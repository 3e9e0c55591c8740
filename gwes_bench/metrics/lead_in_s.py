"""lead_in_s: FASTA parse, upload, filter, weights and engine build, per
scan: the mean of run_pipeline's preprocess_s + engine_build_s."""


def read(run):
    return run.mean("preprocess_s", "engine_build_s")
