"""tournament_s: the automatic threshold's tournament per scan: the mean
of run_pipeline's threshold_s."""


def read(run):
    return run.mean("threshold_s")
