"""tail_s: sort, ARACNE and the writers per scan: the mean of
run_pipeline's sort_s + aracne_s + write_s."""


def read(run):
    return run.mean("sort_s", "aracne_s", "write_s")
