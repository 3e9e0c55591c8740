"""sweep_s: the all-pairs sweep per scan (MIEngine.sweep, with the
fetch of its edges and the gaps-excluded MI of the outlier candidates):
the mean of run_pipeline's sweep_s."""


def read(run):
    return run.mean("sweep_s")
