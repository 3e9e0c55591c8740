"""device_idle_share: the share of the traced window in which no kernel,
copy or fill ran on the device: 100 * (1 - busy_s / window_s)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
