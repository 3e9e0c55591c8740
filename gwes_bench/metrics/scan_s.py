"""scan_s: the window's wall seconds over the scans that completed in it
(FASTA read to files written, one scan at a time), so that a stall in
any scan counts."""


def read(run):
    return run.window_s / len(run.scans) if run.scans else None
