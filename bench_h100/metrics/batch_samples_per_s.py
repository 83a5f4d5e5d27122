"""Audio samples of every file analysed in the window over the window's
wall time, from its start to the last file's return (host clock)."""


def read(run):
    if not run.records:
        return None
    return sum(r["samples"] for r in run.records) / run.window_s
