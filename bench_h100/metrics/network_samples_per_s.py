"""Station samples of every chunk processed in the window, its events on
the host, over the window's wall time, from its start to the last chunk's
return (host clock)."""


def read(run):
    if not run.records:
        return None
    return sum(r["samples"] for r in run.records) / run.window_s
