"""Mean of ``proc_wav_file``'s own ``read_wav`` phase (``PhaseTimer``) a
file over the window, in ms."""


def read(run):
    if not run.records:
        return None
    return 1e3 * sum(r["read_wav_s"] for r in run.records) / len(run.records)
