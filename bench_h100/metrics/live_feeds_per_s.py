"""Feeds completed in the window over the window's wall time, from its
start to the last feed's return (host clock).  Times 60 s of audio a
feed, it is how many stations the card keeps up with."""


def read(run):
    if not run.records:
        return None
    return len(run.records) / run.window_s
