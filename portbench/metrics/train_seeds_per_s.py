"""Seeds trained a second: every real seed of every block the window
trained, over the window's whole time (host clock, ended by a device
sync)."""


def read(rec, name):
    return rec["seeds"] / rec["window_s"]
