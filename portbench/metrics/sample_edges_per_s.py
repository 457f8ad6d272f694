"""Sampled edges a second: every valid (unmasked) edge the window
sampled, its batch's features and labels gathered, over the window's
whole time (host clock, ended by a device sync)."""


def read(rec, name):
    if "edges" not in rec:
        return None
    return rec["edges"] / rec["window_s"]
