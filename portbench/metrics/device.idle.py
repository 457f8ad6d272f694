"""Share of the traced window with no kernel, copy or memset on the
card: one minus the union of device operations over the window's
length."""


def read(rec, name):
    tr = rec.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
