"""The 95th percentile of a block's time as the device sees it, over all
blocks of the window: CUDA events recorded before and after each block's
dispatch, read once after the window.  One name a cell
(``block_p95_ms.<cell>``), each with the bound its own spread allows."""
import statistics


def read(rec, name):
    ms = rec["block_ms"]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
