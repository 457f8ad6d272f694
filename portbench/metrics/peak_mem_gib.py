"""Peak device memory over set-up and window, GiB:
``torch.cuda.max_memory_allocated`` read as the window closes."""


def read(rec, name):
    if not rec["peak_bytes"]:
        return None
    return rec["peak_bytes"] / 2 ** 30
