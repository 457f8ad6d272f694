"""Share of the window's real batches whose node buffer overflowed
(the sampler's ``metadata["overflow"]`` flags, tallied on the device and
read once after the window): wasted capacity against attempts."""


def read(rec, name):
    if not rec["batches"]:
        return None
    return 100.0 * rec["overflow"] / rec["batches"]
