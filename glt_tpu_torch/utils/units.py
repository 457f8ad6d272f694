"""Byte-size parsing and formatting (``'256MB'`` -> bytes), cf.
``glt_tpu/utils/units.py``."""
from __future__ import annotations

import re
from typing import Union

_UNITS = {
    "B": 1,
    "KB": 1024,
    "MB": 1024 ** 2,
    "GB": 1024 ** 3,
    "TB": 1024 ** 4,
}


def parse_size(size: Union[int, str]) -> int:
    """Parse a human-readable byte size like ``'1.5GB'`` into bytes."""
    if isinstance(size, (int, float)):
        return int(size)
    m = re.fullmatch(r"\s*([0-9]*\.?[0-9]+)\s*([KMGT]?B?)\s*", size.upper())
    if not m:
        raise ValueError(f"cannot parse size: {size!r}")
    value, unit = m.groups()
    unit = unit if unit.endswith("B") else unit + "B"
    if unit not in _UNITS:
        raise ValueError(f"unknown unit in size: {size!r}")
    return int(float(value) * _UNITS[unit])


def format_size(num_bytes: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(num_bytes) < 1024:
            return f"{num_bytes:.1f}{unit}" if unit != "B" else f"{num_bytes}B"
        num_bytes /= 1024
    return f"{num_bytes:.1f}TB"
