from .device import resolve_device
from .tensor import ensure_device, ensure_numpy, id2idx, next_power_of_two, pad_to
from .topo import coo_to_csc, coo_to_csr, csr_to_coo, degrees_from_ptr, ptr2ind
from .units import format_size, parse_size

__all__ = [
    "ensure_device", "ensure_numpy", "id2idx", "next_power_of_two", "pad_to",
    "coo_to_csc", "coo_to_csr", "csr_to_coo", "degrees_from_ptr", "ptr2ind",
    "format_size", "parse_size", "resolve_device",
]
