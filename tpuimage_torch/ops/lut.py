"""Table lookups (counterpart of ``tpuimage.ops.lut``).

tpuimage looks tables up by one-hot matrix products, a device of the TPU,
whose gathers are slow; here a lookup is a plain gather on every device.
"""
from __future__ import annotations

import torch


def lut_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an (N,) numeric table and an integer index of any
    shape, clipped to [0, N), in the table's dtype and on the index's
    device."""
    n = int(table.shape[0])
    return table.to(idx.device)[torch.clamp(idx.to(torch.int64), 0, n - 1)]


def lut_lookup_u8(table256: torch.Tensor, values_u8: torch.Tensor) -> torch.Tensor:
    """``table256[values]`` for uint8 values (the cv2.LUT pattern), in the
    table's dtype and on the values' device."""
    return table256.to(values_u8.device)[values_u8.to(torch.int64)]
