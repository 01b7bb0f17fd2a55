"""The card's published peaks and the least time a piece of work can
take on it, frozen from ``chip_smoke.py``'s bound arithmetic.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W power limit): HBM bytes/s; f32 operations/s outside the
tensor cores, the rate the integer and f32 work of the image kernels is
counted at; int8 operations/s on the tensor cores, the rate for products
of bytes with bytes (the Q8.8 Gaussian)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12


def bound(nbytes: float, ops: float, ops_per_s: float = ALU_OPS_PER_S) -> tuple:
    """(seconds, "bytes" or "operations"): the larger of the bytes moved
    (each input read once, each output written once) over HBM bandwidth
    and the operations over the card's peak rate for their type."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / ops_per_s
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def add(bounds) -> tuple:
    """The sum of several (seconds, bound_by); bound_by names the kind
    that bounds the larger share of the seconds."""
    secs = {"bytes": 0.0, "operations": 0.0}
    for s, by in bounds:
        secs[by] += s
    return secs["bytes"] + secs["operations"], max(secs, key=secs.get)
