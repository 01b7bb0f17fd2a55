"""The control: the plain reference computed one precision below the
float32 its configuration states. Inside :func:`rounding`, every float32
tensor that a torch operation computes is rounded to bfloat16 (and held
in float32), so each intermediate value and each accumulator carries
bfloat16's 8 bits of mantissa, as a reference ported to bfloat16 would.
Views and tensors made from host data are left alone, so tables cached
by an earlier float32 run keep their values; integer and float64 work,
and the host's numpy, are left as they are."""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

_SOURCES = (torch.from_numpy, torch.as_tensor, torch.tensor)


def _storages(obj, out: set) -> set:
    if isinstance(obj, torch.Tensor):
        out.add(obj.untyped_storage().data_ptr())
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _storages(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _storages(x, out)
    return out


def _round(x, inputs: set, inplace: bool) -> None:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float32 and (inplace or x.untyped_storage().data_ptr() not in inputs):
            x.copy_(x.to(torch.bfloat16))
    elif isinstance(x, (tuple, list)):
        for y in x:
            _round(y, inputs, inplace)


class _Bfloat16Values(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _SOURCES:
            return out
        name = getattr(func, "__name__", "")
        inplace = (name.endswith("_") and not name.startswith("__")) or name.startswith("__i")
        _round(out, _storages((args, kwargs), set()), inplace)
        return out


@contextlib.contextmanager
def rounding(on: bool = True):
    """Round every float32 result to bfloat16 while ``on``."""
    if not on:
        yield
        return
    with _Bfloat16Values():
        yield
