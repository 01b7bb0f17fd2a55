"""Device mesh, batch sharding and halo exchange (counterpart of
``tpuimage.runtime.mesh``).

The port's mesh is single-controller, as tpuimage's is (one Python
program, ``jax.shard_map`` over a ``Mesh`` of devices):

- a :class:`Mesh` is an array of ``torch.device``\\ s with axis names;
- a sharded value is a list of tensors, one a shard, each on its shard's
  device;
- the collectives are plain functions over such lists. :func:`ppermute`
  copies a shard's tensor to another shard's device
  (``tensor.to(device, non_blocking=True)``: a peer copy between cards,
  nothing when both shards share a device); :func:`psum`, :func:`pmin`
  and :func:`pmax` reduce the list in shard order on the first shard's
  device, and :func:`all_gather` concatenates it there; each shard then
  gets the result on its own device.

The same device may stand more than once in a mesh. The host tests run
8 shards on ``cpu`` in place of XLA's 8 virtual CPU devices, and one card
can hold 4 shards. On a machine with several cards ``make_mesh()`` takes
distinct ones, and the code path is the same. ``torch.distributed`` is
not used: NCCL refuses two ranks on one card, so on a one-card machine a
process group would be a world of one and no halo would cross a shard.

tpuimage's ``batch_sharding`` returns a ``NamedSharding``, an object that
describes how an array is laid out over the mesh. PyTorch has no such
object: a sharded batch is its list of shards, so the rule (the leading
dim split over a mesh axis) lives in :func:`shard_batch`.

Halo exchange adds a fifth border mode to tpuimage's four: ``"none"``,
where the outer shards get no rows on the image's side, so a stencil's
own border acts where the image really ends and blocks differ in height
(:func:`crop_halo` undoes either form).

The bytes the collectives move are counted (:func:`transfer_bytes`), as
the kernels' launches are.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

BORDERS = ("replicate", "reflect101", "constant", "zero", "none")

_lock = threading.Lock()
# collective -> bytes since the last reset_transfer_bytes(): ppermute the
# halo rows, all_gather the gathered result per receiving device, reduce
# the operands brought to the first shard's device
_bytes: Dict[str, int] = {"ppermute": 0, "all_gather": 0, "reduce": 0}


def transfer_bytes() -> Dict[str, int]:
    with _lock:
        return dict(_bytes)


def reset_transfer_bytes() -> None:
    with _lock:
        for k in _bytes:
            _bytes[k] = 0


def _add_bytes(kind: str, n: int) -> None:
    with _lock:
        _bytes[kind] += int(n)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: itself there, else a copy (asynchronous to a
    card; a copy to the host waits for it)."""
    if x.device == dev:
        return x
    return x.to(dev, non_blocking=dev.type == "cuda")


def canonical_device(dev) -> torch.device:
    """``dev`` as the tensors on it report it: the host without an index,
    a card with one (``cuda`` is the current card)."""
    d = torch.device(dev)
    if d.type == "cpu":
        return torch.device("cpu")
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: build the mesh with devices=['cpu'] * n "
                               "to run on the host")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-d array of ``torch.device``\\ s with one name an axis.
    ``mesh.shape[axis]`` is the axis' size, as in JAX; ``mesh.size`` the
    number of shards; ``mesh.devices`` the object array."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = canonical_device(src[idx])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or len(set(self.axis_names)) != arr.ndim:
            raise ValueError(f"mesh of shape {arr.shape} needs {arr.ndim} distinct axis "
                             f"names, got {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axes) -> List[torch.device]:
        """The devices along ``axes`` (a name or a tuple of names, the
        first slowest), the other axes at index 0: where the shards of a
        value split over ``axes`` live."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in idx]
        n = int(np.prod([self.devices.shape[i] for i in idx]))
        return list(np.transpose(self.devices, idx + rest).reshape(n, -1)[:, 0])

    def grid(self, *axes: str) -> np.ndarray:
        """The devices as an array over ``axes`` in that order, any other
        axis at index 0."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in idx]
        arr = np.transpose(self.devices, idx + rest)
        return arr.reshape(arr.shape[:len(idx)] + (-1,))[..., 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, devices=None) -> Mesh:
    """A Mesh over the first n devices: with no ``devices``, the CUDA
    cards (RuntimeError when there is none; there is no fall back to the
    host); else ``devices`` as given, where one device may stand several
    times (``["cpu"] * 8``, ``[torch.device("cuda", 0)] * 4``).

    One axis ("data",) by default; a multi-axis mesh needs ``shape``, as
    ``axis_names=("data", "space"), shape=(2, 4)``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu'] * n "
                               "to build a mesh on the host")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = list(devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"make_mesh: {n} devices asked for, {len(devs)} available")
    devs = devs[:n]
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def pad_to_multiple(batch, multiple: int):
    """Pad the batch dim of an array or tensor up to a multiple by
    repeating the last image. Returns (padded, real_count)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    if isinstance(batch, torch.Tensor):
        return torch.cat([batch, batch[-1:].expand((rem,) + tuple(batch.shape[1:]))]), n
    return np.concatenate([batch, np.repeat(batch[-1:], rem, axis=0)], axis=0), n


def split_to(x: torch.Tensor, devices: Sequence[torch.device], dim: int = 0) -> List[torch.Tensor]:
    """``x`` split along ``dim`` into equal contiguous parts, part i on
    ``devices[i]``; ValueError unless the dim divides."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} must divide the {n} shards")
    part = x.shape[dim] // n
    return [_to(x.narrow(dim, i * part, part), torch.device(d)).contiguous()
            for i, d in enumerate(devices)]


def shard_batch(batch, mesh: Mesh, axis="data") -> List[torch.Tensor]:
    """The leading dim of a batch (array or tensor) split over the mesh
    axis ``axis`` (a name, or a tuple of names to split over several):
    one tensor a shard, each on its device (:meth:`Mesh.axis_devices`).
    The batch must divide (:func:`pad_to_multiple`)."""
    x = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(batch))
    return split_to(x, mesh.axis_devices(axis), 0)


def gather_to(xs: Sequence[torch.Tensor], dev: torch.device, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along ``dim`` on ``dev`` (no count: this is
    how a result leaves the mesh, not a collective)."""
    return torch.cat([_to(x, dev) for x in xs], dim=dim)


def _tree_cat(outs: list, dev: torch.device, n: int):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return gather_to(outs, dev)[:n]
    if isinstance(first, dict):
        return {k: _tree_cat([o[k] for o in outs], dev, n) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_cat([o[i] for o in outs], dev, n) for i in range(len(first)))
    raise TypeError(f"run_data_parallel: unsupported output {type(first)}")


def run_data_parallel(fn: Callable, images, mesh: Optional[Mesh] = None):
    """Run ``fn`` over a uint8 batch (array or tensor), data-parallel over
    every shard of the mesh: pad to a multiple of the mesh's size, split,
    ``fn`` on each shard's local batch on its device, concatenate on the
    mesh's first device, drop the pad. ``fn`` takes a batch, as the
    port's ops do, so there is no ``vmap``. Outputs may be tensors or
    dicts, lists and tuples of them."""
    mesh = mesh or make_mesh()
    padded, n = pad_to_multiple(images, mesh.size)
    shards = shard_batch(padded, mesh, tuple(mesh.axis_names))
    return _tree_cat([fn(s) for s in shards], mesh.devices.flat[0], n)


# ---------------------------------------------------------------------------
# collectives over a shard list
# ---------------------------------------------------------------------------

def ppermute(xs: Sequence[torch.Tensor], perm) -> List[Optional[torch.Tensor]]:
    """``out[dst] = xs[src]`` copied to ``xs[dst]``'s device for each
    (src, dst) pair; a shard no pair sends to gets None (JAX's gets
    zeros)."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = _to(xs[src], xs[dst].device)
        _add_bytes("ppermute", _nbytes(xs[src]))
    return out


def broadcast(v: torch.Tensor, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``v`` on each shard's device (the devices of ``xs``), one copy a
    device."""
    on = {v.device: v}
    for x in xs:
        if x.device not in on:
            on[x.device] = _to(v, x.device)
    return [on[x.device] for x in xs]


def _reduce(xs: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    acc = xs[0]
    for x in xs[1:]:
        _add_bytes("reduce", _nbytes(x))
        acc = op(acc, _to(x, acc.device))
    return broadcast(acc, xs)


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the shards, in shard order, on each shard's device.
    Integer sums are exact in any order; the order is fixed anyway."""
    return _reduce(xs, torch.add)


def pmin(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce(xs, torch.minimum)


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce(xs, torch.maximum)


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
    """The shards concatenated along ``dim`` in shard order (JAX's
    ``all_gather(tiled=True)``), on each shard's device."""
    g = gather_to(xs, xs[0].device, dim)
    out = broadcast(g, xs)
    _add_bytes("all_gather", _nbytes(g) * len({x.device for x in xs}))
    return out


def any_shard(flags: Sequence[torch.Tensor]) -> bool:
    """Whether any shard's bool flag is set: the flags gathered on the
    first shard's device and read back once."""
    return bool(torch.stack([_to(f, flags[0].device) for f in flags]).any())


# ---------------------------------------------------------------------------
# spatial sharding with halo exchange
# ---------------------------------------------------------------------------

def halo_exchange(shards: Sequence[torch.Tensor], halo: int, border: str = "replicate",
                  border_value: float = 0.0, axis: int = 0) -> List[torch.Tensor]:
    """Each shard of an image split along array ``axis`` padded with
    ``halo`` rows of its neighbours' (:func:`ppermute`). The outer sides
    of the first and last shards take the border:

    - "replicate": the shard's own edge row repeated (BORDER_REPLICATE);
    - "reflect101": mirrored about the edge row (BORDER_REFLECT_101;
      needs halo < the shard's extent);
    - "constant": ``border_value``; "zero": 0;
    - "none": no rows, so the block ends where the image does.

    A list in, a list out; inner neighbours must hold ``halo`` rows."""
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    if halo == 0:
        return list(shards)
    n = len(shards)
    for i, x in enumerate(shards):
        ext = x.shape[axis]
        if (n > 1 and halo > ext) or (border == "reflect101" and halo >= ext):
            raise ValueError(f"halo {halo} too deep for shard {i} of extent {ext}")
    tops = [x.narrow(axis, 0, halo) for x in shards]
    bots = [x.narrow(axis, x.shape[axis] - halo, halo) for x in shards]
    from_below = ppermute(tops, [(i, i - 1) for i in range(1, n)])
    from_above = ppermute(bots, [(i, i + 1) for i in range(n - 1)])

    def fill(x, top: bool):
        ext = x.shape[axis]
        if border == "none":
            return None
        if border == "replicate":
            row = x.narrow(axis, 0 if top else ext - 1, 1)
            shape = list(row.shape)
            shape[axis] = halo
            return row.expand(shape)
        if border == "reflect101":
            return x.narrow(axis, 1 if top else ext - 1 - halo, halo).flip(axis)
        v = border_value if border == "constant" else 0
        return torch.full_like(x.narrow(axis, 0, halo), v)

    out = []
    for i, x in enumerate(shards):
        upper = from_above[i] if i > 0 else fill(x, True)
        lower = from_below[i] if i < n - 1 else fill(x, False)
        out.append(torch.cat([p for p in (upper, x, lower) if p is not None], dim=axis))
    return out


def crop_halo(blocks: Sequence[torch.Tensor], halo: int, border: str = "replicate",
              axis: int = 0) -> List[torch.Tensor]:
    """Undo :func:`halo_exchange`: ``halo`` rows off each side that got
    them (with ``border="none"`` the outer sides got none)."""
    n = len(blocks)
    out = []
    for i, b in enumerate(blocks):
        top = 0 if (border == "none" and i == 0) else halo
        bot = 0 if (border == "none" and i == n - 1) else halo
        out.append(b.narrow(axis, top, b.shape[axis] - top - bot))
    return out


def spatial_map(fn: Callable, img, mesh: Mesh, halo: int, axis: str = "space",
                border: str = "replicate", border_value: float = 0.0) -> torch.Tensor:
    """A stencil ``fn(block) -> block`` over an image split along its
    first dim over mesh axis ``axis``, each block with ``halo`` rows of
    its neighbours; ``fn``'s output is cropped back and the rows gathered
    where the image was (the mesh's first device for an array).

    ``fn`` must keep the shape and reach at most ``halo`` rows. With
    ``border`` the stencil's own border mode (or "none") the result
    equals the unsharded stencil on the whole image. H must divide the
    axis size."""
    x = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))
    devs = mesh.axis_devices(axis)
    home = x.device if isinstance(img, torch.Tensor) else devs[0]
    blocks = halo_exchange(split_to(x, devs, 0), halo, border, border_value, axis=0)
    return gather_to(crop_halo([fn(b) for b in blocks], halo, border, 0), home, 0)


def dp_spatial_map(fn: Callable, batch, mesh: Mesh, halo: int, data_axis: str = "data",
                   space_axis: str = "space", border: str = "replicate",
                   border_value: float = 0.0) -> torch.Tensor:
    """Two-axis parallelism: the batch dim split over ``data_axis`` and
    each image's H over ``space_axis``, with halo exchange along H. ``fn``
    takes a local batch block (b_local, h_local + halos, ...), as the
    port's ops take batches. The batch must divide the data axis and H
    the space axis."""
    x = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(batch))
    grid = mesh.grid(data_axis, space_axis)
    home = x.device if isinstance(batch, torch.Tensor) else grid[0, 0]
    nd = grid.shape[0]
    if x.shape[0] % nd:
        raise ValueError(f"batch {x.shape[0]} must divide the {data_axis} axis ({nd})")
    bl = x.shape[0] // nd
    parts = []
    for i in range(nd):
        blocks = halo_exchange(split_to(x[i * bl:(i + 1) * bl], list(grid[i]), 1), halo,
                               border, border_value, axis=1)
        parts.append(gather_to(crop_halo([fn(b) for b in blocks], halo, border, 1), home, 1))
    return torch.cat(parts, dim=0)
