"""tpuimage_torch.runtime.mesh on the host against tpuimage.runtime.mesh on
its 8 virtual CPU devices (tests/conftest.py): the mesh's shapes, the
batch pad and split, data parallelism, halo exchange in every border
mode, spatial_map and dp_spatial_map, and the collectives. The port's
shards all sit on ``cpu`` here, as XLA's 8 virtual devices sit on one
host. Every comparison is exact (integer data, or the same f32 ops in
the same order).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from tpuimage.ops import filters as jfilters
from tpuimage.ops import median as jmedian
from tpuimage.ops import morphology as jmorph
from tpuimage.runtime import mesh as jrt

from tpuimage_torch.ops import filters, median, morphology
from tpuimage_torch.runtime import mesh as rt

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _cpu_mesh(n, axis_names=("space",), shape=None):
    return rt.make_mesh(n, axis_names, shape, devices=CPU8)


def test_make_mesh_shapes_match_tpuimage():
    for n, names, shape in ((8, ("data",), None), (4, ("space",), None),
                            (8, ("data", "space"), (2, 4)), (8, ("data", "space"), (4, 2))):
        ours = rt.make_mesh(n, names, shape, devices=CPU8)
        ref = jrt.make_mesh(n, names, shape)
        assert ours.shape == dict(ref.shape)
        assert ours.axis_names == tuple(ref.axis_names)
        assert ours.size == ref.devices.size == n
        assert all(d == torch.device("cpu") for d in ours.devices.flat)
    grid = rt.make_mesh(4, ("data", "space"), (2, 2), devices=["cpu", "meta", "cpu", "meta"])
    assert [d.type for d in grid.axis_devices("data")] == ["cpu", "cpu"]
    assert [d.type for d in grid.axis_devices("space")] == ["cpu", "meta"]
    assert [d.type for d in grid.axis_devices(("data", "space"))] == ["cpu", "meta"] * 2
    assert grid.grid("space", "data").shape == (2, 2)
    with pytest.raises(ValueError, match="shape required"):
        rt.make_mesh(8, ("data", "space"), devices=CPU8)
    with pytest.raises(ValueError, match="9 devices asked for"):
        rt.make_mesh(9, devices=CPU8)


def test_make_mesh_raises_without_a_card(monkeypatch):
    """No devices and no card: an error, never a quiet host mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.make_mesh(2, devices=["cuda"] * 2)
    assert rt.make_mesh(2, devices=["cpu"] * 2).size == 2


@pytest.mark.parametrize("n,multiple", [(11, 8), (8, 8), (1, 4), (5, 1)])
def test_pad_to_multiple(rng, n, multiple):
    x = rng.integers(0, 256, size=(n, 3, 2), dtype=np.uint8)
    ref, ref_n = jrt.pad_to_multiple(x, multiple)
    ours, ours_n = rt.pad_to_multiple(x, multiple)
    t, t_n = rt.pad_to_multiple(torch.from_numpy(x), multiple)
    assert ours_n == t_n == ref_n == n
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(t.numpy(), ref)


def test_shard_batch_and_run_data_parallel(rng):
    """11 images over 8 shards (padded to 16), a median on each shard's
    local batch: equal to a serial loop and to tpuimage's jit(vmap)."""
    imgs = rng.integers(0, 256, size=(11, 64, 48), dtype=np.uint8)
    mesh = _cpu_mesh(8, ("data",))
    shards = rt.shard_batch(rt.pad_to_multiple(imgs, 8)[0], mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 64, 48)] * 8
    np.testing.assert_array_equal(torch.cat(shards).numpy()[:11], imgs)
    with pytest.raises(ValueError, match="must divide"):
        rt.shard_batch(imgs, mesh)
    out = rt.run_data_parallel(lambda b: median.median_blur(b, 3), imgs, mesh)
    assert out.shape == imgs.shape and out.device.type == "cpu"
    for i in range(len(imgs)):
        np.testing.assert_array_equal(
            out[i].numpy(), median.median_blur(torch.from_numpy(imgs[i]), 3).numpy())
    ref = jrt.run_data_parallel(lambda im: jmedian.median_blur(im, 3), imgs, jrt.make_mesh(8))
    np.testing.assert_array_equal(out.numpy(), ref)
    # dict outputs keep their keys; a (2, 4) mesh splits over both axes
    both = rt.run_data_parallel(lambda b: {"m": median.median_blur(b, 3), "s": b.sum((1, 2))},
                                imgs, _cpu_mesh(8, ("data", "space"), (2, 4)))
    np.testing.assert_array_equal(both["m"].numpy(), ref)
    np.testing.assert_array_equal(both["s"].numpy(), imgs.astype(np.int64).sum((1, 2)))


def _jax_halo(img, n, halo, border, value):
    jmesh = jrt.make_mesh(n, axis_names=("space",))
    f = jax.shard_map(lambda x: jrt.halo_exchange(x, halo, "space", border=border,
                                                  border_value=value),
                      mesh=jmesh, in_specs=(P("space", None),), out_specs=P("space", None))
    return np.asarray(jax.jit(f)(jnp.asarray(img)))


@pytest.mark.parametrize("border,value", [("replicate", 0.0), ("reflect101", 0.0),
                                          ("constant", 255.0), ("zero", 0.0)])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("halo", [1, 3])
def test_halo_exchange_matches_tpuimage(rng, border, value, n, halo):
    img = rng.integers(0, 256, size=(8 * n, 5), dtype=np.uint8)
    rt.reset_transfer_bytes()
    blocks = rt.halo_exchange(rt.split_to(torch.from_numpy(img), ["cpu"] * n), halo, border,
                              value)
    assert [b.shape[0] for b in blocks] == [8 + 2 * halo] * n
    np.testing.assert_array_equal(torch.cat(blocks).numpy(),
                                  _jax_halo(img, n, halo, border, value))
    # each inner boundary moves halo rows each way
    assert rt.transfer_bytes()["ppermute"] == 2 * (n - 1) * halo * 5
    back = rt.crop_halo(blocks, halo, border)
    np.testing.assert_array_equal(torch.cat(back).numpy(), img)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_halo_exchange_none_and_axis(rng, n):
    """"none": no rows on the image's side, neighbours' rows inside;
    along axis 1 of a batch the same rows per image."""
    img = rng.integers(0, 256, size=(3, 6 * n, 4), dtype=np.uint8)
    t = torch.from_numpy(img)
    blocks = rt.halo_exchange(rt.split_to(t, ["cpu"] * n, 1), 2, "none", axis=1)
    for i, b in enumerate(blocks):
        lo, hi = max(6 * i - 2, 0), min(6 * (i + 1) + 2, 6 * n)
        np.testing.assert_array_equal(b.numpy(), img[:, lo:hi])
    np.testing.assert_array_equal(torch.cat(rt.crop_halo(blocks, 2, "none", 1), 1).numpy(), img)
    with pytest.raises(ValueError, match="unknown border"):
        rt.halo_exchange([t], 1, "wrap")
    with pytest.raises(ValueError, match="too deep"):
        rt.halo_exchange(rt.split_to(t, ["cpu"] * 2, 1), 3 * n + 1, "zero", axis=1)


def _gauss5(x):
    return filters.gaussian_blur_u8(x, 5)


def _erode5(x):
    return morphology.erode(x, morphology.structuring_element("rect", 5))


@pytest.mark.parametrize("op", ["gaussian", "erode"])
@pytest.mark.parametrize("border", ["native", "none"])
def test_spatial_map_matches_unsharded_and_tpuimage(rng, op, border):
    """A Gaussian (reflect-101) and an erode (constant 255) over 8 row
    shards: equal to the op on the whole image and to tpuimage's
    spatial_map; with "none" the op's own border acts at the ends."""
    img = rng.integers(0, 256, size=(128, 64), dtype=np.uint8)
    fn, jfn, jborder, value = {
        "gaussian": (_gauss5, lambda b: jfilters.gaussian_blur_u8(b, 5), "reflect101", 0.0),
        "erode": (_erode5, lambda b: jmorph.erode(b, jmorph.structuring_element("rect", 5)),
                  "constant", 255.0)}[op]
    mine = jborder if border == "native" else "none"
    out = rt.spatial_map(fn, img, _cpu_mesh(8), 2, border=mine, border_value=value)
    np.testing.assert_array_equal(out.numpy(), fn(torch.from_numpy(img)).numpy())
    ref = jrt.spatial_map(jfn, jnp.asarray(img), jrt.make_mesh(8, axis_names=("space",)), 2,
                          border=jborder, border_value=value)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="must divide"):
        rt.spatial_map(fn, img[:100], _cpu_mesh(8), 2, border=mine)


@pytest.mark.parametrize("op", ["gaussian", "erode"])
def test_dp_spatial_map_matches_unsharded_and_tpuimage(rng, op):
    batch = rng.integers(0, 256, size=(4, 64, 48), dtype=np.uint8)
    fn, jfn, border, value = {
        "gaussian": (_gauss5, lambda b: jfilters.gaussian_blur_u8(b, 5), "reflect101", 0.0),
        "erode": (_erode5, lambda b: jmorph.erode(b, jmorph.structuring_element("rect", 5)),
                  "constant", 255.0)}[op]
    mesh = _cpu_mesh(8, ("data", "space"), (2, 4))
    out = rt.dp_spatial_map(fn, batch, mesh, 2, border=border, border_value=value)
    np.testing.assert_array_equal(out.numpy(), fn(torch.from_numpy(batch)).numpy())
    ref = jrt.dp_spatial_map(jfn, jnp.asarray(batch),
                             jrt.make_mesh(8, axis_names=("data", "space"), shape=(2, 4)), 2,
                             border=border, border_value=value)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="must divide the data axis"):
        rt.dp_spatial_map(fn, batch[:3], mesh, 2, border=border)


@pytest.mark.parametrize("n", [2, 8])
def test_collectives_match_tpuimage(rng, n):
    x = rng.integers(-1000, 1000, size=(4 * n, 6)).astype(np.int32)
    shards = rt.split_to(torch.from_numpy(x), ["cpu"] * n)

    def local(v):
        return (lax.psum(v, "s"), lax.pmin(v, "s"), lax.pmax(v, "s"),
                lax.all_gather(v, "s", tiled=True),
                lax.ppermute(v, "s", [(i, (i + 1) % n) for i in range(n)]))

    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("s",))
    refs = jax.jit(jax.shard_map(local, mesh=jmesh, in_specs=(P("s", None),),
                                 out_specs=(P(), P(), P(), P(), P("s", None)),
                                 check_vma=False))(jnp.asarray(x))
    rt.reset_transfer_bytes()
    for got, ref in zip((rt.psum(shards), rt.pmin(shards), rt.pmax(shards),
                         rt.all_gather(shards)), refs[:4]):
        assert len(got) == n and all(g is got[0] for g in got)   # one copy a device
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    ring = rt.ppermute(shards, [(i, (i + 1) % n) for i in range(n)])
    np.testing.assert_array_equal(torch.cat(ring).numpy(), np.asarray(refs[4]))
    assert rt.ppermute(shards, [(0, 1)])[2 % n if n > 2 else 0] is None
    counts = rt.transfer_bytes()
    assert counts["reduce"] == 3 * (n - 1) * 4 * 6 * 4
    assert counts["all_gather"] == x.nbytes
    assert counts["ppermute"] == (n + 1) * 4 * 6 * 4
    assert rt.any_shard([torch.tensor(False)] * (n - 1) + [torch.tensor(True)])
    assert not rt.any_shard([torch.tensor(False)] * n)
