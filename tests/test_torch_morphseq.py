"""morph_seq in tpuimage_torch against tpuimage (JAX on the CPU): all four
stages exact (max |diff| 0) against ``morphseq_stages(impl="xla")`` and
``impl="pallas"`` (its two kernels interpreted), on the shapes of
tpuimage's own morph_seq tests, the near-constant image, and a seeded
document photo (``tpuimage_torch.synth``)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpuimage.pipelines import morphseq as jmorphseq

from tpuimage_torch import synth
from tpuimage_torch.pipelines import morphseq

# one intra-op thread: pytest-xdist runs several workers side by side, and
# PyTorch's default of one spinning thread per core each slows every
# worker many times over
torch.set_num_threads(1)

STAGES = ("step1_gray", "step2_eroded", "step3_otsu", "step4_closed")


def _assert_stages_exact(rgb):
    ours = morphseq.morphseq_stages(rgb, device="cpu")
    np.testing.assert_array_equal(ours["original"].numpy(), rgb)
    for impl in ("xla", "pallas"):
        ref = jmorphseq.morphseq_stages(jnp.asarray(rgb), impl=impl)
        for k in STAGES:
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                          err_msg=f"{impl} stage {k}")
    return ours


@pytest.mark.parametrize("shape", [(97, 131), (64, 128), (128, 64), (33, 257)])
def test_random_stages_exact(rng, shape):
    _assert_stages_exact(rng.integers(0, 256, size=shape + (3,), dtype=np.uint8))


def test_near_constant_image_exact():
    """Two adjacent levels only: where a float64 and a float32 Otsu could
    part. They do not: threshold 199, the same binary and closing."""
    rgb = np.full((64, 130, 3), 200, np.uint8)
    rgb[10:20, 40:80] = 199
    ours = _assert_stages_exact(rgb)
    assert set(np.unique(ours["step3_otsu"].numpy())) == {0, 255}


def test_document_photo_exact():
    ours = _assert_stages_exact(synth.document_photo(31, 160, 213))
    assert 0 < (ours["step4_closed"].numpy() == 0).mean() < 1


def test_batch_equals_single(rng):
    batch = rng.integers(0, 256, size=(3, 64, 96, 3), dtype=np.uint8)
    out = morphseq.morphseq_batch(batch, device="cpu")
    for i in range(3):
        one = morphseq.morphseq_stages(torch.from_numpy(batch[i]))
        for k in ("original",) + STAGES:
            assert torch.equal(out[k][i], one[k]), (i, k)


def test_runs_on_the_card_unless_asked(monkeypatch, rng):
    """An array goes to the card by default, and with no card that raises;
    device="cpu" and a CPU tensor run on the host."""
    rgb = rng.integers(0, 256, size=(24, 40, 3), dtype=np.uint8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        morphseq.morphseq_stages(rgb)
    on_host = morphseq.morphseq_stages(rgb, device="cpu")
    assert on_host["step4_closed"].device.type == "cpu"
    assert torch.equal(morphseq.morphseq_stages(torch.from_numpy(rgb))["step4_closed"],
                       on_host["step4_closed"])


def test_threshold_otsu_matches_tpuimage(rng):
    """The op form of steps 3 (tpuimage's ``threshold_otsu``, which its
    XLA morph_seq path calls): the same threshold and binary, per plane."""
    from tpuimage.ops import threshold as jthreshold
    from tpuimage_torch.ops import threshold
    planes = np.stack([rng.integers(0, 256, (40, 56), dtype=np.uint8),
                       synth.document_photo(32, 40, 56)[..., 1]])
    t, binary = threshold.threshold_otsu(torch.from_numpy(planes))
    assert t.shape == (2,) and binary.shape == planes.shape
    for i in range(2):
        rt, rb = jthreshold.threshold_otsu(jnp.asarray(planes[i]))
        assert float(t[i]) == float(rt)
        np.testing.assert_array_equal(binary[i].numpy(), np.asarray(rb))
