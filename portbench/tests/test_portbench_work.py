"""The roofline work counts against hand counts on small shapes, and the
trace reductions on a hand-made trace."""
import pytest

from portbench import peaks
from portbench.trace import Trace, breakdown
from portbench.work import bilateral, gauss_chain


def test_bound_takes_the_larger_side():
    s, by = peaks.bound(3.35e12, 0.0)
    assert s == pytest.approx(1.0) and by == "bytes"
    s, by = peaks.bound(0.0, 67e12)
    assert s == pytest.approx(1.0) and by == "operations"


def test_bilateral_taps_and_count():
    # the disc of radius 1: the centre and its 4 neighbours; radius 4: 49
    assert bilateral.n_taps(3) == 5
    assert bilateral.n_taps(9) == 49
    s, by = bilateral.bound([(2, 3)], {"bilateral_d": 3})
    # 6 pixels x 3 channels read and written; 14 ops x 5 taps x 6 pixels
    assert s == pytest.approx(max(36 / peaks.HBM_BYTES_PER_S, 420 / peaks.ALU_OPS_PER_S))
    assert by == "bytes"


def test_gauss_chain_three_passes_by_hand():
    settings = {"illum_blur_frac": 0.05, "mask_blur_ksize": 51, "block_size": 31}
    h, w = 40, 30
    n = h * w
    k_illum = 15            # max(15, round(30 * 0.05)) is 15, odd
    q8 = [(2 * n + 4 * k) / peaks.HBM_BYTES_PER_S for k in (k_illum, 51)]
    q8_ops = [4 * k * n / peaks.INT8_TENSOR_OPS_PER_S for k in (k_illum, 51)]
    adaptive = max((2 * n + 4 * 31) / peaks.HBM_BYTES_PER_S,
                   2 * (1 + 3 * 15) * n / peaks.ALU_OPS_PER_S)
    want = sum(max(a, b) for a, b in zip(q8, q8_ops)) + adaptive
    s, _ = gauss_chain.bound([(h, w)], settings)
    assert s == pytest.approx(want)
    assert gauss_chain.illum_ksize(1200, 849, 0.05) == 43


def test_trace_union_gaps_and_labels():
    device = [(0.0, 1.0, "k1"), (0.5, 2.0, "k2"), (3.0, 3.5, "Memcpy HtoD (Pageable -> Device)")]
    host = [(1.9, 2.9, "aten::to"), (3.6, 3.7, "cudaLaunchKernel")]
    t = Trace(4.0, device, host, requests=2, images=4)
    assert t.busy() == pytest.approx(2.5)
    assert t.gaps() == [(2.0, 3.0), (3.5, 4.0)]
    b = breakdown(t)
    assert b["device_ops"][0] == ["k2", 1.5]
    assert b["idle_gaps"][0][0] == "aten::to" and b["idle_gaps"][0][1] == pytest.approx(1.0)
    assert b["idle_gaps"][1][0] == "host: no torch op"


@pytest.mark.parametrize("name", ["device_idle_share", "copy_ms_per_request",
                                  "launches_per_image"])
def test_layer_readers_on_a_hand_made_trace(name):
    from portbench import run

    device = [(0.0, 1.0, "k1"), (3.0, 3.5, "Memcpy HtoD (Pageable -> Device)")]
    t = Trace(4.0, device, [], requests=2, images=4)
    want = {"device_idle_share": 62.5, "copy_ms_per_request": 250.0,
            "launches_per_image": 0.5}[name]
    assert run._module("metrics", name).read(t) == pytest.approx(want)
    assert run._module("metrics", name).read(Trace(4.0, [], [], 0, 0)) is None


def test_rooflines_read_nothing_without_their_kernels():
    from portbench import run

    t = Trace(1.0, [(0.0, 0.5, "other")], [], 1, 1, work={"gauss_chain": [(10, 10)]},
              settings={"illum_blur_frac": 0.05, "mask_blur_ksize": 51, "block_size": 31})
    assert run._module("metrics", "gauss_chain_roofline").read(t) is None
    t.device = [(0.0, 0.5, "void gauss_mma_kernel<3>(unsigned char const*)")]
    v = run._module("metrics", "gauss_chain_roofline").read(t)
    assert 0 < v < 100
