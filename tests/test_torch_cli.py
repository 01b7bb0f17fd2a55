"""tpuimage_torch's CLIs against tpuimage's, on the CPU (``--device cpu``),
on small images the tests write (``tpuimage_torch.synth``, saved with PIL).

Tolerances, each stated where it is checked:
- the parsers: tpuimage's option strings, defaults, choices, nargs and
  help, plus ``--device`` (default ``cuda``); face's input required;
- morph_seq: the five files byte-equal to tpuimage's CLI's;
- night, gray and RGB: ``original`` and ``filtered`` equal to tpuimage's
  CLI's, ``enhanced`` within the night contract of
  ``tests/test_torch_night.py`` (CLAHE ties): max 1 level gray, 3 RGB,
  against tpuimage's TPU form (Pallas, interpreted) on < 0.1% of values,
  and against its CLI's file on no more than 0.1% beyond where tpuimage's
  two forms differ; each histogram CSV equal to the counts of the port's
  own image;
- landscape: ``enhanced`` within PATH_TOL of tpuimage's CLI (max 4,
  > 0 on < 1.5%, > 1 on < 0.5%) and its PSNR / SSIM within 1e-4 relative;
  ``degraded`` and ``restored`` drawn from the port's seeded generator
  (equal to ``landscape_eval_step`` with that generator), and, fed the
  noise tpuimage's CLI draws (``PRNGKey(seed)`` split per file), the
  port's ``landscape_eval_step`` gives tpuimage's ``degraded`` exactly and
  its ``restored`` within PATH_TOL: the noise stream is the one semantic
  difference;
- docscan, face, classify: tpuimage's file names, each file equal to the
  port's in-memory entry point on the same input (held to tpuimage by
  their own test files).
"""
import argparse
import csv
import importlib
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from tpuimage.ops import color as jcolor
from tpuimage.ops import histogram as jhist
from tpuimage.ops import median as jmedian

from tpuimage_torch import synth
from tpuimage_torch.classify import router
from tpuimage_torch.ops import color, histogram
from tpuimage_torch.pipelines import docscan, face, landscape

torch.set_num_threads(1)

CLIS = ("morphseq", "night", "landscape", "docscan", "face", "classify")
PATH_TOL = (4, 0.015, 0.005)     # max |diff|, share > 0, share > 1
DOC_ARGS = ["--scale-long", "96", "--mask-blur-ksize", "15", "--block-size", "15"]


@pytest.fixture(autouse=True)
def _no_device_claim(monkeypatch):
    """tpuimage's CLIs claim their device first; the port's CLIs run with
    --device cpu, where no claim is made. No build cache either."""
    monkeypatch.setenv("TPUIMAGE_DEVICE_TIMEOUT", "0")
    monkeypatch.delenv("TPUIMAGE_XLA_CACHE", raising=False)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    images = {"doc": synth.document_photo(3, 160, 120),
              "night": synth.night_scene(1, 120, 160),
              "land_a": synth.landscape_scene(2, 48, 64),
              "land_b": synth.landscape_scene(4, 40, 56),
              "portrait": synth.landscape_scene(5, 64, 48)}
    paths = {}
    for name, img in images.items():
        sub = d / "landscapes" if name.startswith("land") else d
        sub.mkdir(exist_ok=True)
        paths[name] = str(sub / f"{name}.png")
        Image.fromarray(img).save(paths[name])
    paths["landscapes"] = str(d / "landscapes")
    return paths


def _read(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.array(im)


def _run(package: str, name: str, argv) -> None:
    importlib.import_module(f"{package}.cli.{name}").main(argv)


def _port(name: str, argv) -> None:
    _run("tpuimage_torch", name, [*argv, "--device", "cpu"])


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _tpuimage_parser(name: str, monkeypatch) -> argparse.ArgumentParser:
    """tpuimage's parser, read without running the CLI: its build_parser()
    where it has one, else caught at parse_args."""
    mod = importlib.import_module(f"tpuimage.cli.{name}")
    if hasattr(mod, "build_parser"):
        return mod.build_parser()

    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as caught:
            mod.main([])
    return caught.value.parser


def _options(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.required,
                     a.type, a.help)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", CLIS)
def test_parser_matches_tpuimage(name, monkeypatch):
    ref = _tpuimage_parser(name, monkeypatch)
    ours = importlib.import_module(f"tpuimage_torch.cli.{name}").build_parser()
    assert ours.description == ref.description
    want, got = _options(ref), _options(ours)
    device = got.pop("device")
    assert device[0] == ("--device",) and device[1] == "cuda" and not device[4]
    if name == "face":        # tpuimage's default input lies outside the repository
        assert want.pop("input")[3] == "?"
        assert got.pop("input")[3:5] == (None, True)
        with pytest.raises(SystemExit):
            ours.parse_args([])
    assert got == want


def test_without_a_card_the_cli_raises(inputs, tmp_path, monkeypatch):
    """No --device: the card is needed, and this machine has none."""
    monkeypatch.setenv("TPUIMAGE_DEVICE_TIMEOUT", "600")
    with pytest.raises(RuntimeError, match="--device cpu"):
        _run("tpuimage_torch", "morphseq", [inputs["doc"], "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_morphseq_files_equal_tpuimage(inputs, tmp_path):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    _run("tpuimage", "morphseq", [inputs["doc"], "--out", str(ref)])
    _port("morphseq", [inputs["doc"], "--out", str(ours)])
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(ours)) and len(names) == 5
    for n in names:
        assert (ours / n).read_bytes() == (ref / n).read_bytes(), n


def _within(ours, ref, max_diff) -> float:
    """The share of values that differ, after checking the largest
    difference."""
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= max_diff, d.max()
    return float((d > 0).mean())


def _tpu_night(rgb, mode):
    """tpuimage's night path as its ``auto`` dispatch runs it on the TPU
    (Pallas CLAHE and Lab), the kernels interpreted."""
    if mode == "gray":
        f = jmedian.median_blur(jcolor.rgb_to_gray(jnp.asarray(rgb)), 3)
        return np.asarray(jhist.clahe(f, 2.0, 8, 8, impl="pallas"))
    f = jmedian.median_blur(jnp.asarray(rgb), 3)
    lab = jcolor.rgb_to_lab(f, impl="pallas")
    l_enh = jhist.clahe(lab[..., 0], 2.0, 8, 8, impl="pallas")
    return np.asarray(jcolor.lab_to_rgb(jnp.concatenate([l_enh[..., None], lab[..., 1:]], -1)))


@pytest.mark.parametrize("mode,max_diff", [("gray", 1), ("rgb", 3)])
def test_night_files_within_contract(inputs, tmp_path, mode, max_diff):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    _run("tpuimage", "night", [inputs["night"], "--out", str(ref), "--mode", mode,
                               "--histograms"])
    _port("night", [inputs["night"], "--out", str(ours), "--mode", mode, "--histograms"])
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(ours)) and len(names) == 6
    for stage in ("original", "filtered"):
        np.testing.assert_array_equal(_read(ours / f"night_{stage}.png"),
                                      _read(ref / f"night_{stage}.png"))
    enh, ref_enh = _read(ours / "night_enhanced.png"), _read(ref / "night_enhanced.png")
    tpu = _tpu_night(_read(inputs["night"]), mode)
    assert _within(enh, tpu, max_diff) < 1e-3
    assert _within(enh, ref_enh, max_diff) <= float((tpu != ref_enh).mean()) + 1e-3
    for stage in ("original", "filtered", "enhanced"):
        gray = torch.from_numpy(_read(ours / f"night_{stage}.png"))
        if gray.dim() == 3:
            gray = color.rgb_to_gray(gray)
        text = (ours / f"night_{stage}_hist.csv").read_text().splitlines()
        assert len(text) == 256 and all(t.isdigit() for t in text)
        np.testing.assert_array_equal(np.array(text, dtype=np.int64),
                                      histogram.hist256(gray).numpy())


def _metrics(path) -> list:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def test_landscape_files_and_metrics(inputs, tmp_path):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    seed = 3
    _run("tpuimage", "landscape", [inputs["landscapes"], "--out", str(ref), "--seed", str(seed)])
    _port("landscape", [inputs["landscapes"], "--out", str(ours), "--seed", str(seed)])
    assert sorted(os.listdir(ref)) == sorted(os.listdir(ours))
    ref_rows, our_rows = _metrics(ref / "landscape_metrics.csv"), _metrics(ours / "landscape_metrics.csv")
    assert [r["file"] for r in our_rows] == [r["file"] for r in ref_rows] == ["land_a.png",
                                                                             "land_b.png"]
    key = jax.random.PRNGKey(seed)
    gen = torch.Generator().manual_seed(seed)
    for name, ref_row, our_row in zip(("land_a", "land_b"), ref_rows, our_rows):
        rgb = _read(inputs[name])
        for k in ("psnr_enhanced", "ssim_enhanced"):
            np.testing.assert_allclose(float(our_row[k]), float(ref_row[k]), rtol=1e-4)
        enhanced = _read(ours / f"{name}_enhanced.png")
        d = np.abs(enhanced.astype(np.int32) - _read(ref / f"{name}_enhanced.png"))
        assert d.max() <= PATH_TOL[0] and (d > 0).mean() < PATH_TOL[1]
        assert (d > 1).mean() < PATH_TOL[2]
        # the port's CLI: one generator drawn file after file
        mine = landscape.landscape_eval_step(torch.from_numpy(rgb), generator=gen)
        for k in ("enhanced", "degraded", "restored"):
            np.testing.assert_array_equal(_read(ours / f"{name}_{k}.png"), mine[k].numpy())
        for k in ("psnr_restored", "ssim_restored"):
            assert float(our_row[k]) == float(mine[k]), k
        # tpuimage's CLI: PRNGKey(seed) split per file; the port fed that noise
        key, sub = jax.random.split(key)
        noise = np.asarray(jax.random.normal(sub, rgb.shape, dtype=jnp.float32))
        held = landscape.landscape_eval_step(torch.from_numpy(rgb), noise=torch.from_numpy(noise))
        np.testing.assert_array_equal(held["degraded"].numpy(),
                                      _read(ref / f"{name}_degraded.png"))
        d = np.abs(held["restored"].numpy().astype(np.int32)
                   - _read(ref / f"{name}_restored.png"))
        assert d.max() <= PATH_TOL[0] and (d > 0).mean() < PATH_TOL[1]
        np.testing.assert_allclose(float(held["psnr_restored"]), float(ref_row["psnr_restored"]),
                                   rtol=1e-4)
        # the semantic difference: another noise stream at the same seed
        assert not np.array_equal(_read(ours / f"{name}_degraded.png"),
                                  _read(ref / f"{name}_degraded.png"))


def test_docscan_files_equal_process_document(inputs, tmp_path):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    _run("tpuimage", "docscan", [inputs["doc"], "--out", str(ref), *DOC_ARGS])
    _port("docscan", [inputs["doc"], "--out", str(ours), *DOC_ARGS, "--profile"])
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    cfg = docscan.DocScanConfig(scale_long=96, mask_blur_ksize=15, block_size=15)
    mem = tmp_path / "mem"
    res = docscan.process_document(_read(inputs["doc"]), out_dir=str(mem), config=cfg,
                                   device="cpu")
    np.testing.assert_array_equal(_read(ours / "scan_08_clean.png"), res["binary"].numpy())
    for n in os.listdir(mem):
        np.testing.assert_array_equal(_read(ours / n), _read(mem / n))


def test_face_files_equal_enhance_face(inputs, tmp_path):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    argv = [inputs["portrait"], "--no-eyes", "--noise-type", "impulse"]
    _run("tpuimage", "face", [*argv, "--out", str(ref)])
    _port("face", [*argv, "--out", str(ours)])
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    res = face.enhance_face(_read(inputs["portrait"]), noise_type="impulse", eyes=[],
                            device="cpu")
    for k in ("skin_mask", "skin_enhanced", "features_popped"):
        np.testing.assert_array_equal(_read(ours / f"face_{k}.png"), res[k].numpy())
    jpg = tmp_path / "mem.jpg"
    Image.fromarray(res["final"].numpy()).save(jpg)
    assert (ours / "enhanced_face.jpg").read_bytes() == jpg.read_bytes()


def test_classify_files_equal_classify_and_enhance(inputs, tmp_path, capsys):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    files = [inputs["night"], inputs["land_a"], inputs["doc"]]
    _run("tpuimage", "classify", [*files, "--out", str(ref)])
    _port("classify", [*files, "--out", str(ours)])
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(ref)) and len(names) == 3
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("CONFIRMED")]
    assert len(printed) == 6
    for f in files:
        label, probs, out = router.classify_and_enhance(_read(f), device="cpu")
        stem = os.path.splitext(os.path.basename(f))[0]
        np.testing.assert_array_equal(_read(ours / f"{stem}_{label}_enhanced.png"), out.numpy())
        dst = os.path.join(str(ours), f"{stem}_{label}_enhanced.png")
        assert f"CONFIRMED: path={f} type={label} probs={probs} -> {dst}" in printed
