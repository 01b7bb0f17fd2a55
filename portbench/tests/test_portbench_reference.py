"""The plain reference against the port's CPU path at small sizes: the
frozen copy computes what the port computes, so a sound run reads 0.
And the control, the reference one precision lower, reads past every
cell's limits."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, run

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"docscan.smartdoc_b8": (180, 320), "landscape.div2k_b8": (136, 204),
         "docscan.a4pages_b8": (300, 212), "landscape.div2k_b1": (136, 204)}


def _entry(workload):
    spec = run.load_cell(workload)
    cfg = spec["config"]
    return run._module("entries", cfg["entries"][spec["cell"]["entry"]]).Entry(
        cfg["settings"], "cpu"), spec


@pytest.mark.parametrize("workload", ["docscan.smartdoc_b8", "docscan.a4pages_b8",
                                      "landscape.div2k_b8"])
def test_reference_equals_the_port_on_the_cpu(workload):
    entry, spec = _entry(workload)
    pool = run.make_pool({**spec["cell"], "pool": 2}, 7, "cpu", SMALL[workload])
    got = entry.request(entry.payload(pool))
    for image, answer in zip(pool, got):
        readings = entry.compare(answer, entry.reference(image, "cpu"))
        assert all(v == 0 for v in readings.values()), readings


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        text = path.read_text()
        assert "import tpuimage" not in text and "from tpuimage" not in text, path
        assert "import jax" not in text, path


def test_the_docscan_reference_takes_the_configuration_as_run():
    from portbench.reference.docscan import DocScanConfig
    from tpuimage_torch.pipelines.docscan import GUI_DOCUMENT_CONFIG

    cfg = json.loads((ROOT / "portbench/configs/docscan_gui_a4.json").read_text())
    assert DocScanConfig(**cfg["settings"]) == DocScanConfig(
        **{k: getattr(GUI_DOCUMENT_CONFIG, k) for k in DocScanConfig.__dataclass_fields__})


@pytest.mark.parametrize("workload", list(SMALL))
def test_the_control_fails_the_limits(workload):
    """The control in the program's place, through the harness's own run
    and comparison, comes out as not correct, on a reading past its limit."""
    torch.manual_seed(0)
    r = control.run_control(workload, 11, 0.2, "cpu", SMALL[workload],
                            cell_overrides={"check_images": 8})
    assert r["failed"] == 0 and r["requests"] >= 1
    assert not r["correct"]
    assert any(r["readings"].get(k, 0.0) > lim for k, lim in r["limits"].items()), r["readings"]


def test_the_control_leaves_cached_tables_alone():
    entry, spec = _entry("landscape.div2k_b8")
    image = run.make_pool({**spec["cell"], "pool": 1}, 3, "cpu", (64, 96))[0]
    before = entry.reference(image, "cpu")
    entry.reference(image, "cpu", lower_precision=True)
    assert np.array_equal(entry.reference(image, "cpu"), before)


def test_the_landscape_entry_refuses_settings_it_does_not_run():
    """``landscape_gui`` takes no settings: a configuration stating others
    would change the reference and not the timed route, so it is refused."""
    spec = run.load_cell("landscape.div2k_b8")
    entry = run._module("entries", "landscape_gui")
    entry.Entry(spec["config"]["settings"], "cpu")
    with pytest.raises(ValueError):
        entry.Entry({**spec["config"]["settings"], "blend_strength": 0.6}, "cpu")
