"""DocScanner's served path: ``tpuimage_torch.pipelines.docscan.scan_batch``
over a list of uint8 RGB photos in host memory. It returns numpy results,
so a request ends with them in host memory. Judged against the plain
reference's ``scan_photo`` of each photo: the quad, ``use_whole``, the
clean binary page (the warp and every post-warp stage) and the deskew
angle."""
from __future__ import annotations

import numpy as np

# what a quad that one side found and the other did not, or a failed
# photo, reads as
MISSING = 1e9


class Entry:
    def __init__(self, settings: dict, device):
        from tpuimage_torch.pipelines import docscan

        self._scan = docscan.scan_batch
        self._config = docscan.DocScanConfig(**settings)
        self._device = device
        self.settings = settings

    def payload(self, images):
        return list(images)

    def request(self, payload):
        return self._scan(payload, self._config, device=self._device)

    @staticmethod
    def failures(results) -> int:
        return sum(1 for r in results if "error" in r)

    @staticmethod
    def work(results) -> dict:
        return {"gauss_chain": [tuple(r["binary"].shape) for r in results if "binary" in r]}

    def reference(self, image: np.ndarray, device, lower_precision: bool = False):
        from portbench.reference import docscan, lower_precision as lp
        import torch

        config = docscan.DocScanConfig(**self.settings)
        with lp.rounding(lower_precision):
            return docscan.scan_photo(torch.from_numpy(image).to(device), config)

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        """The numbers compared for one photo."""
        if "error" in got:
            return {"quad_px": MISSING, "use_whole": 1.0, "binary_share": 1.0,
                    "angle_deg": MISSING}
        gq, wq = got["quad"], want["quad"]
        if (gq is None) != (wq is None):
            quad_px = MISSING
        else:
            quad_px = 0.0 if gq is None else float(np.abs(np.asarray(gq, np.float64)
                                                          - np.asarray(wq, np.float64)).max())
        gb, wb = got["binary"], want["binary"]
        share = float((gb != wb).mean()) if gb.shape == wb.shape else 1.0
        return {"quad_px": quad_px,
                "use_whole": float(got["use_whole"] != want["use_whole"]),
                "binary_share": share,
                "angle_deg": abs(float(got["deskew_angle"]) - float(want["deskew_angle"]))}
