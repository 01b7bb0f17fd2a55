"""DocScanner's served post-warp on flat pages: a (B, H, W, 3) uint8
stack in host memory is uploaded, run through
``tpuimage_torch.pipelines.docscan.docscan_post_warp_batch``, and its
served outputs (the clean page, the deskew angle and the edge-budget
flag) are copied back. Judged against the plain reference's post-warp
program of each page."""
from __future__ import annotations

import numpy as np

SERVED = ("clean", "deskew_angle", "deskew_overflow")


class Entry:
    def __init__(self, settings: dict, device):
        from tpuimage_torch.pipelines import docscan

        self._post_warp = docscan.docscan_post_warp_batch
        self._config = docscan.DocScanConfig(**settings)
        self._device = device
        self.settings = settings

    def payload(self, images):
        return np.stack(images)

    def request(self, payload):
        import torch

        out = self._post_warp(torch.from_numpy(payload).to(self._device), self._config)
        host = {k: out[k].cpu().numpy() for k in SERVED}
        return [{k: host[k][i] for k in SERVED} for i in range(len(payload))]

    @staticmethod
    def failures(results) -> int:
        return 0

    @staticmethod
    def work(results) -> dict:
        return {"gauss_chain": [tuple(r["clean"].shape) for r in results]}

    def reference(self, image: np.ndarray, device, lower_precision: bool = False):
        from portbench.reference import docscan, lower_precision as lp
        import torch

        config = docscan.DocScanConfig(**self.settings)
        with lp.rounding(lower_precision):
            out = docscan.docscan_post_warp_batch(torch.from_numpy(image[None]).to(device),
                                                  config)
        return {k: out[k][0].cpu().numpy() for k in SERVED}

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        """The numbers compared for one page."""
        gb, wb = got["clean"], want["clean"]
        share = float((gb != wb).mean()) if gb.shape == wb.shape else 1.0
        return {"binary_share": share,
                "angle_deg": abs(float(got["deskew_angle"]) - float(want["deskew_angle"]))}
