"""The GUI's landscape route: ``tpuimage_torch.pipelines.landscape.landscape_gui``
on a (B, H, W, 3) uint8 stack in host memory, which it uploads; the
enhanced stack is copied back. Judged against the plain reference's
route on each photo."""
from __future__ import annotations

import numpy as np

# What ``landscape_gui`` runs: it takes no settings, so the configuration's
# have to be these, or the reference would judge another route than the
# timed one.
ROUTE = {"bilateral_d": 9, "bilateral_sigma_color": 100.0, "bilateral_sigma_space": 75.0,
         "clahe_clip_limit": 2.2, "clahe_tile_grid": [8, 8], "sky_protection_power": 2.0,
         "blend_strength": 0.55, "sharpen_amount": 0.8, "sharpen_sigma": 1.0}


class Entry:
    def __init__(self, settings: dict, device):
        from tpuimage_torch.pipelines import landscape

        if settings != ROUTE:
            raise ValueError(f"landscape_gui runs {ROUTE}; the configuration states {settings}")
        self._route = landscape.landscape_gui
        self._device = device
        self.settings = settings

    def payload(self, images):
        return np.stack(images)

    def request(self, payload):
        return list(self._route(payload, device=self._device).cpu().numpy())

    @staticmethod
    def failures(results) -> int:
        return 0

    @staticmethod
    def work(results) -> dict:
        return {"bilateral": [tuple(r.shape[:2]) for r in results]}

    def reference(self, image: np.ndarray, device, lower_precision: bool = False):
        from portbench.reference import landscape, lower_precision as lp
        import torch

        with lp.rounding(lower_precision):
            out = landscape.landscape_gui(torch.from_numpy(image[None]).to(device),
                                          self.settings)
        return out[0].cpu().numpy()

    @staticmethod
    def compare(got: np.ndarray, want: np.ndarray) -> dict:
        """The numbers compared for one photo: the largest level difference
        and the share of values that differ."""
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        return {"max_diff": float(diff.max()), "diff_share": float((diff > 0).mean())}
