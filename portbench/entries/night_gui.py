"""The GUI's night route: ``tpuimage_torch.pipelines.night.night_gui`` on
a (B, H, W, 3) uint8 stack in host memory, which it uploads; the
``enhanced`` stack is copied back, as the GUI shows it. Judged against
the plain reference's route on each photo."""
from __future__ import annotations

import numpy as np

# What ``night_gui`` runs: it takes no settings, so the configuration's
# have to be these, or the reference would judge another route than the
# timed one.
ROUTE = {"median_ksize": 3, "clahe_clip_limit": 2.0, "clahe_tile_grid": [8, 8]}


class Entry:
    def __init__(self, settings: dict, device):
        from tpuimage_torch.pipelines import night

        if settings != ROUTE:
            raise ValueError(f"night_gui runs {ROUTE}; the configuration states {settings}")
        self._route = night.night_gui
        self._device = device
        self.settings = settings

    def payload(self, images):
        return np.stack(images)

    def request(self, payload):
        return list(self._route(payload, device=self._device)["enhanced"].cpu().numpy())

    @staticmethod
    def failures(results) -> int:
        return 0

    @staticmethod
    def work(results) -> dict:
        return {"photos": [tuple(r.shape[:2]) for r in results]}

    def reference(self, image: np.ndarray, device, lower_precision: bool = False):
        from portbench.reference import lower_precision as lp, night
        import torch

        with lp.rounding(lower_precision):
            out = night.night_gui(torch.from_numpy(image[None]).to(device), self.settings)
        return out[0].cpu().numpy()

    @staticmethod
    def compare(got: np.ndarray, want: np.ndarray) -> dict:
        """The numbers compared for one photo: the largest level difference
        and the share of values that differ."""
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        return {"max_diff": float(diff.max()), "diff_share": float((diff > 0).mean())}
