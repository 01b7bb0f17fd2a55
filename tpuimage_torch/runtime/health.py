"""Device-health fail-fast for the CLIs (counterpart of
``tpuimage.runtime.health``).

tpuimage claims its device with ``jax.devices()`` in a daemon thread with
a deadline, because the claim could block during a worker outage. The
port claims a CUDA card the same way: ``torch.cuda.init()`` and one small
allocation in a daemon thread (it cannot be cancelled, but the process
can exit). Where torch sees no card at all, ``require_device`` raises at
once instead of waiting out the deadline. The CPU is always available.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

_lock = threading.Lock()
# str(device) -> (done event, [the claim's exception or None])
_claims: Dict[str, tuple] = {}


def _claim(dev: torch.device) -> tuple:
    with _lock:
        if str(dev) in _claims:
            return _claims[str(dev)]
        done, error = threading.Event(), [None]
        _claims[str(dev)] = (done, error)

    def claim():
        try:
            torch.cuda.init()
            torch.empty(1, device=dev)
            torch.cuda.synchronize(dev)
        except Exception as e:  # noqa: BLE001 — reported by require_device
            error[0] = e
        done.set()

    threading.Thread(target=claim, daemon=True, name="tpuimage-device-claim").start()
    return done, error


def device_available(timeout_s: float = 120.0, device="cuda") -> bool:
    """True once ``device`` is claimable; False if torch sees no card, the
    claim failed, or it has not completed within ``timeout_s``. Safe to call
    repeatedly: one claim thread per device."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"device_available: a CPU or CUDA device, not {device!r}")
    if not torch.cuda.is_available():
        return False
    done, error = _claim(dev)
    return done.wait(timeout_s) and error[0] is None


def require_device(timeout_s: float = 600.0, what: Optional[str] = None,
                   device="cuda") -> None:
    """Raise RuntimeError unless ``device`` is claimable within
    ``timeout_s``. Call before the first launch on paths that must not hang
    (CLIs, serving loops)."""
    dev = torch.device(device)
    if device_available(timeout_s, dev):
        return
    need = f" (needed for {what})" if what else ""
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device{need}: torch sees none. Run on the host with "
                           f"--device cpu (or device='cpu').")
    done, error = _claim(dev)
    if error[0] is not None:
        raise RuntimeError(f"claiming {dev} failed{need}: {error[0]}") from error[0]
    raise RuntimeError(f"claiming {dev} did not complete within {timeout_s:.0f}s{need}. "
                       f"Retry later, or run on the host with --device cpu "
                       f"(or device='cpu').")
