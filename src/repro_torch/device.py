"""Device resolution for every entry point of the port.

The port runs on the CUDA device.  A caller that wants the CPU (the tests,
a laptop) says so with `device="cpu"`; nothing falls back to the CPU on its
own, so a run that asked for the card and did not get it fails loudly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> the current CUDA device, raising when there is none; an
    explicit device is returned as given (after checking CUDA exists when
    it names CUDA)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
