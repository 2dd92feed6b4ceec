"""Device resolution for every entry point of the port.

The port runs on the CUDA device.  A caller that wants the CPU (the tests,
a laptop) says so with `device="cpu"`; nothing falls back to the CPU on its
own, so a run that asked for the card and did not get it fails loudly.
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _props(index: int | None) -> tuple[str, int]:
    """(name, SM count) of the CUDA device `index` (None: the current)."""
    p = torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index)
    return p.name, p.multi_processor_count


def _index(device) -> int | None:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{dev} is not a CUDA device")
    return dev.index


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device, read from the card
    once per device index: the kernels' launch plans split work until
    their grids cover them."""
    return _props(_index(device))[1]


def device_name(device) -> str:
    """`torch.cuda.get_device_name` of a CUDA device, read once per index."""
    return _props(_index(device))[0]
