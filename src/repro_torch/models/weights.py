"""Parameter import from the JAX package's layout.

`from_reference` takes the JAX package's layer-stacked param pytree as
numpy arrays (for instance `jax.tree_util.tree_map(np.asarray, params)`)
and returns the port's params: the same nested dicts, the same shapes —
GEMM weights (k, n), per-output-channel quantization scales reduced over
k — as tensors on `device`.  Both packages then compute the same function
on the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api


def from_reference(params_np: dict, cfg: ModelConfig,
                   device: str | torch.device | None = None) -> dict:
    api.family_module(cfg)      # raises for a family that is not ported
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        arr = np.asarray(x)
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        return t.to(device=dev, dtype=dtype)

    return conv(params_np)
