"""Parameter import from the JAX package's layout.

`from_reference` takes the JAX package's layer-stacked param pytree as
numpy arrays (for instance `jax.tree_util.tree_map(np.asarray, params)`)
and returns the port's params: the same nested dicts, the same shapes —
GEMM weights (k, n), per-output-channel quantization scales reduced over
k — as tensors on `device`.  Both packages then compute the same function
on the same numbers.  `cnn_from_reference` does the same for the CNN
parameter trees of `repro.models.cnn`, whose layers sit in lists.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api


def _convert(tree, dev: torch.device, dtype: torch.dtype):
    """Nested dicts and lists of arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: _convert(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dev, dtype) for v in tree]
    arr = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    return t.to(device=dev, dtype=dtype)


def from_reference(params_np: dict, cfg: ModelConfig,
                   device: str | torch.device | None = None) -> dict:
    api.family_module(cfg)      # raises for a family that is not ported
    return _convert(params_np, resolve_device(device),
                    getattr(torch, cfg.dtype))


def cnn_from_reference(params_np: dict,
                       device: str | torch.device | None = None,
                       dtype: torch.dtype = torch.float32) -> dict:
    """A `repro.models.cnn` VGG/ResNet param tree (numpy leaves, lists of
    per-layer dicts) -> the port's tree for `models.cnn`."""
    return _convert(params_np, resolve_device(device), dtype)
