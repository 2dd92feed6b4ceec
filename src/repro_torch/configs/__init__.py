"""Architecture registry: one module per architecture, as in the JAX
package (`get_config("tinyllama-1.1b")`; dashes/dots map to underscores in
module names)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeSpec, reduced)

ARCH_IDS = [
    "tinyllama-1.1b",
    "qwen1.5-32b",
    "starcoder2-7b",
    "mistral-large-123b",
    "mamba2-370m",
    "llama-3.2-vision-11b",
    "grok-1-314b",
    "llama4-maverick-400b-a17b",
    "recurrentgemma-9b",
    "whisper-medium",
]


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch)}")
    cfg: ModelConfig = mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def apply_overrides(cfg: ModelConfig, *, reduced: bool = False,
                    mult: str = "", kernel_policy: str = "",
                    **extra) -> ModelConfig:
    """The CLI override dance of launch/serve: optional tiny same-family
    config, approximate multiplier, kernel-dispatch policy, plus arbitrary
    ModelConfig field overrides.  `mult` / `kernel_policy` treat "" as
    "flag not given"; extras apply unless None."""
    from repro_torch.configs import base
    if reduced:
        cfg = base.reduced(cfg)
    over = {}
    if mult:
        over["mult"] = mult
    if kernel_policy:
        over["kernel_policy"] = kernel_policy
    over.update({k: v for k, v in extra.items() if v is not None})
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return cfg
