"""Fixed-capacity slot arena for decode state.

The arena is the model's decode cache allocated once at `capacity` slots
(K/V (L, capacity, max_len, kv, hd) and a per-slot (capacity,) length).
Admitting a request copies its single-row prefill cache into a free slot
in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


class SlotArena:
    """The batched decode cache; `cache["length"]` is per-slot."""

    def __init__(self, cfg: ModelConfig, capacity: int, max_len: int,
                 device: torch.device):
        self.cfg, self.capacity, self.max_len = cfg, capacity, max_len
        cache = api.init_cache(cfg, capacity, max_len, device)
        cache["length"] = torch.zeros((capacity,), dtype=torch.int32,
                                      device=device)
        self.cache = cache

    def insert(self, req_cache: dict, slot: int) -> None:
        """Copy a 1-row prefill cache (built with max_len=self.max_len and
        a true_len vector) into `slot`."""
        for key in ("k", "v"):
            self.cache[key][:, slot] = req_cache[key][:, 0].to(
                self.cache[key].dtype)
        self.cache["length"][slot] = req_cache["length"].reshape(-1)[0]
