"""Unified model API for the `lm`, `ssm`, `hybrid` and `encdec` families:
spec resolution, init, the training forward and loss, the serving
weight-plane cache, and the prefill / decode / chunk steps the serving
engines drive.  Same signatures as the
JAX package's `repro.models.api`, plus an explicit `device` where
something is created.  `extras` carries a request's conditioning, as the
family's own functions name it: "frames" (b, enc_seq, d) for `encdec`,
"img_embeds" (b, n_img_tokens, d) for a cross-attention `lm`.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.approx import gemm as gemm_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as C
from repro_torch.models import encdec, mamba2, rglru, transformer

Params = dict[str, Any]

_FAMILIES = {"lm": transformer, "ssm": mamba2, "hybrid": rglru,
             "encdec": encdec}


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet "
            f"(ported: {sorted(_FAMILIES)})")
    return _FAMILIES[cfg.family]


def extras_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The conditioning a config consumes, by extras key, as one request's
    array shape: {} for a family that takes none."""
    out = {}
    if cfg.family == "encdec":
        out["frames"] = (cfg.enc_seq, cfg.d_model)
    if cfg.cross_every:
        out["img_embeds"] = (cfg.n_img_tokens, cfg.d_model)
    return out


def static_cache_keys(cfg: ModelConfig) -> frozenset:
    """Cache leaves that `decode_step` reads and never writes (it returns
    them as the same tensors): encdec's cross-attention K/V."""
    return getattr(family_module(cfg), "STATIC_CACHE_KEYS", frozenset())


def make_spec(cfg: ModelConfig, mult: str | None = None,
              device: str | torch.device | None = None
              ) -> gemm_mod.MultSpec | None:
    """Resolve the config's multiplier and its kernel-dispatch policy
    (`mult` overrides `cfg.mult`).  None for the exact multiplier.  The
    spec's tables live on `device` (default: the CUDA device)."""
    name = cfg.mult if mult is None else mult
    if name in ("exact", "", None):
        return None
    spec = gemm_mod.spec_from_name(name).with_policy(cfg.kernel_policy)
    return spec.to(resolve_device(device))


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Params:
    """Random params from a seeded `torch.Generator` on `device`; on the
    "meta" device (no generator there) the shapes and dtypes alone."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    return family_module(cfg).init_params(cfg, gen, dev)


def prepare_params(params: Params, cfg: ModelConfig,
                   spec: gemm_mod.MultSpec | None = None,
                   mesh=None) -> Params:
    """Serving-time weight-plane cache: every leaf named in the family's
    PREPARED_GEMM_WEIGHTS becomes a `PreparedWeight` (per-output-channel
    int8 quantization, plus the pre-mapped planes of the plain path),
    computed once instead of on every decode step.  Outputs through the
    prepared tree are bit-identical to the raw tree.  `spec=None` resolves
    through `make_spec(cfg)` on the params' device; identity for exact.

    Under a `mesh`, each leaf whose output dim divides the model axis
    keeps only this rank's column block (wq, wq_t, sw, planes; `w` a view
    of the source), the layout the column-parallel GEMMs run on
    (`approx.gemm`); the others stay whole.  The exact tier has no
    cache: its float weights stay whole and each GEMM multiplies the
    rank's column block."""
    if spec is None:
        spec = make_spec(cfg, device=params["embed"].device)
    if spec is None or spec.is_exact:
        return params
    names = family_module(cfg).PREPARED_GEMM_WEIGHTS

    def prep(name, leaf):
        if isinstance(leaf, dict):
            return {k: prep(k, v) for k, v in leaf.items()}
        if gemm_mod.is_prepared(leaf) or name not in names:
            return leaf
        if not torch.is_tensor(leaf) or leaf.ndim < 2 or \
                not leaf.is_floating_point():
            return leaf
        return gemm_mod.prepare_weight(leaf, spec, mesh)

    return {k: prep(k, v) for k, v in params.items()}


def forward(params: Params, batch: dict, cfg: ModelConfig, spec=None
            ) -> tuple[torch.Tensor, Any]:
    """batch: {"tokens": (b, s)} (+ "frames" for encdec, "img" for a
    cross-attention lm) -> (logits (b, s, v), aux loss).  Differentiable:
    training takes raw float params, never `prepare_params`' output."""
    kwargs = {}
    if cfg.family == "encdec":
        kwargs["frames"] = batch.get("frames")
    if cfg.cross_every:
        kwargs["img_embeds"] = batch.get("img")
    return family_module(cfg).forward(params, batch["tokens"], cfg, spec,
                                      **kwargs)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, spec=None
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (teacher-forced for encdec) plus 0.01 x
    the MoE load-balance term -> (total, {"ce", "aux"}).  Labels default
    to the tokens shifted left (0 at the end), the mask to ones with the
    last position off."""
    logits, aux = forward(params, batch, cfg, spec)
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    ce = C.softmax_xent(logits, labels, loss_mask(batch))
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def loss_mask(batch: dict) -> torch.Tensor:
    """The positions `loss_fn` averages over: the batch's "mask", else
    ones with the last position off (over the labels' shape, the
    tokens' where there are none)."""
    mask = batch.get("mask")
    if mask is None:
        shape = batch.get("labels", batch["tokens"]).shape
        mask = torch.ones(shape, dtype=torch.float32,
                          device=batch["tokens"].device)
        mask[:, -1] = 0.0
    return mask


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device | None = None, mesh=None,
               split_rows: bool = False) -> dict:
    """The decode cache at `batch` rows and `max_len` positions.  Under a
    `mesh` (or the active one, `sharding.ctx`) a family that runs its
    attention on the rank's heads keeps the rank's block of each K/V leaf
    by `sharding.rules.cache_pspec`'s model-axis rule.  With `split_rows`
    every leaf also keeps this data rank's rows where `cache_pspec` puts
    its batch dim on the dp axes (they divide `batch`): the leaf's block
    by `rules.local_shape` over those axes.  Every family's cache starts
    at zero."""
    from repro_torch.sharding import ctx, rules
    fam = family_module(cfg)
    dev = resolve_device(device)
    if mesh is not None:
        with ctx.use_rules(mesh, rules.logical_rules(mesh)):
            return init_cache(cfg, batch, max_len, dev,
                              split_rows=split_rows)
    mesh = ctx.active_mesh()
    if not split_rows or mesh is None:
        return fam.init_cache(cfg, batch, max_len, dev)
    dp = rules.dp_axes(mesh)
    out = {}
    for key, leaf in fam.init_cache(cfg, batch, max_len,
                                    torch.device("meta")).items():
        shape = tuple(leaf.shape)
        shape = rules.local_shape(shape, rules.cache_pspec(key, shape, mesh),
                                  mesh, axes=dp)
        out[key] = torch.zeros(shape, dtype=leaf.dtype, device=dev)
    return out


@torch.no_grad()
def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, spec=None, extras: dict | None = None
                ) -> tuple[torch.Tensor, dict]:
    """tokens (b, 1) -> (logits (b, 1, v), cache with length + 1).  K/V
    buffers (the dense family's, the hybrid's rings, encdec's self K/V)
    are updated in place; recurrent states come back as fresh tensors."""
    return family_module(cfg).decode_step(params, cache, tokens, cfg, spec,
                                          **(extras or {}))


@torch.no_grad()
def chunk_step(params: Params, cache: dict, tokens: torch.Tensor,
               cfg: ModelConfig, spec=None, extras: dict | None = None,
               n_valid: int | torch.Tensor | None = None
               ) -> tuple[torch.Tensor, dict]:
    """Advance a single-request decode cache by up to `tokens.shape[1]`
    tokens — the chunked-prefill primitive.

    A loop of `decode_step` over the chunk, each step given `extras`, so
    the cache sees exactly the ops a token-by-token decode runs.
    `n_valid` (an int, or a one-element tensor) masks the tail of a
    right-padded final chunk: steps at index >= n_valid leave the cache as
    it was, as the JAX package's masked scan does.  Since `decode_step`
    writes K/V in place, each of those steps runs on a scratch copy of the
    state after the valid steps, which also gives it the masked scan's
    logits; the paged engine passes its last chunk unpadded and runs no
    masked step.  Returns (logits (1, c, vocab) — position i holds the
    logits AFTER consuming tokens[:, i] — and the advanced cache).
    Restricted to b == 1: the partial-prefill workspace
    is per-request."""
    b, c = tokens.shape
    if b != 1:
        raise ValueError(f"chunk_step is single-request (got batch {b})")
    n = c if n_valid is None else int(n_valid)  # analysis: allow[JH101] a one-element n_valid is read once a chunk; the engines pass none
    logits = []
    for i in range(c):
        src = cache if i < n else {k: v.clone() for k, v in cache.items()}
        lg, new = decode_step(params, src, tokens[:, i:i + 1], cfg, spec,
                              extras)
        logits.append(lg[:, -1])
        if i < n:
            cache = new
    return torch.stack(logits, dim=1), cache


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, max_len: int | None = None,
            extras: dict | None = None,
            true_len: torch.Tensor | None = None) -> tuple:
    """tokens (b, s) -> (last-valid-position logits (b, v), cache padded to
    max_len).  `true_len` (b,) supports right-padded prompts."""
    return family_module(cfg).prefill(params, tokens, cfg, spec,
                                      max_len=max_len, true_len=true_len,
                                      **(extras or {}))


def param_count(params: Params) -> int:
    def count(x):
        if isinstance(x, dict):
            return sum(count(v) for v in x.values())
        return x.numel() if torch.is_tensor(x) else 0
    return count(params)
