"""Shared helpers of the training tests: the same seeded params and batch
through the JAX package's `api.loss_fn` under `jax.value_and_grad` and
through repro_torch's under autograd.

The reference runs outside `ctx.use_rules` (its sharded step fails on
this JAX), jitted in f32 and eagerly (`jax.disable_jit()`) in bf16, whose
quantizer scale jitted XLA keeps in f32 (ROADMAP Queue 3); both sides on
the plain path (`kernel_policy="xla"` in JAX, "pallas" in the port: each
kernel's plain version on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from repro_torch.models import api, weights

#: The data seed of the loss and gradient checks.  Under trunc2x2 the
#: batch of seed 0 puts one int8 code of reduced TinyLlama on a rounding
#: tie (pinned by `test_seed0_loss_gap_is_one_int8_rounding_tie`).
SEED = 2
BATCH, SEQ = 2, 32


def configs_for(arch: str, **over):
    """(reference config, port config): reduced, with `over` applied."""
    return (jconfigs.reduced(jconfigs.get_config(arch), **over),
            configs.reduced(configs.get_config(arch), **over))


def batch_np(cfg, seed: int = SEED) -> dict:
    """Tokens, and the frames / image embeddings the config consumes."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.cross_every:
        out["img"] = (rng.standard_normal(
            (BATCH, cfg.n_img_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def flatten(tree, prefix=()) -> dict:
    """{key path: leaf} of a nested-dict tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def jax_value_and_grad(cj, pj, bnp, eager: bool = False):
    dtype = jnp.dtype(cj.dtype)
    b = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else dtype)
         for k, v in bnp.items()}
    sj = japi.make_spec(cj)
    fn = jax.value_and_grad(lambda p, bb: japi.loss_fn(p, bb, cj, sj)[0])
    if eager:
        with jax.disable_jit():
            loss, grads = fn(pj, b)
    else:
        loss, grads = jax.jit(fn)(pj, b)
    return float(loss), {tuple(p.key for p in path): np.asarray(
        g, np.float32) for path, g in jax.tree_util.tree_flatten_with_path(
            grads)[0]}


def torch_value_and_grad(ct, params, bnp):
    dtype = getattr(torch, ct.dtype)
    b = {k: torch.from_numpy(v).to(torch.int64 if k == "tokens" else dtype)
         for k, v in bnp.items()}
    leaves = flatten(params)
    for v in leaves.values():
        v.requires_grad_()
    loss, _ = api.loss_fn(params, b, ct, api.make_spec(ct, device="cpu"))
    keys = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                allow_unused=True)
    return loss, {k: (torch.zeros_like(leaves[k]) if g is None else g)
                  for k, g in zip(keys, grads)}


def reference_params(cj):
    """The reference's seeded params; a cross-attention model's gates set
    to 1.0 (they start at 0, and tanh(0) multiplies the image path
    away)."""
    pj = japi.init_params(cj, jax.random.key(0))
    if cj.cross_every:
        pj["cross"]["xgate"] = jnp.ones_like(pj["cross"]["xgate"])
    return pj


def check_loss_and_grads(arch: str, loss_tol: float, grad_tol: float,
                         eager: bool = False, seed: int = SEED, **over):
    """The reference's and the port's loss within `loss_tol`, each
    gradient leaf's max gap within `grad_tol` x that leaf's max |g|."""
    cj, ct = configs_for(arch, kernel_policy="xla", **over)
    ct = configs.apply_overrides(ct, kernel_policy="pallas")
    pj = reference_params(cj)
    params = weights.from_reference(jax.tree_util.tree_map(np.asarray, pj),
                                    ct, "cpu")
    bnp = batch_np(cj, seed)
    lj, gj = jax_value_and_grad(cj, pj, bnp, eager)
    lt, gt = torch_value_and_grad(ct, params, bnp)
    assert lt.dtype == torch.float32
    assert abs(lt.item() - lj) <= loss_tol, (lt.item(), lj)
    assert set(gt) == set(gj)
    for k, want in gj.items():
        got = gt[k].detach().float().numpy()
        assert gt[k].dtype == params_dtype(params, k), k
        assert got.shape == want.shape, k
        if want.size:
            gap = np.abs(got - want).max()
            assert gap <= grad_tol * np.abs(want).max(), (k, gap)
    return lt.item(), lj


def params_dtype(params, key):
    v = params
    for k in key:
        v = v[k]
    return v.dtype
