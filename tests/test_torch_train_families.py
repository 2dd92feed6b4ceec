"""`api.loss_fn` and every gradient leaf of the ssm, hybrid, encdec and
MoE configs, repro_torch against `jax.value_and_grad` of the JAX
package's `api.loss_fn` on the CPU under trunc2x2 (reduced configs, seq
32; helpers in tests/torch_train_checks.py): loss within 1e-5, each
leaf's max gap within 1e-4 of its max |g|.  The hybrid runs one
superblock and a tail block (4 layers) with an 8-token window, so its
windowed attention's backward sees the window bite; the MoE configs
carry the load-balance term into the loss (0.01 x aux).  Last, the
forward on `quantize_param_tree`'s int8 leaves."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.approx import quant as jquant
from repro.models import api as japi
from repro_torch.approx import quant
from repro_torch.models import api, moe, weights

import torch_train_checks as T

torch.set_num_threads(1)


@pytest.mark.parametrize("arch,over", [
    ("mamba2-370m", {}),
    ("recurrentgemma-9b", {"n_layers": 4, "window": 8}),
    ("whisper-medium", {}),
    ("grok-1-314b", {}),
    ("llama4-maverick-400b-a17b", {}),
])
def test_loss_and_grads_match_jax_trunc2x2(arch, over):
    T.check_loss_and_grads(arch, 1e-5, 1e-4, mult="trunc2x2", **over)


@pytest.mark.parametrize("arch", ["grok-1-314b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_aux_is_summed_once_per_block_under_remat(arch):
    """The aux term is each MoE layer's load-balance loss summed over the
    blocks, once per forward: the same with and without remat, and equal
    to the sum of what `moe_ffn` returns in the forward's calls.  Under
    remat the backward reruns every block, so `moe.recording()` logs each
    call a second time."""
    _, ct = T.configs_for(arch, mult="trunc2x2", kernel_policy="pallas")
    params = api.init_params(ct, 0, "cpu")
    toks = torch.from_numpy(T.batch_np(ct)["tokens"]).long()
    n_moe = ct.n_layers // ct.moe_every
    for remat in (False, True):
        c = dataclasses.replace(ct, remat=remat)
        p = {k: v for k, v in params.items()}
        p["embed"] = params["embed"].detach().requires_grad_()
        spec = api.make_spec(c, device="cpu")
        with moe.recording() as log:
            loss, ex = api.loss_fn(p, {"tokens": toks}, c, spec)
            assert len(log) == n_moe
            want = sum(((r.density / c.top_k * r.probs.mean(0)).sum()
                        * r.probs.shape[1] for r in log), 0.0)
            torch.autograd.grad(loss, p["embed"])
        assert len(log) == n_moe * (2 if remat else 1)
        assert torch.equal(ex["aux"], want)
        assert torch.equal(loss, ex["ce"] + 0.01 * ex["aux"])
        assert 0 < ex["aux"].item()


def test_encdec_forward_takes_frames():
    """Whisper's teacher-forced forward encodes the batch's frames: other
    frames move the logits; none means zeros."""
    _, ct = T.configs_for("whisper-medium", mult="trunc2x2",
                          kernel_policy="pallas")
    params = api.init_params(ct, 0, "cpu")
    b = {k: torch.from_numpy(v) for k, v in T.batch_np(ct).items()}
    b["tokens"] = b["tokens"].long()
    spec = api.make_spec(ct, device="cpu")
    with torch.no_grad():
        a, _ = api.forward(params, b, ct, spec)
        z, _ = api.forward(params, dict(b, frames=torch.zeros_like(
            b["frames"])), ct, spec)
        n, _ = api.forward(params, {"tokens": b["tokens"]}, ct, spec)
    assert not torch.equal(a, z)
    assert torch.equal(z, n)
    assert np.isfinite(a.numpy()).all()


@pytest.mark.parametrize("mult", ["exact", "trunc2x2"])
def test_forward_on_int8_params_matches_jax(mult):
    """`quantize_param_tree`'s {"q", "s"} leaves (every GEMM matrix of a
    512-wide model) go through the layer stacks and `_as_weight` as in
    the reference: the logits within 1e-5 of JAX's on its own quantized
    tree."""
    over = dict(mult=mult, kernel_policy="xla", d_model=512, d_ff=512,
                n_heads=8, n_kv_heads=4, head_dim=64, n_layers=1)
    cj, ct = T.configs_for("tinyllama-1.1b", **over)
    pj = T.reference_params(cj)
    params = weights.from_reference(jax.tree_util.tree_map(np.asarray, pj),
                                    ct, "cpu")
    qj = jax.jit(jquant.quantize_param_tree)(pj)
    qt = quant.quantize_param_tree(params)
    assert quant.is_qweight(qt["layers"]["wq"])
    assert quant.is_qweight(qt["lm_head"]) and torch.is_tensor(qt["embed"])
    toks = T.batch_np(cj)["tokens"]
    sj = japi.make_spec(cj)
    want, _ = jax.jit(lambda p, t: japi.forward(p, {"tokens": t}, cj, sj))(
        qj, toks)
    got, _ = api.forward(qt, {"tokens": torch.from_numpy(toks).long()}, ct,
                         api.make_spec(ct, device="cpu"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
