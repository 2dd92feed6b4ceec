"""The port's train step against the JAX package's `make_train_fns` step
(jitted, outside the mesh rules: its sharded builder fails on this JAX),
on the CPU at reduced TinyLlama, batch 4 x seq 32 of the synthetic
Markov stream.  Both start from the reference's `init_fn` state, carried
over by `state_from_reference`; after every step the loss and gradient
norm agree within 1e-5 (relative) and every param within 1e-6 + 1e-2 x
the peak learning rate: Adam normalises each element's step, so an
element whose gradient is near eps (1e-8) turns an ulp of gradient into a
visible fraction of a step.  AdamW in f32, bf16 and int8 moments,
Adafactor, and both gradient-accumulation modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(1)

LR = 3e-4
BATCH, SEQ = 4, 32


def _configs(mult):
    over = dict(mult=mult, kernel_policy="xla")
    return (jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b"), **over),
            configs.reduced(configs.get_config("tinyllama-1.1b"), **over))


def _flat_params(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(
                v.float().numpy() if torch.is_tensor(v) else v, np.float32)
    return out


def _run_both(mult, steps, data_seed=1, lr=LR, warmup=10, **kw):
    """Step the reference and the port side by side; yields (step,
    reference metrics, port metrics, reference state, port state)."""
    cj, ct = _configs(mult)
    oj = jts.StepOptions(lr=lr, total_steps=100, warmup_steps=warmup, **kw)
    ot = ts.StepOptions(lr=lr, total_steps=100, warmup_steps=warmup, **kw)
    init_j, step_j = jts.make_train_fns(cj, oj)
    stj = init_j(jax.random.key(0))
    stt = ts.state_from_reference(jax.tree_util.tree_map(np.asarray, stj),
                                  ct, "cpu")
    _, step_t = ts.make_train_fns(ct, ot, "cpu")
    step_j = jax.jit(step_j)
    for i in range(steps):
        bnp = synthetic.batch_for(cj, "train", BATCH, SEQ, i, data_seed)
        stj, mj = step_j(stj, {k: jnp.asarray(v) for k, v in bnp.items()})
        stt, mt = step_t(stt, ts.batch_to(bnp, "cpu"))
        yield i, mj, mt, stj, stt


def _held(mj, mt, stj, stt, ptol=1e-6 + 1e-2 * LR):
    for key in ("loss", "gnorm"):
        want = float(mj[key])
        assert abs(mt[key].item() - want) <= 1e-5 * abs(want), (key, want)
    assert int(mt["step"]) == int(mj["step"]) == int(stt["step"])
    want = _flat_params(stj["params"])
    got = _flat_params(stt["params"])
    assert set(got) == set(want)
    for k in want:
        gap = np.abs(got[k] - want[k]).max()
        assert gap <= ptol, (k, gap)


def test_three_steps_match_jax_trunc2x2():
    for _, mj, mt, stj, stt in _run_both("trunc2x2", 3):
        _held(mj, mt, stj, stt)


def test_twenty_steps_match_jax_exact_and_the_loss_falls():
    """lr 3e-3 after 5 warmup steps: the mean loss of the last five steps
    is below that of the first five, in both packages alike (the batches
    are small, so single steps are noisy)."""
    losses = []
    for _, mj, mt, stj, stt in _run_both("exact", 20, lr=3e-3, warmup=5):
        _held(mj, mt, stj, stt, ptol=1e-6 + 1e-2 * 3e-3)
        losses.append(mt["loss"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.01, losses


@pytest.mark.parametrize("mode", ["scan_of_grad", "grad_of_scan"])
def test_accumulation_matches_jax(mode):
    for _, mj, mt, stj, stt in _run_both("trunc2x2", 2, accum_steps=2,
                                         accum_mode=mode):
        _held(mj, mt, stj, stt)


@pytest.mark.parametrize("kw", [{"moment_dtype": "bf16"},
                                {"moment_dtype": "int8"},
                                {"optimizer": "adafactor"}])
def test_optimizer_variants_match_jax(kw):
    for _, mj, mt, stj, stt in _run_both("trunc2x2", 2, **kw):
        _held(mj, mt, stj, stt)
    if kw.get("moment_dtype") == "int8":
        m = stt["opt"]["m"]["layers"]["wq"]
        assert isinstance(m, opt.QMoment) and m.q.dtype == torch.int8


def test_state_layout_and_leaf_names_match_jax():
    """`init_fn` gives the reference's state layout: the same leaf names
    (`jax.tree_util.keystr`, the checkpoint's keys), shapes and dtypes,
    QMoment fields included."""
    cj, ct = _configs("trunc2x2")
    for kw in ({"moment_dtype": "int8"}, {"optimizer": "adafactor"}):
        init_j, _ = jts.make_train_fns(cj, jts.StepOptions(**kw))
        shapes = jax.eval_shape(init_j, jax.random.key(0))
        want = {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
                for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        init_t, _ = ts.make_train_fns(ct, ts.StepOptions(**kw), "cpu")
        state = init_t(0)
        got = {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for n, t in ckpt._named_leaves(state)}
        assert got == want
        assert ckpt.leaf_names(state) == list(want)


def test_fsdp_waits_for_the_sharding_slice():
    """The sharding slice has come (`make_train_step`): on one device
    `StepOptions(fsdp=True)` no longer raises and is the unsharded step,
    as the JAX package's `make_train_fns` ignores it."""
    for _, mj, mt, stj, stt in _run_both("trunc2x2", 1, fsdp=True):
        _held(mj, mt, stj, stt)
