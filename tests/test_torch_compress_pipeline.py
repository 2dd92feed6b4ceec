"""The int8-compressed all-reduce with error feedback and the GPipe
schedule of repro_torch (`sharding/compress.py`, `sharding/pipeline.py`)
against the JAX package's own functions on the same numpy inputs.

The port runs one world of 4 CPU ranks under gloo (data=4, then a
stage=4 mesh of the same ranks; tests/torch_train_ranks.py); the JAX
package runs in a subprocess on 4 forced host devices, as its own
tests/test_distributed.py does, `shard_map` giving each device its row
by a reshape (its test indexes x[0], which this JAX refuses inside
`shard_map`)."""

import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

import torch_train_ranks as R
from repro_torch.launch import mesh as meshmod
from repro_torch.sharding import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, EF_STEPS = 4, 8
S, M, MB, D = 4, 6, 8, 32
TIMEOUT_S = 180.0


def inputs() -> dict:
    rng = np.random.default_rng(0)
    return {"xs": rng.standard_normal((N, 4096)).astype(np.float32),
            "g": rng.standard_normal((N, 1024)).astype(np.float32),
            "w": (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
            "x_mb": rng.standard_normal((M, MB, D)).astype(np.float32)}


_JAX = """
import functools, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.sharding import compress, pipeline

z = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("data",))

@jax.jit
@functools.partial(shard_map, mesh=mesh, in_specs=P("data"),
                   out_specs=P("data"), check_rep=False)
def summed(x):
    return compress.compressed_allreduce(x.reshape(x.shape[1:]),
                                         "data")[None]

@jax.jit
@functools.partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")), check_rep=False)
def ef(gs, es):
    out, e2 = compress.ef_compressed_allreduce(gs.reshape(gs.shape[1:]),
                                               es.reshape(es.shape[1:]),
                                               "data")
    return out[None], e2[None]

mean = jax.jit(compress.make_compressed_allreduce_fn(mesh, "data"))
g = jnp.asarray(z["g"])
e = jnp.zeros_like(g)
outs, errs = [], []
for _ in range(8):
    o, e = ef(g, e)
    outs.append(np.asarray(o))
    errs.append(np.asarray(e))
stage = jax.make_mesh((4,), ("stage",))
got = jax.jit(lambda w, x: pipeline.pipeline_apply(
    lambda wi, h: jnp.tanh(h @ wi), w, x, stage, "stage"))(
        jnp.asarray(z["w"]), jnp.asarray(z["x_mb"]))
np.savez(sys.argv[2], sum=np.asarray(summed(jnp.asarray(z["xs"]))),
         mean=np.asarray(mean(jnp.asarray(z["xs"][0]))),
         ef_out=np.stack(outs, 1), ef_err=np.stack(errs, 1),
         pipeline=np.asarray(got),
         bubble=pipeline.bubble_fraction(4, 6))
"""


@functools.lru_cache(maxsize=None)
def reference() -> dict:
    d = tempfile.mkdtemp(prefix="repro_compress_ref_")
    src, dst = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
    np.savez(src, **inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               f"count={N}", PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX), src,
                          dst], env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(dst) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def world() -> list:
    z = inputs()
    return meshmod.spawn(R.compress_pipeline_world, f"data={N}",
                         device="cpu", timeout_s=TIMEOUT_S,
                         args=(z["xs"], z["g"], EF_STEPS, z["w"],
                               z["x_mb"]))


def test_compressed_allreduce_is_the_jax_packages():
    """Bit for bit against the JAX package's compiled ring (absmax x
    f32(1/127), x / scale a true division, each hop's dequantize-and-add
    one fused multiply-add), and
    within the reference test's bound of the exact sum, every rank the
    same."""
    ref = reference()
    want = inputs()["xs"].sum(0)
    tol = 0.05 * np.abs(want).max()
    for r, rank in enumerate(world()):
        np.testing.assert_array_equal(rank["sum"], ref["sum"][r])
        assert np.abs(rank["sum"] - want).max() < tol
        np.testing.assert_array_equal(rank["sum"], world()[0]["sum"])


def test_compressed_mean_is_the_jax_packages():
    """`make_compressed_allreduce_fn` on a tensor replicated over the
    axis: the reference's mean, bit for bit, on every rank."""
    ref = reference()
    for rank in world():
        np.testing.assert_array_equal(rank["mean"], ref["mean"])


@pytest.mark.parametrize("step", range(EF_STEPS))
def test_error_feedback_residual_matches_per_rank(step):
    ref = reference()
    for r, rank in enumerate(world()):
        np.testing.assert_array_equal(rank["ef_err"][step],
                                      ref["ef_err"][r, step])
        np.testing.assert_array_equal(rank["ef_out"][step],
                                      ref["ef_out"][r, step])


def test_error_feedback_tracks_the_running_sum():
    """The reference test's claim: with error feedback the running sum of
    8 compressed reductions is within 2% of the true one."""
    want = EF_STEPS * inputs()["g"].sum(0)
    for rank in world():
        acc = rank["ef_out"].astype(np.float64).sum(0)
        rel = np.abs(acc - want).mean() / (np.abs(want).mean() + 1e-6)
        assert rel < 0.02, rel


def test_compressed_wire_is_int8_codes():
    """Each rank sends 2 (n - 1) hops of a quarter of the tensor as int8
    codes, plus one f32 scale per hop: the compressed path's wire."""
    n_elems = 4096 // N
    hops = 2 * (N - 1)
    calls = 1 + 1 + EF_STEPS       # sum, mean, error-feedback steps
    ef_elems = 1024 // N
    want = (hops * (n_elems + 4) * 2 + hops * (ef_elems + 4) * EF_STEPS)
    for rank in world():
        assert rank["wire"]["ppermute"] == want, (rank["wire"], calls)


def test_pipeline_matches_the_jax_package_and_the_sequential_stack():
    ref = reference()
    for rank in world():
        np.testing.assert_array_equal(rank["pipeline"], rank["sequential"])
        np.testing.assert_allclose(rank["pipeline"], ref["pipeline"],
                                   rtol=2e-5, atol=2e-5)
    assert pipeline.bubble_fraction(S, M) == float(ref["bubble"])


def test_pipeline_is_forward_only():
    assert "forward only" in world()[0]["grad"]


def test_stage_axis_parses_and_leads_the_mesh():
    assert meshmod.parse_spec("data=2,stage=2") == (("stage", 2),
                                                    ("data", 2))
    assert meshmod.parse_spec("model=2") == (("model", 2),)
    for bad in ("stage=0", "stage=x", "stage=2,stage=2"):
        with pytest.raises(ValueError, match="stage"):
            meshmod.parse_spec(bad)
    mesh = meshmod.mesh_from_axes((("stage", 1),))
    assert mesh.axis_names == ("stage", "data", "model")
