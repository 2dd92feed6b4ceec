"""The MoE family (grok-1: MoE in every layer, top-2; llama4-maverick:
dense and MoE layers interleaved, a shared expert, top-1), repro_torch
against the JAX package on the CPU at the reduced configs (d 128, 4
experts, 2 layers; llama4 as one superblock of a dense and an MoE layer).

Params come from `repro.models.api.init_params` through
`weights.from_reference`; inputs from numpy seeds.  The JAX side runs
jitted outside `ctx.use_rules` under `kernel_policy="xla"`; the port
runs on the CPU under "pallas" (each kernel's plain version), with its
expert stacks prepared per expert matrix where the reference quantizes
them on every call (the same codes and scales).

Capacity couples the rows of a call in the reference (GShard-style:
`int(capacity_factor * top_k * t / e)` per call, positions by a cumsum
over the rows in order), so a decode row depends on its batch and a
chunked prefill differs from a whole one.  Two tests pin that both
packages couple the same way; `capacity_factor = e / top_k` (no token
dropped) removes the coupling.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.approx import gemm as jgemm
from repro.models import api as japi
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.approx import gemm as G
from repro_torch.models import api, moe, weights

ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
TOL = 1e-5
MAX_LEN = 32

torch.set_num_threads(1)


# --- moe_ffn ----------------------------------------------------------------

D, F, E = 64, 96, 4


def _ffn_inputs(seed: int, t: int, zero_router: bool = False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, D)).astype(np.float32)
    router = (np.zeros((D, E)) if zero_router else
              rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    wg, wu = (rng.standard_normal((E, D, F)).astype(np.float32) * D ** -0.5
              for _ in range(2))
    wd = rng.standard_normal((E, F, D)).astype(np.float32) * F ** -0.5
    return x, router, wg, wu, wd


def _jax_routing(x, router, top_k, cf):
    """The reference's routing, in its own ops: expert indices and the
    keep mask of each slot."""
    t = x.shape[0]
    cap = max(1, int(cf * top_k * t / E))
    probs = jax.nn.softmax(jnp.einsum("td,de->te", x, router), axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    keep = []
    for slot in range(top_k):
        onehot = jax.nn.one_hot(idx[:, slot], E, dtype=jnp.int32)
        pos = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
        keep.append(pos < cap)
    return np.asarray(idx), np.asarray(jnp.stack(keep, 1))


def _jax_moe(x, router, wg, wu, wd, top_k, cf, mult):
    spec = None if mult == "exact" else \
        jgemm.spec_from_name(mult).with_policy("xla")
    fn = jax.jit(lambda *a: jmoe.moe_ffn(*a, top_k, cf, spec))
    out, aux = fn(x, router, wg, wu, wd)
    return np.asarray(out), float(aux)


@pytest.mark.parametrize("drops", [True, False])
@pytest.mark.parametrize("mult", ["exact", "trunc2x2", "pareto:0.01"])
def test_moe_ffn_matches_jax(mult, drops):
    """Output and aux within 1e-5 of the reference's, expert indices and
    drop masks equal; with drops (capacity factor 0.5: 6 places per
    expert for 24 tokens) and without (e / top_k: none).  Prepared expert
    stacks give the raw stacks' bits."""
    top_k, t = 2, 24
    cf = 0.5 if drops else moe.no_drop_factor(E, top_k)
    x, router, wg, wu, wd = _ffn_inputs(3, t)
    want, aux_j = _jax_moe(x, router, wg, wu, wd, top_k, cf, mult)
    spec = None if mult == "exact" else \
        G.spec_from_name(mult).with_policy("pallas")
    tx = [torch.from_numpy(a) for a in (x, router, wg, wu, wd)]
    with moe.recording() as log:
        got, aux = moe.moe_ffn(*tx, top_k, cf, spec)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert abs(aux.item() - aux_j) <= TOL
    (r,) = log
    idx, keep = _jax_routing(x, router, top_k, cf)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert (not keep.all()) == drops
    if spec is not None:
        pw = [G.prepare_weight(w, spec) for w in tx[2:]]
        again, _ = moe.moe_ffn(tx[0], tx[1], *pw, top_k, cf, spec)
        assert torch.equal(again, got)


@pytest.mark.parametrize("mult", ["exact", "trunc2x2"])
def test_moe_ffn_tie_order_matches_jax(mult):
    """A zero router gives every expert the same probability: both
    packages take the lowest expert indices, in order, so every token
    lands on experts 0 and 1 and the capacity drops the later ones."""
    top_k, t, cf = 2, 10, 1.25
    x, router, wg, wu, wd = _ffn_inputs(4, t, zero_router=True)
    want, aux_j = _jax_moe(x, router, wg, wu, wd, top_k, cf, mult)
    spec = None if mult == "exact" else \
        G.spec_from_name(mult).with_policy("pallas")
    with moe.recording() as log:
        got, aux = moe.moe_ffn(*map(torch.from_numpy,
                                    (x, router, wg, wu, wd)),
                               top_k, cf, spec)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert abs(aux.item() - aux_j) <= TOL
    (r,) = log
    assert (r.expert_idx == torch.tensor([0, 1])).all()
    cap = moe.capacity_of(t, E, top_k, cf)
    assert r.keep.sum(0).tolist() == [cap, cap]
    idx, keep = _jax_routing(x, router, top_k, cf)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)


def test_dropped_rows_let_no_nan_through():
    """A dropped token's output is masked by `where`, not a multiply by
    zero: a NaN in another token's row (which fills a dropped token's
    gather position) does not reach it, as in the reference."""
    top_k, t, cf = 2, 10, 1.25
    x, router, wg, wu, wd = _ffn_inputs(4, t, zero_router=True)
    x[0, 0] = np.nan                  # token 0 fills position 0
    want, _ = _jax_moe(x, router, wg, wu, wd, top_k, cf, "trunc2x2")
    spec = G.spec_from_name("trunc2x2").with_policy("pallas")
    got, _ = moe.moe_ffn(*map(torch.from_numpy, (x, router, wg, wu, wd)),
                         top_k, cf, spec)
    assert np.isnan(want[0]).all() and torch.isnan(got[0]).all()
    assert np.isfinite(want[1:]).all() and torch.isfinite(got[1:]).all()
    np.testing.assert_allclose(got[1:].numpy(), want[1:], rtol=TOL,
                               atol=TOL)


def test_capacity_expression():
    """The reference's float expression, rounding included."""
    assert moe.capacity_of(128, 8, 2, 1.25) == 40
    assert moe.capacity_of(4, 8, 2, 1.25) == 1
    assert moe.capacity_of(128, 32, 1, 1.25) == 5
    assert moe.capacity_of(128, 128, 1, 1.25) == 1
    assert moe.capacity_of(3, 4, 2, 1.25) == 1
    # the no-drop factor gives every call a capacity of its token count,
    # at the expert counts of every MoE config and of the cuts
    for e, k in ((4, 2), (4, 1), (8, 2), (32, 1), (128, 1)):
        cf = moe.no_drop_factor(e, k)
        assert all(moe.capacity_of(t, e, k, cf) == t
                   for t in range(1, 1025)), (e, k)


# --- the models -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def setup(arch: str, mult: str, capacity_factor: float = 1.25):
    """(JAX config, port config, JAX params prepared, port params
    prepared, port spec, jitted JAX prefill / decode_step / chunk_step)."""
    cj = jconfigs.reduced(jconfigs.get_config(arch), mult=mult,
                          kernel_policy="xla",
                          capacity_factor=capacity_factor)
    ct = configs.reduced(configs.get_config(arch), mult=mult,
                         kernel_policy="pallas",
                         capacity_factor=capacity_factor)
    pj = japi.init_params(cj, jax.random.key(0))
    pt = weights.from_reference(jax.tree_util.tree_map(np.asarray, pj), ct,
                                "cpu")
    sj, st = japi.make_spec(cj), api.make_spec(ct, device="cpu")
    pre = jax.jit(lambda p, t, n: japi.prefill(p, t, cj, sj,
                                               max_len=MAX_LEN, true_len=n))
    dec = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cj, sj))
    chunk = jax.jit(lambda p, c, t, n: japi.chunk_step(p, c, t, cj, sj,
                                                       n_valid=n))
    return (cj, ct, japi.prepare_params(pj, cj, sj),
            api.prepare_params(pt, ct, st), st, pre, dec, chunk)


def _close(got: torch.Tensor, want) -> None:
    """Within 1e-4 of the logits' scale."""
    want = np.asarray(want)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _prefill_both(arch, mult, toks, true_len, cf=1.25):
    _, ct, pjp, ptp, st, pre, _, _ = setup(arch, mult, cf)
    lj, cache_j = pre(pjp, jnp.asarray(toks), jnp.asarray(true_len))
    lt, cache_t = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st,
                              max_len=MAX_LEN,
                              true_len=torch.from_numpy(true_len))
    return (lj, cache_j), (lt, cache_t)


@pytest.mark.parametrize("mult", ["trunc2x2", "exact"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, mult):
    """Four right-padded prompts: prefill's logits and K/V, then four
    greedy decode steps of the batch of four, logits and tokens."""
    _, ct, pjp, ptp, st, _, dec, _ = setup(arch, mult)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, ct.vocab, (4, 12)).astype(np.int32)
    true_len = np.array([12, 8, 11, 5], np.int32)
    (lj, cache_j), (lt, cache_t) = _prefill_both(arch, mult, toks, true_len)
    _close(lt, lj)
    for key in ("k", "v"):
        assert cache_t[key].shape == cache_j[key].shape
        np.testing.assert_allclose(cache_t[key].numpy(),
                                   np.asarray(cache_j[key]), rtol=TOL,
                                   atol=TOL)
    tj = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    tt = lt.argmax(-1).numpy()
    np.testing.assert_array_equal(tt, tj)
    for _ in range(4):
        lj, cache_j = dec(pjp, cache_j, jnp.asarray(tj[:, None]))
        lt, cache_t = api.decode_step(ptp, cache_t,
                                      torch.from_numpy(tt[:, None]).long(),
                                      ct, st)
        _close(lt, lj)
        tj = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        tt = lt[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(cache_t["length"].numpy(), true_len + 4)


@pytest.mark.parametrize("mult", ["trunc2x2", "exact"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_step_matches_jax(arch, mult):
    """A 6-token prefill, then chunk_step over 6 more tokens of which the
    last 2 are masked: every position's logits and the cache."""
    _, ct, pjp, ptp, st, pre, _, chunk = setup(arch, mult)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, ct.vocab, (1, 6)).astype(np.int32)
    nxt = rng.integers(0, ct.vocab, (1, 6)).astype(np.int32)
    (_, cache_j), (_, cache_t) = _prefill_both(
        arch, mult, toks, np.array([6], np.int32))
    lj, cache_j = chunk(pjp, cache_j, jnp.asarray(nxt),
                        jnp.asarray([4], jnp.int32))
    lt, cache_t = api.chunk_step(ptp, cache_t, torch.from_numpy(nxt).long(),
                                 ct, st, n_valid=4)
    _close(lt, lj)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_t[key].numpy(),
                                   np.asarray(cache_j[key]), rtol=TOL,
                                   atol=TOL)
    assert cache_t["length"].tolist() == [10]


def _decode_rows(arch, toks, true_len, rows, cf=1.25):
    """Prefill the batch, then one decode step of the batch's `rows`
    (each row's cache sliced out), in both packages: (JAX logits, port
    logits, the port's routing of the step's MoE calls)."""
    (lj, cache_j), (lt, cache_t) = _prefill_both(arch, "exact", toks,
                                                 true_len, cf)
    _, ct, pjp, ptp, st, _, dec, _ = setup(arch, "exact", cf)
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[rows]
    ax = 1 if ct.moe_every == 1 else 2          # the cache's batch axis
    ji, ti = jnp.asarray(rows), torch.as_tensor(rows)
    cj = {"k": cache_j["k"].take(ji, axis=ax),
          "v": cache_j["v"].take(ji, axis=ax),
          "length": cache_j["length"][ji]}
    ctt = {"k": cache_t["k"].index_select(ax, ti),
           "v": cache_t["v"].index_select(ax, ti),
           "length": cache_t["length"][ti]}
    lj, _ = dec(pjp, cj, jnp.asarray(tok[:, None]))
    with moe.recording() as log:
        lt, _ = api.decode_step(ptp, ctt, torch.from_numpy(tok[:, None]
                                                           ).long(), ct, st)
    return np.asarray(lj[:, -1]), lt[:, -1], log


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_rows_couple_through_capacity_as_in_jax(arch):
    """Reference behaviour, pinned in both packages: a decode row's logits
    depend on the other rows of its call.  The last of four rows is
    dropped by an expert that earlier rows filled, so decoding it alone
    gives other logits; the port moves them as JAX does.  With no token
    dropped (capacity factor e / top_k) the row is the same alone."""
    rng = np.random.default_rng(8)
    cfg = configs.reduced(configs.get_config(arch))
    toks = rng.integers(0, cfg.vocab, (4, 10)).astype(np.int32)
    true_len = np.array([10, 9, 10, 7], np.int32)
    batch_j, batch_t, log = _decode_rows(arch, toks, true_len, [0, 1, 2, 3])
    alone_j, alone_t, _ = _decode_rows(arch, toks, true_len, [3])
    np.testing.assert_allclose(batch_t.numpy(), batch_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(alone_t.numpy(), alone_j, rtol=0, atol=1e-4)
    assert any(not r.keep[3].all() for r in log)      # row 3 dropped
    moved_j = np.abs(batch_j[3] - alone_j[0]).max()
    moved_t = (batch_t[3] - alone_t[0]).abs().max().item()
    assert moved_j > 1e-2 and abs(moved_t - moved_j) <= 1e-4
    cf = moe.no_drop_factor(cfg.n_experts, cfg.top_k)
    batch_j, batch_t, log = _decode_rows(arch, toks, true_len, [0, 1, 2, 3],
                                         cf)
    alone_j, alone_t, _ = _decode_rows(arch, toks, true_len, [3], cf)
    assert all(r.keep.all() for r in log)
    assert np.abs(batch_j[3] - alone_j[0]).max() <= 1e-5
    assert (batch_t[3] - alone_t[0]).abs().max().item() <= 1e-5


def _whole_vs_chunked(arch, cf, seed=0):
    """Under exact products: a 16-token prompt prefilled whole against 8
    tokens prefilled and 8 chunked, last logits, in both packages."""
    _, ct, pjp, ptp, st, pre, _, chunk = setup(arch, "exact", cf)
    toks = np.random.default_rng(seed).integers(0, ct.vocab, (1, 16)
                                                ).astype(np.int32)
    (whole_j, _), (whole_t, _) = _prefill_both(
        arch, "exact", toks, np.array([16], np.int32), cf)
    (_, cache_j), (_, cache_t) = _prefill_both(
        arch, "exact", toks[:, :8], np.array([8], np.int32), cf)
    lj, _ = chunk(pjp, cache_j, jnp.asarray(toks[:, 8:]),
                  jnp.asarray([8], jnp.int32))
    lt, _ = api.chunk_step(ptp, cache_t, torch.from_numpy(toks[:, 8:]).long(),
                           ct, st)
    gap_j = np.abs(np.asarray(whole_j) - np.asarray(lj[:, -1])).max()
    gap_t = (whole_t - lt[:, -1]).abs().max().item()
    return gap_j, gap_t


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_parts_from_whole_as_in_jax(arch):
    """Reference behaviour, pinned in both packages: under exact products
    a chunked prefill (8 tokens, then chunk_step's decode steps of one
    token each) differs from the whole one, since each call's capacity
    comes from its own token count; the port's gap is JAX's.  With no
    token dropped the two agree to rounding."""
    cfg = configs.reduced(configs.get_config(arch))
    gap_j, gap_t = _whole_vs_chunked(arch, 1.25)
    assert gap_j > 1e-2 and abs(gap_t - gap_j) <= 1e-4
    gap_j, gap_t = _whole_vs_chunked(
        arch, moe.no_drop_factor(cfg.n_experts, cfg.top_k))
    assert gap_j <= 1e-5 and gap_t <= 1e-5


# --- params -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_carries_the_moe_leaves(arch):
    """`weights.from_reference` carries the `moe` subtree (llama4) and
    the router, we_* and ws_* leaves across at the reference's shapes and
    dtypes (a bf16 model: every leaf bf16), values equal; the port's own
    init gives the same tree."""
    cj = jconfigs.reduced(jconfigs.get_config(arch), dtype="bfloat16",
                          n_layers=4)
    ct = configs.reduced(configs.get_config(arch), dtype="bfloat16",
                         n_layers=4)
    pj = jax.tree_util.tree_map(np.asarray,
                                japi.init_params(cj, jax.random.key(0)))
    pt = weights.from_reference(pj, ct, "cpu")
    own = api.init_params(ct, 0, "cpu")
    moe_tree = "moe" if ct.moe_every > 1 else "layers"
    assert set(pt) == set(own) == set(pj)
    want = {"router", "we_gate", "we_up", "we_down"} | (
        {"ws_gate", "ws_up", "ws_down"} if ct.shared_expert else set())
    assert want <= set(pt[moe_tree]) == set(own[moe_tree])
    for path, arr in jax.tree_util.tree_flatten_with_path(pj)[0]:
        leaf, mine = pt, own
        for k in path:
            leaf, mine = leaf[k.key], mine[k.key]
        assert leaf.dtype == mine.dtype == torch.bfloat16, path
        assert leaf.shape == mine.shape == arr.shape, path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      arr.astype(np.float32))
    n_super = ct.n_layers // ct.moe_every
    lead = (n_super,) if ct.moe_every > 1 else (ct.n_layers,)
    assert pt[moe_tree]["we_gate"].shape == (*lead, ct.n_experts,
                                             ct.d_model, ct.d_ff)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_stacks_prepare_per_expert_matrix(arch):
    """`api.prepare_params` prepares each (layer, expert) matrix of the
    we_* stacks; `.layer(i).layer(e)` slices one, bit-equal to preparing
    that matrix alone; the router stays float."""
    _, ct, _, ptp, st, *_ = setup(arch, "trunc2x2")
    tree = ptp["moe"] if ct.moe_every > 1 else ptp["layers"]
    pw = tree["we_down"]
    assert G.is_prepared(pw) and not G.is_prepared(tree["router"])
    assert pw.wq.shape == (*pw.w.shape[:-2], ct.d_ff, ct.d_model)
    one = pw.layer(0).layer(1)
    fresh = G.prepare_weight(pw.w[0, 1], st)
    assert torch.equal(one.wq, fresh.wq) and torch.equal(one.sw, fresh.sw)


def test_init_layouts():
    """grok: every layer MoE in `layers` (n_layers, ...); llama4: dense
    `layers` (n_super, moe_every - 1, ...) with d_ff_dense, `moe`
    (n_super, ...) with the shared expert; the cache (n_super, moe_every,
    b, max_len, kv, hd), paging along max_len."""
    from repro_torch.serving.arena import PagedArena, SlotArena
    g = configs.reduced(configs.get_config(ARCHS[0]))
    pg = api.init_params(g, 0, "cpu")
    assert pg["layers"]["we_up"].shape == (2, 4, 128, 256)
    assert "moe" not in pg and "w_gate" not in pg["layers"]
    assert api.init_cache(g, 3, 8, "cpu")["k"].shape == (2, 3, 8, 2, 32)
    m = configs.reduced(configs.get_config(ARCHS[1]), n_layers=4)
    pm = api.init_params(m, 0, "cpu")
    assert pm["layers"]["w_gate"].shape == (2, 1, 128, m.d_ff_dense)
    assert pm["moe"]["ws_down"].shape == (2, 256, 128)
    assert pm["moe"]["router"].shape == (2, 128, 4)
    assert api.init_cache(m, 3, 8, "cpu")["k"].shape == (2, 2, 3, 8, 2, 32)
    assert SlotArena(m, 3, 16, torch.device("cpu")).slot_axes["k"] == 2
    arena = PagedArena(m, 3, 32, 8, 13, torch.device("cpu"))
    assert arena.paged == {"k": 2, "v": 2}


def test_llama4_blocks_run_dense_then_moe():
    """An interleaved superblock runs its dense layers, then its MoE
    layer: layer (0, 0) has no router, (0, 1) does."""
    from repro_torch.models import transformer
    m = configs.reduced(configs.get_config(ARCHS[1]), n_layers=4)
    p = api.init_params(m, 0, "cpu")
    order = [(idx, "router" in lp)
             for idx, lp, _ in transformer._blocks(p, m)]
    assert order == [((0, 0), False), ((0, 1), True), ((1, 0), False),
                     ((1, 1), True)]
