"""repro_torch's sharding rules and mesh construction, held to the JAX
package's rules spec for spec.

The JAX rules run on abstract meshes (`repro.compat.make_abstract_mesh`),
the port's on `repro_torch.launch.mesh.make_abstract_mesh`; both need no
device and no process group.  Leaves come from `jax.eval_shape` of the
JAX package's `init_params` / `init_cache` at full size (every config),
the prepared fields' shapes derived from them, and from the port's own
`prepare_params` tree and paged pools at the reduced size.
"""

import functools

import jax
import pytest
import torch
from jax.tree_util import DictKey, GetAttrKey

from repro import configs as jconfigs
from repro.compat import make_abstract_mesh as jmesh
from repro.models import api as japi
from repro.sharding import ctx as jctx
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.approx import gemm as G
from repro_torch.core import accelerator as acc
from repro_torch.core import target as tg
from repro_torch.launch import mesh as meshmod
from repro_torch.models import api
from repro_torch.serving.arena import PagedArena
from repro_torch.sharding import ctx, rules

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((2, 16), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _meshes():
    return [(jmesh(s, n), meshmod.make_abstract_mesh(s, n))
            for s, n in MESHES]


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    cfg = jconfigs.get_config(arch)
    return jax.eval_shape(lambda: japi.init_params(cfg, jax.random.key(0)))


def _port_path(path) -> tuple:
    out = []
    for part in path:
        if isinstance(part, DictKey):
            out.append(str(part.key))
        elif isinstance(part, GetAttrKey):
            out.append(rules.Attr(part.name))
        else:
            raise AssertionError(f"unexpected key {part!r}")
    return tuple(out)


def _prepared_fields(shape: tuple, planes: int) -> dict:
    """A PreparedWeight's field shapes for a (..., k, n) weight."""
    *lead, k, n = shape
    return {"w": shape, "wq": shape, "sw": (*lead, 1, n),
            "planes": (*lead, planes, k, n), "wq_t": (*lead, n, k)}


def _held(path, shape, jm, pm, fsdp):
    want = tuple(jrules.param_pspec(path, shape, jm, fsdp))
    got = rules.param_pspec(_port_path(path), shape, pm, fsdp)
    assert got == want, (path, shape, dict(pm.shape), fsdp, got, want)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_pspec_on_every_leaf_of_every_config(arch):
    tree = _ref_params(arch)
    names = api.family_module(configs.get_config(arch)).PREPARED_GEMM_WEIGHTS
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert leaves
    for jm, pm in _meshes():
        for fsdp in (True, False):
            for path, leaf in leaves:
                shape = tuple(leaf.shape)
                _held(path, shape, jm, pm, fsdp)
                if str(path[-1].key) not in names or len(shape) < 2:
                    continue
                # the serving cache's fields under the leaf's name
                fields = _prepared_fields(shape, 2)
                for f in ("w", "wq", "sw", "planes"):
                    _held((*path, GetAttrKey(f)), fields[f], jm, pm, fsdp)
                wq = rules.param_pspec(_port_path(path), shape, pm, fsdp)
                kmaj = rules.param_pspec((*_port_path(path),
                                          rules.Attr("wq_t")),
                                         fields["wq_t"], pm, fsdp)
                assert kmaj == (wq and (*wq[:-2], wq[-1], wq[-2])), path


@pytest.mark.parametrize("mult", ["trunc2x2", "pareto:0.02:r2"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m",
                                  "grok-1-314b", "whisper-medium"])
def test_param_pspec_on_the_ports_prepared_tree(arch, mult):
    """Every tensor of the port's prepared params (reduced, CPU, the
    kernels' K-major copies included) gets the JAX rule of its path."""
    cfg = configs.reduced(configs.get_config(arch), mult=mult,
                          kernel_policy="pallas")
    params = api.init_params(cfg, 0, "cpu")
    prepared = api.prepare_params(params, cfg, api.make_spec(cfg,
                                                             device="cpu"))
    specs_seen = 0
    for jm, pm in _meshes():
        got = rules.param_specs(prepared, pm, fsdp=False)
        for path, spec in got.items():
            if path[-1] == "wq_t":
                wq = got[(*path[:-1], rules.Attr("wq"))]
                assert spec == (wq and (*wq[:-2], wq[-1], wq[-2])), path
                continue
            jpath = tuple(GetAttrKey(p) if isinstance(p, rules.Attr)
                          else DictKey(p) for p in path)
            shape = tuple(dict(rules.tree_paths(prepared))[path].shape)
            assert spec == tuple(jrules.param_pspec(jpath, shape, jm,
                                                    False)), (path, spec)
            specs_seen += 1
    assert specs_seen > 0
    assert any(isinstance(p[-1], rules.Attr) for p in got)


@functools.lru_cache(maxsize=None)
def _caches(arch: str):
    jcfg = jconfigs.get_config(arch)
    ref = jax.eval_shape(lambda: japi.init_cache(jcfg, 8, 256))
    port = api.init_cache(configs.get_config(arch), 8, 256, device="meta")
    return ({str(p[-1].key): tuple(leaf.shape) for p, leaf in
             jax.tree_util.tree_leaves_with_path(ref)},
            {k: tuple(v.shape) for k, v in port.items()})


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_and_pool_pspecs_on_every_cache_leaf(arch):
    ref, port = _caches(arch)
    assert ref == port
    cfg = configs.get_config(arch)
    arena = PagedArena(cfg, 4, 256, 16, 65, torch.device("meta"))
    for jm, pm in _meshes():
        for key, shape in port.items():
            assert rules.cache_pspec(key, shape, pm) == \
                tuple(jrules.cache_pspec(key, shape, jm)), (key, shape)
            assert rules.paged_pool_pspec(key, shape, pm) == \
                tuple(jrules.paged_pool_pspec(key, shape, jm)), key
        for key in arena.paged:
            shape = tuple(arena.cache[key].shape)
            assert rules.paged_pool_pspec(key, shape, pm) == \
                tuple(jrules.paged_pool_pspec(key, shape, jm)), key


@pytest.mark.parametrize("shape", [(), (1,), (2, 16), (16, 128),
                                   (32, 1, 2048), (512, 4096), (3, 5, 7)])
def test_batch_pspec_and_spec_for(shape):
    for jm, pm in _meshes():
        assert rules.batch_pspec("tokens", shape, pm) == \
            tuple(jrules.batch_pspec("tokens", shape, jm))
        assert rules.dp_axes(pm) == jrules.dp_axes(jm)
        want = jrules.logical_rules(jm)
        assert rules.logical_rules(pm) == want
        logical = ("batch", "heads", "ff", "vocab", None)[:len(shape)]
        assert ctx.spec_for(shape, logical, pm, want) == \
            tuple(jctx.spec_for(shape, logical, jm, want))


def test_rule_introspection_and_fsdp_threshold():
    assert rules.known_param_rule_names() == \
        jrules.known_param_rule_names()
    assert rules.known_cache_keys() == jrules.known_cache_keys()
    for arch in configs.ARCH_IDS:
        assert rules.should_fsdp(configs.get_config(arch)) == \
            jrules.should_fsdp(jconfigs.get_config(arch)), arch
    x = torch.ones(3)
    assert ctx.hint(x, "batch") is x


def test_init_cache_keeps_the_ranks_heads_by_the_cache_rule():
    """Reduced TinyLlama (2 kv heads): a model axis of 2 keeps one kv head
    per rank; 4 does not divide, and the cache stays whole."""
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    whole = api.init_cache(cfg, 3, 16, device="cpu")
    assert whole["k"].shape[-2] == 2
    two = api.init_cache(cfg, 3, 16, device="cpu",
                         mesh=meshmod.make_abstract_mesh((2, 2),
                                                         ("data", "model")))
    assert two["k"].shape == (*whole["k"].shape[:-2], 1, cfg.hd)
    four = api.init_cache(cfg, 3, 16, device="cpu",
                          mesh=meshmod.make_abstract_mesh((1, 4),
                                                          ("data", "model")))
    assert four["k"].shape == whole["k"].shape
    ssm = configs.reduced(configs.get_config("mamba2-370m"))
    got = api.init_cache(ssm, 2, 16, device="cpu",
                         mesh=meshmod.make_abstract_mesh((1, 2),
                                                         ("data", "model")))
    want = api.init_cache(ssm, 2, 16, device="cpu")
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_make_mesh_from_spec_precedence_and_errors(monkeypatch):
    monkeypatch.setenv(meshmod.MESH_ENV_VAR, "data=1,model=1")
    m = meshmod.make_mesh_from_spec()
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    monkeypatch.setenv(meshmod.MESH_ENV_VAR, "model=3")
    # the argument wins over the environment
    assert meshmod.make_mesh_from_spec("model=1").shape == \
        {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="3 ranks.*has 1.*nproc-per-node 3"):
        meshmod.make_mesh_from_spec()
    monkeypatch.delenv(meshmod.MESH_ENV_VAR)
    assert meshmod.make_mesh_from_spec().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="unknown mesh axis"):
        meshmod.make_mesh_from_spec("rows=2")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        meshmod.mesh_from_axes((("rows", 1),))
    pod = meshmod.make_abstract_mesh((2, 2, 4), ("pod", "data", "model"))
    assert rules.dp_axes(pod) == ("pod", "data") and pod.size == 16
    die = acc.nvdla_default(256, 7)
    two = tg.HardwareTarget(die, n_dies=2, mesh_axes=(("model", 2),))
    with pytest.raises(ValueError, match="2 ranks.*has 1"):
        two.make_mesh()
    assert tg.HardwareTarget.monolithic(die).make_mesh().size == 1


def test_prepared_weight_blocks_are_the_blocks_of_the_whole():
    """A weight prepared for a rank's block holds the whole weight's bits
    in that block (each column's scale reads that column alone)."""
    spec = G.spec_from_name("pareto:0.02:r2").with_policy("xla")
    w = torch.randn((2, 24, 16), generator=torch.Generator().manual_seed(0))
    whole = G.prepare_weight(w, spec)
    for r in range(4):
        m = meshmod.Mesh((("data", 1), ("model", 4)), rank=r)
        block = G.prepare_weight(w, spec, m)
        sl = slice(4 * r, 4 * r + 4)
        assert block.tp == 4 and block.wq.shape == (2, 24, 4)
        assert torch.equal(block.wq, whole.wq[..., sl])
        assert torch.equal(block.sw, whole.sw[..., sl])
        assert torch.equal(block.planes, whole.planes[..., sl])
        assert torch.equal(block.w, w[..., sl])
        assert torch.equal(block.layer(1).wq, whole.wq[1][:, sl])
    # 18 columns do not divide 4 ways: the weight stays whole
    w18 = torch.randn((24, 18), generator=torch.Generator().manual_seed(1))
    odd = G.prepare_weight(w18, spec, m)
    assert odd.tp == 1 and odd.wq.shape == (24, 18)
    assert torch.equal(odd.wq, G.prepare_weight(w18, spec).wq)
