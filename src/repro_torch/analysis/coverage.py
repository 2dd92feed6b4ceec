"""SC: sharding-rule coverage over every model family's param, decode-cache
and batch leaves.

The JAX package's checker, over the port's own rules
(`repro_torch.sharding.rules`): the bug class is "a param leaf silently
missed a rule" — a weight that should split under tensor parallelism
falls through `rules.param_pspec`'s replicated default and nobody
notices until TP decode parts.  This checker walks the param tree
`api.init_params` builds on the "meta" device (shapes alone, no storage)
and the decode cache `api.init_cache` builds there, for one reduced
config per family, with leaf names resolved by the walk
`rules.param_pspec` itself takes (`rules.leaf_name`), so checker and
rules cannot diverge:

  SC301  a matrix-shaped param leaf with no partition rule and no
         exemption;
  SC302  a decode-cache leaf whose key has no batch-dim rule;
  SC303  a batch leaf whose leading axis stays unsharded on a mesh whose
         data axes divide it (`launch.mesh.make_abstract_mesh`, 2 x 2).

Vectors and scalars (ndim < 2) are structurally replicated and exempt.
Every exemption names WHY the leaf is replicated.  The port's rule set
is the JAX package's (`tests/test_torch_sharding_rules.py` holds them
spec for spec); where the port stores a weight otherwise, the column
blocks the GEMMs run on, that is ROADMAP Queue 3's "Storage follows the
GEMM's column rule", a storage choice of `prepare_params` that the
rules here do not see.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding

#: one representative architecture per family (reduced configs keep the
#: checker fast; rule resolution is shape-independent by name).
FAMILY_ARCHS = {
    "lm": "tinyllama-1.1b",
    "ssm": "mamba2-370m",
    "hybrid": "recurrentgemma-9b",
    "encdec": "whisper-medium",
}

#: param leaves (ndim >= 2) that are DELIBERATELY replicated.  Keyed by
#: resolved leaf name (`rules.leaf_name`); the value is the reason carried
#: into the report.  The JAX package's table, leaf for leaf.
PARAM_EXEMPTIONS: dict[str, str] = {
    # layer-stacked norm scales/biases: (layers, d) — per-layer vectors
    "ln1": "stacked RMSNorm scales: per-layer vectors, no matrix dim",
    "ln2": "stacked RMSNorm scales: per-layer vectors, no matrix dim",
    "ln": "stacked norm scales: per-layer vectors",
    "mln": "stacked MLP norm scales: per-layer vectors",
    "ln1b": "stacked LayerNorm biases: per-layer vectors",
    "ln2b": "stacked LayerNorm biases: per-layer vectors",
    "xln": "cross-attention norm scales: per-layer vectors",
    "xlnb": "cross-attention norm biases: per-layer vectors",
    "norm_gate": "mamba2 gated-norm scale: per-layer vector",
    # mamba2 SSD internals: per-head vectors and depthwise taps, which
    # the rules keep replicated (rules.py: only in_proj splits over the
    # model axis)
    "A_log": "mamba2 per-head decay: (layers, heads) vector",
    "D": "mamba2 skip gain: (layers, heads) vector",
    "dt_bias": "mamba2 dt bias: (layers, heads) vector",
    "conv_w": "depthwise conv taps: vector-unit arrays, deliberately "
              "replicated (rules.py mamba2/rg-lru comment)",
    "conv_b": "depthwise conv bias: per-channel vector",
    "lam": "rg-lru lambda: per-channel vector",
    # whisper biases: (layers, d) per-layer vectors
    "bq": "attention biases: per-layer vectors",
    "bv": "attention biases: per-layer vectors",
    "bo": "attention biases: per-layer vectors",
    "xbq": "cross-attention biases: per-layer vectors",
    "xbv": "cross-attention biases: per-layer vectors",
    "xbo": "cross-attention biases: per-layer vectors",
    "mb_up": "MLP biases: per-layer vectors",
    "mb_down": "MLP biases: per-layer vectors",
}

#: batch keys whose leading dim is NOT the batch axis (never sharded).
BATCH_EXEMPTIONS: dict[str, str] = {}


def family_config(family: str):
    """The reduced config the checker walks for `family`."""
    from repro_torch import configs
    return configs.apply_overrides(configs.get_config(FAMILY_ARCHS[family]),
                                   reduced=True)


def param_leaves(cfg) -> list[tuple[str | None, tuple[int, ...]]]:
    """(resolved name, shape) of every param tensor leaf of `cfg`'s tree,
    built on the "meta" device."""
    from repro_torch.models import api
    from repro_torch.sharding import rules
    tree = api.init_params(cfg, device="meta")
    return [(rules.leaf_name(path)[0], tuple(leaf.shape))
            for path, leaf in rules.tree_paths(tree)]


def _check_params(cfg, leaves) -> list[Finding]:
    from repro_torch.sharding import rules
    known = rules.known_param_rule_names()
    out: list[Finding] = []
    for name, shape in leaves:
        if len(shape) < 2:
            continue  # vectors/scalars: structurally replicated
        if name in known or name in PARAM_EXEMPTIONS:
            continue
        out.append(Finding(
            "SC301", f"sharding/rules:{cfg.family}",
            f"param leaf `{name}` {shape} of {cfg.name} has no partition "
            f"rule and no exemption — give it a rule in "
            f"rules._param_rules or justify replication in "
            f"coverage.PARAM_EXEMPTIONS"))
    return out


def _check_cache(cfg, cache: dict) -> list[Finding]:
    from repro_torch.sharding import rules
    known = rules.known_cache_keys()
    return [Finding(
        "SC302", f"sharding/rules:{cfg.family}",
        f"decode-cache leaf `{key}` {tuple(leaf.shape)} of {cfg.name} has "
        f"no batch-dim rule in rules._CACHE_BATCH_DIM")
        for key, leaf in cache.items() if key not in known]


def _check_batch(cfg, mesh) -> list[Finding]:
    from repro_torch.sharding import rules
    out: list[Finding] = []
    batch = 8  # divisible by any reasonable data-axis product
    keys = {"tokens": (batch, 16), "labels": (batch, 16),
            "mask": (batch, 16)}
    if cfg.family == "encdec":
        keys["frames"] = (batch, cfg.enc_seq, cfg.d_model)
    if cfg.cross_every:
        keys["img"] = (batch, cfg.n_img_tokens, cfg.d_model)
    for key, shape in keys.items():
        if key in BATCH_EXEMPTIONS:
            continue
        spec = rules.batch_pspec(key, shape, mesh)
        if not spec or spec[0] is None:
            out.append(Finding(
                "SC303", f"sharding/rules:{cfg.family}",
                f"batch leaf `{key}` {shape} of {cfg.name} stays "
                f"replicated on mesh {dict(mesh.shape)} although its "
                f"batch dim divides the data axes"))
    return out


def check(root: str | None = None, device=None) -> list[Finding]:
    """Every family's leaves on a (data=2, model=2) abstract mesh.  Shapes
    only: nothing is allocated, and `device` is not used."""
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models import api
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    findings: list[Finding] = []
    for family in FAMILY_ARCHS:
        cfg = family_config(family)
        findings.extend(_check_params(cfg, param_leaves(cfg)))
        findings.extend(_check_cache(
            cfg, api.init_cache(cfg, 2, 32, device="meta")))
        findings.extend(_check_batch(cfg, mesh))
    return findings
