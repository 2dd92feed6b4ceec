"""PC: the CUDA kernels' shared-memory and grid contracts.

The JAX package's dispatch admits a GEMM by a declared VMEM model, which
its checker holds to the kernels' captured BlockSpecs.  The port's
kernels request their shared memory and grids inside the `.cu` files
(csrc/), and their split plans are computed in Python
(`kernels/qgemm.py`); this checker holds the two sides to each other and
to the card:

  PC401  `approx_qgemm.launch_model` (the Python model of every variant's
         dynamic shared memory, opt-in limit, block and grid) differs from
         the library's host-only query (csrc/query.cu), or a block exceeds
         the compiled kernel's largest — card only;
  PC402  a split plan or tile width does not tile its operands: plane 0's
         and skinny's splits must cover K with no empty split, and a
         padded operand must be a multiple of the tile the kernel runs;
  PC403  `dispatch.choose_gemm_path` admits a shape whose launches'
         modelled shared memory (dynamic, plus the compiled static bytes
         on the card) busts the opt-in limit per block: the card's own, or
         sm_90's 232,448 bytes on the CPU;
  PC404  the K-tail contract: a GEMM whose K pads (k_valid < K) is
         bit-exact with the unpadded plain version, the row quantizer's
         codes ignore a zero-padded tail, and flash attention masks keys
         past its length as a causal mask hides them (bit for bit on the
         card, where one tile loop runs both calls; within its f32
         tolerance on the CPU, whose BLAS groups a row's sums by length).
         The CPU holds the plain versions (what the wrappers run there)
         to that; the card holds each kernel;
  PC405  a tuning-cache entry (`kernels/autotune.py`) holds a plan the
         plan functions reject for its bucket, or one whose modelled
         shared memory busts the limit of the card it is keyed on.
         `dispatch._tuned_plan` ignores such entries at lookup, so this
         flags the producer, not a live scheduling hazard.

The JAX package's `$REPRO_VMEM_BUDGET` override has no counterpart: the
card's opt-in limit, read from the card, replaces the budget.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding

#: The rank of the rank-5 Pareto multiplier pareto:0.01, which the CNN and
#: low-rank check paths run (spelled out: resolving the name runs the
#: NSGA-II search).
PARETO_RANK = 5
#: Ranks probed on every shape: exact/truncation (0), the Pareto path's and
#: every plane count the skinny kernel's template instantiates.
PROBE_RANKS = (0, 1, 2, 4, PARETO_RANK, 8)
#: Odd (m, k, n) shapes beside the main paths': tails in every dim, a
#: one-column GEMM, Whisper's tied head, the vision model's image K/V.
ODD_GEMMS = ((5, 130, 100), (33, 4097, 72), (1, 16, 1), (32, 1024, 51865),
             (1500, 1024, 1024), (6400, 4096, 1024), (129, 200, 192))
#: (bh, sq, skv, d) of the flash launches the main paths make: a TinyLlama
#: prefill (32 heads, bucket 128), Whisper's encoder, StarCoder2's prefill;
#: every head dim the kernel takes, at both dtypes.
FLASH_PROBES = ((32, 128, 128, 64), (16, 1500, 1500, 64),
                (36, 128, 128, 128)) + tuple((8, 130, 130, d)
                                             for d in (32, 64, 128, 256))
#: The card's opt-in shared memory per block, by name, for PC405's
#: cache entries keyed on a card other than the one running.
CARD_SMEM_OPTIN = {"H100": 232448}
#: SMs of the card the CPU plans for (an H100 SXM).
CPU_SM_COUNT = 132


def _main_path_gemms() -> list[tuple[str, int, int, int]]:
    """(what, m, k, n) of the GEMMs the main paths give the kernels:
    TinyLlama-1.1B's layers and head at decode (capacity 4 and 8, and a
    chunk step's one row), a prefill (M = 128, its head at M = 1), a
    chunked prefill's first chunk (M = 32) and a training step (M = 1024,
    8 x 128); VGG16's conv GEMMs and FCs at batch 8."""
    from repro_torch import configs
    from repro_torch.models import cnn
    cfg = configs.get_config("tinyllama-1.1b")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    layer = [(d, d), (d, cfg.n_kv_heads * cfg.hd), (d, f), (f, d)]
    out = []
    for what, m, head_m in (("decode", 4, 4), ("decode", 8, 8),
                            ("chunk step", 1, 1), ("prefill", 128, 1),
                            ("chunk", 32, 1), ("train", 1024, 1024)):
        out += [(what, m, k, n) for k, n in layer]
        out.append((f"{what} head", head_m, d, v))
    c_in, hw = 3, 224
    for c in cnn.VGG_CFG["vgg16"]:
        if c == "M":
            hw //= 2
            continue
        out.append(("vgg16 conv", 8 * hw * hw, 9 * c_in, c))
        c_in = c
    out += [("vgg16 fc", 8, k, n)
            for k, n in ((25088, 4096), (4096, 4096), (4096, 1000))]
    return out


def probe_gemms() -> list[tuple[str, int, int, int, int]]:
    """(what, m, k, n, rank) of every GEMM the checks probe."""
    shapes = _main_path_gemms() + [("odd", *s) for s in ODD_GEMMS]
    return [(what, m, k, n, r) for what, m, k, n in shapes
            for r in PROBE_RANKS]


def _ceil(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def gemm_launches(m: int, k: int, n: int, rank: int, plan, *,
                  sm_count: int) -> list[tuple[str, tuple[int, ...]]]:
    """The (kernel, C entry-point args) launches `ops.approx_qgemm_planned`
    makes for an (m, k, n) GEMM at `rank` under `plan`, after its padding."""
    from repro_torch.kernels import qgemm
    if plan.path == "stacked":
        planes = rank + 1
        return [("stacked", (_ceil(m, plan.bm), _ceil(k, plan.bk),
                             _ceil(n, plan.bn), plan.bn, planes))]
    if plan.skinny:
        kp = _ceil(k, plan.bk)
        if plan.splits is None:
            splits, gran = qgemm.skinny_splits(kp, n, sm_count=sm_count)
        else:
            splits, gran = plan.splits, qgemm.skinny_gran(kp, plan.splits)
        return [("skinny", (m, kp, n, rank, splits, gran))]
    mp, kp, np_ = _ceil(m, plan.bm), _ceil(k, plan.bk), _ceil(n, plan.bn)
    if rank:
        return [("fused_b_planes", (np_, kp, rank)),
                ("fused", (mp, kp, np_, plan.bn, rank))]
    if plan.splits is None:
        splits, k_chunk = qgemm.plane0_splits(mp, kp, np_,
                                              sm_count=sm_count)
    else:
        splits, k_chunk = qgemm.plane0_split_plan(kp, plan.splits)
    out = [("plane0", (mp, kp, np_, k_chunk))]
    if splits > 1:
        out.append(("plane0_reduce", (mp, np_, splits)))
    return out


def quantize_launch(m: int, k: int, *, sm_count: int
                    ) -> tuple[str, tuple[int, ...]]:
    """The row quantizer's launch over m contiguous rows of k floats."""
    from repro_torch.kernels import quantize as qz
    p = qz.launch_plan(m, k, sm_count=sm_count)
    return "quantize_rows", (m, k, int(p.vec), p.lanes, p.vecs, p.threads,
                             p.blocks)


def _plan(m: int, k: int, n: int, rank: int, device):
    from repro_torch.kernels import dispatch
    return dispatch.choose_gemm_path(
        "pallas", m=m, k=k, n=n, device=device,
        mode="lowrank" if rank else "trunc", rank=rank)


def variants(device, sm_count: int) -> dict:
    """{(kernel, args): what} over every launch the probes make: each GEMM
    under its dispatch plan, the quantizer over its activation rows and its
    K-major weight's rows, flash at `FLASH_PROBES` in f32 and bf16."""
    out: dict = {}
    for what, m, k, n, rank in probe_gemms():
        where = f"{what} ({m}, {k}, {n}) rank {rank}"
        for launch in gemm_launches(m, k, n, rank,
                                    _plan(m, k, n, rank, device),
                                    sm_count=sm_count):
            out.setdefault(launch, where)
        for rows, cols in ((m, k), (n, k)):
            out.setdefault(quantize_launch(rows, cols, sm_count=sm_count),
                           f"{what} quantize ({rows}, {cols})")
    for bh, sq, skv, d in FLASH_PROBES:
        for bf16 in (0, 1):
            out.setdefault(("flash_attention", (bh, sq, skv, d, bf16)),
                           f"flash ({bh}, {sq}, {skv}, {d})")
    return out


def _loc(kernel: str) -> str:
    mod = {"quantize_rows": "quantize", "flash_attention": "flash_attention",
           "skinny": "skinny"}.get(kernel, "qgemm")
    return f"csrc/{mod}:{kernel}"


# --------------------------------------------------------------------------
# PC401: the Python model against the library (card only)
# --------------------------------------------------------------------------

def check_model(found: dict, query) -> tuple[list[Finding], dict]:
    """PC401 over `found` (`variants`): `query(kernel, args)` is the
    library's record (`build.query`).  Returns (findings, {(kernel, args):
    record})."""
    from repro_torch.kernels import approx_qgemm as qk
    out, records = [], {}
    for (kernel, args), where in found.items():
        rec = query(qk.QUERY_IDS[kernel], args)
        records[(kernel, args)] = rec
        want = qk.launch_model(kernel, args)
        got = qk.LaunchModel(rec["smem"], rec["smem_limit"], rec["threads"],
                             (rec["grid_x"], rec["grid_y"], rec["grid_z"]))
        if got != want:
            out.append(Finding(
                "PC401", _loc(kernel),
                f"{kernel}{args} ({where}): the Python model gives {want} "
                f"but the library requests {got}"))
        if rec["threads"] > rec["max_threads"]:
            out.append(Finding(
                "PC401", _loc(kernel),
                f"{kernel}{args} ({where}): a block of {rec['threads']} "
                f"threads exceeds the compiled kernel's "
                f"{rec['max_threads']}"))
    return out, records


# --------------------------------------------------------------------------
# PC402: split plans and tiles cover their operands
# --------------------------------------------------------------------------

def _split_findings(kind: str, k: int, splits: int, unit: int,
                    bounds: list[tuple[int, int]], where: str
                    ) -> list[Finding]:
    """A split of K into `bounds` ([lo, hi) bytes) must cover [0, K) in
    order with no empty split."""
    ok = bool(bounds) and len(bounds) == splits and bounds[0][0] == 0 and \
        bounds[-1][1] >= k and all(lo < hi for lo, hi in bounds) and \
        all(a[1] == b[0] for a, b in zip(bounds, bounds[1:])) and \
        bounds[-1][0] < k and all(lo % unit == 0 for lo, _ in bounds)
    if ok:
        return []
    return [Finding("PC402", f"kernels/qgemm:{kind}",
                    f"{where}: {splits} splits of K = {k} as {bounds} "
                    f"leave K uncovered or a split empty")]


def plane0_bounds(k: int, splits: int, k_chunk: int) -> list:
    return [(z * k_chunk, min(k, (z + 1) * k_chunk))
            for z in range(splits)]


def skinny_bounds(k: int, splits: int, gran: int) -> list:
    """csrc/skinny.cu: split z sums the units [z U / S, (z + 1) U / S)."""
    units = -(-k // gran)
    return [((z * units // splits) * gran,
             min(k, ((z + 1) * units // splits) * gran))
            for z in range(splits)]


def check_plans(gemms=None, *, sm_count: int = CPU_SM_COUNT
                ) -> list[Finding]:
    """PC402 over the probes' padded Ks: every split count plane 0 and the
    skinny kernel may be asked for (a plan's) and the count each picks for
    the card; the fused tile widths over N; the static plans' padding
    against the tiles the kernels take."""
    from repro_torch.kernels import approx_qgemm as qk
    from repro_torch.kernels import qgemm
    out: list[Finding] = []
    gemms = probe_gemms() if gemms is None else gemms
    ks = sorted({k for _, _, k, _, _ in gemms})
    for k in ks:
        kp = _ceil(k, qk.PLANE0_TILE[1])
        for want in range(1, -(-kp // qk.PLANE0_TILE[1]) + 1):
            splits, chunk = qgemm.plane0_split_plan(kp, want)
            where = f"plane0_split_plan({kp}, {want}) = ({splits}, {chunk})"
            out += _split_findings("plane0_split_plan", kp, splits,
                                   qk.PLANE0_TILE[1],
                                   plane0_bounds(kp, splits, chunk), where)
            if splits < want or \
                    qgemm.plane0_split_plan(kp, splits) != (splits, chunk):
                out.append(Finding(
                    "PC402", "kernels/qgemm:plane0_split_plan",
                    f"{where}: fewer splits than asked, or the count does "
                    f"not ask for itself again"))
        ks16 = _ceil(k, qk.SKINNY_TILE[0])
        for splits in range(1, -(-ks16 // 32) + 1):
            gran = qgemm.skinny_gran(ks16, splits)
            out += _split_findings(
                "skinny_gran", ks16, splits, gran,
                skinny_bounds(ks16, splits, gran),
                f"skinny_gran({ks16}, {splits}) = {gran}")
    for what, m, k, n, rank in gemms:
        where = f"{what} ({m}, {k}, {n}) rank {rank}"
        if m <= qk.SKINNY_MAX_M:
            ks16 = _ceil(k, qk.SKINNY_TILE[0])
            splits, gran = qgemm.skinny_splits(ks16, n, sm_count=sm_count)
            out += _split_findings(
                "skinny_splits", ks16, splits, gran,
                skinny_bounds(ks16, splits, gran),
                f"{where}: skinny_splits = ({splits}, {gran})")
            if gran != qgemm.skinny_gran(ks16, splits):
                out.append(Finding(
                    "PC402", "kernels/qgemm:skinny_splits",
                    f"{where}: unit {gran} is not skinny_gran's"))
        else:
            tm, tk, tn = qk.PLANE0_TILE
            mp, kp, np_ = _ceil(m, tm), _ceil(k, tk), _ceil(n, tn)
            splits, chunk = qgemm.plane0_splits(mp, kp, np_,
                                                sm_count=sm_count)
            out += _split_findings(
                "plane0_splits", kp, splits, tk,
                plane0_bounds(kp, splits, chunk),
                f"{where}: plane0_splits = ({splits}, {chunk})")
        for kernel in ("plane0", "fused"):
            bm, bk, bn = qk.choose_blocks(m, k, n, kernel=kernel)
            tile = qk.PLANE0_TILE if kernel == "plane0" else \
                qk.fused_tile(_ceil(n, bn))
            padded = (_ceil(m, bm), _ceil(k, bk), _ceil(n, bn))
            if any(p % t for p, t in zip(padded, tile)):
                out.append(Finding(
                    "PC402", "kernels/approx_qgemm:choose_blocks",
                    f"{where}: {kernel} pads to {padded}, which its tile "
                    f"{tile} does not divide"))
    return out


# --------------------------------------------------------------------------
# PC403: dispatch against the card's opt-in shared memory per block
# --------------------------------------------------------------------------

def smem_optin(device) -> int:
    """The opt-in shared memory per block: the card's, or sm_90's."""
    import torch
    from repro_torch.kernels import approx_qgemm as qk
    if torch.device(device).type != "cuda":
        return qk.H100_SMEM_OPTIN
    return int(torch.cuda.get_device_properties(
        torch.device(device)).shared_memory_per_block_optin)


def check_dispatch(found: dict, limit: int, records: dict | None = None
                   ) -> list[Finding]:
    """PC403 over `found` (`variants`, whose GEMMs come from
    `choose_gemm_path`): the modelled dynamic shared memory, plus the
    compiled static bytes where `records` (the card's query) has them,
    must fit `limit`; a launch above 48 KiB needs the launcher's opt-in."""
    from repro_torch.kernels import approx_qgemm as qk
    out = []
    for (kernel, args), where in found.items():
        model = qk.launch_model(kernel, args)
        static = (records or {}).get((kernel, args), {}).get(
            "static_smem", 0)
        if model.smem + static > limit:
            out.append(Finding(
                "PC403", "kernels/dispatch:choose_gemm_path",
                f"{kernel}{args} ({where}) needs {model.smem} B dynamic + "
                f"{static} B static shared memory, above the {limit} B "
                f"opt-in limit per block"))
        elif model.smem > 48 * 1024 and model.smem > model.smem_limit:
            out.append(Finding(
                "PC403", _loc(kernel),
                f"{kernel}{args} ({where}) requests {model.smem} B but its "
                f"launcher opts in to {model.smem_limit} B"))
    return out


# --------------------------------------------------------------------------
# PC404: the K-tail contract
# --------------------------------------------------------------------------

KTAIL = (40, 130, 72)          # (m, k, n): K = 130 pads on every kernel
KTAIL_SKINNY_M = 5
#: flash attention's f32 agreement with its plain version
#: (kernels/flash_attention.py)
FLASH_F32_TOL = 2e-6


def _ktail_specs(device):
    """trunc2x2, and a rank-2 low-rank spec whose tables map code 0 to
    nonzero values, so a K tail the kernels do not mask moves the sum."""
    import dataclasses

    import numpy as np
    from repro_torch.approx import gemm as G
    from repro_torch.core import multipliers as mm
    from repro_torch.core import netlist as nl
    mask = np.random.default_rng(7).random(
        len(nl.bw8().prunable_gates())) < 0.03
    low = G.from_multiplier(mm.pruned(mask, name="pc_ktail"), rank=2)
    fu, fv = low.fu_q.clone(), low.fv_q.clone()
    fu[:, 0], fv[:, 0] = 7, -5
    low = dataclasses.replace(low, fu_q=fu, fv_q=fv)
    return {"trunc2x2": G.spec_from_name("trunc2x2").to(device),
            "lowrank2": low.to(device)}


def _same(got, want) -> bool:
    import torch
    if not got.dtype.is_floating_point:
        return torch.equal(got, want)
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(
        torch.where(nan, 0, got), torch.where(nan, 0, want))


def check_ktail(device) -> list[Finding]:
    """PC404 for the six kernels at K = 130 (a tail on every one): each
    GEMM route through `ops` (which pads K and passes k_valid) against
    the unpadded plain GEMM of approx/gemm.py, bit for bit; the quantizer
    at K = 130 against its plain version and against the plain version of
    the zero-padded rows; flash over 130 keys against the same call over
    160 keys whose last 30 a causal mask hides, bit for bit on either
    side.  On a CUDA device the kernels run; on the CPU the wrappers run
    their plain versions."""
    import numpy as np
    import torch
    from repro_torch.approx import gemm as G
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz

    dev = torch.device(device)
    rng = np.random.default_rng(11)
    out: list[Finding] = []

    def flag(kernel: str, what: str, got, want):
        if not _same(got, want):
            bad = int((got != want).sum())
            out.append(Finding(
                "PC404", _loc(kernel),
                f"{what}: the K-padded result differs from the unpadded "
                f"one at {bad}/{got.numel()} positions"))

    m, k, n = KTAIL
    specs = _ktail_specs(dev)
    for rows in (m, KTAIL_SKINNY_M):
        a = torch.from_numpy(rng.integers(-128, 128, (rows, k), np.int8)
                             ).to(dev)
        b = torch.from_numpy(rng.integers(-128, 128, (k, n), np.int8)
                             ).to(dev)
        for name, spec in specs.items():
            want = G.approx_qgemm(a, b, spec)
            routes = {"stacked": dict(fused=False)}
            if rows <= 32:
                routes["skinny"] = dict(skinny=True)
            else:
                routes["fused" if spec.rank else "plane0"] = {}
            for kernel, kw in routes.items():
                got = ops.approx_qgemm(a, b, spec, **kw)
                flag(kernel, f"{kernel} {name} ({rows}, {k}, {n})", got,
                     want)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(dev) * 3
    for trunc in (0, 2):
        q0, s0 = qz.quantize_rows_plain(x, trunc)
        q1, s1 = qz.quantize_rows(x, trunc=trunc)
        qp, sp = qz.quantize_rows_plain(
            torch.nn.functional.pad(x, (0, 14)), trunc)
        flag("quantize_rows", f"quantize_rows ({m}, {k}) trunc {trunc}",
             torch.cat([q1.float(), s1], 1), torch.cat([q0.float(), s0], 1))
        flag("quantize_rows", f"quantize_rows zero-padded ({m}, {k}) trunc "
             f"{trunc}", torch.cat([qp[:, :k].float(), sp], 1),
             torch.cat([q0.float(), s0], 1))
    bh, s, s_pad, d = 4, 130, 160, 64
    q, kk, v = (torch.from_numpy(rng.standard_normal((bh, s_pad, d)).astype(
        np.float32)).to(dev) for _ in range(3))
    with torch.no_grad():
        short = fk.flash_attention(q[:, :s].contiguous(),
                                   kk[:, :s].contiguous(),
                                   v[:, :s].contiguous(), causal=True)
        full = fk.flash_attention(q, kk, v, causal=True)[:, :s].contiguous()
        plain = fk.flash_attention_plain(q[:, :s], kk[:, :s], v[:, :s],
                                         causal=True)
    what = f"flash ({bh}, {s} of {s_pad} keys, {d}) f32"
    if dev.type == "cuda":
        # one tile loop on both sides: the masked keys' zero weights leave
        # every sum as it was
        flag("flash_attention", what, short, full)
        pairs = ((short, plain, "against its plain version"),)
    else:
        # the plain version's BLAS products group a row's sums by its
        # length: held to the kernel's own f32 tolerance
        pairs = ((short, full, "padded against unpadded"),)
    for got, want, how in pairs:
        gap = float((got - want).abs().max())
        if not gap <= FLASH_F32_TOL:
            out.append(Finding(
                "PC404", _loc("flash_attention"),
                f"{what} {how}: gap {gap:.3g} above {FLASH_F32_TOL}: keys "
                f"past the length are not masked"))
    return out


# --------------------------------------------------------------------------
# PC405: the tuning cache
# --------------------------------------------------------------------------

def _bucket_shape(bucket: str) -> tuple[int, int, int]:
    m, k, n = (int(part[1:]) for part in bucket.split("_"))
    return m, k, n


def card_optin(device_key: str, running: tuple[str, int] | None = None
               ) -> int | None:
    """The opt-in limit of the card a cache key names: the running card's
    where the names match, else `CARD_SMEM_OPTIN`'s; None when unknown."""
    name = device_key.split("|")[0]
    if running is not None and running[0] == name:
        return running[1]
    for tag, limit in CARD_SMEM_OPTIN.items():
        if tag in name:
            return limit
    return None


def check_tuning_cache(path: str | None = None,
                       running: tuple[str, int] | None = None
                       ) -> list[Finding]:
    """PC405 over the entries of the tuning cache at `path` (default: the
    active one): each plan re-validated at its bucket's own shape as
    `dispatch._tuned_plan` validates it, and its launches' modelled shared
    memory against the limit of the card it is keyed on (`running`: the
    (name, limit) of the card this process runs on)."""
    from repro_torch.kernels import approx_qgemm as qk
    from repro_torch.kernels import autotune
    out: list[Finding] = []
    for key, d in autotune.load_cache(path).get("entries", {}).items():
        try:
            device_key, bucket, mode, r = key.rsplit("|", 3)
            m, k, n = _bucket_shape(bucket)
            rank = int(r[1:])
            plan = autotune.TunedPlan.from_dict(d)
        except (ValueError, TypeError, AttributeError):
            continue            # malformed: lookup can never serve it
        why = None
        skinny = m <= qk.SKINNY_MAX_M
        launches = []
        try:
            from repro_torch.kernels import dispatch
            if plan.path not in autotune.KERNEL_PATHS:
                why = f"path {plan.path!r} is not a kernel path"
            elif plan.path == "fused" and plan.skinny != skinny:
                why = f"skinny={plan.skinny} at m = {m}"
            elif plan.path == "stacked" or (plan.path == "fused" and rank
                                            and not skinny):
                if plan.bn not in autotune.BN_CANDIDATES:
                    why = f"tile width {plan.bn}"
            gp = None
            if why is None and plan.path == "fused" and skinny:
                sbk, sbn = qk.choose_skinny_blocks(k, n)
                gp = dispatch.GemmPlan("fused", m, sbk, sbn, skinny=True,
                                       splits=plan.splits)
            elif why is None and plan.path == "fused" and not rank:
                gp = dispatch.GemmPlan("fused", *qk.PLANE0_TILE,
                                       splits=plan.splits)
            elif why is None:
                gp = dispatch.GemmPlan(plan.path, *qk.FUSED_TILE[:2],
                                       plan.bn)
            if gp is not None:
                launches = gemm_launches(m, k, n, rank, gp,
                                         sm_count=CPU_SM_COUNT)
        except (TypeError, ValueError) as e:
            why = str(e)
        if why is not None:
            out.append(Finding(
                "PC405", "kernels/autotune:put",
                f"tuning-cache entry {key} holds {plan.label}, which the "
                f"plan functions reject for its bucket: {why}"))
            continue
        limit = card_optin(device_key, running)
        for kernel, args in launches:
            smem = qk.launch_model(kernel, args).smem
            if limit is not None and smem > limit:
                out.append(Finding(
                    "PC405", "kernels/autotune:put",
                    f"tuning-cache entry {key} holds {plan.label}, whose "
                    f"{kernel} launch requests {smem} B of shared memory, "
                    f"above the {limit} B its card opts in to"))
    return out


# --------------------------------------------------------------------------
# the checker
# --------------------------------------------------------------------------

def check(root: str | None = None, device=None, report: dict | None = None
          ) -> list[Finding]:
    """Every contract on `device` (None: the CUDA device, raising where
    there is none).  On the card PC401 queries the library and PC403 adds
    its static shared memory and reads the card's limit.  `report`, when
    given, receives what was checked (variants, limit, records)."""
    from repro_torch.device import resolve_device, sm_count
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sms = sm_count(dev) if on_card else CPU_SM_COUNT
    limit = smem_optin(dev)
    found = variants(dev, sms)
    findings: list[Finding] = []
    records = None
    if on_card:
        from repro_torch.kernels import build
        model, records = check_model(found, build.query)
        findings += model
    findings += check_plans(sm_count=sms)
    findings += check_dispatch(found, limit, records)
    findings += check_ktail(dev)
    running = None
    if on_card:
        import torch
        running = (torch.cuda.get_device_name(dev), limit)
    findings += check_tuning_cache(running=running)
    if report is not None:
        report.update(variants=found, limit=limit, records=records)
    return findings
