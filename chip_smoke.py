#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

  1. probe    — the card's name and power limit (nvidia-smi);
  2. build    — nvcc builds the kernel library from csrc/ (timed);
  3. kernels  — every kernel of the serving path against its plain PyTorch
                version on the card, at the serving shapes and at odd ones:
                quantize_rows, the plane-0 GEMM and the skinny GEMM (every
                rank) bit-exact, flash attention within 2e-6 (f32) / 2e-2
                (bf16); then each kernel's time per serving unit (CUDA
                events) beside its plain version, one PyTorch library call
                where one computes the same function, and the card's bound;
  4. serve    — full-width TinyLlama-1.1B (22 layers, random f32 weights
                from a seeded CUDA generator) under the trunc2x2 multiplier
                through the port's slot Engine: 6 requests x 16 greedy
                tokens, every kernel's launch counter read around the run;
  5. check    — a 2-layer full-width model served once through the kernels
                and once through the plain versions on the card: prefill
                logits and greedy tokens compared.

The line before the card line is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the repository around it, the script fails and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, int8 tensor-core ops/s,
# f32 (non-tensor-core) flop/s.
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12

MULT = "trunc2x2"


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn` by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_events(events) -> list:
    """The device-side rows of a `key_averages()` table: kernels, memsets
    and copies.  A host op's row also carries the device time of the
    kernels it launched, so summing every row counts that time twice;
    torch's own table sums only these rows."""
    from torch.autograd import DeviceType
    return [e for e in events
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn) -> float | None:
    """Milliseconds of device time (all kernels, from torch.profiler) in
    one call of `fn`; None when the trace holds no device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total
             for e in device_events(prof.key_averages()))
    return us / 1e3 if us > 0 else None


def probe() -> tuple[str, str]:
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} x{torch.cuda.device_count()}")
    log(f"[probe] nvidia-smi: {card}")
    return name, card


def build_phase() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    log(f"[build] {build.last_build.get('path')} built="
        f"{build.last_build.get('built')} in "
        f"{time.perf_counter() - t0:.2f}s")
    for line in build.last_build.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _lowrank_specs(dev):
    import numpy as np
    from repro_torch.approx import gemm as G
    from repro_torch.core import multipliers as mm
    from repro_torch.core import netlist as nl
    mask = np.random.default_rng(1).random(
        len(nl.bw8().prunable_gates())) < 0.03
    m = mm.pruned(mask, name="smoke_lowrank")
    return {r: G.from_multiplier(m, rank=r).to(dev) for r in (1, 2, 4, 8)}


def check_kernels(dev) -> dict:
    """Kernel vs plain version on the card; returns max |err| per kernel."""
    import torch
    from repro_torch.approx import gemm as G
    from repro_torch.kernels import approx_qgemm as qk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops, qgemm
    from repro_torch.kernels import quantize as qz

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"quantize_rows": 0.0, "approx_qgemm_plane0": 0.0,
           "approx_qgemm_skinny": 0.0, "flash_attention": 0.0}

    def rand_q(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def exact(name, got, want, what):
        if not torch.equal(got, want):
            diff = (got.double() - want.double()).abs().max().item()
            raise AssertionError(f"{name} {what}: kernel != plain "
                                 f"(max |diff| {diff})")

    for m, k in [(128, 2048), (128, 5632), (4, 2048), (4, 5632), (1, 2048),
                 (33, 257), (3, 7)]:
        x = torch.randn((m, k), generator=gen, device=dev) * 3
        for trunc in (0, 2):
            q1, s1 = qz.quantize_rows(x, trunc=trunc)
            q0, s0 = qz.quantize_rows_plain(x, trunc)
            exact("quantize_rows", q1, q0, f"q ({m},{k}) trunc {trunc}")
            exact("quantize_rows", s1, s0, f"scale ({m},{k}) trunc {trunc}")

    specs = {name: G.spec_from_name(name).to(dev)
             for name in ("exact", "trunc2x2", "trunc3x1")}
    for m, k, n in [(128, 2048, 2048), (128, 2048, 256), (128, 2048, 5632),
                    (128, 5632, 2048), (33, 257, 65), (300, 64, 512)]:
        a, b = rand_q(m, k), rand_q(k, n)
        for name, spec in specs.items():
            got = ops.approx_qgemm(a, b, spec)
            exact("approx_qgemm_plane0", got, G.approx_qgemm(a, b, spec),
                  f"({m},{k},{n}) {name}")

    lowrank = _lowrank_specs(dev)
    for m, k, n in [(4, 2048, 2048), (4, 2048, 256), (4, 2048, 5632),
                    (4, 5632, 2048), (4, 2048, 32000), (1, 2048, 32000),
                    (3, 257, 65), (32, 512, 256), (9, 200, 130)]:
        a, b = rand_q(m, k), rand_q(k, n)
        for name, spec in specs.items():
            got = ops.approx_qgemm(a, b, spec, skinny=True)
            exact("approx_qgemm_skinny", got, G.approx_qgemm(a, b, spec),
                  f"({m},{k},{n}) {name}")
        for rank, spec in lowrank.items():
            bk, bn = qk.choose_skinny_blocks(k, n)
            ap = ops._pad_to(a, 1, bk)
            bp = ops._pad_to(ops._pad_to(b, 0, bk), 1, bn)
            scales = ops.plane_scales(spec, rank, dev)
            got = qgemm.approx_qgemm_skinny(ap, bp, spec.fu_q, spec.fv_q,
                                            scales, k_valid=k)
            want = qgemm.approx_qgemm_skinny_plain(
                ap, bp, spec.fu_q, spec.fv_q, scales, k_valid=k)
            exact("approx_qgemm_skinny", got, want,
                  f"({m},{k},{n}) rank {rank}")
            ref = G.approx_qgemm(a, b, spec)
            torch.testing.assert_close(got[:, :n], ref, rtol=1e-6, atol=1.0)

    for bh, s, d in [(32, 128, 64), (2, 256, 128), (1, 64, 256), (3, 77, 64),
                     (4, 100, 32)]:
        for dtype, tol in ((torch.float32, 2e-6), (torch.bfloat16, 2e-2)):
            q, k_, v = (torch.randn((bh, s, d), generator=gen, device=dev)
                        .to(dtype) for _ in range(3))
            for causal in (True, False):
                got = fk.flash_attention(q, k_, v, causal=causal)
                want = fk.flash_attention_plain(q, k_, v, causal=causal,
                                                bq=64, bkv=64)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=3 * tol)
                if dtype == torch.float32:
                    err["flash_attention"] = max(
                        err["flash_attention"],
                        (got - want).abs().max().item())
    torch.cuda.synchronize()
    log("[kernels] all kernels agree with their plain versions")
    return err


def time_kernels(dev, cfg, errs: dict) -> list[dict]:
    """Per-kernel time over one serving unit of its main-path calls."""
    import torch
    import torch.nn.functional as F
    from repro_torch.approx import gemm as G
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops, qgemm
    from repro_torch.kernels import quantize as qz

    gen = torch.Generator(device=dev).manual_seed(1)
    spec = G.spec_from_name(MULT).to(dev)
    d, f, kvd, v = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd, cfg.vocab
    shapes = [(d, d), (d, kvd), (d, kvd), (d, d), (d, f), (d, f), (f, d)]
    weights = [torch.randint(-128, 128, kn, generator=gen, device=dev,
                             dtype=torch.int8)
               for _ in range(cfg.n_layers) for kn in shapes]
    head = torch.randint(-128, 128, (d, v), generator=gen, device=dev,
                         dtype=torch.int8)
    cap, bucket = 4, 128
    acts = {(m, k): torch.randint(-128, 128, (m, k), generator=gen,
                                  device=dev, dtype=torch.int8)
            for m in (cap, 32, bucket) for k in (d, f)}
    out = []

    def row(name, route, source, replaces, unit, calls, kernel, plain,
            library, nbytes, ops_, peak):
        b, by = bound_ms(nbytes, ops_, peak)
        lib_ms = None
        if library is not None:
            try:  # a yardstick only: the port never calls it
                lib_ms = cuda_ms(library)
            except RuntimeError as e:
                log(f"[time] {name}: library call unavailable ({e})")
        out.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": errs[name], "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain, reps=3, warmup=1),
            "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms,
            "unit": unit, "calls": calls, "device_ms": device_ms(kernel)})
        log(f"[time] {name}: {out[-1]['ms']:.4f} ms per {unit} "
            f"(device {out[-1]['device_ms']}, plain "
            f"{out[-1]['plain_ms']:.4f}, bound {b:.4f} by {by}, library "
            f"{out[-1]['library_ms']})")

    # skinny: one decode step of the arena (m = capacity)
    dec = [(acts[(cap, w.shape[0])], w) for w in weights + [head]]
    row("approx_qgemm_skinny", "cuda", "src/repro_torch/csrc/qgemm.cu",
        "src/repro/kernels/approx_qgemm.py:418", "decode step (m=4)",
        len(dec),
        lambda: [ops.approx_qgemm(a, w, spec, skinny=True) for a, w in dec],
        lambda: [qgemm.approx_qgemm_skinny_plain(
            a, w, spec.fu_q, spec.fv_q, ops.plane_scales(spec, 0, dev),
            trunc_a=2, trunc_b=2, k_valid=a.shape[1]) for a, w in dec],
        lambda: [torch._int_mm(acts[(32, w.shape[0])], w) for _, w in dec],
        sum(a.numel() + w.numel() + a.shape[0] * w.shape[1] * 4
            for a, w in dec),
        sum(2 * a.shape[0] * w.shape[0] * w.shape[1] for a, w in dec),
        PEAK_INT8)

    # plane0: the GEMMs of one admitted request's prefill (m = bucket)
    pre = [(acts[(bucket, w.shape[0])], w) for w in weights]
    row("approx_qgemm_plane0", "cuda", "src/repro_torch/csrc/qgemm.cu",
        "src/repro/kernels/approx_qgemm.py:338", "prefill (m=128)", len(pre),
        lambda: [ops.approx_qgemm(a, w, spec) for a, w in pre],
        lambda: [qgemm.approx_qgemm_plane0_plain(a, w, trunc_a=2, trunc_b=2)
                 for a, w in pre],
        lambda: [torch._int_mm(a, w) for a, w in pre],
        sum(a.numel() + w.numel() + a.shape[0] * w.shape[1] * 4
            for a, w in pre),
        sum(2 * a.shape[0] * w.shape[0] * w.shape[1] for a, w in pre),
        PEAK_INT8)

    # quantize_rows: the activation rows of one decode step
    xs = [torch.randn((cap, w.shape[0]), generator=gen, device=dev)
          for w in weights + [head]]
    row("quantize_rows", "cuda", "src/repro_torch/csrc/quantize.cu",
        "src/repro/kernels/quantize.py:44", "decode step (m=4)", len(xs),
        lambda: [qz.quantize_rows(x, trunc=2) for x in xs],
        lambda: [qz.quantize_rows_plain(x, 2) for x in xs],
        None, sum(x.numel() * 5 + x.shape[0] * 4 for x in xs),
        sum(x.numel() * 4 for x in xs), PEAK_F32)

    # flash: the attention calls of one admitted request's prefill
    bh, hd = cfg.n_heads, cfg.hd
    qkv = [tuple(torch.randn((bh, bucket, hd), generator=gen, device=dev)
                 for _ in range(3)) for _ in range(cfg.n_layers)]
    pairs = bucket * (bucket + 1) // 2
    row("flash_attention", "cuda", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:76", "prefill (s=128)",
        len(qkv),
        lambda: [fk.flash_attention(q, k, v_) for q, k, v_ in qkv],
        lambda: [fk.flash_attention_plain(q, k, v_) for q, k, v_ in qkv],
        lambda: [F.scaled_dot_product_attention(q[None], k[None], v_[None],
                                                is_causal=True)
                 for q, k, v_ in qkv],
        len(qkv) * 4 * bh * bucket * hd * 4,
        len(qkv) * bh * pairs * 4 * hd, PEAK_F32)
    del weights, head
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the main path: full-width serving
# ---------------------------------------------------------------------------

def counters():
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import qgemm
    from repro_torch.kernels import quantize as qz
    return {"quantize_rows": qz.quantize_rows,
            "approx_qgemm_plane0": qgemm.approx_qgemm_plane0,
            "approx_qgemm_skinny": qgemm.approx_qgemm_skinny,
            "flash_attention": fk.flash_attention}


def serve_phase(dev, cfg) -> dict:
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.serving import Engine, Request, SamplingParams

    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    eng = Engine(cfg, params, capacity=4, max_len=256,
                 prefill_buckets=(128,), device=dev)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {api.param_count(params) / 1e9:.3f}B params, "
        f"engine ready in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    lens = [40, 128, 77, 100, 64, 115]
    arrivals = [0, 0, 0, 0, 3, 5]
    sp = SamplingParams(max_new_tokens=16)
    for i, (n, t) in enumerate(zip(lens, arrivals)):
        eng.submit(Request(f"r{i}", rng.integers(0, cfg.vocab, n).tolist(),
                           sp, arrival=t))
    ctr = counters()
    for fn in ctr.values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in ctr.items()}

    assert len(done) == 6, [c.request_id for c in done]
    for c in done:
        assert c.finish_reason == "length" and len(c.tokens) == 16, c
        assert all(0 <= t < cfg.vocab for t in c.tokens), c.tokens
    st = eng.stats()
    steps, adm = st["decode_steps"], st["admitted"]
    n_gemm = 7 * cfg.n_layers
    want = {"quantize_rows": (n_gemm + 1) * (steps + adm),
            "approx_qgemm_skinny": (n_gemm + 1) * steps + adm,
            "approx_qgemm_plane0": n_gemm * adm,
            "flash_attention": cfg.n_layers * adm}
    for name, n in launches.items():
        assert n > 0, f"{name} never launched on the main path"
        assert n == want[name], (name, n, want[name])
    toks = sum(len(c.tokens) - 1 for c in done)
    log(f"[serve] 6 requests x 16 tokens in {wall:.2f}s: prefill "
        f"{st['prefill_s']:.3f}s for {adm} requests "
        f"({st['prefill_s'] / adm * 1e3:.1f} ms each), decode "
        f"{toks / st['decode_s']:.1f} tok/s over {steps} steps "
        f"({st['decode_s'] / steps * 1e3:.2f} ms/step)")
    log(f"[serve] launches {launches}; per decode step: "
        f"{n_gemm + 1} quantize_rows + {n_gemm + 1} approx_qgemm_skinny")
    log(f"[serve] r0 tokens {done[0].tokens}")
    profile_decode(eng, rng, cfg)
    del eng, params
    torch.cuda.empty_cache()
    return launches


def profile_decode(eng, rng, cfg, steps: int = 4) -> None:
    """Device-busy share and the heaviest kernels over a few steady decode
    steps of a full arena (after the main path's counters were read)."""
    import torch
    from repro_torch.serving import Request, SamplingParams
    for i in range(eng.capacity):
        eng.submit(Request(f"p{i}", rng.integers(0, cfg.vocab, 64).tolist(),
                           SamplingParams(max_new_tokens=steps + 2),
                           arrival=eng.tick))
    eng.step()                      # admissions + first decode
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = device_events(events)
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        log("[profile] no device time in the trace: busy share not measured")
        return
    log(f"[profile] {steps} decode steps: wall {wall * 1e3:.2f} ms, device "
        f"busy {dev_us / 1e3:.2f} ms ({dev_us / 1e6 / wall:.1%}); idle "
        f"{1 - dev_us / 1e6 / wall:.1%}; {sum(e.count for e in kernels)} "
        f"device ops")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} "
            f"ms/step  {e.count // steps:5d}/step  {e.key[:70]}")
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        log(f"[profile]   host {e.self_cpu_time_total / 1e3 / steps:8.3f} "
            f"ms/step  {e.count // steps:5d}/step  {e.key[:60]}")
    eng.run_until_complete()


def check_phase(dev, cfg_full) -> None:
    """Kernels vs plain versions through the whole model on the card."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import api

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    params = api.init_params(cfg, seed=1, device=dev)
    rng = np.random.default_rng(1)
    # a full arena (m = 4 on the skinny kernel) at per-row lengths
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 128))).to(dev)
    true_len = torch.tensor([128, 77, 40, 101], dtype=torch.int32,
                            device=dev)
    runs = {}
    for policy in ("pallas", "xla"):
        c = dataclasses.replace(cfg, kernel_policy=policy)
        spec = api.make_spec(c, device=dev)
        p = api.prepare_params(params, c, spec)
        logits, cache = api.prefill(p, tokens, c, spec, max_len=160,
                                    true_len=true_len)
        runs[policy] = [c, spec, p, cache, logits]
    # Both paths decode the same greedy tokens (the kernel path's), so each
    # step's logits compare on equal inputs.  Only flash vs the plain
    # chunked attention differ, by f32 rounding (a few 1e-7 here); the
    # other kernels are bit-exact, so 1e-4 leaves room for rounding but
    # not for one int8 code moving (O(1e-3) on a logit).
    tol = 1e-4
    diffs, match = [], []
    for step in range(9):
        lp, lx = runs["pallas"][4], runs["xla"][4]
        if step:
            lp, lx = lp[:, -1], lx[:, -1]
        assert torch.isfinite(lp).all() and lp.shape == (4, cfg.vocab)
        diffs.append((lp - lx).abs().max().item())
        tok = lp.argmax(-1)
        match.append((tok == lx.argmax(-1)).float().mean().item())
        if step == 8:
            break
        for run in runs.values():
            c, spec, p, cache, _ = run
            run[4], run[3] = api.decode_step(p, cache, tok[:, None], c, spec)
    share = sum(match) / len(match)
    log(f"[check] 2-layer full width, kernels vs plain on the card: prefill "
        f"logits max|diff| {diffs[0]:.3e}, decode steps 1-8 max|diff| "
        f"{max(diffs[1:]):.3e} (limit {tol:g}; |logits| <= "
        f"{lx.abs().max().item():.3f}), greedy token match {share:.3f}")
    assert max(diffs) <= tol, diffs
    assert share == 1.0, match


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch import configs
    except ImportError as e:
        print(f"chip_smoke: the repository's src/repro_torch is missing "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    name, card = probe()
    build_phase()
    cfg = configs.get_config("tinyllama-1.1b", mult=MULT,
                             kernel_policy="pallas", attn_impl="flash",
                             dtype="float32")
    table = time_kernels(dev, cfg, check_kernels(dev))
    launches = serve_phase(dev, cfg)
    for row in table:
        row["launches"] = launches[row["name"]]
    check_phase(dev, cfg)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
