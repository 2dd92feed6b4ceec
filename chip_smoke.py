#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

  1. probe     — the card's name and power limit (nvidia-smi);
  2. build     — nvcc builds the kernel library from csrc/ (timed);
  3. kernels   — every kernel against its plain PyTorch version on the
                 card, at the main paths' shapes and at odd ones:
                 quantize_rows, the plane-0 GEMM, the skinny GEMM (every
                 rank), the fused and the stacked low-rank GEMMs (ranks 1, 2,
                 4, 8, every VGG16 conv shape; stacked bit-identical to
                 fused, its launches counted over these parity calls)
                 bit-exact, flash attention within 2e-6 (f32) / 2e-2
                 (bf16); then each kernel's time per unit of its main path
                 (CUDA events) beside its plain version, a PyTorch library
                 yardstick and the card's bound;
  4. serve     — full-width TinyLlama-1.1B (22 layers, random f32 weights
                 from a seeded CUDA generator) under the trunc2x2 multiplier
                 through the port's slot Engine: 6 requests x 16 greedy
                 tokens, every kernel's launch counter read around the run;
  5. check     — a 2-layer full-width model served once through the kernels
                 and once through the plain versions on the card: logits and
                 greedy tokens compared, under trunc2x2 and under the
                 rank-5 Pareto multiplier pareto:0.01 (low-rank prefill on
                 the fused kernel, decode on the skinny one, both sides on
                 the plain attention; flash's o-projection inputs go
                 through the kernel and the plain GEMM, which must agree
                 to the bit, and flash-vs-chunked divergence is printed);
  6. cnn       — full-width VGG16 (224x224, 1000 classes, batch 8, random
                 f32 weights calibrated layer by layer to mean 0, var 1)
                 under pareto:0.01: 13 conv GEMMs on the fused kernel, 3 FC
                 GEMMs on the skinny kernel, launch counters read around
                 one forward, the smallest row absmax each GEMM quantizes,
                 forward time, device busy share;
  7. cnn-check — VGG16 and ResNet50 at batch 2 through the kernels and
                 through the plain versions on the card: logits compared,
                 top-1 equal;
  8. accuracy  — `repro_torch.launch.accuracy`: vgg_mini trained 260 steps,
                 top-1 and drop under every truncation and Pareto
                 multiplier, through the kernels and through the plain
                 versions (top-1 equal).

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
#: The CNN path's multiplier: the rank-5 gate-pruned Pareto multiplier.
CNN_MULT = "pareto:0.01"
#: The quantizers' scale floor: a row whose absmax is below it gets
#: coarser codes, so the CNN path must keep its rows far above it.
QUANT_FLOOR = 1e-8


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


def check_kernels(dev) -> tuple[dict, int]:
    """Kernel vs plain version on the card; returns max |err| per kernel
    and the stacked kernel's launches over its parity calls."""
    import torch
    from repro_torch.approx import gemm as G
    from repro_torch.kernels import approx_qgemm as qk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops, qgemm
    from repro_torch.kernels import quantize as qz

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"quantize_rows": 0.0, "approx_qgemm_plane0": 0.0,
           "approx_qgemm_skinny": 0.0, "flash_attention": 0.0,
           "approx_qgemm_fused": 0.0, "approx_qgemm_stacked": 0.0}

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

    # fused / stacked: every distinct VGG16 im2col shape, the TinyLlama
    # prefill shapes, odd shapes, every rank; then a K tail that is a whole
    # padded tile.  The stacked kernel is on no main path: its launches are
    # counted over these parity calls.
    def parity():
        for m, k, n in list(dict.fromkeys(vgg16_convs())) + [
                (128, 2048, 2048), (128, 2048, 256), (128, 2048, 5632),
                (128, 5632, 2048), (33, 257, 65), (300, 64, 512)]:
            a, b = rand_q(m, k), rand_q(k, n)
            for rank, spec in lowrank.items():
                what = f"({m},{k},{n}) rank {rank}"
                got = ops.approx_qgemm(a, b, spec)
                exact("approx_qgemm_fused", got,
                      qgemm.approx_qgemm_fused_plain(
                          a, b, spec.fu_q, spec.fv_q,
                          ops.plane_scales(spec, rank, dev), k_valid=k), what)
                exact("approx_qgemm_stacked",
                      ops.approx_qgemm(a, b, spec, fused=False), got,
                      what + " (stacked vs fused)")
                torch.testing.assert_close(got, G.approx_qgemm(a, b, spec),
                                           rtol=1e-6, atol=1.0)
                del got
            del a, b

    _, n = counted(parity)
    stacked_launches = n["approx_qgemm_stacked"]
    spec = lowrank[2]
    a, b = rand_q(128, 128), rand_q(128, 128)
    ap = torch.cat([a, torch.zeros_like(a)], 1)
    bp = torch.cat([b, torch.zeros_like(b)], 0)
    exact("approx_qgemm_fused", qgemm.approx_qgemm_fused(
        ap, bp, spec.fu_q, spec.fv_q, ops.plane_scales(spec, 2, dev),
        k_valid=128), G.approx_qgemm(a, b, spec), "fully padded K tile")
    torch.cuda.empty_cache()

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
    log(f"[kernels] all kernels agree with their plain versions; "
        f"{stacked_launches} stacked launches in the parity calls")
    return err, stacked_launches


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
    del weights, head, acts, dec, pre, xs, qkv
    torch.cuda.empty_cache()

    # fused: the 13 conv GEMMs of one VGG16 forward (batch 8, 224x224)
    # under the rank-5 Pareto multiplier; stacked: the same GEMMs through
    # the stacked route, on stacks built beforehand
    lspec = G.spec_from_name(CNN_MULT).to(dev)
    rank = lspec.rank
    planes = rank + 1
    scales = ops.plane_scales(lspec, rank, dev)
    convs = [(torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                            dtype=torch.int8),
              torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8)) for m, k, n in vgg16_convs()]
    mkn = [(a.shape[0], a.shape[1], w.shape[1]) for a, w in convs]
    # torch._int_mm takes K and N in multiples of 8: conv 1's K = 27 pads
    padded8 = [(ops._pad_to(a, 1, 8), ops._pad_to(w, 0, 8))
               for a, w in convs]

    def int_mm_planes():
        return [torch._int_mm(a, w) for a, w in padded8
                for _ in range(planes)]

    row("approx_qgemm_fused", "cuda", "src/repro_torch/csrc/qgemm.cu",
        "src/repro/kernels/approx_qgemm.py:273",
        "VGG16 forward, batch 8 (13 conv GEMMs)", len(convs),
        lambda: [ops.approx_qgemm(a, w, lspec) for a, w in convs],
        lambda: [qgemm.approx_qgemm_fused_plain(
            a, w, lspec.fu_q, lspec.fv_q, scales, k_valid=a.shape[1])
            for a, w in convs],
        int_mm_planes,
        sum(m * k + k * n + 4 * m * n for m, k, n in mkn),
        sum(2 * m * k * n * planes for m, k, n in mkn), PEAK_INT8)
    stacks = []
    for a, w in convs:
        a_s, b_s, s_ = ops.build_stacks(a, w, lspec)
        stacks.append((ops._pad_to(ops._pad_to(a_s, 1, 128), 2, 32),
                       ops._pad_to(ops._pad_to(b_s, 1, 32), 2, 128), s_))
    del convs
    row("approx_qgemm_stacked", "cuda", "src/repro_torch/csrc/qgemm.cu",
        "src/repro/kernels/approx_qgemm.py:157",
        "VGG16 forward's 13 conv GEMMs, pre-mapped stacks", len(stacks),
        lambda: [qgemm.approx_qgemm_stacked(a_s, b_s, s_)
                 for a_s, b_s, s_ in stacks],
        lambda: [qgemm.approx_qgemm_stacked_plain(a_s, b_s, s_)
                 for a_s, b_s, s_ in stacks],
        int_mm_planes,
        sum(planes * (m * k + k * n) + 4 * m * n for m, k, n in mkn),
        sum(2 * m * k * n * planes for m, k, n in mkn), PEAK_INT8)
    del stacks, padded8
    torch.cuda.empty_cache()
    return out


def vgg16_convs(batch: int = 8, image: int = 224) -> list[tuple]:
    """(M, K, N) of VGG16's 13 im2col conv GEMMs."""
    from repro_torch.models import cnn
    shapes, c_in, hw = [], 3, image
    for v in cnn.VGG_CFG["vgg16"]:
        if v == "M":
            hw //= 2
            continue
        shapes.append((batch * hw * hw, 9 * c_in, v))
        c_in = v
    return shapes


# ---------------------------------------------------------------------------
# the main path: full-width serving
# ---------------------------------------------------------------------------

def counters():
    """Every kernel wrapper, by kernel name: each counts its launches."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import qgemm
    from repro_torch.kernels import quantize as qz
    return {"quantize_rows": qz.quantize_rows,
            "approx_qgemm_plane0": qgemm.approx_qgemm_plane0,
            "approx_qgemm_skinny": qgemm.approx_qgemm_skinny,
            "flash_attention": fk.flash_attention,
            "approx_qgemm_fused": qgemm.approx_qgemm_fused,
            "approx_qgemm_stacked": qgemm.approx_qgemm_stacked}


def counted(fn) -> tuple:
    """(result of fn(), launches of every kernel during it): the counters
    are set to 0 just before and read just after."""
    import torch
    ctr = counters()
    for f in ctr.values():
        f.launches = 0
    res = fn()
    torch.cuda.synchronize()
    return res, {name: f.launches for name, f in ctr.items()}


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
    t0 = time.perf_counter()
    done, launches = counted(eng.run_until_complete)
    wall = time.perf_counter() - t0

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
            "flash_attention": cfg.n_layers * adm,
            "approx_qgemm_fused": 0, "approx_qgemm_stacked": 0}
    assert launches == want, (launches, want)
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


def check_phase(dev, cfg_full, mult: str, attn_impl: str) -> None:
    """Kernels vs plain versions through the whole model on the card.

    Under trunc2x2 the kernel run takes flash attention and the plain run
    the plain chunked forward.  Under pareto:0.01 both runs take the plain
    chunked attention, so that only the GEMM and quantize kernels differ:
    flash's f32 rounding moves int8 codes at the o-projection input, which
    the rank-5 multiplier, masking no LSBs, carries to the logits.
    `flash_witness` measures that and holds the GEMM kernels to the plain
    path on flash's own o-projection inputs."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import api

    cfg = dataclasses.replace(cfg_full, n_layers=2, mult=mult,
                              attn_impl=attn_impl)
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
        (logits, cache), n = counted(lambda: api.prefill(
            p, tokens, c, spec, max_len=160, true_len=true_len))
        if policy == "pallas":
            tiled = "approx_qgemm_fused" if spec.mode == "lowrank" \
                else "approx_qgemm_plane0"
            assert n[tiled] == 7 * cfg.n_layers, (mult, n)
        runs[policy] = [c, spec, p, cache, logits]
    if attn_impl != "flash":
        flash_witness(runs, tokens, true_len)
    # Both paths decode the same greedy tokens (the kernel path's), so each
    # step's logits compare on equal inputs.  Only flash vs the plain
    # chunked attention differ, by f32 rounding (a few 1e-7 here); the
    # other kernels are bit-exact, so 1e-4 leaves room for rounding but
    # not for one int8 code moving (O(1e-3) on a logit).  The decode
    # attention is plain PyTorch in both runs.
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
    log(f"[check] {mult}, attention {attn_impl}, 2-layer full width, "
        f"kernels vs plain on the card: prefill "
        f"logits max|diff| {diffs[0]:.3e}, decode steps 1-8 max|diff| "
        f"{max(diffs[1:]):.3e} (limit {tol:g}; |logits| <= "
        f"{lx.abs().max().item():.3f}), greedy token match {share:.3f}")
    assert max(diffs) <= tol, diffs
    assert share == 1.0, match


def flash_witness(runs: dict, tokens, true_len) -> None:
    """Flash vs the plain chunked attention at layer 0 of the model that
    `check_phase` runs on chunked attention: their divergence at the
    o-projection input, the int8 codes it moves and what it makes of the
    prefill logits are printed as readings; the o-projection GEMM through
    the kernels and through the plain path must agree to the bit on
    flash's outputs and on chunked's."""
    import dataclasses

    import torch
    from repro_torch.approx import layers as AL
    from repro_torch.kernels import quantize as qz
    from repro_torch.models import api
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T

    c, spec, p = runs["pallas"][:3]
    cx, spec_x, px = runs["xla"][:3]
    b, s = tokens.shape
    lp, lpx = T._layer(p["layers"], 0), T._layer(px["layers"], 0)
    with torch.no_grad():
        x = C.rmsnorm(AL.embed(tokens, p["embed"]), lp["ln1"])
        positions = torch.arange(s, device=tokens.device)[None, :]
        q, k, v = T._qkv(x, lp, c, spec, positions)
        inputs = {"flash": C.flash_attention(q, k, v, True),
                  "chunked": C.chunked_attention(q, k, v, c.attn_chunk, True)}
        inputs = {name: o.reshape(b, s, -1) for name, o in inputs.items()}
        for name, o in inputs.items():
            got = AL.dense(o, lp["wo"], None, spec)
            want = AL.dense(o, lpx["wo"], None, spec_x)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"o-projection on {name}'s output: kernels != plain "
                    f"(max |diff| {(got - want).abs().max().item():.3e})")
        div = (inputs["flash"] - inputs["chunked"]).abs().max().item()
        codes = [qz.quantize_rows_plain(o.reshape(b * s, -1), 0)[0]
                 for o in inputs.values()]
        moved = (codes[0] != codes[1]).sum().item()
        cf = dataclasses.replace(c, attn_impl="flash")
        lf, _ = api.prefill(p, tokens, cf, spec, max_len=160,
                            true_len=true_len)
        ldiff = (lf - runs["pallas"][4]).abs().max().item()
    log(f"[check] flash witness, layer 0 o-projection input: flash vs "
        f"chunked max|diff| {div:.3e}, {moved} of {codes[0].numel()} int8 "
        f"codes moved; the o-projection GEMM through the kernels equals the "
        f"plain path's on both; prefill logits with flash vs chunked "
        f"attention (kernels on both) max|diff| {ldiff:.3e}")


# ---------------------------------------------------------------------------
# the CNN path: full-width VGG16 / ResNet50 under a Pareto multiplier
# ---------------------------------------------------------------------------

def _cnn_spec(dev, policy: str):
    from repro_torch.approx import gemm as G
    spec = G.spec_from_name(CNN_MULT).with_policy(policy).to(dev)
    assert spec.mode == "lowrank" and spec.rank == 5, (spec.mode, spec.rank)
    return spec


def vgg_replay(params, x, arch: str, spec, calibrate: bool = False
               ) -> tuple:
    """`cnn.vgg_forward` layer by layer: (logits, the smallest absmax of
    the rows each of its GEMMs quantizes, the share of each conv's outputs
    above 0).  An im2col row's absmax is the 3x3 window's max of the
    per-pixel channel absmax.  With `calibrate`, each layer's weight and
    bias are first set in place so that its output over `x` has mean 0
    and variance 1 (a data-dependent init, as LSUV's), which stands in for
    the normalisation a trained network folds in.  The reference's init
    needs it under a low-rank multiplier: the multiplier errs low on the
    non-negative activations, so ReLU zeroes most outputs, the scale
    shrinks layer by layer towards the quantizers' floor, and whole FC
    rows die."""
    import torch
    import torch.nn.functional as F
    from repro_torch.approx import layers as AL
    from repro_torch.models import cnn

    def layer(x, p, op):
        y = op(x, p["w"])
        if calibrate:
            std, mean = torch.std_mean(y)
            p["w"].div_(std)
            p["b"].fill_(-(mean / std).item())
            y = op(x, p["w"])
        return y + p["b"]

    mins, live = [], []
    convs = iter(params["convs"])
    for v in cnn.VGG_CFG[arch]:
        if v == "M":
            x = cnn._max_pool(x, 2, 2, same=False)
            continue
        amax = x.abs().amax(-1)[:, None]
        mins.append(F.max_pool2d(amax, 3, 1, padding=1).min().item())
        y = layer(x, next(convs), lambda x, w: AL.conv2d(x, w, 1, 1, spec))
        live.append((y > 0).float().mean().item())
        x = torch.relu(y)
    x = x.reshape(x.shape[0], -1)
    for i, p in enumerate(params["fcs"]):
        mins.append(x.abs().amax(-1).min().item())
        x = layer(x, p, lambda x, w: AL.dense(x, w, None, spec))
        if i < len(params["fcs"]) - 1:
            x = torch.relu(x)
    return x, mins, live


def vgg16_params(dev, seed: int, x) -> tuple:
    """VGG16's parameters from a seeded CUDA generator, calibrated on the
    plain path under the CNN multiplier on `x`; with the reference init's
    row-absmax minima and live shares."""
    import torch
    from repro_torch.models import cnn
    params = cnn.init_vgg("vgg16", seed=seed, n_classes=1000, image=224,
                          device=dev)
    spec = _cnn_spec(dev, "xla")
    with torch.no_grad():
        _, raw, live = vgg_replay(params, x, "vgg16", spec)
        vgg_replay(params, x, "vgg16", spec, calibrate=True)
    return params, raw, live


def cnn_phase(dev) -> dict:
    """One VGG16 forward (224x224, batch 8) under pareto:0.01 with every
    kernel counter read around it; then the smallest row absmax each of its
    GEMMs quantizes, its time and its device profile."""
    import torch
    from repro_torch.models import cnn

    t0 = time.perf_counter()
    spec = _cnn_spec(dev, "pallas")
    log(f"[cnn] {CNN_MULT} -> {spec.name}: rank {spec.rank}, nmed "
        f"{spec.nmed:.5f} (front ready in {time.perf_counter() - t0:.1f}s)")
    x = torch.randn((8, 224, 224, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    params, raw, raw_live = vgg16_params(dev, 0, x)

    def fwd():
        return cnn.vgg_forward(params, x, "vgg16", spec=spec)

    with torch.no_grad():
        fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, launches = counted(fwd)
        first = time.perf_counter() - t0
        want = {"quantize_rows": 16, "approx_qgemm_fused": 13,
                "approx_qgemm_skinny": 3, "approx_qgemm_plane0": 0,
                "approx_qgemm_stacked": 0, "flash_attention": 0}
        assert launches == want, (launches, want)
        assert logits.shape == (8, 1000) and torch.isfinite(logits).all()
        replayed, mins, live = vgg_replay(params, x, "vgg16", spec)
        assert torch.equal(replayed, logits), "replay != vgg_forward"

        def fmt(vals, f):
            return "[" + ", ".join(format(v, f) for v in vals) + "]"

        log(f"[cnn] smallest row absmax per GEMM (16; quantizer floor "
            f"{QUANT_FLOOR:g}): reference init {fmt(raw, '.2e')}, calibrated "
            f"{fmt(mins, '.2e')}")
        log(f"[cnn] share of conv outputs > 0 (13): reference init "
            f"{fmt(raw_live, '.3f')}, calibrated {fmt(live, '.3f')}")
        assert min(mins) >= 1e4 * QUANT_FLOOR, mins
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        log(f"[cnn] VGG16 224x224 batch 8 under {CNN_MULT}: launches "
            f"{launches}; forward {first * 1e3:.2f} ms (counted run), "
            f"{ms:.2f} ms (mean of {reps}); |logits| <= "
            f"{logits.abs().max().item():.3e}")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = device_events(prof.key_averages())
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        log("[cnn] no device time in the trace: busy share not measured")
    else:
        log(f"[cnn] profiled forward: wall {wall * 1e3:.2f} ms, device busy "
            f"{dev_us / 1e3:.2f} ms ({dev_us / 1e6 / wall:.1%}); "
            f"{sum(e.count for e in kernels)} device ops")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[cnn]   {e.self_device_time_total / 1e3:8.3f} ms  "
                f"{e.count:4d} calls  {e.key[:70]}")
    del params, x, logits
    torch.cuda.empty_cache()
    return launches


def cnn_check_phase(dev) -> None:
    """VGG16 (calibrated as in the cnn phase) and ResNet50 (224x224, batch 2,
    pareto:0.01) through the kernels and the plain versions on the card.
    The kernels and the plain versions compute the same integer planes and
    flush them in the same order, so the logits should agree to the bit;
    the limit, 1e-4 of the logits' scale, leaves room for rounding but not
    for one int8 code moving."""
    import torch
    from repro_torch.models import cnn

    kern, plain = _cnn_spec(dev, "pallas"), _cnn_spec(dev, "xla")
    x = torch.randn((2, 224, 224, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    for arch in ("vgg16", "resnet50"):
        if arch == "vgg16":
            params = vgg16_params(dev, 1, x)[0]
            fwd = cnn.vgg_forward
        else:
            params = cnn.init_resnet(arch, seed=1, device=dev)
            fwd = cnn.resnet_forward
        with torch.no_grad():
            lk, nk = counted(lambda: fwd(params, x, arch, spec=kern))
            lx = fwd(params, x, arch, spec=plain)
        assert nk["approx_qgemm_fused"] > 0, nk
        assert torch.isfinite(lk).all() and lk.shape == (2, 1000)
        diff = (lk - lx).abs().max().item()
        scale = lx.abs().max().item()
        same_top1 = torch.equal(lk.argmax(-1), lx.argmax(-1))
        log(f"[cnn-check] {arch} batch 2 under {CNN_MULT}: kernels "
            f"{ {k: v for k, v in nk.items() if v} }; logits max|diff| "
            f"kernels vs plain {diff:.3e} (|logits| <= {scale:.3e}, limit "
            f"{1e-4 * scale:.3e}); top-1 equal {same_top1}")
        assert diff <= 1e-4 * scale and same_top1
        del params, lk, lx
        torch.cuda.empty_cache()


def accuracy_phase(dev) -> None:
    """repro_torch.launch.accuracy on the card: vgg_mini trained 260 steps,
    every multiplier's top-1 through the kernels and the plain versions."""
    from repro_torch.launch import accuracy as acc

    t0 = time.perf_counter()
    params, rows = acc.run(policy="pallas", device=dev)
    plain = acc.report(params, "xla")
    for line in acc.format_lines(rows):
        log(f"[accuracy] {line}")
    for r, q in zip(rows, plain, strict=True):
        assert r["name"] == q["name"] and r["top1"] == q["top1"], (r, q)
    log("[accuracy] ranks " + ", ".join(
        f"{r['name']}={r['mode']}/{r['rank']}" for r in rows[1:])
        + f"; kernels and plain versions give the same top-1 for all "
        f"{len(rows)}; {time.perf_counter() - t0:.1f}s")


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
    errs, stacked_launches = check_kernels(dev)
    table = time_kernels(dev, cfg, errs)
    log(f"[kernels] {time.perf_counter() - t_start:.1f}s")
    # each kernel's launches come from the main path that runs it
    launches = serve_phase(dev, cfg)
    check_phase(dev, cfg, MULT, "flash")
    check_phase(dev, cfg, CNN_MULT, "chunked")
    log(f"[serve+check] {time.perf_counter() - t_start:.1f}s")
    cnn_launches = cnn_phase(dev)
    cnn_check_phase(dev)
    launches["approx_qgemm_fused"] = cnn_launches["approx_qgemm_fused"]
    launches["approx_qgemm_stacked"] = stacked_launches
    log(f"[cnn] {time.perf_counter() - t_start:.1f}s")
    accuracy_phase(dev)
    for row in table:
        row["launches"] = launches[row["name"]]
        assert row["launches"] > 0, row["name"]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
