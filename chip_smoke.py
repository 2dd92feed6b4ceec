#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise).
Every phase but autotune runs with $REPRO_TUNING_CACHE pointed at a file
that does not exist, so each GEMM takes its static plan whatever tuning
cache the checkout holds; the script checks at its end that no plan
outside autotune came from a cache.

  1. probe     — the card's name and power limit (nvidia-smi);
  2. build     — nvcc builds the kernel library from csrc/ (timed);
  3. kernels   — every kernel against its plain PyTorch version on the
                 card, at the main paths' shapes and at odd ones:
                 quantize_rows (every launch-plan class at the VGG16,
                 decode and prefill sizes, odd and two-pass rows, row
                 slices, rows holding NaN, +-inf and zeros; plans
                 logged), the plane-0 GEMM (also on K-major weights
                 as prepared weights hand it, at the prefill shapes, the
                 recurrent models' layers at M = 128 included, and a
                 large-M VGG16 im2col shape, its K split logged), the
                 skinny GEMM on K-major weights (every rank, the decode,
                 first-chunk prefill (m = 32) and VGG16 FC shapes, every
                 m class with a K tail, its K split logged; the recurrent
                 and conditioned models' layers and LM heads at m = 1, 4,
                 8 and 32, Whisper's tied head at N = 51865 among them),
                 plane 0 also at M = 128 on the conditioned models' layers,
                 at M = 1500 on Whisper's encoder shapes and at M = 1600
                 and 6400 on the vision model's image K/V, the fused
                 and the stacked low-rank GEMMs (ranks 1, 2, 4, 8, every VGG16 conv shape;
                 stacked bit-identical to fused, its launches counted over
                 these parity calls) bit-exact, flash attention within
                 2e-6 (f32) / 2e-2 (bf16) (Whisper's encoder at (16,
                 1500, 64) non-causal, StarCoder2's and the vision model's
                 prefills at (36 / 32, 128, 128) among its shapes); the
                 MoE models' GEMMs (grok-1's and llama4-maverick's
                 attention, one expert matrix per shape, llama4's dense
                 FFN, both LM heads, N = 202048 among them) on skinny at
                 m = 1, 4, 5 and 32 and on plane 0 at M = 40 and 128,
                 bit-exact; then each kernel's time per unit
                 of its main path (CUDA events) beside its plain version
                 (quantize_rows per decode step and per VGG16 forward, with
                 x.to(torch.int8) on the same inputs as a same-bytes
                 yardstick), a
                 PyTorch library yardstick (`torch._int_mm` on K-major
                 weights, SDPA pinned to its memory-efficient backend; wall
                 and device time) and the card's bound; the skinny
                 kernel's device time per call of each decode shape inside
                 the step, the fused kernel's per VGG16 conv shape and at
                 the TinyLlama
                 prefill shapes under pareto:0.01, and plane 0's time over
                 VGG16's 13 conv GEMMs under trunc2x2; and, bit-exact,
                 training's GEMMs on row-major weights (plane 0 at M =
                 1024, the fused kernel at M = 512; TinyLlama's layers and
                 head) and quantize_rows at those rows;
  4. autotune  — the measured tuning cache behind `choose_gemm_path`,
                 in a cache file of the phase's own: every bucket of
                 TinyLlama-1.1B's decode (m = 4), prefill (M = 128) and
                 2-layer-check prefill (M = 512) GEMMs under trunc2x2,
                 VGG16's conv and FC GEMMs under pareto:0.01, tuned on
                 the card (every split count of plane 0 and skinny, both
                 tile widths of fused and stacked, the plain path as a
                 yardstick; CUDA graphs of runs over cold weights),
                 one line per bucket: static, candidates, winner, plain,
                 bound and share; then, under policy auto, the 2-layer
                 check (trunc2x2, flash) and a VGG16 forward held bit for
                 bit to their untuned runs, every tuned bucket's plan
                 reading source "tuned"; calibrate_gemm on a tuned plan;
                 the full-width decode step's device ms by kind, static
                 against tuned;
  5. serve     — full-width TinyLlama-1.1B (22 layers, random f32 weights
                 from a seeded CUDA generator) under the trunc2x2 multiplier
                 through the port's slot Engine: 6 requests x 16 greedy
                 tokens, every kernel's launch counter read around the run;
  6. paged     — the same model through the paged engine on a ten-request
                 trace (the six prompts above, two seeded sampled requests,
                 two sharing a 64-token prefix), each run token-identical
                 to a slot engine of its capacity: P (paged, capacity 4,
                 pages of 16, prefix cache), PC (+ chunked prefill, 32),
                 PS (+ speculation drafted by trunc2x2 itself, k 4,
                 acceptance exactly 1), PD (the reference bench's equal-KV
                 layout: capacity 8, 65 pages, chunks of 32, budget 8,
                 trunc4x4 drafts) against S8; after each: the allocator's
                 audit, no live page, launches equal to `paged_want`'s
                 formula; then ms per decode step, chunk step and spec
                 step, tick-space TTFT of PD against S4, and the view's
                 gather and scatter on the profiler.  A run that leaves its
                 slot engine fails the phase.  PD runs metered: its
                 per-request Joules must sum to the meter's total;
  7. fleet     — the carbon-aware fleet on the same model: a metered
                 two-replica fleet (us-west and eu-west on the diurnal
                 trace, capacity 2, trunc2x2, 12 Poisson requests of 104
                 tokens x 16, replica 0 killed at its step 5), Joules
                 priced at the card's power limit: zero lost, exactly
                 once, per-replica conservation, tokens equal to a lone
                 slot engine, launches equal to `fleet_want`'s formula
                 over the meters' counts, every tick decision equal to the
                 same fleet on the CPU at the reduced size; the seeded
                 chaos campaign (seed 7, tiers exact/trunc2x2/trunc4x4, 16
                 requests): five invariants, report equal to its CPU tick
                 twin, every death an injected one; the total-carbon
                 search over the multi-die scenarios on the card, held to
                 the CPU's (rtol 1e-6);
  8. recurrent — mamba2-370m (4 of its 48 layers, cut so the script
                 stays well inside its time limit: the engines' steps are
                 host-bound and scale with depth) and then
                 recurrentgemma-9b (38 layers, 10.4B params) at full
                 width, the 9B at full depth, trunc2x2, f32, random
                 weights from a seeded CUDA generator, through
                 the slot and paged engines on the paged trace (tokens in
                 each model's vocabulary): S4, P, PS and PC against S4,
                 but mamba2's PC against C4, a slot engine admitting
                 through the same chunked prefill (under trunc2x2 its
                 chunked prefill parts from the whole one by int8 codes
                 that flip and grow with depth: C4's agreement with S4 is
                 reported), and its PD against C8 (the 9B runs no PD: its
                 trunc4x4 draft would prepare a second 17 GB int8 copy);
                 the chunked prefill held to the whole one under exact
                 (gap at most 1e-3, greedy tokens equal); the 9B's
                 params prepared once and shared by every engine; each
                 paged run token-identical to its slot engine, audit
                 clean, no live page, launches equal to `paged_want`'s
                 formula over
                 `step_launches` (17 GEMMs per mamba2 decode step, 241
                 per hybrid step, no flash); ms per prefill, decode step,
                 chunk step and spec step, one profiled decode step's
                 device busy share, and the peak device memory;
  9. recurrent-check — mamba2 at 2 layers (512-token prompts: the SSD
                 crosses two 256-token chunks) and the hybrid at 4 layers
                 (window cut to 64 under 128-token prompts: the rings
                 wrap), full width, once through the kernels and once
                 through the plain versions on the card: logits compared,
                 greedy tokens equal, the plain run launching nothing;
 10. conditioned — whisper-medium (4 + 4 of its 24 + 24 layers, 1500
                 frames), starcoder2-7b (8 of its 32 layers, the GELU
                 MLP) and llama-3.2-vision-11b (1 of its 8 superblocks,
                 5 + 1 cross layers; all three cut so the script stays
                 well inside its time limit; 1600 image
                 tokens, every cross-attention gate set to 1.0: it starts
                 at 0, which multiplies the image path away) at full
                 width, trunc2x2, flash, f32, random weights
                 from a seeded CUDA generator, prepared once, one model at
                 a time, through the slot and paged engines on the paged
                 trace, each request carrying its own seeded frames or
                 image (the two prefix-sharing requests the same ones):
                 S4, P, PS, C4 and PC (StarCoder2 S4 and P), P and PS
                 token-identical to S4, PC to C4 (the slot engine that
                 prefills the same chunks: under trunc2x2 the chunked
                 prefill parts from the whole one by int8 codes that
                 flip, which on these random weights move greedy and
                 sampled streams; C4's agreement with S4 is reported);
                 the chunked prefill held to the whole one under exact
                 at full depth; audit clean, no live page, a
                 prefix hit, launches equal to `paged_want`'s formula
                 over `step_launches`; ms per prefill, decode step, chunk
                 step and spec step, one profiled decode step's device
                 busy share, device memory after prepare and at peak, and
                 each model's seconds;
 11. conditioned-check — Whisper (2 + 2 layers) and the vision model (2
                 layers in one superblock) at full width, once through the
                 kernels and once through the plain versions on the card,
                 both on the chunked attention (flash's rounding moves
                 int8 codes that trunc2x2 carries to the logits; a
                 witness measures it and holds the GEMM kernels on
                 flash's outputs): logits compared, greedy tokens equal,
                 the plain run launching nothing; the whole prefill held
                 to the chunked one under exact;
 12. moe       — grok-1-314b (2 of its 64 layers: every layer MoE, 8
                 experts, top-2) and llama4-maverick-400b-a17b (1 of its
                 24 superblocks: a dense layer and an MoE layer with its
                 shared expert; 32 of its 128 experts, top-1: at 128 one
                 layer's experts hold 64.4 GB in f32, about 97 GB once
                 prepared, more than the card; the cut moves its expert
                 capacity in a bucket-128 prefill from 1 to 5) at full
                 width, trunc2x2, flash, f32, random weights from a
                 seeded CUDA generator, prepared once (every expert
                 matrix) and shared, through the slot and paged engines
                 on the paged trace: S4, P, PS, C4 and PC.  The rows of
                 an MoE call share its expert capacity (the reference's
                 GShard-style routing), so P is held to S4 (each idle
                 lane quiet), while PS against S4, PC against C4 and C4
                 against S4 are reported (their decode calls put other
                 rows beside a token), as is PS's acceptance; then S4,
                 PS and PC again on a copy of the config whose capacity
                 drops nothing (capacity_factor = experts / top_k, the
                 same prepared weights): PS and PC token-identical to S4
                 with every draft accepted, no token dropped (no C4
                 twin there: its C4 equalled S4 on every request of both
                 models); the exact whole-vs-chunked gap is reported,
                 and held on the no-drop copy; tokens
                 dropped per call, launches equal to `paged_want`'s
                 formula (an MoE layer's expert GEMMs at M = the call's
                 capacity), ms per prefill, decode, chunk and spec step,
                 device busy share, memory after prepare and at peak;
 13. moe-check — grok-1 at 1 layer and llama4-maverick at 1 superblock
                 (32 experts), full width, through the kernels and through
                 the plain versions, both on chunked attention: logit gap
                 0, greedy tokens and every call's routing (expert
                 indices, drop mask) equal, the plain run launching
                 nothing;
 14. train     — full-width TinyLlama-1.1B (22 layers, 1.1B params,
                 random f32 weights from a seeded CUDA generator) trained
                 under trunc2x2 through the kernels, chunked attention
                 (the flash kernel has no backward) and remat: 6 AdamW
                 steps (f32 moments) at batch 8 x seq 128 through
                 `launch.train.train`, every kernel's launch counter read
                 around the run and around one more step (quantize_rows =
                 plane 0 = (7 L + 1) + 7 L = 309 per step, the others 0),
                 losses and gradient norms finite, s/step, peak memory, a
                 profiled step's device busy share and the forward's
                 per-call weight quantize + K-major copy; then the CLI
                 (`launch.train.main`) for 2 steps at the config's bf16;
 15. train-check — the same model at 2 layers: one train step through
                 the kernels and one through the plain versions from the
                 same state, under trunc2x2 and pareto:0.01 (fused):
                 loss, gradient norm and every updated param equal (gap
                 0); a checkpoint round trip (npz + manifest, restored
                 bit-equal into a fresh trainer, steps 3-4 resumed within
                 1e-5 of an uninterrupted run); an int8-moment and an
                 Adafactor step finite;
 16. check     — a 2-layer full-width model served once through the kernels
                 and once through the plain versions on the card: logits and
                 greedy tokens compared, under trunc2x2 and under the
                 rank-5 Pareto multiplier pareto:0.01 (low-rank prefill on
                 the fused kernel, decode on the skinny one, both sides on
                 the plain attention; flash's o-projection inputs go
                 through the kernel and the plain GEMM, which must agree
                 to the bit, and flash-vs-chunked divergence is printed);
 17. cnn       — full-width VGG16 (224x224, 1000 classes, batch 8, random
                 f32 weights calibrated layer by layer to mean 0, var 1)
                 under pareto:0.01: 13 conv GEMMs on the fused kernel, 3 FC
                 GEMMs on the skinny kernel, launch counters read around
                 one forward, the smallest row absmax each GEMM quantizes,
                 forward time, device busy share, each quantize_rows
                 call's device time with its bound and launch plan, and
                 each FC GEMM's device time (the kernel, and the per-call
                 transpose of its weight);
 18. cnn-check — VGG16 and ResNet50 at batch 2 through the kernels and
                 through the plain versions on the card: logits compared,
                 top-1 equal;
 19. accuracy  — `repro_torch.launch.accuracy`: vgg_mini trained 260 steps,
                 top-1 and drop under every truncation and Pareto
                 multiplier, through the kernels and through the plain
                 versions (top-1 equal);
 20. codesign  — the co-design core on the card: the VGG16 7 nm space's
                 FPS lattice and every genome's metrics held to the CPU's
                 (rtol 1e-6, same inf places and feasible mask); the
                 paper's reproduction (`repro_torch.launch.codesign`:
                 VGG16 at 7/14/28 nm under drops measured through the
                 kernels on phase 19's vgg_mini), each GA design within
                 1e-4 of `exhaustive_best`; `calibrate_gemm` (plane 0 and
                 fused) and `calibrate_serving` (quantize, plane 0,
                 skinny) with their launches counted; the multi-die
                 scenarios under the GEMM calibration; the GA's times.

The line before the card line is a JSON object with one entry per kernel
and main-path unit (quantize_rows has two: the decode step and the VGG16
forward; `path` names the run its launches come from,
`paged_launches` holds each kernel's launches in run PD,
`fleet_launches` those of the metered fleet, `recurrent_launches`,
`conditioned_launches` and `moe_launches` those of each recurrent,
conditioned and MoE model's runs, summed; `train_launches` those of the
train phase's 6 steps; `autotune_launches` those of the autotune phase's
runs under its tuned cache);
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

MULT = "trunc2x2"
#: The CNN path's multiplier: the rank-5 gate-pruned Pareto multiplier.
CNN_MULT = "pareto:0.01"
#: The quantizers' scale floor: a row whose absmax is below it gets
#: coarser codes, so the CNN path must keep its rows far above it.
QUANT_FLOOR = 1e-8


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(kernel: str, shapes) -> tuple[float, str]:
    """The card's least milliseconds for `kernel`'s calls at `shapes`, and
    whether bytes or operations bound them: the port's roofline
    (`roofline.analysis.kernel_bound`, H100 SXM data-sheet peaks)."""
    from repro_torch.roofline import analysis as rfa
    sec, by = rfa.kernel_bound(kernel, shapes)
    return sec * 1e3, by


def pin_no_tuning_cache() -> str:
    """Point $REPRO_TUNING_CACHE at a file under build/ that does not
    exist, for every phase but autotune (which sets its own and puts this
    back): a tuning cache left in the checkout must not move the static
    plans that the readings and launch formulas assume."""
    import os
    (ROOT / "build").mkdir(exist_ok=True)
    path = ROOT / "build" / f"no-tuning-cache-{os.getpid()}.json"
    assert not path.exists(), path
    os.environ["REPRO_TUNING_CACHE"] = str(path)
    return str(path)


def assert_untuned(path: str) -> None:
    """No phase outside autotune read a tuned plan: the pinned cache is
    still absent and no memoized plan came from a cache."""
    from repro_torch.kernels import dispatch
    assert not pathlib.Path(path).exists(), path
    tuned = [k for k, p in dispatch._plans.items() if p.source == "tuned"]
    assert not tuned, tuned
    log(f"[done] no phase outside autotune read a tuning cache ({path} "
        f"absent; {len(dispatch._plans)} plans memoized, none tuned)")


def sms() -> int:
    """The card's SM count, which the kernels' launch plans read."""
    import torch
    from repro_torch import device as D
    return D.sm_count(torch.device("cuda", 0))


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


def kernel_times(fn, name: str = "") -> list[float] | None:
    """Device microseconds of each kernel whose name holds `name` that one
    call of `fn` runs, in launch order (torch.profiler); None when the
    trace holds no device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    us = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return us if sum(us) > 0 else None


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
        if "Compiling entry function" in line:
            log(f"[build] {line.split(chr(39))[1]}")    # the mangled name
        elif "registers" in line or "spill" in line or line.startswith("=="):
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


def same(got, want) -> bool:
    """Bit-exact, a NaN equal to a NaN (the card's NaN payloads are its
    own, in the kernel and in PyTorch's ops alike)."""
    import torch
    if not got.dtype.is_floating_point:
        return torch.equal(got, want)
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(
        torch.where(nan, 0, got), torch.where(nan, 0, want))


def check_quantize(dev, gen) -> None:
    """quantize_rows against its plain version: every launch-plan class at
    the main paths' sizes (VGG16's im2col and FC inputs, ResNet50's stem,
    the decode and prefill rows), odd shapes, rows past the register plan (two-pass),
    row slices off and on the 16-byte grid, and rows holding NaN, +-inf,
    zeros and absmaxes below the 1e-8 floor."""
    import torch
    from repro_torch.kernels import quantize as qz

    def held(x, what):
        m, k = x.shape
        plan = qz.launch_plan(m, k, x.stride(0), x.data_ptr(),
                               sm_count=sms())
        for trunc in (0, 2):
            q1, s1 = qz.quantize_rows(x, trunc=trunc)
            q0, s0 = qz.quantize_rows_plain(x, trunc)
            if not (same(q1, q0) and same(s1, s0)):
                raise AssertionError(
                    f"quantize_rows {what} ({m},{k}) trunc {trunc}: kernel "
                    f"!= plain (codes differ at {(q1 != q0).sum().item()}, "
                    f"scales at {(~(s1 == s0) & ~s0.isnan()).sum().item()})")
        return plan

    plans = []
    for m, k in [(401408, 27), (401408, 576), (100352, 1152), (25088, 2304),
                 (6272, 4608), (1568, 4608), (8, 25088), (100352, 147),
                 (128, 2048),
                 (128, 5632), (4, 2048), (4, 5632), (1, 2048), (1024, 2048),
                 (1024, 5632), (512, 2048), (512, 5632), (33, 257),
                 (3, 7), (3, 40000), (3, 40001)]:
        x = torch.randn((m, k), generator=gen, device=dev) * 3
        p = held(x, "random")
        plans.append(f"({m},{k}) {'16-byte' if p.vec else 'scalar'} "
                     f"lanes {p.lanes} x {p.vecs or 'loop'}")
        del x
    torch.cuda.empty_cache()
    big = torch.randn((9, 2056), generator=gen, device=dev)
    off = held(big[1:, 1:2049], "row slice off the 16-byte grid")
    on = held(big[1:, 8:2056], "row slice on the 16-byte grid")
    assert not off.vec and on.vec, (off, on)
    bits = []
    for k in (37, 2048, 25088, 40000):
        x = torch.randn((8, k), generator=gen, device=dev) * 3
        x[0, 3] = float("nan")
        x[1, 5] = float("inf")
        x[2, 7] = -float("inf")
        x[3] = 0
        x[4] *= 1e-10
        x[5, 2], x[5, k - 1] = float("inf"), float("nan")
        held(x, "non-finite rows")
        q, s = qz.quantize_rows(x)
        s0 = qz.quantize_rows_plain(x)[1]
        assert s[[0, 5]].isnan().all() and (s[1:3] == float("inf")).all()
        assert not q[:4].any() and not q[5].any()
        bits.append(torch.equal(s.view(torch.int32), s0.view(torch.int32)))
    nan_cast = torch.tensor([float("nan")], device=dev).to(torch.int8).item()
    log("[kernels] quantize_rows plans: " + "; ".join(plans))
    log(f"[kernels] quantize_rows: non-finite rows equal to the plain "
        f"version (NaN scales, codes 0; scale bits identical, NaN payloads "
        f"included: {all(bits)}); PyTorch's CUDA cast of NaN to int8 gives "
        f"{nan_cast}; row slices take the scalar variant off the 16-byte "
        f"grid and 16-byte loads on it")


def check_kernels(dev) -> tuple[dict, int]:
    """Kernel vs plain version on the card; returns max |err| per kernel
    and the stacked kernel's launches over its parity calls."""
    import torch
    from repro_torch.approx import gemm as G
    from repro_torch.kernels import approx_qgemm as qk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops, qgemm

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

    check_quantize(dev, gen)

    specs = {name: G.spec_from_name(name).to(dev)
             for name in ("exact", "trunc2x2", "trunc3x1")}
    # plane 0: unprepared operands (transposed per call), then the K-major
    # weight that prepared weights hand the kernel, at the prefill shapes
    # (TinyLlama's, then the recurrent models' layers at bucket 128) and at
    # a large-M VGG16 im2col shape (conv 3 at batch 8)
    rec_layers, rec_heads = model_gemm_shapes(RECURRENT_ARCHS)
    cond_layers, cond_heads = model_gemm_shapes(CONDITIONED_ARCHS)
    # the conditioned models' large-M GEMMs: Whisper's encoder (and its
    # cross K/V) at M = 1500, the vision cross K/V at M = 1600 (one image,
    # a prefill or a chunk step) and 6400 (four images, a decode step)
    whisper = [(1024, 1024), (1024, 4096), (4096, 1024)]
    cond_large = [(1500, k, n) for k, n in whisper] + [
        (m, 4096, 1024) for m in (1600, 6400)]
    prefill = [(128, 2048, 2048), (128, 2048, 256), (128, 2048, 5632),
               (128, 5632, 2048)]
    for m, k, n in prefill + [(33, 257, 65), (300, 64, 512)]:
        a, b = rand_q(m, k), rand_q(k, n)
        for name, spec in specs.items():
            got = ops.approx_qgemm(a, b, spec)
            exact("approx_qgemm_plane0", got, G.approx_qgemm(a, b, spec),
                  f"({m},{k},{n}) {name}")
    prefill += [(128, k, n) for k, n in
                dict.fromkeys(rec_layers + cond_layers)]
    for m, k, n in prefill + cond_large + [(100352, 1152, 128)]:
        a, b = rand_q(m, k), rand_q(k, n)
        bt = b.T.contiguous()
        names = ["trunc2x2"] if m == 100352 else specs
        for name in names:
            spec = specs[name]
            got = ops.approx_qgemm(a, b, spec, b_t=bt)
            exact("approx_qgemm_plane0", got, G.approx_qgemm(a, b, spec),
                  f"({m},{k},{n}) {name}, K-major weight")
            ta, tb, _ = ops._spec_kernel_args(spec)
            exact("approx_qgemm_plane0", got,
                  qgemm.approx_qgemm_plane0_plain(a, bt, trunc_a=ta,
                                                  trunc_b=tb),
                  f"({m},{k},{n}) {name}, K-major weight vs plain")
        splits, k_chunk = qgemm.plane0_splits(m, k, n, sm_count=sms())
        tm, _, tn = qk.PLANE0_TILE
        log(f"[kernels] plane0 ({m},{k},{n}): {splits} K split(s) of "
            f"{k_chunk}, {(m // tm) * (n // tn) * splits} blocks")
        del a, b, bt

    # skinny, on the K-major weight that prepared weights hand it: the
    # decode step's shapes (m = 4; the head also at m = 1), the paged
    # engine's first-chunk prefill (m = 32), VGG16's FC shapes (m = 8), odd
    # shapes, every m class and rank with a K tail
    lowrank = _lowrank_specs(dev)
    lowrank[5] = G.spec_from_name("pareto:0.01").to(dev)
    assert lowrank[5].rank == 5
    for m, k, n in [(4, 2048, 2048), (4, 2048, 256), (4, 2048, 5632),
                    (4, 5632, 2048), (4, 2048, 32000), (1, 2048, 32000),
                    (32, 2048, 2048), (32, 2048, 256), (32, 2048, 5632),
                    (32, 5632, 2048), (8, 25088, 4096), (8, 4096, 4096),
                    (8, 4096, 1000), (3, 257, 65), (32, 512, 256), (9, 200, 130)] + [
                        (m, 300, 200) for m in (1, 3, 4, 8, 17, 32)]:
        a, b = rand_q(m, k), rand_q(k, n)
        bt = b.T.contiguous()
        for name, spec in specs.items():
            got = ops.approx_qgemm(a, b, spec, skinny=True, b_t=bt)
            exact("approx_qgemm_skinny", got, G.approx_qgemm(a, b, spec),
                  f"({m},{k},{n}) {name}, K-major weight")
        for rank, spec in lowrank.items():
            bk, _ = qk.choose_skinny_blocks(k, n)
            ap = ops._pad_to(a, 1, bk)
            btp = ops._pad_to(bt, 1, bk)
            scales = ops.plane_scales(spec, rank, dev)
            got = qgemm.approx_qgemm_skinny(ap, btp, spec.fu_q, spec.fv_q,
                                            scales, k_valid=k)
            want = qgemm.approx_qgemm_skinny_plain(
                ap, btp, spec.fu_q, spec.fv_q, scales, k_valid=k)
            exact("approx_qgemm_skinny", got, want,
                  f"({m},{k},{n}) rank {rank}")
            exact("approx_qgemm_skinny",
                  ops.approx_qgemm(a, b, spec, skinny=True, b_t=bt), got,
                  f"({m},{k},{n}) rank {rank}, route vs wrapper")
            ref = G.approx_qgemm(a, b, spec)
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1.0)
        splits, gran = qgemm.skinny_splits(k, n, sm_count=sms())
        log(f"[kernels] skinny ({m},{k},{n}): {splits} K split(s) of "
            f"{gran}-byte units, {-(-n // qk.SKINNY_BM) * splits} blocks")
        del a, b, bt

    # skinny at the recurrent and conditioned models' shapes, layers and
    # LM heads (Whisper's tied one at the odd N = 51865 among them), at the
    # m their phases give it: 1 (chunk steps, the head after a prefill), 4
    # (decode at capacity 4), 8 (PD at capacity 8) and 32 (the first chunk
    # of PC and PD)
    for k, n in rec_layers + rec_heads + [
            kn for kn in cond_layers + cond_heads
            if kn not in rec_layers + rec_heads]:
        b = rand_q(k, n)
        bt = b.T.contiguous()
        for m in (1, 4, 8, 32):
            a = rand_q(m, k)
            for name, spec in specs.items():
                got = ops.approx_qgemm(a, b, spec, skinny=True, b_t=bt)
                exact("approx_qgemm_skinny", got,
                      G.approx_qgemm(a, b, spec),
                      f"({m},{k},{n}) {name}, K-major weight")
        splits, gran = qgemm.skinny_splits(k, n, sm_count=sms())
        log(f"[kernels] skinny (1-32,{k},{n}): {splits} K split(s) of "
            f"{gran}-byte units, {-(-n // qk.SKINNY_BM) * splits} blocks")
        del a, b, bt
        torch.cuda.empty_cache()

    # the MoE models' GEMMs, one expert matrix per (k, n), the dense and
    # shared-expert FFNs and the LM heads (llama4-maverick's N = 202048
    # tail among them): skinny at m = 1 (chunk steps), 4 (decode at
    # capacity 4; an expert's capacity is 1 there), 5 (llama4's expert
    # capacity in a bucket-128 prefill at 32 experts) and 32 (first
    # chunks), plane 0 at M = 40 (grok's expert capacity in a bucket-128
    # prefill) and 128 (attention, dense and shared FFN), all bit-exact
    moe_layers, moe_heads = model_gemm_shapes(MOE_ARCHS)
    for k, n in moe_layers + moe_heads:
        b = rand_q(k, n)
        bt = b.T.contiguous()
        for m in (1, 4, 5, 32):
            a = rand_q(m, k)
            for name, spec in specs.items():
                got = ops.approx_qgemm(a, b, spec, skinny=True, b_t=bt)
                exact("approx_qgemm_skinny", got,
                      G.approx_qgemm(a, b, spec),
                      f"({m},{k},{n}) {name}, K-major weight")
        if (k, n) in moe_layers:
            for m in (40, 128):
                a = rand_q(m, k)
                for name, spec in specs.items():
                    got = ops.approx_qgemm(a, b, spec, b_t=bt)
                    exact("approx_qgemm_plane0", got,
                          G.approx_qgemm(a, b, spec),
                          f"({m},{k},{n}) {name}, K-major weight")
                    ta, tb, _ = ops._spec_kernel_args(spec)
                    exact("approx_qgemm_plane0", got,
                          qgemm.approx_qgemm_plane0_plain(
                              a, bt, trunc_a=ta, trunc_b=tb),
                          f"({m},{k},{n}) {name}, K-major weight vs plain")
        splits, gran = qgemm.skinny_splits(k, n, sm_count=sms())
        log(f"[kernels] MoE ({k},{n}): skinny at m = 1, 4, 5, 32 "
            f"({splits} K split(s) of {gran}-byte units)"
            + (f", plane 0 at M = 40, 128 ("
               f"{qgemm.plane0_splits(40, k, n, sm_count=sms())[0]}, "
               f"{qgemm.plane0_splits(128, k, n, sm_count=sms())[0]} K "
               f"splits)"
               if (k, n) in moe_layers else ""))
        del a, b, bt
        torch.cuda.empty_cache()

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
                          a, b.T, spec.fu_q, spec.fv_q,
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

    # training: TinyLlama's GEMMs (the head included) at the train phase's
    # M = 8 x 128 rows on plane 0, and at the train-check's 4 x 128 on the
    # fused kernel under pareto:0.01, on row-major weights transposed per
    # call, as the training forward hands them (its weights change every
    # step, so nothing is prepared)
    for k, n in [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                 (2048, 32000)]:
        b = rand_q(k, n)
        a = rand_q(1024, k)
        for name, spec in specs.items():
            exact("approx_qgemm_plane0", ops.approx_qgemm(a, b, spec),
                  G.approx_qgemm(a, b, spec),
                  f"(1024,{k},{n}) {name}, row-major weight")
        a = rand_q(512, k)
        spec = lowrank[5]
        got = ops.approx_qgemm(a, b, spec)
        exact("approx_qgemm_fused", got, qgemm.approx_qgemm_fused_plain(
            a, b.T, spec.fu_q, spec.fv_q, ops.plane_scales(spec, 5, dev),
            k_valid=k), f"(512,{k},{n}) pareto:0.01, row-major weight")
        torch.testing.assert_close(got, G.approx_qgemm(a, b, spec),
                                   rtol=1e-6, atol=1.0)
        del a, b, got
    torch.cuda.empty_cache()
    spec = lowrank[2]
    a, b = rand_q(128, 128), rand_q(128, 128)
    ap = torch.cat([a, torch.zeros_like(a)], 1)
    bp = torch.cat([b, torch.zeros_like(b)], 0)
    exact("approx_qgemm_fused", qgemm.approx_qgemm_fused(
        ap, bp.T.contiguous(), spec.fu_q, spec.fv_q,
        ops.plane_scales(spec, 2, dev), k_valid=128),
        G.approx_qgemm(a, b, spec), "fully padded K tile")
    torch.cuda.empty_cache()

    # flash: the whole-prompt prefill (s = 128), the paged engine's first
    # chunk (s = 32, one partial tile), other widths and odd lengths;
    # Whisper's encoder (16 heads over 1500 frames, non-causal) and the
    # prefills of StarCoder2 (36 heads) and the vision model (32) at d 128
    for bh, s, d in [(32, 128, 64), (32, 32, 64), (2, 256, 128),
                     (1, 64, 256), (3, 77, 64), (4, 100, 32),
                     (16, 1500, 64), (36, 128, 128), (32, 128, 128)]:
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
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.approx import gemm as G
    from repro_torch.kernels import approx_qgemm as qk
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
    # the library yardstick's weights, K-major (cuBLAS's int8 GEMMs want a
    # K-major B), made once outside the timed loops
    kmajor = {id(w): w.t().contiguous().t() for w in weights + [head]}
    cap, bucket = 4, 128
    acts = {(m, k): torch.randint(-128, 128, (m, k), generator=gen,
                                  device=dev, dtype=torch.int8)
            for m in (cap, 32, bucket) for k in (d, f)}
    out = []

    def row(name, route, source, replaces, unit, calls, kernel, plain,
            library, shapes, path="serve"):
        b, by = bound_ms(name, shapes)
        lib_ms = lib_dms = None
        if library is not None:
            try:  # a yardstick only: the port never calls it
                lib_ms = cuda_ms(library)
                lib_dms = device_ms(library)
            except RuntimeError as e:
                log(f"[time] {name}: library call unavailable ({e})")
        out.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": errs[name], "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain, reps=3, warmup=1),
            "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms, "library_device_ms": lib_dms,
            "unit": unit, "calls": calls, "device_ms": device_ms(kernel),
            "path": path})
        dms = out[-1]["device_ms"]
        share = f"{b / dms:.1%}" if dms else "not measured"
        log(f"[time] {name}: {out[-1]['ms']:.4f} ms per {unit} "
            f"(device {dms}, plain {out[-1]['plain_ms']:.4f}, bound "
            f"{b:.4f} by {by}, device time at {share} of the bound, "
            f"library {lib_ms}, library device {lib_dms})")

    # skinny: one decode step of the arena (m = capacity), on the K-major
    # weights that prepared weights keep: (N, K) contiguous, the storage of
    # the yardstick's K-major views
    dec = [(acts[(cap, w.shape[0])], w, kmajor[id(w)].t())
           for w in weights + [head]]

    def decode_step():
        return [ops.approx_qgemm(a, w, spec, skinny=True, b_t=wt)
                for a, w, wt in dec]

    row("approx_qgemm_skinny", "cuda", "src/repro_torch/csrc/skinny.cu",
        "src/repro/kernels/approx_qgemm.py:418", "decode step (m=4)",
        len(dec), decode_step,
        lambda: [qgemm.approx_qgemm_skinny_plain(
            a, wt, spec.fu_q, spec.fv_q, trunc_a=2, trunc_b=2,
            k_valid=a.shape[1]) for a, _, wt in dec],
        lambda: [torch._int_mm(acts[(32, w.shape[0])], kmajor[id(w)])
                 for _, w, _ in dec],
        [(a.shape[0], *w.shape) for a, w, _ in dec])
    # where skinny's time goes: device time per call of each decode shape,
    # inside the step (the weights stream from HBM, as in serving)
    per_call = kernel_times(decode_step, "skinny_kernel")
    if per_call is None:
        log("[time] approx_qgemm_skinny device time per call: not measured")
    else:
        shapes = {}
        for (_, w, _), us in zip(dec, per_call):
            shapes.setdefault((cap, w.shape[0], w.shape[1]), []).append(us)
        log(f"[time] approx_qgemm_skinny device time per call in the decode "
            f"step ({sum(per_call) / 1e3:.4f} ms over its {len(per_call)} "
            f"calls): " + "; ".join(
                f"({m},{k},{n}) x{len(t)}: {sum(t) / len(t):.2f} us (bound "
                f"{bound_ms('approx_qgemm_skinny', [(m, k, n)])[0] * 1e3:.2f}"
                f" us, "
                f"{qgemm.skinny_splits(k, n, sm_count=sms())[0]} split(s))"
                for (m, k, n), t in shapes.items()))

    # plane0: the GEMMs of one admitted request's prefill (m = bucket), on
    # the K-major weights that prepared weights keep: (N, K) contiguous,
    # the storage of the yardstick's K-major views
    pre = [(acts[(bucket, w.shape[0])], w, kmajor[id(w)].t())
           for w in weights]
    row("approx_qgemm_plane0", "cuda", "src/repro_torch/csrc/qgemm.cu",
        "src/repro/kernels/approx_qgemm.py:338", "prefill (m=128)", len(pre),
        lambda: [ops.approx_qgemm(a, w, spec, b_t=wt) for a, w, wt in pre],
        lambda: [qgemm.approx_qgemm_plane0_plain(a, wt, trunc_a=2,
                                                 trunc_b=2)
                 for a, _, wt in pre],
        lambda: [torch._int_mm(a, kmajor[id(w)]) for a, w, _ in pre],
        [(a.shape[0], *w.shape) for a, w, _ in pre])
    # where plane 0's time goes: device time per call at each prefill shape
    shapes = {}
    for a, w, wt in pre:
        mkn_ = (a.shape[0], a.shape[1], w.shape[1])
        shapes.setdefault(mkn_, [a, wt, 0])[2] += 1
    parts = []
    for (m, k, n), (a, wt, count) in shapes.items():
        dms = device_ms(lambda: [ops.approx_qgemm(a, wt.T, spec, b_t=wt)
                                 for _ in range(count)])
        us = f"{dms / count * 1e3:.2f} us" if dms else "not measured"
        parts.append(f"({m},{k},{n}) x{count}: {us}, "
                     f"{qgemm.plane0_splits(m, k, n, sm_count=sms())[0]} "
                     f"split(s)")
    log("[time] approx_qgemm_plane0 device time per call: "
        + "; ".join(parts))
    # the earlier yardstick, on row-major weights, read once beside it
    row_major = {
        "prefill": cuda_ms(lambda: [torch._int_mm(a, w) for a, w, _ in pre]),
        "decode step": cuda_ms(lambda: [torch._int_mm(acts[(32, w.shape[0])],
                                                      w) for _, w, _ in dec])}
    log(f"[time] torch._int_mm on row-major (K, N) weights: "
        + ", ".join(f"{u} {t:.4f} ms" for u, t in row_major.items())
        + " (K-major: the library_ms of rows approx_qgemm_plane0 and "
        "approx_qgemm_skinny)")

    # quantize_rows: the activation rows of one decode step
    xs = [torch.randn((cap, w.shape[0]), generator=gen, device=dev)
          for w in weights + [head]]
    row("quantize_rows", "cuda", "src/repro_torch/csrc/quantize.cu",
        "src/repro/kernels/quantize.py:44", "decode step (m=4)", len(xs),
        lambda: [qz.quantize_rows(x, trunc=2) for x in xs],
        lambda: [qz.quantize_rows_plain(x, 2) for x in xs],
        None, [tuple(x.shape) for x in xs])
    # quantize_rows: the 16 GEMM inputs of one VGG16 forward (batch 8), as
    # pareto:0.01 quantizes them (no mask); beside it a same-bytes
    # yardstick, x.to(torch.int8) (reads 4 bytes and writes 1 per element,
    # but not the same function: timed only)
    xs = [torch.randn(mk, generator=gen, device=dev) for mk in vgg16_rows()]
    row("quantize_rows", "cuda", "src/repro_torch/csrc/quantize.cu",
        "src/repro/kernels/quantize.py:44",
        "VGG16 forward, batch 8 (16 GEMM inputs)", len(xs),
        lambda: [qz.quantize_rows(x) for x in xs],
        lambda: [qz.quantize_rows_plain(x) for x in xs],
        None, [tuple(x.shape) for x in xs], path="cnn")

    def to_int8():
        return [x.to(torch.int8) for x in xs]

    log(f"[time] same-bytes yardstick on the VGG16 quantize inputs, "
        f"x.to(torch.int8): {cuda_ms(to_int8):.4f} ms (device "
        f"{device_ms(to_int8)}; bound {out[-1]['bound_ms']:.4f})")

    # flash: the attention calls of one admitted request's prefill
    bh, hd = cfg.n_heads, cfg.hd
    qkv = [tuple(torch.randn((bh, bucket, hd), generator=gen, device=dev)
                 for _ in range(3)) for _ in range(cfg.n_layers)]

    def sdpa():  # one named backend, the same kernel in every run
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return [F.scaled_dot_product_attention(
                q[None], k[None], v_[None], is_causal=True)
                for q, k, v_ in qkv]

    log("[time] flash_attention library yardstick: SDPA pinned to "
        f"{SDPBackend.EFFICIENT_ATTENTION.name}")
    row("flash_attention", "cuda", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:76", "prefill (s=128)",
        len(qkv),
        lambda: [fk.flash_attention(q, k, v_) for q, k, v_ in qkv],
        lambda: [fk.flash_attention_plain(q, k, v_) for q, k, v_ in qkv],
        sdpa, [(bh, bucket, bucket, hd)] * len(qkv))
    del weights, head, kmajor, acts, dec, pre, xs, qkv
    torch.cuda.empty_cache()

    # fused: the 13 conv GEMMs of one VGG16 forward (batch 8, 224x224)
    # under the rank-5 Pareto multiplier, as the CNN path calls them (the
    # quantized weight transposed per call); stacked: the same GEMMs
    # through the stacked route, on stacks built beforehand
    lspec = G.spec_from_name(CNN_MULT).to(dev)
    rank = lspec.rank
    planes = rank + 1
    scales = ops.plane_scales(lspec, rank, dev)
    convs = [(torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                            dtype=torch.int8),
              torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8)) for m, k, n in vgg16_convs()]
    mkn = [(a.shape[0], a.shape[1], w.shape[1]) for a, w in convs]
    # the yardstick: R + 1 exact products per GEMM, torch._int_mm on
    # K-major weights (made once, untimed); it takes K and N in multiples
    # of 8, so conv 1's K = 27 pads
    padded8 = [(ops._pad_to(a, 1, 8), ops._pad_to(w, 0, 8))
               for a, w in convs]
    kmajor8 = [(a, w.t().contiguous().t()) for a, w in padded8]

    def int_mm_planes():
        return [torch._int_mm(a, w) for a, w in kmajor8
                for _ in range(planes)]

    row("approx_qgemm_fused", "cuda", "src/repro_torch/csrc/qgemm.cu",
        "src/repro/kernels/approx_qgemm.py:273",
        "VGG16 forward, batch 8 (13 conv GEMMs)", len(convs),
        lambda: [ops.approx_qgemm(a, w, lspec) for a, w in convs],
        lambda: [qgemm.approx_qgemm_fused_plain(
            a, w.T, lspec.fu_q, lspec.fv_q, scales, k_valid=a.shape[1])
            for a, w in convs],
        int_mm_planes, [(m, k, n, planes) for m, k, n in mkn], path="cnn")
    # the earlier yardstick, on row-major weights, read once beside it
    row_major = cuda_ms(lambda: [torch._int_mm(a, w) for a, w in padded8
                                 for _ in range(planes)])
    log(f"[time] {planes} x torch._int_mm per VGG16 conv GEMM on row-major "
        f"(K, N) weights: {row_major:.4f} ms (K-major: the library_ms of "
        "rows approx_qgemm_fused and approx_qgemm_stacked)")
    # where fused's time goes: device time per call at each VGG16 shape,
    # beside its operation bound, and at the TinyLlama prefill shapes
    # (M = 128) under the same multiplier
    parts = []
    for (m, k, n), (a, w) in zip(mkn, convs):
        dms = device_ms(lambda: ops.approx_qgemm(a, w, lspec))
        b, _ = bound_ms("approx_qgemm_fused", [(m, k, n, planes)])
        us = f"{dms * 1e3:.1f} us" if dms else "not measured"
        parts.append(f"({m},{k},{n}): {us} (bound {b * 1e3:.1f} us, "
                     f"tile {qk.fused_tile(n)[2]})")
    log("[time] approx_qgemm_fused device time per call: "
        + "; ".join(parts))
    parts = []
    for m, k, n in [(128, 2048, 2048), (128, 2048, 256), (128, 2048, 5632),
                    (128, 5632, 2048)]:
        a = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        wt = torch.randint(-128, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8)
        dms = device_ms(lambda: ops.approx_qgemm(a, wt.T, lspec, b_t=wt))
        b, by = bound_ms("approx_qgemm_fused", [(m, k, n, planes)])
        us = f"{dms * 1e3:.1f} us" if dms else "not measured"
        parts.append(f"({m},{k},{n}): {us} (bound {b * 1e3:.1f} us by "
                     f"{by})")
    log(f"[time] approx_qgemm_fused at the TinyLlama prefill shapes under "
        f"{CNN_MULT}, K-major weights, device time per call: "
        + "; ".join(parts))
    stacks = []
    for a, w in convs:
        a_s, b_s, s_ = ops.build_stacks(a, w, lspec)
        bm, bk, bn = qk.choose_blocks(*a.shape, w.shape[1], kernel="stacked")
        stacks.append((ops._pad_to(ops._pad_to(a_s, 1, bm), 2, bk),
                       ops._pad_to(ops._pad_to(b_s, 1, bk), 2, bn), s_))
    del convs
    row("approx_qgemm_stacked", "cuda", "src/repro_torch/csrc/qgemm.cu",
        "src/repro/kernels/approx_qgemm.py:157",
        "VGG16 forward's 13 conv GEMMs, pre-mapped stacks", len(stacks),
        lambda: [qgemm.approx_qgemm_stacked(a_s, b_s, s_)
                 for a_s, b_s, s_ in stacks],
        lambda: [qgemm.approx_qgemm_stacked_plain(a_s, b_s, s_)
                 for a_s, b_s, s_ in stacks],
        int_mm_planes, [(m, k, n, planes) for m, k, n in mkn],
        path="parity")
    del stacks, padded8, kmajor8
    torch.cuda.empty_cache()

    # plane 0 at large M: the 13 conv GEMMs of one VGG16 forward (batch 8)
    # under trunc2x2, on K-major weights (a log line, not a row)
    convs = [(torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                            dtype=torch.int8),
              torch.randint(-128, 128, (n, k), generator=gen, device=dev,
                            dtype=torch.int8)) for m, k, n in mkn]

    def vgg_plane0():
        return [ops.approx_qgemm(a, wt.T, spec, b_t=wt) for a, wt in convs]

    b, by = bound_ms("approx_qgemm_plane0", mkn)
    log(f"[time] approx_qgemm_plane0 at large M, VGG16 forward's 13 conv "
        f"GEMMs (batch 8) under {MULT}: {cuda_ms(vgg_plane0, reps=3):.4f} "
        f"ms (device {device_ms(vgg_plane0)}, bound {b:.4f} by {by}); "
        f"splits "
        f"{sorted({qgemm.plane0_splits(*s, sm_count=sms())[0] for s in mkn})}")
    del convs
    torch.cuda.empty_cache()
    return out


def vgg16_rows(batch: int = 8) -> list[tuple]:
    """(M, K) of the 16 matrices one VGG16 forward quantizes: the 13 conv
    GEMMs' im2col rows, then the 3 FC inputs."""
    return [(m, k) for m, k, _ in vgg16_convs(batch)] + [
        (batch, 25088), (batch, 4096), (batch, 4096)]


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
# autotune: the measured tuning cache behind choose_gemm_path
# ---------------------------------------------------------------------------

#: VGG16's three FC GEMMs at batch 8, as (K, N).
VGG16_FCS = [(25088, 4096), (4096, 4096), (4096, 1000)]


def tuning_cells(cfg) -> list[tuple]:
    """(what, m, k, n, mult) of one GEMM per bucket the autotune phase
    tunes, the first of each bucket: TinyLlama-1.1B's layers (q/o, k/v,
    gate/up, down) at decode (m = 4; the head shares gate/up's bucket), at
    one request's prefill (M = 128) and at the 2-layer check's prefill (4
    rows x 128 tokens); VGG16's conv GEMMs and FC GEMMs (m = 8) under the
    CNN multiplier."""
    from repro_torch.kernels import autotune
    d, f, kvd = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd
    layer = [(d, d), (d, kvd), (d, f), (f, d)]
    cells = [(what, m, k, n, MULT) for what, m in
             (("decode", 4), ("prefill", 128), ("check prefill", 4 * 128))
             for k, n in layer]
    cells.append(("head", 4, d, cfg.vocab, MULT))
    cells += [("vgg16 conv", m, k, n, CNN_MULT)
              for m, k, n in vgg16_convs()]
    cells += [("vgg16 fc", 8, k, n, CNN_MULT) for k, n in VGG16_FCS]
    seen, out = set(), []
    for cell in cells:
        key = (autotune.shape_bucket(*cell[1:4]), cell[4])
        if key not in seen:
            seen.add(key)
            out.append(cell)
    return out


def _winner_kernel(plan) -> str:
    if plan.path == "stacked":
        return "approx_qgemm_stacked"
    if plan.skinny:
        return "approx_qgemm_skinny"
    return "approx_qgemm_plane0" if plan.splits is not None \
        else "approx_qgemm_fused"


def _plan_sources(dev, tuned: set) -> dict:
    """The sources of the memoized GEMM plans on `dev`; every plan of a
    tuned (bucket, mode, rank) must read "tuned"."""
    from repro_torch.kernels import autotune, dispatch
    sources = {}
    for (_, m, k, n, mode, rank, d), plan in dispatch._plans.items():
        if d != dev:
            continue
        sources[plan.source] = sources.get(plan.source, 0) + 1
        if (autotune.shape_bucket(m, k, n), mode, rank) in tuned:
            assert plan.source == "tuned", ((m, k, n, mode, rank), plan)
    return sources


def _device_ms_by_kind(kernels, steps: int) -> dict:
    """Device ms per step of a profiled decode's rows, by kernel kind."""
    kinds = {"skinny": "skinny", "quantize": "quantize_rows",
             "plane0": "plane0", "flash": "flash", "lowrank": "fused"}
    out = {}
    for e in kernels:
        kind = next((v for k, v in kinds.items() if k in e.key), "other")
        out[kind] = out.get(kind, 0.0) + e.self_device_time_total / 1e3 / steps
    return {k: round(v, 4) for k, v in sorted(out.items())}


def autotune_phase(dev, cfg_full, card: str) -> dict:
    """Tune every bucket of `tuning_cells` on the card into a cache of the
    phase's own ($REPRO_TUNING_CACHE, restored after to the absent file
    every other phase reads), one line per bucket; then, under policy auto, hold the
    2-layer TinyLlama check (trunc2x2, flash: prefill and 8 decode steps)
    and one VGG16 forward (batch 8, pareto:0.01) under the tuned cache bit
    for bit to their runs without it, every plan of a tuned bucket
    reading source "tuned"; anchor calibrate_gemm on a tuned plan; and
    report the full-width decode step's device time by kind, static
    against tuned.  Returns the launches of the runs under the tuned
    cache (not the tuner's own timing calls)."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.approx import gemm as G
    from repro_torch.core import calibrate as cal
    from repro_torch.kernels import autotune, dispatch
    from repro_torch.models import api, cnn
    from repro_torch.roofline import analysis as rfa
    from repro_torch.serving import Engine

    t0 = time.perf_counter()
    var = "REPRO_TUNING_CACHE"
    saved = os.environ.get(var)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tuning-", dir=str(ROOT / "build"))
    tuned_path = os.path.join(tmp, "TUNING_gemm_torch.json")
    untuned_path = os.path.join(tmp, "absent.json")
    launches = {name: 0 for name in counters()}

    def add(n):
        for name, v in n.items():
            launches[name] += v

    try:
        os.environ[var] = tuned_path
        specs = {MULT: G.spec_from_name(MULT).to(dev),
                 CNN_MULT: _cnn_spec(dev, "auto")}
        log(f"[autotune] card {autotune.card_of(dev).key}, cache {tuned_path}"
            f" (kernel library {autotune.kernel_version()})")
        tuned = set()
        for what, m, k, n, mult in tuning_cells(cfg_full):
            spec = specs[mult]
            rank = spec.rank if spec.mode == "lowrank" else 0
            plan = autotune.tune_gemm(m, k, n, spec, device=dev)
            tuned.add((autotune.shape_bucket(m, k, n), spec.mode, rank))
            win = plan.us[plan.path]
            bound, by = rfa.kernel_bound(_winner_kernel(plan),
                                         [(m, k, n, rank + 1)])
            cands = ", ".join(f"{lbl} {us:.2f}"
                              for lbl, us in plan.candidates.items())
            log(f"[autotune] {what} ({m},{k},{n}) {mult} "
                f"{autotune.shape_bucket(m, k, n)}: static {plan.static} "
                f"{plan.candidates[plan.static]:.2f} us; candidates "
                f"{cands} us; winner {plan.label} {win:.2f} us "
                f"({plan.candidates[plan.static] / win:.3f}x "
                f"static); plain {plan.us['xla']:.2f} us; bound "
                f"{bound * 1e6:.2f} us by {by}, winner at "
                f"{bound * 1e6 / win:.1%} of it")
        log(f"[autotune] tuned {len(tuned)} buckets in "
            f"{time.perf_counter() - t0:.1f}s")

        # the 2-layer check: prefill and 8 greedy decode steps, under
        # policy auto, without and with the tuned cache
        cfg = dataclasses.replace(cfg_full, n_layers=2, mult=MULT,
                                  attn_impl="flash", kernel_policy="auto")
        params = api.init_params(cfg, seed=1, device=dev)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                               (4, 128))).to(dev)
        true_len = torch.tensor([128, 77, 40, 101], dtype=torch.int32,
                                device=dev)
        spec = api.make_spec(cfg, device=dev)
        p = api.prepare_params(params, cfg, spec)

        def check_run():
            logits, cache = api.prefill(p, tokens, cfg, spec, max_len=160,
                                        true_len=true_len)
            out = [logits]
            for _ in range(8):
                tok = out[-1].reshape(4, -1).argmax(-1)
                logits, cache = api.decode_step(p, cache, tok[:, None], cfg,
                                                spec)
                out.append(logits)
            return out

        def vgg_run():
            return cnn.vgg_forward(vgg, x, "vgg16", spec=specs[CNN_MULT])

        x = torch.randn((8, 224, 224, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
        vgg = vgg16_params(dev, 0, x)[0]
        runs = {}
        for label, path in (("untuned", untuned_path), ("tuned", tuned_path)):
            os.environ[var] = path
            with torch.no_grad():
                out, n_check = counted(check_run)
                fwd, n_vgg = counted(vgg_run)
            sources = _plan_sources(dev, tuned if label == "tuned" else set())
            if label == "untuned":
                assert set(sources) == {"default"}, sources
                assert all(pl.path == "fused" and pl.splits is None
                           for pl in dispatch._plans.values()), "not static"
            else:
                add(n_check)
                add(n_vgg)
            runs[label] = (out, fwd)
            log(f"[autotune] {label}: plan sources {sources}; check "
                f"launches { {k: v for k, v in n_check.items() if v} }; "
                f"VGG16 launches { {k: v for k, v in n_vgg.items() if v} }")
        for a, b in zip(runs["untuned"][0], runs["tuned"][0]):
            assert torch.isfinite(a).all() and torch.equal(a, b), \
                (a - b).abs().max().item()
        assert torch.equal(runs["untuned"][1], runs["tuned"][1]), \
            (runs["untuned"][1] - runs["tuned"][1]).abs().max().item()
        log("[autotune] under the tuned cache the 2-layer check (prefill + "
            "8 decode steps, 9 logits tensors) and the VGG16 forward equal "
            "their untuned runs bit for bit")
        del params, p, vgg, x, runs
        torch.cuda.empty_cache()

        # the delay anchor on a tuned plan: the q/o projection's prefill
        m, k, n = next(cell[1:4] for cell in tuning_cells(cfg_full)
                       if cell[0] == "prefill")
        c, n_cal = counted(lambda: cal.calibrate_gemm(
            m=m, k=k, n=n, mult_name=MULT, policy="auto", device=dev))
        add(n_cal)
        assert c.meta["dispatch"]["source"] == "tuned", c.meta["dispatch"]
        log(f"[autotune] calibrate_gemm ({m},{k},{n}) {MULT}: plan "
            f"{c.meta['dispatch']}, {c.meta['us_per_call']:.1f} us/call")

        # the full-width decode step, static against tuned
        cfg = dataclasses.replace(cfg_full, kernel_policy="auto")
        params = api.init_params(cfg, seed=0, device=dev)
        eng = Engine(cfg, params, capacity=4, max_len=256,
                     prefill_buckets=(128,), device=dev)
        kinds = {}
        for label, path in (("static", untuned_path), ("tuned", tuned_path)):
            os.environ[var] = path
            res, n = counted(lambda: profile_decode(
                eng, np.random.default_rng(5), cfg, tag=f"autotune {label}"))
            if label == "tuned":
                add(n)
            kinds[label] = None if res is None else \
                _device_ms_by_kind(res[0], 4)
        log(f"[autotune] full-width decode step (capacity 4), device ms per "
            f"step by kind: static {kinds['static']}, tuned "
            f"{kinds['tuned']} ({card})")
        del eng, params
        torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[autotune] launches under the tuned cache {launches}; phase "
        f"{time.perf_counter() - t0:.1f}s")
    return launches


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
    from repro_torch.approx import gemm as G
    from repro_torch.models import api
    from repro_torch.serving import Engine, Request, SamplingParams

    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    eng = Engine(cfg, params, capacity=4, max_len=256,
                 prefill_buckets=(128,), device=dev)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {api.param_count(params) / 1e9:.3f}B params, "
        f"engine ready in {time.perf_counter() - t0:.1f}s")

    def kmajor_bytes(tree):
        if isinstance(tree, dict):
            return sum(kmajor_bytes(v) for v in tree.values())
        return tree.wq_t.numel() if G.is_prepared(tree) and \
            tree.wq_t is not None else 0

    log(f"[serve] K-major int8 weight copies kept for the plane-0 and "
        f"skinny kernels: "
        f"{kmajor_bytes(eng._tier_exec[eng.tiers[0]]) / 1e9:.4f} GB")
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


#: The paged phase's trace: the serve phase's six greedy prompts, two
#: seeded sampled requests and two greedy requests sharing a 64-token
#: prefix (lengths and arrival ticks).
PAGED_GREEDY = [(40, 0), (128, 0), (77, 0), (100, 0), (64, 3), (115, 5)]
PAGED_SAMPLED = [(48, 1, 1001), (96, 4, 1002)]
PAGED_SHARED = [(16, 2), (16, 6)]
PAGED_NEW = 16


def seeded_extras(cfg, batch: int, step: int) -> dict:
    """Seeded conditioning for `batch` requests, drawn by the data
    pipeline's `frames_batch` / `img_batch`: a (batch, *shape) array for
    each key `api.extras_shapes` names ({} where the config takes none)."""
    from repro_torch.data import synthetic
    from repro_torch.models import api
    draw = {"frames": synthetic.frames_batch,
            "img_embeds": synthetic.img_batch}
    return {key: draw[key](batch, *shape, step)
            for key, shape in api.extras_shapes(cfg).items()}


def paged_trace(cfg) -> list:
    """Ten requests, tokens in the model's vocabulary: six greedy, two
    sampled, two sharing a 64-token prefix.  Where the config takes
    conditioning, each request carries its own seeded frames or image
    embeddings (`seeded_extras`), and the prefix-sharing pair the same
    ones, so their prefix pages are shared."""
    import dataclasses

    import numpy as np
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(0)      # the serve phase's six prompts
    greedy = SamplingParams(max_new_tokens=PAGED_NEW)
    out = [Request(f"g{i}", rng.integers(0, cfg.vocab, n).tolist(), greedy,
                   arrival=t) for i, (n, t) in enumerate(PAGED_GREEDY)]
    for i, (n, t, seed) in enumerate(PAGED_SAMPLED):
        out.append(Request(f"s{i}", rng.integers(0, cfg.vocab, n).tolist(),
                           SamplingParams(temperature=0.8, top_k=16,
                                          max_new_tokens=PAGED_NEW,
                                          seed=seed), arrival=t))
    prefix = rng.integers(0, cfg.vocab, 64).tolist()
    for i, (n, t) in enumerate(PAGED_SHARED):
        out.append(Request(f"h{i}", prefix + rng.integers(
            0, cfg.vocab, n).tolist(), greedy, arrival=t))
    out = sorted(out, key=lambda r: r.arrival)
    steps = [100 if r.request_id.startswith("h") else i
             for i, r in enumerate(out)]
    return [dataclasses.replace(r, extras={
        k: v[0] for k, v in seeded_extras(cfg, 1, step).items()} or None)
        for r, step in zip(out, steps)]


def gemm_rows(cfg, b: int, s: int, prefill: bool) -> list[int]:
    """The row count M of every approximate GEMM of one step, the LM head
    (at M = b) last: a prefill of b prompts of s tokens, or a decode step
    of b lanes (s = 1).  Per layer: 7 dense GEMMs under SwiGLU, 6 under
    the GELU MLP; mamba2's in and out projections (2); the hybrid's 6 per
    recurrent block (its w_rg / w_in run exact) and 7 per attention block
    (26 x 6 + 12 x 7 = 240 for recurrentgemma-9b); Whisper's 8 per
    decoder layer (self q, k, v, o; cross q, o; the MLP's two), and in
    prefill its encoder's 6 per layer and its cross K/V (2 per decoder
    layer, made once) at M = b x enc_seq; the vision model's 4 per
    cross-attention block (q, o, and the image's k, v at M = b x
    n_img_tokens, in every step).  An MoE layer runs its 4 attention
    GEMMs at M = b x s, then top_k x 3 x n_experts expert GEMMs (every
    expert, whether or not a token reached it) at M = the call's capacity,
    and the shared expert's 3 at b x s; an interleaved model's dense
    layers run 7 (grok-1: every layer MoE; llama4-maverick: one dense and
    one MoE layer per superblock)."""
    t = b * s
    if cfg.is_moe:
        from repro_torch.models import moe
        cap = moe.capacity_of(t, cfg.n_experts, cfg.top_k,
                              cfg.capacity_factor)
        moe_layer = [t] * (4 + 3 * cfg.shared_expert) + \
            [cap] * (cfg.top_k * 3 * cfg.n_experts)
        n_moe = cfg.n_layers // cfg.moe_every
        rows = moe_layer * n_moe + [t] * (7 * (cfg.n_layers - n_moe))
        return rows + [b]
    if cfg.family == "ssm":
        rows = [t] * (2 * cfg.n_layers)
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // 3
        rows = [t] * (6 * (cfg.n_layers - n_attn) + 7 * n_attn)
    elif cfg.family == "encdec":
        rows = [t] * (8 * cfg.n_layers)
        if prefill:
            e = b * cfg.enc_seq
            rows += [e] * (6 * cfg.n_enc_layers + 2 * cfg.n_layers)
    else:
        per_layer = 7 if cfg.mlp_style == "swiglu" else 6
        rows = [t] * (per_layer * cfg.n_layers)
        if cfg.cross_every:
            n_cross = cfg.n_layers // cfg.cross_every
            rows += [t] * (2 * n_cross) + \
                [b * cfg.n_img_tokens] * (2 * n_cross)
    return rows + [b]


def step_launches(cfg, b: int, s: int, prefill: bool) -> dict:
    """Kernel launches of one step (`gemm_rows`): each GEMM quantizes its
    rows once and runs skinny at M <= 32, plane 0 above; a prefill runs
    `flash_per_prefill` flash launches."""
    from repro_torch.kernels import approx_qgemm as qk
    rows = gemm_rows(cfg, b, s, prefill)
    skinny = sum(m <= qk.SKINNY_MAX_M for m in rows)
    return {"quantize_rows": len(rows), "approx_qgemm_skinny": skinny,
            "approx_qgemm_plane0": len(rows) - skinny,
            "flash_attention": flash_per_prefill(cfg, s) if prefill else 0,
            "approx_qgemm_fused": 0, "approx_qgemm_stacked": 0}


def flash_per_prefill(cfg, s: int = 128) -> int:
    """Flash launches of one prefill of s tokens: one per self-attention
    layer of an `lm` (the vision model's cross-attention takes the naive
    impl up to 2^20 scores); Whisper's encoder layers (non-causal over its
    frames) and decoder layers, and its cross-attention too where s equals
    enc_seq (the reference's impl rule); none for mamba2 (no attention) or
    the hybrid (its attention is windowed, which the reference routes to
    the blockwise forward: its flash has no window); none where the config
    takes another attention impl."""
    if cfg.attn_impl != "flash":
        return 0
    if cfg.family == "lm":
        return cfg.n_layers
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers * (2 if s == cfg.enc_seq
                                                  else 1)
    return 0


def paged_want(cfg, st: dict, trace, prefill_chunk, spec_k,
               capacity: int = 4, bucket: int = 128) -> dict:
    """Kernel launches of one paged (or slot) run, from the engine's own
    counts and `step_launches`.

    Every decode-shaped step (a decode step, a draft or verify step) runs
    at b = `capacity`, and each token of a later chunk runs one decode
    step at b = 1 (M <= 32 everywhere but the vision model's image K/V,
    which take plane 0).  A whole-prompt admission prefills at `bucket`;
    a chunked admission's first chunk prefills `prefill_chunk` = 32
    tokens (M = 32 takes skinny), and every later chunk runs one decode
    step per prompt token it takes (the last chunk unpadded), so a chunked
    prompt of n tokens runs n - `prefill_chunk` of them.  A spec step runs
    spec_k draft and spec_k verify steps.  Every request of the trace
    finishes its prefill (the phases assert they all finish by length)."""
    long = [] if prefill_chunk is None else [
        len(r.tokens) for r in trace if len(r.tokens) > prefill_chunk]
    chunked = len(long)
    whole = st["admitted"] - chunked
    spec_steps = st.get("spec", {}).get("steps", 0)
    chunk_tokens = sum(n - prefill_chunk for n in long)
    if prefill_chunk is not None and "paged" in st:
        assert st["paged"]["chunked"]["chunks"] == sum(
            -(-n // prefill_chunk) for n in long), st["paged"]["chunked"]
    steps = st["decode_steps"] - spec_steps + 2 * spec_k * spec_steps
    parts = [(steps, step_launches(cfg, capacity, 1, False)),
             (chunk_tokens, step_launches(cfg, 1, 1, False)),
             (whole, step_launches(cfg, 1, bucket, True))]
    if chunked:
        parts.append((chunked, step_launches(cfg, 1, prefill_chunk, True)))
    out = dict.fromkeys(counters(), 0)
    for count, per in parts:
        for k in out:
            out[k] += count * per[k]
    return out


def paged_runs(with_pd: bool = True) -> dict:
    """The paged phase's runs, by name: (engine class, keyword args).  S4
    and S8 are slot engines; P, PC, PS and PD paged ones."""
    from repro_torch.serving import Engine, PagedEngine
    paged_kw = dict(page_size=16)
    runs = {
        "S4": (Engine, dict(capacity=4)),
        "P": (PagedEngine, dict(capacity=4, **paged_kw)),
        "PC": (PagedEngine, dict(capacity=4, prefill_chunk=32,
                                 chunk_budget=1, **paged_kw)),
        "PS": (PagedEngine, dict(capacity=4, draft_tier=MULT, spec_k=4,
                                 **paged_kw)),
    }
    if with_pd:
        runs["S8"] = (Engine, dict(capacity=8))
        # bench_serving.py:134-147: the slot arena's 4 x 256 positions
        # as 64 pages of 16 plus the trash page, served 8 wide
        runs["PD"] = (PagedEngine, dict(
            capacity=8, n_pages=65, prefill_chunk=32, chunk_budget=8,
            draft_tier="trunc4x4", spec_k=4, **paged_kw))
    return runs


def run_want(cfg, name: str, kw: dict, st: dict, trace) -> dict:
    """`paged_want` for one run of `paged_runs` (a slot run is a paged
    run without chunks or drafts)."""
    return paged_want(cfg, st, trace, kw.get("prefill_chunk"),
                      kw.get("spec_k", 0) if "draft_tier" in kw else 0,
                      capacity=kw.get("capacity", 4))


def paged_phase(dev, cfg, card: str) -> dict:
    """The paged engine at full width, each run held to a slot engine of
    the same capacity on the same params and trace.  Returns the kernel
    launches of run PD (the reference bench's equal-KV-memory layout)."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.roofline import analysis as rfa
    from repro_torch.serving import PagedEngine

    t_phase = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    trace = paged_trace(cfg)
    common = dict(max_len=256, prefill_buckets=(128,), device=dev)
    runs = paged_runs()
    res, engines = {}, {}
    from repro_torch.fleet.meter import DevicePowerModel, EnergyMeter
    # PD runs metered: the paged engine's five meter calls on the card
    pd_meter = EnergyMeter(power=DevicePowerModel(tdp_w=card_tdp_w(card)))
    runs["PD"][1]["meter"] = pd_meter
    for name, (cls, kw) in runs.items():
        eng = cls(cfg, params, **common, **kw)
        for req in trace:
            eng.submit(req)
        t0 = time.perf_counter()
        done, launches = counted(eng.run_until_complete)
        wall = time.perf_counter() - t0
        st = eng.stats()
        toks = {c.request_id: (c.tokens, c.finish_reason) for c in done}
        assert len(toks) == len(trace), sorted(toks)
        for c in done:
            assert c.finish_reason == "length" and \
                len(c.tokens) == PAGED_NEW, c
        res[name] = dict(toks=toks, st=st, wall=wall, launches=launches,
                         done=done)
        ms = st["decode_s"] / max(st["decode_steps"], 1) * 1e3
        line = (f"[paged] {name}: {wall:.2f}s, {st['decode_steps']} decode "
                f"steps, {ms:.2f} ms/step, prefill {st['prefill_s']:.3f}s")
        if cls is PagedEngine:
            pg = st["paged"]
            eng._alloc.audit()
            assert pg["pages_live"] == 0, pg
            assert pg["alloc_failures"] == 0, pg
            want = run_want(cfg, name, kw, st, trace)
            assert launches == want, (name, launches, want)
            line += (f"; prefix hits {pg['prefix_hits']} "
                     f"({pg['prefix_hit_tokens']} tokens), stalls "
                     f"{pg['admission_stalls']}, chunks "
                     f"{pg['chunked']['chunks']}")
        log(line + f"; launches {launches}")
        if name in ("S4", "P"):
            engines[name] = eng
        else:
            del eng
        torch.cuda.empty_cache()

    s4, s8 = res["S4"]["toks"], res["S8"]["toks"]
    diverged = []
    for name, base in (("P", "S4"), ("PC", "S4"), ("PS", "S4"),
                       ("PD", "S8")):
        for rid, (toks, _) in res[name]["toks"].items():
            want = res[base]["toks"][rid][0]
            if toks != want:
                at = next(i for i, (a, b) in enumerate(zip(toks, want))
                          if a != b)
                diverged.append((name, rid, at))
                log(f"[paged] {name} {rid} diverges from {base} at token "
                    f"{at}: {toks} vs {want}")
    log(f"[paged] S8 equal to S4: {s8 == s4}; distinct tokens per request "
        f"in S4: { {r: len(set(t)) for r, (t, _) in sorted(s4.items())} }")
    # a divergence fails the phase; tests/test_torch_paged.py's
    # test_chunked_prefill_tie_moves_one_int8_code is the procedure that
    # finds the first moved int8 code of a chunked prompt
    assert not diverged, diverged
    log(f"[paged] P, PC, PS token-identical to S4 and PD to S8 on all "
        f"{len(trace)} requests")
    assert res["P"]["st"]["paged"]["prefix_hits"] >= 1
    assert res["PC"]["st"]["paged"]["chunked"]["chunks"] > 0
    ps = res["PS"]["st"]["spec"]
    assert ps["acceptance_rate"] == 1.0, ps
    for name in ("PS", "PD"):
        for c in res[name]["done"]:
            assert c.spec.accepted + c.spec.corrections == len(c.tokens), c
    pd, pd_st = res["PD"]["done"], res["PD"]["st"]
    pd_j = sum(c.carbon.energy_j for c in pd)
    assert abs(pd_j - pd_meter.energy_j) <= 1e-9 * pd_meter.energy_j, (
        pd_j, pd_meter.energy_j)
    assert pd_meter.open_energy_j() == 0.0
    long = [r for r in trace if len(r.tokens) > 32]
    assert pd_meter.prefill_calls == pd_st["admitted"] - len(long) + \
        pd_st["paged"]["chunked"]["chunks"]
    assert pd_meter.decode_steps == pd_st["decode_steps"]
    assert all(c.carbon.tokens == len(c.tokens) for c in pd)
    log(f"[paged] PD metered at {card_tdp_w(card):g} W: "
        f"{pd_meter.energy_j:.3f} J ({pd_meter.prefill_j:.3f} J over "
        f"{pd_meter.prefill_calls} prefill calls, {pd_meter.decode_j:.3f} J "
        f"over {pd_meter.decode_steps} spec steps), per-request Joules sum "
        f"to the total (rel {abs(pd_j - pd_meter.energy_j) / pd_j:.1e}); "
        f"{pd_meter.energy_j / sum(len(c.tokens) for c in pd):.4f} J/token "
        f"({card})")

    def per(total, count):
        return f"{total / count * 1e3:.2f} ms" if count else "none"

    p_st, s4_st = res["P"]["st"], res["S4"]["st"]
    log(f"[paged] ms per decode step: P "
        f"{per(p_st['decode_s'], p_st['decode_steps'])}, S4 "
        f"{per(s4_st['decode_s'], s4_st['decode_steps'])} ({card})")
    pc = res["PC"]["st"]["paged"]["chunked"]
    long = [len(r.tokens) for r in trace if len(r.tokens) > 32]
    log(f"[paged] PC: {pc['chunks']} chunks ({len(long)} first-chunk "
        f"prefills), ms per chunk step (up to 32 decode steps at m = 1) "
        f"{per(pc['chunk_step_s'], pc['chunks'] - len(long))}, per chunk-"
        f"step token {per(pc['chunk_step_s'], sum(n - 32 for n in long))} "
        f"({card})")
    for name in ("PS", "PD"):
        st = res[name]["st"]
        sp = st["spec"]
        emitted = sum(len(c.tokens) for c in res[name]["done"]) \
            - st["admitted"]
        log(f"[paged] {name}: draft {sp['draft_tier']} k {sp['k']}: "
            f"{sp['steps']} spec steps, "
            f"{per(st['decode_s'], sp['steps'])} per spec step, "
            f"{emitted / sp['steps']:.2f} tokens emitted per spec step, "
            f"acceptance {sp['acceptance_rate']:.4f} ({sp['accepted']} of "
            f"{sp['proposed']}) ({card})")

    def ttft(name):
        t = np.array([c.ttft_ticks for c in res[name]["done"]])
        return np.percentile(t, 50), np.percentile(t, 95)

    (a50, a95), (b50, b95) = ttft("S4"), ttft("PD")
    log(f"[paged] TTFT ticks p50/p95 at equal KV memory (1,024 positions): "
        f"S4 {a50:.1f}/{a95:.1f}, PD {b50:.1f}/{b95:.1f}")

    # the gather and scatter around each paged decode step, on the profiler
    rng = np.random.default_rng(7)
    prof = {}
    for name in ("S4", "P"):
        prof[name] = profile_decode(engines[name], rng, cfg,
                                    tag=f"paged-profile {name}")
    if prof["P"] is not None and prof["S4"] is not None:
        steps = 4                                # profile_decode's default

        def by_name(kernels):
            out = {}
            for e in kernels:
                us, n = out.get(e.key, (0.0, 0))
                out[e.key] = (us + e.self_device_time_total, n + e.count)
            return out

        # what the paged step launches beyond the slot step: the view's
        # gather, the row scatter and their index arithmetic
        kp, ks = by_name(prof["P"][0]), by_name(prof["S4"][0])
        extra = [(us - ks.get(k, (0.0, 0))[0], n - ks.get(k, (0.0, 0))[1], k)
                 for k, (us, n) in kp.items() if n > ks.get(k, (0.0, 0))[1]]
        for us, n, k in sorted(extra, reverse=True):
            log(f"[paged]   +{us / 1e3 / steps:8.4f} ms/step "
                f"+{n / steps:5.1f}/step {k[:90]}")
        busy = {n: sum(e.self_device_time_total for e in prof[n][0])
                / 1e3 / steps for n in prof}
        # the view: K and V of every lane's max_len positions, read once
        # from the pools and written once
        view_bytes = 2 * 2 * 4 * cfg.n_layers * 4 * 256 * cfg.n_kv_heads \
            * cfg.hd
        log(f"[paged] P's gather, scatter and index arithmetic: "
            f"{sum(e[0] for e in extra) / 1e3 / steps:.4f} ms device time "
            f"in {sum(e[1] for e in extra) / steps:.1f} extra launches per "
            f"decode step (the view's byte bound "
            f"{view_bytes / rfa.H100_SXM.hbm_bytes_per_s * 1e3:.4f} ms for "
            f"{view_bytes / 1e6:.1f} MB); device busy per step P "
            f"{busy['P']:.3f} ms, S4 "
            f"{busy['S4']:.3f} ms; wall per step P "
            f"{prof['P'][1] * 1e3:.2f} ms, S4 {prof['S4'][1] * 1e3:.2f} ms "
            f"({card})")
    del engines, params
    torch.cuda.empty_cache()
    log(f"[paged] phase {time.perf_counter() - t_phase:.1f}s")
    return res["PD"]["launches"]


def profile_decode(eng, rng, cfg, steps: int = 4,
                   tag: str = "profile") -> tuple[list, float] | None:
    """Device-busy share and the heaviest kernels over a few steady decode
    steps of a full arena (after the main path's counters were read).
    Returns (the profiler's device rows, wall seconds per step), or None
    when the trace holds no device time."""
    import torch
    from repro_torch.serving import Request, SamplingParams
    for i in range(eng.capacity):
        eng.submit(Request(f"{tag} p{i}",
                           rng.integers(0, cfg.vocab, 64).tolist(),
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
        log(f"[{tag}] no device time in the trace: busy share not measured")
        eng.run_until_complete()
        return None
    ops_ = sum(e.count for e in kernels)
    log(f"[{tag}] {steps} decode steps: wall {wall * 1e3:.2f} ms, device "
        f"busy {dev_us / 1e3:.2f} ms ({dev_us / 1e6 / wall:.1%}); idle "
        f"{1 - dev_us / 1e6 / wall:.1%}; {ops_} device ops, "
        f"{ops_ / steps:.1f} launches per decode step")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"[{tag}]   {e.self_device_time_total / 1e3 / steps:8.3f} "
            f"ms/step  {e.count // steps:5d}/step  {e.key[:70]}")
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        log(f"[{tag}]   host {e.self_cpu_time_total / 1e3 / steps:8.3f} "
            f"ms/step  {e.count // steps:5d}/step  {e.key[:60]}")
    eng.run_until_complete()
    return kernels, wall / steps


# ---------------------------------------------------------------------------
# the fleet: metered replicas, failover, chaos and the total-carbon GA
# ---------------------------------------------------------------------------

#: The fleet phase's trace (`benchmarks/bench_fleet.py`'s defaults, with
#: the serve phase's bucket): prompts of 104 tokens and 16 new ones, so
#: max_len 128 is the bucket and plane 0 and flash run at the shapes the
#: kernels phase checks; replica 0 dies at its step 5.
FLEET_PROMPT, FLEET_GEN, FLEET_MAX_LEN = 104, 16, 128
FLEET_REQUESTS, CHAOS_REQUESTS, FLEET_KILL = 12, 16, 5
FLEET_SLO = 32.0
CHAOS_SEED, CHAOS_TIERS = 7, ("exact", "trunc2x2", "trunc4x4")
#: the traces are drawn at TinyLlama's vocab on both sides, so that the
#: reduced CPU twin sees the same arrivals (its prompts taken mod 512)
TRACE_VOCAB = 32000
#: the card against the CPU on the total-carbon search
TOTAL_RTOL = 1e-6


def card_tdp_w(card: str) -> float:
    """The power limit in the `nvidia-smi` line, in watts."""
    import re
    m = re.search(r"([0-9.]+)\s*W\b", card)
    assert m, f"no power limit in {card!r}"
    return float(m.group(1))


def fleet_want(cfg, s: dict) -> dict:
    """Kernel launches of a metered slot-engine fleet on one approximate
    tier, from its meters' counts (`Replica.carbon_summary`, summed over
    replicas and restarts).  Every metered prefill is a whole-prompt
    prefill at bucket 128: 7L + 1 quantize_rows, 7L plane 0, one skinny
    (the head at m = 1) and L flash.  Every metered decode step runs 7L + 1
    quantize_rows and skinny.  A replica dies only at a step boundary, so
    every launch is metered."""
    per_step = 7 * cfg.n_layers + 1
    p, d = s["prefill_calls"], s["decode_steps"]
    return {"quantize_rows": per_step * (p + d),
            "approx_qgemm_skinny": per_step * d + p,
            "approx_qgemm_plane0": (per_step - 1) * p,
            "flash_attention": cfg.n_layers * p,
            "approx_qgemm_fused": 0, "approx_qgemm_stacked": 0}


def fleet_ticks(fleet) -> dict:
    """What the router, the replicas and the controller decided, on the
    tick clock only (no token values, no seconds): equal between the card
    at full width and the CPU at the reduced size."""
    import dataclasses
    return {"routes": [dataclasses.astuple(r) for r in fleet.routes],
            "requeue_events": fleet.requeue_events,
            "recoveries": fleet.recoveries,
            "tier_events": (fleet.controller.events if fleet.controller
                            else []),
            "completions": [(c.request_id, c.finish_reason, c.arrival,
                             c.admitted_tick, c.finished_tick, c.attempt,
                             len(c.tokens), c.tier_tokens)
                            for c in fleet.completions()],
            "wall_admitted": [r.wall_admitted for r in fleet.replicas],
            "alive": [r.alive for r in fleet.replicas], "tick": fleet.tick}


def _fleet_requests(vocab: int, n: int, deadlines: bool) -> list:
    """`poisson_requests` at TRACE_VOCAB (seed 0), prompts taken mod the
    model's `vocab`; the chaos trace carries the bench's deadlines."""
    import dataclasses
    from repro_torch.launch.fleet import poisson_requests
    out = []
    for r in poisson_requests(n, FLEET_PROMPT, FLEET_GEN, TRACE_VOCAB,
                              seed=0):
        r = dataclasses.replace(r, tokens=[t % vocab for t in r.tokens])
        if deadlines:
            r = dataclasses.replace(r, ttft_deadline_ticks=4.0 * FLEET_SLO,
                                    deadline_ticks=8.0 * FLEET_SLO)
        out.append(r)
    return out


def metered_fleet(cfg, params, dev, tdp_w: float):
    """`build_fleet` on the bench's defaults (us-west and eu-west on the
    diurnal trace, capacity 2, SLO 32 ticks, 1800 s per tick, seed 0), one
    trunc2x2 tier, 12 Poisson requests, replica 0 killed at its step 5."""
    from repro_torch.fleet.meter import DevicePowerModel
    from repro_torch.launch.fleet import build_fleet
    fleet = build_fleet(cfg, trace="diurnal", capacity=2,
                        max_len=FLEET_MAX_LEN, seed=0,
                        ttft_slo_ticks=FLEET_SLO, seconds_per_tick=1800.0,
                        params=params, tiers=(MULT,),
                        power=DevicePowerModel(tdp_w=tdp_w), device=dev)
    reqs = _fleet_requests(cfg.vocab, FLEET_REQUESTS, deadlines=False)
    for r in reqs:
        fleet.submit(r)
    fleet.replicas[0].inject_fault(at_step=FLEET_KILL)
    return fleet, reqs


def chaos_campaign(cfg, params, dev, tdp_w: float):
    """`bench_fleet.py --chaos`'s campaign: the tier ladder exact,
    trunc2x2, trunc4x4 under `DegradationConfig(patience=1)`, 16 Poisson
    requests with the bench's deadlines, `ChaosSchedule.random(7)`."""
    import dataclasses
    from repro_torch.fleet.chaos import ChaosCampaign, ChaosSchedule
    from repro_torch.fleet.meter import DevicePowerModel
    from repro_torch.fleet.router import DegradationConfig, FleetConfig
    from repro_torch.launch.fleet import build_fleet
    # the exact tier serves on the raw weights (a cfg.mult other than
    # exact would also prepare them once more, unused)
    cfg = dataclasses.replace(cfg, mult="exact")
    fleet = build_fleet(cfg, trace="diurnal", capacity=2,
                        max_len=FLEET_MAX_LEN, seed=0,
                        seconds_per_tick=1800.0, params=params,
                        tiers=CHAOS_TIERS,
                        fleet_cfg=FleetConfig(
                            ttft_slo_ticks=FLEET_SLO,
                            degradation=DegradationConfig(patience=1)),
                        power=DevicePowerModel(tdp_w=tdp_w), device=dev)
    schedule = ChaosSchedule.random(CHAOS_SEED,
                                    [r.name for r in fleet.replicas])
    reqs = _fleet_requests(cfg.vocab, CHAOS_REQUESTS, deadlines=True)
    return fleet, ChaosCampaign(fleet, reqs, schedule)


def _deaths_injected(fleet, applied: list[dict]) -> None:
    """Every failover (a replica death) answers an injected death of that
    replica at or before its tick: a kernel that failed to build or
    launch would show as a death no event explains."""
    deaths = [e for e in applied
              if e["kind"] in ("kill", "transient", "submit_fault")]
    for ev in fleet.requeue_events:
        cause = [d for d in deaths if d["replica"] == ev["replica"]
                 and d["tick"] <= ev["tick"]]
        assert cause, ("a death no fault explains", ev, applied)
    assert len(fleet.requeue_events) <= len(deaths), (
        fleet.requeue_events, deaths)


def _design_held(got: dict, want: dict) -> bool:
    """A total-carbon winner on the card against the CPU's: the same
    design, every number within TOTAL_RTOL."""
    import math
    for k, v in want.items():
        g = got[k]
        if isinstance(v, float):
            if not math.isclose(g, v, rel_tol=TOTAL_RTOL, abs_tol=1e-30):
                return False
        elif g != v:
            return False
    return set(got) == set(want)


def fleet_phase(dev, cfg, card: str) -> dict:
    """The carbon-aware fleet at full width on the card.  Returns the
    metered fleet's kernel launches."""
    import torch
    from repro_torch import configs
    from repro_torch.core import codesign as cd
    from repro_torch.fleet import chaos
    from repro_torch.fleet.total import OperationalModel
    from repro_torch.models import api
    from repro_torch.serving import Engine

    t_phase = time.perf_counter()
    tdp_w = card_tdp_w(card)
    params = api.init_params(cfg, seed=0, device=dev)
    rcfg = configs.reduced(configs.get_config("tinyllama-1.1b"), mult=MULT,
                           kernel_policy="pallas", attn_impl="flash",
                           dtype="float32")
    rparams = api.init_params(rcfg, seed=0, device="cpu")

    # 1. the metered fleet, with replica 0 killed at its step 5
    fleet, reqs = metered_fleet(cfg, params, dev, tdp_w)
    t0 = time.perf_counter()
    comps, launches = counted(fleet.run_until_complete)
    wall = time.perf_counter() - t0
    s = fleet.stats()
    twin, _ = metered_fleet(rcfg, rparams, "cpu", tdp_w)
    twin.run_until_complete()
    assert s["lost"] == [] and s["completed"] == FLEET_REQUESTS, s["lost"]
    assert chaos.check_exactly_once(
        fleet, {r.request_id: r for r in reqs}) == []
    assert chaos.check_meter_conservation(fleet, {}) == [], \
        chaos.check_meter_conservation(fleet, {})
    ticks, twin_ticks = fleet_ticks(fleet), fleet_ticks(twin)
    assert ticks == twin_ticks, "the card's fleet left its CPU tick twin"
    assert [e["replica"] for e in fleet.requeue_events] == ["us-west"]
    assert fleet.replicas[0]._steps == FLEET_KILL and not fleet.recoveries
    summed = {k: sum(r.carbon_summary()[k] for r in fleet.replicas)
              for k in ("prefill_calls", "decode_steps")}
    want = fleet_want(cfg, summed)
    assert launches == want, (launches, want)
    lone = Engine(cfg, params, capacity=2, max_len=FLEET_MAX_LEN, device=dev)
    for r in reqs:
        lone.submit(r)
    alone = {c.request_id: c.tokens for c in lone.run_until_complete()}
    assert {c.request_id: c.tokens for c in comps} == alone
    del lone
    n_routes = len(fleet.routes)
    share = {r.name: sum(rec.replica == r.name for rec in fleet.routes)
             / n_routes for r in fleet.replicas}
    log(f"[fleet] metered fleet, 2 replicas x capacity 2 ({MULT}), "
        f"{FLEET_REQUESTS} requests x {FLEET_GEN} tokens, replica us-west "
        f"killed at its step {FLEET_KILL}: {wall:.2f}s, {s['ticks']} ticks, "
        f"requeued {s['requeued']}, lost 0, exactly once; ticks equal to "
        f"the CPU twin; tokens equal to a lone slot engine; launches "
        f"{launches} = formula over {summed}")
    log("[fleet] routed share: " + ", ".join(
        f"{k} {v:.3f}" for k, v in share.items())
        + f" ({n_routes} routes, low-carbon share "
        f"{s['low_carbon_share']:.3f})")
    for r in fleet.replicas:
        c = r.carbon_summary()
        log(f"[fleet]   {r.name}: alive {r.alive}, "
            f"{c['prefill_calls']} prefills, {c['decode_steps']} decode "
            f"steps, {c['energy_j']:.3f} J ({c['prefill_j']:.3f} prefill), "
            f"{c['finalized_tokens']} tokens, {c['energy_j_per_token']:.4f} "
            f"J/token, {c['co2e_g_per_token']:.4e} gCO2e/token, abandoned "
            f"{c['abandoned_energy_j']:.3f} J; power model at "
            f"{tdp_w:g} W on {card}")
    t = s["totals"]
    log(f"[fleet] totals {t['energy_j']:.3f} J, {t['co2e_g']:.4e} gCO2e, "
        f"{t['energy_j_per_token']:.4f} J/token over {t['tokens']} tokens "
        "(the power model applied to host-timed step seconds, not a "
        "measured draw)")
    del fleet, twin, comps
    torch.cuda.empty_cache()

    # 2. the chaos campaign, held to its CPU tick twin
    fleet, campaign = chaos_campaign(cfg, params, dev, tdp_w)
    t0 = time.perf_counter()
    report, chaos_launches = counted(campaign.run)
    wall = time.perf_counter() - t0
    twin, twin_campaign = chaos_campaign(rcfg, rparams, "cpu", tdp_w)
    twin_report = twin_campaign.run()
    rep = report.to_dict()
    assert report.ok, report.violations
    assert rep == twin_report.to_dict(), (rep, twin_report.to_dict())
    assert fleet_ticks(fleet) == fleet_ticks(twin)
    _deaths_injected(fleet, report.events_applied)
    for k in ("quantize_rows", "approx_qgemm_skinny", "approx_qgemm_plane0",
              "flash_attention"):
        assert chaos_launches[k] > 0, (k, chaos_launches)
    log(f"[fleet] chaos seed {CHAOS_SEED}, tiers {','.join(CHAOS_TIERS)}: "
        f"{wall:.2f}s; {rep['faults_by_kind']}; submitted "
        f"{rep['submitted']}, completed {rep['completed']}, lost 0, "
        f"requeued {rep['requeued']}, recoveries {rep['recoveries']}, "
        f"restarts {rep['restarts']}, shed {rep['shed']}, deadline "
        f"{rep['deadline_evictions']}, TTFT p95 {rep['ttft_p95_ticks']} "
        f"ticks (SLO {rep['ttft_slo_ticks']}), tier tokens "
        f"{rep['tier_occupancy']}, {rep['degradation_events']} tier "
        f"changes; all five invariants hold; report equal to the CPU "
        f"tick twin; deaths exactly the injected ones")
    log(f"[fleet] chaos launches (trunc tiers; exact runs only flash): "
        f"{chaos_launches}")
    for r in fleet.replicas:
        c = r.carbon_summary()
        log(f"[fleet]   {r.name}: {c['energy_j_per_token']:.4f} J/token, "
            f"{c['co2e_g_per_token']:.4e} gCO2e/token, "
            f"{r.restarts} restarts ({card})")
    del fleet, twin, campaign, params
    torch.cuda.empty_cache()

    # 3. the total-carbon search on the card against the CPU
    t0 = time.perf_counter()
    op = OperationalModel()
    got = cd.run_total_carbon(cd.multi_die_scenarios(), op, device=dev)
    card_s = time.perf_counter() - t0
    want = cd.run_total_carbon(cd.multi_die_scenarios(), op, device="cpu")
    for g, w in zip(got, want, strict=True):
        assert g["scenario"] == w["scenario"] and g["op"] == w["op"]
        for key in ("cdp_winner", "total_winner"):
            assert _design_held(g[key], w[key]), (key, g[key], w[key])
        assert g["differs"] == w["differs"]
        # reduction = 1 - total / cdp_total: each total within TOTAL_RTOL
        # moves it by at most 2 x TOTAL_RTOL x (1 - reduction)
        red_diff = abs(g["total_reduction"] - w["total_reduction"])
        assert red_diff <= 2 * TOTAL_RTOL * (1 - w["total_reduction"]) \
            + 1e-12, (g["total_reduction"], w["total_reduction"])
        tw = g["total_winner"]
        log(f"[fleet] total carbon {g['scenario']['workload']} "
            f"{g['scenario']['node_nm']}nm {g['scenario']['fps_min']:g} fps: "
            f"CDP winner {g['cdp_winner']['multiplier']} x "
            f"{g['cdp_winner']['n_dies']} dies, total winner "
            f"{tw['multiplier']} x {tw['n_dies']} dies "
            f"({tw['num_pes']} PEs, {tw['total_g_per_inf']:.4e} g/inf); "
            f"total -{100 * g['total_reduction']:.3f}% (card vs CPU "
            f"{red_diff:.1e}); winners equal to the CPU's")
    log(f"[fleet] run_total_carbon on the card {card_s:.2f}s; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# the recurrent families: Mamba-2 and RecurrentGemma served at full width
# ---------------------------------------------------------------------------

#: The recurrent phase's models, in order.  recurrentgemma-9b runs no PD:
#: its trunc4x4 draft tier would prepare a second 17 GB int8 copy.
RECURRENT_ARCHS = ("mamba2-370m", "recurrentgemma-9b")
#: Their depths in the recurrent phase.  mamba2's is cut from 48 layers:
#: at full depth the phase took 268-430 s of the script's 1200 s, at 8
#: layers mamba2 alone 39-44 s.  The 9B
#: keeps its 38: at 14, its trunc2x2 top-1 margins fall below what the
#: chunked prefill's flipped int8 codes move, and its PC parts from S4
#: (PERF.md).
RECURRENT_DEPTH = {"mamba2-370m": 4, "recurrentgemma-9b": 38}
#: The conditioned phase's models, in the order it serves them (the
#: largest last).
CONDITIONED_ARCHS = ("whisper-medium", "starcoder2-7b",
                     "llama-3.2-vision-11b")
#: Their cuts in the conditioned phase, to keep the script inside its
#: time limit with the MoE phases: llama-3.2-vision-11b at 1 of its 8
#: superblocks (5 self and 1 cross layer; at 8 it took 172-205 s, at 4
#: 99-156 s), whisper-medium at 4 + 4 of its 24 + 24 layers (at full
#: depth 127-139 s, at 6 + 6 63 s, most of it the chunked runs C4 and
#: PC), starcoder2-7b at 8 of its 32 layers (14-22 s at 32).
CONDITIONED_CUT = {"llama-3.2-vision-11b": dict(n_layers=5),
                   "whisper-medium": dict(n_layers=4, n_enc_layers=4),
                   "starcoder2-7b": dict(n_layers=8)}
#: The MoE phase's models, in order, and their cuts: full width, grok-1
#: at 2 of its 64 layers (every layer MoE, 8 experts, top-2),
#: llama4-maverick at 1 of its 24 superblocks (a dense and an MoE layer,
#: the shared expert) with 32 of its 128 experts (top-1): at 128 one MoE
#: layer's experts hold 64.4 GB in f32, about 97 GB once prepared, more
#: than the card.  The expert cut moves llama4's expert capacity in a
#: bucket-128 prefill from 1 to 5; at decode it stays 1.
MOE_ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
MOE_CUT = {"grok-1-314b": dict(n_layers=2),
           "llama4-maverick-400b-a17b": dict(n_layers=2, n_experts=32)}
#: The moe-check phase's cuts: one MoE layer of each kind.
MOE_CHECK_CUT = {"grok-1-314b": dict(n_layers=1),
                 "llama4-maverick-400b-a17b": dict(n_layers=2,
                                                   n_experts=32)}


def model_gemm_shapes(archs) -> tuple[list, list]:
    """The models' approximate GEMMs at full width, as (k, n): the
    layers' and the LM heads' (a head tied to the embedding, Whisper's,
    as (d, vocab)), read off each family's PREPARED_GEMM_WEIGHTS leaves
    initialised on the meta device."""
    import torch
    from repro_torch import configs
    from repro_torch.models import api

    layers, heads = set(), set()

    def walk(mod, name, leaf):
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                walk(mod, k, v)
        elif name in mod.PREPARED_GEMM_WEIGHTS:
            (heads if name == "lm_head" else layers).add(
                tuple(leaf.shape[-2:]))

    for arch in archs:
        cfg = configs.get_config(arch, mult=MULT, dtype="float32")
        mod = api.family_module(cfg)
        walk(mod, "", mod.init_params(cfg, torch.Generator(),
                                      torch.device("meta")))
        if cfg.tie_embeddings:
            heads.add((cfg.d_model, cfg.vocab))
    return sorted(layers), sorted(heads)


def chunked_slot_engine():
    """A slot `Engine` class whose admissions prefill as the paged
    engine's chunked prefill does (`prefill_chunk` tokens through
    `api.prefill`, the rest through `api.chunk_step` in unpadded pieces of
    `prefill_chunk`, the first token drawn from the last piece's logits):
    the slot twin of mamba2's runs PC and PD.  The chunked computation is
    the model's own, and under trunc2x2 mamba2's parts from its
    whole-prompt prefill by more than its random weights' top-1 / top-2
    margins, so its PC and PD are held to this twin, which differs from
    them by nothing but the paged machinery; `prefill_gap` holds the
    chunked path itself to the whole prefill under exact products."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.serving import Engine

    class ChunkedSlotEngine(Engine):
        def __init__(self, *args, prefill_chunk: int = 32, **kw):
            self.prefill_chunk = prefill_chunk
            super().__init__(*args, **kw)

        def _prefill_request(self, request, extras):
            c, n = self.prefill_chunk, len(request.tokens)
            if n <= c:
                return super()._prefill_request(request, extras)
            toks = np.asarray(request.tokens, np.int64)[None]

            def piece(a):
                return torch.from_numpy(toks[:, a:a + c]).to(self.device)

            _, cache = api.prefill(
                self.exec_params, piece(0), self.cfg, self._spec,
                max_len=self.max_len, extras=extras,
                true_len=torch.tensor([c], dtype=torch.int32,
                                      device=self.device))
            for pos in range(c, n, c):
                logits, cache = api.chunk_step(self.exec_params, cache,
                                               piece(pos), self.cfg,
                                               self._spec, extras)
            return logits[:, -1], cache

    return ChunkedSlotEngine


#: Whole vs chunked prefill under exact products: the largest logit gap
#: allowed (measured 1.5e-5 for mamba2, 7.5e-5 for the 9B, on logits of
#: about 4 and 9).
EXACT_PREFILL_GAP = 1e-3


def prefill_gap(dev, cfg, params, trace, count: int = 3,
                tag: str = "recurrent") -> None:
    """Whole-prompt prefill (bucket 128) against the chunked one (32
    tokens, then chunk_step) on the `count` shortest chunked prompts, each
    with its own extras, under the serving multiplier and under exact: the
    largest logit gap, the whole prefill's top-1 / top-2 margin, and
    whether the greedy tokens agree.  Under exact the gap must be within
    EXACT_PREFILL_GAP and the greedy tokens equal: the chunked path on the
    card is held to the whole prefill where no int8 code can flip.  An MoE
    model's capacity depends on the tokens a call routes (128 against 32
    and 1), so its gaps are reported, and the exact gap is held on its
    `moe.no_drop` copy, where capacity drops nothing."""
    import torch
    from repro_torch.models import api, moe
    from repro_torch.serving.engine import prefill_extras

    prompts = sorted((r for r in trace if len(r.tokens) > 32),
                     key=lambda r: len(r.tokens))[:count]
    held = []
    # (config, multiplier, whether its exact gap is held)
    cases = [(cfg, cfg.mult, False), (cfg, "exact", not cfg.is_moe)]
    if cfg.is_moe:
        cases.append((moe.no_drop(cfg), "exact", True))
    for c, mult, hold in cases:
        spec = api.make_spec(c, mult=mult, device=dev)
        p = api.prepare_params(params, c, spec) if spec else params
        parts = []
        for r in prompts:
            n = len(r.tokens)
            ex = prefill_extras(cfg, r.extras, dev)
            toks = torch.zeros((1, 128), dtype=torch.long, device=dev)
            toks[0, :n] = torch.tensor(r.tokens, device=dev)
            whole, _ = api.prefill(p, toks, c, spec, max_len=256,
                                   extras=ex, true_len=torch.tensor(
                                       [n], dtype=torch.int32, device=dev))
            _, cache = api.prefill(p, toks[:, :32], c, spec, max_len=256,
                                   extras=ex, true_len=torch.tensor(
                                       [32], dtype=torch.int32, device=dev))
            chunked, _ = api.chunk_step(p, cache, toks[:, 32:n], c, spec,
                                        ex)
            top = torch.topk(whole[0], 2).values
            gap = (whole - chunked[:, -1]).abs().max().item()
            argmax = bool(whole.argmax() == chunked[0, -1].argmax())
            parts.append(
                f"{r.request_id} (n {n}) gap {gap:.3e}, "
                f"margin {(top[0] - top[1]).item():.3e}, argmax "
                f"{'equal' if argmax else 'differs'}")
            if hold:
                held.append((r.request_id, gap, argmax))
        what = (f", capacity_factor {c.capacity_factor:g}"
                if c.is_moe else "")
        log(f"[{tag}] {cfg.name} whole vs chunked prefill, {mult}{what}: "
            + "; ".join(parts))
        del p
    assert all(g <= EXACT_PREFILL_GAP and a for _, g, a in held), \
        (cfg.name, held, EXACT_PREFILL_GAP)


def drop_witness(cfg, routing: list, tag: str, who: str) -> None:
    """The token slots each `moe_ffn` call of a run dropped, by the number
    of tokens t the call routed (a bucket-128 prefill, a decode step at
    b = capacity, ...), beside the call's expert capacity; `who` names
    the config in the log."""
    import numpy as np
    by_t = {}
    for r in routing:
        by_t.setdefault((r.expert_idx.shape[0], r.capacity), []).append(
            int(r.dropped))
    log(f"[{tag}] {who} tokens dropped per call (of t x top_k token "
        f"slots): " + "; ".join(
            f"t {t}, capacity {cap}: {len(d)} calls, min / mean / max "
            f"{min(d)} / {np.mean(d):.2f} / {max(d)} of {t * cfg.top_k}"
            for (t, cap), d in sorted(by_t.items())))


def _gb(nbytes: float) -> str:
    return f"{nbytes / 1e9:.3f} GB"


def _prepared_bytes(tree) -> int:
    """Bytes of the int8 copies (`wq`, `wq_t`) in a prepared param tree."""
    from repro_torch.approx import gemm as G
    if isinstance(tree, dict):
        return sum(_prepared_bytes(v) for v in tree.values())
    if not G.is_prepared(tree):
        return 0
    return tree.wq.numel() + (tree.wq_t.numel() if tree.wq_t is not None
                              else 0)


def model_serving(dev, cfg, card: str, names: list[str],
                  tag: str = "recurrent") -> dict:
    """One model at full width and depth through the slot and paged
    engines on `paged_trace`'s ten requests (with their conditioning,
    where the model takes any), the runs of `names` held as
    `serve_and_hold` says.  Where PC runs, the chunked prefill is held to
    the whole one under exact (`prefill_gap`).  An MoE model's rows share
    their call's expert capacity, so its PS and PC are reported there,
    and S4, PS and PC run again on its `moe.no_drop` copy, from the same
    prepared params, where no row takes another's capacity: PS (every
    draft accepted) and PC held to S4 (a C4 twin there equalled S4 on
    every request of both MoE models, PERF.md).  A cross-attention model's
    gates are set to 1.0 after init (they start at 0, which multiplies the
    image path away).  Unless PD runs, the params are prepared once and
    every engine shares the prepared tree (PD's trunc4x4 needs the raw
    weights).  Returns the kernels' launches summed over the runs."""
    import gc

    import numpy as np
    import torch
    from repro_torch.models import api, moe

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, seed=0, device=dev)
    if cfg.cross_every:
        params["cross"]["xgate"].fill_(1.0)
    n_params = api.param_count(params)
    with_pd = "PD" in names
    if not with_pd:
        params = api.prepare_params(params, cfg)
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name}: {n_params / 1e9:.3f}B params f32, "
        f"{cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}; "
        + ("prepared once, " + _gb(_prepared_bytes(params)) + " int8 "
           "(wq + wq_t) shared by every engine; " if not with_pd else "")
        + f"ready in {time.perf_counter() - t0:.1f}s; device memory after "
        f"prepare {_gb(torch.cuda.memory_allocated())}, peak "
        f"{_gb(torch.cuda.max_memory_allocated())} ({card})")
    trace = paged_trace(cfg)
    if "PC" in names:
        prefill_gap(dev, cfg, params, trace, tag=tag)
    res, total, s4 = serve_and_hold(dev, cfg, params, names, trace, tag,
                                    drops=cfg.is_moe)
    if cfg.is_moe:
        _, more, twin = serve_and_hold(
            dev, moe.no_drop(cfg), params,
            [n for n in names if n in ("S4", "PS", "PC")], trace,
            tag, drops=False)
        del twin
        total = {k: total[k] + more[k] for k in total}

    def per(total_s, count):
        return f"{total_s / count * 1e3:.2f} ms" if count else "none"

    s4_st = res["S4"]["st"]
    line = (f"[{tag}] {cfg.name} ms per prefill (bucket 128) "
            f"{per(s4_st['prefill_s'], s4_st['admitted'])}, per decode "
            f"step (S4) {per(s4_st['decode_s'], s4_st['decode_steps'])}")
    if "PC" in res:
        pc = res["PC"]["st"]["paged"]["chunked"]
        long = [len(r.tokens) for r in trace if len(r.tokens) > 32]
        line += (f", per chunk step (PC, up to 32 decode steps at m = 1) "
                 f"{per(pc['chunk_step_s'], pc['chunks'] - len(long))}")
    if "PS" in res:
        ps = res["PS"]["st"]["spec"]
        line += (f", per spec step (PS, 8 decode steps) "
                 f"{per(res['PS']['st']['decode_s'], ps['steps'])}")
    prof = profile_decode(s4, np.random.default_rng(7), cfg, steps=1,
                          tag=f"{tag}-profile {cfg.name}")
    busy = "not measured" if prof is None else (
        f"{sum(e.self_device_time_total for e in prof[0]) / 1e3:.3f} ms "
        f"device of {prof[1] * 1e3:.2f} ms wall, "
        f"{sum(e.self_device_time_total for e in prof[0]) / 1e6 / prof[1]:.1%}"
        " busy")
    log(line + f"; one profiled decode step: {busy}; peak device memory "
        f"{_gb(torch.cuda.max_memory_allocated())}; "
        f"{time.perf_counter() - t0:.1f}s ({card})")
    del s4, params, res
    gc.collect()
    torch.cuda.empty_cache()
    return total


def serve_and_hold(dev, cfg, params, names: list[str], trace, tag: str,
                   drops: bool = False) -> tuple[dict, dict, object]:
    """The runs of `names` on `trace`, one engine at a time, from
    `params`: S4, P, PS and PC, each held to S4; where C4 runs, PC is held
    instead to it, the slot engine admitting through the same chunked
    prefill (`chunked_slot_engine`), and PD to C8.  Each run's tokens in
    the vocabulary and as many as asked, every paged run's audit clean
    with no live page and a prefix hit, every run's launches equal to
    `paged_want`'s formula, PS accepting every draft; C4's agreement with
    S4 reported.  With `drops` (an MoE config whose capacity drops
    tokens), PS against S4, PS's acceptance and PC against C4 are
    reported instead: their decode calls put other rows beside a token,
    and the rows of a call share its capacity.  An MoE config's S4 logs
    the tokens each call dropped, which must be none without `drops`.
    Returns ({run: tokens, stats, completions}, launches summed over the
    runs, the S4 engine)."""
    import contextlib
    import gc

    import torch
    from repro_torch.models import moe
    from repro_torch.serving import PagedEngine

    who = cfg.name + (f" (capacity_factor {cfg.capacity_factor:g})"
                      if cfg.is_moe else "")
    common = dict(max_len=256, prefill_buckets=(128,), device=dev)
    runs = paged_runs("PD" in names)
    twin = chunked_slot_engine()
    runs["C4"] = (twin, dict(capacity=4, prefill_chunk=32))
    runs["C8"] = (twin, dict(capacity=8, prefill_chunk=32))
    paged_leaves = [] if cfg.family in ("ssm", "hybrid") else ["k", "v"]
    res, total, s4 = {}, dict.fromkeys(counters(), 0), None
    for name in names:
        cls, kw = runs[name]
        eng = cls(cfg, params, **common, **kw)
        for req in trace:
            eng.submit(req)
        t_run = time.perf_counter()
        with (moe.recording() if cfg.is_moe and name == "S4"
              else contextlib.nullcontext()) as routing:
            done, launches = counted(eng.run_until_complete)
        wall = time.perf_counter() - t_run
        if routing is not None:
            drop_witness(cfg, routing, tag, who)
            assert drops or not any(int(r.dropped) for r in routing), who
        st = eng.stats()
        assert len(done) == len(trace), [c.request_id for c in done]
        for c in done:
            assert c.finish_reason == "length" and \
                len(c.tokens) == PAGED_NEW, c
            assert all(0 <= t < cfg.vocab for t in c.tokens), c.tokens
        want = run_want(cfg, name, kw, st, trace)
        assert launches == want, (who, name, launches, want)
        line = (f"[{tag}] {who} {name}: {wall:.2f}s, "
                f"{st['decode_steps']} decode steps, prefill "
                f"{st['prefill_s']:.3f}s")
        if cls is PagedEngine:
            pg = st["paged"]
            eng._alloc.audit()
            assert pg["pages_live"] == 0 and pg["alloc_failures"] == 0, pg
            assert pg["paged_leaves"] == paged_leaves, pg
            # h1 shares h0's 64-token prefix, conditioning included
            assert pg["prefix_hits"] >= bool(paged_leaves), pg
            line += (f"; prefix hits {pg['prefix_hits']}, chunks "
                     f"{pg['chunked']['chunks']}")
        log(line + f"; launches {launches} (= the formula)")
        res[name] = dict(toks={c.request_id: c.tokens for c in done},
                         st=st, done=done)
        for k in total:
            total[k] += launches[k]
        if name == "S4":
            s4 = eng
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    pairs = (("P", "S4"), ("PS", "S4"),
             ("PC", "C4" if "C4" in res else "S4"), ("PD", "C8"))
    coupled = ("PS", "PC") if drops else ()
    diverged, parted = [], {}
    for name, base in pairs:
        if name not in res:
            continue
        for rid, toks in res[name]["toks"].items():
            want = res[base]["toks"][rid]
            if toks != want:
                at = next(i for i, (a, b) in enumerate(zip(toks, want))
                          if a != b)
                if name in coupled:
                    parted.setdefault(name, []).append(f"{rid} {at}")
                    continue
                diverged.append((name, rid, at))
                log(f"[{tag}] {who} {name} {rid} diverges from "
                    f"{base} at token {at}: {toks} vs {want}")
    assert not diverged, (who, diverged)
    for name, base in pairs:
        if name in coupled and name in res:
            log(f"[{tag}] {who} {name} against {base} (reported: the "
                f"rows of a call share its capacity): "
                f"{len(trace) - len(parted.get(name, []))} of {len(trace)} "
                f"requests equal; first differing token "
                + (", ".join(parted[name]) if name in parted else "none"))
    if "C4" in res:
        # the chunked prefill against the whole one under trunc2x2:
        # reported, not held (the model's own arithmetic parts them)
        agree = []
        for rid, toks in sorted(res["C4"]["toks"].items()):
            same = [a == b for a, b in zip(toks, res["S4"]["toks"][rid])]
            agree.append(f"{rid} {(same + [False]).index(False)}")
        log(f"[{tag}] {who} C4 (chunked prefill) against S4 "
            f"(whole prefill), tokens equal before the first difference: "
            + ", ".join(agree))
    if "PS" in res:
        # drafting with the serving tier itself accepts every draft, but
        # where capacity drops tokens: a verify step feeds a frozen lane
        # other tokens than the draft step did, and that row takes
        # capacity
        ps = res["PS"]["st"]["spec"]
        if "PS" in coupled:
            log(f"[{tag}] {who} PS acceptance (reported) "
                f"{ps['accepted']} of {ps['proposed']} drafts, "
                f"{ps['acceptance_rate']:.4f}")
        else:
            assert ps["acceptance_rate"] == 1.0, (who, ps)
    for name in ("PS", "PD"):
        for c in res.get(name, {}).get("done", []):
            assert c.spec.accepted + c.spec.corrections == len(c.tokens), c
    held = ", ".join(f"{n} to {b}" for n, b in pairs
                     if n in res and n not in coupled)
    log(f"[{tag}] {who}: {held}, token-identical on all {len(trace)} "
        f"requests; distinct tokens per request in S4: "
        f"{ {r: len(set(t)) for r, t in sorted(res['S4']['toks'].items())} }")
    return res, total, s4


def recurrent_phase(dev, card: str) -> dict:
    """The recurrent families on the card, after the TinyLlama phases'
    tensors are freed.  Returns {arch: launches per kernel}."""
    import gc

    import torch
    from repro_torch import configs

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[recurrent] device memory held before the phase: "
        f"{_gb(torch.cuda.memory_allocated())}")
    out = {}
    for arch in RECURRENT_ARCHS:
        cfg = configs.get_config(arch, mult=MULT, kernel_policy="pallas",
                                 dtype="float32",
                                 n_layers=RECURRENT_DEPTH[arch])
        # mamba2's chunked prefill parts from its whole one under
        # trunc2x2 (PERF.md): its PC and PD are held to C4 / C8
        names = (["S4", "P", "PS", "C4", "PC", "C8", "PD"]
                 if arch == "mamba2-370m" else ["S4", "P", "PS", "PC"])
        out[arch] = model_serving(dev, cfg, card, names)
    log(f"[recurrent] phase {time.perf_counter() - t_phase:.1f}s")
    return out


def kernels_vs_plain(dev, cfg, params, tokens, true_len, tag: str,
                     extras: dict | None = None,
                     max_len: int | None = None) -> dict:
    """`cfg` served from `params` once through the kernels and once
    through the plain versions on the card: a prefill of `tokens` (rows
    of `true_len` tokens, with `extras`), then 8 greedy decode steps on
    the kernel run's tokens.  Logits equal at every step (the kernels are
    bit-exact with their plain versions, and both runs take the same
    attention), greedy tokens equal, an MoE model's routing (every call's
    expert indices and drop mask) equal, the kernel run's prefill
    launches equal to `step_launches`, the plain run's none.  Returns
    {policy: (cfg, spec, prepared params, prefill logits)}."""
    import dataclasses

    import torch
    from repro_torch.models import api, moe

    b, s = tokens.shape
    runs, first, routing = {}, {}, {}
    for policy in ("pallas", "xla"):
        c = dataclasses.replace(cfg, kernel_policy=policy)
        spec = api.make_spec(c, device=dev)
        p = api.prepare_params(params, c, spec)
        with moe.recording() as routing[policy]:
            (logits, cache), n = counted(lambda: api.prefill(
                p, tokens, c, spec, max_len=max_len, extras=extras,
                true_len=true_len))
        want = (step_launches(cfg, b, s, True) if policy == "pallas"
                else dict.fromkeys(n, 0))
        assert n == want, (cfg.name, policy, n, want)
        runs[policy] = [c, spec, p, cache, logits]
        first[policy] = (c, spec, p, logits)
    diffs, match = [], []
    for step in range(9):
        lp, lx = runs["pallas"][4], runs["xla"][4]
        if step:
            lp, lx = lp[:, -1], lx[:, -1]
        assert torch.isfinite(lp).all() and lp.shape == (b, cfg.vocab)
        diffs.append((lp - lx).abs().max().item())
        tok = lp.argmax(-1)
        match.append((tok == lx.argmax(-1)).float().mean().item())
        if step == 8:
            break
        for policy, run in runs.items():
            c, spec, p, cache, _ = run
            with moe.recording() as log_:
                run[4], run[3] = api.decode_step(p, cache, tok[:, None], c,
                                                 spec, extras)
            routing[policy] += log_
    routed = ""
    if cfg.is_moe:
        rk, rx = routing["pallas"], routing["xla"]
        assert len(rk) == len(rx) == 9 * (cfg.n_layers // cfg.moe_every), \
            (len(rk), len(rx))
        for i, (a, b_) in enumerate(zip(rk, rx)):
            assert torch.equal(a.expert_idx, b_.expert_idx) and \
                torch.equal(a.keep, b_.keep), (cfg.name, "routing", i)
        routed = (f"; routing equal in all {len(rk)} MoE calls (dropped "
                  f"token slots per call "
                  f"{[int(r.dropped) for r in rk]})")
    log(f"[{tag}] {cfg.name}, {cfg.n_layers} layers, full width, prompts "
        f"{true_len.tolist()}, kernels vs plain on the card: prefill "
        f"logits max|diff| {diffs[0]:.3e}, decode steps 1-8 max|diff| "
        f"{max(diffs[1:]):.3e} (limit 0; |logits| <= "
        f"{lx.abs().max().item():.3f}), greedy token match "
        f"{sum(match) / len(match):.3f}" + routed)
    assert max(diffs) == 0.0, diffs
    assert all(m == 1.0 for m in match), match
    return first


def recurrent_check_phase(dev) -> None:
    """Both recurrent models at full width and reduced depth through
    `kernels_vs_plain`: mamba2 at 2 layers on 512-token prompts (the SSD
    crosses two 256-token chunks), the hybrid at 4 layers (a superblock
    and a tail block) with the window cut to 64 under 128-token prompts,
    so the rings wrap."""
    import gc

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import api

    cases = (("mamba2-370m", dict(n_layers=2), 512, [512, 300, 257, 100]),
             ("recurrentgemma-9b", dict(n_layers=4, window=64), 128,
              [128, 77, 40, 101]))
    for arch, over, s, lens in cases:
        cfg = configs.get_config(arch, mult=MULT, dtype="float32", **over)
        params = api.init_params(cfg, seed=1, device=dev)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, s))).to(dev)
        true_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        kernels_vs_plain(dev, cfg, params, tokens, true_len,
                         "recurrent-check")
        del params
        gc.collect()
        torch.cuda.empty_cache()


def conditioned_phase(dev, card: str) -> dict:
    """The conditioned families on the card, after the recurrent phases'
    tensors are freed, one model at a time: whisper-medium (cut to 4 + 4
    layers, 1500 frames), starcoder2-7b (cut to 8 layers, the GELU MLP)
    and llama-3.2-vision-11b (cut to 5 + 1 cross layers, 1600 image tokens,
    every gate set to 1.0), full width, trunc2x2, flash, f32, through
    `model_serving` on `paged_trace` with its conditioning: S4, P, PS, C4 and PC, P and
    PS held to S4, PC to C4 (under trunc2x2 the chunked prefill parts from
    the whole one by int8 codes that flip, and on these random weights
    the flips move greedy and sampled streams, as mamba2's do: C4's
    agreement with S4 is reported, and the chunked prefill is held to the
    whole one under exact); StarCoder2 S4 and P (its path differs from
    TinyLlama's only in the MLP and the widths).  Returns {arch: launches
    per kernel}."""
    import gc

    import torch
    from repro_torch import configs

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[conditioned] device memory held before the phase: "
        f"{_gb(torch.cuda.memory_allocated())}")
    out = {}
    for arch in CONDITIONED_ARCHS:
        cfg = configs.get_config(arch, mult=MULT, kernel_policy="pallas",
                                 attn_impl="flash", dtype="float32",
                                 **CONDITIONED_CUT.get(arch, {}))
        names = (["S4", "P"] if arch == "starcoder2-7b"
                 else ["S4", "P", "PS", "C4", "PC"])
        out[arch] = model_serving(dev, cfg, card, names, tag="conditioned")
    log(f"[conditioned] phase {time.perf_counter() - t_phase:.1f}s")
    return out


def conditioned_check_phase(dev) -> None:
    """Whisper (2 + 2 layers) and the vision model (2 layers in one
    superblock, its gate at 1.0) at full width through `kernels_vs_plain`,
    four prompts of 128, 77, 40 and 101 tokens, each with its own seeded
    frames or image.  Both runs take the plain chunked attention, as
    `check_phase` does under pareto:0.01: flash's f32 rounding moves int8
    codes, which trunc2x2 carries to the logits (0.21 at Whisper's 2
    layers on the card, 0.18 between flash's plain version and the
    chunked forward on the CPU), so only the GEMM and quantize kernels
    differ; `attention_witness` measures flash against chunked and holds
    the GEMM kernels to the plain path on flash's own outputs.  Then the
    whole prefill held to the chunked one under exact (`prefill_gap`), on
    `paged_trace`'s prompts."""
    import gc

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import api

    t_phase = time.perf_counter()
    cases = (("whisper-medium", dict(n_layers=2, n_enc_layers=2)),
             ("llama-3.2-vision-11b", dict(n_layers=2, cross_every=2)))
    for arch, over in cases:
        cfg = configs.get_config(arch, mult=MULT, dtype="float32",
                                 attn_impl="chunked", **over)
        params = api.init_params(cfg, seed=1, device=dev)
        if cfg.cross_every:
            params["cross"]["xgate"].fill_(1.0)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 128))).to(
            dev)
        true_len = torch.tensor([128, 77, 40, 101], dtype=torch.int32,
                                device=dev)
        ex = {k: torch.from_numpy(v).to(dev)
              for k, v in seeded_extras(cfg, 4, 1).items()}
        runs = kernels_vs_plain(dev, cfg, params, tokens, true_len,
                                "conditioned-check", extras=ex, max_len=160)
        attention_witness(runs, tokens, true_len, ex)
        del runs
        prefill_gap(dev, cfg, params, paged_trace(cfg),
                    tag="conditioned-check")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[conditioned-check] {time.perf_counter() - t_phase:.1f}s")


def moe_phase(dev, card: str) -> dict:
    """The MoE family on the card, after the conditioned phases' tensors
    are freed, one model at a time (`MOE_ARCHS`, cut as `MOE_CUT` says):
    grok-1 (2 layers, 8 experts, top-2) and llama4-maverick (a dense and
    an MoE layer with its shared expert, 32 experts, top-1) at full
    width, trunc2x2, flash, f32, random weights from a seeded CUDA
    generator, prepared once (the expert stacks per expert matrix) and
    shared, through `model_serving` on `paged_trace`: S4, P, PS, C4 and
    PC.  P is held to S4 (a prefix hit reuses K/V that a prefill of the
    same bucket computed, and every idle lane is quiet); PS against S4
    and PC against C4 are reported, as C4 against S4 is: their decode
    calls put other rows beside a token, and the rows of a call share
    its expert capacity.  On the `moe.no_drop` copy, from the same
    prepared weights, S4, PS and PC run again, PS and PC held to S4; the
    exact whole-vs-chunked gap is held there too.  Returns
    {arch: launches per kernel}."""
    import gc

    import torch
    from repro_torch import configs

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] device memory held before the phase: "
        f"{_gb(torch.cuda.memory_allocated())}")
    out = {}
    for arch in MOE_ARCHS:
        cfg = configs.get_config(arch, mult=MULT, kernel_policy="pallas",
                                 attn_impl="flash", dtype="float32",
                                 **MOE_CUT[arch])
        out[arch] = model_serving(dev, cfg, card,
                                  ["S4", "P", "PS", "C4", "PC"], tag="moe")
    log(f"[moe] phase {time.perf_counter() - t_phase:.1f}s")
    return out


def moe_check_phase(dev) -> None:
    """grok-1 at 1 layer and llama4-maverick at 1 superblock (32
    experts), full width, through `kernels_vs_plain` on four prompts of
    128, 77, 40 and 101 tokens, both runs on the chunked attention (as
    `conditioned_check_phase`: flash's rounding would move int8 codes):
    the logit gap must be 0, the greedy tokens and every call's routing
    (expert indices, drop mask) equal, the plain run launching
    nothing."""
    import gc

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import api

    t_phase = time.perf_counter()
    for arch in MOE_ARCHS:
        cfg = configs.get_config(arch, mult=MULT, dtype="float32",
                                 attn_impl="chunked", **MOE_CHECK_CUT[arch])
        params = api.init_params(cfg, seed=1, device=dev)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 128))).to(
            dev)
        true_len = torch.tensor([128, 77, 40, 101], dtype=torch.int32,
                                device=dev)
        runs = kernels_vs_plain(dev, cfg, params, tokens, true_len,
                                "moe-check", max_len=160)
        del runs, params
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[moe-check] {time.perf_counter() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

#: The train phase: full-width TinyLlama, 6 AdamW steps at batch 8 x seq
#: 128 through `launch.train.train`, then 2 CLI steps at the config's bf16.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 128
#: The train-check phase's model depth and batch (4 x 128 = 512 rows).
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH = 2, 4
def train_want(cfg, steps: int) -> dict:
    """Kernel launches of `steps` train steps of a dense lm under a trunc
    multiplier at M = batch x seq > 32 rows: each approximate GEMM runs
    plane 0 once and, on f32 activations, `quantize_rows` once (bf16
    activations keep the plain quantizer); the forward runs 7 GEMMs per
    layer and the head, and remat's backward reruns each layer's 7:
    (7 L + 1) + 7 L [remat] per step, 309 for L = 22."""
    per = (7 * cfg.n_layers + 1 + 7 * cfg.n_layers * cfg.remat) * steps
    want = dict.fromkeys(counters(), 0)
    want["approx_qgemm_plane0"] = per
    want["quantize_rows"] = per if cfg.dtype == "float32" else 0
    return want


def _finite(values) -> bool:
    import math
    return all(math.isfinite(v) for v in values)


def step_breakdown(fn) -> tuple[float, dict, list, tuple] | None:
    """One profiled call of `fn` (after a warm-up call): its device ms,
    summed by kind (the int8 plane-0 GEMMs, `quantize_rows`, other GEMMs
    - cuBLAS's f32 products of the straight-through backward and the
    attention's -, everything else), the 6 costliest device rows as
    (name, ms, calls), and (device ms, regions) of the kernels launched
    under `gemm.WEIGHT_PREP` (the forward's per-call weight quantize and
    K-major copy, remat's recompute included, two regions per GEMM;
    counted in the kinds too); None when the trace holds no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.approx import gemm
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_events(prof.key_averages())
    kinds = dict.fromkeys(("plane0", "quantize_rows", "other GEMMs",
                           "the rest"), 0.0)
    for e in rows:
        name = e.key.lower()
        kind = ("plane0" if "plane0" in name else
                "quantize_rows" if "quantize" in name else
                "other GEMMs" if "gemm" in name or "xmma" in name else
                "the rest")
        kinds[kind] += e.self_device_time_total / 1e3
    total = sum(kinds.values())
    if total <= 0:
        return None
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    prep = [e for e in prof.key_averages() if e.key == gemm.WEIGHT_PREP
            and e.device_type == DeviceType.CPU]
    return total, kinds, [(e.key[:70], e.self_device_time_total / 1e3,
                           e.count) for e in top], (
        sum(e.device_time_total for e in prep) / 1e3,
        sum(e.count for e in prep))


def train_phase(dev, card: str) -> dict:
    """Full-width TinyLlama-1.1B (22 layers, d 2048, vocab 32000) trained
    on the card: f32, trunc2x2, the kernels (`pallas`), chunked attention
    (flash has no backward), remat as the config has it.  6 AdamW steps
    (f32 moments) at batch 8 x seq 128 through `launch.train.train`, the
    launch counters read around the run and around one more step (each
    equal to `train_want`), losses and gradient norms finite, s/step,
    peak memory, one profiled step's device busy share and the forward's
    per-call weight prep (read from that step's trace); then the CLI
    (`launch.train.main`) for 2 steps at the config's bf16.  Returns the
    6-step run's launches."""
    import contextlib
    import io
    import re

    import torch
    from repro_torch import configs
    from repro_torch.approx import gemm
    from repro_torch.data import synthetic
    from repro_torch.launch import train as launch
    from repro_torch.train import train_step as ts

    t_phase = time.perf_counter()
    cfg = configs.get_config("tinyllama-1.1b", mult=MULT,
                             kernel_policy="pallas", attn_impl="chunked",
                             dtype="float32")
    assert cfg.remat and cfg.n_layers == 22
    # the CLI's options for a 6-step run
    options = ts.StepOptions(lr=3e-4, total_steps=TRAIN_STEPS,
                             warmup_steps=max(10, TRAIN_STEPS // 20))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run, launches = counted(lambda: launch.train(
        cfg, options, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        device=dev, log_every=1))
    want = train_want(cfg, TRAIN_STEPS)
    assert launches == want, (launches, want)
    assert _finite(run["losses"]) and _finite(run["gnorms"]), run
    peak = torch.cuda.max_memory_allocated()
    step_s = run["step_s"]
    log(f"[train] {cfg.name}: {cfg.param_count():,} params, f32, "
        f"{TRAIN_STEPS} AdamW steps at {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
        f"{[round(x, 4) for x in run['losses']]}, gnorms "
        f"{[round(x, 3) for x in run['gnorms']]}; s/step "
        f"{[round(x, 3) for x in step_s]} (first includes warm-up), "
        f"median of steps 2-{TRAIN_STEPS} "
        f"{sorted(step_s[1:])[len(step_s[1:]) // 2]:.3f} s; peak memory "
        f"{_gb(peak)}; launches {launches}")

    # one more step through the same step function: its launches, then a
    # profiled step's device busy share against the host-timed median
    _, step_fn = ts.make_train_fns(cfg, options, dev)
    batch = ts.batch_to(synthetic.batch_for(cfg, "train", TRAIN_BATCH,
                                            TRAIN_SEQ, TRAIN_STEPS, 0), dev)
    box = {"state": run.pop("state")}

    def one():
        box["state"], m = step_fn(box["state"], batch)
        return m

    m, n = counted(one)
    assert n == train_want(cfg, 1), n
    assert _finite([m["loss"].item(), m["gnorm"].item()]), m
    t0 = time.perf_counter()
    one()["loss"].item()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = step_breakdown(one)
    if prof is None:
        busy = "device time not measured (the profiler saw no device time)"
    else:
        total, kinds, top, (prep, regions) = prof
        busy = (f"device {total:.1f} ms per profiled step, busy share "
                f"{total / wall_ms:.3f}; by kind "
                + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items())
                + " ms; costliest: " + "; ".join(
                    f"{name} {ms:.1f} ms x{calls}" for name, ms, calls in top)
                + "; per-call weight quantize + K-major copy ("
                + (f"{prep:.2f} ms" if prep > 0 else "not measured")
                + f" over {regions} {gemm.WEIGHT_PREP} regions)")
    log(f"[train] one step: launches {n} (per step: quantize_rows = plane "
        f"0 = (7 L + 1) + 7 L = {7 * 22 + 1 + 7 * 22}); wall {wall_ms:.1f} "
        f"ms; {busy} on {card}")
    del box, batch, run
    torch.cuda.empty_cache()

    # the CLI as a user runs it: the config's bf16, the card by default
    argv = ["--arch", "tinyllama-1.1b", "--mult", MULT, "--kernel-policy",
            "pallas", "--steps", "2", "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--log-every", "1"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc, n = counted(lambda: launch.main(argv))
    cli_s = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        log(f"[train] cli: {line}")
    bf16 = configs.get_config("tinyllama-1.1b", mult=MULT,
                              kernel_policy="pallas")
    assert rc == 0 and bf16.dtype == "bfloat16"
    assert n == train_want(bf16, 2), (n, train_want(bf16, 2))
    losses = [float(x) for x in re.findall(r"loss\s+(\S+) gnorm", text)]
    gn = [float(x) for x in re.findall(r"gnorm\s+(\S+) \(", text)]
    assert len(losses) == 2 and _finite(losses + gn), text
    assert "done: loss" in text, text
    log(f"[train] cli: python -m repro_torch.launch.train {' '.join(argv)}: "
        f"{cli_s:.1f}s, launches {n}; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    torch.cuda.empty_cache()
    return launches


def _param_gaps(a: dict, b: dict) -> dict:
    """{leaf name: max |a - b|} over two params trees."""
    from repro_torch.train import checkpoint as ckpt
    bb = dict(ckpt._named_leaves(b))
    return {name: (t.float() - bb[name].float()).abs().max().item()
            for name, t in ckpt._named_leaves(a)}


def train_check_phase(dev) -> None:
    """Training at 2 layers, full width, f32, seeded weights and batch (4
    x 128): one train step through the kernels and one through the plain
    versions from the same state, under trunc2x2 (plane 0) and pareto:0.01
    (the fused kernel): loss, gradient norm and every updated param equal
    (gap 0: the forward's GEMMs are bit-exact and the backward is the
    same ops).  A checkpoint round trip: save after step 2, restore into
    a fresh trainer's state (every tensor bit-equal), steps 3-4 against
    an uninterrupted 4-step run (every tensor bit-equal: the step is
    deterministic on the card, the embedding's backward included, whose
    CUDA index accumulation sorts the indices and uses no atomics).  One
    int8-moment step and one Adafactor step, finite."""
    import dataclasses
    import shutil

    import torch
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_step as ts

    t_phase = time.perf_counter()
    cfg = configs.get_config("tinyllama-1.1b", mult=MULT,
                             kernel_policy="pallas", attn_impl="chunked",
                             dtype="float32", n_layers=TRAIN_CHECK_LAYERS)
    opts = ts.StepOptions(lr=1e-3, total_steps=10, warmup_steps=2)
    batches = [ts.batch_to(synthetic.batch_for(
        cfg, "train", TRAIN_CHECK_BATCH, TRAIN_SEQ, i, 1), dev)
        for i in range(4)]
    for mult in (MULT, CNN_MULT):
        res = {}
        for policy in ("pallas", "xla"):
            c = dataclasses.replace(cfg, mult=mult, kernel_policy=policy)
            init, step = ts.make_train_fns(c, opts, dev)
            (st, m), n = counted(lambda: step(init(1), batches[0]))
            tiled = "approx_qgemm_fused" if mult == CNN_MULT \
                else "approx_qgemm_plane0"
            want = dict.fromkeys(n, 0)
            if policy == "pallas":
                want[tiled] = want["quantize_rows"] = \
                    train_want(c, 1)["approx_qgemm_plane0"]
            assert n == want, (mult, policy, n, want)
            res[policy] = (st["params"], m)
        (pk, mk), (px, mx) = res["pallas"], res["xla"]
        gaps = _param_gaps(pk, px)
        dl = abs(mk["loss"].item() - mx["loss"].item())
        dg = abs(mk["gnorm"].item() - mx["gnorm"].item())
        worst = max(gaps, key=gaps.get)
        embed = gaps["['embed']"]
        log(f"[train-check] {mult}, {TRAIN_CHECK_LAYERS} layers, full "
            f"width, one step kernels vs plain: loss {mk['loss'].item():.6f}"
            f" gap {dl:.3e}, gnorm {mk['gnorm'].item():.4f} gap {dg:.3e}, "
            f"largest param gap {gaps[worst]:.3e} ({worst}; limit 0), "
            f"embed {embed:.3e}")
        assert dl == 0.0 and dg == 0.0 and gaps[worst] == 0.0, (dl, dg, gaps)
        del res, pk, px

    # checkpoint round trip, resumed against uninterrupted
    init, step = ts.make_train_fns(cfg, opts, dev)
    whole, losses = init(1), []
    for b in batches:
        whole, m = step(whole, b)
        losses.append(m["loss"].item())
    part = init(1)
    for b in batches[:2]:
        part, _ = step(part, b)
    where = ROOT / "build" / "train_check_ckpt"
    shutil.rmtree(where, ignore_errors=True)
    mgr = ckpt.CheckpointManager(where)
    t0 = time.perf_counter()
    mgr.save(part, 2)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, at = mgr.restore(init(2))
    load_s = time.perf_counter() - t0
    assert at == 2
    saved = dict(ckpt._named_leaves(part))
    for name, t in ckpt._named_leaves(restored):
        assert t.dtype == saved[name].dtype and torch.equal(t, saved[name]), \
            name
    resumed = []
    for b in batches[2:]:
        restored, m = step(restored, b)
        resumed.append(m["loss"].item())
    gap = {name: (t.float() - w.float()).abs().max().item()
           for (name, t), (_, w) in zip(ckpt._named_leaves(restored),
                                        ckpt._named_leaves(whole))}
    worst = max(gap, key=gap.get)
    log(f"[train-check] checkpoint: {len(saved)} leaves, "
        f"{_gb(sum(t.numel() * t.element_size() for t in saved.values()))}"
        f", saved in {save_s:.1f}s, restored bit-equal in {load_s:.1f}s; "
        f"steps 3-4 resumed {resumed} vs uninterrupted {losses[2:]}, "
        f"largest gap {gap[worst]:.3e} ({worst}; limit 0)")
    assert resumed == losses[2:], (resumed, losses[2:])
    for (name, t), (_, w) in zip(ckpt._named_leaves(restored),
                                 ckpt._named_leaves(whole)):
        assert t.dtype == w.dtype and torch.equal(t, w), (name, gap[name])
    shutil.rmtree(where, ignore_errors=True)
    del whole, part, restored, saved

    for kw in ({"moment_dtype": "int8"}, {"optimizer": "adafactor"}):
        init, step = ts.make_train_fns(
            cfg, dataclasses.replace(opts, **kw), dev)
        st, m = step(init(1), batches[0])
        vals = [m["loss"].item(), m["gnorm"].item()]
        assert _finite(vals) and all(
            torch.isfinite(t).all() for t in
            (st["params"]["embed"], st["params"]["layers"]["wq"])), kw
        log(f"[train-check] {kw}: one step, loss {vals[0]:.6f}, gnorm "
            f"{vals[1]:.4f}, finite")
    torch.cuda.empty_cache()
    log(f"[train-check] {time.perf_counter() - t_phase:.1f}s")


def attention_witness(runs: dict, tokens, true_len, ex: dict) -> None:
    """Flash against the plain chunked attention at the first attention
    of a conditioned model that `conditioned_check_phase` runs on chunked
    attention (Whisper's encoder layer 0, non-causal over its 1500
    frames; the vision model's layer 0, causal over 128 tokens): their
    divergence, the int8 codes it moves at the o-projection input and
    what it makes of the prefill logits (kernels on both sides) are
    printed as readings; the o-projection GEMM through the kernels and
    through the plain path must agree to the bit on both outputs."""
    import dataclasses

    import torch
    from repro_torch.approx import layers as AL
    from repro_torch.kernels import quantize as qz
    from repro_torch.models import api
    from repro_torch.models import attention as A
    from repro_torch.models import common as C
    from repro_torch.models import encdec
    from repro_torch.models import transformer as T

    c, spec, p, prefill_logits = runs["pallas"]
    _, spec_x, px, _ = runs["xla"]
    with torch.no_grad():
        if c.family == "encdec":
            where = "encoder layer 0"
            lp = C.block_params(p["enc_layers"], 0)
            lpx = C.block_params(px["enc_layers"], 0)
            frames = ex["frames"]
            h = frames + C.sinusoid_positions(frames.shape[1], c.d_model,
                                              frames.device)
            x = C.layernorm(h, lp["ln1"], lp["ln1b"])
            b, s = x.shape[:2]
            q = AL.dense(x, lp["wq"], lp["bq"], spec).reshape(
                b, s, c.n_heads, c.hd)
            k, v = encdec._project_kv(x, lp, c, spec)
            causal, bias = False, "bo"
        else:
            where = "layer 0"
            lp = C.block_params(p["layers"], 0, 0)
            lpx = C.block_params(px["layers"], 0, 0)
            b, s = tokens.shape
            x = C.rmsnorm(AL.embed(tokens, p["embed"]), lp["ln1"])
            positions = torch.arange(s, device=tokens.device)[None, :]
            q, k, v = T._qkv(x, lp, c, spec, positions)
            causal, bias = True, None
        outs = {"flash": C.flash_attention(q, k, v, causal),
                "chunked": A.blockwise_attention(q, k, v, c.attn_chunk,
                                                 causal)}
        outs = {name: o.reshape(b, s, -1) for name, o in outs.items()}
        for name, o in outs.items():
            got = AL.dense(o, lp["wo"], lp.get(bias), spec)
            want = AL.dense(o, lpx["wo"], lpx.get(bias), spec_x)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{c.name} o-projection on {name}'s output: kernels "
                    f"!= plain (max |diff| "
                    f"{(got - want).abs().max().item():.3e})")
        div = (outs["flash"] - outs["chunked"]).abs().max().item()
        codes = [qz.quantize_rows_plain(o.reshape(b * s, -1), 0)[0]
                 for o in outs.values()]
        moved = (codes[0] != codes[1]).sum().item()
        cf = dataclasses.replace(c, attn_impl="flash")
        lf, _ = api.prefill(p, tokens, cf, spec, max_len=160, extras=ex,
                            true_len=true_len)
        ldiff = (lf - prefill_logits).abs().max().item()
    log(f"[conditioned-check] {c.name} flash witness, {where} o-projection "
        f"input: flash vs chunked max|diff| {div:.3e}, {moved} of "
        f"{codes[0].numel()} int8 codes moved; the o-projection GEMM "
        f"through the kernels equals the plain path's on both; prefill "
        f"logits with flash vs chunked attention (kernels on both) "
        f"max|diff| {ldiff:.3e}")


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
    from repro_torch.models import attention as A
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T

    c, spec, p = runs["pallas"][:3]
    cx, spec_x, px = runs["xla"][:3]
    b, s = tokens.shape
    lp = C.block_params(p["layers"], 0)
    lpx = C.block_params(px["layers"], 0)
    with torch.no_grad():
        x = C.rmsnorm(AL.embed(tokens, p["embed"]), lp["ln1"])
        positions = torch.arange(s, device=tokens.device)[None, :]
        q, k, v = T._qkv(x, lp, c, spec, positions)
        inputs = {"flash": C.flash_attention(q, k, v, True),
                  "chunked": A.blockwise_attention(q, k, v, c.attn_chunk,
                                                   True)}
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
    quantize_per_shape(fwd)
    fc_skinny(params, spec, dev)
    del params, x, logits
    torch.cuda.empty_cache()
    return launches


def quantize_per_shape(fwd) -> None:
    """Device time of each quantize_rows call inside one VGG16 forward
    (batch 8), beside its byte bound and the launch plan it ran."""
    import torch
    from repro_torch.kernels import quantize as qz
    with torch.no_grad():
        us = kernel_times(fwd, "quantize_")
    rows = vgg16_rows()
    if us is None or len(us) != len(rows):
        log(f"[cnn] quantize_rows device time per call: not measured "
            f"({None if us is None else len(us)} kernels in the trace)")
        return
    parts = []
    for (m, k), t in zip(rows, us):
        p = qz.launch_plan(m, k, sm_count=sms())
        parts.append(f"({m},{k}) {t:.1f} us (bound "
                     f"{bound_ms('quantize_rows', [(m, k)])[0] * 1e3:.1f}; "
                     f"{'16-byte' if p.vec else 'scalar'}, lanes {p.lanes} "
                     f"x {p.vecs})")
    log(f"[cnn] quantize_rows device time per call in the forward "
        f"({sum(us) / 1e3:.4f} ms over {len(us)} calls): " + "; ".join(parts))


def fc_skinny(params, spec, dev) -> None:
    """VGG16's three FC GEMMs (m = 8) as the CNN path runs them: the
    quantized weight, which no prepared copy keeps, transposed per call to
    the K-major layout the skinny kernel takes, then the kernel.  Logs each
    call's device time: the kernel's, and the rest (the transpose and the
    flush scales)."""
    import torch
    from repro_torch.approx import quant
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(4)
    parts, total = [], [0.0, 0.0]
    for p in params["fcs"]:
        wq, _ = quant.quantize(p["w"], axis=1)
        k, n = wq.shape
        xq = torch.randint(-128, 128, (8, k), generator=gen, device=dev,
                           dtype=torch.int8)
        with torch.no_grad():
            every = kernel_times(
                lambda: ops.approx_qgemm(xq, wq, spec, skinny=True))
            kern = kernel_times(
                lambda: ops.approx_qgemm(xq, wq, spec, skinny=True),
                "skinny_kernel")
            copy = device_ms(lambda: wq.T.contiguous())
        if not every or not kern:
            parts.append(f"(8,{k},{n}): not measured")
            continue
        total[0] += sum(kern)
        total[1] += sum(every) - sum(kern)
        parts.append(f"(8,{k},{n}): kernel {sum(kern):.1f} us, other "
                     f"{sum(every) - sum(kern):.1f} us (the transpose alone "
                     f"{copy * 1e3 if copy else float('nan'):.1f} us; bound "
                     f"{bound_ms('approx_qgemm_skinny', [(8, k, n, 6)])[0] * 1e3:.1f}"
                     " us)")
    log(f"[cnn] FC GEMMs on the skinny kernel under {CNN_MULT}, device time "
        f"per call: " + "; ".join(parts) + f"; all three: kernel "
        f"{total[0] / 1e3:.4f} ms, transposes and scales {total[1] / 1e3:.4f} "
        f"ms")


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


def accuracy_phase(dev) -> dict:
    """repro_torch.launch.accuracy on the card: vgg_mini trained 260 steps,
    every multiplier's top-1 through the kernels and the plain versions.
    Returns the trained vgg_mini for the codesign phase."""
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
    return params


# ---------------------------------------------------------------------------
# codesign: the co-design core on the card
# ---------------------------------------------------------------------------

#: The codesign phase holds the card's population metrics and FPS lattice
#: to the CPU's, and each GA design to the exhaustive optimum, this close.
CODESIGN_RTOL = 1e-6
GA_SLACK = 1e-4


def wall_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of `fn` on the host clock, each call between two
    synchronizations (for work that reads results back to the host)."""
    import torch
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[reps // 2]


def _held_to(got: dict, want: dict) -> float:
    """Hold population metrics on the card to the CPU's: the same
    `feasible` mask, `inf` at the same places, no NaN, the rest within
    CODESIGN_RTOL.  Returns the largest relative difference."""
    import numpy as np
    worst = 0.0
    assert set(got) == set(want)
    for k in got:
        g, w = got[k].cpu().numpy(), want[k].numpy()
        if k == "feasible":
            assert np.array_equal(g, w), k
            continue
        assert not np.isnan(g).any() and not np.isnan(w).any(), k
        assert np.array_equal(np.isinf(g), np.isinf(w)), k
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=CODESIGN_RTOL,
                                   err_msg=k)
        worst = max(worst, float(np.max(np.abs(g[fin] - w[fin])
                                        / np.abs(w[fin]))))
    return worst


def codesign_phase(dev, params: dict, card: str) -> None:
    """The co-design core on the card: (1) the FPS lattice and every
    genome's metrics of the VGG16 7 nm space held to the CPU's; (2) the
    paper's reproduction, `repro_torch.launch.codesign` at 7, 14 and 28 nm
    under drops measured through the kernels on the accuracy phase's
    vgg_mini, each GA design held to `exhaustive_best`; (3) the delay
    calibrations on the port's kernels; (4) the multi-die scenarios under
    the GEMM calibration; (5) the GA's times.  (2) and (3) are the phase's
    main path: their kernel launches are counted, logged, and must include
    every kernel that path runs."""
    import math

    import numpy as np
    from repro_torch.core import calibrate as cal
    from repro_torch.core import codesign as cd
    from repro_torch.core import dataflow as df
    from repro_torch.core import ga_batched as gb
    from repro_torch.launch import codesign as launch

    t_start = time.perf_counter()
    mults = launch.default_mults()

    # 1. the card against the CPU on one space
    space = gb.build_space("vgg16", 7, 30.0, 2.0, mults=mults, device=dev)
    cpu_space = gb.build_space("vgg16", 7, 30.0, 2.0, mults=mults,
                               device="cpu")
    np.testing.assert_allclose(space.fps_table, cpu_space.fps_table,
                               rtol=CODESIGN_RTOL)
    lat_err = float(np.max(np.abs(space.fps_table - cpu_space.fps_table)
                           / cpu_space.fps_table))
    pop = gb.exhaustive_population(space)
    got = gb.evaluate_population(pop, space.tables(dev), 7)
    want = gb.evaluate_population(pop, space.tables("cpu"), 7)
    met_err = _held_to(got, want)
    log(f"[codesign] vgg16 7nm space, {len(space.mults)} multipliers: FPS "
        f"lattice ({space.fps_table.size} configs) card vs CPU max rel "
        f"{lat_err:.3e}; {len(pop)} genomes' metrics max rel {met_err:.3e} "
        f"(limit {CODESIGN_RTOL:g}); same feasible mask "
        f"({int(want['feasible'].sum())} feasible) and inf pattern")

    # 2. the paper's reproduction under measured drops
    res, launches = counted(lambda: launch.run(params, policy="pallas",
                                                device=dev))
    for line in launch.format_lines(res):
        log(f"[codesign] {line}")
    for entry in res["nodes"]:
        rep, node = entry["report"], entry["node_nm"]
        node_space = gb.build_space("vgg16", node, launch.FPS_MIN,
                                    launch.MAX_DROP, mults=res["mults"],
                                    accuracy_fn=res["accuracy_fn"],
                                    device=dev)
        _, ex = gb.exhaustive_best(node_space, device=dev)
        log(f"[codesign] {node}nm: GA fitness {rep.ga_cdp.fitness:.6g}, "
            f"exhaustive {float(ex['fitness']):.6g}; carbon -"
            f"{100 * rep.ga_reduction:.2f}% (GA), -"
            f"{100 * rep.approx_only_reduction:.2f}% (approx only); chosen "
            f"{rep.ga_cdp.config.multiplier} drop "
            f"{entry['chosen_drop_pct']:.2f}%")
        assert rep.ga_cdp.fitness <= float(ex["fitness"]) * (1 + GA_SLACK)
        assert rep.ga_reduction > 0 and rep.approx_only_reduction > 0
        assert entry["chosen_drop_pct"] <= launch.MAX_DROP
    admitted = sum(d <= launch.MAX_DROP for d in res["drops"].values())
    log(f"[codesign] reproduction launches {launches}; "
        f"{len(res['drops'])} multipliers measured, {admitted} within the "
        f"{launch.MAX_DROP:g}% drop ceiling")

    # 3. the delay calibrations on the port's kernels
    cals = []
    for kw in ({}, dict(m=128, k=2048, n=5632),
               dict(m=128, k=2048, n=5632, mult_name="pareto:0.01")):
        c, n = counted(lambda: cal.calibrate_gemm(device=dev, **kw))
        cals.append(c)
        launches = {k: launches[k] + n[k] for k in launches}
        log(f"[codesign] calibrate_gemm {c.meta['shape']} {c.meta['mult']}: "
            f"scale {c.scale:.6g} ({c.measured:.4g} MAC/s measured, "
            f"{c.meta['us_per_call']:.1f} us/call); plan "
            f"{c.meta['dispatch']}; launches "
            f"{ {k: v for k, v in n.items() if v} }")
        assert c.meta["dispatch"]["path"] == "fused" and c.scale > 0
    c, n = counted(lambda: cal.calibrate_serving(
        mult="trunc2x2", kernel_policy="pallas", device=dev))
    launches = {k: launches[k] + n[k] for k in launches}
    log(f"[codesign] calibrate_serving {c.meta['arch']} {c.meta['mult']}: "
        f"scale {c.scale:.6g} ({c.measured:.4g} steps/s over "
        f"{c.meta['decode_steps']} decode steps, analytical "
        f"{c.analytical:.4g}); launches { {k: v for k, v in n.items() if v} }")
    assert c.scale > 0 and c.meta["decode_steps"] > 0
    for k in ("quantize_rows", "approx_qgemm_plane0", "approx_qgemm_skinny",
              "approx_qgemm_fused"):
        assert launches[k] > 0, (k, launches)

    # 4. the multi-die scenarios under the GEMM delay calibration: the
    # full-width TinyLlama FFN up-projection under trunc2x2, whose time is
    # the kernel's; the reference shape (128, 160, 128) is launch-bound
    gemm_cal = cals[1]
    t0 = time.perf_counter()
    scen = cd.run_scenarios(cd.multi_die_scenarios(), mults=mults,
                            calibration=gemm_cal, device=dev)
    for r in scen:
        b = r.best
        log(f"[codesign] {r.scenario.name}: {b.n_dies} dies x "
            f"{b.config.num_pes // b.n_dies} PEs, {b.config.multiplier}, "
            f"{b.fps:.1f} fps, {b.carbon_g:.2f} g ("
            f"{-100 * r.ga_reduction:+.2f}% vs the exact baseline); best "
            f"monolithic fitness "
            f"{r.mono.fitness:.4g} vs {b.fitness:.4g}; calibrated CDP "
            f"{r.cdp_calibrated:.4g}; {r.wall_s:.2f}s")
        assert math.isclose(r.cdp_calibrated, b.cdp / gemm_cal.scale,
                            rel_tol=1e-6)
    assert any(r.best.n_dies > 1 for r in scen)
    log(f"[codesign] multi-die scenarios {time.perf_counter() - t0:.1f}s")

    # 5. the GA's times
    cfg = gb.BatchedGAConfig()

    def ga():
        gb.run_ga_batched("vgg16", 7, 30.0, 2.0, cfg=cfg, space=space,
                          device=dev)

    ri, rj, rk, rd = np.meshgrid(*(np.arange(n) for n in
                                   space.fps_table.shape), indexing="ij")
    rows, cols = space.rows[ri, rj].ravel(), space.cols[ri, rj].ravel()
    glbs, dies = space.glb_kib[rk].ravel(), space.dies[rd].ravel()

    def exhaustive():
        gb.exhaustive_best(space, device=dev)

    def lattice(workload):
        return lambda: df.batched_fps(workload, rows, cols, glbs, 7,
                                      dies=dies, device=dev)

    def busy(fn) -> str:
        ms = device_ms(fn)
        return "not measured" if ms is None else f"{ms:.4f} ms"

    ga_ms = wall_ms(ga, reps=3)
    ga_dev = device_ms(ga)
    ex_ms = wall_ms(exhaustive)
    lat_ms = {w: wall_ms(lattice(w)) for w in ("vgg16", "resnet152")}
    log(f"[codesign] run_ga_batched at pop {cfg.pop_size} x "
        f"{cfg.generations} generations: {ga_ms / cfg.generations:.4f} ms "
        f"per generation (host clock, median of 3 runs), device busy "
        + ("not measured" if ga_dev is None else
           f"{ga_dev / cfg.generations:.4f} ms")
        + f" per generation on {card}")
    log(f"[codesign] exhaustive_best over {space.size} genomes: "
        f"{ex_ms:.3f} ms (host clock, median of 5), device busy "
        f"{busy(exhaustive)} on {card}")
    log(f"[codesign] build_space lattice ({len(rows)} configs): " + ", ".join(
        f"{w} {ms:.3f} ms (device busy {busy(lattice(w))})"
        for w, ms in lat_ms.items())
        + f" (host clock, median of 5) on {card}")
    log(f"[codesign] main-path launches {launches}; "
        f"{time.perf_counter() - t_start:.1f}s")


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
    untuned = pin_no_tuning_cache()
    name, card = probe()
    build_phase()
    cfg = configs.get_config("tinyllama-1.1b", mult=MULT,
                             kernel_policy="pallas", attn_impl="flash",
                             dtype="float32")
    errs, stacked_launches = check_kernels(dev)
    table = time_kernels(dev, cfg, errs)
    log(f"[kernels] {time.perf_counter() - t_start:.1f}s")
    autotune_launches = autotune_phase(dev, cfg, card)
    log(f"[autotune] {time.perf_counter() - t_start:.1f}s")
    # each kernel's launches come from the main path that runs it
    launches = serve_phase(dev, cfg)
    paged_launches = paged_phase(dev, cfg, card)
    fleet_launches = fleet_phase(dev, cfg, card)
    log(f"[fleet] {time.perf_counter() - t_start:.1f}s")
    recurrent_launches = recurrent_phase(dev, card)
    recurrent_check_phase(dev)
    log(f"[recurrent] {time.perf_counter() - t_start:.1f}s")
    conditioned_launches = conditioned_phase(dev, card)
    conditioned_check_phase(dev)
    log(f"[conditioned] {time.perf_counter() - t_start:.1f}s")
    moe_launches = moe_phase(dev, card)
    moe_check_phase(dev)
    log(f"[moe] {time.perf_counter() - t_start:.1f}s")
    train_launches = train_phase(dev, card)
    train_check_phase(dev)
    log(f"[train] {time.perf_counter() - t_start:.1f}s")
    check_phase(dev, cfg, MULT, "flash")
    check_phase(dev, cfg, CNN_MULT, "chunked")
    log(f"[serve+check] {time.perf_counter() - t_start:.1f}s")
    cnn_launches = cnn_phase(dev)
    cnn_check_phase(dev)
    log(f"[cnn] {time.perf_counter() - t_start:.1f}s")
    vgg_mini = accuracy_phase(dev)
    log(f"[accuracy] {time.perf_counter() - t_start:.1f}s")
    codesign_phase(dev, vgg_mini, card)
    counts = {"serve": launches, "cnn": cnn_launches,
              "parity": {"approx_qgemm_stacked": stacked_launches}}
    for row in table:
        row["launches"] = counts[row["path"]][row["name"]]
        assert row["launches"] > 0, row["name"]
        row["paged_launches"] = paged_launches[row["name"]]
        row["fleet_launches"] = fleet_launches[row["name"]]
        row["recurrent_launches"] = {
            arch: n[row["name"]] for arch, n in recurrent_launches.items()}
        row["conditioned_launches"] = {
            arch: n[row["name"]] for arch, n in conditioned_launches.items()}
        row["moe_launches"] = {
            arch: n[row["name"]] for arch, n in moe_launches.items()}
        row["train_launches"] = train_launches[row["name"]]
        row["autotune_launches"] = autotune_launches[row["name"]]
    assert_untuned(untuned)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
