"""Measured (not analytical) delay for the CDP objective.

The analytical dataflow model (`core/dataflow.py`) predicts *relative*
performance across accelerator configs well — that is what the paper's
claims rest on — but its absolute time scale is a stack of optimistic
assumptions (perfect double buffering, no host overhead).  This module
anchors that scale to a real measurement: it runs the port's own fast
path — the `repro_torch.serving` continuous-batching engine, or the
approximate GEMM as `kernels/dispatch.choose_gemm_path` plans it — and
returns a `DelayCalibration` whose `scale` maps analytical throughput
onto measured throughput.

Scenario sweeps (`core/codesign.py`) then report CDP twice: the paper's
analytical figure, and the serving-calibrated figure
`carbon / (fps * scale)` in which a design's delay is what the measured
software stack would actually deliver.  Everything downstream stays a
pure tensor program: a calibration is one scalar multiplier on the FPS
lattice, so the population-parallel GA consumes it for free.

Measurements run on the CUDA device unless the caller passes
`device="cpu"`; on the card every clock read follows a
`torch.cuda.synchronize()`, so a time is the work's and not its launch's.
All imports of the serving/kernel stack are lazy: `core` stays light for
consumers that only want the carbon/GA models.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from repro_torch.device import resolve_device

from . import accelerator as accmod
from . import carbon as carbonmod
from . import dataflow as dfmod
from . import target as targetmod
from . import workloads as wl


@dataclasses.dataclass(frozen=True)
class DelayCalibration:
    """`measured / analytical` throughput for the same work.

    `analytical` is the dataflow model's prediction for the anchor
    accelerator running a layer-level mirror of the measured workload, so
    `scale` carries exactly one piece of information: how the modeled
    absolute time scale relates to a real end-to-end measurement."""
    measured: float           # measured throughput [unit]
    analytical: float         # model-predicted throughput [unit]
    unit: str                 # "tokens/s" | "macs/s"
    source: str               # "serving" | "gemm" | "identity"
    anchor: str               # anchor accelerator description
    meta: dict

    @property
    def scale(self) -> float:
        return self.measured / max(self.analytical, 1e-12)

    def calibrated_fps(self, fps: float) -> float:
        return fps * self.scale

    def calibrated_cdp(self, carbon_g: float, fps: float) -> float:
        return carbonmod.cdp(carbon_g, self.calibrated_fps(fps))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["scale"] = self.scale
        return d


def identity() -> DelayCalibration:
    """No-op calibration (scale 1): calibrated CDP == analytical CDP."""
    return DelayCalibration(1.0, 1.0, "", "identity", "", {})


def _anchor_config(node_nm: int) -> accmod.AcceleratorConfig:
    """The calibration anchor: the full-size exact NVDLA default."""
    return accmod.nvdla_default(2048, node_nm)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _backend(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def calibrate_serving(arch: str = "tinyllama-1.1b", *, requests: int = 3,
                      capacity: int = 2, max_len: int = 48, prompt: int = 8,
                      gen: int = 4, node_nm: int = 7, mult: str = "",
                      kernel_policy: str = "", seed: int = 0,
                      mesh_spec: str = "", n_dies: int | None = None,
                      target=None,
                      device: str | torch.device | None = None
                      ) -> DelayCalibration:
    """Measure the decode-step rate by serving a tiny deterministic trace
    through `repro_torch.serving.Engine` (reduced config) on `device`, and
    anchor it against the dataflow model's decode-step prediction built
    from the SAME model dimensions (`workloads.decode_block_gemms`).

    Measured throughput is steps/s, i.e. SINGLE-STREAM tokens/s: one
    engine step advances every occupied slot, so dividing emitted tokens
    by wall time would fold the arena's batch concurrency into the scale
    (capacity would silently 'improve' calibrated CDP).  The per-step
    rate is the quantity the analytical single decode step predicts; the
    batched-throughput figure is recorded in `meta` for reference.

    `mult` / `kernel_policy` ("" keeps the config's) pick the multiplier
    and the kernels: `mult="trunc2x2", kernel_policy="pallas"` serves the
    trace through the row quantizer, the plane-0 prefill GEMM and the
    skinny decode GEMM.  `n_dies` (or a `mesh_spec` / `core.target.
    HardwareTarget` whose model axis gives it) runs the analytical mirror
    under that die partition; the measured side serves on one device, so
    a mesh or target spanning more than one device raises
    `NotImplementedError` (tensor-parallel serving on
    `torch.distributed` is not ported yet)."""
    from repro_torch import configs
    from repro_torch.serving import Engine, Request, SamplingParams

    cfg = configs.apply_overrides(configs.get_config(arch), reduced=True,
                                  mult=mult, kernel_policy=kernel_policy)
    axes: tuple[tuple[str, int], ...] = ()
    if target is not None:
        if mesh_spec or n_dies is not None:
            raise ValueError("pass either target= or mesh_spec/n_dies, "
                             "not both")
        axes = target.mesh_axes or (("model", target.n_dies),)
        mesh_spec = target.mesh_spec()
        n_dies = target.n_dies
    elif mesh_spec:
        axes = targetmod.parse_mesh_spec(mesh_spec)
        if n_dies is None:
            n_dies = dict(axes).get("model", 1)
    n_dies = n_dies or 1
    n_devices = math.prod(size for _, size in axes)
    if n_devices > 1:
        raise NotImplementedError(
            f"serving over {n_devices} devices (mesh "
            f"{mesh_spec or dict(axes)!r}) needs tensor-parallel serving on "
            "torch.distributed, which the port does not have yet (ROADMAP "
            "Queue 1, item 2: sharding)")
    dev = resolve_device(device)
    eng = Engine(cfg, capacity=capacity, max_len=max_len, seed=seed,
                 device=dev)
    # warm the phases (and build the kernels) so the measurement is
    # steady-state decode
    eng.submit(Request("_warmup", [1] * prompt,
                       SamplingParams(max_new_tokens=2)))
    eng.run_until_complete()
    _sync(dev)
    base = eng.stats()
    for i in range(requests):
        eng.submit(Request(f"cal{i}", [(7 * i + j) % (cfg.vocab - 1) + 1
                                       for j in range(prompt)],
                           SamplingParams(max_new_tokens=gen)))
    done = [c for c in eng.run_until_complete() if c.request_id != "_warmup"]
    _sync(dev)
    stats = eng.stats()
    decode_s = stats["decode_s"] - base["decode_s"]
    decode_steps = stats["decode_steps"] - base["decode_steps"]
    decode_toks = sum(max(len(c.tokens) - 1, 0) for c in done)
    measured = decode_steps / max(decode_s, 1e-9)

    # analytical mirror: one decode step of this model at mid-trace cache
    # length, on the anchor accelerator under the SAME die partitioning
    head_dim = cfg.head_dim or cfg.d_model // cfg.n_heads
    kv_len = prompt + max(gen // 2, 1)
    layers: list[wl.Layer] = []
    for i in range(cfg.n_layers):
        layers += wl.decode_block_gemms(
            f"cal.l{i}", cfg.n_heads * head_dim, cfg.d_ff, cfg.n_heads,
            max(cfg.n_kv_heads, 1), kv_len)
    anchor = _anchor_config(node_nm)
    analytical = dfmod.layers_perf(layers, anchor, n_dies).fps

    return DelayCalibration(
        measured=measured, analytical=analytical, unit="tokens/s",
        source="serving",
        anchor=f"nvdla_default(2048, {node_nm}nm) x {n_dies} dies",
        meta={"arch": cfg.name, "family": cfg.family, "requests": requests,
              "prompt": prompt, "gen": gen, "kv_len": kv_len,
              "mesh_spec": mesh_spec, "n_dies": n_dies,
              "mult": cfg.mult, "kernel_policy": cfg.kernel_policy,
              "decode_s": decode_s, "decode_steps": decode_steps,
              "decode_tokens": decode_toks,
              "batched_tokens_per_s": decode_toks / max(decode_s, 1e-9),
              "backend": _backend(dev),
              "engine": {k: v for k, v in stats.items()
                         if isinstance(v, (int, float))}})


def calibrate_gemm(m: int = 128, k: int = 160, n: int = 128, *,
                   mult_name: str = "trunc2x2", reps: int = 3,
                   node_nm: int = 7, seed: int = 0,
                   policy: str | None = None,
                   device: str | torch.device | None = None
                   ) -> DelayCalibration:
    """Measure effective MAC/s of the approximate-GEMM data path on
    `device` and anchor it against the dataflow model's prediction for a
    single GEMM layer of the same shape.

    The measured side runs whatever `kernels/dispatch.choose_gemm_path`
    picks for this GEMM on this device — the skinny kernel at m <= 32, the
    plane-0 or fused kernel above, the plain PyTorch path for a CPU
    tensor under the default policy — on a weight kept K-major once, as a
    prepared serving weight is.  The chosen plan is recorded in
    `meta["dispatch"]` with its source ("tuned", "policy" or
    "default"), the device in `meta["backend"]`; the time is the median
    of `reps` calls, each between two synchronizations."""
    import numpy as np

    from repro_torch.approx import gemm as G
    from repro_torch.kernels import dispatch, ops

    from . import multipliers as mm

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    a, b = a.to(dev), b.to(dev)
    spec = G.from_multiplier(mm.get_multiplier(mult_name)).to(dev)
    rank = spec.rank if spec.mode == "lowrank" else 0
    plan = dispatch.choose_gemm_path(policy or spec.policy, m=m, k=k, n=n,
                                     device=dev, mode=spec.mode, rank=rank)
    if plan.use_pallas:
        b_t = b.T.contiguous()

        def fn():
            return ops.approx_qgemm_planned(a, b, spec, plan, b_t)
    else:
        def fn():
            return G.approx_qgemm(a, b, spec)
    fn()                       # warm-up: builds and loads the kernels
    _sync(dev)
    samples = []
    for _ in range(max(reps, 1)):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        samples.append(time.perf_counter() - t0)
    samples.sort()
    h = len(samples) // 2
    sec = samples[h] if len(samples) % 2 else \
        0.5 * (samples[h - 1] + samples[h])
    measured = m * k * n / max(sec, 1e-12)

    anchor = _anchor_config(node_nm)
    layer = wl.GemmLayer("cal.gemm", m, n, k)
    analytical = dfmod.layers_perf([layer], anchor).fps * layer.macs

    return DelayCalibration(
        measured=measured, analytical=analytical, unit="macs/s",
        source="gemm",
        anchor=f"nvdla_default(2048, {node_nm}nm)",
        meta={"shape": {"m": m, "k": k, "n": n}, "mult": mult_name,
              "reps": reps, "us_per_call": sec * 1e6,
              "dispatch": plan.as_dict(),
              "backend": _backend(dev)})


def get_calibration(source: str, node_nm: int = 7,
                    **kwargs) -> DelayCalibration:
    """Dispatch by name."""
    if source in ("", "none", "identity"):
        return identity()
    if source == "serving":
        return calibrate_serving(node_nm=node_nm, **kwargs)
    if source == "gemm":
        return calibrate_gemm(node_nm=node_nm, **kwargs)
    raise ValueError(f"unknown calibration source {source!r}")
