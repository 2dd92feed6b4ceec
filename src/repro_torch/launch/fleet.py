"""Carbon-aware fleet serving demo over the port: N replicas, live grid
routing, mid-trace failover.

  PYTHONPATH=src python -m repro_torch.launch.fleet --arch tinyllama-1.1b \
      --requests 12 --gen 8 --trace diurnal
  PYTHONPATH=src python -m repro_torch.launch.fleet --reduced --device cpu \
      --kill 3

The replicas serve on the CUDA device; `--device cpu` runs the plain
PyTorch versions of the kernels instead (use `--reduced` there).

Under torchrun every rank runs the same fleet and router loop (SPMD):
each replica's engine serves over the mesh `--mesh` names (or
$REPRO_MESH, then the host mesh over the world's ranks), and `targets`
give replicas meshes of their own (`HardwareTarget.make_mesh`).  Routing,
degradation and failover read only ticks, tokens and seeded draws, so
every rank decides alike; each rank's meter prices its own host-timed
seconds, and rank 0 prints its Joules beside the ranks' maximum:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.fleet \
      --reduced --device cpu --mesh data=2 --kill 3

Builds a small fleet (default two replicas in different-intensity
regions, each its own Engine + EnergyMeter), replays a Poisson arrival
trace through the carbon-aware router, and reports where traffic went,
what it cost in gCO2e, and whether the TTFT SLO held.  With `--trace
diurnal` the regions' intensities cross over the (virtual) day, so the
routed share visibly follows the cleaner grid.  `--kill T` injects a
replica-0 fault after T of its steps mid-trace: its in-flight requests
re-queue onto the survivors and the run still completes every request —
the zero-lost check prints at the end.

`build_fleet` / `poisson_requests` are importable; `chip_smoke.py`'s
fleet phase drives the same path at full width on the card.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.fleet.grid import (REGION_INTENSITY_G_PER_KWH, StaticGrid,
                                    diurnal_trace)
from repro_torch.fleet.meter import DevicePowerModel
from repro_torch.fleet.replica import Replica
from repro_torch.fleet.router import Fleet, FleetConfig
from repro_torch.serving import Request, SamplingParams
from repro_torch.train.fault import PreemptionGuard

DEFAULT_REGIONS = ("us-west", "eu-west")   # close means -> diurnal crossover


def build_fleet(cfg, *, regions: tuple[str, ...] = DEFAULT_REGIONS,
                trace: str = "static", capacity: int = 2,
                max_len: int = 64, seed: int = 0,
                ttft_slo_ticks: float = 32.0,
                seconds_per_tick: float = 1800.0,
                params=None, mesh=None, targets=None,
                tiers: tuple[str, ...] | None = None,
                fleet_cfg: FleetConfig | None = None,
                power: DevicePowerModel | None = None,
                device=None) -> Fleet:
    """One replica per region.  `trace="diurnal"` gives each region a
    phase-shifted sinusoidal day curve (half a period apart for two
    replicas), so the lowest-carbon region changes over the run;
    `"static"` pins each to its annual-average intensity.  `targets`
    (optional, one per region) lets replicas run different accelerator
    designs.  `tiers` gives every engine a multiplier-tier degradation
    ladder; `fleet_cfg` overrides the whole router config (retry
    budget, probation, `DegradationConfig`, ...) — `ttft_slo_ticks` is
    ignored when it is passed.  `power` prices every replica's Joules
    (default: from its target, else the edge default); `device` is where
    the engines run (None: the CUDA device, raising when there is
    none).  Inside a world of ranks, every rank calls this alike: `mesh`
    serves every replica over one mesh, `targets` each over its own."""
    replicas = []
    for i, region in enumerate(regions):
        if trace == "diurnal":
            grid = diurnal_trace(region, phase=i / len(regions))
        elif trace == "static":
            grid = StaticGrid(region)
        else:
            raise ValueError(f"unknown trace {trace!r}")
        replicas.append(Replica(
            f"{region}", cfg, grid=grid,
            target=targets[i] if targets else None, power=power,
            seconds_per_tick=seconds_per_tick, params=params, mesh=mesh,
            capacity=capacity, max_len=max_len, seed=seed, tiers=tiers,
            device=device))
    return Fleet(replicas,
                 fleet_cfg or FleetConfig(ttft_slo_ticks=ttft_slo_ticks))


def poisson_requests(n: int, prompt_len: int, gen: int, vocab: int,
                     seed: int = 0, mean_gap_ticks: float = 2.0
                     ) -> list[Request]:
    """Synthetic arrival trace: exponential inter-arrival gaps (Poisson
    process) on the fleet's virtual tick clock, deterministic by seed."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += rng.exponential(mean_gap_ticks)
        out.append(Request(
            request_id=f"t{i}",
            tokens=rng.integers(1, vocab, (prompt_len,)).tolist(),
            sampling=SamplingParams(max_new_tokens=gen),
            arrival=float(round(t))))
    return out


def ttft_ticks(completion) -> int:
    """Admission-to-first-token in engine ticks (arrival is restamped to
    the routing tick, so this includes replica queueing)."""
    return int(completion.admitted_tick - completion.arrival) + 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--regions", default=",".join(DEFAULT_REGIONS),
                    help="comma-separated regions, one replica each "
                         f"(known: {', '.join(REGION_INTENSITY_G_PER_KWH)})")
    ap.add_argument("--trace", default="diurnal",
                    choices=["static", "diurnal"],
                    help="grid-intensity model per region")
    ap.add_argument("--capacity", type=int, default=2)
    ap.add_argument("--slo-ticks", type=float, default=32.0)
    ap.add_argument("--seconds-per-tick", type=float, default=1800.0,
                    help="virtual seconds per fleet tick (ticks sweep the "
                         "diurnal curve)")
    ap.add_argument("--kill", type=int, default=-1,
                    help="inject a replica-0 fault after this many of its "
                         "steps (-1 = no fault)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--mesh", default="",
                    help="mesh spec every replica serves over under "
                         "torchrun, e.g. 'data=2' (default: $REPRO_MESH, "
                         "then the host mesh over the world's ranks)")
    args = ap.parse_args(argv)

    from repro_torch.launch import mesh as meshmod
    meshmod.init_from_env(args.device)
    mesh = meshmod.make_mesh_from_spec(args.mesh)

    cfg = configs.apply_overrides(configs.get_config(args.arch),
                                  reduced=args.reduced)
    regions = tuple(args.regions.split(","))
    max_len = args.prompt_len + args.gen + 8
    fleet = build_fleet(cfg, regions=regions, trace=args.trace,
                        capacity=args.capacity, max_len=max_len,
                        seed=args.seed, ttft_slo_ticks=args.slo_ticks,
                        seconds_per_tick=args.seconds_per_tick,
                        mesh=mesh if mesh.size > 1 else None,
                        device=args.device)
    reqs = poisson_requests(args.requests, args.prompt_len, args.gen,
                            cfg.vocab, seed=args.seed)
    for r in reqs:
        fleet.submit(r)
    if args.kill >= 0:
        fleet.replicas[0].inject_fault(at_step=args.kill)

    comps = []
    with PreemptionGuard() as guard:
        while fleet.busy() and not guard.preempted:
            fleet.step()
        if not guard.preempted:
            comps = fleet.run_until_complete()

    s = fleet.stats()
    joules = [r.carbon_summary()["energy_j"] for r in fleet.replicas]
    joules_max = mesh.all_reduce_max(joules)
    lost = s["lost"]
    if mesh.rank != 0:
        return 0 if not lost else 1
    print(f"[fleet] {len(regions)} replicas on "
          f"{fleet.replicas[0].engine.device}, trace={args.trace}, "
          f"slo={args.slo_ticks:.0f} ticks, kill="
          f"{args.kill if args.kill >= 0 else 'off'}")
    for rs in s["replicas"]:
        c = rs["carbon"]
        print(f"[fleet]   {rs['name']:<12} alive={rs['alive']} "
              f"routed={rs['routed']:3d} done={rs['completed']:3d} "
              f"ci_now={rs['g_per_kwh_now']:6.1f} g/kWh  "
              f"energy={c['energy_j']:8.2f} J  co2e={c['co2e_g']:.3e} g")
    if mesh.size > 1:
        print(f"[fleet] mesh {dict(mesh.shape)}: energy per replica, "
              f"rank 0 " + ", ".join(f"{j:.2f}" for j in joules)
              + " J; max over ranks "
              + ", ".join(f"{j:.2f}" for j in joules_max) + " J")
    # routed share per half of the route log: under a diurnal trace the
    # cleaner region flips, and so should the majority share
    recs = fleet.routes
    half = len(recs) // 2
    for label, part in (("first half", recs[:half]),
                        ("second half", recs[half:])):
        if part:
            share = {n: sum(1 for r in part if r.replica == n) / len(part)
                     for n in sorted({r.replica for r in recs})}
            print(f"[fleet] routed share ({label}): "
                  + "  ".join(f"{k}={v:.2f}" for k, v in share.items()))
    print(f"[fleet] low-carbon share: {s['low_carbon_share']:.2f} "
          f"(fraction routed to the cleanest live region)")
    if comps:
        tt = sorted(ttft_ticks(c) for c in comps)
        p95 = tt[min(int(0.95 * len(tt)), len(tt) - 1)]
        print(f"[fleet] ttft ticks p50={tt[len(tt) // 2]} p95={p95} "
              f"(slo {args.slo_ticks:.0f}: "
              f"{'OK' if p95 <= args.slo_ticks else 'VIOLATED'})")
    t = s["totals"]
    print(f"[fleet] totals: {t['energy_j']:.2f} J, {t['co2e_g']:.3e} gCO2e, "
          f"{t['co2e_g_per_token']:.3e} g/token over {t['tokens']} tokens")
    print(f"[fleet] submitted={s['submitted']} completed={s['completed']} "
          f"requeued={s['requeued']} lost={len(lost)} "
          f"{'(ZERO-LOST OK)' if not lost else f'LOST: {lost}'}")
    return 0 if not lost else 1


if __name__ == "__main__":
    raise SystemExit(main())
