"""HardwareTarget: the single description of WHAT the stack runs on.

One frozen value ties the three layers of the repo together:

  * **die**: the per-die `AcceleratorConfig` (the paper's design point) —
    feeds the silicon area model and, through it, per-die Murphy yield;
  * **n_dies**: how many identical dies share the package — feeds the
    multi-die carbon model (`carbon.multi_die_carbon`: per-die yield +
    packaging/bonding overhead) and the dataflow model's inter-die
    communication delay (`dataflow` `n_dies` argument);
  * **mesh_axes**: the serving mesh (name, size) pairs.  By construction
    the "model" axis size equals `n_dies`: one die = one tensor-parallel
    shard, so the carbon model, the analytical delay model, and the
    measured serving engine all describe the same partitioning.

The co-design GA emits targets (`ga.Genome.to_target`); the calibration
layer consumes them (`calibrate.calibrate_serving(target=...)`), and
the serving engine serves on `make_mesh()`: one rank per die on the model
axis, over a `torch.distributed` process group.
"""

from __future__ import annotations

import dataclasses

from . import accelerator as accmod
from . import carbon as carbonmod

#: Mesh axis names the serving stack understands.
MESH_AXIS_NAMES = ("pod", "data", "model")


def parse_mesh_spec(spec: str) -> tuple[tuple[str, int], ...]:
    """Parse a ``"model=4,data=2"``-style mesh spec into (name, size)
    pairs.  Axis names must come from `MESH_AXIS_NAMES`; sizes must be
    positive ints.  The empty string parses to an empty tuple (caller
    falls back to its default mesh)."""
    spec = (spec or "").strip()
    if not spec:
        return ()
    axes = []
    seen = set()
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in MESH_AXIS_NAMES:
            raise ValueError(
                f"unknown mesh axis {name!r} in {spec!r}; "
                f"expected axes from {MESH_AXIS_NAMES}")
        if name in seen:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        seen.add(name)
        try:
            n = int(size)
        except ValueError:
            raise ValueError(f"bad size for mesh axis {name!r} in {spec!r}")
        if n < 1:
            raise ValueError(f"mesh axis {name!r} must be >= 1, got {n}")
        axes.append((name, n))
    # canonical pod -> data -> model order (device-locality convention)
    axes.sort(key=lambda a: MESH_AXIS_NAMES.index(a[0]))
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class HardwareTarget:
    """mesh shape x die count x per-die accelerator config."""
    die: accmod.AcceleratorConfig
    n_dies: int = 1
    mesh_axes: tuple[tuple[str, int], ...] = ()

    def __post_init__(self):
        if self.n_dies < 1:
            raise ValueError(f"n_dies must be >= 1, got {self.n_dies}")
        for name, _ in self.mesh_axes:
            if name not in MESH_AXIS_NAMES:
                raise ValueError(
                    f"unknown mesh axis {name!r}; expected axes from "
                    f"{MESH_AXIS_NAMES}")
        if self.mesh_axes:
            # an absent model axis means size 1, so a typo'd or missing
            # axis cannot silently serve monolithically while the carbon/
            # delay models charge for n_dies
            model = dict(self.mesh_axes).get("model", 1)
            if model != self.n_dies:
                raise ValueError(
                    f"mesh model axis ({model}) must equal n_dies "
                    f"({self.n_dies}): one die == one TP shard")

    # --- construction -----------------------------------------------------

    @classmethod
    def monolithic(cls, die: accmod.AcceleratorConfig,
                   data: int = 1) -> "HardwareTarget":
        return cls(die=die, n_dies=1,
                   mesh_axes=(("data", data), ("model", 1)))

    @classmethod
    def from_mesh_spec(cls, die: accmod.AcceleratorConfig,
                       spec: str) -> "HardwareTarget":
        axes = parse_mesh_spec(spec)
        return cls(die=die, n_dies=dict(axes).get("model", 1),
                   mesh_axes=axes)

    # --- derived hardware quantities --------------------------------------

    @property
    def total_pes(self) -> int:
        return self.die.num_pes * self.n_dies

    @property
    def die_area_mm2(self) -> float:
        return accmod.area_model(self.die).total_mm2

    @property
    def total_area_mm2(self) -> float:
        """Total patterned silicon across dies (excl. interposer)."""
        return self.n_dies * self.die_area_mm2

    def carbon(self, ci_fab: float | None = None
               ) -> carbonmod.MultiDieBreakdown:
        return carbonmod.multi_die_carbon(self.die_area_mm2, self.n_dies,
                                          self.die.node_nm, ci_fab)

    def fps(self, workload: str) -> float:
        """Analytical FPS of the full package (all dies cooperating),
        including inter-die all-gather delay."""
        from . import dataflow as dfmod
        full = dataclasses.replace(
            self.die, pe_cols=self.die.pe_cols * self.n_dies)
        return dfmod.workload_perf(workload, full, self.n_dies).fps

    # --- serving-side surface ---------------------------------------------

    @property
    def tp_degree(self) -> int:
        return dict(self.mesh_axes).get("model", self.n_dies)

    def mesh_spec(self) -> str:
        return ",".join(f"{n}={s}" for n, s in self.mesh_axes)

    def make_mesh(self):
        """The serving mesh of this target (`launch.mesh.Mesh`) over the
        process group's ranks: its axes, or, when it names none, `n_dies`
        ranks on the model axis and the world's other ranks on data (a
        one-die target in a world of two serves data-parallel, as the
        reference's does on a host of two devices).  Lazy import: `core`
        consumers that only want the carbon model never touch
        torch.distributed."""
        from repro_torch.launch import mesh as meshmod
        if not self.mesh_axes:
            return meshmod.make_host_mesh(model=self.n_dies)
        return meshmod.mesh_from_axes(self.mesh_axes)
