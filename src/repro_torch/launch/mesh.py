"""The port's device mesh: named axes over the ranks of a
`torch.distributed` process group, one process per rank.

A `Mesh` has named dims ("data", "model", and "pod" or a pipeline's
"stage" where asked), the size of each, this rank's coordinate on each,
and one process group per axis (the ranks that differ only along it).
Ranks are laid out row-major over (stage, pod, data, model): the ranks
of a model group are consecutive.
The sharding rules (`sharding/rules.py`) read only `shape` and
`axis_names`, so `make_abstract_mesh` gives them a mesh with no group.

The serving and calibration entry points accept a ``model=2,data=2``
spec (or $REPRO_MESH); `make_mesh_from_spec` resolves it (argument >
$REPRO_MESH > the host default) and checks the axis product against the
process group's world size.  A world is launched with `torchrun
--nproc-per-node N` (the CLIs call `init_from_env`), or from Python with
`spawn`.

Backend: gloo on the CPU, and wherever ranks share a CUDA device (NCCL
refuses two ranks on one device); NCCL only where each rank of a host has
a device of its own, a layout no machine of this project's has tested.

Collectives are methods of the mesh, each counting its calls, bytes
moved and host seconds per kind (`calls`, `bytes`, `seconds`; `gathers`
and `collective_s` are the all-gather count and the total seconds the
serving engines read):

* `all_gather` concatenates the ranks' blocks along a dim (counted per
  axis too, `gathers_on`: the serving engines report the model axis's
  and the data axes' apart); under
  autograd its backward hands each rank its block of the incoming
  gradient (every op after a gather runs alike on each rank of the
  axis, so each holds the same whole gradient);
* `all_reduce` sums over one axis or a tuple of axes (the train step's
  gradients over (pod, data));
* `gather_leaf` / `block` turn a leaf sharded by a spec (`sharding.rules`)
  into the whole tensor and back;
* `ppermute` sends each rank's tensor to its partner along an axis, as
  `lax.ppermute` does (ranks with no source get zeros).

Gloo gathers and reduces CUDA tensors itself (it stages them through
host memory inside the collective; an H100's ranks were seen to take
that path), so those helpers hand it the device tensors.  Its
point-to-point send and receive are CPU-only (torch.distributed's
backend table), so `ppermute` under gloo always stages a device tensor
through host memory explicitly.  There is no reduce-scatter: gloo has
none, and the train step all-reduces and keeps the rank's block.
Nothing falls back to one device or the CPU when a group or a
collective fails: the error propagates.

`make_production_mesh` (the JAX package's 256/512-chip pod layouts)
waits for the dry run.
"""

from __future__ import annotations

import datetime
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.target import MESH_AXIS_NAMES, parse_mesh_spec

MESH_ENV_VAR = "REPRO_MESH"
#: The mesh's axes, outermost first: a pipeline's "stage" axis leads the
#: serving target's (`core.target.MESH_AXIS_NAMES`).  A stage axis is a
#: mesh axis, not a die layout, so `HardwareTarget` never names one.
AXIS_NAMES = ("stage", *MESH_AXIS_NAMES)


def parse_spec(spec: str | None) -> tuple[tuple[str, int], ...]:
    """(name, size) pairs of a ``"stage=4"`` or ``"model=2,data=2"`` spec:
    `core.target.parse_mesh_spec`'s grammar plus a leading stage axis."""
    parts = [p for p in (spec or "").split(",") if p.strip()]
    stage = [p for p in parts if p.partition("=")[0].strip() == "stage"]
    axes = parse_mesh_spec(",".join(p for p in parts if p not in stage))
    if len(stage) > 1:
        raise ValueError(f"duplicate mesh axis 'stage' in {spec!r}")
    if stage:
        try:
            n = int(stage[0].partition("=")[2])
        except ValueError:
            raise ValueError(f"bad size for mesh axis 'stage' in {spec!r}")
        if n < 1:
            raise ValueError(f"mesh axis 'stage' must be >= 1, got {n}")
        axes = (("stage", n), *axes)
    return axes


def _world() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class _AllGather(torch.autograd.Function):
    """`Mesh.all_gather` under autograd: the backward keeps this rank's
    block of the whole gradient (module docstring)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.block = (mesh.axis_index(axis), x.shape[dim], dim)
        return mesh._gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i, width, dim = ctx.block
        return g.narrow(dim, i * width, width), None, None, None


#: the kinds of collective a mesh counts
KINDS = ("all_gather", "all_reduce", "ppermute")


class Mesh:
    """Named axes over the ranks of the default process group (module
    docstring).  `groups` maps each axis of size > 1 to its process group;
    an abstract mesh has none and serves only the sharding rules."""

    def __init__(self, axes: tuple[tuple[str, int], ...], *, rank: int = 0,
                 groups: dict | None = None, backend: str = "",
                 device: torch.device | None = None):
        self.axis_names = tuple(n for n, _ in axes)
        self.shape = dict(axes)
        self.size = math.prod(self.shape.values())
        self.rank = rank
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        self.coords = {n: int(i) for n, i in zip(self.axis_names, idx)}
        self.groups = groups or {}
        self.backend = backend
        self.device = device
        self.reset_counts()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def reset_counts(self) -> None:
        """Zero the collectives' calls, bytes and host seconds."""
        self.calls = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)
        self.seconds = dict.fromkeys(KINDS, 0.0)
        #: all-gathers and their host seconds per axis
        self.axis_gathers: dict[str, int] = {}
        self.axis_gather_s: dict[str, float] = {}

    @property
    def gathers(self) -> int:
        """All-gathers run (the serving engines' count)."""
        return self.calls["all_gather"]

    @property
    def collective_s(self) -> float:
        """Host seconds in every collective."""
        return sum(self.seconds.values())

    def gathers_on(self, axes) -> tuple[int, float]:
        """(all-gathers, their host seconds) over `axes` (an axis name or
        a tuple of them): the serving engines' count per axis."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return (sum(self.axis_gathers.get(a, 0) for a in axes),
                sum(self.axis_gather_s.get(a, 0.0) for a in axes))

    def _count(self, kind: str, nbytes: int, t0: float) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += int(nbytes)
        self.seconds[kind] += time.perf_counter() - t0

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def shard_cols(self, x: torch.Tensor, axis: str = "model"
                   ) -> torch.Tensor:
        """This rank's block of x's last dim over `axis` (a view)."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        width = x.shape[-1] // n
        return x.narrow(-1, self.axis_index(axis) * width, width)

    def all_gather(self, x: torch.Tensor, axis: str = "model",
                   dim: int = -1) -> torch.Tensor:
        """Concatenate every rank's `x` along `dim`, in the axis's rank
        order (the blocks `shard_cols` hands out); differentiable."""
        if self.axis_size(axis) == 1:
            return x
        return _AllGather.apply(x, self, axis, dim % x.ndim)

    def _gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        n = self.axis_size(axis)
        t0 = time.perf_counter()
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.groups[axis])
        out = torch.cat(parts, dim=dim)
        self._count("all_gather", src.numel() * src.element_size() * n, t0)
        self.axis_gathers[axis] = self.axis_gathers.get(axis, 0) + 1
        self.axis_gather_s[axis] = (self.axis_gather_s.get(axis, 0.0)
                                    + time.perf_counter() - t0)
        return out

    def all_reduce(self, x: torch.Tensor, axes="data") -> torch.Tensor:
        """The sum of every rank's `x` over `axes` (an axis name or a
        tuple of them), a new tensor; `x` is left as it was."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if self.axis_size(a) > 1)
        if not axes:
            return x
        out = x.detach().clone(memory_format=torch.contiguous_format)
        for axis in axes:
            t0 = time.perf_counter()
            dist.all_reduce(out, group=self.groups[axis])
            self._count("all_reduce", out.numel() * out.element_size(), t0)
        return out

    def _spec_axes(self, spec, ndim: int):
        """(dim, axes along it, innermost first) of every dim `spec`
        shards over an axis of size > 1."""
        for dim, ax in enumerate(tuple(spec)[:ndim]):
            names = () if ax is None else (
                (ax,) if isinstance(ax, str) else tuple(ax))
            names = tuple(a for a in names if self.axis_size(a) > 1)
            if names:
                yield dim, names[::-1]

    def block(self, x: torch.Tensor, spec, copy: bool = True
              ) -> torch.Tensor:
        """This rank's block of a whole tensor under `spec` (a copy, or a
        view with `copy` False): a dim sharded over a tuple of axes splits
        row-major over them."""
        for dim, names in self._spec_axes(spec, x.ndim):
            for axis in names[::-1]:
                n = self.axis_size(axis)
                width = x.shape[dim] // n
                x = x.narrow(dim, self.axis_index(axis) * width, width)
        return x.clone() if copy else x

    def gather_leaf(self, x: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor from every rank's block under `spec` (the
        inverse of `block`)."""
        for dim, names in self._spec_axes(spec, x.ndim):
            for axis in names:
                x = self._gather(x, axis, dim)
        return x

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """`lax.ppermute` over `axis`: the rank at index i sends `x` to
        index j for each (i, j) of `perm`; a rank receives its source's
        tensor, or zeros where no pair names it.  Under gloo a device
        tensor goes through host memory (module docstring)."""
        n = self.axis_size(axis)
        me = self.axis_index(axis)
        dst = [j for i, j in perm if i == me]
        src = [i for i, j in perm if j == me]
        if n == 1:
            return x.clone() if src else torch.zeros_like(x)
        t0 = time.perf_counter()
        group = self.groups[axis]
        staged = self.backend == "gloo" and x.device.type != "cpu"
        send = x.detach().contiguous()
        if staged:
            send = send.cpu()
        recv = torch.zeros_like(send)
        ops = [dist.P2POp(dist.isend, send,
                          dist.get_global_rank(group, j), group)
               for j in dst]
        ops += [dist.P2POp(dist.irecv, recv,
                           dist.get_global_rank(group, i), group)
                for i in src]
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        self._count("ppermute", send.numel() * send.element_size() *
                    len(dst), t0)
        return recv.to(x.device) if staged else recv

    def all_reduce_max(self, values) -> list[float]:
        """Elementwise max of a list of floats over every rank of the
        mesh (a CPU tensor under gloo, the rank's device under NCCL)."""
        vals = [float(v) for v in values]
        if self.size == 1:
            return vals
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor(vals, dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.cpu().tolist()


def make_abstract_mesh(sizes, names) -> Mesh:
    """A mesh of the given axis sizes with no process group: the sharding
    rules' shapes."""
    return Mesh(tuple(zip(names, (int(s) for s in sizes))))


_MESHES: dict = {}


def mesh_from_axes(axes: tuple[tuple[str, int], ...]) -> Mesh:
    """Concrete mesh from parsed (name, size) pairs over the default
    process group; always carries a "data" and a "model" axis (size 1
    filled in).  Unknown axis names raise, and so does an axis product
    other than the group's world size.  Every rank must call it with the
    same axes (it creates the axis groups, a collective act)."""
    for name, _ in axes:
        if name not in AXIS_NAMES:
            raise ValueError(f"unknown mesh axis {name!r}; expected axes "
                             f"from {AXIS_NAMES}")
    d = dict(axes)
    d.setdefault("data", 1)
    d.setdefault("model", 1)
    names = tuple(n for n in AXIS_NAMES if n in d)
    full = tuple((n, int(d[n])) for n in names)
    need = math.prod(s for _, s in full)
    world, rank = _world()
    if need != world:
        raise ValueError(
            f"mesh {dict(full)} spans {need} ranks but the process group "
            f"has {world} (launch one process per rank: torchrun "
            f"--nproc-per-node {need} ..., or "
            f"repro_torch.launch.mesh.spawn(fn, spec))")
    if need == 1:
        return Mesh(full)
    key = (full, id(dist.group.WORLD))
    if key not in _MESHES:
        sizes = tuple(s for _, s in full)
        grid = np.arange(need).reshape(sizes)
        groups = {}
        for ax, (name, size) in enumerate(full):
            if size == 1:
                continue
            lines = np.moveaxis(grid, ax, -1).reshape(-1, size)
            for line in lines:   # every rank creates every group, in order
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
        _MESHES[key] = groups
    return Mesh(full, rank=rank, groups=_MESHES[key],
                backend=dist.get_backend(), device=_rank_device())


#: the device `init_group` pinned this rank to (None: a group made
#: elsewhere, whose ranks take the current CUDA device where there is one)
_GROUP_DEVICE: torch.device | None = None


def _rank_device() -> torch.device:
    if _GROUP_DEVICE is not None:
        return _GROUP_DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_host_mesh(model: int | None = None) -> Mesh:
    """A mesh over the process group's ranks: `model` of them on the model
    axis (default 2 where the world is even and larger than 1), the rest
    on data."""
    n, _ = _world()
    model = model or (2 if n % 2 == 0 and n > 1 else 1)
    return mesh_from_axes((("data", max(n // model, 1)), ("model", model)))


def make_mesh_from_spec(spec: str | None = None) -> Mesh:
    """Mesh from a ``"model=4,data=2"`` spec (or one with a ``stage``
    axis, `parse_spec`); precedence is the explicit
    argument, then $REPRO_MESH, then the host-mesh default."""
    spec = spec if spec not in (None, "") else os.environ.get(
        MESH_ENV_VAR, "")
    axes = parse_spec(spec)
    if not axes:
        return make_host_mesh()
    return mesh_from_axes(axes)


# --- process groups ---------------------------------------------------------------

def backend_for(device: torch.device | str, local_world: int) -> str:
    """gloo, unless each of the host's `local_world` ranks has a CUDA
    device of its own (then NCCL)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world > 1:
        return "nccl"
    return "gloo"


def init_group(rank: int, world: int, device: torch.device | str, *,
               store=None, timeout_s: float = 600.0,
               local_rank: int | None = None,
               local_world: int | None = None) -> None:
    """Join the default process group as `rank` of `world` (through
    `store`, or the torchrun environment when None), after pinning the
    rank's device: cuda:(local rank % device_count) for a CUDA device
    (and its share of the host's CPU threads), one CPU thread for the CPU
    (ranks share the host's cores)."""
    global _GROUP_DEVICE
    dev = torch.device(device)
    local = local_world or world
    if dev.type == "cuda":
        local_rank = rank if local_rank is None else local_rank
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        # the host's cores, shared among the host's ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
    else:
        torch.set_num_threads(1)
    kw = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        kw |= {"store": store, "rank": rank, "world_size": world}
    dist.init_process_group(backend_for(dev, local), **kw)
    _GROUP_DEVICE = dev


def init_from_env(device: str | torch.device | None = None) -> bool:
    """Under torchrun ($WORLD_SIZE > 1), join its process group on
    `device` (None: the card, raising when there is none, as every entry
    point does); True when a group is up."""
    from repro_torch.device import resolve_device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        return True
    if world <= 1:
        return False
    rank = int(os.environ["RANK"])
    init_group(rank, world, resolve_device(device),
               local_rank=int(os.environ.get("LOCAL_RANK", rank)),
               local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    return True


def _to_host(obj: Any) -> Any:
    """Tensors (nested in dicts, lists, tuples) to numpy arrays."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, world: int, store_path: str, spec: str,
               device: str, timeout_s: float, fn, args, results) -> None:
    try:
        store = dist.FileStore(store_path, world)
        init_group(rank, world, device, store=store, timeout_s=timeout_s)
        out = fn(make_mesh_from_spec(spec), *args)
        results.put((rank, True, _to_host(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, spec: str, *,
          device: str | torch.device | None = None,
          timeout_s: float = 300.0, args: tuple = ()) -> list:
    """Run `fn(mesh, *args)` on every rank of the mesh `spec` names, one
    process per rank, and return the ranks' results in rank order
    (tensors come back as numpy arrays).  `device` None is the card, as
    for every entry point (resolved here, so that a host without one
    raises before any rank starts); rank r of a CUDA world runs on
    cuda:(r % device_count), and "cpu" runs the ranks on the CPU.

    Ranks start by the `spawn` method (CUDA cannot fork) and meet at a
    `FileStore` in a temporary directory (no ports, so concurrent worlds
    cannot clash); the group and the whole call have `timeout_s`.  A rank
    that raises or dies, or a deadline that passes, kills every rank and
    raises `RuntimeError`.  `fn` must be importable by name (a module's
    top-level function)."""
    import multiprocessing as mp

    from repro_torch.device import resolve_device
    device = resolve_device(device).type
    world = math.prod(s for _, s in parse_spec(spec)) or 1
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, world, os.path.join(tmp, "store"), spec, device,
              timeout_s, fn, args, results)) for r in range(world)]
    deadline = time.monotonic() + timeout_s * 1.1 + 2.0
    out: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"spawn({spec!r}): ranks "
                    f"{sorted(set(range(world)) - set(out))} did not "
                    f"finish within {timeout_s:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn({spec!r}): rank(s) exited "
                                       f"without a result: {dead}")
                continue
            if not ok:
                raise RuntimeError(f"spawn({spec!r}): rank {rank} raised:\n"
                                   f"{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
