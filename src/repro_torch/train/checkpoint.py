"""Async, atomic checkpoints with per-leaf checksums, the counterpart of
the JAX package's `repro.train.checkpoint.CheckpointManager`.

Layout:  <dir>/step_<N>/proc_<k>.npz  +  <dir>/step_<N>/manifest.json

* framework-neutral: `numpy.savez` (uncompressed), one array per leaf,
  keyed by the reference's `jax.tree_util.keystr` of the same state
  ("['params']['layers']['wq']", a `QMoment`'s fields as ".q" and
  ".scale"); bf16 leaves are stored as their uint16 bits, the manifest
  records each leaf's shape, dtype and zlib.crc32 of its bytes;
* atomic: written to `step_<N>.tmp/`, then renamed, so a crash never
  leaves a half checkpoint that restore would pick up;
* verified: restore checks every CRC and shape, and a corrupt or
  truncated checkpoint is skipped for the previous one;
* async: `save(blocking=False)` copies the state to the host on the
  calling thread and writes it on a background thread;
* elastic: under a mesh (`make_train_step`'s ranks) `save` gathers every
  sharded leaf whole on every rank (a collective), rank 0 writes the same
  files one device would, and a blocking save ends at a barrier;
  `restore` reads the whole leaves and keeps each rank's block by the
  current mesh's specs, whatever mesh (or one device) wrote them.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.rules import Attr
from repro_torch.train.optimizer import state_map_with_path

_FORMAT_VERSION = 1


def _keystr(path: tuple) -> str:
    """The JAX package's `keystr` of a `state_map_with_path` path."""
    return "".join(f".{p}" if isinstance(p, Attr) else f"[{p!r}]"
                   for p in path)


def _named_leaves(state: Any) -> list[tuple[str, Any]]:
    """(keystr name, tensor) of every leaf, in the reference's leaf order
    (dict keys sorted, a `QMoment`'s fields in declaration order)."""
    leaves: list = []
    state_map_with_path(lambda path, t: leaves.append((path, t)), state)
    return [(_keystr(path), t) for path, t in
            sorted(leaves, key=lambda x: x[0])]


def leaf_names(state: Any) -> list[str]:
    """The checkpoint's leaf names of `state`, in order."""
    return [name for name, _ in _named_leaves(state)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


#: One process writes everything (rank 0 of a mesh).
_PAYLOAD = "proc_0.npz"


@dataclasses.dataclass
class CheckpointManager:
    directory: str | pathlib.Path
    keep_last: int = 3

    def __post_init__(self):
        self.directory = pathlib.Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def _dir(self, step: int) -> pathlib.Path:
        return self.directory / f"step_{step:08d}"

    # --- save -----------------------------------------------------------
    def save(self, state: Any, step: int, blocking: bool = True, *,
             shardings: Any = None, mesh=None) -> None:
        """Checkpoint `state` (nested dicts of tensors and `QMoment`s) as
        step `step`.  The device-to-host copy happens here; with
        `blocking=False` the write runs on a thread (`wait` joins it).
        Under a `mesh`, `state` is the rank's blocks by `shardings`:
        every rank must call (module docstring)."""
        self.wait()
        sync = mesh is not None and mesh.size > 1
        named = _named_leaves(state)
        specs = dict(_named_leaves(shardings)) if sync else {}
        flat, dtypes = {}, {}
        for name, t in named:   # one leaf whole on the device at a time
            if sync:
                t = mesh.gather_leaf(t, specs[name])
            if not sync or mesh.rank == 0:
                flat[name], dtypes[name] = _to_numpy(t), _dtype_name(t)
        if sync and mesh.rank != 0:
            if blocking:
                dist.barrier()
            return

        def work():
            tmp = self.directory / f"step_{step:08d}.tmp"
            final = self._dir(step)
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / _PAYLOAD, **flat)
            manifest = {
                "step": step, "version": _FORMAT_VERSION, "format": "npz",
                "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k],
                               "crc": zlib.crc32(v.tobytes())}
                           for k, v in flat.items()},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._prune()

        if blocking:
            work()
            if sync:
                dist.barrier()
            return

        def guarded():
            try:
                work()
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join a pending async save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self) -> None:
        for s in self.all_steps()[:-self.keep_last]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # --- restore ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.directory.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read(self, step: int) -> dict[str, torch.Tensor]:
        """Every leaf of step `step` as CPU tensors, checksums verified."""
        d = self._dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        out = {}
        with np.load(d / _PAYLOAD) as z:
            for key, meta in manifest["leaves"].items():
                arr = z[key]
                if zlib.crc32(arr.tobytes()) != meta["crc"] or \
                        list(arr.shape) != meta["shape"]:
                    raise IOError(f"checksum mismatch for {key}")
                out[key] = _from_numpy(arr, meta["dtype"])
        return out

    def restore(self, target: Any, step: int | None = None,
                device: str | torch.device | None = None, *,
                shardings: Any = None, mesh=None) -> tuple[Any, int]:
        """Restore into the structure of `target` (a state of the same
        layout: its leaves give the shapes, dtypes and, unless `device` is
        given, the device) from `step`, or from the newest checkpoint that
        reads back intact.  Under a `mesh`, `target` holds the rank's
        blocks by `shardings` and each leaf read whole keeps that block.
        Returns (state, step)."""
        specs = None if mesh is None else dict(_named_leaves(shardings))
        candidates = self.all_steps() if step is None else [step]
        for s in reversed(candidates):
            try:
                flat = self._read(s)
            except Exception as e:  # corrupt or truncated: try older
                print(f"[checkpoint] step {s} unusable "
                      f"({type(e).__name__}: {e}); trying older")
                continue

            def load(name, leaf):
                if name not in flat:
                    raise KeyError(f"checkpoint missing leaf {name}")
                t = flat[name]
                if specs is not None:
                    t = mesh.block(t, specs[name])
                if tuple(t.shape) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch for {name}: "
                                     f"{tuple(t.shape)} vs "
                                     f"{tuple(leaf.shape)}")
                return t.to(device or leaf.device, leaf.dtype)

            return state_map_with_path(
                lambda path, leaf: load(_keystr(path), leaf), target), s
        raise FileNotFoundError(f"no restorable checkpoint in "
                                f"{self.directory}")
