"""Fault-tolerance utilities: preemption handling, straggler detection,
crash-restart supervision.

A fork of the JAX package's `train/fault.py` (plain Python), held equal
to it by `tests/test_torch_fleet.py`.

On a real multi-pod deployment the same hooks attach to the cluster
scheduler's SIGTERM and to cross-host heartbeats; everything here is
process-local and unit-testable, with the coordination points marked.
Both the watchdog and the restart supervisor are clock-injectable —
deterministic tests (and the fleet's virtual-tick clock) supply their
own `clock` / `sleep` instead of touching the wall clock.
"""

from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Callable


class PreemptionGuard:
    """SIGTERM/SIGINT -> set a flag; the step loop checkpoints and exits
    cleanly at the next step boundary (standard TPU-preemption protocol).

    Used as a context manager, the guard holds SIGTERM only inside its
    block and puts the previous handler back on the way out, so a caller
    that runs the loop in its own process (a test, a smoke script) keeps
    its SIGTERM behaviour afterwards."""

    def __init__(self) -> None:
        self._requested = False
        self._installed = False
        self._previous = None

    def install(self) -> None:
        if self._installed:
            return

        def handler(signum, frame):
            self._requested = True

        self._previous = signal.signal(signal.SIGTERM, handler)
        self._installed = True

    def uninstall(self) -> None:
        """Put back the SIGTERM handler that `install` replaced."""
        if not self._installed:
            return
        signal.signal(signal.SIGTERM, self._previous)
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def request(self) -> None:  # for tests / manual triggering
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps (hosts, in multihost) whose duration exceeds
    `factor` x running median.  At fleet scale the mitigation is: log,
    alert, and — when a host trips repeatedly — trigger an elastic restart
    without it (restart path exercised in tests via CheckpointManager).

    `clock` is the timebase for step_start/step_end (default: the wall
    clock).  `fleet.Replica` injects its deterministic virtual-tick
    clock so straggler detection replays bit-identically from a chaos
    seed; tests inject counters."""
    factor: float = 3.0
    window: int = 50
    min_samples: int = 5
    on_straggler: Callable[[int, float, float], None] | None = None
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._durations: list[float] = []
        self.flagged: list[int] = []
        self._t0: float | None = None

    def step_start(self) -> None:
        self._t0 = self.clock()

    def step_end(self, step: int) -> bool:
        assert self._t0 is not None, "step_start not called"
        dur = self.clock() - self._t0
        self._t0 = None
        return self.observe(step, dur)

    def observe(self, step: int, duration: float) -> bool:
        """Duration-injection variant (external timers, the fleet's
        virtual clock, chaos straggler schedules) — no clock reads."""
        is_straggler = False
        if len(self._durations) >= self.min_samples:
            med = statistics.median(self._durations[-self.window:])
            if duration > self.factor * med:
                is_straggler = True
                self.flagged.append(step)
                if self.on_straggler:
                    self.on_straggler(step, duration, med)
        self._durations.append(duration)
        return is_straggler


def run_with_restarts(main: Callable[[int], int], max_restarts: int = 3,
                      sleep: Callable[[float], None] = time.sleep) -> int:
    """Supervisor: re-invoke `main(attempt)` after crashes.  `main` must be
    resumable (checkpoint-based).  Returns its final value.  Backoff is
    linear in the attempt number; `sleep` is injectable so deterministic
    tests (and simulated clocks) observe the backoff without waiting."""
    attempt = 0
    while True:
        try:
            return main(attempt)
        except Exception as e:  # noqa: BLE001 — supervisor boundary
            attempt += 1
            if attempt > max_restarts:
                raise
            print(f"[fault] attempt {attempt}/{max_restarts} restarting "
                  f"after: {type(e).__name__}: {e}")
            sleep(0.1 * attempt)
