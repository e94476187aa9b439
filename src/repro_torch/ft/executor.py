"""Fault-tolerant step execution: retries, straggler deadlines, heartbeats.

The torch package's twin of the JAX package's ``repro/ft/executor.py``
(plain Python, the same defaults and semantics).  One process runs the
steps, so failures are *injected* (tests) through the interfaces a
cluster deployment would use:

* :class:`HeartbeatMonitor` — per-worker last-seen timestamps; a worker is
  declared dead after ``timeout_s`` (the control plane's failure
  detector);
* :class:`StragglerPolicy` — a step's deadline is max(``min_deadline_s``,
  ``multiplier`` x EWMA(step time)); a step past it is counted and
  surfaced to the executor;
* :class:`RetryingExecutor` — runs a step function and classifies its
  failures: a :class:`TransientFailure` is retried with bounded
  exponential backoff, a :class:`WorkerFailure` restores the latest
  checkpoint and replays from it.  The data pipeline is deterministic in
  the step index (batch = f(seed, step)), which makes the replay exact.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


class WorkerFailure(RuntimeError):
    """A (simulated) lost worker: fatal, requires a restore."""


class TransientFailure(RuntimeError):
    """A retryable fault (a preempted collective, a flaky link)."""


class HeartbeatMonitor:
    def __init__(self, n_workers: int, timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: Dict[int, float] = {
            w: clock() for w in range(n_workers)}

    def beat(self, worker: int):
        self._last[worker] = self._clock()

    def dead_workers(self) -> List[int]:
        now = self._clock()
        return [w for w, t in self._last.items()
                if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead_workers()


@dataclasses.dataclass
class StragglerPolicy:
    multiplier: float = 3.0
    min_deadline_s: float = 1.0
    ewma_alpha: float = 0.2
    _ewma: Optional[float] = None

    def deadline(self) -> float:
        if self._ewma is None:
            return float("inf")
        return max(self.min_deadline_s, self.multiplier * self._ewma)

    def observe(self, dt: float) -> bool:
        """Record a step time; True if it was a straggler step."""
        straggled = self._ewma is not None and dt > self.deadline()
        self._ewma = dt if self._ewma is None else (
            self.ewma_alpha * dt + (1 - self.ewma_alpha) * self._ewma)
        return straggled


@dataclasses.dataclass
class ExecutorStats:
    steps: int = 0
    retries: int = 0
    restores: int = 0
    stragglers: int = 0


class RetryingExecutor:
    """Wraps a step function with retry and restore-and-replay semantics.

    ``step_fn(state, step) -> state``.  ``restore_fn(step) -> (state,
    restored_step)`` rewinds to the last checkpoint; the caller replays
    forward from there (the data pipeline and the step's noise are both
    keyed on the step index, so the replay is exact).  ``sleep`` takes the
    backoff's seconds (injectable, as ``HeartbeatMonitor``'s ``clock``).
    """

    def __init__(self, step_fn: Callable, *, max_retries: int = 3,
                 backoff_s: float = 0.05,
                 restore_fn: Optional[Callable] = None,
                 straggler: Optional[StragglerPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.step_fn = step_fn
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.restore_fn = restore_fn
        self.straggler = straggler or StragglerPolicy()
        self.stats = ExecutorStats()
        self._sleep = sleep

    def run_step(self, state, step: int):
        """``(state, step_after)``; ``step_after`` rewinds on a restore."""
        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                out = self.step_fn(state, step)
                dt = time.monotonic() - t0
                if self.straggler.observe(dt):
                    self.stats.stragglers += 1
                self.stats.steps += 1
                return out, step + 1
            except TransientFailure:
                attempt += 1
                self.stats.retries += 1
                if attempt > self.max_retries:
                    raise
                self._sleep(self.backoff_s * (2 ** (attempt - 1)))
            except WorkerFailure:
                if self.restore_fn is None:
                    raise
                self.stats.restores += 1
                state, restored_step = self.restore_fn(step)
                return state, restored_step
