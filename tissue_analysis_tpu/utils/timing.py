"""Structured per-pass timing & profiling.

The reference's only observability is `verbose=True` prints (SURVEY.md §5).
Here every pipeline stage can report wall-clock + voxel throughput into an
active collector, and `profile_trace` wraps `jax.profiler` for device-level
traces.

Usage::

    with timing.collect() as t:
        table = analyze(image)
    print(t.report())          # per-stage wall-clock + Mvox/s

Collection is zero-overhead when inactive (module-level flag check only).
"""

from __future__ import annotations

import contextlib
import os
import dataclasses
import threading
import time
from typing import List, Optional

__all__ = ["Timings", "collect", "stage", "profile_trace"]

_tls = threading.local()


@dataclasses.dataclass
class Stage:
    name: str
    seconds: float
    voxels: Optional[int] = None

    @property
    def mvox_s(self) -> Optional[float]:
        if self.voxels is None or self.seconds <= 0:
            return None
        return self.voxels / self.seconds / 1e6


@dataclasses.dataclass
class Timings:
    stages: List[Stage] = dataclasses.field(default_factory=list)

    def add(self, name: str, seconds: float, voxels: Optional[int] = None):
        self.stages.append(Stage(name, seconds, voxels))

    def total(self) -> float:
        return sum(s.seconds for s in self.stages)

    def report(self) -> str:
        lines = []
        for s in self.stages:
            tp = f"  {s.mvox_s:10.1f} Mvox/s" if s.mvox_s is not None else ""
            lines.append(f"{s.name:<28s} {s.seconds * 1e3:9.2f} ms{tp}")
        lines.append(f"{'total':<28s} {self.total() * 1e3:9.2f} ms")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            s.name: {"seconds": s.seconds, "mvox_s": s.mvox_s}
            for s in self.stages
        }


@contextlib.contextmanager
def collect():
    """Activate a Timings collector for the enclosed scope (per thread)."""
    prev = getattr(_tls, "timings", None)
    t = Timings()
    _tls.timings = t
    try:
        yield t
    finally:
        _tls.timings = prev


@contextlib.contextmanager
def stage(name: str, voxels: Optional[int] = None):
    """Record one pipeline stage into the active collector (no-op if none).

    ``TA_STAGE_VERBOSE=1`` additionally prints a timestamped line as each
    stage enters and leaves — the reference's ``verbose=True`` analogue,
    and a way to see which stage a long first compile is sitting in."""
    # =1 convention: "0"/"false"/empty must NOT enable (ADVICE r4)
    verbose = os.environ.get("TA_STAGE_VERBOSE", "").lower() not in (
        "", "0", "false",
    )
    t: Optional[Timings] = getattr(_tls, "timings", None)
    if t is None and not verbose:
        yield
        return
    if verbose:
        print(time.strftime("[%H:%M:%S]"), "stage:", name, flush=True)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if verbose:
            print(
                time.strftime("[%H:%M:%S]"), f"stage done ({dt:.3f}s):",
                name, flush=True,
            )
        if t is not None:
            t.add(name, dt, voxels)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Device-level `jax.profiler` trace around the enclosed scope."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
