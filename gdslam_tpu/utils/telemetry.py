"""Structured per-frame metrics + profiling helpers.

The reference's observability is std::cout prints and ad-hoc chrono timers
(SURVEY §5). Here: JSONL per-frame records (track state, inliers, map sizes,
stage timings) and a `profile` context manager wrapping `jax.profiler.trace`.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics sink."""

    def __init__(self, path: Optional[str] = None):
        self._f = open(path, "a") if path else None
        self.last: dict = {}

    def log(self, **kv) -> None:
        kv.setdefault("t_wall", time.time())
        self.last = kv
        if self._f:
            self._f.write(json.dumps(kv) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def frame_metrics(tracker) -> dict:
    """Snapshot the tracker's per-frame state for logging."""
    return {
        "frame": tracker.frame_id,
        "state": tracker.state.name,
        "inliers": tracker.n_inliers,
        "n_kf": int(tracker.arena.n_kf),
        "n_pt": int(tracker.arena.n_pt),
        "ref_kf": tracker.ref_kf,
    }


@contextlib.contextmanager
def profile(trace_dir: Optional[str]):
    """jax.profiler trace scope; no-op when trace_dir is None."""
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield


class StageTimer:
    """Wall-clock stage timing (the reference's chrono tic/toc, structured)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {k: {"total_s": v, "mean_ms": 1000 * v / self.counts[k]}
                for k, v in self.totals.items()}


def gpu_device() -> dict:
    """The GPU a measurement runs on: JAX's first device (platform, kind,
    device count) and each card's `name, power.limit` as nvidia-smi reports
    them. Raises RuntimeError when JAX's first device is not a GPU — a time
    taken anywhere else is not a time of the card."""
    import subprocess

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {dev} "
                           f"(platform {dev.platform!r})")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "cards": [ln.strip() for ln in out.splitlines() if ln.strip()]}
