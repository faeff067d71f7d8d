"""Tracing / profiling hooks.

Rebuild of the reference's profiling (reference: flag-gated
cProfile dumps ``--profile_kernels`` / ``--profile_master``, ``util.Timer``
helpers in eval paths; SURVEY.md §5).  Structured device tracing replaces
host cProfile: ``trace()`` wraps ``jax.profiler`` (XPlane/TensorBoard),
``annotate()`` marks named spans visible in the trace, and the evaluator's
per-region counters (compiles / cache hits / wall time / est. bytes) are
surfaced through :func:`region_stats` and the ``profile_kernels`` flag.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

import jax
import numpy as np

from spartan_tpu.util import log_info


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
  """Capture a device profile into ``log_dir`` (TensorBoard XPlane)."""
  jax.profiler.start_trace(log_dir)
  try:
    yield
  finally:
    jax.profiler.stop_trace()
    log_info("profiler trace written to %s", log_dir)


def annotate(name: str):
  """Named span context manager visible in device traces."""
  return jax.profiler.TraceAnnotation(name)


def region_stats() -> Dict[str, Any]:
  """Evaluator counters: compiles, cache hits, evals."""
  from spartan_tpu.backend import evaluator
  return dict(evaluator.stats)


def reset_region_stats() -> None:
  from spartan_tpu.backend import evaluator
  for k in evaluator.stats:
    evaluator.stats[k] = 0


class StepTimer:
  """Per-step wall-clock + bytes-moved accounting for iterative workloads
  (the reference's ``--profile_kernels`` analogue, per jitted region)."""

  def __init__(self):
    self.steps = []

  @contextlib.contextmanager
  def step(self, name: str = "step", bytes_moved: Optional[int] = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    rec = {"name": name, "seconds": dt}
    if bytes_moved is not None:
      rec["gbps"] = bytes_moved / dt / 1e9
    self.steps.append(rec)

  def summary(self) -> Dict[str, Any]:
    if not self.steps:
      return {}
    secs = np.array([s["seconds"] for s in self.steps])
    out = {"count": len(self.steps), "total_s": float(secs.sum()),
           "mean_s": float(secs.mean()), "median_s": float(np.median(secs)),
           "p99_s": float(np.percentile(secs, 99))}
    gbps = [s["gbps"] for s in self.steps if "gbps" in s]
    if gbps:
      out["median_gbps"] = float(np.median(gbps))
    return out


def device_memory_stats() -> Dict[str, Any]:
  """Per-device live memory where the backend exposes it."""
  out = {}
  for d in jax.devices():
    try:
      out[str(d)] = d.memory_stats()
    except Exception:
      out[str(d)] = None
  return out
