"""Per-step timings for the example workloads (BASELINE configs 3–5) on
the current device, slope-timed (marginal cost per iteration inside one
compiled loop; excludes dispatch constants).

Run: ``python -u tools/bench_examples.py``  → one JSON line per workload.
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np


def _sync(x):
  import jax
  return np.asarray(jax.device_get(x))


def _slope(loop, k_lo=8, k_hi=24, reps=2):
  _sync(loop(k_lo))
  _sync(loop(k_hi))
  tl, th = [], []
  for _ in range(reps):
    t0 = time.perf_counter(); _sync(loop(k_lo)); tl.append(time.perf_counter() - t0)
    t0 = time.perf_counter(); _sync(loop(k_hi)); th.append(time.perf_counter() - t0)
  return (min(th) - min(tl)) / (k_hi - k_lo)


def bench_linreg(n=1 << 20, d=64):
  import jax, jax.numpy as jnp
  from jax import lax
  rng = np.random.default_rng(0)
  X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
  y = jnp.asarray(rng.standard_normal(n).astype(np.float32))

  @jax.jit
  def loop(X, y, k):
    def body(_, w):
      Xb, wb = lax.optimization_barrier((X, w))
      return wb - 0.05 * (Xb.T @ (Xb @ wb - y)) * (2.0 / n)
    return lax.fori_loop(0, k, body, jnp.zeros((d,), jnp.float32))

  s = _slope(lambda k: loop(X, y, k))
  return {"metric": f"linreg step ({n}x{d} f32, config 3)",
          "value": round(s * 1e3, 3), "unit": "ms/step",
          "gflops": round(2 * 2 * n * d / s / 1e9, 1)}


def bench_kmeans(n=1 << 19, d=64, kc=64):
  import jax, jax.numpy as jnp
  from jax import lax
  rng = np.random.default_rng(0)
  P = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
  C0 = jnp.asarray(rng.standard_normal((kc, d)).astype(np.float32))

  @jax.jit
  def loop(P, C0, k):
    def body(_, c):
      Pb, cb = lax.optimization_barrier((P, c))
      dist = (-2.0) * (Pb @ cb.T) + jnp.sum(cb * cb, axis=1)
      lab = jnp.argmin(dist, axis=1)
      # one-hot matmul segment-sum
      oh = (lab[:, None] == jnp.arange(kc, dtype=lab.dtype)[None, :]
            ).astype(Pb.dtype)
      sums = oh.T @ Pb
      counts = jnp.sum(oh, axis=0)
      return sums / jnp.maximum(counts, 1.0)[:, None]
    return lax.fori_loop(0, k, body, C0)

  s = _slope(lambda k: loop(P, C0, k))
  return {"metric": f"kmeans step ({n} pts, d={d}, k={kc}, config 4)",
          "value": round(s * 1e3, 3), "unit": "ms/step"}


def bench_pagerank(n=1 << 20, avg_deg=16):
  import jax, jax.numpy as jnp
  from jax import lax
  rng = np.random.default_rng(0)
  # padded-ELL adjacency, uniform degree
  cols = jnp.asarray(rng.integers(0, n, (n, avg_deg)).astype(np.int32))
  vals = jnp.full((n, avg_deg), 1.0 / avg_deg, jnp.float32)

  @jax.jit
  def loop(cols, vals, k):
    r0 = jnp.full((n,), 1.0 / n, jnp.float32)
    def body(_, r):
      cb, rb = lax.optimization_barrier((cols, r))
      y = jnp.sum(vals * jnp.take(rb, cb, axis=0), axis=1)
      return y * 0.85 + 0.15 / n
    return lax.fori_loop(0, k, body, r0)

  s = _slope(lambda k: loop(cols, vals, k))
  nnz = n * avg_deg
  return {"metric": f"pagerank SpMV step ({n} nodes, {nnz} edges, config 5)",
          "value": round(s * 1e3, 3), "unit": "ms/step",
          "gnnz_per_s": round(nnz / s / 1e9, 2)}


def main():
  import jax
  print(f"device: {jax.devices()[0].device_kind}", file=sys.stderr)
  for fn in (bench_linreg, bench_kmeans, bench_pagerank):
    try:
      print(json.dumps(fn()), flush=True)
    except Exception as e:
      print(json.dumps({"metric": fn.__name__, "error": str(e)[:200]}),
            flush=True)


if __name__ == "__main__":
  main()
