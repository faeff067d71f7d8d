"""Linear regression by batch gradient descent.

Reference: ``spartan/examples/linear_reg.py`` (SURVEY.md §2.5, config 3) —
repeated map (prediction error) + reduce (gradient) over the row-tiled
design matrix.  Each step is one fused jitted region: the matvec, residual
map and gradient reduction compile together; the gradient all-reduce is
the `psum` XLA emits from the sharded contraction.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp


def gradient_step(X, y, w, alpha: float):
  """One GD step: ``w - alpha * 2/N * X^T (X w - y)`` (lazy).  The step
  keeps ``w``'s dtype (the contractions may accumulate wider), so it can
  be a ``make_fori`` carry."""
  n = X.shape[0]
  residual = sp.dot(X, w) - y
  grad = sp.dot(X.T, residual) * (2.0 / n)
  return (w - alpha * grad).astype(w.dtype)


def fit(X, y, iterations: int = 50, alpha: float = 0.05):
  """Train; X/y are SpartanArrays, exprs, or numpy arrays."""
  X, y = sp.lazify(X), sp.lazify(y)
  w = sp.zeros((X.shape[1],), dtype=np.float64)
  for _ in range(iterations):
    w = sp.Val(gradient_step(X, y, w, alpha).evaluate())
  return w.evaluate()


def fit_fused(X, y, iterations: int = 50, alpha: float = 0.05):
  """Whole training run in ONE compiled on-device loop (`lax.fori_loop`)
  — no per-step host dispatch.  Semantically identical to :func:`fit`.
  """
  import functools

  import jax
  import jax.numpy as jnp
  from jax import lax

  X = sp.lazify(X).evaluate()
  y = sp.lazify(y).evaluate()
  n, d = X.shape

  @functools.partial(jax.jit, static_argnames=("iters",))
  def run(Xd, yd, iters):
    def body(_, w):
      grad = Xd.T @ (Xd @ w - yd) * (2.0 / n)
      return w - alpha * grad
    return lax.fori_loop(0, iters, body, jnp.zeros((d,), Xd.dtype))

  out = run(X.data, y.data, iterations)
  from spartan_tpu.core.array import SpartanArray
  return SpartanArray(out)


def make_data(n: int = 4096, d: int = 16, seed: int = 0, tile_hint=None):
  rng = np.random.default_rng(seed)
  X = rng.standard_normal((n, d))
  w_true = rng.standard_normal(d)
  y = X @ w_true + 0.01 * rng.standard_normal(n)
  return (sp.from_numpy(X, tile_hint=tile_hint), sp.from_numpy(y), w_true)


def run(n: int = 4096, d: int = 16, iterations: int = 50, alpha: float = 0.05):
  X, y, w_true = make_data(n, d)
  w = fit(X, y, iterations, alpha)
  return w, w_true
