"""Lanczos iteration: extremal eigenvalues of a large symmetric matrix.

Reference: ``spartan/examples/lanczos.py`` (SURVEY.md §2.5 broader demo
set) — repeated distributed matvec + dot-product reductions, with the
tiny tridiagonal eigenproblem solved on the driver.  Device shape: each
``A @ v`` / ``v . w`` is a fused sharded contraction (XLA emits the
cross-shard reduce over the interconnect); the O(k²) recurrence
bookkeeping stays on
the host, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import spartan_tpu as sp


def tridiagonalize(A, k: int = 32, seed: int = 0,
                   full_reorth: bool = True):
  """k-step Lanczos on symmetric A (SpartanArray/expr/numpy).

  Returns (alphas (k,), betas (k-1,), V list of k SpartanArray basis
  vectors).  ``full_reorth`` re-orthogonalizes against the whole basis
  each step (classic Lanczos loses orthogonality in floating point; the
  extra ``V^T w`` matvecs are cheap sharded reductions).
  """
  A = sp.lazify(A)
  n = A.shape[0]
  rng = np.random.default_rng(seed)
  v0 = rng.standard_normal(n)
  v = sp.Val(sp.lazify(v0 / np.linalg.norm(v0)).evaluate())
  v_prev = None
  beta = 0.0
  alphas, betas, basis = [], [], []
  for i in range(k):
    basis.append(v)
    w = sp.dot(A, v, precision="highest")
    if v_prev is not None:
      w = w - beta * v_prev
    alpha = float(sp.dot(w, v, precision="highest").glom())
    w = w - alpha * v
    if full_reorth:
      for u in basis:
        w = w - sp.dot(w, u, precision="highest") * u
      w = sp.Val(w.evaluate())
    alphas.append(alpha)
    if i + 1 == k:
      break
    beta = float(sp.sqrt(sp.dot(w, w)).glom())
    if beta < 1e-14:  # invariant subspace found: exact breakdown
      break
    v_prev = v
    v = sp.Val((w / beta).evaluate())
    betas.append(beta)
  return np.asarray(alphas), np.asarray(betas), basis


def top_eigenvalue(A, k: int = 32, seed: int = 0) -> float:
  """Largest eigenvalue estimate from the k-step Krylov subspace (the
  tridiagonal eigenproblem is k×k — driver-side numpy, as the reference
  did)."""
  alphas, betas, _ = tridiagonalize(A, k=k, seed=seed)
  t = np.diag(alphas)
  if len(betas):
    m = len(alphas)
    t += np.diag(betas[:m - 1], 1) + np.diag(betas[:m - 1], -1)
  return float(np.linalg.eigvalsh(t)[-1])


def run(n: int = 512, k: int = 40, seed: int = 0):
  rng = np.random.default_rng(seed)
  m = rng.standard_normal((n, n))
  A = (m + m.T) / 2.0
  est = top_eigenvalue(A, k=k, seed=seed)
  true = float(np.linalg.eigvalsh(A)[-1])
  return est, true
