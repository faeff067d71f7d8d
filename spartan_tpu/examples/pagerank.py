"""PageRank power iteration.

Reference: ``spartan/examples/pagerank.py`` (SURVEY.md §2.5, config 5) —
sparse adjacency tiles, repeated SpMV + renormalize.  Two paths:

* ``fit(...)`` — dense column-stochastic matrix (correctness baseline,
  SURVEY.md §7 "dense-fallback path first");
* ``fit_sparse(...)`` — sparse tiles (:mod:`spartan_tpu.backend.sparse`),
  the SpMV auto-routed to the ELL, block-ELL or densified formulation.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp


def step(M, r, damping: float = 0.85):
  """One power iteration: ``d * M r + (1-d)/n`` (lazy)."""
  n = r.shape[0]
  return sp.dot(M, r) * damping + (1.0 - damping) / n


def fit(M, iterations: int = 30, damping: float = 0.85):
  """Dense power iteration; ``M`` is the column-stochastic link matrix.
  Runs as ONE compiled on-device loop (``sp.fori_loop``) — no per-step
  host dispatch (the reference re-dispatched per-tile kernels every
  iteration)."""
  M = sp.lazify(M)
  n = M.shape[0]
  r0 = sp.ones((n,), dtype=np.float64) / n
  return sp.fori_loop(iterations, lambda r: step(M, r, damping), r0)


def fit_sparse(A_sp, iterations: int = 30, damping: float = 0.85):
  """Sparse power iteration over a SparseArray adjacency (column-stochastic
  already applied) — the framework path: ``spmv_expr`` (which auto-routes
  block-structured matrices to the block-ELL formulation) composed
  with the damping map, compiled once by ``sp.fori_loop``."""
  from spartan_tpu.backend.sparse import spmv_expr

  n = A_sp.shape[0]
  r0 = sp.ones((n,), dtype=A_sp.dtype) / n
  out = sp.fori_loop(
      iterations,
      lambda r: spmv_expr(A_sp, r) * damping + (1.0 - damping) / n, r0)
  return np.asarray(out.glom())


def make_link_matrix(n: int = 256, avg_degree: int = 8, seed: int = 0):
  """Random column-stochastic dense link matrix (dangling nodes patched to
  uniform)."""
  rng = np.random.default_rng(seed)
  A = (rng.random((n, n)) < (avg_degree / n)).astype(np.float64)
  np.fill_diagonal(A, 0.0)
  deg = A.sum(axis=0)
  dangling = deg == 0
  A[:, dangling] = 1.0 / n
  deg = A.sum(axis=0)
  return A / deg


def run(n: int = 256, iterations: int = 30):
  M = make_link_matrix(n)
  r = fit(sp.from_numpy(M), iterations)
  return r, M
