"""Blocked Cholesky factorization of a tiled SPD matrix.

Reference: ``spartan/examples/cholesky.py`` (SURVEY.md §2.5 broader demo
set) — the reference's tile-parallel right-looking Cholesky: per
block-column, factor the small diagonal block, solve the panel, and
rank-k-update the trailing submatrix across tiles.  Device shape: the
diagonal factor and triangular inverse are O(b³) on a b×b block (driver-
side numpy, like the reference's single-tile kernels); the panel solve
and the trailing ``A -= P Pᵀ`` update — all the O(n²b) work — run as
sharded ``sp.dot`` + region ``sp.assign`` on the mesh.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp


def factor(A, block: int = 128):
  """Lower-triangular L with ``L @ L.T == A`` (A: SPD, numpy or
  SpartanArray).  Evaluates one block-column per step (the reference's
  per-tile kernel granularity); returns a SpartanArray."""
  A = sp.lazify(A)
  n = A.shape[0]
  work = sp.Val(A.evaluate())      # functional working copy
  out = sp.Val(sp.zeros((n, n), dtype=np.float64).evaluate())
  for j0 in range(0, n, block):
    j1 = min(j0 + block, n)
    # small diagonal block: factor on the driver (reference parity)
    ajj = np.asarray(work[j0:j1, j0:j1].glom())
    ljj = np.linalg.cholesky(ajj)
    linv_t = np.linalg.inv(ljj).T            # (b, b)
    out = sp.assign(out, (slice(j0, j1), slice(j0, j1)), sp.Val(ljj))
    if j1 < n:
      # panel solve: A[j1:, j0:j1] @ L_jj^{-T} — one sharded dot
      panel = sp.dot(work[j1:, j0:j1], sp.Val(linv_t), precision="highest")
      panel = sp.Val(panel.evaluate())
      out = sp.assign(out, (slice(j1, n), slice(j0, j1)), panel)
      # trailing update: the O(n²b) rank-b syrk, tile-parallel on the mesh
      trail = work[j1:, j1:] - sp.dot(panel, panel.T, precision="highest")
      work = sp.Val(sp.assign(work, (slice(j1, n), slice(j1, n)),
                              trail).evaluate())
    out = sp.Val(out.evaluate())
  return out.evaluate()


def run(n: int = 512, block: int = 128, seed: int = 0):
  rng = np.random.default_rng(seed)
  m = rng.standard_normal((n, n))
  A = m @ m.T + n * np.eye(n)
  L = factor(A, block=block)
  err = float(np.abs(np.asarray(L.glom()) - np.linalg.cholesky(A)).max())
  return L, err
