"""Tall-skinny QR (TSQR) via CholeskyQR2.

Reference: ``spartan/examples/qr.py`` (SURVEY.md §2.5 broader demo set)
— the reference QR-factorizes row-tiled tall matrices for its SSVD
pipeline.  Device shape: CholeskyQR2 — the communication-optimal TSQR for
accelerators: the only collective work is two d×d Gram matrices
(``XᵀX``, a sharded contraction reduced over the interconnect); the d×d
Cholesky
factors are driver-side numpy, and Q forms as a sharded ``X @ R⁻¹``.
Two rounds square the single-round loss of orthogonality (CholQR2:
‖QᵀQ−I‖ ~ ε instead of ~ ε·κ(X)²).
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp


def _chol_qr_once(X):
  """One CholeskyQR round: returns (Q SpartanArray, R numpy upper)."""
  g = np.asarray(sp.dot(X.T, X, precision="highest").glom())  # (d,d) Gram
  r = np.linalg.cholesky(g).T               # upper-triangular
  q = sp.dot(X, sp.Val(np.linalg.inv(r)), precision="highest")
  return sp.Val(q.evaluate()), r


def tsqr(X):
  """Q (n×d SpartanArray, orthonormal columns) and R (d×d numpy upper)
  with ``Q @ R == X``."""
  X = sp.lazify(X)
  q1, r1 = _chol_qr_once(X)
  q, r2 = _chol_qr_once(q1)
  return q, r2 @ r1


def run(n: int = 1 << 14, d: int = 32, seed: int = 0):
  rng = np.random.default_rng(seed)
  xn = rng.standard_normal((n, d))
  q, r = tsqr(sp.from_numpy(xn))
  qn = np.asarray(q.glom())
  orth_err = float(np.abs(qn.T @ qn - np.eye(d)).max())
  recon_err = float(np.abs(qn @ r - xn).max())
  return orth_err, recon_err
