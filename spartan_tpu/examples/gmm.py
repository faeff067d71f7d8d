"""Gaussian mixture model (diagonal covariance) via EM — the whole run
in ONE compiled on-device loop.

Reference parity: extends the reference's clustering demos (k-means /
fuzzy k-means — SURVEY.md §2.5) to soft assignments.  Device shape: the
E-step responsibilities and every M-step moment are (n,k)/(n,d) matmuls
on the matrix units; `sp.make_fori` compiles the full EM iteration into a single
XLA program (no per-step dispatch).
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp

_LOG2PI = float(np.log(2.0 * np.pi))


def em_step(X, mu, var, pi, eps: float = 1e-6):
  """One EM step; all ops lazy/sharded.  X (n,d); mu,var (k,d); pi (k,)."""
  n, d = X.shape
  # E-step: log N(x | mu_k, diag var_k) via the expanded quadratic —
  # each term is an (n,d)@(d,k) matmul instead of an (n,k,d) cube
  iv = 1.0 / var                                     # (k,d)
  quad = (sp.dot(X * X, sp.transpose(iv))
          - 2.0 * sp.dot(X, sp.transpose(mu * iv))
          + sp.sum(mu * mu * iv, axis=1))            # (n,k)
  logp = (-0.5 * (quad + sp.sum(sp.log(var), axis=1) + d * _LOG2PI)
          + sp.log(pi))                              # (n,k)
  m = sp.max(logp, axis=1, keepdims=True)
  r = sp.exp(logp - m)
  resp = r / sp.sum(r, axis=1, keepdims=True)        # softmax rows (n,k)
  # M-step: soft-count moments, all matmuls
  nk = sp.sum(resp, axis=0) + eps                    # (k,)
  mu_new = sp.dot(sp.transpose(resp), X) / nk.reshape((pi.shape[0], 1))
  ex2 = sp.dot(sp.transpose(resp), X * X) / nk.reshape((pi.shape[0], 1))
  var_new = sp.maximum(ex2 - mu_new * mu_new, eps)
  pi_new = nk / float(n)
  return mu_new, var_new, pi_new


def fit_fused(X, k: int, iterations: int = 50, seed: int = 0):
  """EM from a farthest-point seeding, one compiled loop."""
  from spartan_tpu.examples import kmeans
  X = sp.lazify(X)
  n, d = X.shape
  mu0 = kmeans.farthest_init(X, k, seed)
  var0 = np.ones((k, d)) * float(np.asarray(sp.var(X, axis=0).glom()).mean())
  pi0 = np.full(k, 1.0 / k)
  run = sp.make_fori(lambda mu, var, pi: em_step(X, mu, var, pi),
                     (sp.Val(mu0), sp.Val(var0), sp.Val(pi0)))
  mu, var, pi = run(iterations)
  return (np.asarray(sp.lazify(mu).glom()), np.asarray(sp.lazify(var).glom()),
          np.asarray(sp.lazify(pi).glom()))


def em_numpy(X, mu, var, pi, iterations, eps: float = 1e-6):
  """Identical EM loop in numpy (the universal oracle)."""
  X = np.asarray(X, np.float64)
  n, d = X.shape
  for _ in range(iterations):
    iv = 1.0 / var
    quad = (X * X) @ iv.T - 2.0 * X @ (mu * iv).T + (mu * mu * iv).sum(1)
    logp = -0.5 * (quad + np.log(var).sum(1) + d * _LOG2PI) + np.log(pi)
    m = logp.max(1, keepdims=True)
    r = np.exp(logp - m)
    resp = r / r.sum(1, keepdims=True)
    nk = resp.sum(0) + eps
    mu = resp.T @ X / nk[:, None]
    var = np.maximum(resp.T @ (X * X) / nk[:, None] - mu * mu, eps)
    pi = nk / n
  return mu, var, pi


def run(n: int = 4096, d: int = 4, k: int = 3, iterations: int = 40,
        seed: int = 0):
  rng = np.random.default_rng(seed)
  true_mu = rng.standard_normal((k, d)) * 5.0
  lab = rng.integers(0, k, n)
  X = true_mu[lab] + rng.standard_normal((n, d))
  mu, var, pi = fit_fused(sp.from_numpy(X), k, iterations, seed=seed)
  # match recovered means to truth (greedy)
  err = 0.0
  used = set()
  for i in range(k):
    j = min((jj for jj in range(k) if jj not in used),
            key=lambda jj: np.abs(mu[i] - true_mu[jj]).max())
    used.add(j)
    err = max(err, float(np.abs(mu[i] - true_mu[j]).max()))
  return err, pi
