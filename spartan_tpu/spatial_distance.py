"""``sp.spatial.distance`` — the scipy.spatial.distance surface.

Pairwise distances are the canonical matmul workload: ``cdist``/``pdist``
for the inner-product metrics (euclidean/sqeuclidean/cosine/
correlation/mahalanobis) lower to one matmul + rank-1 corrections
(the examples/kmeans pattern); the L1-family
metrics (cityblock/chebyshev/minkowski/canberra/braycurtis/hamming/
jaccard/...) are broadcast reductions XLA tiles without materializing
the (m, n, d) intermediate beyond registers.  ``pdist`` computes the
square form and gathers the static upper triangle (condensed form).
Everything returns lazy Exprs; the vector-pair helpers (``euclidean``,
``cosine``, ...) are the same kernels on 1-D operands.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

import spartan_tpu as sp
from spartan_tpu.special import _f

__all__ = [
    "cdist", "pdist", "squareform", "directed_hausdorff",
    "minkowski", "euclidean", "sqeuclidean", "cosine", "correlation",
    "cityblock", "chebyshev", "canberra", "braycurtis", "hamming",
    "jaccard", "jensenshannon", "rel_entr", "seuclidean",
    "mahalanobis", "russellrao", "rogerstanimoto", "sokalsneath",
    "dice", "yule", "kulczynski1",
    "is_valid_dm", "is_valid_y", "num_obs_dm", "num_obs_y",
]


def _dot(a, b):
  """Pairwise dots at precision='highest': at default precision an f32
  matmul may run reduced-precision passes (TF32 on a GPU) — fine for
  kmeans-style argmins, NOT for a user-facing distance value."""
  return jnp.matmul(a, b, precision="highest")


def _pair_dot(a, b):
  """Matmul form: |a|² + |b|² - 2ab, clamped (cancellation guard)."""
  sq = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
        - 2.0 * _dot(a, b.T))
  return jnp.maximum(sq, 0.0)


def _metric_kern(metric, kw):
  """(m,d),(n,d) -> (m,n) metric kernels (standardized args in kw)."""
  p = kw.get("p", 2.0)
  if metric == "sqeuclidean":
    return lambda a, b, *s: _pair_dot(a, b)
  if metric == "euclidean":
    return lambda a, b, *s: jnp.sqrt(_pair_dot(a, b))
  if metric == "cosine":
    def cos(a, b, *s):
      na = jnp.linalg.norm(a, axis=-1)[:, None]
      nb = jnp.linalg.norm(b, axis=-1)[None, :]
      return 1.0 - _dot(a, b.T) / (na * nb)
    return cos
  if metric == "correlation":
    def corr(a, b, *s):
      a = a - a.mean(-1, keepdims=True)
      b = b - b.mean(-1, keepdims=True)
      na = jnp.linalg.norm(a, axis=-1)[:, None]
      nb = jnp.linalg.norm(b, axis=-1)[None, :]
      return 1.0 - _dot(a, b.T) / (na * nb)
    return corr
  if metric == "mahalanobis":
    def maha(a, b, VI):
      aVI = _dot(a, VI)
      d2 = ((aVI * a).sum(-1)[:, None]
            + ((_dot(b, VI)) * b).sum(-1)[None, :]
            - 2.0 * _dot(aVI, b.T))
      return jnp.sqrt(jnp.maximum(d2, 0.0))
    return maha
  if metric == "seuclidean":
    def seuc(a, b, V):
      iv = 1.0 / V
      d2 = ((a * a * iv).sum(-1)[:, None]
            + (b * b * iv).sum(-1)[None, :]
            - 2.0 * _dot(a * iv, b.T))
      return jnp.sqrt(jnp.maximum(d2, 0.0))
    return seuc
  # broadcast family: reduce over d of f(a[:,None,:], b[None,:,:])
  def bcast(red):
    return lambda a, b, *s: red(a[:, None, :], b[None, :, :])
  if metric == "cityblock":
    return bcast(lambda A, B: jnp.abs(A - B).sum(-1))
  if metric == "chebyshev":
    return bcast(lambda A, B: jnp.abs(A - B).max(-1))
  if metric == "minkowski":
    return bcast(lambda A, B:
                 (jnp.abs(A - B) ** p).sum(-1) ** (1.0 / p))
  if metric == "canberra":
    def canb(A, B):
      num = jnp.abs(A - B)
      den = jnp.abs(A) + jnp.abs(B)
      return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0),
                       0.0).sum(-1)
    return bcast(canb)
  if metric == "braycurtis":
    return bcast(lambda A, B: jnp.abs(A - B).sum(-1)
                 / jnp.abs(A + B).sum(-1))
  if metric == "hamming":
    return bcast(lambda A, B: (A != B).mean(-1))
  if metric == "jaccard":
    def jac(A, B):
      num = _f(((A != B) & ((A != 0) | (B != 0))).sum(-1))
      den = _f(((A != 0) | (B != 0)).sum(-1))
      return jnp.where(den > 0, num / jnp.maximum(den, 1.0), 0.0)
    return bcast(jac)
  if metric == "jensenshannon":
    def js(A, B):
      # scipy normalizes each vector to a distribution first
      P = A / jnp.maximum(A.sum(-1, keepdims=True), 1e-300)
      Q = B / jnp.maximum(B.sum(-1, keepdims=True), 1e-300)
      M = (P + Q) / 2.0
      kl = lambda x, m: jnp.where(
          x > 0, x * (jnp.log(jnp.where(x > 0, x, 1.0))
                      - jnp.log(jnp.where(m > 0, m, 1.0))), 0.0)
      d2 = (kl(P, M) + kl(Q, M)).sum(-1) / 2.0
      return jnp.sqrt(jnp.maximum(d2, 0.0))
    return bcast(js)
  # boolean dissimilarities (ctf/cft/ctt/cff contingency forms)
  def bool_metric(fn):
    def kern(A, B):
      A, B = A != 0, B != 0
      # counts promote through _f (int/int division would land f32)
      ctt = _f((A & B).sum(-1))
      ctf = _f((A & ~B).sum(-1))
      cft = _f((~A & B).sum(-1))
      cff = _f((~A & ~B).sum(-1))
      return fn(ctt, ctf, cft, cff)
    return bcast(kern)
  if metric == "russellrao":
    return bcast(lambda A, B:
                 (A.shape[-1] - _f(((A != 0) & (B != 0)).sum(-1)))
                 / A.shape[-1])
  if metric == "rogerstanimoto":
    return bool_metric(lambda ctt, ctf, cft, cff:
                       2 * (ctf + cft)
                       / (ctt + cff + 2 * (ctf + cft)))
  if metric == "sokalsneath":
    return bool_metric(lambda ctt, ctf, cft, cff:
                       2.0 * (ctf + cft) / (ctt + 2 * (ctf + cft)))
  if metric == "dice":
    return bool_metric(lambda ctt, ctf, cft, cff:
                       (ctf + cft) / (2 * ctt + ctf + cft))
  if metric == "yule":
    def yule_fn(ctt, ctf, cft, cff):
      half = ctf * cft
      return jnp.where(half > 0,
                       2.0 * half / (ctt * cff + half), 0.0)
    return bool_metric(yule_fn)
  if metric == "kulczynski1":
    return bool_metric(lambda ctt, ctf, cft, cff: ctt / (ctf + cft))
  raise ValueError(f"unsupported metric {metric!r} — supported: "
                   "euclidean sqeuclidean cosine correlation "
                   "mahalanobis seuclidean cityblock chebyshev "
                   "minkowski canberra braycurtis hamming jaccard "
                   "jensenshannon russellrao rogerstanimoto "
                   "sokalsneath dice yule kulczynski1")


def _extra_ops(metric, kw, XA):
  if metric == "mahalanobis":
    VI = kw.get("VI")
    if VI is None:
      raise ValueError("mahalanobis needs VI=inv(cov)")
    return [sp.lazify(VI)]
  if metric == "seuclidean":
    V = kw.get("V")
    if V is None:
      raise ValueError("seuclidean needs V (per-feature variances)")
    return [sp.lazify(V)]
  return []


def cdist(XA, XB, metric="euclidean", **kw):
  """Pairwise distances between two collections (lazy, matmul-routed
  for the inner-product metrics)."""
  A, B = sp.lazify(XA), sp.lazify(XB)
  kern = _metric_kern(metric, kw)
  extra = _extra_ops(metric, kw, A)
  return sp.map([A, B] + extra,
                lambda a, b, *s: kern(_f(a), _f(b), *map(_f, s)))


def pdist(X, metric="euclidean", **kw):
  """Condensed pairwise distances (square form + static-triu gather)."""
  A = sp.lazify(X)
  n = A.shape[0]
  iu = np.triu_indices(n, k=1)
  kern = _metric_kern(metric, kw)
  extra = _extra_ops(metric, kw, A)
  return sp.map([A] + extra,
                lambda a, *s: kern(_f(a), _f(a), *map(_f, s))[iu])


def squareform(X, force="no", checks=True):
  """Condensed <-> square conversion (static shapes both ways)."""
  A = sp.lazify(X)
  if len(A.shape) == 1:
    m = A.shape[0]
    n = int(round((1 + np.sqrt(1 + 8 * m)) / 2))
    if n * (n - 1) // 2 != m:
      raise ValueError(f"condensed length {m} is not triangular")
    iu = np.triu_indices(n, k=1)

    def to_square(v):
      out = jnp.zeros((n, n), v.dtype)
      out = out.at[iu].set(v)
      return out + out.T
    return sp.map([A], to_square)
  n = A.shape[0]
  iu = np.triu_indices(n, k=1)
  return sp.map([A], lambda a: a[iu])


def directed_hausdorff(u, v, rng=None):
  """Directed Hausdorff distance (device max-min over the pairwise
  matrix; returns (d, 0, 0) — witness indices need the host path)."""
  U, V = sp.lazify(u), sp.lazify(v)

  def kern(a, b):
    d = jnp.sqrt(_pair_dot(_f(a), _f(b)))
    return d.min(axis=1).max()
  return (sp.map([U, V], kern), 0, 0)


def _vec_metric(metric):
  def op(u, v, *extra, **kw):
    kern = _metric_kern(metric, kw)
    ops = [sp.lazify(u), sp.lazify(v)] + [sp.lazify(e) for e in extra
                                          if e is not None]
    return sp.map(ops, lambda a, b, *s:
                  kern(_f(a)[None, :], _f(b)[None, :],
                       *map(_f, s))[0, 0])
  op.__name__ = metric
  op.__doc__ = f"{metric} distance between two 1-D vectors (lazy)."
  return op


euclidean = _vec_metric("euclidean")
sqeuclidean = _vec_metric("sqeuclidean")
cosine = _vec_metric("cosine")
correlation = _vec_metric("correlation")
cityblock = _vec_metric("cityblock")
chebyshev = _vec_metric("chebyshev")
canberra = _vec_metric("canberra")
braycurtis = _vec_metric("braycurtis")
hamming = _vec_metric("hamming")
jaccard = _vec_metric("jaccard")
russellrao = _vec_metric("russellrao")
rogerstanimoto = _vec_metric("rogerstanimoto")
sokalsneath = _vec_metric("sokalsneath")
dice = _vec_metric("dice")
yule = _vec_metric("yule")
kulczynski1 = _vec_metric("kulczynski1")


def jensenshannon(p, q, base=None, *, axis=0, keepdims=False):
  """Jensen-Shannon distance between two distributions (lazy)."""
  scale = 1.0 if base is None else float(np.log(base))

  def kern(a, b):
    a, b = _f(a), _f(b)
    P = a / jnp.maximum(a.sum(axis, keepdims=True), 1e-300)
    Q = b / jnp.maximum(b.sum(axis, keepdims=True), 1e-300)
    M = (P + Q) / 2.0
    kl = lambda x, m: jnp.where(
        x > 0, x * (jnp.log(jnp.where(x > 0, x, 1.0))
                    - jnp.log(jnp.where(m > 0, m, 1.0))), 0.0)
    d2 = (kl(P, M) + kl(Q, M)).sum(axis, keepdims=keepdims) / 2.0
    return jnp.sqrt(jnp.maximum(d2, 0.0) / scale)
  return sp.map([sp.lazify(p), sp.lazify(q)], kern)


def rel_entr(x, y, out=None):
  """Elementwise relative entropy (re-export of the device
  sp.special kernel; scipy.spatial.distance re-exports it too)."""
  from spartan_tpu.special import rel_entr as _re
  return _re(x, y)


def minkowski(u, v, p=2.0, w=None):
  """Minkowski distance between two 1-D vectors."""
  if w is not None:
    def kern(a, b, ww):
      return ((_f(ww) * jnp.abs(_f(a) - _f(b)) ** p).sum()
              ** (1.0 / p))
    return sp.map([sp.lazify(u), sp.lazify(v), sp.lazify(w)], kern)
  return sp.map([sp.lazify(u), sp.lazify(v)],
                lambda a, b: (jnp.abs(_f(a) - _f(b)) ** p).sum()
                ** (1.0 / p))


def seuclidean(u, v, V):
  """Standardized euclidean between two 1-D vectors."""
  return sp.map([sp.lazify(u), sp.lazify(v), sp.lazify(V)],
                lambda a, b, vv:
                jnp.sqrt(((_f(a) - _f(b)) ** 2 / _f(vv)).sum()))


def mahalanobis(u, v, VI):
  """Mahalanobis distance between two 1-D vectors."""
  def kern(a, b, vi):
    d = _f(a) - _f(b)
    return jnp.sqrt(_dot(_dot(d, _f(vi)), d))
  return sp.map([sp.lazify(u), sp.lazify(v), sp.lazify(VI)], kern)


_HOST_NAMES = ["is_valid_dm", "is_valid_y"]


def is_valid_dm(D, tol=0.0, throw=False, name="D", warning=False):
  """Square distance matrix validity (host check)."""
  import scipy.spatial.distance as _ssd
  return _ssd.is_valid_dm(np.asarray(sp.lazify(D).glom()), tol=tol,
                          throw=throw, name=name, warning=warning)


def is_valid_y(y, warning=False, throw=False, name=None):
  """Condensed distance vector validity (host check)."""
  import scipy.spatial.distance as _ssd
  return _ssd.is_valid_y(np.asarray(sp.lazify(y).glom()),
                         warning=warning, throw=throw, name=name)


def num_obs_dm(d):
  """Observations in a square distance matrix."""
  return sp.lazify(d).shape[0]


def num_obs_y(Y):
  """Observations implied by a condensed distance vector."""
  m = sp.lazify(Y).shape[0]
  n = int(round((1 + np.sqrt(1 + 8 * m)) / 2))
  if n * (n - 1) // 2 != m:
    raise ValueError(f"condensed length {m} is not triangular")
  return n
