"""``sp.spatial`` — the scipy.spatial surface.

Device-first design: a k-d tree is a pointer-chasing structure the matrix units
cannot see; on device the speed-of-light neighbor query is the dense
pairwise-distance tile (one bf16/f32 matmul + rank-1 corrections, the
examples/kmeans pattern) followed by an on-chip ``top_k`` / masked
reduction.  ``KDTree``/``cKDTree`` therefore keep the scipy API but
lower every query to that brute-force matmul kernel — ``query`` and
``count_neighbors`` stay entirely on device (top-k / sorted
searchsorted), while the inherently ragged outputs
(``query_ball_point`` lists, ``query_pairs`` sets) compute the
boolean mask on device and extract indices on the host.
``sparse_distance_matrix`` returns the framework's own SparseArray.

Device functions: ``distance_matrix``, ``minkowski_distance(_p)``,
``procrustes`` (SVD Kabsch), ``geometric_slerp``.  Submodules:
``distance`` (matmul cdist/pdist) and ``transform`` (quaternion
Rotation).  Host boundary: the Qhull family (ConvexHull/Delaunay/
Voronoi/...) — sequential exact geometric algorithms scipy owns; they
re-export whole (the SuperLU convention) and accept lazy Exprs via
``__array__``.

Reference parity: the spartan reference has no spatial module;
SURVEY.md §2.5 'broader demo set' motivates the beyond-parity scipy
surfaces.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

import spartan_tpu as sp
from spartan_tpu import spatial_distance as distance  # noqa: F401
from spartan_tpu import spatial_transform as transform  # noqa: F401
from spartan_tpu.spatial_distance import _pair_dot
from spartan_tpu.special import _f
from spartan_tpu.util import log_info

__all__ = [
    "KDTree", "cKDTree", "distance_matrix", "minkowski_distance",
    "minkowski_distance_p", "procrustes", "geometric_slerp",
    "ConvexHull", "Delaunay", "Voronoi", "HalfspaceIntersection",
    "SphericalVoronoi", "QhullError", "Rectangle", "tsearch",
    "distance", "transform",
]

_host_noticed = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info("sp.spatial.%s: ragged/host output — indices extracted on "
           "the host from the device-computed distance mask.", name)


# ---------------------------------------------------------------------
# pairwise minkowski kernel (concrete jnp arrays)
# ---------------------------------------------------------------------

def _pair_minkowski(a, b, p, box=None):
  """(n, d), (m, d) -> (n, m).  p=2 without boxsize rides the matrix units
  (|a|^2+|b|^2-2ab); everything else is the broadcast reduction XLA
  tiles without materializing (n, m, d)."""
  if box is None and p == 2.0:
    return jnp.sqrt(_pair_dot(a, b))
  d = jnp.abs(a[:, None, :] - b[None, :, :])
  if box is not None:
    d = jnp.minimum(d, box - d)
  if np.isinf(p):
    return d.max(-1)
  if p == 1.0:
    return d.sum(-1)
  if p == 2.0:
    return jnp.sqrt((d * d).sum(-1))
  return (d ** p).sum(-1) ** (1.0 / p)


class KDTree:
  """scipy.spatial.KDTree API over brute-force matmul pairwise tiles.

  ``leafsize``/``compact_nodes``/``balanced_tree`` are accepted and
  ignored (there is no tree).  ``boxsize`` (toroidal topology) is
  honored via min-image distances in every kernel."""

  def __init__(self, data, leafsize=10, compact_nodes=True,
               copy_data=False, balanced_tree=True, boxsize=None):
    self.data = sp.lazify(data)
    if len(self.data.shape) != 2:
      raise ValueError("data must be (n, m)")
    self.n, self.m = self.data.shape
    self.leafsize = leafsize
    self.boxsize = None
    if boxsize is not None:
      bs = np.broadcast_to(np.asarray(boxsize, float), (self.m,))
      if (bs <= 0).any():
        raise ValueError("boxsize must be positive")
      self.boxsize = bs.copy()
      # scipy requires data inside the box
      self.data = sp.map([self.data],
                         lambda a, b=jnp.asarray(bs): _f(a) % b)
    self.maxes = sp.map([self.data], lambda a: a.max(0))
    self.mins = sp.map([self.data], lambda a: a.min(0))
    self.size = self.n

  # -- device queries ---------------------------------------------------

  def _dists_to(self, x, p):
    """Lazy (B, n) distance tile from query points to the data."""
    box = None if self.boxsize is None else jnp.asarray(self.boxsize)
    return sp.map([sp.lazify(x), self.data],
                  lambda q, d: _pair_minkowski(
                      jnp.atleast_2d(_f(q)), _f(d), p, box))

  def query(self, x, k=1, eps=0, p=2.0, distance_upper_bound=np.inf,
            workers=1):
    """k nearest neighbors — one device kernel: matmul distance tile +
    lax.top_k.  Returns lazy (d, i); missing neighbors follow the
    scipy convention (d=inf, i=n)."""
    xl = sp.lazify(x)
    if xl.shape[-1:] != (self.m,):
      raise ValueError(f"query points must have {self.m} columns")
    batch_shape = xl.shape[:-1]
    ks = list(k) if np.ndim(k) else list(range(1, int(k) + 1))
    if not ks or min(ks) < 1 or max(ks) > self.n:
      raise ValueError(f"k={k} out of range for n={self.n}")
    kmax = max(ks)
    cols = np.asarray(ks, np.int32) - 1
    n, bound = self.n, float(distance_upper_bound)
    box = None if self.boxsize is None else jnp.asarray(self.boxsize)
    squeeze = np.ndim(k) == 0 and int(k) == 1

    def kern(q, data):
      q2 = jnp.atleast_2d(_f(q)).reshape(-1, data.shape[1])
      D = _pair_minkowski(q2, _f(data), p, box)
      import jax.lax as lax
      negd, idx = lax.top_k(-D, kmax)
      d = -negd
      miss = d > bound
      d = jnp.where(miss, jnp.inf, d)[:, cols]
      i = jnp.where(miss, n, idx)[:, cols]
      out_shape = batch_shape + (len(cols),)
      if squeeze:
        out_shape = batch_shape
        d, i = d[..., 0], i[..., 0]
      return d.reshape(out_shape), i.reshape(out_shape)
    ops = [xl, self.data]
    d = sp.map(ops, lambda *a: kern(*a)[0])
    i = sp.map(ops, lambda *a: kern(*a)[1])
    return d, i

  def count_neighbors(self, other, r, p=2.0, weights=None,
                      cumulative=True):
    """Pair counting — fully on device: sort the flat distance tile
    once, then searchsorted per radius (weighted: cumsum of the
    sorted pair-weight products)."""
    rs = np.atleast_1d(np.asarray(r, float))
    scalar_r = np.ndim(r) == 0
    box = None if self.boxsize is None else jnp.asarray(self.boxsize)
    wa = wb = None
    if weights is not None:
      wa, wb = (weights if isinstance(weights, tuple)
                else (weights, weights))
    ops = [self.data, other.data]
    if wa is not None:
      ops += [sp.lazify(wa), sp.lazify(wb)]

    def kern(a, b, *w):
      D = _pair_minkowski(_f(a), _f(b), p, box).ravel()
      order = jnp.argsort(D)
      Ds = D[order]
      pos = jnp.searchsorted(Ds, jnp.asarray(rs, D.dtype),
                             side="right")
      if w:
        pw = (_f(w[0])[:, None] * _f(w[1])[None, :]).ravel()[order]
        cw = jnp.concatenate([jnp.zeros((1,), pw.dtype),
                              jnp.cumsum(pw)])
        out = cw[pos]
      else:
        out = pos
      if not cumulative:
        out = jnp.diff(out, prepend=jnp.zeros((1,), out.dtype))
      return out[0] if scalar_r else out
    return sp.map(ops, kern)

  def sparse_distance_matrix(self, other, max_distance, p=2.0,
                             output_type="dok_matrix"):
    """Distance pairs within max_distance.  The tile computes on
    device; the ragged extraction is host (variable nnz), returning
    the framework's SparseArray for the matrix output types."""
    _host_notice("KDTree.sparse_distance_matrix")
    box = None if self.boxsize is None else jnp.asarray(self.boxsize)
    D = sp.map([self.data, other.data],
               lambda a, b: _pair_minkowski(_f(a), _f(b), p, box))
    Dv = np.asarray(D.glom())
    i, j = np.nonzero(Dv <= max_distance)
    v = Dv[i, j]
    if output_type == "dict":
      return {(int(a), int(c)): float(x) for a, c, x in zip(i, j, v)}
    if output_type == "ndarray":
      out = np.empty(len(i), dtype=[("i", np.intp), ("j", np.intp),
                                    ("v", np.float64)])
      out["i"], out["j"], out["v"] = i, j, v
      return out
    if output_type in ("dok_matrix", "coo_matrix"):
      return sp.sparse.coo_matrix((v, (i, j)),
                                  shape=(self.n, other.n))
    raise ValueError(f"unknown output_type {output_type!r}")

  # -- ragged host extractions ------------------------------------------

  def query_ball_point(self, x, r, p=2.0, eps=0, workers=1,
                       return_sorted=None, return_length=False):
    xl = sp.lazify(x)
    single = len(xl.shape) == 1
    D = self._dists_to(xl if not single
                       else sp.map([xl], lambda a: a[None]), p)
    rr = np.asarray(r, float)
    mask = sp.map([D], lambda d: d <= jnp.asarray(
        rr if rr.ndim == 0 else rr.reshape(-1, 1), d.dtype))
    if return_length:
      cnt = sp.map([mask], lambda m: m.sum(-1))
      return sp.map([cnt], lambda c: c[0]) if single else cnt
    _host_notice("KDTree.query_ball_point")
    mv = np.asarray(mask.glom())
    lists = [sorted(np.nonzero(row)[0].tolist()) for row in mv]
    if single:
      return lists[0]
    out = np.empty(len(lists), dtype=object)
    out[:] = lists
    return out.reshape(xl.shape[:-1])

  def query_ball_tree(self, other, r, p=2.0, eps=0):
    _host_notice("KDTree.query_ball_tree")
    box = None if self.boxsize is None else jnp.asarray(self.boxsize)
    mask = sp.map([self.data, other.data],
                  lambda a, b: _pair_minkowski(_f(a), _f(b), p, box)
                  <= r)
    mv = np.asarray(mask.glom())
    return [sorted(np.nonzero(row)[0].tolist()) for row in mv]

  def query_pairs(self, r, p=2.0, eps=0, output_type="set"):
    _host_notice("KDTree.query_pairs")
    box = None if self.boxsize is None else jnp.asarray(self.boxsize)

    def kern(a):
      a = _f(a)
      D = _pair_minkowski(a, a, p, box)
      n = D.shape[0]
      triu = jnp.arange(n)[:, None] < jnp.arange(n)[None, :]
      return triu & (D <= r)
    mv = np.asarray(sp.map([self.data], kern).glom())
    i, j = np.nonzero(mv)
    if output_type == "ndarray":
      return np.stack([i, j], axis=1)
    return {(int(a), int(b)) for a, b in zip(i, j)}

  def __reduce__(self):
    return (KDTree, (np.asarray(self.data.glom()), self.leafsize))


class cKDTree(KDTree):
  """Alias of KDTree (scipy's C implementation distinction is
  meaningless here — both lower to the same matmul kernels)."""


def distance_matrix(x, y, p=2.0, threshold=1000000):
  """All pairwise minkowski distances (lazy; threshold is scipy's
  host-memory chunking heuristic — meaningless for XLA, ignored)."""
  X, Y = sp.lazify(x), sp.lazify(y)
  if X.shape[-1] != Y.shape[-1]:
    raise ValueError(f"x ({X.shape}) and y ({Y.shape}) column "
                     "counts differ")
  return sp.map([X, Y],
                lambda a, b: _pair_minkowski(_f(a), _f(b), p))


def minkowski_distance_p(x, y, p=2.0):
  """Componentwise |x-y|^p summed over the last axis (no root)."""
  def kern(a, b):
    d = jnp.abs(_f(a) - _f(b))
    return d.max(-1) if np.isinf(p) else (d ** p).sum(-1)
  return sp.map([sp.lazify(x), sp.lazify(y)], kern)


def minkowski_distance(x, y, p=2.0):
  """L_p distance along the last axis (rowwise, not pairwise)."""
  def kern(a, b):
    d = jnp.abs(_f(a) - _f(b))
    if np.isinf(p):
      return d.max(-1)
    return (d ** p).sum(-1) ** (1.0 / p)
  return sp.map([sp.lazify(x), sp.lazify(y)], kern)


def procrustes(data1, data2):
  """Procrustes analysis (device: standardize + SVD Kabsch).

  Returns (mtx1, mtx2, disparity) as lazy Exprs — mtx2 is the
  standardized data2 rotated/scaled onto mtx1."""
  A, B = sp.lazify(data1), sp.lazify(data2)
  if A.shape != B.shape or len(A.shape) != 2:
    raise ValueError("procrustes operands must be equal-shape (n, m)")

  def standardize(a):
    a = a - a.mean(0, keepdims=True)
    return a / jnp.linalg.norm(a)

  def kern(a, b):
    m1, m2 = standardize(_f(a)), standardize(_f(b))
    # orthogonal_procrustes(m1, m2): svd of m2.T @ m1, transposed
    u, w, vt = jnp.linalg.svd((m2.T @ m1).T)
    R = u @ vt
    s = w.sum()
    m2r = (m2 @ R.T) * s
    disparity = ((m1 - m2r) ** 2).sum()
    return m1, m2r, disparity
  ops = [A, B]
  mtx1 = sp.map(ops, lambda *x: kern(*x)[0])
  mtx2 = sp.map(ops, lambda *x: kern(*x)[1])
  disparity = sp.map(ops, lambda *x: kern(*x)[2])
  return mtx1, mtx2, disparity


def geometric_slerp(start, end, t, tol=1e-7):
  """Spherical linear interpolation between two unit vectors in R^m
  (device kernel; the antipodal validity check is eager — it is a
  scipy ValueError contract on two tiny vectors)."""
  S, E = sp.lazify(start), sp.lazify(end)
  if S.shape != E.shape or len(S.shape) != 1:
    raise ValueError("start/end must be equal-length 1-D")
  sv = np.asarray(S.glom(), float)
  ev = np.asarray(E.glom(), float)
  for name, v in (("start", sv), ("end", ev)):
    if abs(np.linalg.norm(v) - 1.0) > np.sqrt(np.finfo(float).eps):
      raise ValueError(f"{name} must be a unit vector")
  if np.linalg.norm(sv + ev) < float(tol):
    raise ValueError("antipodal vectors: slerp path is undefined")
  T = sp.lazify(t)
  scalar_t = len(T.shape) == 0

  def kern(s, e, tt):
    s, e, tt = _f(s), _f(e), jnp.atleast_1d(_f(tt))
    cosw = jnp.clip((s * e).sum(), -1.0, 1.0)
    w = jnp.arccos(cosw)
    sinw = jnp.sin(w)
    safe = sinw > 1e-12
    denom = jnp.where(safe, sinw, 1.0)
    c0 = jnp.where(safe, jnp.sin((1.0 - tt) * w) / denom, 1.0 - tt)
    c1 = jnp.where(safe, jnp.sin(tt * w) / denom, tt)
    out = c0[:, None] * s[None, :] + c1[:, None] * e[None, :]
    return out[0] if scalar_t else out
  return sp.map([S, E, T], kern)


# ---------------------------------------------------------------------
# host boundary: the Qhull family — sequential exact computational
# geometry (incremental facet insertion); no XLA analog.  Re-exported
# whole (the SuperLU/RK45-driver convention); lazy Exprs ingest via
# Expr.__array__.
# ---------------------------------------------------------------------

from scipy.spatial import (  # noqa: E402
    ConvexHull, Delaunay, HalfspaceIntersection, QhullError,
    Rectangle, SphericalVoronoi, Voronoi, tsearch)

_HOST_NAMES = [
    "ConvexHull", "Delaunay", "HalfspaceIntersection", "QhullError",
    "Rectangle", "SphericalVoronoi", "Voronoi", "tsearch",
]
