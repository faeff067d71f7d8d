"""``sp.cluster`` — the scipy.cluster surface (vq + hierarchy).

``vq`` is the canonical matmul workload (the examples/kmeans pattern):
``vq``/``py_vq`` assignment is one pairwise-distance matmul + argmin,
``kmeans``/``kmeans2`` run each refinement as a fused ``lax`` loop on
device — distances → argmin → one-hot matmul center update in a
single memory pass per iteration, with
k-means++ and farthest-point device seeding.

``hierarchy`` is the host boundary: agglomerative linkage is an
inherently sequential nearest-pair merge chain (n-1 data-dependent
steps — no batched/SPMD formulation exists at scipy semantics), so
the whole submodule re-exports through the once-per-process-notice
wrapper; the device contribution for big inputs is computing the
condensed distance input with the matrix units (``sp.spatial.distance.pdist``)
before handing the (n²/2)-sized reduction to the host tree builder.

Reference parity: the spartan reference has no cluster module;
SURVEY.md §2.5 'broader demo set' motivates the beyond-parity scipy
surfaces.
"""

from __future__ import annotations

import inspect as _inspect
import types as _types

import jax
import jax.numpy as jnp
import numpy as np

import spartan_tpu as sp
from spartan_tpu.expr.base import Expr
from spartan_tpu.special import _f
from spartan_tpu.util import log_info

__all__ = ["vq", "hierarchy"]

_py_callable = callable


# ---------------------------------------------------------------------
# cluster.vq — device
# ---------------------------------------------------------------------

def _pair_sq(x, c):
  """(n,d),(k,d) -> (n,k) squared distances, matmul-routed."""
  return ((x * x).sum(-1)[:, None] + (c * c).sum(-1)[None, :]
          - 2.0 * jnp.matmul(x, c.T, precision="highest"))


def whiten(obs, check_finite=True):
  """Per-feature unit-variance scaling (lazy)."""
  def kern(o):
    o = _f(o)
    std = o.std(0)
    return o / jnp.where(std > 0, std, 1.0)
  return sp.map([sp.lazify(obs)], kern)


def vq(obs, code_book, check_finite=True):
  """Assign each observation to the nearest code (one matmul pass).

  Returns lazy (codes, dists) — scipy's (code, dist) contract."""
  O, C = sp.lazify(obs), sp.lazify(code_book)

  def kern(o, c):
    d2 = jnp.maximum(_pair_sq(_f(o), _f(c)), 0.0)
    code = jnp.argmin(d2, axis=1)
    # exact distance for the reported minimum (re-sqrt of the gather)
    dist = jnp.sqrt(jnp.take_along_axis(d2, code[:, None], 1)[:, 0])
    return code, dist
  ops = [O, C]
  code = sp.map(ops, lambda *a: kern(*a)[0])
  dist = sp.map(ops, lambda *a: kern(*a)[1])
  return code, dist


_vq_assign = vq  # the function — the global name `vq` becomes the
                 # submodule object below


def py_vq(obs, code_book, check_finite=True):
  """scipy's pure-python reference vq — same device kernel here."""
  return _vq_assign(obs, code_book, check_finite=check_finite)


def _one_refine(x, c):
  """One Lloyd step: assign + one-hot matmul center update (empty
  clusters keep their previous center, scipy semantics)."""
  k = c.shape[0]
  d2 = _pair_sq(x, c)
  lab = jnp.argmin(d2, axis=1)
  hot = jax.nn.one_hot(lab, k, dtype=x.dtype)
  sums = jnp.matmul(hot.T, x, precision="highest")
  cnt = hot.sum(0)
  newc = sums / jnp.maximum(cnt, 1.0)[:, None]
  c = jnp.where((cnt > 0)[:, None], newc, c)
  dist = jnp.sqrt(jnp.maximum(
      jnp.take_along_axis(d2, lab[:, None], 1)[:, 0], 0.0))
  return c, lab, dist.mean()


def kmeans(obs, k_or_guess, iter=20, thresh=1e-5, check_finite=True,
           *, seed=None, rng=None):
  """scipy.cluster.vq.kmeans: best-of-``iter`` restarts, each a fused
  device while_loop on mean-distortion change < thresh.

  Returns (codebook, distortion) as lazy Exprs."""
  O = sp.lazify(obs)
  n, d = O.shape
  if np.ndim(k_or_guess) > 0:
    guesses = [np.asarray(sp.lazify(k_or_guess).glom(), float)]
  else:
    k = int(k_or_guess)
    if k < 1 or k > n:
      raise ValueError(f"k={k} out of range for n={n}")
    g = np.random.default_rng(rng if rng is not None else seed)
    guesses = [np.asarray(O.glom(), float)[
        g.choice(n, size=k, replace=False)] for _ in range(max(1, iter))]
  th = float(thresh)

  def run(o, c0):
    o = _f(o)

    def cond(carry):
      c, prev, cur, it = carry
      return (jnp.abs(prev - cur) > th) & (it < 100)

    def body(carry):
      c, prev, cur, it = carry
      c2, _, dist = _one_refine(o, c)
      return c2, cur, dist, it + 1

    c0 = c0.astype(o.dtype)
    c1, _, d1 = _one_refine(o, c0)
    c, _, dist, _ = jax.lax.while_loop(
        cond, body, (c1, jnp.inf, d1, jnp.asarray(1)))
    return c, dist

  best = None
  for c0 in guesses:
    # c0 as a map OPERAND: all restarts share one compiled region
    # (closure constants would embed per-restart programs — the
    # remote-compile 413 lesson)
    ops = [O, sp.lazify(np.asarray(c0))]
    book = sp.map(ops, lambda o, c: run(o, _f(c))[0])
    dist = sp.map(ops, lambda o, c: run(o, _f(c))[1])
    if best is None:
      best = (book, dist)
    else:
      bb, bd = best
      pick = sp.map([dist, bd], lambda a, b: a < b)
      best = (sp.map([pick, book, bb],
                     lambda p, x, y: jnp.where(p, x, y)),
              sp.map([pick, dist, bd],
                     lambda p, x, y: jnp.where(p, x, y)))
  return best


def kmeans2(data, k, iter=10, thresh=1e-5, minit="random",
            missing="warn", check_finite=True, *, seed=None, rng=None):
  """scipy.cluster.vq.kmeans2: fixed ``iter`` Lloyd refinements in one
  fused fori_loop; device '++'/'points'/'random' seeding.

  Returns (centroids, labels) as lazy Exprs."""
  O = sp.lazify(data)
  if len(O.shape) == 1:
    O = sp.map([O], lambda a: a[:, None])
  n, d = O.shape
  g = np.random.default_rng(rng if rng is not None else seed)
  if np.ndim(k) > 0 or minit == "matrix":
    c0 = np.asarray(sp.lazify(k).glom(), float)
    kk = c0.shape[0]
  else:
    kk = int(k)
    hostX = np.asarray(O.glom(), float)
    if minit == "points":
      c0 = hostX[g.choice(n, size=kk, replace=False)]
    elif minit == "++":
      # k-means++: D²-weighted sequential picks (host RNG, host-side
      # distance updates on the small candidate set)
      c0 = np.empty((kk, d))
      c0[0] = hostX[g.integers(n)]
      d2 = ((hostX - c0[0]) ** 2).sum(1)
      for i in range(1, kk):
        p = d2 / d2.sum()
        c0[i] = hostX[g.choice(n, p=p)]
        d2 = np.minimum(d2, ((hostX - c0[i]) ** 2).sum(1))
    elif minit == "random":
      mu, cov = hostX.mean(0), np.cov(hostX.T)
      if d == 1:
        c0 = g.normal(mu, np.sqrt(cov), size=(kk, 1))
      else:
        c0 = g.multivariate_normal(mu, np.atleast_2d(cov), size=kk)
    else:
      raise ValueError(f"unknown minit {minit!r}")
  iters = int(iter)

  def run(o, c0v):
    o = _f(o)

    def body(_, c):
      return _one_refine(o, c)[0]
    c = jax.lax.fori_loop(0, iters, body, c0v.astype(o.dtype))
    lab = jnp.argmin(_pair_sq(o, c), axis=1)
    return c, lab
  ops = [O, sp.lazify(np.asarray(c0))]
  cent = sp.map(ops, lambda o, c: run(o, _f(c))[0])
  lab = sp.map(ops, lambda o, c: run(o, _f(c))[1])
  return cent, lab


class ClusterError(Exception):
  """scipy.cluster.vq.ClusterError parity."""


# the vq submodule object (scipy idiom: sp.cluster.vq.kmeans); the
# functions above stay importable from this module, and `vq` the name
# becomes the submodule holding them (vq.vq is the assignment fn,
# matching scipy's layout)
vq_mod = _types.ModuleType("spartan_tpu.cluster.vq")
vq_mod.__doc__ = "scipy.cluster.vq surface (device matmul kernels)."
for _n, _o in [("whiten", whiten), ("vq", vq), ("py_vq", py_vq),
               ("kmeans", kmeans), ("kmeans2", kmeans2),
               ("ClusterError", ClusterError)]:
  setattr(vq_mod, _n, _o)
vq = vq_mod
vq.__all__ = ["whiten", "vq", "py_vq", "kmeans", "kmeans2",
              "ClusterError"]


# ---------------------------------------------------------------------
# cluster.hierarchy — host boundary (sequential agglomerative merges)
# ---------------------------------------------------------------------

_host_noticed = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info("sp.cluster.hierarchy.%s: sequential agglomerative "
           "algorithm — runs EAGERLY on the host (scipy), the "
           "sp.linalg.eig convention.", name)


def _host_hier(name):
  import scipy.cluster.hierarchy as _sch
  fn = getattr(_sch, name)

  def op(*args, **kw):
    _host_notice(name)
    conv = [np.array(sp.lazify(a).glom(), copy=True)
            if isinstance(a, (Expr, np.ndarray, list, tuple))
            and not isinstance(a, str) else a for a in args]
    return fn(*conv, **kw)
  op.__name__ = name
  op.__doc__ = (f"scipy.cluster.hierarchy.{name} — host boundary "
                "(eager scipy call with a once-per-process notice; "
                "compute the condensed-distance input on device with "
                "sp.spatial.distance.pdist for large n).")
  return op


hierarchy = _types.ModuleType("spartan_tpu.cluster.hierarchy")
hierarchy.__doc__ = ("scipy.cluster.hierarchy surface — host boundary "
                     "(sequential merge chains).")
_HIER_HOST = []
import scipy.cluster.hierarchy as _sch  # noqa: E402
for _n in dir(_sch):
  if _n.startswith("_") or _n == "test":  # scipy's bundled test runner
    continue
  _obj = getattr(_sch, _n)
  if _inspect.ismodule(_obj):
    continue
  if _inspect.isclass(_obj):
    setattr(hierarchy, _n, _obj)      # ClusterNode, DisjointSet, ...
    _HIER_HOST.append(_n)
  elif _py_callable(_obj):
    setattr(hierarchy, _n, _host_hier(_n))
    _HIER_HOST.append(_n)
hierarchy._HOST_NAMES = sorted(_HIER_HOST)
hierarchy.__all__ = sorted(_HIER_HOST)
del _sch, _n, _obj
