"""k-means clustering.

Reference: ``spartan/examples/kmeans.py`` (SURVEY.md §2.5 config 4, §3.5) —
``map_with_location`` distances → argmin labels → scatter-add centroid
update through a shuffle with an add reducer.  Here one lazy step evaluates
as a single fused region: the distance matrix never fully materializes
(XLA fuses it into the argmin), and the scatter-add lowers to the
segment-sum collective pattern.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

import spartan_tpu as sp


def assign_labels(points, centers):
  """Nearest-centroid labels via ||p||² - 2 p·c + ||c||² (the ||p||² term
  is constant per row and dropped)."""
  d = (-2.0) * sp.dot(points, centers.T) + sp.sum(centers * centers, axis=1)
  return sp.argmin(d, axis=1)


def _emit_sums(p, l, coords):
  rows = jnp.broadcast_to(l[:, None], p.shape)
  return (rows, coords[1]), p


def _emit_counts(l, coords):
  return (l,), jnp.ones_like(l, dtype=jnp.result_type(float))


def _onehot(l, k):
  # one-hot via comparison against an iota row: segment sums as a matmul
  classes = jnp.arange(k, dtype=l.dtype)
  return (l[:, None] == classes[None, :]).astype(jnp.result_type(float))


def update_centers(points, labels, k: int, use_matmul: bool = True):
  """Centroid update.  Two formulations, identical results:

  * scatter-add (the reference's shuffle+combiner pattern) — what the
    RPC-era design did per tile;
  * one-hot matmul segment-sum (default): the (n,k) one-hot turns the
    scatter into a dense matmul.
  """
  d = points.shape[1]
  if use_matmul:
    onehot = sp.map([labels], _onehot, fn_kw={"k": k})
    sums = sp.dot(onehot.T, points)
    counts = sp.sum(onehot, axis=0)
  else:
    sums = sp.shuffle([points, labels], _emit_sums, (k, d), np.add)
    counts = sp.shuffle(labels, _emit_counts, (k,), np.add)
  safe = sp.maximum(counts, 1.0)
  # counts accumulate in the reduction dtype (f64 under x64): keep the
  # centers in the points' dtype so a make_fori carry stays stable
  return (sums / sp.expand_dims(safe, 1)).astype(points.dtype)


def fit(points, k: int, iterations: int = 10, centers=None, seed: int = 0):
  points = sp.lazify(points)
  n, d = points.shape
  if centers is None:
    rng = np.random.default_rng(seed)
    centers = sp.from_numpy(
        np.asarray(points.evaluate().glom()[rng.choice(n, k, replace=False)]))
  else:
    centers = sp.lazify(centers)
  labels = None
  for _ in range(iterations):
    labels = assign_labels(points, centers)
    centers = sp.Val(update_centers(points, labels, k).evaluate())
  return centers.evaluate(), labels.evaluate() if labels is not None else None


def farthest_init(points, k: int, seed: int = 0) -> np.ndarray:
  """Farthest-point (k-center greedy) seeding: random first center, then
  repeatedly the point farthest from its nearest chosen center.  Each
  round is one fused sharded distance map + argmax — O(k) small rounds.
  Immune to the random-init empty-cluster fixed point (two random seeds
  in one tight blob can leave a center permanently empty)."""
  points = sp.lazify(points)
  n = points.shape[0]
  rng = np.random.default_rng(seed)
  first = int(rng.integers(0, n))
  chosen = [np.asarray(points[first].glom())]
  for _ in range(k - 1):
    cs = sp.Val(np.stack(chosen))
    d2 = (sp.sum(points * points, axis=1).reshape((n, 1))
          - 2.0 * sp.dot(points, sp.transpose(cs))
          + sp.sum(cs * cs, axis=1))
    nxt = int(sp.argmax(sp.min(d2, axis=1)).glom())
    chosen.append(np.asarray(points[nxt].glom()))
  return np.stack(chosen)


def fit_fused(points, k: int, iterations: int = 10, centers=None,
              seed: int = 0, init: str = "random"):
  """Whole Lloyd iteration in ONE compiled on-device loop (no
  per-step host dispatch; semantics match :func:`fit`).
  ``init='farthest'`` seeds with :func:`farthest_init`."""
  import functools

  import jax
  from jax import lax

  points = sp.lazify(points).evaluate()
  n, d = points.shape
  if centers is None and init == "farthest":
    c0 = farthest_init(sp.Val(points), k, seed)
  elif centers is None:
    rng = np.random.default_rng(seed)
    c0 = np.asarray(points.glom()[rng.choice(n, k, replace=False)])
  else:
    c0 = np.asarray(sp.lazify(centers).glom())

  @functools.partial(jax.jit, static_argnames=("iters",))
  def run(p, c_init, iters):
    def body(_, c):
      dist = (-2.0) * (p @ c.T) + jnp.sum(c * c, axis=1)
      lab = jnp.argmin(dist, axis=1)
      onehot = _onehot(lab, k).astype(p.dtype)   # matmul segment-sum
      sums = onehot.T @ p
      counts = jnp.sum(onehot, axis=0)
      return sums / jnp.maximum(counts, 1.0)[:, None]
    return lax.fori_loop(0, iters, body, c_init)

  out = run(points.data, jnp.asarray(c0, points.dtype), iterations)
  from spartan_tpu.core.array import SpartanArray
  return SpartanArray(out)


def make_data(n: int = 4096, d: int = 8, k: int = 4, seed: int = 0):
  rng = np.random.default_rng(seed)
  true_centers = rng.standard_normal((k, d)) * 6.0
  labels = rng.integers(0, k, n)
  pts = true_centers[labels] + rng.standard_normal((n, d))
  return sp.from_numpy(pts), true_centers


def run(n: int = 4096, d: int = 8, k: int = 4, iterations: int = 10):
  pts, true_centers = make_data(n, d, k)
  centers, labels = fit(pts, k, iterations)
  return centers, labels, true_centers
