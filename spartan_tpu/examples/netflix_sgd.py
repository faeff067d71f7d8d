"""Netflix-style matrix factorization by minibatch SGD.

Reference: the netflix SGD example (SURVEY.md §2.5) — rating triples
scattered over tiles, per-rating factor updates.  Redesign for XLA: a
whole minibatch of (user, item, rating) triples updates U and V in one
fused region per step — gathers of the touched factor rows, vectorized
gradient, scatter-add back (the reference's per-rating Python loop becomes
one XLA scatter).
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp
from spartan_tpu.expr.write import ScatterAssignExpr


def _scatter_rows_matmul(dst, idx, updates, n_rows: int):
  """``dst.at[idx].add(updates)`` as a one-hot matmul (matmul segment-sum;
 an XLA
  scatter-add alternative)."""
  import jax.numpy as jnp

  def _oh(l, n):
    return (l[:, None] == jnp.arange(n, dtype=l.dtype)[None, :]).astype(
        jnp.result_type(float))

  onehot = sp.map([idx], _oh, fn_kw={"n": n_rows})       # (B, n_rows)
  return dst + sp.dot(onehot.T, updates)


def sgd_step(U, V, users, items, ratings, lr: float = 0.05,
             reg: float = 0.02, use_matmul: bool = True):
  """One vectorized SGD step over a batch of rating triples (lazy).

  The factor scatter-back defaults to the one-hot matmul segment-sum;
  ``use_matmul=False`` keeps the XLA scatter-add (identical results —
  duplicate indices accumulate in both)."""
  Uu = U[users]                       # (B, k) gather
  Vi = V[items]
  pred = sp.sum(Uu * Vi, axis=1)
  err = sp.expand_dims(pred - ratings, 1)       # (B, 1)
  gU = err * Vi + reg * Uu
  gV = err * Uu + reg * Vi
  if use_matmul:
    U2 = _scatter_rows_matmul(U, users, (-lr) * gU, U.shape[0])
    V2 = _scatter_rows_matmul(V, items, (-lr) * gV, V.shape[0])
  else:
    U2 = ScatterAssignExpr(U, users, (-lr) * gU, reducer=np.add)
    V2 = ScatterAssignExpr(V, items, (-lr) * gV, reducer=np.add)
  return U2, V2


def fit(users, items, ratings, n_users: int, n_items: int, k: int = 8,
        epochs: int = 10, batch: int = 1024, lr: float = 0.05,
        reg: float = 0.02, seed: int = 0):
  rng = np.random.default_rng(seed)
  # factor matrices are small relative to the batch: replicate them (one
  # big tile) so per-batch row gathers don't force an SPMD reshard of U/V
  U = sp.from_numpy(rng.standard_normal((n_users, k)) * 0.1,
                    tile_hint=(n_users, k))
  V = sp.from_numpy(rng.standard_normal((n_items, k)) * 0.1,
                    tile_hint=(n_items, k))
  users = np.asarray(users)
  items = np.asarray(items)
  ratings = np.asarray(ratings, dtype=np.float64)
  n = users.shape[0]
  for _ in range(epochs):
    order = rng.permutation(n)
    for s in range(0, n - batch + 1, batch):
      sel = order[s:s + batch]
      u2, v2 = sgd_step(sp.lazify(U), sp.lazify(V),
                        sp.from_numpy(users[sel]),
                        sp.from_numpy(items[sel]),
                        sp.from_numpy(ratings[sel]), lr, reg)
      out = sp.evaluate(sp.ListExpr([u2, v2]))
      U, V = out[0], out[1]
  return U, V


def fit_compiled(users, items, ratings, n_users: int, n_items: int,
                 k: int = 8, epochs: int = 10, batch: int = 1024,
                 lr: float = 0.05, reg: float = 0.02, seed: int = 0):
  """Serving-style training: the SGD step is compiled ONCE via
  ``sp.compile`` and every minibatch streams through the same runner —
  removes per-batch DAG construction/evaluation overhead (the python
  loop's only remaining cost is the jitted dispatch)."""
  rng = np.random.default_rng(seed)
  U0 = rng.standard_normal((n_users, k)) * 0.1
  V0 = rng.standard_normal((n_items, k)) * 0.1
  users = np.asarray(users)
  items = np.asarray(items)
  ratings = np.asarray(ratings, dtype=np.float64)

  # template leaves define the compiled step's signature (factors
  # replicated — see fit())
  Ut = sp.from_numpy(U0, tile_hint=(n_users, k))
  Vt = sp.from_numpy(V0, tile_hint=(n_items, k))
  ut = sp.from_numpy(users[:batch])
  it_ = sp.from_numpy(items[:batch])
  rt = sp.from_numpy(ratings[:batch])
  u2, v2 = sgd_step(Ut, Vt, ut, it_, rt, lr, reg)
  step = sp.compile(sp.ListExpr([u2, v2]), wrt=[Ut, Vt, ut, it_, rt])

  U, V = U0, V0
  n = users.shape[0]
  for _ in range(epochs):
    order = rng.permutation(n)
    for s in range(0, n - batch + 1, batch):
      sel = order[s:s + batch]
      out = step(U, V, users[sel], items[sel], ratings[sel])
      U, V = out[0], out[1]
  return U, V


def rmse(U, V, users, items, ratings):
  Uu = sp.lazify(U)[sp.from_numpy(np.asarray(users))]
  Vi = sp.lazify(V)[sp.from_numpy(np.asarray(items))]
  pred = sp.sum(Uu * Vi, axis=1)
  err = pred - sp.from_numpy(np.asarray(ratings, dtype=np.float64))
  return float(sp.sqrt(sp.mean(err * err)).glom())


def run(n_users: int = 256, n_items: int = 128, k: int = 6,
        n_ratings: int = 8192, epochs: int = 5, seed: int = 0):
  rng = np.random.default_rng(seed)
  U0 = rng.standard_normal((n_users, k)) * 0.5
  V0 = rng.standard_normal((n_items, k)) * 0.5
  users = rng.integers(0, n_users, n_ratings)
  items = rng.integers(0, n_items, n_ratings)
  ratings = (U0[users] * V0[items]).sum(1) + 0.05 * rng.standard_normal(
      n_ratings)
  U, V = fit(users, items, ratings, n_users, n_items, k, epochs)
  return rmse(U, V, users, items, ratings)
