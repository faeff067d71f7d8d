"""``sp.sparse.csgraph`` — scipy.sparse.csgraph over fused device loops.

The reference has no graph-algorithms module (SURVEY.md §2.5 — PageRank
is its only graph workload); this is beyond-parity surface built
Device-first:

* **Shortest paths / components are min-plus relaxations** expressed as
  GATHERS over the padded-ELL layout (no scatters): for target ``j``,
  row ``j`` of ``Gᵀ`` lists its incoming sources, so one
  ``take(dist, GT.cols, axis=1)`` + masked ``min`` over the pad axis is
  a whole Bellman–Ford round.  The round iterates inside ONE compiled
  ``sp.while_loop`` with a data-dependent changed-flag stop — the same
  fused-loop design as sparse_linalg's solvers.
* **Floyd–Warshall** runs dense: a ``fori_loop`` carrying ``(k, D)``
  with traced-index ``take`` for the pivot row/column — n fused
  (n, n) min-plus updates, no host round trips.
* **Inherently sequential / structure-output algorithms** (DFS, minimum
  spanning tree, RCM ordering, bipartite matching, strong components)
  are host boundaries via scipy — the sp.linalg.eig convention, logged
  once per process.

Edge convention: stored value 0 means NO edge (scipy's dense
``null_value=0`` contract — the padded-ELL pads are (col 0, val 0), so
explicit zero-weight edges cannot be represented; scipy's
zero-weight-edge corner needs its masked-array form even upstream).
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp
from spartan_tpu.backend.sparse import SparseArray, from_coo, from_scipy
from spartan_tpu.util import log_info


__all__ = [
    "NegativeCycleError", "shortest_path", "floyd_warshall",
    "bellman_ford", "dijkstra", "johnson", "connected_components",
    "laplacian", "breadth_first_order", "breadth_first_tree",
    "depth_first_order", "depth_first_tree", "minimum_spanning_tree",
    "reverse_cuthill_mckee", "structural_rank",
    "maximum_bipartite_matching", "csgraph_from_dense",
    "csgraph_to_dense",
]

_INF = np.inf
_NULL = -9999  # scipy's predecessor sentinel


class NegativeCycleError(Exception):
  """Raised when a negative-weight cycle is reachable (scipy contract)."""


# ---------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------

def _as_sparse(csgraph) -> SparseArray:
  """Any accepted graph form → padded-ELL SparseArray (host ingest,
  the established pack-building path)."""
  if isinstance(csgraph, SparseArray):
    return csgraph
  try:
    import scipy.sparse as ss
    if ss.issparse(csgraph):
      return from_scipy(csgraph.tocsr())
  except ImportError:  # pragma: no cover
    pass
  dense = np.asarray(sp.lazify(csgraph).glom())
  if dense.ndim != 2 or dense.shape[0] != dense.shape[1]:
    raise ValueError(f"csgraph must be square 2-D, got {dense.shape}")
  import scipy.sparse as ss
  # scipy's dense-ingest contract: 0, inf and nan all mean "no edge"
  dense = np.where(np.isfinite(dense), dense, 0.0)
  return from_scipy(ss.csr_matrix(dense))


def csgraph_from_dense(graph, null_value=0, nan_null=True,
                       infinity_null=True):
  """Dense → sparse graph (``null_value`` entries dropped; inf/nan
  dropped by default — scipy contract)."""
  dense = np.array(np.asarray(sp.lazify(graph).glom()), copy=True)
  if nan_null:
    dense = np.where(np.isnan(dense), 0.0, dense)
  if infinity_null:
    dense = np.where(np.isinf(dense), 0.0, dense)
  if null_value != 0:
    dense = np.where(dense == null_value, 0.0, dense)
  import scipy.sparse as ss
  return from_scipy(ss.csr_matrix(dense))


def csgraph_to_dense(csgraph, null_value=0):
  """Sparse → dense graph with ``null_value`` at non-edges."""
  G = _as_sparse(csgraph)
  d = np.asarray(G.todense())
  if null_value != 0:
    d = np.where(d == 0, null_value, d)
  return d


def _edge_exprs(G: SparseArray):
  """(cols, vals, mask) lazy leaves for one ELL orientation; None when
  the orientation has zero stored width (no edges)."""
  if G.cols.shape[1] == 0:
    return None
  cols = sp.Val(np.asarray(G.cols))
  vals = sp.Val(np.asarray(G.vals, dtype=np.float64))
  return cols, vals


# ---------------------------------------------------------------------
# the min-plus relaxation core (gather formulation — no scatters)
# ---------------------------------------------------------------------

def _relax(dist, edges, unweighted: bool):
  """One min-plus round: ``out[s, j] = min_slot dist[s, src[j, slot]] +
  w[j, slot]`` with pads/non-edges masked to +inf.  ``dist`` is (k, n)."""
  cols, vals = edges
  gathered = sp.take(dist, cols, axis=1)            # (k, n, w)
  mask = sp.not_equal(vals, 0.0)                    # (n, w) — 0 == no edge
  w = 1.0 if unweighted else vals
  cand = sp.where(mask, gathered + w, np.float64(_INF))
  return sp.min(cand, axis=2)                       # (k, n)


def _sssp(G: SparseArray, sources: np.ndarray, directed: bool,
          unweighted: bool, detect_negative: bool):
  """Multi-source shortest paths: fused while_loop of relaxation rounds.

  Returns (dist (k, n) np.float64, hit_round_limit bool, rounds int)."""
  n = G.shape[0]
  k = len(sources)
  dist0 = np.full((k, n), _INF)
  dist0[np.arange(k), sources] = 0.0
  inc = _edge_exprs(G.transpose())                  # incoming edges of j
  out = None if directed else _edge_exprs(G)        # reverse orientation
  if inc is None and out is None:
    return dist0, False
  limit = n + 1  # paths need ≤ n-1 rounds; a change at round ≥ n ⇒ cycle

  def cond(dist, changed, it):
    return sp.logical_and(changed > 0, it < np.int32(limit))

  def body(dist, changed, it):
    rel = None
    if inc is not None:
      rel = _relax(dist, inc, unweighted)
    if out is not None:
      r2 = _relax(dist, out, unweighted)
      rel = r2 if rel is None else sp.minimum(rel, r2)
    new = sp.minimum(dist, rel)
    chg = sp.any(sp.less(new, dist)).astype(np.int32)
    return new, chg, it + 1

  dist, changed, it = sp.while_loop(
      cond, body,
      (sp.Val(dist0), sp.Val(np.int32(1)), sp.Val(np.int32(0))))
  hit_limit = bool(int(np.asarray(changed.glom()))) and \
      int(np.asarray(it.glom())) >= limit
  if detect_negative and hit_limit:
    raise NegativeCycleError(
        "negative-weight cycle reachable from the given sources")
  return np.asarray(dist.glom()), hit_limit, int(np.asarray(it.glom()))


def _predecessors(G: SparseArray, dist: np.ndarray, sources: np.ndarray,
                  directed: bool, unweighted: bool) -> np.ndarray:
  """One post-convergence pass: pred[s, j] = source of the edge that
  achieves dist[s, j] (argmin over the gathered candidates)."""
  k, n = dist.shape
  orientations = [_edge_exprs(G.transpose())]
  if not directed:
    orientations.append(_edge_exprs(G))
  d = sp.Val(dist)
  best = sp.Val(np.full((k, n), _INF))
  src = sp.Val(np.full((k, n), _NULL, dtype=np.int32))
  for edges in orientations:
    if edges is None:
      continue
    cols, vals = edges
    gathered = sp.take(d, cols, axis=1)
    mask = sp.not_equal(vals, 0.0)
    w = 1.0 if unweighted else vals
    cand = sp.where(mask, gathered + w, np.float64(_INF))   # (k, n, w)
    slot = sp.argmin(cand, axis=2)                          # (k, n)
    val = sp.min(cand, axis=2)
    # the source vertex sitting in the winning slot
    colsb = sp.broadcast_to(cols[None, :, :], tuple(cand.shape))
    this_src = sp.squeeze(
        sp.take_along_axis(colsb, slot[:, :, None], axis=2), axis=2)
    better = sp.less(val, best)
    best = sp.where(better, val, best)
    src = sp.where(better, this_src.astype(np.int32), src)
  bestn = np.asarray(best.glom())
  srcn = np.asarray(src.glom()).astype(np.int32)
  pred = np.where(np.isfinite(dist) & (bestn == dist), srcn, _NULL)
  pred = pred.astype(np.int32)
  pred[np.arange(k), sources] = _NULL  # sources have no predecessor
  return pred


def _indices_array(indices, n) -> np.ndarray:
  if indices is None:
    return np.arange(n)
  idx = np.atleast_1d(np.asarray(indices, dtype=np.int64))
  if idx.ndim != 1:
    raise ValueError("indices must be at most 1-D")
  idx = np.where(idx < 0, idx + n, idx)
  if (idx < 0).any() or (idx >= n).any():
    raise ValueError("indices out of range")
  return idx


def _maybe_squeeze(arr, indices):
  return arr[0] if np.isscalar(indices) or (
      indices is not None and np.ndim(indices) == 0) else arr


# ---------------------------------------------------------------------
# shortest-path surface
# ---------------------------------------------------------------------

def bellman_ford(csgraph, directed=True, indices=None,
                 return_predecessors=False, unweighted=False):
  """Bellman–Ford from the given sources (all vertices by default) —
  supports negative edge weights; raises :class:`NegativeCycleError`
  when a negative cycle is reachable.  One fused device while_loop."""
  G = _as_sparse(csgraph)
  srcs = _indices_array(indices, G.shape[0])
  dist, _, _ = _sssp(G, srcs, directed, unweighted, detect_negative=True)
  if not return_predecessors:
    return _maybe_squeeze(dist, indices)
  pred = _predecessors(G, dist, srcs, directed, unweighted)
  return _maybe_squeeze(dist, indices), _maybe_squeeze(pred, indices)


def dijkstra(csgraph, directed=True, indices=None,
             return_predecessors=False, unweighted=False, limit=_INF):
  """Shortest paths for NON-NEGATIVE weights.

  Device-first note: priority queues are hostile to SIMD hardware; for
  non-negative weights Bellman–Ford relaxation converges to the same
  distances, so this routes to the same fused relaxation loop
  (scipy.sparse.csgraph.dijkstra file-level parity, different
  mechanism).  Raises ValueError on negative weights (scipy contract:
  dijkstra may not be used with them)."""
  G = _as_sparse(csgraph)
  if not unweighted and G.nnz and float(np.asarray(G.vals).min()) < 0:
    raise ValueError("dijkstra requires non-negative weights — use "
                     "bellman_ford / johnson")
  srcs = _indices_array(indices, G.shape[0])
  dist, _, _ = _sssp(G, srcs, directed, unweighted, detect_negative=False)
  if limit != _INF:
    dist = np.where(dist > limit, _INF, dist)
  if not return_predecessors:
    return _maybe_squeeze(dist, indices)
  pred = _predecessors(G, dist, srcs, directed, unweighted)
  if limit != _INF:
    pred = np.where(np.isinf(dist), _NULL, pred).astype(np.int32)
  return _maybe_squeeze(dist, indices), _maybe_squeeze(pred, indices)


def johnson(csgraph, directed=True, indices=None,
            return_predecessors=False, unweighted=False):
  """All-pairs with negative weights allowed.  scipy reweights then runs
  Dijkstra; here the fused Bellman–Ford relaxation already handles
  negative weights directly, so the reweighting pass would be pure
  overhead — same results, one loop."""
  return bellman_ford(csgraph, directed=directed, indices=indices,
                      return_predecessors=return_predecessors,
                      unweighted=unweighted)


def floyd_warshall(csgraph, directed=True, return_predecessors=False,
                   unweighted=False):
  """Dense all-pairs shortest paths: ``fori_loop`` over pivots with
  traced-index row/column ``take`` — n fused (n, n) min-plus updates on
  device."""
  G = _as_sparse(csgraph)
  n = G.shape[0]
  dense = np.asarray(G.todense(), dtype=np.float64)
  if unweighted:
    dense = (dense != 0).astype(np.float64)
  D0 = np.where(dense != 0, dense, _INF)
  np.fill_diagonal(D0, 0.0)
  if not directed:
    D0 = np.minimum(D0, D0.T)

  if not return_predecessors:
    def body(k, D):
      row = sp.take(D, k, axis=0)
      col = sp.take(D, k, axis=1)
      return k + 1, sp.minimum(D, col[:, None] + row[None, :])

    _, Df = sp.fori_loop(n, body, (sp.Val(np.int32(0)), sp.Val(D0)))
    dist = np.asarray(Df.glom())
    if np.diag(dist).min() < 0:
      raise NegativeCycleError("negative-weight cycle in the graph")
    return dist

  # Predecessors are carried INSIDE the pivot loop (standard FW pred
  # recurrence: pred[i,j] <- pred[k,j] wherever D[i,k]+D[k,j] < D[i,j]).
  # A post-hoc equality match against dist is 1-ulp fragile — FW's
  # addition order differs from a fresh D[i,p]+w(p,j) pass.
  P0 = np.full((n, n), _NULL, dtype=np.int32)
  edge = np.isfinite(D0) & ~np.eye(n, dtype=bool)
  P0[edge] = np.broadcast_to(np.arange(n)[:, None], (n, n))[edge]

  def body_p(k, D, P):
    row = sp.take(D, k, axis=0)
    col = sp.take(D, k, axis=1)
    cand = col[:, None] + row[None, :]
    better = sp.less(cand, D)
    predk = sp.take(P, k, axis=0)
    newP = sp.where(better, sp.broadcast_to(predk[None, :], (n, n)), P)
    return k + 1, sp.where(better, cand, D), newP

  _, Df, Pf = sp.fori_loop(
      n, body_p, (sp.Val(np.int32(0)), sp.Val(D0), sp.Val(P0)))
  dist = np.asarray(Df.glom())
  if np.diag(dist).min() < 0:
    raise NegativeCycleError("negative-weight cycle in the graph")
  pred = np.asarray(Pf.glom()).astype(np.int32)
  return dist, pred


def shortest_path(csgraph, method="auto", directed=True,
                  return_predecessors=False, unweighted=False,
                  indices=None):
  """Dispatch front-end (scipy.sparse.csgraph.shortest_path parity).

  ``method='auto'``: Floyd–Warshall when all pairs of a small graph are
  wanted (dense O(n²) state pays off below ~2k vertices); the fused
  Bellman–Ford relaxation otherwise (and always when ``indices`` picks
  a source subset)."""
  G = _as_sparse(csgraph)
  n = G.shape[0]
  if method == "auto":
    method = "BF" if (indices is not None or n > 2048) else "FW"
  if method == "FW":
    if indices is not None:
      idx = _indices_array(indices, n)
      out = floyd_warshall(G, directed=directed,
                           return_predecessors=return_predecessors,
                           unweighted=unweighted)
      if return_predecessors:
        return (_maybe_squeeze(out[0][idx], indices),
                _maybe_squeeze(out[1][idx], indices))
      return _maybe_squeeze(out[idx], indices)
    return floyd_warshall(G, directed=directed,
                          return_predecessors=return_predecessors,
                          unweighted=unweighted)
  if method in ("BF", "J"):
    return bellman_ford(G, directed=directed, indices=indices,
                        return_predecessors=return_predecessors,
                        unweighted=unweighted)
  if method == "D":
    return dijkstra(G, directed=directed, indices=indices,
                    return_predecessors=return_predecessors,
                    unweighted=unweighted)
  raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------------
# components / structure
# ---------------------------------------------------------------------

def connected_components(csgraph, directed=True, connection="weak",
                         return_labels=True):
  """``(n_components, labels)`` via min-label propagation: labels start
  as vertex ids and flow along edges (both orientations — weak
  connectivity) inside one fused while_loop; converges in O(diameter)
  rounds.  ``connection='strong'`` is inherently sequential (Tarjan) —
  host boundary via scipy."""
  G = _as_sparse(csgraph)
  n = G.shape[0]
  if directed and connection == "strong":
    _host_notice("connected_components[strong]")
    import scipy.sparse.csgraph as cs
    return cs.connected_components(G.to_scipy(), directed=True,
                                   connection="strong",
                                   return_labels=return_labels)
  edges = [e for e in (_edge_exprs(G), _edge_exprs(G.transpose()))
           if e is not None]
  labels0 = np.arange(n, dtype=np.float64)
  if not edges:
    labels = labels0
  else:
    limit = n + 1

    def cond(lab, changed, it):
      return sp.logical_and(changed > 0, it < np.int32(limit))

    def body(lab, changed, it):
      new = lab
      for cols, vals in edges:
        mask = sp.not_equal(vals, 0.0)
        nb = sp.take(lab, cols, axis=0)               # (n, w)
        nb = sp.where(mask, nb, np.float64(_INF))
        new = sp.minimum(new, sp.min(nb, axis=1))
      chg = sp.any(sp.less(new, lab)).astype(np.int32)
      return new, chg, it + 1

    lab, _, _ = sp.while_loop(
        cond, body,
        (sp.Val(labels0), sp.Val(np.int32(1)), sp.Val(np.int32(0))))
    labels = np.asarray(lab.glom())
  uniq, inv = np.unique(labels, return_inverse=True)
  if not return_labels:
    return len(uniq)
  return len(uniq), inv.astype(np.int32)


def laplacian(csgraph, normed=False, return_diag=False,
              use_out_degree=False, copy=True, dtype=None,
              symmetrized=False):
  """Graph Laplacian ``L = D - A`` (or the symmetric-normalized form).

  Sparse input → sparse output assembled ON DEVICE: the degree vector is
  one SpMV, off-diagonals are a per-row/per-column scale of the ELL
  values, and the diagonal joins via ELL concatenation (no host
  densification).  Dense input stays a lazy expr chain."""
  del copy
  # scipy contract (probed r4s3): the graph DIAGONAL (self-loops) is
  # ignored entirely — degrees exclude it and no self-loop entry
  # survives in L; normed return_diag is sqrt(deg) with isolated
  # vertices reported as 1 (the safe divisor scipy uses internally).
  G = _as_sparse(csgraph) if not _is_dense(csgraph) else None
  if G is not None:
    import jax.numpy as jnp
    A = (G + G.transpose()) if symmetrized else G
    n = A.shape[0]
    rows = jnp.arange(n, dtype=A.cols.dtype)[:, None]
    vals_off = jnp.where(A.cols == rows, 0.0,
                         A.vals.astype(jnp.float64))
    Aoff = SparseArray(A.cols, vals_off, A.shape, A.nnz)
    ones = np.ones(n, dtype=np.float64)
    from spartan_tpu.backend.sparse import spmv
    deg = np.asarray(spmv(Aoff if use_out_degree else Aoff.transpose(),
                          ones), dtype=np.float64)
    if not normed:
      L = sp.sparse.diags(deg) + (-Aoff)
      d_out = deg
    else:
      w = np.where(deg > 0, np.sqrt(np.where(deg == 0, 1, deg)), 1.0)
      winv = 1.0 / w
      colscale = jnp.asarray(winv)[Aoff.cols]           # (n, w)
      rowscale = jnp.asarray(winv)[:, None]
      offdiag = SparseArray(Aoff.cols,
                            -Aoff.vals * rowscale * colscale,
                            A.shape, A.nnz)
      L = sp.sparse.diags((deg > 0).astype(np.float64)) + offdiag
      d_out = w
    if dtype is not None:
      L = SparseArray(L.cols, L.vals.astype(dtype), L.shape, L.nnz)
    return (L, d_out) if return_diag else L
  # dense: lazy expr chain
  A = sp.lazify(csgraph)
  if symmetrized:
    A = A + sp.transpose(A)
  n = A.shape[0]
  eye_mask = sp.Val(np.eye(n))
  Aoff = A * (1.0 - eye_mask)
  axis = 1 if use_out_degree else 0
  deg = sp.sum(Aoff, axis=axis)
  if not normed:
    L = sp.diag(deg) - Aoff
    d_out = deg
  else:
    isol = sp.equal(deg, 0)
    w = sp.where(isol, 1.0, sp.sqrt(sp.where(isol, 1.0, deg)))
    winv = 1.0 / w
    conn_eye = sp.diag(sp.where(isol, 0.0, 1.0))
    L = conn_eye - winv[:, None] * Aoff * winv[None, :]
    d_out = w
  if dtype is not None:
    L = L.astype(dtype)
  return (L, d_out) if return_diag else L


def _is_dense(x) -> bool:
  if isinstance(x, SparseArray):
    return False
  try:
    import scipy.sparse as ss
    if ss.issparse(x):
      return False
  except ImportError:  # pragma: no cover
    pass
  return True


# ---------------------------------------------------------------------
# BFS
# ---------------------------------------------------------------------

def breadth_first_order(csgraph, i_start, directed=True,
                        return_predecessors=True):
  """BFS node order from ``i_start``: the unweighted relaxation gives
  levels; the order is level-major with index-order ties (a valid BFS
  order — scipy's queue order may permute WITHIN a level)."""
  G = _as_sparse(csgraph)
  n = G.shape[0]
  src = _indices_array(int(i_start), n)[:1] if np.ndim(i_start) == 0 \
      else _indices_array(i_start, n)[:1]
  dist, _, _ = _sssp(G, src, directed, unweighted=True,
                  detect_negative=False)
  levels = dist[0]
  reach = np.flatnonzero(np.isfinite(levels))
  order = reach[np.argsort(levels[reach], kind="stable")].astype(np.int32)
  if not return_predecessors:
    return order
  pred = _predecessors(G, dist, src, directed, unweighted=True)[0]
  return order, pred


def breadth_first_tree(csgraph, i_start, directed=True):
  """The BFS tree as a sparse matrix with the graph's edge weights."""
  G = _as_sparse(csgraph)
  order, pred = breadth_first_order(G, i_start, directed=directed)
  gsp = G.to_scipy().tocsr()
  rows, cols, vals = [], [], []
  for j in order:
    p = pred[j]
    if p == _NULL:
      continue
    w = gsp[p, j]
    if w == 0 and not directed:
      w = gsp[j, p]
    rows.append(p)
    cols.append(j)
    vals.append(w)
  import scipy.sparse as ss
  return from_scipy(ss.csr_matrix(
      (np.asarray(vals, dtype=np.float64),
       (np.asarray(rows, dtype=np.int64), np.asarray(cols, np.int64))),
      shape=G.shape))


# ---------------------------------------------------------------------
# host-boundary algorithms (inherently sequential / structure outputs)
# ---------------------------------------------------------------------

_host_noticed: set = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info(
      "sp.sparse.csgraph.%s: inherently sequential (queue/stack-order) "
      "algorithm — runs EAGERLY on the host (scipy.sparse.csgraph), the "
      "sp.linalg.eig convention.", name)


def _host_cs(name, G, *args, **kw):
  _host_notice(name)
  import scipy.sparse.csgraph as cs
  return getattr(cs, name)(_as_sparse(G).to_scipy(), *args, **kw)


def depth_first_order(csgraph, i_start, directed=True,
                      return_predecessors=True):
  return _host_cs("depth_first_order", csgraph, int(i_start),
                  directed=directed,
                  return_predecessors=return_predecessors)


def depth_first_tree(csgraph, i_start, directed=True):
  t = _host_cs("depth_first_tree", csgraph, int(i_start),
               directed=directed)
  return from_scipy(t.tocsr())


def minimum_spanning_tree(csgraph, overwrite=False):
  t = _host_cs("minimum_spanning_tree", csgraph, overwrite=overwrite)
  return from_scipy(t.tocsr())


def reverse_cuthill_mckee(csgraph, symmetric_mode=False):
  return _host_cs("reverse_cuthill_mckee", csgraph,
                  symmetric_mode=symmetric_mode)


def structural_rank(csgraph):
  return int(_host_cs("structural_rank", csgraph))


def maximum_bipartite_matching(csgraph, perm_type="row"):
  return _host_cs("maximum_bipartite_matching", csgraph,
                  perm_type=perm_type)


def yen(csgraph, source, sink, K, *, directed=True,
        return_predecessors=False, unweighted=False):
  """Yen's K-shortest loopless paths — inherently sequential (each
  candidate spur re-runs a blocked Dijkstra on a mutated graph), host
  boundary."""
  return _host_cs("yen", csgraph, int(source), int(sink), int(K),
                  directed=directed,
                  return_predecessors=return_predecessors,
                  unweighted=unweighted)


def maximum_flow(csgraph, source, sink, *, method="dinic"):
  """Max flow (Dinic/Edmonds-Karp) — augmenting-path search is
  inherently sequential, host boundary.  Returns scipy's
  ``MaximumFlowResult`` (``.flow`` is a scipy CSR — wrap with
  ``sp.sparse.csr_matrix`` to move it on-device)."""
  _host_notice("maximum_flow")
  import scipy.sparse.csgraph as cs
  G = _as_sparse(csgraph).to_scipy().tocsr()
  if G.dtype != np.int32:
    # scipy's contract: integer capacities only.  Casting floats would
    # silently truncate (0.9 -> 0) and big int64 would wrap — raise
    # like scipy unless the values round-trip exactly.
    cast = G.astype(np.int32)
    if G.nnz and not np.array_equal(np.asarray(cast.data, np.float64),
                                    np.asarray(G.data, np.float64)):
      raise ValueError("graph capacities must be integers (int32 "
                       "representable); got dtype "
                       f"{G.dtype} with non-representable values")
    G = cast
  return cs.maximum_flow(G, int(source), int(sink), method=method)


def min_weight_full_bipartite_matching(biadjacency, maximize=False):
  """Min-weight full bipartite matching (LAPJVsp) — sequential
  augmenting shortest paths, host boundary."""
  return _host_cs("min_weight_full_bipartite_matching", biadjacency,
                  maximize=maximize)


def _sym_weight(G, GT, p, j):
  """Edge weight w(p→j); for undirected graphs csgraph uses the lighter
  of the two stored directions (0 = absent)."""
  w = np.asarray(G[p, j]).ravel()
  if GT is None:
    return w
  w2 = np.asarray(GT[p, j]).ravel()
  return np.where((w != 0) & (w2 != 0), np.minimum(w, w2), w + w2)


def reconstruct_path(csgraph, predecessors, directed=True):
  """Tree from a predecessor vector: one vectorized edge-list build
  (edge ``(pred[j], j)`` with the graph's weight), no path walking.
  Returns the tree as a device :class:`SparseArray` (scipy returns
  CSR)."""
  G = _as_sparse(csgraph).to_scipy().tocsr()
  n = G.shape[0]
  pred = np.asarray(predecessors).ravel()
  if pred.shape != (n,):
    raise ValueError(f"predecessors must have shape ({n},)")
  j = np.flatnonzero(pred >= 0)
  p = pred[j]
  w = _sym_weight(G, None if directed else G.T.tocsr(), p, j)
  # unweighted trees (BFS) store implicit weight 1 per edge
  w = np.where(w == 0, 1.0, w)
  return from_coo(p, j, w, (n, n))


def construct_dist_matrix(graph, predecessors, directed=True,
                          null_value=np.inf):
  """Distances implied by a full (N, N) predecessor matrix (row i
  rooted at i) — a LEVEL-SYNCHRONOUS gather recurrence instead of
  scipy's per-pair path walk: ``D[i, j] = D[i, pred[i, j]] + w``,
  iterated with `take_along_axis` until fixed point (path-depth
  rounds, each one vectorized over all N² entries)."""
  G = _as_sparse(graph).to_scipy().tocsr()
  n = G.shape[0]
  pred = np.asarray(predecessors)
  if pred.shape != (n, n):
    raise ValueError(f"predecessors must have shape ({n}, {n})")
  valid = pred >= 0
  rows_p = np.where(valid, pred, 0)
  cols_j = np.broadcast_to(np.arange(n), (n, n))
  w = _sym_weight(G, None if directed else G.T.tocsr(),
                  rows_p.ravel(), cols_j.ravel()).reshape(n, n)
  d = np.full((n, n), np.inf)
  np.fill_diagonal(d, 0.0)
  for _ in range(n):
    dp = np.take_along_axis(d, rows_p, axis=1)
    nd = np.where(valid, dp + w, d)
    np.fill_diagonal(nd, 0.0)
    if np.array_equal(nd, d):
      break
    d = nd
  if not np.isinf(null_value):
    d = np.where(np.isinf(d), null_value, d)
  return d


__all__ += ["yen", "maximum_flow", "min_weight_full_bipartite_matching",
            "reconstruct_path", "construct_dist_matrix"]
