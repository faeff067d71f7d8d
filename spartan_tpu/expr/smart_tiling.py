"""Smart tiling: cost-model search over array placements.

Rebuild of the reference's headline contribution (reference:
``spartan/expr/optimize.py`` AutoTiling — the ATC'15 "smart tiling" pass
that searches per-array tiling choices to minimize bytes moved over the
network; SURVEY.md §2.1, §6).

Re-targeted at shardings: XLA already propagates shardings *inside* a
jitted region, so the decisions that still belong to the framework are
(a) how leaf arrays are laid out when first placed on the mesh and (b) the
``out_shardings`` at region boundaries.  This module runs a bottom-up
dynamic program over a small candidate-spec set per node, charging each op
the interconnect bytes XLA would have to move given its children's layouts
(all-gather for broadcast/replication, all-to-all for re-tiling,
reduce-scatter/psum for contractions and combiner updates), and returns
the argmin leaf layouts + expected cost.

Entry points:
  * :func:`plan(expr)`      → ``TilingPlan`` (leaf specs, root spec, cost)
  * :func:`apply_plan`      → reshard the DAG's leaves per the plan
  * :func:`smart_tile(expr)`→ plan + apply, returns the plan
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import math

import numpy as np
from jax.sharding import PartitionSpec

from spartan_tpu.core.array import SpartanArray
from spartan_tpu.core.mesh import get_mesh
from spartan_tpu.core.tiling import Tiling
from spartan_tpu.expr.base import Expr, NotShapeable, Val
from spartan_tpu.expr.dot import DotExpr, OuterExpr, TensorDotExpr
from spartan_tpu.expr.map import MapExpr, MapWithLocationExpr
from spartan_tpu.expr.ndarray import CreationExpr
from spartan_tpu.expr.reduce import ReduceExpr
from spartan_tpu.expr.reshape import RavelExpr, ReshapeExpr, TransposeExpr
from spartan_tpu.expr.slice import SliceExpr


# ---------------------------------------------------------------------------
# Spec helpers and the byte-cost model
# ---------------------------------------------------------------------------

def _n_shards(entry, mesh) -> int:
  if entry is None:
    return 1
  axes = entry if isinstance(entry, (tuple, list)) else (entry,)
  n = 1
  for a in axes:
    n *= mesh.shape[a]
  return n


_norm_memo: Dict[Tuple, Tuple] = {}


def _norm(spec: PartitionSpec, ndim: int) -> Tuple:
  # hot inside the DP's O(cands³) dot loop — memoize (specs are hashable)
  try:
    hit = _norm_memo.get((spec, ndim))
    if hit is not None:
      return hit
  except TypeError:
    hit = None
  entries = tuple(spec)
  entries = entries + (None,) * (ndim - len(entries))
  out = tuple(tuple(e) if isinstance(e, (tuple, list)) else e
              for e in entries[:ndim])
  if hit is None:
    try:
      if len(_norm_memo) > 4096:
        _norm_memo.clear()
      _norm_memo[(spec, ndim)] = out
    except TypeError:
      pass
  return out


_itemsize_memo: Dict = {}


def _itemsize(dtype) -> int:
  try:
    hit = _itemsize_memo.get(dtype)
    if hit is None:
      hit = _itemsize_memo[dtype] = np.dtype(dtype).itemsize
    return hit
  except TypeError:
    return np.dtype(dtype).itemsize


def _nelems(shape) -> float:
  return float(math.prod(shape)) if shape else 1.0


def spec_fits(spec: PartitionSpec, shape, mesh) -> bool:
  for dim, entry in zip(shape, _norm(spec, len(shape))):
    n = _n_shards(entry, mesh)
    if n > 1 and dim % n != 0:
      return False
  return True


def candidate_specs(shape, mesh) -> List[PartitionSpec]:
  """Small candidate set per shape: every assignment of {axes, axis-pairs,
  nothing} to dims, filtered by divisibility."""
  axes = list(mesh.axis_names)
  ndim = len(shape)
  if ndim == 0:
    return [PartitionSpec()]
  pool: List[PartitionSpec] = [PartitionSpec()]
  if ndim == 1:
    opts = [tuple(axes)] + [(a,) for a in axes]
    for o in opts:
      pool.append(PartitionSpec(o if len(o) > 1 else o[0]))
  else:
    # one axis (or the flattened pair) on a single dim; or distinct axes on
    # two dims — covers row/col/2-D tilings on a 2-D mesh
    for d in range(ndim):
      for o in [tuple(axes)] + [(a,) for a in axes]:
        entries = [None] * ndim
        entries[d] = o if len(o) > 1 else o[0]
        pool.append(PartitionSpec(*entries))
    if len(axes) >= 2:
      for d1 in range(ndim):
        for d2 in range(ndim):
          if d1 == d2:
            continue
          for a1, a2 in ((axes[0], axes[1]), (axes[1], axes[0])):
            entries = [None] * ndim
            entries[d1], entries[d2] = a1, a2
            pool.append(PartitionSpec(*entries))
  seen, out = set(), []
  for s in pool:
    key = _norm(s, ndim)
    if key not in seen and spec_fits(s, shape, mesh):
      seen.add(key)
      out.append(s)
  return out


# Compute-imbalance charge.  The reference's model was network-bytes-only
# because its tile partitioning never admitted replication as a layout; on
# a device mesh "replicate everything" has ZERO collectives and would win
# every comm-only comparison while making every chip do the full work.
# Charge each op β·work_bytes/util, where util is the number of devices
# the op's work is partitioned over and β ≈ 0.1 reflects that processing
# a byte locally is ~10× cheaper than moving it across the
# interconnect.  Replication
# still wins for small arrays (work term vanishes with size) — the
# r2 "replicate small leaves" insight falls out of the model for free.
_COMPUTE_WEIGHT = 0.1


def _compute_cost(work_elems: float, itemsize: int, util: int) -> float:
  return _COMPUTE_WEIGHT * float(work_elems) * itemsize / max(util, 1)


def _spec_util(spec: PartitionSpec, ndim: int, mesh) -> int:
  """Number of devices a spec partitions work over."""
  util = 1
  for entry in _norm(spec, ndim):
    util *= _n_shards(entry, mesh)
  return util


def reshard_bytes(shape, dtype, src: PartitionSpec, dst: PartitionSpec,
                  mesh) -> float:
  """Estimated interconnect bytes to move an array from ``src`` to ``dst`` layout.

  Model (global bytes crossing links, relative scale is what matters):
    * identical layouts → 0
    * purely *refining* (dst splits a dim src had whole on every device
      that will own it) → 0 (local slice)
    * replicating a sharded dim (all-gather) → B·(k−1) where k = shard
      count being removed
    * general re-tiling (all-to-all) → B·(1 − 1/k_src·k_dst overlap) ≈ B
  """
  if not shape:
    return 0.0
  b = _nelems(shape) * _itemsize(dtype)
  s, d = _norm(src, len(shape)), _norm(dst, len(shape))
  if s == d:
    return 0.0
  cost = 0.0
  changed = [(i, se, de) for i, (se, de) in enumerate(zip(s, d)) if se != de]
  for i, se, de in changed:
    ks, kd = _n_shards(se, mesh), _n_shards(de, mesh)
    if ks == 1 and kd > 1:
      # splitting a dim that was whole: if the array was fully replicated
      # this is a local slice (free); if other dims sharded, mostly local
      cost += 0.0
    elif kd == 1 and ks > 1:
      cost += b * (ks - 1) / ks          # all-gather this dim
    else:
      cost += b * (1.0 - 1.0 / max(ks, kd))   # all-to-all-ish
  return cost


def _dot_cost(a_shape, b_shape, dtype, a_spec, b_spec, out_spec,
              mesh) -> float:
  """Cost of C[m,n] = A[m,k] @ B[k,n] given operand layouts and the
  wanted output layout.

  Coherent SPMD story (replaces r2's per-symptom charges, which billed
  phantom gathers for operands that were already replicated): the output
  spec (S_m, S_n) plus the operands' contraction sharding S_k determine
  the canonical partitioned algorithm's REQUIRED operand layouts
  A:(S_m, S_k), B:(S_k, S_n).  Charge

    * the real reshard bytes from each operand's current layout to its
      required layout (already-there and refine-from-replicated are free),
    * the partial-sum combine of C over the S_k shards (psum /
      reduce-scatter — the reference's "dot shuffle"),
    * the compute-imbalance term over the devices the contraction
      actually partitions across.
  """
  itemsize = _itemsize(dtype)

  def _ax(e):
    if e is None:
      return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)

  # map the (≤2-D) output spec entries onto (m, n)
  o = _norm(out_spec, 2) + (None, None)
  if len(a_shape) == 2 and len(b_shape) == 2:
    m_entry, n_entry = o[0], o[1]
  elif len(a_shape) == 1 and len(b_shape) == 2:   # vec @ mat → (n,)
    m_entry, n_entry = None, o[0]
  elif len(a_shape) == 2:                          # mat @ vec → (m,)
    m_entry, n_entry = o[0], None
  else:                                            # vec @ vec → scalar
    m_entry = n_entry = None
  # 1-D operands: the single dim IS the contraction dim
  if len(a_shape) == 2:
    _, a_k = _norm(a_spec, 2)
  elif len(a_shape) == 1:
    a_k = _norm(a_spec, 1)[0]
  else:
    a_k = None
  if len(b_shape) == 2:
    b_k, _ = _norm(b_spec, 2)
  elif len(b_shape) == 1:
    b_k = _norm(b_spec, 1)[0]
  else:
    b_k = None

  ka, kb = _n_shards(a_k, mesh), _n_shards(b_k, mesh)
  # contraction sharding: keep the operands' k-sharding when present
  # (mismatch realigns to the more-sharded side); axes already spent on
  # the output's m/n cannot also split k
  if ka >= kb and ka > 1:
    s_k = a_k
  elif kb > 1:
    s_k = b_k
  else:
    s_k = None
  if set(_ax(s_k)) & (set(_ax(m_entry)) | set(_ax(n_entry))):
    s_k = None
  kk = _n_shards(s_k, mesh)

  cost = 0.0
  if len(a_shape) == 2:
    cost += reshard_bytes(a_shape, dtype, a_spec,
                          PartitionSpec(m_entry, s_k), mesh)
  elif len(a_shape) == 1:
    cost += reshard_bytes(a_shape, dtype, a_spec, PartitionSpec(s_k), mesh)
  if len(b_shape) == 2:
    cost += reshard_bytes(b_shape, dtype, b_spec,
                          PartitionSpec(s_k, n_entry), mesh)
  elif len(b_shape) == 1:
    cost += reshard_bytes(b_shape, dtype, b_spec, PartitionSpec(s_k), mesh)

  m = a_shape[0] if len(a_shape) == 2 else 1
  n = b_shape[1] if len(b_shape) == 2 else 1
  k = a_shape[-1] if a_shape else 1
  if kk > 1:  # partial-sum combine of C over the contraction shards
    cost += float(m) * n * itemsize * (kk - 1) / kk
  km, kn = _n_shards(m_entry, mesh), _n_shards(n_entry, mesh)
  util = min(km * kn * max(kk, 1), int(mesh.devices.size))
  cost += _compute_cost(float(m) * n * k, itemsize, util)
  return cost


# ---------------------------------------------------------------------------
# The dynamic program
# ---------------------------------------------------------------------------

class TilingPlan:
  """Result of the cost search."""

  def __init__(self, leaf_specs: Dict[int, PartitionSpec],
               root_spec: Optional[PartitionSpec], cost: float):
    self.leaf_specs = leaf_specs
    self.root_spec = root_spec
    self.cost = cost

  def __repr__(self):
    return (f"TilingPlan(cost={self.cost:.3g}, "
            f"leaves={ {k: str(v) for k, v in self.leaf_specs.items()} }, "
            f"root={self.root_spec})")


def _stencil_halo_bytes(shape, dtype, spec, mesh, halo: int = 1) -> float:
  """Halo-exchange traffic for a stencil over a sharded input: each
  sharded spatial dim moves ``halo`` boundary rows per shard per side
  (the reference's neighbor-tile fetch, as one ppermute ring)."""
  entries = _norm(spec, len(shape))
  item = _itemsize(dtype)
  total = 0.0
  for d, entry in enumerate(entries):
    k = _n_shards(entry, mesh)
    if k <= 1:
      continue
    ghost_rows = 2 * halo * k  # both directions, every boundary
    row_bytes = _nelems(shape) / max(shape[d], 1) * item
    total += ghost_rows * row_bytes
  return total


def plan(expr: Expr, mesh=None) -> TilingPlan:
  """Bottom-up DP: for every node and candidate output spec, the minimal
  bytes moved in the subtree; argmin at the root, choices backtracked to
  the leaves."""
  from spartan_tpu.expr.base import ensure_recursion_budget
  ensure_recursion_budget(expr)  # solve/back are recursive per node
  mesh = mesh or get_mesh()
  # table: expr_id -> {norm_spec: (cost, spec, [(child, child_spec)])}
  table: Dict[int, Dict[Tuple, Tuple[float, PartitionSpec, list]]] = {}

  def solve(e: Expr) -> Dict[Tuple, Tuple[float, PartitionSpec, list]]:
    hit = table.get(e.expr_id)
    if hit is not None:
      return hit
    try:
      shape = e.shape
      dtype = e.dtype
    except (NotShapeable, Exception):
      table[e.expr_id] = {(): (0.0, PartitionSpec(), [])}
      return table[e.expr_id]

    cands = candidate_specs(shape, mesh)
    out: Dict[Tuple, Tuple[float, PartitionSpec, list]] = {}

    if isinstance(e, Val):
      # Steady-state planning: a placement move is one-time and amortizes
      # to ~nothing over a program, so it enters only as an EPSILON
      # tie-break toward the leaf's current layout — this makes the plan a
      # near-pure function of DAG structure, so re-planning an
      # already-placed DAG fixpoints immediately instead of oscillating
      # (each transient layout re-plans AND recompiles the region).
      # Replicating a leaf does carry a standing cost (n copies of the
      # array resident in HBM): charge a small per-byte term so big
      # leaves prefer sharded layouts when otherwise near-tied while
      # small leaves still replicate (the r2 netflix-factor lesson).
      cur = (e.value.tiling.spec if isinstance(e.value, SpartanArray)
             else PartitionSpec())
      b = _nelems(shape) * _itemsize(dtype)
      n_total = int(mesh.devices.size)
      for s in cands:
        replicas = n_total // max(_spec_util(s, len(shape), mesh), 1)
        mem = 0.05 * b * (replicas - 1) / max(replicas, 1)
        tie = 1e-6 * reshard_bytes(shape, dtype, cur, s, mesh)
        out[_norm(s, len(shape))] = (mem + tie, s, [])
    elif isinstance(e, CreationExpr):
      item = _itemsize(dtype)
      for s in cands:
        out[_norm(s, len(shape))] = (
            _compute_cost(_nelems(shape), item,
                          _spec_util(s, len(shape), mesh)), s, [])
    elif isinstance(e, (MapExpr, MapWithLocationExpr)):
      kids = [c for c in e.inputs]
      kid_tabs = [solve(c) for c in kids]
      for s in cands:
        total = 0.0
        picks = []
        for c, tab in zip(kids, kid_tabs):
          try:
            cshape, cdtype = c.shape, c.dtype
          except Exception:
            picks.append((c, PartitionSpec()))
            continue
          if len(cshape) != len(shape) or _nelems(cshape) <= 1:
            # broadcast operand: replicated is free enough
            best_c = min(tab.values(), key=lambda v: v[0])
            total += best_c[0]
            picks.append((c, best_c[1]))
            continue
          best_cost, best_spec = None, None
          for key, (ccost, cspec, _) in tab.items():
            move = reshard_bytes(cshape, cdtype, cspec, s, mesh)
            t = ccost + move
            if best_cost is None or t < best_cost:
              best_cost, best_spec = t, cspec
          total += best_cost
          picks.append((c, best_spec))
        total += _compute_cost(_nelems(shape), _itemsize(dtype),
                               _spec_util(s, len(shape), mesh))
        out[_norm(s, len(shape))] = (total, s, picks)
    elif isinstance(e, ReduceExpr):
      kids = list(e.inputs)
      kid_tabs = [solve(c) for c in kids]
      rep = max(kids, key=lambda c: (getattr(c, "ndim", 0),
                                     getattr(c, "size", 0)))
      rep_tab = kid_tabs[kids.index(rep)]
      for s in cands:
        # derive required child spec: s with the reduced axis re-inserted
        best = None
        for key, (ccost, cspec, _) in rep_tab.items():
          try:
            derived = _reduce_out_spec(cspec, rep.shape, e.axis, e.keepdims)
          except Exception:
            derived = PartitionSpec()
          move = reshard_bytes(shape, dtype, derived, s, mesh)
          # partial-sum combine over the reduced axes' shards
          kk = 1
          if e.axis is not None and rep.ndim:
            centr = _norm(cspec, rep.ndim)
            for a in (e.axis if isinstance(e.axis, tuple) else (e.axis,)):
              a %= rep.ndim
              if a < len(centr):
                kk *= _n_shards(centr[a], mesh)
          combine = (_nelems(shape) * _itemsize(dtype)
                     * (kk - 1) / max(kk, 1))
          try:
            work = _compute_cost(rep.size, _itemsize(rep.dtype),
                                 _spec_util(cspec, rep.ndim, mesh))
          except Exception:
            work = 0.0
          t = ccost + move + combine + work
          if best is None or t < best[0]:
            best = (t, cspec)
        others = 0.0
        picks = [(rep, best[1])]
        for c, tab in zip(kids, kid_tabs):
          if c is rep:
            continue
          bc = min(tab.values(), key=lambda v: v[0])
          others += bc[0]
          picks.append((c, bc[1]))
        out[_norm(s, len(shape))] = (best[0] + others, s, picks)
    elif isinstance(e, (DotExpr, TensorDotExpr, OuterExpr)) and len(
        e.inputs) == 2:
      a, bb = e.inputs
      ta, tb = solve(a), solve(bb)
      for s in cands:
        best = None
        for ka, (ca, sa, _) in ta.items():
          for kb, (cb, sb, _) in tb.items():
            try:
              op = _dot_cost(a.shape, bb.shape, dtype, sa, sb, s, mesh)
            except Exception:
              op = 0.0
            t = ca + cb + op
            if best is None or t < best[0]:
              best = (t, sa, sb)
        out[_norm(s, len(shape))] = (best[0], s, [(a, best[1]),
                                                  (bb, best[2])])
    elif type(e).__name__ == "TransposeExpr" and len(e.children()) == 1:
      # transpose is free under sharding: the output spec is the child's
      # spec with axes permuted — no data moves, XLA relabels the layout
      (c,) = e.children()
      tab = solve(c)
      axes = e.axes if e.axes else tuple(range(c.ndim))[::-1]
      for key, (ccost, cspec, _) in tab.items():
        centries = _norm(cspec, c.ndim)
        permuted = PartitionSpec(*(centries[a] for a in axes))
        out_key = _norm(permuted, len(shape))
        prev = out.get(out_key)
        if prev is None or ccost < prev[0]:
          out[out_key] = (ccost, permuted, [(c, cspec)])
      # also admit the remaining candidates via an explicit reshard
      for s in cands:
        k = _norm(s, len(shape))
        if k in out:
          continue
        best = None
        for key, (ccost, cspec, _) in tab.items():
          centries = _norm(cspec, c.ndim)
          permuted = PartitionSpec(*(centries[a] for a in axes))
          t = ccost + reshard_bytes(shape, dtype, permuted, s, mesh)
          if best is None or t < best[0]:
            best = (t, cspec)
        out[k] = (best[0], s, [(c, best[1])])
    elif type(e).__name__ in ("StencilExpr", "PoolExpr"):
      # stencil/pool: batch/channel dims shard free; sharded spatial dims
      # pay a halo exchange per step (reference stencil neighbor fetch)
      kids = e.children()
      kid_tabs = [solve(c) for c in kids]
      c0, tab0 = kids[0], kid_tabs[0]
      others = 0.0
      opicks = []
      for c, tab in list(zip(kids, kid_tabs))[1:]:
        bc = min(tab.values(), key=lambda v: v[0])
        others += bc[0]
        opicks.append((c, bc[1]))
      for s in cands:
        best = None
        for key, (ccost, cspec, _) in tab0.items():
          try:
            halo = _stencil_halo_bytes(c0.shape, c0.dtype, cspec, mesh)
            move = reshard_bytes(shape, dtype, cspec, s, mesh)
            work = _compute_cost(c0.size, _itemsize(c0.dtype),
                                 _spec_util(cspec, c0.ndim, mesh))
          except Exception:
            halo, move, work = 0.0, 0.0, 0.0
          t = ccost + halo + move + work
          if best is None or t < best[0]:
            best = (t, cspec)
        out[_norm(s, len(shape))] = (best[0] + others, s,
                                     [(c0, best[1])] + opicks)
    elif type(e).__name__ == "ShuffleExpr":
      # generic scatter re-tile: charge a full all-to-all of the output
      # ((n-1)/n of the bytes cross shards) on top of the inputs' best
      kids = e.children()
      kid_tabs = [solve(c) for c in kids]
      base = 0.0
      picks = []
      for c, tab in zip(kids, kid_tabs):
        bc = min(tab.values(), key=lambda v: v[0])
        base += bc[0]
        picks.append((c, bc[1]))
      n_total = float(np.prod([mesh.shape[a] for a in mesh.axis_names]))
      a2a = (_nelems(shape) * _itemsize(dtype) *
             (n_total - 1) / max(n_total, 1))
      for s in cands:
        work = _compute_cost(_nelems(shape), _itemsize(dtype),
                             _spec_util(s, len(shape), mesh))
        out[_norm(s, len(shape))] = (base + a2a + work, s, picks)
    else:
      # structural ops: chain through the dominant child
      kids = e.children()
      kid_tabs = [solve(c) for c in kids]
      base = 0.0
      picks = []
      for c, tab in zip(kids, kid_tabs):
        bc = min(tab.values(), key=lambda v: v[0])
        base += bc[0]
        picks.append((c, bc[1]))
      for s in cands:
        out[_norm(s, len(shape))] = (base, s, picks)

    table[e.expr_id] = out
    return out

  root_tab = solve(expr)
  best_key = min(root_tab, key=lambda k: root_tab[k][0])
  cost, root_spec, _ = root_tab[best_key]

  # backtrack leaf choices (memoized per (node, key) — shared subtrees
  # would otherwise blow up combinatorially).  A shared leaf may receive
  # CONFLICTING spec demands from different parents (the per-node DP is
  # independent per consumer); collect every demand and resolve to the
  # consensus spec minimizing total reshard bytes to all demand sites —
  # a leaf can only live in one layout.
  demands: Dict[int, List[PartitionSpec]] = {}
  leaf_nodes: Dict[int, Expr] = {}
  visited = set()

  def back(e: Expr, key: Tuple):
    if (e.expr_id, key) in visited:
      return
    visited.add((e.expr_id, key))
    tab = table.get(e.expr_id, {})
    if key not in tab:
      if not tab:
        return
      key = min(tab, key=lambda k: tab[k][0])
    _, spec, picks = tab[key]
    if isinstance(e, Val):
      demands.setdefault(e.expr_id, []).append(spec)
      leaf_nodes[e.expr_id] = e
      return
    for c, cspec in picks:
      try:
        back(c, _norm(cspec, c.ndim))
      except Exception:
        back(c, ())

  back(expr, best_key)
  leaf_specs: Dict[int, PartitionSpec] = {}
  for eid, specs in demands.items():
    uniq = {}
    for sp_ in specs:
      uniq.setdefault(_norm(sp_, 8), sp_)
    if len(uniq) == 1:
      leaf_specs[eid] = specs[0]
      continue
    leaf = leaf_nodes[eid]
    try:
      shape, dtype = leaf.shape, leaf.dtype
    except Exception:
      leaf_specs[eid] = specs[0]
      continue
    best_spec, best_cost = None, None
    for cand in uniq.values():
      total = 0.0
      for want in specs:
        total += reshard_bytes(shape, dtype, cand, want, mesh)
      if best_cost is None or total < best_cost:
        best_cost, best_spec = total, cand
    leaf_specs[eid] = best_spec
  return TilingPlan(leaf_specs, root_spec, cost)


def _reduce_out_spec(child_spec: PartitionSpec, child_shape, axis,
                     keepdims) -> PartitionSpec:
  if axis is None:
    return PartitionSpec()
  nd = len(child_shape)
  entries = list(_norm(child_spec, nd))
  axes = {a % nd for a in (axis if isinstance(axis, tuple) else (axis,))}
  if keepdims:
    for ax in axes:
      entries[ax] = None
  else:
    entries = [s for i, s in enumerate(entries) if i not in axes]
  while entries and entries[-1] is None:
    entries.pop()
  return PartitionSpec(*entries)


def apply_plan(expr: Expr, plan_: TilingPlan, mesh=None) -> None:
  """Reshard the DAG's SpartanArray leaves to the planned layouts —
  in place on the arrays themselves (``reshard_``), so every holder sees
  the planned placement from then on."""
  mesh = mesh or get_mesh()

  def visit(e: Expr):
    if isinstance(e, Val) and isinstance(e.value, SpartanArray):
      spec = plan_.leaf_specs.get(e.expr_id)
      if spec is not None and _norm(spec, e.value.ndim) != _norm(
          e.value.tiling.spec, e.value.ndim):
        e.value.reshard_(Tiling(mesh, spec))

  expr.visit(visit)


def smart_tile(expr: Expr, mesh=None) -> TilingPlan:
  """Plan + apply: lay the DAG's leaves out to minimize bytes moved."""
  p = plan(expr, mesh)
  apply_plan(expr, p, mesh)
  return p


def validate_plan(expr: Expr, mesh=None):
  """Measurement hook: compare the planner's predicted bytes-moved with
  XLA's own cost analysis of the compiled region (the closest thing to
  ground truth without running a profiler).  Returns a dict with the
  planner's prediction and XLA's ``bytes accessed`` estimate for the
  region compiled (a) with default leaf layouts and (b) with the plan
  applied — so the cost model can be sanity-checked per workload."""
  import jax
  from spartan_tpu.backend import evaluator as ev

  mesh = mesh or get_mesh()
  p = plan(expr, mesh)

  def _xla_bytes(root: Expr) -> float:
    from spartan_tpu.expr import optimize as opt_mod
    opt = opt_mod.optimize(root)
    leaves = ev._collect_leaves(opt)
    stripped, stub_leaves = ev._strip_leaf_values(opt, leaves)
    stub_index = {s_.expr_id: i for i, s_ in enumerate(stub_leaves)}
    runner = ev._make_runner(stripped, stub_index)
    args = [leaf.leaf_value() for leaf in leaves]
    lowered = jax.jit(runner).lower(*args)
    cost = lowered.compile().cost_analysis()
    if isinstance(cost, list):
      cost = cost[0] if cost else {}
    return float((cost or {}).get("bytes accessed", float("nan")))

  before = _xla_bytes(expr)
  apply_plan(expr, p, mesh)
  after = _xla_bytes(expr)
  return {"predicted_moved_bytes": p.cost,
          "xla_bytes_accessed_default": before,
          "xla_bytes_accessed_planned": after}
