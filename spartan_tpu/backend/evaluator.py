"""Region evaluator: lazy DAG → fused jitted XLA computations.

Rebuild of the reference's evaluation engine (reference:
``spartan/expr/base.py`` ``Expr.evaluate`` → optimizer → topological eval
with a per-expr cache, dispatching per-tile kernels through
``blob_ctx.map`` RPC fan-out; SURVEY.md §3.2).  The entire dashed region of
that call stack — kernel fan-out, per-tile evaluation, combiner merges —
becomes ONE ``jax.jit``-compiled XLA program over sharded arrays:

* materialization points (eval-cache hits, ``glom``, data-dependent
  shapes, checkpoints) cut the DAG into regions;
* each region compiles once, cached by structural signature (the
  reference's expr-eval cache, hoisted to compiled-computation granularity
  so iterative workloads hit the XLA compile cache every step);
* ``out_shardings`` comes from the AutoTiling pass — sharding is
  placement, XLA inserts the collectives.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import jax
from spartan_tpu.config import FLAGS
from spartan_tpu.core.array import SpartanArray
from spartan_tpu.core.tiling import Tiling
from spartan_tpu.expr import optimize as opt_mod
from spartan_tpu.expr.base import (DictExpr, EmitCtx, Expr, ListExpr,
                                   NotShapeable, Val,
                                   ensure_recursion_budget)
from spartan_tpu.util import Timer, log_debug, log_info

# structural signature → compiled callable
_jit_cache: "OrderedDict[Tuple, Callable]" = OrderedDict()

# raw (pre-optimization) signature → (compiled, binding recipe, wrap_root)
# — the fast lane: structurally-repeated evaluations skip the optimizer
_fast_cache: "OrderedDict[Tuple, Any]" = OrderedDict()

# simple counters surfaced for profiling/tests
stats = {"compiles": 0, "evals": 0, "cache_hits": 0, "fast_hits": 0}


def clear_cache() -> None:
  _jit_cache.clear()
  _fast_cache.clear()
  try:
    from spartan_tpu.expr.loop import clear_runner_cache
    clear_runner_cache()  # loop runners ride the same signature/flag
    # invariants (and the pin-flush path calls through here)
  except Exception:
    pass


def _opt_flags_fingerprint() -> tuple:
  """Optimizer-pipeline flags: part of the fast-lane key (the compiled
  program depends on which passes ran)."""
  return (FLAGS.optimization, FLAGS.opt_fusion, FLAGS.opt_reduce_fusion,
          FLAGS.opt_collapse_cached, FLAGS.opt_const_fold,
          FLAGS.opt_auto_tiling, FLAGS.replicate_small_bytes,
          FLAGS.opt_smart_tiling, FLAGS.smart_tiling_max_nodes)


def _materialize_unshapeable(expr: Expr) -> None:
  """Eagerly evaluate materialization boundaries: nodes whose output shape
  is data-dependent (boolean masks), and explicit boundaries like
  CheckpointExpr (which must get the chance to restore from disk instead
  of re-tracing its lineage)."""

  def visit(e: Expr):
    if e._cache is not None:
      return
    eager = getattr(e, "evaluate_eager", None)
    if eager is None:
      return
    if getattr(e, "_eager_boundary", False):
      e._cache = eager()
      return
    try:
      e.aval()
      return  # shapeable after all
    except NotShapeable:
      pass
    e._cache = eager()

  expr.visit(visit)


def _migrate_stray_leaves(expr: Expr) -> None:
  """Re-place SpartanArray leaves living on a different mesh onto the
  active mesh (the reference master's tile re-placement, as one
  device_put) — mixing meshes in one jitted region is an XLA error."""
  from spartan_tpu.core.mesh import get_mesh
  from spartan_tpu.core.tiling import Tiling, auto_tiling

  mesh = get_mesh()
  mesh_devices = tuple(mesh.devices.flat)

  def visit(e: Expr):
    if not isinstance(e, Val) or not isinstance(e.value, SpartanArray):
      return
    arr = e.value
    if tuple(arr.tiling.mesh.devices.flat) == mesh_devices:
      return
    from spartan_tpu.util import log_debug
    log_debug("migrating leaf %s from mesh %s to active mesh %s",
              e.expr_id, dict(arr.tiling.mesh.shape), dict(mesh.shape))
    spec = arr.tiling.spec
    try:
      e.value = arr.reshard(Tiling(mesh, spec))
    except Exception:
      e.value = arr.reshard(auto_tiling(arr.shape, None, mesh))
    e._aval = None

  expr.visit(visit)


def _collect_leaves(root: Expr) -> List[Val]:
  leaves: List[Val] = []
  seen = set()

  def go(e: Expr):
    if e.expr_id in seen:
      return
    seen.add(e.expr_id)
    if isinstance(e, Val):
      leaves.append(e)
      return
    for c in e.children():
      go(c)

  go(root)
  return leaves


class _StubVal(Val):
  """Valueless leaf used inside compiled runners: keeps the structure the
  runner traces over without pinning the original leaf's device buffer
  for the lifetime of the compiled-region cache."""

  _members = ()
  _params = ()
  _eager_skip = True  # never force-evaluated by --eager

  def __init__(self, aval):
    Expr.__init__(self)
    self.value = None
    self._stub_aval = aval

  def aval(self):
    return self._stub_aval

  def leaf_value(self):
    raise RuntimeError("stub leaf has no value (runner binds args "
                       "positionally)")


def _strip_leaf_values(root: Expr, leaves: List[Val]):
  """Rebuild the DAG with stub leaves (same positional identity) so the
  compiled closure holds no references to user device arrays."""
  stubs = {l.expr_id: _StubVal(l.aval()) for l in leaves}
  memo: Dict[int, Expr] = {}

  def go(e: Expr) -> Expr:
    hit = memo.get(e.expr_id)
    if hit is not None:
      return hit
    if getattr(e, "_holds_subdag", False):
      # nodes embedding a DAG in their params (RematExpr) bind their leaf
      # inputs by identity — keep them (and their leaves) intact
      memo[e.expr_id] = e
      for l in e.children():
        if isinstance(l, Val):
          stubs.pop(l.expr_id, None)
          memo[l.expr_id] = l
      return e
    if isinstance(e, Val):
      out = stubs.get(e.expr_id, e)
    else:
      changed = {}
      for name in e._members:
        v = getattr(e, name)
        if isinstance(v, Expr):
          changed[name] = go(v)
        elif isinstance(v, (list, tuple)):
          changed[name] = [go(c) if isinstance(c, Expr) else c for c in v]
      out = e.replace(**changed)
      out.tiling_hint = e.tiling_hint
    memo[e.expr_id] = out
    return out

  stripped = go(root)
  # leaves under _holds_subdag nodes stay un-stubbed (identity preserved)
  ordered_stubs = [stubs.get(l.expr_id, l) for l in leaves]
  return stripped, ordered_stubs


def _make_runner(root: Expr, leaf_index: Dict[int, int]) -> Callable:
  ctx = EmitCtx(abstract=False)

  def run(*args):
    env: Dict[int, Any] = {}

    def emit(e: Expr):
      if e.expr_id in env:
        return env[e.expr_id]
      if isinstance(e, Val):
        v = args[leaf_index[e.expr_id]]
      else:
        v = e._emit(ctx, [emit(c) for c in e.children()])
      env[e.expr_id] = v
      return v

    return emit(root)

  return run


def _out_shardings(root: Expr):
  def sh(e: Expr):
    if e.tiling_hint is not None:
      return e.tiling_hint.sharding
    return None

  # per-leaf None = "let XLA choose" — mixed pytrees are supported
  if isinstance(root, DictExpr):
    return {k: sh(v) for k, v in zip(root.keys, root.vals)}
  if isinstance(root, ListExpr):
    return tuple(sh(v) for v in root.vals)
  return sh(root)


def _wrap(root: Expr, value) -> Any:
  """Wrap jit outputs back into SpartanArrays with their tilings."""
  def wrap_one(e: Optional[Expr], v):
    tiling = e.tiling_hint if e is not None else None
    return SpartanArray(v, tiling)

  if isinstance(root, DictExpr):
    return {k: wrap_one(c, value[k]) for k, c in zip(root.keys, root.vals)}
  if isinstance(root, ListExpr):
    return [wrap_one(c, v) for c, v in zip(root.vals, value)]
  return wrap_one(root, value)


def _dag_size(expr: Expr) -> int:
  n = [0]
  expr.visit(lambda _: n.__setitem__(0, n[0] + 1))
  return n[0]


_chunking = [False]


def _chunk_evaluate(expr: Expr) -> None:
  """Segment a very deep DAG: materialize every Kth interior node in topo
  order, so each jit region XLA sees stays small (compile time on a
  multi-thousand-op region is superlinear).  Structurally identical
  segments — the common case, e.g. long ``e = e + 1`` chains — share ONE
  compiled runner via the post-optimize signature cache.  Each sub-eval
  collapses at the previous cut (CollapseCached), so regions are ~K ops.
  """
  if _chunking[0]:
    return  # the top-level call already planned the cuts; sub-evals run
            # plain (their regions collapse at previously-cached cuts)
  order: list = []

  def collect(e: Expr):
    if not isinstance(e, Val) and e._cache is None:
      order.append(e)

  expr.visit(collect)
  k = max(2, FLAGS.chunk_eval_size)
  _chunking[0] = True
  try:
    for node in order[k - 1:-1:k]:  # [:-1] keeps the root for the caller
      if node._cache is None:
        evaluate(node)
  finally:
    _chunking[0] = False


def _prepass(expr: Expr, mesh_devices):
  """ONE iterative pre-order walk computing everything the hot path needs
  (size, interior caches, leaf list in ``_collect_leaves`` order, and
  whether the rare unshapeable/stray-leaf walkers must run) — the fast
  lane previously paid ~5 separate DAG traversals per evaluation."""
  size = 0
  interior_cached = False
  has_eager = False
  has_stray = False
  leaves: List[Val] = []
  seen = set()
  stack = [expr]
  while stack:
    e = stack.pop()
    if e.expr_id in seen:
      continue
    seen.add(e.expr_id)
    size += 1
    if isinstance(e, Val):
      leaves.append(e)
      v = e.value
      if (isinstance(v, SpartanArray)
          and tuple(v.tiling.mesh.devices.flat) != mesh_devices):
        has_stray = True
      continue
    if e._cache is not None:
      interior_cached = True
      continue  # subtree collapses; don't count/collect under it
    if getattr(e, "evaluate_eager", None) is not None:
      has_eager = True
    for c in reversed(e.children()):
      stack.append(c)
  return size, interior_cached, has_eager, has_stray, leaves


def evaluate(expr: Expr):
  """Evaluate ``expr`` to SpartanArray(s), compiling its region on miss."""
  if expr._cache is not None:
    return expr._cache
  if isinstance(expr, Val):
    v = expr.value
    if isinstance(v, SpartanArray):
      return v
    result = SpartanArray(expr.leaf_value())
    expr._cache = result
    return result

  from spartan_tpu.core.mesh import get_mesh
  from spartan_tpu.expr.base import semantic_flags_fingerprint
  mesh = get_mesh()
  mesh_devices = tuple(mesh.devices.flat)
  (size, interior_cached, has_eager,
   has_stray, raw_leaves) = _prepass(expr, mesh_devices)

  # deep op chains exceed CPython's default recursion limit (the DAG
  # walkers are recursive); size the limit to the DAG once per evaluation
  import sys
  depth_budget = 10 * size + 1000
  if sys.getrecursionlimit() < depth_budget:
    sys.setrecursionlimit(min(depth_budget, 1_000_000))
  if size > FLAGS.chunk_eval_threshold:
    _chunk_evaluate(expr)
    interior_cached = True  # cuts now carry caches

  stats["evals"] += 1
  if has_eager:
    _materialize_unshapeable(expr)
    # materialization may have cached interior nodes; recheck cheaply
    flag = [interior_cached]

    def _scan(e: Expr):
      if e._cache is not None and not isinstance(e, Val):
        flag[0] = True

    expr.visit(_scan)
    interior_cached = flag[0]
  if has_stray:
    _migrate_stray_leaves(expr)

  mesh_key = (tuple(mesh.axis_names), tuple(mesh.devices.shape),
              tuple(int(d.id) for d in mesh_devices))
  flags_key = (semantic_flags_fingerprint(), _opt_flags_fingerprint(),
               mesh_key)

  # -- fast lane: skip the optimizer when this structure was seen before.
  # Only valid when no interior node carries an eval cache (a cached
  # interior changes what CollapseCached produces, invisibly to the raw
  # signature).
  raw_key = None
  if not interior_cached:
    raw_key = (expr.signature({}), flags_key)
    hit = _fast_cache.get(raw_key)
    if hit is not None:
      compiled, recipe, wrap_root = hit
      stats["fast_hits"] += 1
      args = [raw_leaves[i].leaf_value() if kind == "raw" else const
              for kind, i, const in recipe]
      if FLAGS.profile_kernels:
        with Timer("region") as t:
          out = compiled(*args)
          jax.block_until_ready(out)
        log_info("region %s (fast lane): %.4fs", type(expr).__name__,
                 t.elapsed)
      else:
        out = compiled(*args)
      result = _wrap_like(wrap_root, expr, out)
      expr._cache = result
      return result

  root = opt_mod.optimize(expr)

  leaves = _collect_leaves(root)
  leaf_index = {leaf.expr_id: i for i, leaf in enumerate(leaves)}
  sig = root.signature({})
  key = (sig, flags_key)

  compiled = _jit_cache.get(key)
  if compiled is None:
    stats["compiles"] += 1
    stripped, stub_leaves = _strip_leaf_values(root, leaves)
    stub_index = {s_.expr_id: i for i, s_ in enumerate(stub_leaves)}
    runner = _make_runner(stripped, stub_index)
    shardings = _out_shardings(stripped)
    if shardings is not None:
      compiled = jax.jit(runner, out_shardings=shardings)
    else:
      compiled = jax.jit(runner)
    _jit_cache[key] = compiled
    while len(_jit_cache) > FLAGS.max_expr_cache:
      _jit_cache.popitem(last=False)
    log_debug("compiled region for %s (%d leaves)", type(expr).__name__,
              len(leaves))
  else:
    stats["cache_hits"] += 1
    # rebind: a cache hit reuses the compiled fn with fresh leaf args, but
    # the runner closed over the *old* DAG's leaf order. The signature
    # includes structure, so leaf order is deterministic and identical —
    # only the argument values differ.

  if raw_key is not None:
    # binding recipe: each optimized leaf is either one of the raw DAG's
    # leaves (bind fresh value by position) or a pass-created constant
    # (e.g. ConstFoldCreations' scalar — fully determined by the raw
    # signature, safe to freeze).  Positions refer to the _prepass leaf
    # order — the same order the fast lane binds with.
    raw_pos = {id(l): i for i, l in enumerate(raw_leaves)}
    recipe = []
    for leaf in leaves:
      i = raw_pos.get(id(leaf))
      if i is not None:
        recipe.append(("raw", i, None))
      else:
        recipe.append(("const", -1, leaf.leaf_value()))
    wrap_root = ("dict", root.keys) if isinstance(root, DictExpr) else \
                ("list", len(root.vals)) if isinstance(root, ListExpr) else \
                ("one", None)
    hints = ([v.tiling_hint for v in root.vals]
             if isinstance(root, (ListExpr, DictExpr))
             else [root.tiling_hint])
    _fast_cache[raw_key] = (compiled, recipe, (wrap_root, hints))
    while len(_fast_cache) > FLAGS.max_expr_cache:
      _fast_cache.popitem(last=False)

  args = [leaf.leaf_value() for leaf in leaves]
  if FLAGS.profile_kernels:
    with Timer("region") as t:
      out = compiled(*args)
      jax.block_until_ready(out)
    log_info("region %s: %.4fs", type(expr).__name__, t.elapsed)
  else:
    out = compiled(*args)

  result = _wrap(root, out)
  expr._cache = result
  return result


def _wrap_like(wrap_root, expr: Expr, value) -> Any:
  """Wrap fast-lane outputs using the recorded structure + tiling hints."""
  (kind, meta), hints = wrap_root
  if kind == "dict":
    return {k: SpartanArray(value[k], hints[j])
            for j, k in enumerate(meta)}
  if kind == "list":
    return [SpartanArray(v, hints[j]) for j, v in enumerate(value)]
  return SpartanArray(value, hints[0])
