"""Axis reductions with reference accumulation semantics.

Rebuild of the reference's reduce op (reference:
``spartan/expr/reduce.py`` — per-tile local reduce + combiner-merge into
output tiles, with dtype promotion / float64 accumulation; SURVEY.md §2.1,
§3.2).  The per-tile/combiner split collapses into a single traced
``jnp.<op>(x, axis, dtype=acc)`` — XLA's SPMD partitioner emits the
cross-shard combine (psum / reduce-scatter over the interconnect) that
the reference implemented as ``Tile.merge`` RPC updates.

Accumulation dtype rules (``dtype_for_reduction`` in the reference):
float inputs accumulate (and return) float64, integer/bool inputs
accumulate in the platform default int — gated by
``FLAGS.float64_reductions`` so a fast path can stay in f32.
"""

from __future__ import annotations

from typing import Any, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spartan_tpu.config import FLAGS
from spartan_tpu.expr.base import EmitCtx, Expr, lazify
from spartan_tpu.expr.local import LocalExpr


def dtype_for_reduction(dtype) -> np.dtype:
  """Accumulator/result dtype for additive reductions."""
  dtype = np.dtype(dtype)
  if dtype.kind == "b":
    return np.dtype(np.int64)
  if dtype.kind == "u":
    # numpy accumulates unsigned in uint64 (promote_types with int64
    # would give int64/float64 — wrong sign/kind)
    return np.promote_types(dtype, np.uint64)
  if dtype.kind == "i":
    # numpy promotes sub-word ints to the default int accumulator
    return np.promote_types(dtype, np.int64)
  if dtype.kind == "f" and FLAGS.float64_reductions:
    return np.promote_types(dtype, np.float64)
  if dtype.kind == "c" and FLAGS.float64_reductions:
    return np.promote_types(dtype, np.complex128)
  return dtype


def _canon(dtype) -> np.dtype:
  return jax.dtypes.canonicalize_dtype(np.dtype(dtype))


# op → (jnp reducer, needs accumulation promotion)
_ADDITIVE = {"sum", "prod", "mean", "var", "std"}


class ReduceExpr(Expr):
  """Reduce ``child`` along ``axis`` with named ``op``.

  ``local_op`` (optional LocalExpr) is a fused pre-map spliced in by
  ReduceMapFusion — the reduction reads the fused kernel's output without a
  materialized intermediate.
  """

  _members = ("inputs",)
  _params = ("op", "axis", "keepdims", "out_dtype", "local_op", "ddof")

  def __init__(self, inputs, op: str, axis=None, keepdims=False,
               out_dtype=None, local_op: Optional[LocalExpr] = None,
               ddof: int = 0):
    if isinstance(inputs, Expr):
      inputs = [inputs]
    axis = _canon_axis(axis)
    super().__init__(inputs=[lazify(v) for v in inputs], op=op, axis=axis,
                     keepdims=keepdims, out_dtype=out_dtype,
                     local_op=local_op, ddof=ddof)

  def _value(self, deps: List[Any]):
    if self.local_op is not None:
      return self.local_op.evaluate(deps)
    return deps[0]

  def _try_affine_rewrite(self, deps: List[Any]):
    """Strength-reduce ``sum(a·x + b)`` to ``a·sum(x) + b·count``.

    The fused elementwise chain of config-1-style workloads is affine in
    its one big operand; summation is linear, so the per-element work
    collapses into a scalar epilogue around a *pure* sum that runs at
    memory speed.  Flag-gated
    (``opt_affine_reduce``); float64 accumulation semantics preserved
    (both forms accumulate in the promoted dtype).
    """
    from spartan_tpu.config import FLAGS
    if self.op not in ("sum", "mean") or not FLAGS.opt_affine_reduce:
      return None
    if self.local_op is None:
      return None
    big = [k for k, d in enumerate(deps) if getattr(d, "ndim", 0) >= 1]
    if len(big) != 1:
      return None
    bi = big[0]
    affine = _extract_affine(self.local_op, bi)
    if affine is None:
      return None
    is_const, a_fn, b_fn = affine
    if is_const:
      return None
    x = deps[bi]
    if np.dtype(x.dtype).kind not in "fiu":
      return None
    # Accumulator = the node's abstract output dtype (computed over the
    # UNREWRITTEN local_op chain).  Deriving it from the raw operand was
    # wrong: sum(int_arr / 2) would truncate the 0.5 coefficient into an
    # int accumulator and silently return 0.
    acc = _canon(self.aval().dtype)
    if np.dtype(acc).kind not in "fc" and any(
        np.dtype(getattr(d, "dtype", np.float64)).kind not in "iub"
        for d in deps):
      return None  # mixed-kind corner: leave it to the unrewritten path
    a = jnp.asarray(a_fn(deps), dtype=acc)
    b = jnp.asarray(b_fn(deps), dtype=acc)
    if self.op == "sum":
      s = jnp.sum(x, axis=self.axis, dtype=acc, keepdims=self.keepdims)
      count = _reduced_count(x.shape, self.axis)
      return a * s + b * jnp.asarray(count, acc)
    # mean: E[a x + b] = a E[x] + b
    m = jnp.mean(x, axis=self.axis, dtype=acc, keepdims=self.keepdims)
    return a * m + b

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    if not ctx.abstract:
      fast = self._try_affine_rewrite(deps)
      if fast is not None:
        return fast
    # the fused pre-map and the reduction are traced together, so XLA
    # emits one pass over the operand for any elementwise chain
    x = self._value(deps)
    op, axis, keepdims = self.op, self.axis, self.keepdims
    if self.out_dtype is not None:
      acc = _canon(self.out_dtype)
    elif op in _ADDITIVE:
      acc = _canon(dtype_for_reduction(x.dtype))
    else:
      acc = None

    if op == "sum":
      return jnp.sum(x, axis=axis, dtype=acc, keepdims=keepdims)
    if op == "prod":
      return jnp.prod(x, axis=axis, dtype=acc, keepdims=keepdims)
    if op == "mean":
      if acc is not None and np.dtype(acc).kind in "iu":
        acc = _canon(np.float64)
      return jnp.mean(x, axis=axis, dtype=acc, keepdims=keepdims)
    if op in ("var", "std"):
      if acc is not None and np.dtype(acc).kind in "iu":
        acc = _canon(np.float64)
      xa = x.astype(acc) if acc is not None else x
      v = jnp.var(xa, axis=axis, ddof=self.ddof, keepdims=keepdims)
      return jnp.sqrt(v) if op == "std" else v
    if op == "max":
      return jnp.max(x, axis=axis, keepdims=keepdims)
    if op == "min":
      return jnp.min(x, axis=axis, keepdims=keepdims)
    if op == "argmax":
      return jnp.argmax(x, axis=axis, keepdims=keepdims)
    if op == "argmin":
      return jnp.argmin(x, axis=axis, keepdims=keepdims)
    if op == "all":
      return jnp.all(x, axis=axis, keepdims=keepdims)
    if op == "any":
      return jnp.any(x, axis=axis, keepdims=keepdims)
    if op == "count_nonzero":
      return jnp.count_nonzero(x, axis=axis)
    if op == "nanmax":
      return jnp.nanmax(x, axis=axis, keepdims=keepdims)
    if op == "nanmin":
      return jnp.nanmin(x, axis=axis, keepdims=keepdims)
    if op == "nansum":
      return jnp.nansum(x, axis=axis, dtype=acc, keepdims=keepdims)
    raise ValueError(f"unknown reduction {op!r}")

  def _sig_local(self, memo, result):
    return ("ReduceExpr", self.op, self.axis, self.keepdims,
            str(self.out_dtype), self.ddof,
            self.local_op.signature() if self.local_op is not None else None,
            tuple(self._child_sig(c, memo, result) for c in self.inputs))


def _canon_axis(axis):
  """NumPy-style axis → None | int | tuple[int] (single ints unwrapped)."""
  if axis is None:
    return None
  if isinstance(axis, (list, tuple, np.ndarray)):
    axes = tuple(int(a) for a in axis)
    return axes[0] if len(axes) == 1 else axes
  return int(axis)


def _reduced_count(shape, axis) -> int:
  if axis is None:
    axis = range(len(shape))
  elif not isinstance(axis, tuple):
    axis = (axis,)
  n = 1
  for a in axis:
    n *= int(shape[a % len(shape)])
  return n


def _extract_affine(node, big_idx: int):
  """Symbolically decompose a LocalExpr as ``a·x + b`` in input slot
  ``big_idx``; scalar slots stay symbolic (evaluated against the real dep
  values at emit time).  Returns ``(is_const, a_fn, b_fn)`` with
  ``a_fn/b_fn: deps -> traced scalar``, or None if non-affine."""
  from spartan_tpu.expr.local import FnCallExpr, LocalConst, LocalInput

  if isinstance(node, LocalInput):
    if node.idx == big_idx:
      return (False, lambda d: 1.0, lambda d: 0.0)
    return (True, lambda d: 0.0, lambda d, i=node.idx: d[i])
  if isinstance(node, LocalConst):
    v = node.value
    return (True, lambda d: 0.0, lambda d: v)
  if not isinstance(node, FnCallExpr) or node.kw:
    return None
  name = getattr(node.fn, "__name__", "")
  subs = [_extract_affine(c, big_idx) for c in node.deps]
  if any(s is None for s in subs):
    return None
  if name == "add" and len(subs) == 2:
    (c1, a1, b1), (c2, a2, b2) = subs
    return (c1 and c2, lambda d: a1(d) + a2(d), lambda d: b1(d) + b2(d))
  if name == "subtract" and len(subs) == 2:
    (c1, a1, b1), (c2, a2, b2) = subs
    return (c1 and c2, lambda d: a1(d) - a2(d), lambda d: b1(d) - b2(d))
  if name == "negative" and len(subs) == 1:
    (c1, a1, b1) = subs[0]
    return (c1, lambda d: -a1(d), lambda d: -b1(d))
  if name == "multiply" and len(subs) == 2:
    (c1, a1, b1), (c2, a2, b2) = subs
    if c1:
      return (c1 and c2, lambda d: b1(d) * a2(d), lambda d: b1(d) * b2(d))
    if c2:
      return (False, lambda d: a1(d) * b2(d), lambda d: b1(d) * b2(d))
    return None
  if name in ("true_divide", "divide") and len(subs) == 2:
    (c1, a1, b1), (c2, a2, b2) = subs
    if c2:
      return (c1, lambda d: a1(d) / b2(d), lambda d: b1(d) / b2(d))
    return None
  return None


class CustomReduceExpr(Expr):
  """User-supplied reduction (reference ``expr.reduce`` with
  ``local_reduce_fn``/``accumulate_fn``; reference: spartan/expr/reduce.py).

  SPMD semantics: ``fn(x, axis=axis, **fn_kw)`` runs over the
  *global* traced array inside the fused region — XLA's partitioner
  emits the cross-shard combine, so the reference's separate
  ``accumulate_fn`` (tile-partial merge) is only a consistency contract:
  the reduction must be associative for sharded execution to agree with
  single-device execution, exactly as it had to be in the reference."""

  _members = ("inputs",)
  _params = ("fn", "axis", "fn_kw")

  def __init__(self, inputs, fn, axis=None, fn_kw=None):
    if isinstance(inputs, Expr):
      inputs = [inputs]
    super().__init__(inputs=[lazify(v) for v in inputs], fn=fn, axis=axis,
                     fn_kw=dict(fn_kw or {}))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return self.fn(deps[0], axis=self.axis, **self.fn_kw)


def reduce(v, op=None, axis=None, keepdims=False, out_dtype=None,
           ddof: int = 0, dtype_fn=None, local_reduce_fn=None,
           accumulate_fn=None, fn_kw=None):
  """Named-op reduction (``op`` a string: "sum", "max", ...) or, in the
  reference's extensible form, a custom reduction via
  ``local_reduce_fn(x, axis=..., **fn_kw)``.  ``dtype_fn`` and
  ``accumulate_fn`` are accepted for API parity; with XLA there is no
  per-tile merge step — ``local_reduce_fn`` sees the global array and
  must be associative along sharded axes (same contract as the
  reference's tile-combiner)."""
  if local_reduce_fn is not None:
    del accumulate_fn, dtype_fn  # parity-only (see docstring)
    return CustomReduceExpr(v, fn=local_reduce_fn, axis=axis, fn_kw=fn_kw)
  if not isinstance(op, str):
    raise TypeError("reduce needs op=<str> or local_reduce_fn=<callable>")
  return ReduceExpr(v, op=op, axis=axis, keepdims=keepdims,
                    out_dtype=out_dtype, ddof=ddof)
