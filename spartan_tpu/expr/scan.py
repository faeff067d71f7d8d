"""Prefix scans.

Rebuild of the reference's scan op (reference:
``spartan/expr/scan.py`` — per-tile local scan, cross-tile carry, offset
fix-up map; SURVEY.md §2.1).  The three-phase tile algorithm collapses into
one traced ``jax.lax.associative_scan`` / ``jnp.cumsum`` — XLA partitions
the work-efficient scan across shards, with the cross-shard carry riding
ICI collectives.
"""

from __future__ import annotations

from typing import Any, List, Optional

import jax
import jax.numpy as jnp
from spartan_tpu.expr.base import EmitCtx, Expr, lazify
from spartan_tpu.expr.reduce import dtype_for_reduction


class ScanExpr(Expr):
  _members = ("inputs",)
  _params = ("op", "axis")

  def __init__(self, src, op: str = "sum", axis: Optional[int] = None):
    super().__init__(inputs=[lazify(src)], op=op, axis=axis)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x = deps[0]
    axis = self.axis
    if axis is None:
      x = jnp.ravel(x)
      axis = 0
    if self.op == "sum":
      acc = jax.dtypes.canonicalize_dtype(dtype_for_reduction(x.dtype))
      return jnp.cumsum(x, axis=axis, dtype=acc)
    if self.op == "prod":
      acc = jax.dtypes.canonicalize_dtype(dtype_for_reduction(x.dtype))
      return jnp.cumprod(x, axis=axis, dtype=acc)
    if self.op == "max":
      return jax.lax.associative_scan(jnp.maximum, x, axis=axis)
    if self.op == "min":
      return jax.lax.associative_scan(jnp.minimum, x, axis=axis)
    raise ValueError(f"unknown scan op {self.op!r}")


class CustomScanExpr(Expr):
  """User-supplied prefix scan (the reference's extensible scan form):
  ``scan_fn`` is a binary ASSOCIATIVE combiner traced into one
  ``jax.lax.associative_scan`` — XLA partitions the work-efficient scan
  and emits the cross-shard carry, the same contract the reference's
  per-tile scan + carry phases imposed."""

  _members = ("inputs",)
  _params = ("fn", "axis", "reverse")

  def __init__(self, src, fn, axis=None, reverse=False):
    super().__init__(inputs=[lazify(src)], fn=fn, axis=axis,
                     reverse=bool(reverse))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x = deps[0]
    axis = self.axis
    if axis is None:
      x = jnp.ravel(x)
      axis = 0
    return jax.lax.associative_scan(self.fn, x, axis=axis,
                                    reverse=self.reverse)


def scan(v, op: str = "sum", axis: Optional[int] = None, scan_fn=None,
         reverse: bool = False):
  """Named-op prefix scan, or the extensible form via ``scan_fn(a, b)``
  (binary associative combiner, e.g. log-sum-exp accumulation).
  ``reverse=True`` gives the suffix scan (both forms)."""
  if scan_fn is not None:
    return CustomScanExpr(v, fn=scan_fn, axis=axis, reverse=reverse)
  if reverse:
    # suffix scan for named ops: flip → prefix scan → flip (keeps the
    # f64-accumulation semantics of ScanExpr)
    from spartan_tpu.expr.builtins import flip, ravel
    src = lazify(v)
    if axis is None:
      src, axis = ravel(src), 0
    return flip(ScanExpr(flip(src, axis=axis), op=op, axis=axis),
                axis=axis)
  return ScanExpr(v, op=op, axis=axis)
