"""Elementwise / broadcast map over distributed arrays.

Rebuild of the reference's map op (reference:
``spartan/expr/map.py`` — ``MapExpr``/``map``/``map_with_location`` with a
per-tile ``tile_mapper`` kernel: the largest input chooses the output
tiling, other inputs are fetched/broadcast per tile; SURVEY.md §2.1, §3.2).

Device-first: the mapper runs over *global* traced arrays inside the fused
jitted region — NumPy broadcasting is jnp broadcasting, cross-tile fetches
of broadcast operands become XLA's sharding propagation, and the
"largest input chooses tiling" rule survives as the AutoTiling pass copying
the dominant input's PartitionSpec to the output.

``map_with_location`` gives kernels access to global coordinates: instead
of the reference's per-tile ``(tile, extent)`` pair, the kernel receives
``(values, coords)`` where ``coords[d]`` is the global index grid along dim
``d`` (built with ``lax.broadcasted_iota``, which XLA partitions for free).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from spartan_tpu.expr.base import EmitCtx, Expr, lazify
from spartan_tpu.expr.local import FnCallExpr, LocalExpr, LocalInput


class MapExpr(Expr):
  """Apply a fused local kernel elementwise over N inputs."""

  _members = ("inputs",)
  _params = ("op",)  # a LocalExpr tree

  def __init__(self, inputs: Sequence[Expr], op: LocalExpr):
    super().__init__(inputs=list(inputs), op=op)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return self.op.evaluate(deps)

  def _sig_local(self, memo, result):
    return ("MapExpr", self.op.signature(),
            tuple(self._child_sig(c, memo, result) for c in self.inputs))

  def pretty_op(self) -> str:
    return self.op.pretty()


class MapWithLocationExpr(Expr):
  """Map with access to global coordinates."""

  _members = ("inputs",)
  _params = ("fn", "fn_kw")

  def __init__(self, inputs: Sequence[Expr], fn: Callable, fn_kw=None):
    super().__init__(inputs=list(inputs), fn=fn, fn_kw=dict(fn_kw or {}))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    shape = deps[0].shape
    coords = tuple(
        jax.lax.broadcasted_iota(jnp.int32, shape, d)
        for d in range(len(shape)))
    return self.fn(*deps, coords, **self.fn_kw)


def map(inputs, fn: Callable, fn_kw=None, numpy_expr=None) -> MapExpr:
  """Lazy elementwise map: ``fn(*inputs)`` per element with broadcasting.

  ``numpy_expr`` is accepted for reference-API compatibility and ignored
  (the kernel itself is jax-traceable; there is no separate numpy path).
  """
  del numpy_expr
  if isinstance(inputs, Expr) or not isinstance(inputs, (list, tuple)):
    inputs = [inputs]
  exprs = [lazify(v) for v in inputs]
  op = FnCallExpr(fn, [LocalInput(i) for i in range(len(exprs))],
                  fn_kw)
  return MapExpr(inputs=exprs, op=op)


def map1(a, fn: Callable, **kw) -> MapExpr:
  return map([a], fn, fn_kw=kw or None)


def _numpy_promoting(fn: Callable) -> Callable:
  """Wrap a binary ufunc so mixed STRONG dtypes promote by NumPy's rules
  (value-preserving: int32+float32→float64) instead of jax's lattice
  (int32+float32→float32).  Weak (python-scalar) operands keep jax's
  numpy-compatible weak behavior; exotic dtypes (bfloat16) pass through.
  Promotions canonicalize, so the x64-off fast path is unchanged."""
  name = getattr(fn, "__name__", "")
  int_div = name in ("true_divide", "divide")

  def wrapped(x, y):
    if not hasattr(x, "dtype") or not hasattr(y, "dtype"):
      return fn(x, y)  # raw python scalar: weak by definition
    wx = bool(getattr(x, "weak_type", False))
    wy = bool(getattr(y, "weak_type", False))
    try:
      kx = np.dtype(x.dtype).kind
      ky = np.dtype(y.dtype).kind
    except TypeError:
      return fn(x, y)  # bfloat16 etc: jax rules
    if not wx and not wy and kx in "biufc" and ky in "biufc":
      dt = np.result_type(x.dtype, y.dtype)
      if int_div and dt.kind in "biu":
        dt = np.dtype(np.float64)  # numpy: int / int → float64
      dt = jax.dtypes.canonicalize_dtype(dt)
      return fn(x.astype(dt), y.astype(dt))
    return fn(x, y)

  wrapped.__name__ = name or "binary"
  wrapped.__qualname__ = f"np_promoting_{name}"
  return wrapped


_PROMOTING_CACHE = {}


def map2(a, b, fn: Callable) -> MapExpr:
  """Binary map with NumPy promotion semantics; scalar operands stay
  inline as weak-typed leaf values."""
  wrapped = _PROMOTING_CACHE.get(fn)
  if wrapped is None:
    wrapped = _numpy_promoting(fn)
    _PROMOTING_CACHE[fn] = wrapped
  return map([a, b], wrapped)


def map_with_location(inputs, fn: Callable, fn_kw=None) -> MapWithLocationExpr:
  """Lazy map where ``fn(*values, coords)`` sees global index grids."""
  if isinstance(inputs, Expr) or not isinstance(inputs, (list, tuple)):
    inputs = [inputs]
  return MapWithLocationExpr([lazify(v) for v in inputs], fn, fn_kw)
