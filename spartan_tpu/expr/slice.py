"""Lazy basic slicing and fancy/boolean indexing.

Rebuild of the reference's slicing layer (reference:
``spartan/expr/slice.py`` — lazy ``SliceExpr`` via extent intersection, no
copy until forced — plus the fancy/boolean indexing module; SURVEY.md
§2.1, §3.4).  Basic slices and integer-array gathers stay inside the
traced region (a forced cross-shard slice is just a resharding XLA plans);
boolean-mask selection has a data-dependent output shape, so it raises
:class:`NotShapeable` and the evaluator materializes it eagerly — the same
boundary the reference drew.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import jax.numpy as jnp
import numpy as np

from spartan_tpu.expr.base import EmitCtx, Expr, NotShapeable, lazify


def _is_basic(idx) -> bool:
  if isinstance(idx, (int, np.integer, slice)) or idx is None or idx is Ellipsis:
    return True
  if isinstance(idx, tuple):
    return all(_is_basic(i) for i in idx)
  return False


def _is_bool_mask(idx) -> bool:
  if isinstance(idx, Expr):
    try:
      return np.dtype(idx.dtype).kind == "b"
    except NotShapeable:
      return False
  arr = np.asarray(idx) if isinstance(idx, (np.ndarray, list)) else None
  return arr is not None and arr.dtype.kind == "b"


class SliceExpr(Expr):
  """Basic (rect) slicing — stays lazy and traced."""

  _members = ("inputs",)
  _params = ("idx",)

  def __init__(self, src, idx):
    super().__init__(inputs=[lazify(src)], idx=idx)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return deps[0][self.idx]


class FancyIndexExpr(Expr):
  """Integer-array gather — traced (static output shape)."""

  _members = ("inputs",)
  _params = ()

  def __init__(self, src, indices):
    super().__init__(inputs=[lazify(src), lazify(indices)])

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    src, idx = deps
    return src[idx.astype(jnp.int32) if idx.dtype.kind == "i" else idx]


class BooleanMaskExpr(Expr):
  """Boolean-mask selection — data-dependent shape ⇒ eager boundary."""

  _members = ("inputs",)
  _params = ()

  def __init__(self, src, mask):
    super().__init__(inputs=[lazify(src), lazify(mask)])

  def aval(self):
    raise NotShapeable(f"boolean mask selection has data-dependent shape")

  def _emit(self, ctx, deps):
    raise NotShapeable("boolean mask selection must be evaluated eagerly")

  def evaluate_eager(self):
    """Host-side evaluation (the materialization boundary)."""
    from spartan_tpu.core.array import from_numpy
    src = self.inputs[0].evaluate().glom()
    mask = self.inputs[1].evaluate().glom()
    return from_numpy(src[mask])


class MultiIndexExpr(Expr):
  """Advanced indexing with a tuple mixing arrays and basic parts
  (``x[rows, cols]``, ``x[rows, 1:5]``) — traced, static output shape.
  The tuple structure lives in ``template`` (array slots marked by
  position); array parts are child exprs."""

  _members = ("inputs",)
  _params = ("template",)

  _SLOT = "__array_slot__"

  def __init__(self, src, parts):
    template = []
    arrays = []
    for p in parts:
      if isinstance(p, Expr) or isinstance(p, (np.ndarray, list)):
        template.append(self._SLOT)
        arrays.append(lazify(p))
      else:
        template.append(p)
    super().__init__(inputs=[lazify(src)] + arrays, template=tuple(template))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    src = deps[0]
    arrays = list(deps[1:])
    idx = []
    for t in self.template:
      if t == self._SLOT:
        a = arrays.pop(0)
        idx.append(a.astype(jnp.int32) if a.dtype.kind in "iu" else a)
      else:
        idx.append(t)
    return src[tuple(idx)]


def _tuple_has_array(idx) -> bool:
  return isinstance(idx, tuple) and any(
      isinstance(p, (Expr, np.ndarray, list)) for p in idx)


def _tuple_has_bool(idx) -> bool:
  for p in idx:
    if isinstance(p, Expr):
      try:
        if np.dtype(p.dtype).kind == "b":
          return True
      except NotShapeable:
        return True
    elif isinstance(p, (np.ndarray, list)):
      if np.asarray(p).dtype.kind == "b":
        return True
  return False


def _index_dims_consumed(p) -> int:
  """How many axes of the source one index part consumes: bool scalars
  and None add an axis (consume 0), a k-D boolean mask consumes k,
  everything else consumes 1."""
  if p is None or isinstance(p, (bool, np.bool_)):
    return 0
  if isinstance(p, (np.ndarray, list)):
    arr = np.asarray(p)
    if arr.dtype.kind == "b":
      return arr.ndim
  if isinstance(p, Expr):
    try:
      if np.dtype(p.dtype).kind == "b":
        return p.ndim
    except NotShapeable:
      pass
  return 1


def _check_static_index_bounds(src, idx) -> None:
  """numpy parity: STATIC (python int / host ndarray) integer indices
  out of range raise IndexError at construction — jax alone silently
  clamps at trace time.  Traced (Expr) indices keep clamp semantics (no
  data-dependent errors under jit).  One walker covers basic and
  advanced tuples so the two paths cannot drift (r3-s4 review)."""
  try:
    shape = lazify(src).shape
  except NotShapeable:
    return
  parts = idx if isinstance(idx, tuple) else (idx,)
  n_real = sum(_index_dims_consumed(p) for p in parts if p is not Ellipsis)
  dim = 0
  for p in parts:
    if p is Ellipsis:
      dim += len(shape) - n_real
      continue
    consumed = _index_dims_consumed(p)
    if consumed == 1 and dim < len(shape):
      d = shape[dim]
      if isinstance(p, (int, np.integer)):
        if not (-d <= int(p) < d):
          raise IndexError(
              f"index {int(p)} is out of bounds for axis {dim} with "
              f"size {d}")
      elif isinstance(p, (np.ndarray, list)):
        arr = np.asarray(p)
        if arr.dtype.kind in "iu" and arr.size:
          lo, hi = int(arr.min()), int(arr.max())
          if lo < -d or hi >= d:
            bad = lo if lo < -d else hi
            raise IndexError(
                f"index {bad} is out of bounds for axis {dim} with "
                f"size {d}")
    dim += consumed


def make_slice(src, idx) -> Expr:
  """Dispatch ``src[idx]`` to the right expr node (reference
  ``Expr.__getitem__``)."""
  if _is_bool_mask(idx):
    return BooleanMaskExpr(src, idx)
  _check_static_index_bounds(src, idx)
  if _is_basic(idx):
    return SliceExpr(src, idx)
  if _tuple_has_array(idx):
    if _tuple_has_bool(idx):
      # boolean inside a tuple: data-dependent shape → eager numpy
      from spartan_tpu.expr.fio import HostExpr
      parts = [p for p in idx if isinstance(p, (Expr, np.ndarray, list))]
      template = tuple("__array_slot__" if isinstance(
          p, (Expr, np.ndarray, list)) else p for p in idx)

      def host_index(s, *arrays):
        arrays = list(arrays)
        full = tuple(arrays.pop(0) if t == "__array_slot__" else t
                     for t in template)
        return s[full]

      return HostExpr([src] + parts, host_index)
    return MultiIndexExpr(src, idx)
  return FancyIndexExpr(src, idx)
