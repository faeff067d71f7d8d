"""Lazy reshape / ravel / transpose / concatenate.

Rebuild of the reference's shape ops (reference:
``spartan/expr/reshape.py`` / ``transpose.py`` — lazy reshape as a
ravelled-offset remap and transpose as an extent transpose + shuffle;
SURVEY.md §2.1).  Both become single traced XLA ops: a cross-shard reshape
or transpose is an all-to-all re-tiling XLA plans (the reference emulated
it point-to-point over RPC).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax.numpy as jnp
from spartan_tpu.expr.base import EmitCtx, Expr, lazify


class ReshapeExpr(Expr):
  _members = ("inputs",)
  _params = ("new_shape",)

  def __init__(self, src, new_shape: Sequence[int]):
    super().__init__(inputs=[lazify(src)], new_shape=tuple(new_shape))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return jnp.reshape(deps[0], self.new_shape)


class RavelExpr(Expr):
  _members = ("inputs",)
  _params = ()

  def __init__(self, src):
    super().__init__(inputs=[lazify(src)])

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return jnp.ravel(deps[0])


class TransposeExpr(Expr):
  _members = ("inputs",)
  _params = ("axes",)

  def __init__(self, src, axes: Optional[Sequence[int]] = None):
    super().__init__(inputs=[lazify(src)],
                     axes=tuple(axes) if axes is not None else None)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return jnp.transpose(deps[0], self.axes)


class ConcatenateExpr(Expr):
  _members = ("inputs",)
  _params = ("axis",)

  def __init__(self, arrays, axis: int = 0):
    super().__init__(inputs=[lazify(a) for a in arrays], axis=axis)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return jnp.concatenate(deps, axis=self.axis)


class StackExpr(Expr):
  _members = ("inputs",)
  _params = ("axis",)

  def __init__(self, arrays, axis: int = 0):
    super().__init__(inputs=[lazify(a) for a in arrays], axis=axis)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return jnp.stack(deps, axis=self.axis)


class TileExpr(Expr):
  """numpy.tile (repeat whole-array)."""

  _members = ("inputs",)
  _params = ("reps",)

  def __init__(self, src, reps):
    super().__init__(inputs=[lazify(src)], reps=reps)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return jnp.tile(deps[0], self.reps)
