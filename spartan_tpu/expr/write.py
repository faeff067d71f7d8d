"""In-place-style region writes (functional under the hood).

Rebuild of the reference's write/assign exprs (reference:
``spartan/expr/write_array.py`` / ``assign.py`` — ``write(dst_region ←
fn(src))`` region updates and scatter-assign; SURVEY.md §2.1).  The update
is a traced functional ``dst.at[region].<op>(src)`` producing a new array;
combiner semantics match ``Tile.merge`` (commutative/associative reducers).
"""

from __future__ import annotations

from typing import Any, List, Optional

import jax.numpy as jnp
from spartan_tpu.core.array import canonical_reducer
from spartan_tpu.core.extent import TileExtent
from spartan_tpu.expr.base import EmitCtx, Expr, lazify


class WriteArrayExpr(Expr):
  """``dst`` with ``src`` merged into ``region`` via ``reducer``."""

  _members = ("inputs",)
  _params = ("region", "reducer")

  def __init__(self, dst, region, src, reducer=None):
    if isinstance(region, TileExtent):
      region = region.to_slice()
    super().__init__(inputs=[lazify(dst), lazify(src)], region=region,
                     reducer=canonical_reducer(reducer))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    dst, src = deps
    at = dst.at[self.region]
    if self.reducer == "set":
      return at.set(jnp.asarray(src, dtype=dst.dtype))
    return getattr(at, self.reducer)(jnp.asarray(src, dtype=dst.dtype))


def write(dst, region, src, reducer=None) -> WriteArrayExpr:
  return WriteArrayExpr(dst, region, src, reducer)


def assign(dst, idx, src) -> WriteArrayExpr:
  """``dst[idx] = src`` as a lazy expr (reference ``assign``)."""
  return WriteArrayExpr(dst, idx, src, None)


class ScatterAssignExpr(Expr):
  """``dst`` with ``values`` scattered at integer ``indices``."""

  _members = ("inputs",)
  _params = ("reducer",)

  def __init__(self, dst, indices, values, reducer=None):
    super().__init__(inputs=[lazify(dst), lazify(indices), lazify(values)],
                     reducer=canonical_reducer(reducer))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    dst, idx, vals = deps
    at = dst.at[idx]
    if self.reducer == "set":
      return at.set(vals.astype(dst.dtype))
    return getattr(at, self.reducer)(vals.astype(dst.dtype))
