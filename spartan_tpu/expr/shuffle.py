"""Scatter-with-combiner: the generic cross-tile data-movement escape hatch.

Rebuild of the reference's shuffle op (reference:
``spartan/expr/shuffle.py`` — a per-tile fn emitting ``(extent, data)``
updates merged into a target array with a reducer, used by transpose /
sort / pagerank-style scatters; SURVEY.md §2.1).

Device-first redesign: instead of per-tile Python emitting dynamic extents
over RPC, the kernel is traced over the *global* array plus coordinate
grids and returns ``(indices, values)``; the op lowers to one XLA scatter
with the combiner (``target.at[indices].add/max/min/mul``), whose
cross-shard movement XLA compiles to the right collectives
(all-to-all / psum patterns — SURVEY.md §2.4).  Shapes stay static — the
index arrays, not the extent list, carry the data-dependence.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spartan_tpu.core.array import canonical_reducer
from spartan_tpu.expr.base import EmitCtx, Expr, lazify


class ShuffleExpr(Expr):
  """``fn(*inputs, coords) -> (indices, values)`` scattered into a zeroed,
  filled, or provided target array with a combiner."""

  _members = ("inputs",)
  _params = ("fn", "target_shape", "reducer", "fn_kw", "out_dtype", "init",
             "has_target")

  def __init__(self, inputs, fn: Callable, target_shape: Sequence[int],
               reducer=None, fn_kw=None, out_dtype=None, init=None,
               target=None, has_target: bool = False):
    if isinstance(inputs, Expr) or not isinstance(inputs, (list, tuple)):
      inputs = [inputs]
    inputs = [lazify(v) for v in inputs]
    if target is not None:
      # reference parity: updates merge INTO an existing array
      inputs = inputs + [lazify(target)]
      has_target = True
      target_shape = tuple(int(s) for s in inputs[-1].shape)
    super().__init__(inputs=inputs, fn=fn,
                     target_shape=tuple(int(s) for s in target_shape),
                     reducer=canonical_reducer(reducer),
                     fn_kw=dict(fn_kw or {}), out_dtype=out_dtype,
                     init=init, has_target=has_target)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    if self.has_target:
      data_deps, target = deps[:-1], deps[-1]
    else:
      data_deps, target = deps, None
    x = data_deps[0]
    coords = tuple(
        jax.lax.broadcasted_iota(jnp.int32, x.shape, d)
        for d in range(x.ndim))
    indices, values = self.fn(*data_deps, coords, **self.fn_kw)
    if not isinstance(indices, tuple):
      indices = (indices,)
    if target is not None:
      base = target
      dt = target.dtype
    else:
      dt = self.out_dtype or values.dtype
      if self.init is not None:
        base = jnp.full(self.target_shape, self.init, dtype=dt)
      else:
        base = jnp.zeros(self.target_shape, dtype=dt)
    at = base.at[indices]
    op = self.reducer
    if op == "set":
      return at.set(values.astype(dt))
    return getattr(at, op)(values.astype(dt))


def shuffle(v, fn: Callable, target_shape: Sequence[int] = None,
            reducer=np.add, fn_kw=None, out_dtype=None, init=None,
            target=None) -> ShuffleExpr:
  """Scatter-reduce ``fn``'s emitted ``(indices, values)`` into a fresh
  target of ``target_shape`` — or merge into an existing ``target`` array
  (the reference's update-a-DistArray form) — using ``reducer``."""
  if target is None and target_shape is None:
    raise ValueError("shuffle needs target_shape or target")
  return ShuffleExpr(v, fn, target_shape or (), reducer=reducer,
                     fn_kw=fn_kw, out_dtype=out_dtype, init=init,
                     target=target)
