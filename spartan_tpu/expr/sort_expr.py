"""Distributed sort / percentile / median.

Rebuild of the reference's sort module (reference:
``spartan/expr/sort.py`` — sample-based distributed sort via shuffle;
SURVEY.md §2.1).  Two lowerings, picked by ``--sort_method``:

* **gather** — one traced ``jnp.sort``; XLA's SPMD plan all-gathers the
  (1-D sharded) array and sorts it redundantly per device.  Comm-optimal
  for a replicated result and the latency winner for anything that fits
  per-device memory.
* **sample** — the reference's sample+shuffle design rebuilt exactly-
  ranked on collectives (``spartan_tpu.parallel.sample_sort``): per-shard
  sort, bitwise binary search for the exact global rank boundaries, and a
  ``ragged_all_to_all`` bucket exchange — O(n/p) memory/comm per device.
  ``auto`` (default) switches to it above ``--sort_sample_threshold``
  elements.

Percentile/median/quantile on large sharded 1-D arrays use the rank
search alone (exact distributed selection): the order statistics come
back from O(log |dtype|) scalar collectives with no gather at all.
"""

from __future__ import annotations

from typing import Any, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spartan_tpu.config import FLAGS
from spartan_tpu.expr.base import EmitCtx, Expr, lazify


def _sample_routable(n: int, dtype) -> bool:
  """Shared routing predicate: does (n, dtype) take the sample path under
  the current flags + mesh?  Must depend only on static data so abstract
  (aval) and concrete emission agree."""
  if FLAGS.sort_method == "gather":
    return False
  from spartan_tpu.core.mesh import get_mesh
  from spartan_tpu.parallel import sample_sort as ss
  if not ss.routable((n,), dtype, get_mesh()):
    return False
  return FLAGS.sort_method == "sample" or n >= FLAGS.sort_sample_threshold


class SortExpr(Expr):
  _members = ("inputs",)
  _params = ("axis", "kind")

  def __init__(self, src, axis: Optional[int] = -1, kind: str = "sort"):
    super().__init__(inputs=[lazify(src)], axis=axis, kind=kind)

  def _route_sample(self, x) -> bool:
    if self.kind not in ("sort", "argsort"):
      return False
    if self.axis is None:
      n = int(np.prod(x.shape)) if x.ndim else 0
    elif x.ndim == 1 and self.axis in (0, -1):
      n = x.shape[0]
    else:
      return False
    return _sample_routable(n, x.dtype)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x = deps[0]
    # the collective sample path has no transpose rule for the ragged
    # exchange — autodiff uses the gather lowering (same aval)
    if not ctx.differentiable and self._route_sample(x):
      from spartan_tpu.core.mesh import get_mesh
      from spartan_tpu.parallel import sample_sort as ss
      xf = jnp.ravel(x) if self.axis is None else x
      return ss.sample_sort_traced(xf, get_mesh(), kind=self.kind)
    axis = self.axis
    if axis is None:
      x = jnp.ravel(x)
      axis = 0
    if self.kind == "sort":
      return jnp.sort(x, axis=axis)
    if self.kind == "argsort":
      return jnp.argsort(x, axis=axis)
    raise ValueError(self.kind)


class PercentileExpr(Expr):
  _members = ("inputs",)
  _params = ("q", "axis")

  def __init__(self, src, q, axis: Optional[int] = None):
    # normalize q to a hashable static param (float or tuple of floats)
    q = tuple(float(v) for v in q) if np.ndim(q) >= 1 else float(q)
    super().__init__(inputs=[lazify(src)], q=q, axis=axis)

  def _emit_gather(self, x):
    return jnp.percentile(
        x.astype(jnp.float64 if x.dtype.kind in "iu" else x.dtype),
        np.asarray(self.q), axis=self.axis)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x = deps[0]
    n = int(np.prod(x.shape)) if x.ndim else 0
    if (ctx.differentiable or self.axis is not None or np.ndim(self.q) > 1
        or not _sample_routable(n, x.dtype)):
      return self._emit_gather(x)
    # Distributed selection: the interpolation ranks are static (q and the
    # shape are Expr params), so fetch the exact order statistics at the
    # floor/ceil ranks and interpolate — no gather, no full sort.
    from spartan_tpu.core.mesh import get_mesh
    from spartan_tpu.parallel import sample_sort as ss
    q = np.atleast_1d(np.asarray(self.q, np.float64))
    pos = np.clip(q / 100.0, 0.0, 1.0) * (n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    ranks = sorted(set(lo.tolist()) | set(hi.tolist()))
    where = {r: i for i, r in enumerate(ranks)}
    vals = ss.rank_values(jnp.ravel(x), ranks, get_mesh())
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    v_lo = vals[np.asarray([where[r] for r in lo])].astype(fdt)
    v_hi = vals[np.asarray([where[r] for r in hi])].astype(fdt)
    out = v_lo + (v_hi - v_lo) * jnp.asarray(pos - np.floor(pos), fdt)
    if jnp.issubdtype(x.dtype, jnp.floating):
      # NaN propagation (ADVICE r2): the rank search encodes NaN as the
      # max key and would return a finite order statistic; numpy (and the
      # gather route's jnp.percentile) return NaN whenever any input is
      # NaN — emit the same.  NaN-aware callers use nanpercentile.
      out = jnp.where(jnp.any(jnp.isnan(x)), jnp.asarray(jnp.nan, fdt), out)
    # match the gather lowering's aval exactly — routing is mesh-dependent
    # but avals are cached mesh-independently, so both routes must agree.
    ref = jax.eval_shape(self._emit_gather,
                         jax.ShapeDtypeStruct(x.shape, x.dtype))
    return out.astype(ref.dtype).reshape(ref.shape)
