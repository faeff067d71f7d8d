"""Lazy array creation.

Rebuild of the reference's creation exprs (reference:
``spartan/expr/ndarray.py`` — ``NdArrayExpr`` lazily allocating a DistArray
with shape/dtype/tile_hint/reducer; SURVEY.md §2.1).  Creation emits
``jnp.full``/``iota``/``jax.random`` ops inside the fused region, so e.g.
``ones(...) + x`` never materializes the ones — XLA folds it.  The
``tile_hint`` survives as a sharding hint consumed by the AutoTiling pass.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spartan_tpu.expr.base import EmitCtx, Expr

_seed_counter = [0]


def _next_seed() -> int:
  _seed_counter[0] += 1
  return _seed_counter[0]


def set_random_seed(seed: int) -> None:
  """Reset the stream used to derive per-expr PRNG keys."""
  _seed_counter[0] = int(seed) * 1_000_003


class CreationExpr(Expr):
  """Materialize-free array construction (zeros/ones/full/arange/eye/rand…)."""

  _members = ()
  _params = ("op", "out_shape", "out_dtype", "params", "tile_hint")

  def __init__(self, op: str, out_shape: Sequence[int], out_dtype,
               params: Optional[Dict[str, Any]] = None,
               tile_hint: Optional[Sequence[int]] = None):
    out_shape = tuple(int(s) for s in out_shape)
    dt = jax.dtypes.canonicalize_dtype(np.dtype(out_dtype))
    super().__init__(op=op, out_shape=out_shape, out_dtype=dt,
                     params=dict(params or {}), tile_hint=tile_hint)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    op, shape, dt, p = self.op, self.out_shape, self.out_dtype, self.params
    if op == "full":
      return jnp.full(shape, p["fill"], dtype=dt)
    if op == "arange":
      return jnp.arange(p["start"], p["stop"], p["step"]).astype(dt).reshape(shape)
    if op == "linspace":
      return jnp.linspace(p["start"], p["stop"], p["num"], dtype=dt)
    if op == "eye":
      return jnp.eye(shape[0], shape[1] if len(shape) > 1 else None,
                     k=p.get("k", 0), dtype=dt)
    if op == "rand":
      key = jax.random.PRNGKey(p["seed"])
      return jax.random.uniform(key, shape, dtype=dt)
    if op == "randn":
      key = jax.random.PRNGKey(p["seed"])
      return jax.random.normal(key, shape, dtype=dt)
    if op == "randint":
      key = jax.random.PRNGKey(p["seed"])
      return jax.random.randint(key, shape, p["low"], p["high"], dtype=dt)
    if op == "bernoulli":
      key = jax.random.PRNGKey(p["seed"])
      return jax.random.bernoulli(key, p["p"], shape).astype(dt)
    if op == "exponential":
      key = jax.random.PRNGKey(p["seed"])
      return jax.random.exponential(key, shape, dtype=dt) * p["scale"]
    if op == "poisson":
      key = jax.random.PRNGKey(p["seed"])
      return jax.random.poisson(key, p["lam"], shape).astype(dt)
    if op == "binomial":
      key = jax.random.PRNGKey(p["seed"])
      return jax.random.binomial(key, p["n"], p["p"], shape=shape).astype(dt)
    if op == "beta":
      key = jax.random.PRNGKey(p["seed"])
      return jax.random.beta(key, p["a"], p["b"], shape, dtype=dt)
    if op == "gamma":
      key = jax.random.PRNGKey(p["seed"])
      return jax.random.gamma(key, p["shape_param"], shape,
                              dtype=dt) * p["scale"]
    raise ValueError(f"unknown creation op {op!r}")


def ndarray(shape, dtype=np.float64, tile_hint=None, reducer=None) -> CreationExpr:
  """Reference-parity alias: lazily allocate a zeroed distributed array.

  ``reducer`` is accepted for API compatibility; combiner semantics live on
  the update/scatter ops in the rebuild.
  """
  del reducer
  return CreationExpr("full", shape, dtype, {"fill": 0}, tile_hint)
