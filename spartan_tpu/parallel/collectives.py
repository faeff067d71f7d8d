"""Explicit collective primitives over the mesh.

The reference's communication layer was a bespoke master/worker RPC with
every collective pattern emulated point-to-point (reference:
``spartan/rpc/``, ``spartan/blob_ctx.py``; SURVEY.md §2.4).  The rebuild
deletes that layer: most data movement is *implicit* (XLA chooses the
collective from shardings).  This module is the *explicit* escape hatch —
``shard_map`` + hand-placed collectives for when the comm schedule must be
in our hands:

* :func:`reshard` — re-tiling; XLA plans the minimal collective
  (all-to-all / all-gather), cf. the reference's ShuffleExpr re-tiles;
* :func:`ring_shift` — circular shift along a sharded dim via a
  ``lax.ppermute`` ring — the CP/ring-attention primitive (SURVEY.md §2.3),
  applied here to stencil halos since the reference has no attention;
* :func:`halo_exchange` — pad each shard with neighbor boundary rows
  (zero-filled at array edges) — the reference stencil's neighbor-tile
  fetch, as one interconnect ring step;
* :func:`all_to_all_retile` — switch which dim is sharded in one
  ``lax.all_to_all`` (the Ulysses primitive; reference analogue:
  transpose-shuffles).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from spartan_tpu.core.array import SpartanArray
from spartan_tpu.core.mesh import get_mesh
from spartan_tpu.core.tiling import Tiling


def _as_jax(x):
  return x.data if isinstance(x, SpartanArray) else x


def reshard(arr: SpartanArray, spec: PartitionSpec,
            mesh: Optional[Mesh] = None) -> SpartanArray:
  """Move an array to a new PartitionSpec; XLA plans the collective."""
  mesh = mesh or arr.tiling.mesh
  tiling = Tiling(mesh, spec)
  return SpartanArray(jax.device_put(arr.data, tiling.sharding), tiling)


def _flat_axis(mesh: Mesh) -> Tuple[str, ...]:
  return tuple(mesh.axis_names)


def ring_shift(x, shift: int, mesh: Optional[Mesh] = None,
               axis_name: Union[str, Tuple[str, ...], None] = None):
  """Circular shift (np.roll) along dim 0 of an array sharded over
  ``axis_name``, with the cross-shard exchange as an explicit ppermute
  ring.  ``shift`` must satisfy ``|shift| <= shard_rows``.
  """
  mesh = mesh or get_mesh()
  if axis_name is None:
    axis_name = _flat_axis(mesh)
  axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
  data = _as_jax(x)
  n_shards = 1
  for a in axes:
    n_shards *= mesh.shape[a]
  rows = data.shape[0]
  if rows % n_shards != 0:
    raise ValueError(f"dim 0 ({rows}) must divide over {n_shards} shards")
  if abs(shift) > rows // n_shards:
    raise ValueError("|shift| must be <= rows per shard; compose calls")
  spec = PartitionSpec(axes if len(axes) > 1 else axes[0])

  def body(xs):
    if shift == 0:
      return xs
    idx = lax.axis_index(axes)
    n = n_shards
    if shift > 0:
      # each shard's last `shift` rows go to the next shard
      boundary = xs[-shift:]
      perm = [(i, (i + 1) % n) for i in range(n)]
      recv = lax.ppermute(boundary, axes, perm)
      return jnp.concatenate([recv, xs[:-shift]], axis=0)
    else:
      s = -shift
      boundary = xs[:s]
      perm = [(i, (i - 1) % n) for i in range(n)]
      recv = lax.ppermute(boundary, axes, perm)
      return jnp.concatenate([xs[s:], recv], axis=0)

  fn = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)
  out = fn(jax.device_put(data, NamedSharding(mesh, spec)))
  if isinstance(x, SpartanArray):
    return SpartanArray(out, Tiling(mesh, spec))
  return out


def halo_exchange(x, halo: int, mesh: Optional[Mesh] = None,
                  axis_name: Union[str, Tuple[str, ...], None] = None):
  """Return per-shard blocks padded with ``halo`` boundary rows from each
  neighbor (zeros at the global array edges): output dim 0 grows by
  ``2*halo*n_shards``.  One ppermute ring in each direction — the
  reference stencil's neighbor-tile fetch (SURVEY.md §2.3).
  """
  mesh = mesh or get_mesh()
  if axis_name is None:
    axis_name = _flat_axis(mesh)
  axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
  data = _as_jax(x)
  n = 1
  for a in axes:
    n *= mesh.shape[a]
  rows = data.shape[0]
  if rows % n != 0 or rows // n < halo:
    raise ValueError(f"need halo <= rows/shard; rows={rows} shards={n}")
  spec = PartitionSpec(axes if len(axes) > 1 else axes[0])

  def body(xs):
    idx = lax.axis_index(axes)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    from_above = lax.ppermute(xs[-halo:], axes, fwd)   # prev shard's tail
    from_below = lax.ppermute(xs[:halo], axes, bwd)    # next shard's head
    zero = jnp.zeros_like(from_above)
    top = jnp.where(idx == 0, zero, from_above)
    bot = jnp.where(idx == n - 1, zero, from_below)
    return jnp.concatenate([top, xs, bot], axis=0)

  fn = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)
  return fn(jax.device_put(data, NamedSharding(mesh, spec)))


def stencil1d_halo(x, kernel, mesh: Optional[Mesh] = None):
  """1-D 'SAME' correlation along dim 0 of a sharded array computed with an
  explicit halo exchange (no XLA auto-halo): demonstrates the
  CP-ring-applied-to-stencils pattern end-to-end."""
  mesh = mesh or get_mesh()
  kernel = jnp.asarray(kernel)
  k = kernel.shape[0]
  if k % 2 == 0:
    raise ValueError(f"stencil1d_halo needs an odd-length kernel (got {k}) "
                     "— 'SAME' centering is ambiguous for even lengths")
  halo = k // 2
  axes = _flat_axis(mesh)
  n = 1
  for a in axes:
    n *= mesh.shape[a]
  data = _as_jax(x)
  spec = PartitionSpec(axes if len(axes) > 1 else axes[0])

  def body(xs):
    idx = lax.axis_index(axes)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    from_above = lax.ppermute(xs[-halo:], axes, fwd)
    from_below = lax.ppermute(xs[:halo], axes, bwd)
    zero = jnp.zeros_like(from_above)
    top = jnp.where(idx == 0, zero, from_above)
    bot = jnp.where(idx == n - 1, zero, from_below)
    padded = jnp.concatenate([top, xs, bot], axis=0)
    # local VALID correlation over the padded block
    segs = [padded[i:i + xs.shape[0]] * kernel[i] for i in range(k)]
    return sum(segs)

  fn = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)
  return fn(jax.device_put(data, NamedSharding(mesh, spec)))


def all_to_all_retile(x, mesh: Optional[Mesh] = None):
  """Switch a 2-D array from row-sharded to column-sharded with one
  explicit ``lax.all_to_all`` (the Ulysses primitive)."""
  mesh = mesh or get_mesh()
  axes = _flat_axis(mesh)
  n = 1
  for a in axes:
    n *= mesh.shape[a]
  data = _as_jax(x)
  if data.ndim != 2 or data.shape[0] % n or data.shape[1] % n:
    raise ValueError("need 2-D array with both dims divisible by the mesh")
  in_spec = PartitionSpec(axes if len(axes) > 1 else axes[0], None)
  out_spec = PartitionSpec(None, axes if len(axes) > 1 else axes[0])

  def body(xs):
    # xs: (rows/n, cols) → (rows, cols/n)
    return lax.all_to_all(xs, axes, split_axis=1, concat_axis=0, tiled=True)

  fn = jax.shard_map(body, mesh=mesh, in_specs=in_spec, out_specs=out_spec)
  return fn(jax.device_put(data, NamedSharding(mesh, in_spec)))


def map_tiles(x, fn, mesh: Optional[Mesh] = None):
  """Run ``fn(block, ul)`` on every tile in parallel — the reference's
  per-tile kernel dispatch (``blob_ctx.map`` → ``Worker.run_kernel``,
  SURVEY.md §3.2) as one shard_map: ``block`` is the local shard,
  ``ul`` a tuple of traced global offsets of its upper-left corner.
  ``fn`` must return a block of the same shape (owner-computes)."""
  from spartan_tpu.core.array import SpartanArray
  if not isinstance(x, SpartanArray):
    raise TypeError("map_tiles needs a materialized SpartanArray")
  mesh = mesh or x.tiling.mesh
  spec = x.tiling.spec
  entries = tuple(spec) + (None,) * (x.ndim - len(tuple(spec)))
  grid = x.tiling.grid_shape(x.shape)
  tile_shape = x.tiling.tile_shape(x.shape)

  def body(xs):
    ul = []
    for d, entry in enumerate(entries):
      if entry is None:
        ul.append(jnp.zeros((), jnp.int32))
      else:
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        idx = lax.axis_index(tuple(axes) if len(axes) > 1 else axes[0])
        ul.append((idx * tile_shape[d]).astype(jnp.int32))
    out = fn(xs, tuple(ul))
    if out.shape != xs.shape:
      raise ValueError(f"map_tiles fn changed the block shape: "
                       f"{xs.shape} -> {out.shape}")
    return out

  f = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)
  return SpartanArray(f(x.data), x.tiling)


def psum_across(x, mesh: Optional[Mesh] = None):
  """Explicit all-reduce of per-shard partials (the reference's
  update+add-reducer across workers)."""
  mesh = mesh or get_mesh()
  axes = _flat_axis(mesh)
  spec = PartitionSpec(axes if len(axes) > 1 else axes[0])
  data = _as_jax(x)

  def body(xs):
    return lax.psum(xs, axes)

  fn = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=PartitionSpec())
  return fn(jax.device_put(data, NamedSharding(mesh, spec)))
