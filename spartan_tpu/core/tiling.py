"""Tiling: logical tile grids ↔ physical shardings.

Rebuild of the reference's tile/partitioner layer (reference:
``spartan/array/distarray.py`` — ``{TileExtent → blob_id}`` maps built from
``tile_hint``s; SURVEY.md §2.1, §7).  A :class:`Tiling` pairs a mesh with a
``PartitionSpec``; the logical tile grid (the list of per-shard
:class:`~spartan_tpu.core.extent.TileExtent` rectangles) is derived from the
sharding's exact index map, so logical geometry and physical placement can
never drift apart.

``tile_hint`` keeps the reference's ergonomics: a requested tile *shape*
(e.g. ``(1000, 1000)`` on a ``(4000, 4000)`` array → a 4×4 grid) is
translated into the choice of which dims the mesh axes split.  The smart
tiling pass (``spartan_tpu/expr/optimize.py``) picks specs for intermediate
arrays to minimize resharding collectives.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from spartan_tpu.core.extent import TileExtent
from spartan_tpu.core.mesh import get_mesh


class Tiling:
  """A mesh plus a PartitionSpec: the placement of one array."""

  __slots__ = ("mesh", "spec")

  def __init__(self, mesh: Mesh, spec: PartitionSpec):
    self.mesh = mesh
    self.spec = spec

  @property
  def sharding(self) -> NamedSharding:
    return NamedSharding(self.mesh, self.spec)

  def _axis_size(self, entry) -> int:
    if entry is None:
      return 1
    if isinstance(entry, (tuple, list)):
      n = 1
      for a in entry:
        n *= self.mesh.shape[a]
      return n
    return self.mesh.shape[entry]

  def grid_shape(self, array_shape: Sequence[int]) -> Tuple[int, ...]:
    """Number of tiles along each dim."""
    spec = tuple(self.spec) + (None,) * (len(array_shape) - len(tuple(self.spec)))
    return tuple(min(self._axis_size(e), s) if s > 0 else 1
                 for e, s in zip(spec, array_shape))

  def tile_shape(self, array_shape: Sequence[int]) -> Tuple[int, ...]:
    """Shape of a (non-edge) tile."""
    return tuple(-(-s // g) for s, g in
                 zip(array_shape, self.grid_shape(array_shape)))

  def extents(self, array_shape: Sequence[int]) -> List[TileExtent]:
    """Logical tile rectangles in row-major grid order, derived from the
    sharding's exact per-device index map (deduplicated across replicas)."""
    array_shape = tuple(int(s) for s in array_shape)
    seen = {}
    for _, idx in self.sharding.devices_indices_map(array_shape).items():
      ul = tuple((sl.start or 0) for sl in idx)
      lr = tuple(sl.stop if sl.stop is not None else s
                 for sl, s in zip(idx, array_shape))
      if any(l <= u for u, l in zip(ul, lr)) and array_shape:
        continue
      seen[(ul, lr)] = TileExtent(ul, lr, array_shape)
    return sorted(seen.values(), key=lambda e: e.ul)

  def num_tiles(self, array_shape: Sequence[int]) -> int:
    return int(np.prod(self.grid_shape(array_shape))) if array_shape else 1

  def with_spec(self, spec: PartitionSpec) -> "Tiling":
    return Tiling(self.mesh, spec)

  def __eq__(self, other):
    return (isinstance(other, Tiling) and self.mesh == other.mesh
            and tuple(self.spec) == tuple(other.spec))

  def __hash__(self):
    return hash((id(self.mesh), tuple(self.spec)))

  def __repr__(self):
    return f"Tiling(mesh={dict(self.mesh.shape)}, spec={self.spec})"


# ---------------------------------------------------------------------------
# Tiling choice ("smart tiling" defaults; the DAG-level pass lives in
# expr/optimize.py and calls into these helpers)
# ---------------------------------------------------------------------------

def split_dims_from_hint(shape: Sequence[int],
                         tile_hint: Optional[Sequence[int]]) -> List[int]:
  """Which dims does a reference-style ``tile_hint`` (a tile *shape*) ask us
  to split?  A dim is split when the hinted tile is smaller than the dim."""
  if tile_hint is None:
    return []
  return [i for i, (t, s) in enumerate(zip(tile_hint, shape)) if t < s]


def choose_spec(shape: Sequence[int], mesh: Mesh,
                split_dims: Optional[Sequence[int]] = None,
                nbytes: Optional[int] = None) -> PartitionSpec:
  """Map mesh axes onto array dims.

  Default policy (no explicit split dims): split the largest dims.  For a
  rank≥2 array on a 2-D mesh, dims get one axis each (2-D tile grid, the
  reference's default for matrices); rank-1 arrays shard over all axes
  flattened.  Dims smaller than their axis stay unsplit (replicated over
  that axis) — tiny arrays are replicated outright.

  Arrays below ``FLAGS.replicate_small_bytes`` are replicated: sharding
  them saves no memory worth having, and gathers *from* a small sharded
  array force cross-shard collectives (or SPMD rematerialization) in
  every consumer — the netflix-factors lesson generalized.  ``nbytes``
  is the real byte size when the caller knows it (8 bytes/element is
  assumed otherwise).  Explicit ``split_dims`` (a user tile_hint) wins.
  """
  shape = tuple(int(s) for s in shape)
  axes = list(mesh.axis_names)
  if not shape or any(s == 0 for s in shape):
    # XLA treats empty arrays as replicated; any sharded spec conflicts
    return PartitionSpec()
  if split_dims is None:
    from spartan_tpu.config import FLAGS
    est = nbytes if nbytes is not None else int(np.prod(shape)) * 8
    if est < FLAGS.replicate_small_bytes:
      return PartitionSpec()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    split_dims = [i for i in order if shape[i] > 1][: len(axes)]
    split_dims.sort()
  else:
    split_dims = sorted(set(int(d) % len(shape) for d in split_dims))

  # XLA shardings require each dim divisible by its shard count — the tiler
  # only ever proposes even splits (Device-first: static, aligned tiles).
  entries: List = [None] * len(shape)
  if len(split_dims) == 1:
    d = split_dims[0]
    # all mesh axes gang up on the single split dim while it stays divisible
    usable = []
    prod = 1
    for a in axes:
      if shape[d] % (prod * mesh.shape[a]) == 0:
        usable.append(a)
        prod *= mesh.shape[a]
    if usable:
      entries[d] = tuple(usable) if len(usable) > 1 else usable[0]
  elif split_dims:
    # one axis per dim, largest axes to largest dims, divisibility required;
    # unassigned axes retry on remaining dims
    dims_by_size = sorted(split_dims, key=lambda i: -shape[i])
    axes_left = sorted(axes, key=lambda a: -mesh.shape[a])
    for d in dims_by_size:
      for a in list(axes_left):
        if shape[d] % mesh.shape[a] == 0:
          entries[d] = a
          axes_left.remove(a)
          break
  while entries and entries[-1] is None:
    entries.pop()
  return PartitionSpec(*entries)


def auto_tiling(shape: Sequence[int],
                tile_hint: Optional[Sequence[int]] = None,
                mesh: Optional[Mesh] = None,
                nbytes: Optional[int] = None) -> Tiling:
  """Default tiling for a freshly-created array."""
  mesh = mesh or get_mesh()
  split = split_dims_from_hint(shape, tile_hint) if tile_hint is not None else None
  if split == []:
    # hint says "one big tile" → replicate
    return Tiling(mesh, PartitionSpec())
  return Tiling(mesh, choose_spec(shape, mesh, split, nbytes=nbytes))


def replicated_tiling(mesh: Optional[Mesh] = None) -> Tiling:
  return Tiling(mesh or get_mesh(), PartitionSpec())
