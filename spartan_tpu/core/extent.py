"""Tile geometry algebra.

Rebuild of the reference's extent module (reference:
``spartan/array/extent.py`` — ``TileExtent(ul, lr, array_shape)`` with
``intersection`` / ``create`` / ``compute_slice`` / ``offset_from`` /
``find_overlapping`` / ``from_slice`` and ravel/unravel index math;
SURVEY.md §2.1).  In the rebuild, extents describe logical tile rectangles
that the partitioner maps onto ``jax.sharding`` PartitionSpecs; the algebra
itself is pure Python over tuples (with an optional C fast path in
``spartan_tpu._ext``) and is deliberately JAX-free so it can run at trace
time with zero overhead on device.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

Coord = Tuple[int, ...]

# Optional C fast path (built by spartan_tpu/_ext/build.py); pure-python
# fallback keeps the module dependency-free.
try:  # pragma: no cover - exercised when the extension is built
  from spartan_tpu._ext import _extent_c  # type: ignore
except Exception:  # pragma: no cover
  _extent_c = None


class TileExtent:
  """A rectangular region ``[ul, lr)`` of an array of shape ``array_shape``.

  Immutable and hashable; coordinates are plain int tuples.
  """

  __slots__ = ("ul", "lr", "array_shape")

  def __init__(self, ul: Sequence[int], lr: Sequence[int],
               array_shape: Optional[Sequence[int]] = None):
    self.ul: Coord = tuple(int(x) for x in ul)
    self.lr: Coord = tuple(int(x) for x in lr)
    self.array_shape: Optional[Coord] = (
        tuple(int(x) for x in array_shape) if array_shape is not None else None)
    if len(self.ul) != len(self.lr):
      raise ValueError(f"rank mismatch: ul={self.ul} lr={self.lr}")
    for u, l in zip(self.ul, self.lr):
      if l < u:
        raise ValueError(f"negative extent: ul={self.ul} lr={self.lr}")

  # -- basic geometry -------------------------------------------------------

  @property
  def ndim(self) -> int:
    return len(self.ul)

  @property
  def shape(self) -> Coord:
    return tuple(l - u for u, l in zip(self.ul, self.lr))

  @property
  def size(self) -> int:
    n = 1
    for s in self.shape:
      n *= s
    return n

  def to_slice(self) -> Tuple[slice, ...]:
    return tuple(slice(u, l) for u, l in zip(self.ul, self.lr))

  def contains(self, other: "TileExtent") -> bool:
    return all(su <= ou and ol <= sl for su, sl, ou, ol in
               zip(self.ul, self.lr, other.ul, other.lr))

  def contains_point(self, pt: Sequence[int]) -> bool:
    return all(u <= p < l for u, p, l in zip(self.ul, pt, self.lr))

  def add_dim(self) -> "TileExtent":
    """Append a trailing unit dimension."""
    shape = self.array_shape + (1,) if self.array_shape is not None else None
    return TileExtent(self.ul + (0,), self.lr + (1,), shape)

  def drop_axis(self, axis: Optional[int]) -> "TileExtent":
    """Remove ``axis`` (the geometry of a reduction's output tile).

    ``axis=None`` collapses to the scalar (rank-0) extent, matching a
    full reduction.
    """
    if axis is None:
      return TileExtent((), (), ())
    axis = axis % self.ndim
    ul = self.ul[:axis] + self.ul[axis + 1:]
    lr = self.lr[:axis] + self.lr[axis + 1:]
    shape = None
    if self.array_shape is not None:
      shape = self.array_shape[:axis] + self.array_shape[axis + 1:]
    return TileExtent(ul, lr, shape)

  def transpose(self, axes: Optional[Sequence[int]] = None) -> "TileExtent":
    if axes is None:
      axes = tuple(reversed(range(self.ndim)))
    ul = tuple(self.ul[a] for a in axes)
    lr = tuple(self.lr[a] for a in axes)
    shape = (tuple(self.array_shape[a] for a in axes)
             if self.array_shape is not None else None)
    return TileExtent(ul, lr, shape)

  # -- index math -----------------------------------------------------------

  def ravelled_pos(self, pt: Optional[Sequence[int]] = None) -> int:
    """Row-major linear offset of ``pt`` (default: ``self.ul``) within the
    enclosing array."""
    if self.array_shape is None:
      raise ValueError("ravelled_pos requires array_shape")
    if pt is None:
      pt = self.ul
    pos = 0
    for p, s in zip(pt, self.array_shape):
      pos = pos * s + p
    return pos

  def to_global(self, local_idx: int) -> int:
    """Map a row-major offset *within this tile* to the row-major offset in
    the enclosing array."""
    if self.array_shape is None:
      raise ValueError("to_global requires array_shape")
    local = unravelled_pos(local_idx, self.shape)
    pt = tuple(u + o for u, o in zip(self.ul, local))
    return self.ravelled_pos(pt)

  # -- dunder ---------------------------------------------------------------

  def __eq__(self, other: object) -> bool:
    return (isinstance(other, TileExtent) and self.ul == other.ul
            and self.lr == other.lr and self.array_shape == other.array_shape)

  def __hash__(self) -> int:
    return hash((self.ul, self.lr, self.array_shape))

  def __repr__(self) -> str:
    return f"extent({self.ul}, {self.lr})"


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def create(ul: Sequence[int], lr: Sequence[int],
           array_shape: Optional[Sequence[int]]) -> TileExtent:
  return TileExtent(ul, lr, array_shape)


def from_shape(shape: Sequence[int]) -> TileExtent:
  """Extent covering a whole array."""
  shape = tuple(int(s) for s in shape)
  return TileExtent((0,) * len(shape), shape, shape)


def from_slice(idx, shape: Sequence[int]) -> TileExtent:
  """Build an extent from basic-index ``idx`` (slice / int / tuple thereof)
  against an array of ``shape``.  Integer indices keep a unit dim (callers
  squeeze separately), matching lazy-slice geometry.
  """
  shape = tuple(int(s) for s in shape)
  if not isinstance(idx, tuple):
    idx = (idx,)
  if Ellipsis in idx:
    pos = idx.index(Ellipsis)
    fill = len(shape) - (len(idx) - 1)
    idx = idx[:pos] + (slice(None),) * fill + idx[pos + 1:]
  idx = idx + (slice(None),) * (len(shape) - len(idx))
  if len(idx) > len(shape):
    raise IndexError(f"too many indices {idx} for shape {shape}")
  ul: List[int] = []
  lr: List[int] = []
  for i, (ix, dim) in enumerate(zip(idx, shape)):
    if isinstance(ix, slice):
      start, stop, step = ix.indices(dim)
      if step != 1:
        raise NotImplementedError("strided basic slicing is handled by the "
                                  "expr layer, not extent geometry")
      ul.append(start)
      lr.append(max(start, stop))
    else:
      ix = int(ix)
      if ix < 0:
        ix += dim
      if not 0 <= ix < dim:
        raise IndexError(f"index {ix} out of bounds for dim {i} size {dim}")
      ul.append(ix)
      lr.append(ix + 1)
  return TileExtent(ul, lr, shape)


# ---------------------------------------------------------------------------
# Algebra
# ---------------------------------------------------------------------------

def intersection(a: Optional[TileExtent],
                 b: Optional[TileExtent]) -> Optional[TileExtent]:
  """Overlap of two extents, or None if they are disjoint."""
  if a is None or b is None:
    return None
  ul = tuple(max(x, y) for x, y in zip(a.ul, b.ul))
  lr = tuple(min(x, y) for x, y in zip(a.lr, b.lr))
  if any(l <= u for u, l in zip(ul, lr)):
    return None
  return TileExtent(ul, lr, a.array_shape or b.array_shape)


def offset_from(base: TileExtent, other: TileExtent) -> TileExtent:
  """Express ``other`` (contained in ``base``) relative to ``base``'s
  origin."""
  if not base.contains(other):
    raise ValueError(f"{other} not contained in {base}")
  ul = tuple(o - b for o, b in zip(other.ul, base.ul))
  lr = tuple(o - b for o, b in zip(other.lr, base.ul))
  return TileExtent(ul, lr, base.shape)


def offset_slice(base: TileExtent, other: TileExtent) -> Tuple[slice, ...]:
  """Slices selecting ``other`` out of the block addressed by ``base``."""
  return offset_from(base, other).to_slice()


def compute_slice(base: TileExtent, idx) -> TileExtent:
  """Sub-extent of ``base`` selected by basic-index ``idx`` applied in
  base-local coordinates."""
  local = from_slice(idx, base.shape)
  ul = tuple(b + u for b, u in zip(base.ul, local.ul))
  lr = tuple(b + l for b, l in zip(base.ul, local.lr))
  return TileExtent(ul, lr, base.array_shape)


def shift(ext: TileExtent, offsets: Sequence[int],
          clip: bool = True) -> Optional[TileExtent]:
  """Translate an extent (used by stencil halo geometry), optionally
  clipping to the array bounds; returns None if clipped away entirely."""
  ul = tuple(u + o for u, o in zip(ext.ul, offsets))
  lr = tuple(l + o for l, o in zip(ext.lr, offsets))
  if not clip:
    return TileExtent(ul, lr, ext.array_shape)
  if ext.array_shape is None:
    raise ValueError("clip requires array_shape")
  ul = tuple(min(max(u, 0), s) for u, s in zip(ul, ext.array_shape))
  lr = tuple(min(max(l, 0), s) for l, s in zip(lr, ext.array_shape))
  if any(l <= u for u, l in zip(ul, lr)):
    return None
  return TileExtent(ul, lr, ext.array_shape)


def find_overlapping(extents: Iterable[TileExtent],
                     region: TileExtent) -> Iterator[Tuple[TileExtent, TileExtent]]:
  """Yield ``(extent, overlap)`` for every extent intersecting ``region``.

  This is the hot path of the reference's fetch/update planner; the C fast
  path batches the rectangle tests.
  """
  extents = list(extents)
  if _extent_c is not None and extents:
    hits = _extent_c.find_overlapping(
        [(e.ul, e.lr) for e in extents], (region.ul, region.lr))
    for i, (ul, lr) in hits:
      yield extents[i], TileExtent(ul, lr, region.array_shape)
    return
  for ext in extents:
    overlap = intersection(ext, region)
    if overlap is not None:
      yield ext, overlap


def unravelled_pos(idx: int, shape: Sequence[int]) -> Coord:
  """Row-major offset → coordinate tuple."""
  pos: List[int] = []
  for s in reversed(shape):
    pos.append(idx % s)
    idx //= s
  return tuple(reversed(pos))


def ravelled_pos(pt: Sequence[int], shape: Sequence[int]) -> int:
  pos = 0
  for p, s in zip(pt, shape):
    pos = pos * s + p
  return pos


def all_nonzero_shape(shape: Sequence[int]) -> bool:
  return all(s > 0 for s in shape)
