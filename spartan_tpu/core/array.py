"""SpartanArray: the distributed array object.

Rebuild of the reference's DistArray (reference:
``spartan/array/distarray.py`` — extent→blob map with
``create/fetch/update/foreach_tile/glom/select`` and a ``Broadcast``
wrapper; SURVEY.md §2.1, §3.4).  Here the extent→blob map *is* a sharded
``jax.Array``: XLA owns placement and movement, so

- ``glom()``      → ``jax.device_get`` of the global value,
- ``fetch(ext)``  → a (jitted) slice + gather,
- ``update(...)`` → a functional scatter-merge (``.at[].op``) producing a
  new array — combiners (`np.add`-style reducers) become scatter ops that
  XLA lowers to ``psum``/``reduce_scatter`` when shards overlap,
- ``foreach_tile``→ host-side iteration over logical tile extents (debug /
  IO paths only; compute never routes through it).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spartan_tpu.core.extent import TileExtent
from spartan_tpu.core.mesh import get_mesh
from spartan_tpu.core.tiling import Tiling, auto_tiling, replicated_tiling

# reducer registry: the reference passes raw np ufuncs (np.add, np.maximum)
# as tile-merge combiners; map them to jnp scatter ops / ufuncs.
_REDUCERS = {
    None: "set",
    "set": "set",
    np.add: "add", jnp.add: "add", "add": "add", "sum": "add",
    np.multiply: "mul", jnp.multiply: "mul", "mul": "mul",
    np.maximum: "max", jnp.maximum: "max", "max": "max",
    np.minimum: "min", jnp.minimum: "min", "min": "min",
}


def canonical_reducer(reducer: Any) -> str:
  try:
    if reducer in _REDUCERS:
      return _REDUCERS[reducer]
  except TypeError:
    pass
  if callable(reducer):
    name = getattr(reducer, "__name__", "")
    if name in _REDUCERS:
      return _REDUCERS[name]
  raise ValueError(f"unsupported reducer {reducer!r}; expected one of "
                   "None/np.add/np.multiply/np.maximum/np.minimum")


class SpartanArray:
  """A sharded device array plus its logical tiling metadata."""

  __slots__ = ("data", "tiling")

  def __init__(self, data: jax.Array, tiling: Optional[Tiling] = None):
    if tiling is None:
      sh = getattr(data, "sharding", None)
      if sh is not None and hasattr(sh, "mesh") and hasattr(sh, "spec"):
        tiling = Tiling(sh.mesh, sh.spec)
      else:
        tiling = replicated_tiling()
    self.data = data
    self.tiling = tiling

  # -- basic properties -----------------------------------------------------

  @property
  def shape(self) -> Tuple[int, ...]:
    return tuple(self.data.shape)

  @property
  def dtype(self):
    return self.data.dtype

  @property
  def ndim(self) -> int:
    return self.data.ndim

  @property
  def size(self) -> int:
    return int(self.data.size)

  @property
  def sharding(self):
    return self.tiling.sharding

  def tile_extents(self) -> List[TileExtent]:
    return self.tiling.extents(self.shape)

  @property
  def tile_shape(self) -> Tuple[int, ...]:
    return self.tiling.tile_shape(self.shape)

  # -- data movement --------------------------------------------------------

  def glom(self) -> np.ndarray:
    """Gather the full array to the host (reference ``DistArray.glom``)."""
    return np.asarray(jax.device_get(self.data))

  def fetch(self, region) -> np.ndarray:
    """Gather an arbitrary rectangle to the host (reference
    ``DistArray.fetch(extent)``)."""
    if isinstance(region, TileExtent):
      idx = region.to_slice()
    else:
      idx = region
    return np.asarray(jax.device_get(self.data[idx]))

  def update(self, region, value, reducer: Any = None) -> "SpartanArray":
    """Functional scatter-merge of ``value`` into ``region`` with a
    combiner (reference ``DistArray.update`` + ``Tile.merge``)."""
    op = canonical_reducer(reducer)
    idx = region.to_slice() if isinstance(region, TileExtent) else region
    value = jnp.asarray(value, dtype=self.dtype)
    at = self.data.at[idx]
    new = getattr(at, "set" if op == "set" else op)(value)
    new = jax.device_put(new, self.sharding)
    return SpartanArray(new, self.tiling)

  def foreach_tile(self, fn: Callable[[TileExtent, np.ndarray], None]) -> None:
    """Host-side visit of every logical tile (debug/IO only)."""
    host = self.glom()
    for ext in self.tile_extents():
      fn(ext, host[ext.to_slice()])

  def select(self, idx) -> np.ndarray:
    """Host gather of a sub-region (reference ``DistArray.select``)."""
    return self.fetch(idx)

  def reshard(self, tiling: Tiling) -> "SpartanArray":
    """Move to a new tiling — XLA plans the minimal resharding collective."""
    return SpartanArray(jax.device_put(self.data, tiling.sharding), tiling)

  def reshard_(self, tiling: Tiling) -> "SpartanArray":
    """In-place re-placement: every holder of this array sees the new
    layout afterwards (the reference master's tile migration, reference
    ``distarray`` re-assignment).  The tiling passes use this so planned
    leaf layouts persist across step boundaries — user code re-wrapping
    the same array next step starts from the planned placement."""
    self.data = jax.device_put(self.data, tiling.sharding)
    self.tiling = tiling
    return self

  # -- conversion -----------------------------------------------------------

  def __array__(self, dtype=None):
    out = self.glom()
    return out.astype(dtype) if dtype is not None else out

  def astype(self, dtype) -> "SpartanArray":
    return SpartanArray(self.data.astype(dtype), self.tiling)

  def __repr__(self):
    return (f"SpartanArray(shape={self.shape}, dtype={self.dtype}, "
            f"spec={self.tiling.spec})")

  # -- lazy re-entry ---------------------------------------------------------
  # Arithmetic/indexing on an EVALUATED array re-enters the expression
  # layer (reference semantics: DistArrays are valid lazy operands), so
  # `y = (expr.evaluate() * 2)[0]` builds a new DAG over the sharded
  # buffer instead of raising or silently gathering to the host.

  def _lazy(self):
    from spartan_tpu.expr.base import Val
    return Val(self)

  def __getitem__(self, idx):
    return self._lazy()[idx]

  def __neg__(self):
    return -self._lazy()

  def __abs__(self):
    return self._lazy().__abs__()

  def __invert__(self):
    return self._lazy().__invert__()

  def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
    """numpy-left operands (``np_arr * arr``, ``np.sin(arr)``) dispatch
    to the lazy layer like Expr does — without this, numpy would fall
    back to ``__array__`` and silently gather the whole sharded array."""
    from spartan_tpu.expr.base import Expr
    mapped = tuple(i._lazy() if isinstance(i, SpartanArray) else i
                   for i in inputs)
    lead = next(i for i in mapped if isinstance(i, Expr))
    return lead.__array_ufunc__(ufunc, method, *mapped, **kwargs)

  # elementwise __eq__ (installed below) ⇒ unhashable, like np.ndarray/Expr
  __hash__ = None

  def __getattr__(self, name):
    # whitelisted expr-method delegation (SpartanArray has __slots__, so
    # this only fires for genuinely missing attributes)
    if name in _EXPR_DELEGATES:
      return getattr(self._lazy(), name)
    raise AttributeError(
        f"'SpartanArray' object has no attribute {name!r}")


_EXPR_DELEGATES = frozenset([
    "T", "sum", "prod", "mean", "std", "var", "max", "min", "argmax",
    "argmin", "all", "any", "dot", "outer", "reshape", "ravel", "flatten",
    "transpose", "swapaxes", "squeeze", "clip", "round", "cumsum",
    "cumprod", "take", "repeat", "diagonal", "trace", "sort", "argsort",
    "partition", "argpartition", "searchsorted", "nonzero", "item",
    "tolist", "conj", "conjugate", "at",
])

_BINOP_NAMES = [
    "add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
    "floordiv", "rfloordiv", "mod", "rmod", "pow", "rpow", "matmul",
    "lt", "le", "gt", "ge", "eq", "ne", "and", "rand", "or",
    "ror", "xor", "rxor", "lshift", "rshift",
]


def _install_lazy_binops():
  for short in _BINOP_NAMES:
    dunder = f"__{short}__"

    def op(self, other, _d=dunder):
      expr_fn = getattr(self._lazy(), _d, None)
      if expr_fn is None:
        return NotImplemented
      return expr_fn(other)

    op.__name__ = dunder
    setattr(SpartanArray, dunder, op)


_install_lazy_binops()


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def from_numpy(arr, tile_hint: Optional[Sequence[int]] = None,
               mesh=None, tiling: Optional[Tiling] = None) -> SpartanArray:
  """Distribute host data over the mesh (reference ``expr/fio.from_numpy``)."""
  arr = np.asarray(arr)
  if tiling is None:
    tiling = auto_tiling(arr.shape, tile_hint, mesh or get_mesh(),
                         nbytes=arr.nbytes)
  data = jax.device_put(jnp.asarray(arr), tiling.sharding)
  return SpartanArray(data, tiling)


def from_jax(data: jax.Array, tiling: Optional[Tiling] = None) -> SpartanArray:
  return SpartanArray(data, tiling)


def create(shape: Sequence[int], dtype=np.float64,
           tile_hint: Optional[Sequence[int]] = None, mesh=None,
           fill: float = 0) -> SpartanArray:
  """Allocate a distributed array (reference ``DistArray.create``)."""
  dt = jax.dtypes.canonicalize_dtype(np.dtype(dtype))
  nbytes = int(np.prod(tuple(shape) or (1,))) * dt.itemsize
  tiling = auto_tiling(shape, tile_hint, mesh or get_mesh(), nbytes=nbytes)

  @jax.jit
  def _alloc():
    return jnp.full(tuple(shape), fill, dtype=dt)

  data = jax.jit(_alloc, out_shardings=tiling.sharding)()
  return SpartanArray(data, tiling)
