"""Distributed sample sort + exact distributed selection over the mesh.

Rebuild of the reference's sample-based distributed sort
(reference: ``spartan/expr/sort.py`` — sample splitters, then a shuffle
moving each partition range to its owning worker; SURVEY.md §2.1 sort
row).  The rebuild replaces statistical sample splitters + an RPC shuffle
with an **exact** formulation that keeps every shape static for XLA:

1. each device sorts its local shard (``jnp.argsort``, stable);
2. the p-1 global rank boundaries (ranks ``j * n/p``) are found by a
   bitwise binary search over the order-preserving unsigned-integer image
   of the key dtype: 32 (or 64) rounds of a (p-1)-lane ``searchsorted``
   into the local sorted shard + a ``psum`` — O(log |dtype|) collectives
   of p-1 scalars each, no data movement;
3. boundary **ties are split by global tie rank** (one small
   ``all_gather`` of per-device tie counts), so bucket j holds *exactly*
   n/p elements — output shards are perfectly even and no second
   redistribution is needed;
4. buckets are exchanged with ``lax.ragged_all_to_all`` (GPU: each
   device moves exactly its n/p elements over the interconnect) or a dense padded
   ``lax.all_to_all`` (CPU meshes — XLA:CPU has no ragged thunk); each
   device then sorts its received n/p elements locally.

Per-device cost: O(n/p log n/p) compute, O(n/p) memory and comm on the
ragged path — versus the gather-sort plan's O(n) everything.  The rank
search alone (step 2) is **distributed selection**: exact order
statistics of a sharded vector with no gather at all, used by
``sp.percentile`` / ``median`` / ``quantile`` / ``partition`` on large
sharded inputs (:func:`rank_values`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from spartan_tpu.core.mesh import get_mesh

# ---------------------------------------------------------------------------
# Order-preserving unsigned-integer encodings.
#
# Floats use the classic sign-flip bijection (negative -> ~bits, positive ->
# bits | sign_bit): total order on the unsigned image matches the float
# order, with one subtlety — NaNs are canonicalized to the maximum code so
# bucket routing agrees with jnp.sort's NaNs-last order regardless of the
# NaN's sign/payload bits.


def _enc_float(v, ubits: int):
  ut = jnp.uint32 if ubits == 32 else jnp.uint64
  sign = ut(1) << (ubits - 1)
  bits = lax.bitcast_convert_type(v, ut)
  enc = jnp.where(bits >> (ubits - 1), ~bits, bits | sign)
  return jnp.where(jnp.isnan(v), ~ut(0), enc)


def _dec_float(u, ubits: int, ftype):
  ut = jnp.uint32 if ubits == 32 else jnp.uint64
  sign = ut(1) << (ubits - 1)
  bits = jnp.where(u >> (ubits - 1), u & ~sign, ~u)
  out = lax.bitcast_convert_type(bits, ftype)
  return jnp.where(u == ~ut(0), jnp.full_like(out, jnp.nan), out)


def _enc_int(v, ubits: int):
  ut = jnp.uint32 if ubits == 32 else jnp.uint64
  return lax.bitcast_convert_type(v, ut) ^ (ut(1) << (ubits - 1))


def _dec_int(u, ubits: int, itype):
  ut = jnp.uint32 if ubits == 32 else jnp.uint64
  return lax.bitcast_convert_type(u ^ (ut(1) << (ubits - 1)), itype)


def _codec(dtype) -> Optional[Tuple[int, object, object]]:
  """(nbits, encode, decode) for ``dtype``, or None if unsupported.

  Sub-32-bit dtypes upcast exactly into the 32-bit key space; 64-bit
  dtypes need x64 enabled (the search state is a uint64 vector).
  """
  dt = jnp.dtype(dtype)
  x64 = jax.config.jax_enable_x64
  f32, i32, u32 = jnp.dtype(jnp.float32), jnp.dtype(jnp.int32), jnp.dtype(
      jnp.uint32)
  if dt == f32:
    return 32, lambda v: _enc_float(v, 32), lambda u: _dec_float(
        u, 32, jnp.float32)
  if dt in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16)):
    return 32, lambda v: _enc_float(v.astype(jnp.float32), 32), (
        lambda u: _dec_float(u, 32, jnp.float32).astype(dt))
  if dt == i32:
    return 32, lambda v: _enc_int(v, 32), lambda u: _dec_int(u, 32, jnp.int32)
  if dt in (jnp.dtype(jnp.int8), jnp.dtype(jnp.int16)):
    return 32, lambda v: _enc_int(v.astype(jnp.int32), 32), (
        lambda u: _dec_int(u, 32, jnp.int32).astype(dt))
  if dt == u32:
    return 32, lambda v: v, lambda u: u
  if dt in (jnp.dtype(jnp.uint8), jnp.dtype(jnp.uint16)):
    return 32, lambda v: v.astype(jnp.uint32), lambda u: u.astype(dt)
  if x64 and dt == jnp.dtype(jnp.float64):
    return 64, lambda v: _enc_float(v, 64), lambda u: _dec_float(
        u, 64, jnp.float64)
  if x64 and dt == jnp.dtype(jnp.int64):
    return 64, lambda v: _enc_int(v, 64), lambda u: _dec_int(u, 64, jnp.int64)
  if x64 and dt == jnp.dtype(jnp.uint64):
    return 64, lambda v: v, lambda u: u
  return None


def supported_dtype(dtype) -> bool:
  return _codec(dtype) is not None


# ---------------------------------------------------------------------------
# Core building blocks (run inside shard_map).


def _mesh_geom(mesh: Mesh):
  axes = tuple(mesh.axis_names)
  p = 1
  for a in axes:
    p *= mesh.shape[a]
  ax_arg = axes if len(axes) > 1 else axes[0]
  spec = PartitionSpec(ax_arg)
  return axes, ax_arg, p, spec


def _count_dtype():
  return jnp.int64 if jax.config.jax_enable_x64 else jnp.int32


def _rank_search(bits_sorted, targets, axes, ubits: int):
  """Bit pattern of the global rank-``targets[j]`` key (0-indexed): the
  smallest code K with global count(bits <= K) >= target + 1.  One
  ``searchsorted`` + ``psum`` per bit of the key space."""
  ut = jnp.uint32 if ubits == 32 else jnp.uint64
  cdt = targets.dtype

  def body(_, lohi):
    lo, hi = lohi
    mid = lo + (hi - lo) // ut(2)
    cnt = lax.psum(
        jnp.searchsorted(bits_sorted, mid, side="right").astype(cdt), axes)
    ge = cnt >= targets + 1
    return jnp.where(ge, lo, mid + ut(1)), jnp.where(ge, mid, hi)

  lo0 = jnp.zeros(targets.shape, ut)
  hi0 = jnp.full(targets.shape, ~ut(0))
  v, _ = lax.fori_loop(0, ubits, body, (lo0, hi0))
  return v


def _local_splits(bits_sorted, v, targets, axes, rank):
  """Local split positions s (p+1,): my sorted elements [s_j, s_{j+1})
  belong to global bucket j.  Boundary-value ties are apportioned by
  global tie rank (device order, then local position), which is what
  makes every bucket exactly n/p elements."""
  cdt = targets.dtype
  m = bits_sorted.shape[0]
  left = jnp.searchsorted(bits_sorted, v, side="left").astype(cdt)
  right = jnp.searchsorted(bits_sorted, v, side="right").astype(cdt)
  less = lax.psum(left, axes)                       # global count < V_j
  tie_local = right - left
  tie_all = lax.all_gather(tie_local, axes, tiled=False)   # (p, p-1)
  my_tie_off = (jnp.cumsum(tie_all, axis=0) - tie_all)[rank]
  take = jnp.clip(targets - less - my_tie_off, 0, tie_local)
  s_mid = left + take
  return jnp.concatenate(
      [jnp.zeros((1,), cdt), s_mid, jnp.full((1,), m, cdt)])


def _exchange_dense(arrays, s, p: int, ax_arg, m: int):
  """CPU-mesh fallback: scatter each bucket into a (p, m) padded buffer and
  ``all_to_all`` it (capacity m per peer — safe upper bound).  Returns
  (valid u8 (p*m,), received arrays (p*m,) each)."""
  cdt = s.dtype
  i = jnp.arange(m, dtype=cdt)
  dest = jnp.searchsorted(s[1:], i, side="right")
  pos = dest * m + (i - s[dest])
  valid = jnp.zeros((p * m,), jnp.uint8).at[pos].set(1)
  valid = lax.all_to_all(valid.reshape(p, m), ax_arg, 0, 0).reshape(-1)
  outs = []
  for a in arrays:
    buf = jnp.zeros((p * m,), a.dtype).at[pos].set(a)
    outs.append(lax.all_to_all(buf.reshape(p, m), ax_arg, 0, 0).reshape(-1))
  return valid, outs


def _exchange_ragged(arrays, s, p: int, axes, ax_arg, m: int, rank):
  """GPU path: buckets are contiguous in the locally sorted shard, so
  the split positions ARE the ragged offsets; each device sends and
  receives exactly m elements."""
  sizes = (s[1:] - s[:-1]).astype(jnp.int32)
  in_off = s[:-1].astype(jnp.int32)
  c = lax.all_gather(sizes, axes, tiled=False)      # (p, p) rows = senders
  out_off = (jnp.cumsum(c, axis=0) - c)[rank].astype(jnp.int32)
  recv = c[:, rank].astype(jnp.int32)
  return [
      lax.ragged_all_to_all(a, jnp.zeros((m,), a.dtype), in_off, sizes,
                            out_off, recv, axis_name=ax_arg) for a in arrays
  ]


def _sample_sort_shard(xs, *, gidx_dtype, p, axes, ax_arg, kind, exchange,
                       enc, ubits, n):
  m = xs.shape[0]
  cdt = _count_dtype()
  rank = lax.axis_index(axes)
  order = jnp.argsort(xs, stable=True)
  loc = xs[order]
  bits = enc(loc)
  targets = (jnp.arange(1, p) * m).astype(cdt)
  v = _rank_search(bits, targets, axes, ubits)
  s = _local_splits(bits, v, targets, axes, rank)

  payload = [loc]
  if kind == "argsort":
    payload.append((rank.astype(gidx_dtype) * gidx_dtype.type(m)
                    + order.astype(gidx_dtype)))
  if exchange == "ragged":
    outs = _exchange_ragged(payload, s, p, axes, ax_arg, m, rank)
    keys = tuple(outs)
    res = lax.sort(keys, num_keys=len(keys)) if len(keys) > 1 else (
        jnp.sort(outs[0]),)
    return res[-1] if kind == "argsort" else res[0]
  valid, outs = _exchange_dense(payload, s, p, ax_arg, m)
  # invalid (padding) slots sort last; ties in values break by global index
  # (argsort) so the result is deterministic and argsort is stable.
  keys = (jnp.uint8(1) - valid, *outs)
  res = lax.sort(keys, num_keys=len(keys))
  return res[-1][:m] if kind == "argsort" else res[1][:m]


# ---------------------------------------------------------------------------
# Public API.


def routable(shape, dtype, mesh: Optional[Mesh] = None) -> bool:
  """True if a 1-D sort/selection of (shape, dtype) can take the sample
  path on ``mesh``: >1 device, even shards, encodable dtype, and counts
  representable in the available integer width."""
  mesh = mesh or get_mesh()
  _, _, p, _ = _mesh_geom(mesh)
  n = int(np.prod(shape)) if len(shape) else 0
  if p <= 1 or n == 0 or n % p != 0:
    return False
  if not supported_dtype(dtype):
    return False
  if not jax.config.jax_enable_x64 and n >= 2**31:
    return False
  return True


def _pick_exchange(mesh: Mesh, exchange: str) -> str:
  if exchange != "auto":
    return exchange
  platform = mesh.devices.flat[0].platform
  return "ragged" if platform == "gpu" else "dense"


def sample_sort_traced(x, mesh: Optional[Mesh] = None, kind: str = "sort",
                       exchange: str = "auto", force: bool = False):
  """Distributed sort (or stable argsort) of a 1-D array; call inside a
  traced region or eagerly.  Output is sharded evenly over all mesh axes
  (PartitionSpec((*axis_names,))).

  ``force=True`` skips the ``routable`` gate (still requires even shards
  and an encodable dtype) — used by hardware validation to execute the
  ragged-exchange path on a 1-device mesh, where production routing
  would send the sort down the local path instead."""
  mesh = mesh or get_mesh()
  axes, ax_arg, p, spec = _mesh_geom(mesh)
  if x.ndim != 1:
    raise ValueError(f"sample_sort is 1-D; got shape {x.shape}")
  if force:
    if (x.size % p != 0) or not supported_dtype(x.dtype):
      raise ValueError(
          f"not forceable: shape={x.shape} dtype={x.dtype} devices={p}")
  elif not routable(x.shape, x.dtype, mesh):
    raise ValueError(
        f"not routable: shape={x.shape} dtype={x.dtype} devices={p}")
  codec = _codec(x.dtype)
  ubits, enc, _ = codec
  gidx_dtype = jax.eval_shape(
      lambda v: jnp.argsort(v), jax.ShapeDtypeStruct(x.shape, x.dtype)).dtype
  fn = jax.shard_map(
      functools.partial(_sample_sort_shard, gidx_dtype=jnp.dtype(gidx_dtype),
                        p=p, axes=axes, ax_arg=ax_arg,
                        kind=kind, exchange=_pick_exchange(mesh, exchange),
                        enc=enc, ubits=ubits, n=x.shape[0]),
      mesh=mesh, in_specs=spec, out_specs=spec)
  return fn(x)


def _rank_values_shard(xs, *, ranks, axes, ubits, enc, dec):
  cdt = _count_dtype()
  bits = enc(jnp.sort(xs))
  targets = jnp.asarray(ranks, cdt)
  v = _rank_search(bits, targets, axes, ubits)
  return dec(v)


def rank_values(x, ranks: Sequence[int], mesh: Optional[Mesh] = None):
  """Exact order statistics: the values at global sorted ranks ``ranks``
  (0-indexed ints) of a sharded 1-D array, with no gather — O(log|dtype|)
  scalar-vector collectives.  Returns a replicated (len(ranks),) array."""
  mesh = mesh or get_mesh()
  axes, _, p, spec = _mesh_geom(mesh)
  ranks = [int(r) for r in ranks]
  if x.ndim != 1:
    raise ValueError("rank_values is 1-D")
  if not routable(x.shape, x.dtype, mesh):
    # correct everywhere; one local sort after a gather
    return jnp.sort(x)[jnp.asarray(ranks)]
  ubits, enc, dec = _codec(x.dtype)
  fn = jax.shard_map(
      functools.partial(_rank_values_shard, ranks=tuple(ranks), axes=axes,
                        ubits=ubits, enc=enc, dec=dec),
      mesh=mesh, in_specs=spec, out_specs=PartitionSpec())
  return fn(x)
