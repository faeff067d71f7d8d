"""Sparse construction & manipulation (the ``scipy.sparse`` builder
surface), on device.

Reference: the reference's sparse tiles ARE scipy matrices
(``spartan/sparse/``, SURVEY.md §2.1/§2.2), so its users build graphs
and operators with ``scipy.sparse.eye/diags/kron/hstack/...`` and feed
them to sparse workloads (config 5 PageRank).  This module provides
that surface over :class:`~spartan_tpu.backend.sparse.SparseArray`
(padded-ELL device layout).

Device-first shape: every structural composition that is expressible as a
static, vectorized transform of the ELL ``(rows, width)`` tiles runs
ON DEVICE — ``kron`` is one broadcasted outer product of the two ELL
tile pairs, ``hstack``/``vstack``/``block_diag``/``bmat`` are shifted
concatenations, ``tril``/``triu`` are masked ``where``s.  No
host↔device round trips, no index chasing.  Only the banded builders
(``eye``/``diags``/``spdiags``) assemble their index pattern with
host numpy first (one-shot O(n·ndiags) construction, like all ingest),
and ``random`` samples its support on host (RNG-exact scipy parity).

ELL invariants maintained throughout (see ``backend/sparse.py``):
pad entries are ``(col 0, val 0)``; any composition that could move a
pad's column index re-zeroes it (``_fix_pads``).  Duplicate stored
coordinates are legal and SUM under every compute path (SpMV gather,
``todense``, ``diagonal``); :meth:`SparseArray.canonicalize` merges
them via the host when a minimal-width form is wanted.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from spartan_tpu.backend.sparse import SparseArray, from_dense, from_scipy

__all__ = [
    "eye", "identity", "diags", "spdiags", "kron", "kronsum",
    "hstack", "vstack", "block_diag", "bmat", "tril", "triu",
    "random", "rand", "issparse", "isspmatrix",
]


def issparse(x) -> bool:
  return isinstance(x, SparseArray)


isspmatrix = issparse


def _as_sparse(x, what: str = "operand") -> SparseArray:
  if isinstance(x, SparseArray):
    return x
  try:
    import scipy.sparse as ss
    if ss.issparse(x):
      return from_scipy(x)
  except ImportError:  # pragma: no cover - scipy is baked in
    pass
  if hasattr(x, "shape") or isinstance(x, (list, tuple)):
    a = np.asarray(x)
    if a.ndim != 2:
      raise ValueError(f"{what} must be 2-D, got shape {a.shape}")
    return from_dense(a)
  raise TypeError(f"cannot interpret {type(x).__name__} as a sparse matrix")


def _fix_pads(cols, vals):
  """Re-anchor pad entries (val 0) at column 0 — compositions that shift
  column indices would otherwise leave pads pointing at live columns
  (harmless for val-weighted gathers, but it breaks the documented
  invariant that downstream packers rely on)."""
  return jnp.where(vals != 0, cols, 0), vals


def _ell(cols, vals, shape, nnz) -> SparseArray:
  cols, vals = _fix_pads(jnp.asarray(cols, jnp.int32), jnp.asarray(vals))
  return SparseArray(cols, vals, tuple(int(s) for s in shape), int(nnz))


# ---------------------------------------------------------------------------
# Banded builders (host-assembled pattern, device storage)
# ---------------------------------------------------------------------------

def eye(m: int, n: Optional[int] = None, k: int = 0,
        dtype=np.float64, format=None) -> SparseArray:
  """Sparse identity / shifted-diagonal matrix (``scipy.sparse.eye``).
  An entirely out-of-range ``k`` yields an all-zero matrix (numpy
  ``np.eye`` semantics; scipy raises there)."""
  del format  # single device format; accepted for signature parity
  m = int(m)
  n = m if n is None else int(n)
  r = np.arange(m)
  valid = (r + k >= 0) & (r + k < n)
  cols = np.where(valid, r + k, 0).astype(np.int32)[:, None]
  vals = valid.astype(np.dtype(dtype))[:, None]
  return _ell(cols, vals, (m, n), int(valid.sum()))


def identity(n: int, dtype=np.float64, format=None) -> SparseArray:
  return eye(n, dtype=dtype, format=format)


def diags(diagonals, offsets=0, shape=None, format=None,
          dtype=None) -> SparseArray:
  """Banded matrix from diagonals (``scipy.sparse.diags`` semantics:
  value ``t`` of diagonal ``k`` lands at ``(t - min(k,0), t + max(k,0))``;
  scalars broadcast along their diagonal when ``shape`` is given)."""
  del format
  if np.isscalar(offsets):
    diagonals = [np.atleast_1d(np.asarray(diagonals))]
    offsets = [int(offsets)]
  else:
    diagonals = [np.atleast_1d(np.asarray(d)) for d in diagonals]
    offsets = [int(k) for k in offsets]
  if len(diagonals) != len(offsets):
    raise ValueError("number of diagonals does not match offsets")
  if len(set(offsets)) != len(offsets):
    raise ValueError("offsets array contains duplicate values")

  if shape is None:
    size = max(len(d) + abs(k) for d, k in zip(diagonals, offsets))
    shape = (size, size)
  n, m = int(shape[0]), int(shape[1])

  width = len(offsets)
  cols = np.zeros((n, width), np.int32)
  vals_dtype = np.dtype(dtype) if dtype is not None else np.result_type(
      *[d.dtype for d in diagonals])
  vals = np.zeros((n, width), vals_dtype)
  nnz = 0
  for j, (d, k) in enumerate(zip(diagonals, offsets)):
    length = min(n + min(k, 0), m - max(k, 0))
    if length < 0:
      length = 0
    if d.size == 1:
      d = np.broadcast_to(d, (length,))
    elif d.size != length:
      raise ValueError(
          f"diagonal {j} (offset {k}) has length {d.size}, expected "
          f"{length} for shape {shape} (scipy.sparse.diags contract)")
    t = np.arange(length)
    rows = t - min(k, 0)
    cols[rows, j] = t + max(k, 0)
    vals[rows, j] = d[:length]
    nnz += length
  return _ell(cols, vals, (n, m), nnz)


def spdiags(data, diags_, m=None, n=None) -> SparseArray:
  """MATLAB-convention banded builder (``scipy.sparse.spdiags``): the
  value at ``(i, i+k)`` is ``data[j, i+k]`` — indexed by COLUMN, so
  off-diagonal bands are read with a ``k``-shift (unlike :func:`diags`,
  which reads each diagonal from its start)."""
  data = np.atleast_2d(np.asarray(data))
  offsets = np.atleast_1d(np.asarray(diags_)).astype(int)
  if m is not None and n is None and not np.isscalar(m):
    m, n = m  # spdiags(data, diags, shape) form
  if m is None or n is None:
    raise ValueError("spdiags needs m, n (or a shape tuple)")
  n_, m_ = int(m), int(n)
  width = len(offsets)
  cols = np.zeros((n_, width), np.int32)
  vals = np.zeros((n_, width), data.dtype)
  nnz = 0
  for j, k in enumerate(offsets):
    rows = np.arange(max(0, -k), min(n_, m_ - k))
    c = rows + k
    take = c[c < data.shape[1]]
    rows = rows[: len(take)]
    live = data[j, take] != 0
    cols[rows, j] = take
    vals[rows, j] = data[j, take]
    nnz += int(live.sum())
  return _ell(cols, vals, (n_, m_), nnz)


# ---------------------------------------------------------------------------
# Device-side structural compositions
# ---------------------------------------------------------------------------

def kron(A, B, format=None) -> SparseArray:
  """Kronecker product — ONE broadcasted outer product over the two ELL
  tile pairs (row ``ia*nB+ib`` of the result is the outer product of
  row ``ia`` of A with row ``ib`` of B, in both columns and values).
  Fully on-device, O(nnz(A)·width(B)) storage; no index chasing.

  The result width is ``width(A)·width(B)`` — an upper bound over rows
  (exact for the densest row pair).  ``canonicalize()`` compacts."""
  del format
  A, B = _as_sparse(A, "A"), _as_sparse(B, "B")
  nA, mA = A.shape
  nB, mB = B.shape
  # (nA, 1, kA, 1) ⊗ (1, nB, 1, kB) -> (nA*nB, kA*kB)
  cols = (A.cols[:, None, :, None].astype(jnp.int32) * mB
          + B.cols[None, :, None, :]).reshape(nA * nB, -1)
  vals = (A.vals[:, None, :, None]
          * B.vals[None, :, None, :]).reshape(nA * nB, -1)
  return _ell(cols, vals, (nA * nB, mA * mB), A.nnz * B.nnz)


def kronsum(A, B, format=None) -> SparseArray:
  """Kronecker sum ``kron(I_nB, A) + kron(B, I_nA)`` for square A, B
  (scipy's operand order).  Built directly in ELL: row ``ib*nA+ia``
  concatenates A's row ``ia`` (columns shifted into block ``ib``) with
  B's row ``ib`` spread across blocks at intra-block offset ``ia`` —
  one device-side concatenation, no intermediate matrices."""
  del format
  A, B = _as_sparse(A, "A"), _as_sparse(B, "B")
  nA, mA = A.shape
  nB, mB = B.shape
  if nA != mA or nB != mB:
    raise ValueError(f"kronsum needs square operands, got {A.shape} "
                     f"and {B.shape}")
  ia = jnp.arange(nA, dtype=jnp.int32)
  ib = jnp.arange(nB, dtype=jnp.int32)
  # kron(I_nB, A): row ib*nA+ia has A.cols[ia] + ib*nA
  colsA = (A.cols[None, :, :] + (ib * nA)[:, None, None])
  valsA = jnp.broadcast_to(A.vals[None, :, :], (nB,) + A.vals.shape)
  # kron(B, I_nA): row ib*nA+ia has B.cols[ib]*nA + ia
  colsB = (B.cols[:, None, :] * nA + ia[None, :, None])
  valsB = jnp.broadcast_to(B.vals[:, None, :], (nB, nA, B.vals.shape[1]))
  dt = jnp.result_type(valsA.dtype, valsB.dtype)
  cols = jnp.concatenate([colsA, colsB], axis=2).reshape(nA * nB, -1)
  vals = jnp.concatenate([valsA.astype(dt), valsB.astype(dt)],
                         axis=2).reshape(nA * nB, -1)
  return _ell(cols, vals, (nA * nB, nA * nB), A.nnz * nB + B.nnz * nA)


def _pad_width(s: SparseArray, width: int) -> SparseArray:
  k = s.cols.shape[1]
  if k == width:
    return s
  pad = [(0, 0), (0, width - k)]
  return SparseArray(jnp.pad(s.cols, pad), jnp.pad(s.vals, pad),
                     s.shape, s.nnz)


def hstack(blocks: Sequence, format=None, dtype=None) -> SparseArray:
  """Horizontal concatenation — column-shifted ELL concat, on device."""
  del format
  blocks = [_as_sparse(b, "block") for b in blocks]
  n = blocks[0].shape[0]
  if any(b.shape[0] != n for b in blocks):
    raise ValueError("hstack blocks disagree on row count: "
                     f"{[b.shape for b in blocks]}")
  dt = np.result_type(*[b.dtype for b in blocks]) if dtype is None else dtype
  offset = 0
  cols_parts, vals_parts = [], []
  for b in blocks:
    cols_parts.append(b.cols + offset)
    vals_parts.append(b.vals.astype(dt))
    offset += b.shape[1]
  cols = jnp.concatenate(cols_parts, axis=1)
  vals = jnp.concatenate(vals_parts, axis=1)
  return _ell(cols, vals, (n, offset), sum(b.nnz for b in blocks))


def vstack(blocks: Sequence, format=None, dtype=None) -> SparseArray:
  """Vertical concatenation — width-padded ELL row concat, on device."""
  del format
  blocks = [_as_sparse(b, "block") for b in blocks]
  m = blocks[0].shape[1]
  if any(b.shape[1] != m for b in blocks):
    raise ValueError("vstack blocks disagree on column count: "
                     f"{[b.shape for b in blocks]}")
  dt = np.result_type(*[b.dtype for b in blocks]) if dtype is None else dtype
  width = max(b.cols.shape[1] for b in blocks)
  blocks = [_pad_width(b, width) for b in blocks]
  cols = jnp.concatenate([b.cols for b in blocks], axis=0)
  vals = jnp.concatenate([b.vals.astype(dt) for b in blocks], axis=0)
  n = sum(b.shape[0] for b in blocks)
  return _ell(cols, vals, (n, m), sum(b.nnz for b in blocks))


def block_diag(mats: Sequence, format=None, dtype=None) -> SparseArray:
  """Block-diagonal assembly — shifted ELL row concat, on device."""
  del format
  mats = [_as_sparse(b, "block") for b in mats]
  dt = np.result_type(*[b.dtype for b in mats]) if dtype is None else dtype
  width = max(b.cols.shape[1] for b in mats)
  total_m = sum(b.shape[1] for b in mats)
  cols_parts, vals_parts = [], []
  offset = 0
  for b in mats:
    b = _pad_width(b, width)
    cols_parts.append(b.cols + offset)
    vals_parts.append(b.vals.astype(dt))
    offset += b.shape[1]
  cols = jnp.concatenate(cols_parts, axis=0)
  vals = jnp.concatenate(vals_parts, axis=0)
  n = sum(b.shape[0] for b in mats)
  return _ell(cols, vals, (n, total_m), sum(b.nnz for b in mats))


def _zeros(n: int, m: int, dtype) -> SparseArray:
  return SparseArray(jnp.zeros((n, 1), jnp.int32),
                     jnp.zeros((n, 1), dtype), (n, m), 0)


def bmat(blocks, format=None, dtype=None) -> SparseArray:
  """Grid assembly from a 2-D list of blocks (``None`` = zero block).
  Row heights / column widths are inferred from the non-None entries;
  a fully-None row or column is ambiguous and raises (scipy parity)."""
  del format
  grid = [[None if b is None else _as_sparse(b, "block") for b in row]
          for row in blocks]
  R = len(grid)
  C = len(grid[0]) if R else 0
  if any(len(row) != C for row in grid):
    raise ValueError("blocks must form a rectangular grid")
  heights = [None] * R
  widths = [None] * C
  for i in range(R):
    for j in range(C):
      b = grid[i][j]
      if b is None:
        continue
      if heights[i] is None:
        heights[i] = b.shape[0]
      elif heights[i] != b.shape[0]:
        raise ValueError(f"block row {i} has inconsistent heights")
      if widths[j] is None:
        widths[j] = b.shape[1]
      elif widths[j] != b.shape[1]:
        raise ValueError(f"block column {j} has inconsistent widths")
  if any(h is None for h in heights) or any(w is None for w in widths):
    raise ValueError("a full row or column of None blocks is ambiguous")
  dts = [b.dtype for row in grid for b in row if b is not None]
  dt = np.result_type(*dts) if dtype is None else np.dtype(dtype)
  rows = []
  for i in range(R):
    row = [grid[i][j] if grid[i][j] is not None
           else _zeros(heights[i], widths[j], dt) for j in range(C)]
    rows.append(hstack(row, dtype=dt))
  return vstack(rows, dtype=dt)


def _tri_mask(A: SparseArray, k: int, lower: bool) -> SparseArray:
  rows = jnp.arange(A.shape[0], dtype=jnp.int32)[:, None]
  keep = (A.cols <= rows + k) if lower else (A.cols >= rows + k)
  keep = keep & (A.vals != 0)
  vals = jnp.where(keep, A.vals, 0)
  nnz = int(jnp.sum(keep))
  return _ell(jnp.where(keep, A.cols, 0), vals, A.shape, nnz)


def tril(A, k: int = 0, format=None) -> SparseArray:
  """Lower triangle (entries with ``col <= row + k``), masked on device."""
  del format
  return _tri_mask(_as_sparse(A), int(k), lower=True)


def triu(A, k: int = 0, format=None) -> SparseArray:
  """Upper triangle (entries with ``col >= row + k``), masked on device."""
  del format
  return _tri_mask(_as_sparse(A), int(k), lower=False)


# ---------------------------------------------------------------------------
# Random matrices
# ---------------------------------------------------------------------------

def random(m: int, n: int, density: float = 0.01, format=None,
           dtype=np.float64, random_state=None,
           data_rvs=None) -> SparseArray:
  """Uniform-random sparse matrix with EXACTLY
  ``round(density * m * n)`` distinct stored positions
  (``scipy.sparse.random`` contract; ``sprandn`` is the cheaper
  with-replacement sampler).  Support is sampled host-side —
  oversample + unique + top-up, O(nnz) memory even for huge ``m·n``."""
  del format
  m, n = int(m), int(n)
  if not 0 <= density <= 1:
    raise ValueError("density must be in [0, 1]")
  rng = (random_state if isinstance(random_state, np.random.Generator)
         else np.random.default_rng(random_state))
  total = m * n
  nnz = int(round(density * total))
  flat = np.empty(0, np.int64)
  while flat.size < nnz:
    need = nnz - flat.size
    extra = rng.integers(0, total, size=int(need * 1.3) + 16)
    flat = np.unique(np.concatenate([flat, extra]))
    if flat.size > nnz:
      flat = rng.permutation(flat)[:nnz]
  vals = (data_rvs(nnz) if data_rvs is not None
          else rng.random(nnz)).astype(dtype, copy=False)
  # values of exactly 0 would read as pads; nudge them (measure zero
  # for continuous rvs, but data_rvs may be discrete)
  vals = np.where(vals == 0, np.finfo(np.dtype(dtype)).tiny
                  if np.issubdtype(np.dtype(dtype), np.floating) else 1,
                  vals)
  from spartan_tpu.backend.sparse import from_coo
  return from_coo(flat // n, flat % n, vals, (m, n))


def rand(m: int, n: int, density: float = 0.01, format=None,
         dtype=np.float64, random_state=None) -> SparseArray:
  return random(m, n, density, format=format, dtype=dtype,
                random_state=random_state)


# ---------------------------------------------------------------------------
# scipy format constructors + predicates (r5 parity sweep).
#
# The DEVICE layout is always padded ELL (one format, chosen for the
# vectorized gather paths); these constructors accept every input form their
# scipy namesakes do (dense, sparse, (M,N), (data,(row,col)),
# (data,indices,indptr), (data,offsets)) by delegating the PARSING to
# scipy's own constructor (host-side one-shot ingest, the documented
# convention) and converting to ELL.  Each tags the result's declared
# format so `.format` / `isspmatrix_*` behave like scipy's.
# ---------------------------------------------------------------------------

_KNOWN_FORMATS = ("csr", "csc", "coo", "bsr", "dia", "dok", "lil")


def _format_ctor(fmt: str):
  def ctor(arg1, shape=None, dtype=None, copy=False, *, maxprint=None):
    del copy, maxprint
    import scipy.sparse as ss
    if isinstance(arg1, SparseArray):
      if shape is not None and tuple(shape) != arg1.shape:
        raise ValueError(
            f"cannot reshape sparse matrix {arg1.shape} -> {tuple(shape)}")
      out = SparseArray(arg1.cols, arg1.vals, arg1.shape, arg1.nnz)
      if dtype is not None and np.dtype(dtype) != out.dtype:
        out = out.astype(dtype)
    else:
      out = from_scipy(
          getattr(ss, f"{fmt}_matrix")(arg1, shape=shape, dtype=dtype))
    out.fmt = fmt
    return out

  ctor.__name__ = f"{fmt}_matrix"
  ctor.__qualname__ = f"{fmt}_matrix"
  ctor.__doc__ = (
      f"scipy.sparse.{fmt}_matrix-compatible constructor — accepts the "
      f"same input forms, stores padded ELL on device, tags "
      f"``.format='{fmt}'``.")
  return ctor


csr_matrix = _format_ctor("csr")
csc_matrix = _format_ctor("csc")
coo_matrix = _format_ctor("coo")
bsr_matrix = _format_ctor("bsr")
dia_matrix = _format_ctor("dia")
# scipy's new sparse-ARRAY API: same constructors (our SparseArray
# already has array (not matrix) elementwise-multiply semantics only
# through .multiply, matching the classic API surface we document).
csr_array = _format_ctor("csr")
csc_array = _format_ctor("csc")
coo_array = _format_ctor("coo")
bsr_array = _format_ctor("bsr")
dia_array = _format_ctor("dia")


def _isspmatrix_for(fmt: str):
  def pred(x) -> bool:
    return isinstance(x, SparseArray) and x.fmt == fmt

  pred.__name__ = f"isspmatrix_{fmt}"
  pred.__qualname__ = f"isspmatrix_{fmt}"
  pred.__doc__ = (
      f"True when ``x`` is a device sparse array whose DECLARED format "
      f"tag is ``'{fmt}'`` (the device layout is always padded ELL; "
      f"the tag records the constructor/format= the user asked for)."
      + ("  Always False in practice: this host-mutation format is a "
         "documented non-goal." if fmt in ("dok", "lil") else ""))
  return pred


isspmatrix_csr = _isspmatrix_for("csr")
isspmatrix_csc = _isspmatrix_for("csc")
isspmatrix_coo = _isspmatrix_for("coo")
isspmatrix_bsr = _isspmatrix_for("bsr")
isspmatrix_dia = _isspmatrix_for("dia")
isspmatrix_dok = _isspmatrix_for("dok")
isspmatrix_lil = _isspmatrix_for("lil")


def find(A):
  """``(row, col, value)`` arrays of the nonzeros (duplicates summed,
  explicit zeros dropped) — host fetch, scipy contract."""
  import scipy.sparse as ss
  return ss.find(_as_sparse(A).to_scipy())


def save_npz(file, matrix, compressed: bool = True) -> None:
  """Persist to scipy's ``.npz`` container (host boundary — file IO).
  The declared format tag rides along via the stored scipy format."""
  import scipy.sparse as ss
  m = _as_sparse(matrix)
  out = m.to_scipy()
  if m.fmt in ("csc", "coo", "bsr", "dia"):
    out = getattr(out, f"to{m.fmt}")()
  ss.save_npz(file, out, compressed=compressed)


def load_npz(file) -> SparseArray:
  """Load a scipy ``.npz`` sparse container onto the device (host
  boundary — file IO); the stored scipy format becomes the tag."""
  import scipy.sparse as ss
  m = ss.load_npz(file)
  out = from_scipy(m)
  if m.format in _KNOWN_FORMATS:
    out.fmt = m.format
  return out


class SparseWarning(Warning):
  """Base sparse warning (scipy.sparse.SparseWarning parity)."""


class SparseEfficiencyWarning(SparseWarning):
  """Emitted when an operation falls off the efficient device path."""


# scipy 1.x sparse-ARRAY builder aliases (keyword-only signatures).

def eye_array(m, n=None, *, k: int = 0, dtype=float,
              format=None) -> SparseArray:
  return eye(m, n, k=k, dtype=dtype, format=format)


def diags_array(diagonals, /, *, offsets=0, shape=None, format=None,
                dtype=None) -> SparseArray:
  return diags(diagonals, offsets, shape=shape, format=format, dtype=dtype)


def block_array(blocks, *, format=None, dtype=None) -> SparseArray:
  return bmat(blocks, format=format, dtype=dtype)


def random_array(shape, *, density: float = 0.01, format=None,
                 dtype=None, rng=None, data_sampler=None,
                 random_state=None) -> SparseArray:
  m, n = shape
  out = random(m, n, density, format=format,
               dtype=(dtype if dtype is not None else np.float64),
               random_state=(rng if rng is not None else random_state),
               data_rvs=data_sampler)
  return out


__all__ += [
    "csr_matrix", "csc_matrix", "coo_matrix", "bsr_matrix", "dia_matrix",
    "csr_array", "csc_array", "coo_array", "bsr_array", "dia_array",
    "isspmatrix_csr", "isspmatrix_csc", "isspmatrix_coo", "isspmatrix_bsr",
    "isspmatrix_dia", "isspmatrix_dok", "isspmatrix_lil",
    "find", "save_npz", "load_npz",
    "SparseWarning", "SparseEfficiencyWarning",
    "eye_array", "diags_array", "block_array", "random_array",
]
