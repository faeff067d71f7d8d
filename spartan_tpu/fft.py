"""``sp.fft`` — numpy.fft-style spectral surface over lazy exprs.

The reference had no FFT (spartan's builtins stop at dense linear
algebra; SURVEY.md §2.1 builtins row) — this is a widening for the
NumPy-user surface.  Every transform is a lazy map over XLA's native FFT
lowering (FFTs execute on device); complex avals flow through the
DAG like any other dtype (map/reduce/slicing are dtype-agnostic).
``fftfreq``/``rfftfreq`` are tiny host-built leaves.

Multi-axis transforms (``fft2``/``ifft2``/``fftn``/``ifftn`` and the
real variants ``rfft2``/``rfftn``/``irfft2``/``irfftn``) DISTRIBUTE on
>1-device meshes by pencil decomposition (``--fft_pencil``, default
on): local FFT over all transform axes but one while that one is
sharded, ONE tiled ``all_to_all`` transpose over the interconnect, local FFT over
the remaining axis — O(n/p) memory and compute per device.  The
transpose-target axis is zero-padded to a mesh-size multiple when
needed (the r-variants' n//2+1 rarely divides) and sliced back, so the
only requirement is one non-real transform axis divisible by the mesh
size; ineligible transforms (and the single-axis ones) constrain their
transform axes local instead, which replicates the transform's compute
but keeps batch dims sharded.

Complex routing note: some callers (``scipy_linalg``, ``signal``,
``sparse_linalg``, ``special``) still route complex inputs or outputs
through the host, a choice left from an older runtime without complex
device buffers; the CPU and GPU runtimes support complex arrays end to
end.
"""

from __future__ import annotations

import functools

import numpy as np

import spartan_tpu as sp

__all__ = ["fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "fftn",
           "ifftn", "rfft2", "irfft2", "rfftn", "irfftn", "hfft", "ihfft",
           "fftshift", "ifftshift", "fftfreq", "rfftfreq"]


def _transform_axes(name, kw, ndim):
  """Which dims the transform runs over (normalized, non-negative)."""
  if name in ("fftshift", "ifftshift"):
    return ()  # a roll, not an FFT — no locality requirement
  if name in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
    axes = (kw.get("axis", -1),)
  else:  # fft2/ifft2/rfft2/irfft2/fftn/ifftn/rfftn/irfftn
    axes = kw.get("axes")
    if axes is None:
      s = kw.get("s")
      if s is not None:
        axes = tuple(range(ndim - len(s), ndim))
      else:
        axes = (tuple(range(ndim))
                if name in ("fftn", "ifftn", "rfftn", "irfftn")
                else (-2, -1))
  return tuple(a % ndim for a in axes)


# Multi-axis transforms that decompose into per-axis 1-D FFTs — eligible
# for the pencil (transpose) algorithm.  Value = (per-axis complex base,
# real-transform applied along axes[-1] or None).
_PENCIL_BASE = {"fft2": ("fft", None), "ifft2": ("ifft", None),
                "fftn": ("fft", None), "ifftn": ("ifft", None),
                "rfft2": ("fft", "rfft"), "rfftn": ("fft", "rfft"),
                "irfft2": ("ifft", "irfft"), "irfftn": ("ifft", "irfft")}


def _pencil_fft(name, a, axes, mesh):
  """Distributed multi-axis FFT by pencil decomposition, or None if the
  transform isn't eligible (then the caller falls back to localizing the
  transform axes, which replicates the transform's compute).

  Shape: FFT every transform axis but one locally while that one (the
  pencil axis ``s``) is sharded, transpose ``s`` against the last
  transform axis with ONE tiled ``all_to_all`` (O(n/p) bytes per device,
  rides the interconnect), FFT ``s`` locally — O(n/p) memory and compute
  per device
  vs the replicated fallback's O(n); the scaling-book transpose-FFT
  recipe.  The transpose-target axis is zero-padded to a mesh-size
  multiple when needed (sliced back after), so the ONLY divisibility
  requirement is one transform axis (other than the real axis of the
  r-variants) divisible by the mesh size.  Explicit shard_map rather
  than sharding constraints: the GSPMD constraint-flip formulation
  miscompiles on XLA:CPU for ndim>=3 (hlo-verifier INTERNAL after
  spmd-partitioning, jax 0.9) and leaves the collective choice to the
  partitioner."""
  import jax
  import jax.numpy as jnp
  from jax.sharding import PartitionSpec as P
  from spartan_tpu.config import FLAGS
  if (name not in _PENCIL_BASE or len(set(axes)) != len(axes)
      or len(axes) < 2):
    return None
  base, real = _PENCIL_BASE[name]
  names = tuple(mesh.axis_names)
  p = int(mesh.devices.size)
  batch = int(np.prod([a.shape[d] for d in range(a.ndim)
                       if d not in axes], initial=1))
  if a.size < int(FLAGS.fft_pencil_min_elems) or batch >= p:
    # tiny transforms aren't worth an interconnect round-trip, and when the batch
    # dims alone can absorb the mesh the localize fallback is
    # embarrassingly parallel — zero collectives beats a transpose
    # (code-review r4: pencil used to force a reshard + all_to_all on
    # batched FFTs that previously ran p independent local transforms)
    return None
  ak = axes[-1]
  s = next((d for d in axes[:-1] if a.shape[d] % p == 0), None)
  if s is None:
    if real is not None or a.shape[ak] % p:
      return None
    s, ak = ak, axes[0]  # complex axes commute: pencil on the last axis
  others = [d for d in axes if d != s]

  def pad_to(x, dim, mult):
    extra = -x.shape[dim] % mult
    if not extra:
      return x
    widths = [(0, extra if d == dim else 0) for d in range(x.ndim)]
    return jnp.pad(x, widths)

  if real == "irfft":
    # inverse-real: ifft over every axis but the last while the (padded)
    # last is sharded, transpose, irfft the last axis locally.
    nk_in = a.shape[ak]
    out_len = 2 * (nk_in - 1)
    a = pad_to(a, ak, p)
    in_spec = P(*[names if d == ak else None for d in range(a.ndim)])
    out_spec = P(*[names if d == s else None for d in range(a.ndim)])

    def body_i(xl):
      for ax in axes[:-1]:   # incl. s — only the (sharded) real axis waits
        xl = getattr(jnp.fft, base)(xl, axis=ax)
      xl = jax.lax.all_to_all(xl, names, split_axis=s, concat_axis=ak,
                              tiled=True)
      xl = jax.lax.slice_in_dim(xl, 0, nk_in, axis=ak)
      return jnp.fft.irfft(xl, n=out_len, axis=ak)

    return jax.shard_map(body_i, mesh=mesh, in_specs=(in_spec,),
                         out_specs=out_spec, check_vma=False)(a)

  # forward family (fft/ifft/rfft*): transform the non-pencil axes
  # locally while s is sharded (the real transform, if any, runs along
  # axes[-1] here), pad the transpose target, transpose, FFT s locally.
  t = ak if s != ak else axes[0]
  t_len = (a.shape[t] // 2 + 1) if (real and t == axes[-1]) else a.shape[t]
  in_spec = P(*[names if d == s else None for d in range(a.ndim)])
  out_spec = P(*[names if d == t else None for d in range(a.ndim)])

  def body_f(xl):
    if real:
      xl = jnp.fft.rfft(xl, axis=axes[-1])
    for ax in others:
      if real and ax == axes[-1]:
        continue
      xl = getattr(jnp.fft, base)(xl, axis=ax)
    xl = pad_to(xl, t, p)
    xl = jax.lax.all_to_all(xl, names, split_axis=t, concat_axis=s,
                            tiled=True)
    return getattr(jnp.fft, base)(xl, axis=s)

  out = jax.shard_map(body_f, mesh=mesh, in_specs=(in_spec,),
                      out_specs=out_spec, check_vma=False)(a)
  if out.shape[t] != t_len:
    out = jax.lax.slice_in_dim(out, 0, t_len, axis=t)
  return out




def _four_step_fft(name, kw, a, mesh):
  """Distributed single-axis FFT for long 1-D arrays (Bailey four-step),
  or None if ineligible.  n = n1*n2: view x as (n1, n2) row-major, FFT
  the strided axis while columns are sharded, multiply by the twiddle
  W_n^(j2*k1), ONE all_to_all transpose, FFT the contiguous axis, read
  out as the transpose — X[k1 + n1*k2] = D[k1, k2].  A 1-D transform
  has no batch dims to shard, so the localize fallback fully replicates
  it; this keeps O(n/p) per device.  Twiddle phases come from exact
  integer j2*k1 (< n), so float rounding contributes only ~2pi*eps
  absolute phase error even at huge n."""
  import jax
  import jax.numpy as jnp
  from jax.sharding import PartitionSpec as P
  from spartan_tpu.config import FLAGS
  if name not in ("fft", "ifft") or a.ndim != 1:
    return None
  n = a.shape[0]
  n_kw = dict(kw).get("n")
  if (n_kw is not None and n_kw != n) or n < int(FLAGS.fft_pencil_min_elems):
    return None
  p = int(mesh.devices.size)
  best = None
  d = 1
  while d * d <= n:           # trace-time host loop over divisors
    if n % d == 0:
      for n1 in (d, n // d):
        if n1 % p == 0 and (n // n1) % p == 0:
          if best is None or abs(n1 - n // n1) < abs(best - n // best):
            best = n1
    d += 1
  if best is None:
    return None
  n1, n2 = best, n // best
  names = tuple(mesh.axis_names)
  sign = -2j if name == "fft" else 2j
  x64 = bool(jax.config.jax_enable_x64)
  itype = jnp.int64 if x64 else jnp.int32
  ftype = jnp.float64 if x64 else jnp.float32

  def body(xl):
    # xl: (n1, n2/p) — column block of the row-major (n1, n2) view
    b = getattr(jnp.fft, name)(xl, axis=0)
    j2 = (jax.lax.axis_index(names) * (n2 // p)
          + jnp.arange(n2 // p, dtype=itype))
    k1 = jnp.arange(n1, dtype=itype)
    ph = (k1[:, None] * j2[None, :]).astype(ftype)  # exact ints < n
    c = b * jnp.exp((sign * jnp.pi / n) * ph).astype(b.dtype)
    c = jax.lax.all_to_all(c, names, split_axis=0, concat_axis=1,
                           tiled=True)
    return getattr(jnp.fft, name)(c, axis=1)

  d2 = jax.shard_map(body, mesh=mesh, in_specs=(P(None, names),),
                     out_specs=P(names, None),
                     check_vma=False)(a.reshape(n1, n2))
  return d2.T.reshape(n)


def _fft_call(name, kw, a):
  import jax
  import jax.numpy as jnp
  from jax.sharding import NamedSharding, PartitionSpec as P

  from spartan_tpu.config import FLAGS
  kw = dict(kw)
  norm = kw.pop("norm", None)
  axes = _transform_axes(name, kw, a.ndim)
  if axes:
    from spartan_tpu.core.mesh import get_mesh
    mesh = get_mesh()
    if mesh is not None and mesh.devices.size > 1:
      if FLAGS.fft_pencil and "s" not in kw:
        out = _pencil_fft(name, a, axes, mesh)
        if out is None:
          out = _four_step_fft(name, kw, a, mesh)
        if out is not None:
          # the stages compose to norm='backward'; rescale for the rest
          return _apply_norm(out, name, norm, a, axes)
      # Fallback: the transform axes whole on each device; constraining
      # them to None (others unconstrained) keeps batch dims sharded and
      # ALSO sidesteps an XLA:CPU fft-thunk layout RET_CHECK that aborts
      # chained fft programs whose transform axis is sharded (reproduced
      # on jax 0.9: jit(real∘ifft2∘fft2) over a last-axis-sharded input).
      spec = P(*[None if d in axes else P.UNCONSTRAINED
                 for d in range(a.ndim)])
      a = jax.lax.with_sharding_constraint(a, NamedSharding(mesh, spec))
  if norm is not None:
    kw["norm"] = norm
  return getattr(jnp.fft, name)(a, **kw)


def _apply_norm(out, name, norm, a_in, axes):
  """Rescale a backward-normed decomposed transform to ``norm``.
  numpy semantics: forward transforms scale by 1 / sqrt(N) / N for
  backward / ortho / forward; inverses by 1/N / 1/sqrt(N) / 1, with N
  the product of the transform lengths (OUTPUT lengths for irfft)."""
  import numpy as _np
  if norm is None or norm == "backward":
    return out
  if norm not in ("ortho", "forward"):
    raise ValueError(f"Invalid norm value {norm!r}; should be 'backward', "
                     "'ortho' or 'forward'.")
  src = out if name in ("irfft2", "irfftn") else a_in
  n_tot = float(_np.prod([src.shape[ax] for ax in axes]))
  inverse = name.startswith("i")
  if inverse:   # computed with 1/N built in
    return out * (n_tot ** 0.5 if norm == "ortho" else n_tot)
  return out / (n_tot ** 0.5 if norm == "ortho" else n_tot)


def _fft_map(v, name, **kw):
  kw = {k: w for k, w in kw.items() if w is not None}
  return sp.map([sp.lazify(v)],
                functools.partial(_fft_call, name, tuple(sorted(kw.items()))))


def fft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "fft", n=n, axis=axis, norm=norm)


def ifft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "ifft", n=n, axis=axis, norm=norm)


def rfft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "rfft", n=n, axis=axis, norm=norm)


def irfft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "irfft", n=n, axis=axis, norm=norm)


def fft2(v, s=None, axes=(-2, -1), norm=None):
  return _fft_map(v, "fft2", s=None if s is None else tuple(s),
                  axes=tuple(axes), norm=norm)


def ifft2(v, s=None, axes=(-2, -1), norm=None):
  return _fft_map(v, "ifft2", s=None if s is None else tuple(s),
                  axes=tuple(axes), norm=norm)


def fftn(v, s=None, axes=None, norm=None):
  return _fft_map(v, "fftn", s=None if s is None else tuple(s),
                  axes=None if axes is None else tuple(axes), norm=norm)


def ifftn(v, s=None, axes=None, norm=None):
  return _fft_map(v, "ifftn", s=None if s is None else tuple(s),
                  axes=None if axes is None else tuple(axes), norm=norm)


def rfft2(v, s=None, axes=(-2, -1), norm=None):
  return _fft_map(v, "rfft2", s=None if s is None else tuple(s),
                  axes=tuple(axes), norm=norm)


def irfft2(v, s=None, axes=(-2, -1), norm=None):
  return _fft_map(v, "irfft2", s=None if s is None else tuple(s),
                  axes=tuple(axes), norm=norm)


def rfftn(v, s=None, axes=None, norm=None):
  return _fft_map(v, "rfftn", s=None if s is None else tuple(s),
                  axes=None if axes is None else tuple(axes), norm=norm)


def irfftn(v, s=None, axes=None, norm=None):
  return _fft_map(v, "irfftn", s=None if s is None else tuple(s),
                  axes=None if axes is None else tuple(axes), norm=norm)


def hfft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "hfft", n=n, axis=axis, norm=norm)


def ihfft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "ihfft", n=n, axis=axis, norm=norm)


def fftshift(v, axes=None):
  return _fft_map(v, "fftshift", axes=None if axes is None else tuple(axes))


def ifftshift(v, axes=None):
  return _fft_map(v, "ifftshift",
                  axes=None if axes is None else tuple(axes))


def fftfreq(n, d=1.0):
  return sp.from_numpy(np.fft.fftfreq(int(n), d))


def rfftfreq(n, d=1.0):
  return sp.from_numpy(np.fft.rfftfreq(int(n), d))


# ---------------------------------------------------------------------
# scipy.fft extras: DCT/DST families, Hermitian n-D, fast Hankel.
#
# Device-first shapes: every cosine/sine transform lowers to ONE real FFT
# of a symmetric extension (types 1/2) or a half-sample-phased
# zero-padded complex FFT (types 3/4) — no quadratic basis matmuls and
# no data-dependent control flow; the n-D variants apply the 1-D kernel
# per axis.  fht/ifht are FFTLog (Hamilton 2000): the u_m coefficients
# are data-independent and computed once on the HOST (complex loggamma
# has no XLA lowering — the signal.py design-time convention), the
# transform itself is a device rfft·u·irfft.
# ---------------------------------------------------------------------

__all__ += ["dct", "idct", "dst", "idst", "dctn", "idctn", "dstn",
            "idstn", "hfft2", "hfftn", "ihfft2", "ihfftn", "fht",
            "ifht", "fhtoffset", "next_fast_len", "prev_fast_len",
            "set_workers", "get_workers"]


def _dct1d(x, type):
  """Backward-normed DCT along the last axis (concrete jnp)."""
  import jax.numpy as jnp
  N = x.shape[-1]
  if type == 1:
    if N < 2:
      raise ValueError("DCT-I requires length >= 2")
    w = jnp.concatenate([x, x[..., -2:0:-1]], -1)      # 2N-2 sym ext
    return jnp.fft.rfft(w)[..., :N].real
  if type == 2:
    w = jnp.zeros(x.shape[:-1] + (4 * N,), x.dtype)    # interleaved
    w = w.at[..., 1:2 * N:2].set(x)                    # sym extension
    w = w.at[..., 2 * N + 1:4 * N:2].set(x[..., ::-1])
    return jnp.fft.rfft(w)[..., :N].real
  ar = jnp.arange(N)
  if type == 3:
    xt = x * jnp.where(ar == 0, 1.0, 2.0)
    z = xt * jnp.exp(1j * jnp.pi * ar / (2 * N))
    z = jnp.concatenate([z, jnp.zeros_like(z)], -1)
    return (jnp.fft.ifft(z, axis=-1) * (2 * N))[..., :N].real
  if type == 4:
    z = x * jnp.exp(-1j * jnp.pi * ar / (2 * N))
    z = jnp.concatenate([z, jnp.zeros_like(z)], -1)
    F = jnp.fft.fft(z, axis=-1)[..., :N]
    ph = jnp.exp(-1j * jnp.pi * (2 * ar + 1) / (4 * N))
    return 2.0 * (ph * F).real
  raise ValueError(f"DCT type must be 1-4, got {type}")


def _dst1d(x, type):
  """Backward-normed DST along the last axis — types 2-4 ride the DCT
  kernels via the exact flip/alternating-sign identities."""
  import jax.numpy as jnp
  N = x.shape[-1]
  ar = jnp.arange(N)
  if type == 1:
    w = jnp.zeros(x.shape[:-1] + (2 * N + 2,), x.dtype)  # odd ext
    w = w.at[..., 1:N + 1].set(x)
    w = w.at[..., N + 2:].set(-x[..., ::-1])
    return -jnp.fft.rfft(w)[..., 1:N + 1].imag
  s = jnp.where(ar % 2 == 0, 1.0, -1.0).astype(x.dtype)
  if type == 2:
    return _dct1d(x * s, 2)[..., ::-1]
  if type == 3:
    return _dct1d(x[..., ::-1], 3) * s
  if type == 4:
    return _dct1d(x[..., ::-1], 4) * s
  raise ValueError(f"DST type must be 1-4, got {type}")


def _cos_den(kind, type, N):
  if type == 1:
    return 2.0 * (N - 1) if kind == "dct" else 2.0 * (N + 1)
  return 2.0 * N


_INV_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}
_INV_NORM = {"backward": "forward", "forward": "backward",
             "ortho": "ortho"}


def _cosine_axis(x, kind, type, n, axis, norm, orthogonalize):
  """Full scipy-semantics 1-axis transform on a concrete array."""
  import jax.numpy as jnp
  x = jnp.moveaxis(x, axis, -1)
  if n is not None:
    cur = x.shape[-1]
    if n < cur:
      x = x[..., :n]
    elif n > cur:
      pad = [(0, 0)] * (x.ndim - 1) + [(0, n - cur)]
      x = jnp.pad(x, pad)
  N = x.shape[-1]
  adj = orthogonalize if orthogonalize is not None else norm == "ortho"
  r2 = float(np.sqrt(2.0))
  if adj:
    if kind == "dct" and type == 3:
      x = x.at[..., 0].multiply(r2)
    elif kind == "dct" and type == 1:
      x = x.at[..., 0].multiply(r2).at[..., -1].multiply(r2)
    elif kind == "dst" and type == 3:
      x = x.at[..., -1].multiply(r2)
  y = _dct1d(x, type) if kind == "dct" else _dst1d(x, type)
  if adj:
    if kind == "dct" and type == 2:
      y = y.at[..., 0].divide(r2)
    elif kind == "dct" and type == 1:
      y = y.at[..., 0].divide(r2).at[..., -1].divide(r2)
    elif kind == "dst" and type == 2:
      y = y.at[..., -1].divide(r2)
  den = _cos_den(kind, type, N)
  if norm == "ortho":
    y = y / np.sqrt(den)
  elif norm == "forward":
    y = y / den
  return jnp.moveaxis(y, -1, axis)


def _localize_axes(a, axes):
  """Constrain the given dims local on >1-device meshes (the _fft_call
  fallback — keeps batch dims sharded, dodges the XLA:CPU fft-layout
  RET_CHECK on sharded transform axes)."""
  import jax
  from jax.sharding import NamedSharding, PartitionSpec as P
  from spartan_tpu.core.mesh import get_mesh
  mesh = get_mesh()
  if mesh is None or mesh.devices.size <= 1:
    return a
  axes = tuple(ax % a.ndim for ax in axes)
  spec = P(*[None if d in axes else P.UNCONSTRAINED
             for d in range(a.ndim)])
  return jax.lax.with_sharding_constraint(a, NamedSharding(mesh, spec))


def _cos_dtype(x):
  """ints -> default float; complex splits (types 1/2 ride rfft,
  which needs real input — scipy transforms re/im independently)."""
  import jax.numpy as jnp
  if jnp.issubdtype(x.dtype, jnp.complexfloating):
    return x, True
  if not jnp.issubdtype(x.dtype, jnp.floating):
    return x.astype(jnp.result_type(x.dtype, 1.0)), False
  return x, False


def _cosine_call(kind, inverse, type, n, axis, norm, orthogonalize, x):
  if norm not in (None, "backward", "ortho", "forward"):
    raise ValueError(f"Invalid norm value {norm!r}")
  norm = norm or "backward"
  if inverse:
    type, norm = _INV_TYPE[int(type)], _INV_NORM[norm]
  x = _localize_axes(x, (axis,))
  x, cplx = _cos_dtype(x)
  if cplx:
    return (_cosine_axis(x.real, kind, int(type), n, axis, norm,
                         orthogonalize)
            + 1j * _cosine_axis(x.imag, kind, int(type), n, axis,
                                norm, orthogonalize))
  return _cosine_axis(x, kind, int(type), n, axis, norm, orthogonalize)


def _cosine_map(v, kind, inverse, type, n, axis, norm, orthogonalize):
  return sp.map([sp.lazify(v)],
                functools.partial(_cosine_call, kind, inverse, type, n,
                                  axis, norm, orthogonalize))


def dct(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
        workers=None, *, orthogonalize=None):
  """scipy.fft.dct — one real-FFT device kernel (see module header)."""
  return _cosine_map(x, "dct", False, type, n, axis, norm, orthogonalize)


def idct(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
         workers=None, *, orthogonalize=None):
  return _cosine_map(x, "dct", True, type, n, axis, norm, orthogonalize)


def dst(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
        workers=None, *, orthogonalize=None):
  return _cosine_map(x, "dst", False, type, n, axis, norm, orthogonalize)


def idst(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
         workers=None, *, orthogonalize=None):
  return _cosine_map(x, "dst", True, type, n, axis, norm, orthogonalize)


def _cosine_nd_call(kind, inverse, type, s, axes, norm, orthogonalize,
                    x):
  if norm not in (None, "backward", "ortho", "forward"):
    raise ValueError(f"Invalid norm value {norm!r}")
  nrm = norm or "backward"
  t = int(type)
  if inverse:
    t, nrm = _INV_TYPE[t], _INV_NORM[nrm]
  if axes is None:
    axes = (tuple(range(x.ndim)) if s is None
            else tuple(range(x.ndim - len(s), x.ndim)))
  axes = tuple(ax % x.ndim for ax in axes)
  ss = (None,) * len(axes) if s is None else tuple(s)
  x = _localize_axes(x, axes)
  x, cplx = _cos_dtype(x)
  if cplx:
    re, im = x.real, x.imag
    for ax, nn in zip(axes, ss):
      re = _cosine_axis(re, kind, t, nn, ax, nrm, orthogonalize)
      im = _cosine_axis(im, kind, t, nn, ax, nrm, orthogonalize)
    return re + 1j * im
  for ax, nn in zip(axes, ss):
    x = _cosine_axis(x, kind, t, nn, ax, nrm, orthogonalize)
  return x


def _cosine_nd_map(v, kind, inverse, type, s, axes, norm,
                   orthogonalize):
  s = None if s is None else tuple(int(i) for i in s)
  axes = None if axes is None else tuple(int(a) for a in axes)
  return sp.map([sp.lazify(v)],
                functools.partial(_cosine_nd_call, kind, inverse, type,
                                  s, axes, norm, orthogonalize))


def dctn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
         workers=None, *, orthogonalize=None):
  """scipy.fft.dctn — the 1-D kernel applied per axis."""
  return _cosine_nd_map(x, "dct", False, type, s, axes, norm,
                        orthogonalize)


def idctn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
          workers=None, *, orthogonalize=None):
  return _cosine_nd_map(x, "dct", True, type, s, axes, norm,
                        orthogonalize)


def dstn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
         workers=None, *, orthogonalize=None):
  return _cosine_nd_map(x, "dst", False, type, s, axes, norm,
                        orthogonalize)


def idstn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
          workers=None, *, orthogonalize=None):
  return _cosine_nd_map(x, "dst", True, type, s, axes, norm,
                        orthogonalize)


# -- Hermitian n-D (real-spectrum signals) ------------------------------

def _hfftn_call(inverse, s, axes, norm, x):
  """hfftn = irfftn(conj(x)) * Ntot with forward-direction norms;
  ihfftn = conj(rfftn(x)) with inverse-direction norms."""
  import jax.numpy as jnp
  if norm not in (None, "backward", "ortho", "forward"):
    raise ValueError(f"Invalid norm value {norm!r}")
  if axes is None:
    axes = (tuple(range(x.ndim)) if s is None
            else tuple(range(x.ndim - len(s), x.ndim)))
  axes = tuple(ax % x.ndim for ax in axes)
  x = _localize_axes(x, axes)
  if inverse:
    y = jnp.conj(jnp.fft.rfftn(x, s=s, axes=axes))
    n_tot = float(np.prod([x.shape[ax] if s is None else s[i]
                           for i, ax in enumerate(axes)]))
    if norm in (None, "backward"):
      return y / n_tot
    return y / np.sqrt(n_tot) if norm == "ortho" else y
  y = jnp.fft.irfftn(jnp.conj(x), s=s, axes=axes)
  n_tot = float(np.prod([y.shape[ax] for ax in axes]))
  y = y * n_tot
  if norm == "ortho":
    return y / np.sqrt(n_tot)
  return y / n_tot if norm == "forward" else y


def _hfftn_map(v, inverse, s, axes, norm):
  s = None if s is None else tuple(int(i) for i in s)
  axes = None if axes is None else tuple(int(a) for a in axes)
  return sp.map([sp.lazify(v)],
                functools.partial(_hfftn_call, inverse, s, axes, norm))


def hfft2(x, s=None, axes=(-2, -1), norm=None):
  return _hfftn_map(x, False, s, tuple(axes), norm)


def hfftn(x, s=None, axes=None, norm=None):
  return _hfftn_map(x, False, s, axes, norm)


def ihfft2(x, s=None, axes=(-2, -1), norm=None):
  return _hfftn_map(x, True, s, tuple(axes), norm)


def ihfftn(x, s=None, axes=None, norm=None):
  return _hfftn_map(x, True, s, axes, norm)


# -- fast Hankel transform (FFTLog) --------------------------------------

def _fht_coeff(n, dln, mu, offset, bias):
  """FFTLog u_m coefficients (Hamilton 2000 eq. 16-18) — host once per
  (n, dln, mu, offset, bias): complex loggamma has no XLA lowering."""
  from scipy.special import loggamma
  m = np.arange(n // 2 + 1)
  y = np.pi * m / (n * dln)
  xp = (mu + 1 + bias) / 2
  xm = (mu + 1 - bias) / 2
  v = loggamma(xp + 1j * y) - loggamma(xm - 1j * y)
  u = np.exp((bias + 2j * y) * np.log(2.0) - 2j * y * offset + v)
  if n % 2 == 0:
    u[-1] = u[-1].real  # low-ringing: Nyquist coefficient real
  return u


def _fht_call(dln, mu, offset, bias, inverse, a):
  import jax.numpy as jnp
  n = a.shape[-1]
  u = jnp.asarray(_fht_coeff(n, float(dln), float(mu), float(offset),
                             float(bias)))
  j = np.arange(n)
  pre = np.exp(-bias * (j - (n - 1) / 2) * dln) if bias else None
  post = (np.exp(-bias * ((j - (n - 1) / 2) * dln + offset))
          if bias else None)
  a = _localize_axes(a, (-1,))
  if not inverse:
    if pre is not None:
      a = a * jnp.asarray(pre)
    A = jnp.fft.irfft(jnp.fft.rfft(a, axis=-1) * u, n,
                      axis=-1)[..., ::-1]
    if post is not None:
      A = A * jnp.asarray(post)
    return A
  if post is not None:
    a = a / jnp.asarray(post)
  out = jnp.fft.irfft(jnp.fft.rfft(a, axis=-1) / jnp.conj(u), n,
                      axis=-1)[..., ::-1]
  if pre is not None:
    out = out / jnp.asarray(pre)
  return out


def fht(a, dln, mu, offset=0.0, bias=0.0):
  """scipy.fft.fht — FFTLog: host-computed u_m, device rfft·u·irfft."""
  return sp.map([sp.lazify(a)],
                functools.partial(_fht_call, float(dln), float(mu),
                                  float(offset), float(bias), False))


def ifht(A, dln, mu, offset=0.0, bias=0.0):
  """scipy.fft.ifht — the exact inverse (divide by conj(u))."""
  return sp.map([sp.lazify(A)],
                functools.partial(_fht_call, float(dln), float(mu),
                                  float(offset), float(bias), True))


# -- host helpers (tiny scalar/integer utilities, scipy re-exports) ------

from scipy.fft import fhtoffset  # noqa: E402  (low-ringing offset search)
from scipy.fft import next_fast_len, prev_fast_len  # noqa: E402
from scipy.fft import get_workers, set_workers  # noqa: E402

_HOST_NAMES = ["fhtoffset", "next_fast_len", "prev_fast_len",
               "get_workers", "set_workers"]
