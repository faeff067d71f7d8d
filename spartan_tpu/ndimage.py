"""``sp.ndimage`` — the scipy.ndimage surface, on device.

The reference has no image module (beyond-parity surface, the
sp.signal pattern).  N-D image work is what the vector and matrix units were built
for, so the data-plane core runs as lazy device kernels:

* **filters** — boundary handling is one ``jnp.pad`` (every ndimage
  mode maps to a pad mode), then correlation via XLA conv / shifted
  stacks; separable ``gaussian_filter``/``uniform_filter`` run one
  1-D pass per axis inside a single fused kernel; rank filters
  (min/max/median/rank/percentile, grey morphology) are static
  shifted-window stacks with sort/extremum selects — no data-dependent
  shapes anywhere.
* **binary morphology** — erosion/dilation as windowed all/any over
  the structuring element; ``binary_propagation``/``fill_holes`` are
  geodesic flood fills: ONE ``lax.while_loop`` of masked dilations
  with a changed-flag stop (the classic iterate-until-stable made
  compiler-friendly).
* **measurements** — per-label reductions ride the one-hot matmul
  segment-sum idiom; ``label`` is
  min-label propagation in a fused while_loop (the csgraph
  connected-components pattern) with a host renumber pass.
* **fourier filters** — host-computed spectral multipliers applied
  lazily (elementwise, fuses into surrounding FFT chains).
* **interpolation** — ``map_coordinates``/``shift``/``zoom``/
  ``rotate``/``affine_transform`` run ON DEVICE for order <= 1
  (jax.scipy gather interpolation); spline orders >= 2 route host
  (scipy's default order=3 — say so once), as do the distance
  transforms, watershed, ``find_objects`` (variable-length output)
  and the per-window python-callable ``generic_*`` family.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp
from spartan_tpu.expr.base import Expr
from spartan_tpu.util import log_info

__all__ = [
    # filters
    "correlate", "convolve", "correlate1d", "convolve1d",
    "uniform_filter", "uniform_filter1d", "gaussian_filter",
    "gaussian_filter1d", "gaussian_laplace",
    "gaussian_gradient_magnitude", "laplace", "sobel", "prewitt",
    "generic_laplace", "generic_gradient_magnitude",
    "minimum_filter", "minimum_filter1d", "maximum_filter",
    "maximum_filter1d", "median_filter", "rank_filter",
    "percentile_filter", "vectorized_filter",
    # morphology
    "generate_binary_structure", "iterate_structure",
    "binary_erosion", "binary_dilation", "binary_opening",
    "binary_closing", "binary_propagation", "binary_fill_holes",
    "binary_hit_or_miss", "grey_erosion", "grey_dilation",
    "grey_opening", "grey_closing", "morphological_gradient",
    "morphological_laplace", "white_tophat", "black_tophat",
    # measurements
    "label", "sum", "sum_labels", "mean", "variance",
    "standard_deviation", "minimum", "maximum", "median",
    "minimum_position", "maximum_position", "extrema",
    "center_of_mass", "histogram", "labeled_comprehension",
    "find_objects", "value_indices",
    # fourier
    "fourier_gaussian", "fourier_shift", "fourier_uniform",
    "fourier_ellipsoid",
    # interpolation
    "map_coordinates", "shift", "zoom", "rotate", "affine_transform",
    "geometric_transform", "spline_filter", "spline_filter1d",
    # host boundaries
    "distance_transform_edt", "distance_transform_cdt",
    "distance_transform_bf", "watershed_ift", "generic_filter",
    "generic_filter1d",
]

_PAD_MODE = {
    "reflect": "symmetric", "grid-mirror": "symmetric",
    "mirror": "reflect",
    "nearest": "edge",
    "wrap": "wrap", "grid-wrap": "wrap",
    "constant": "constant", "grid-constant": "constant",
}


def _pad_kw(mode: str, cval):
  try:
    jmode = _PAD_MODE[mode]
  except KeyError:
    raise ValueError(f"unknown boundary mode {mode!r}") from None
  return (jmode, {"constant_values": cval} if jmode == "constant" else {})


def _origins(origin, nd):
  o = np.broadcast_to(np.asarray(origin, int), (nd,))
  return tuple(int(v) for v in o)


_host_noticed: set = set()


def _host_notice(name, why):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info("sp.ndimage.%s: %s — runs EAGERLY on the host "
           "(scipy.ndimage), the sp.linalg.eig convention.", name, why)


def _host_nd(name, why, *args, **kw):
  import scipy.ndimage as ndi
  _host_notice(name, why)
  conv = [np.asarray(sp.lazify(a).glom())
          if isinstance(a, (Expr, np.ndarray)) else a for a in args]
  return getattr(ndi, name)(*conv, **kw)


# ---------------------------------------------------------------------
# correlation / convolution (XLA conv after one boundary pad)
# ---------------------------------------------------------------------

def _corr_nd(input, weights, mode, cval, origin, flip: bool):
  X = sp.lazify(input)
  w = np.asarray(sp.lazify(weights).glom(), dtype=float)
  nd = len(X.shape)
  if w.ndim != nd:
    raise RuntimeError("filter weights array has incorrect shape.")
  if flip:
    w = w[tuple(slice(None, None, -1) for _ in range(nd))]
    orig = tuple(-o - (1 - s % 2) for o, s in
                 zip(_origins(origin, nd), w.shape))
  else:
    orig = _origins(origin, nd)
  jmode, pkw = _pad_kw(mode, cval)

  def kern(xx):
    import jax
    import jax.numpy as jnp
    dt = jnp.result_type(xx.dtype, jnp.float32)
    # filter center lands at s//2 + origin: pad so VALID correlation
    # reads exactly scipy's window.  lax.conv_general_dilated IS
    # cross-correlation (no kernel flip), matching scipy.correlate.
    pads = [(s // 2 + o, s - 1 - (s // 2 + o))
            for s, o in zip(w.shape, orig)]
    xp = jnp.pad(xx.astype(dt), pads, mode=jmode, **pkw)
    wj = jnp.asarray(w, dt)
    out = jax.lax.conv_general_dilated(
        xp[None, None], wj[None, None],
        window_strides=(1,) * nd, padding="VALID")
    return out[0, 0]

  return sp.map([X], kern)


def correlate(input, weights, output=None, mode: str = "reflect",
              cval: float = 0.0, origin=0):
  """N-D correlation — one boundary pad + XLA ``conv_general_dilated``
  (matmul-tiled for 2-D)."""
  del output
  return _corr_nd(input, weights, mode, cval, origin, flip=False)


def convolve(input, weights, output=None, mode: str = "reflect",
             cval: float = 0.0, origin=0):
  del output
  return _corr_nd(input, weights, mode, cval, origin, flip=True)


def _corr1d(input, weights, axis, mode, cval, origin, flip: bool):
  X = sp.lazify(input)
  nd = len(X.shape)
  w = np.atleast_1d(np.asarray(sp.lazify(weights).glom(), dtype=float))
  shape = [1] * nd
  shape[axis % nd] = w.size
  o = [0] * nd
  o[axis % nd] = int(origin)
  return _corr_nd(X, w.reshape(shape), mode, cval, tuple(o), flip)


def correlate1d(input, weights, axis: int = -1, output=None,
                mode: str = "reflect", cval: float = 0.0, origin=0):
  del output
  return _corr1d(input, weights, axis, mode, cval, origin, False)


def convolve1d(input, weights, axis: int = -1, output=None,
               mode: str = "reflect", cval: float = 0.0, origin=0):
  del output
  return _corr1d(input, weights, axis, mode, cval, origin, True)


def uniform_filter1d(input, size: int, axis: int = -1, output=None,
                     mode: str = "reflect", cval: float = 0.0,
                     origin=0):
  del output
  return _corr1d(input, np.full(int(size), 1.0 / int(size)), axis,
                 mode, cval, origin, False)


def uniform_filter(input, size=3, output=None, mode: str = "reflect",
                   cval: float = 0.0, origin=0, *, axes=None):
  """Separable box filter — one 1-D pass per axis, all in one fused
  kernel chain."""
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  axes = tuple(range(nd)) if axes is None else tuple(
      a % nd for a in axes)
  sizes = np.broadcast_to(np.asarray(size, int), (len(axes),))
  origins = np.broadcast_to(np.asarray(origin, int), (len(axes),))
  out = X
  for ax, s, o in zip(axes, sizes, origins):
    out = uniform_filter1d(out, int(s), axis=ax, mode=mode, cval=cval,
                           origin=int(o))
  return out


def _gauss_kernel(sigma: float, order: int, truncate: float, radius):
  r = int(radius) if radius is not None else int(truncate * float(sigma)
                                                 + 0.5)
  xk = np.arange(-r, r + 1, dtype=float)
  phi = np.exp(-0.5 * xk * xk / (sigma * sigma))
  phi /= phi.sum()
  if order == 0:
    return phi
  # scipy: apply the Hermite-polynomial derivative correction
  q = np.zeros(order + 1)
  q[0] = 1
  D = np.diag(np.arange(1, order + 1), 1)       # d/dx
  P = np.diag(np.ones(order) / -(sigma * sigma), -1)  # x * -1/sigma^2
  Q_deriv = D + P
  for _ in range(order):
    q = Q_deriv.dot(q)
  q = (xk[:, None] ** np.arange(order + 1)[None]).dot(q)
  return q * phi


def gaussian_filter1d(input, sigma: float, axis: int = -1,
                      order: int = 0, output=None,
                      mode: str = "reflect", cval: float = 0.0,
                      truncate: float = 4.0, *, radius=None):
  """1-D Gaussian (and derivative-of-Gaussian) — host kernel weights,
  one device correlation."""
  del output
  w = _gauss_kernel(float(sigma), int(order), truncate, radius)
  return _corr1d(input, w[::-1], axis, mode, cval, 0, False)


def gaussian_filter(input, sigma, order=0, output=None,
                    mode: str = "reflect", cval: float = 0.0,
                    truncate: float = 4.0, *, radius=None, axes=None):
  """Separable N-D Gaussian — one 1-D device pass per axis."""
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  axes = tuple(range(nd)) if axes is None else tuple(
      a % nd for a in axes)
  sigmas = np.broadcast_to(np.asarray(sigma, float), (len(axes),))
  orders = np.broadcast_to(np.asarray(order, int), (len(axes),))
  out = X
  for ax, s, o in zip(axes, sigmas, orders):
    if s > 1e-15:
      out = gaussian_filter1d(out, float(s), axis=ax, order=int(o),
                              mode=mode, cval=cval, truncate=truncate,
                              radius=radius)
  return out


def generic_laplace(input, derivative2, output=None,
                    mode: str = "reflect", cval: float = 0.0,
                    extra_arguments=(), extra_keywords=None):
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  kw = extra_keywords or {}
  out = derivative2(X, 0, None, mode, cval, *extra_arguments, **kw)
  for ax in range(1, nd):
    out = out + derivative2(X, ax, None, mode, cval, *extra_arguments,
                            **kw)
  return out


def laplace(input, output=None, mode: str = "reflect",
            cval: float = 0.0):
  """N-D Laplace — sum of second-difference correlations (device)."""
  def d2(x, ax, out, m, cv):
    return correlate1d(x, np.array([1.0, -2.0, 1.0]), ax, out, m, cv, 0)
  return generic_laplace(input, d2, output, mode, cval)


def gaussian_laplace(input, sigma, output=None, mode: str = "reflect",
                     cval: float = 0.0, **kwargs):
  def d2(x, ax, out, m, cv):
    nd = len(sp.lazify(x).shape)
    orders = [0] * nd
    orders[ax] = 2
    return gaussian_filter(x, sigma, orders, out, m, cv, **kwargs)
  return generic_laplace(input, d2, output, mode, cval)


def generic_gradient_magnitude(input, derivative, output=None,
                               mode: str = "reflect", cval: float = 0.0,
                               extra_arguments=(), extra_keywords=None):
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  kw = extra_keywords or {}
  acc = None
  for ax in range(nd):
    d = derivative(X, ax, None, mode, cval, *extra_arguments, **kw)
    acc = d * d if acc is None else acc + d * d
  return sp.sqrt(acc)


def gaussian_gradient_magnitude(input, sigma, output=None,
                                mode: str = "reflect",
                                cval: float = 0.0, **kwargs):
  def d1(x, ax, out, m, cv):
    nd = len(sp.lazify(x).shape)
    orders = [0] * nd
    orders[ax] = 1
    return gaussian_filter(x, sigma, orders, out, m, cv, **kwargs)
  return generic_gradient_magnitude(input, d1, output, mode, cval)


def _edge_filter(input, axis, mode, cval, smooth):
  X = sp.lazify(input)
  nd = len(X.shape)
  ax = axis % nd
  out = correlate1d(X, np.array([-1.0, 0.0, 1.0]), ax, None, mode,
                    cval, 0)
  for a in range(nd):
    if a != ax:
      out = correlate1d(out, smooth, a, None, mode, cval, 0)
  return out


def sobel(input, axis: int = -1, output=None, mode: str = "reflect",
          cval: float = 0.0):
  del output
  return _edge_filter(input, axis, mode, cval, np.array([1.0, 2.0, 1.0]))


def prewitt(input, axis: int = -1, output=None, mode: str = "reflect",
            cval: float = 0.0):
  del output
  return _edge_filter(input, axis, mode, cval, np.array([1.0, 1.0, 1.0]))



# ---------------------------------------------------------------------
# rank filters + grey morphology (static shifted-window stacks)
# ---------------------------------------------------------------------

def _footprint_of(size, footprint, nd, name):
  if footprint is not None:
    fp = np.asarray(sp.lazify(footprint).glom()).astype(bool)
    if fp.ndim != nd:
      raise RuntimeError("footprint array has incorrect shape.")
    return fp
  if size is None:
    raise ValueError(f"{name}: either size or footprint must be given")
  sizes = tuple(np.broadcast_to(np.asarray(size, int), (nd,)))
  return np.ones(sizes, bool)


def _stack_windows(xx, offs, jmode, pkw):
  """Pad once, slice per offset — (n_offsets, *shape) plane stack."""
  import jax.numpy as jnp
  nd = xx.ndim
  lo = [max(0, int(-offs[:, d].min())) for d in range(nd)]
  hi = [max(0, int(offs[:, d].max())) for d in range(nd)]
  xp = jnp.pad(xx, list(zip(lo, hi)), mode=jmode, **pkw)
  planes = []
  for off in offs:
    sl = tuple(slice(lo[d] + int(off[d]),
                     lo[d] + int(off[d]) + xx.shape[d])
               for d in range(nd))
    planes.append(xp[sl])
  return jnp.stack(planes)


def _fp_offsets(fp, origin, flip: bool):
  """Footprint cell offsets relative to the (origin-shifted) center."""
  nd = fp.ndim
  orig = _origins(origin, nd)
  if flip:
    fp = fp[tuple(slice(None, None, -1) for _ in range(nd))]
    orig = tuple(-o - (1 - s % 2) for o, s in zip(orig, fp.shape))
  centers = [s // 2 + o for s, o in zip(fp.shape, orig)]
  offs = np.argwhere(fp) - np.asarray(centers)
  return fp, offs


def _rank_core(input, fp, origin, mode, cval, reducer, flip=False,
               add=None):
  X = sp.lazify(input)
  jmode, pkw = _pad_kw(mode, cval)
  fp2, offs = _fp_offsets(fp, origin, flip)
  # addv must be bound unconditionally: kern's closure cell would
  # otherwise be EMPTY when add is None and the structural fn_key
  # inspection rejects empty cells
  addv = None if add is None else (
      add[fp2] if add.shape == fp2.shape else add)

  def kern(xx):
    import jax.numpy as jnp
    dt = jnp.result_type(xx.dtype, jnp.float32)
    stack = _stack_windows(xx.astype(dt), offs, jmode, pkw)
    if addv is not None:
      stack = stack + jnp.asarray(addv, dt).reshape(
          (-1,) + (1,) * xx.ndim)
    return reducer(stack)

  return sp.map([X], kern)


def minimum_filter(input, size=None, footprint=None, output=None,
                   mode: str = "reflect", cval: float = 0.0, origin=0,
                   *, axes=None):
  del output, axes
  import jax.numpy as jnp
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "minimum_filter")
  return _rank_core(X, fp, origin, mode, cval,
                    lambda s: jnp.min(s, axis=0))


def maximum_filter(input, size=None, footprint=None, output=None,
                   mode: str = "reflect", cval: float = 0.0, origin=0,
                   *, axes=None):
  del output, axes
  import jax.numpy as jnp
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "maximum_filter")
  return _rank_core(X, fp, origin, mode, cval,
                    lambda s: jnp.max(s, axis=0))


def minimum_filter1d(input, size: int, axis: int = -1, output=None,
                     mode: str = "reflect", cval: float = 0.0,
                     origin=0):
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  shape = [1] * nd
  shape[axis % nd] = int(size)
  o = [0] * nd
  o[axis % nd] = int(origin)
  import jax.numpy as jnp
  return _rank_core(X, np.ones(shape, bool), tuple(o), mode, cval,
                    lambda s: jnp.min(s, axis=0))


def maximum_filter1d(input, size: int, axis: int = -1, output=None,
                     mode: str = "reflect", cval: float = 0.0,
                     origin=0):
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  shape = [1] * nd
  shape[axis % nd] = int(size)
  o = [0] * nd
  o[axis % nd] = int(origin)
  import jax.numpy as jnp
  return _rank_core(X, np.ones(shape, bool), tuple(o), mode, cval,
                    lambda s: jnp.max(s, axis=0))


def rank_filter(input, rank: int, size=None, footprint=None,
                output=None, mode: str = "reflect", cval: float = 0.0,
                origin=0, *, axes=None):
  del output, axes
  import jax.numpy as jnp
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "rank_filter")
  r = int(rank)
  if r < 0:
    r += int(fp.sum())
  return _rank_core(X, fp, origin, mode, cval,
                    lambda s: jnp.sort(s, axis=0)[r])


def median_filter(input, size=None, footprint=None, output=None,
                  mode: str = "reflect", cval: float = 0.0, origin=0,
                  *, axes=None):
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "median_filter")
  return rank_filter(X, int(fp.sum()) // 2, footprint=fp, output=output,
                     mode=mode, cval=cval, origin=origin, axes=axes)


def percentile_filter(input, percentile: float, size=None,
                      footprint=None, output=None,
                      mode: str = "reflect", cval: float = 0.0,
                      origin=0, *, axes=None):
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape),
                     "percentile_filter")
  p = float(percentile)
  if p < 0:
    p += 100.0
  n = int(fp.sum())
  rank = int(p * (n - 1) / 100.0 + 0.5)
  return rank_filter(X, rank, footprint=fp, output=output, mode=mode,
                     cval=cval, origin=origin, axes=axes)


def vectorized_filter(input, function, *, size=None, footprint=None,
                      output=None, mode: str = "reflect", cval=0.0,
                      origin=0, axes=None, batch_memory=None):
  """Rolling-window apply of a VECTORIZED callable — the window stack
  is one device tensor and ``function(stack, axis=0)`` is traced into
  the kernel (scipy loops windows on the host)."""
  del output, axes, batch_memory
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape),
                     "vectorized_filter")
  jmode, pkw = _pad_kw(mode, cval)
  _, offs = _fp_offsets(fp, origin, False)

  def kern(xx):
    import jax.numpy as jnp
    dt = jnp.result_type(xx.dtype, jnp.float32)
    stack = _stack_windows(xx.astype(dt), offs, jmode, pkw)
    return jnp.asarray(function(stack, axis=0))

  return sp.map([X], kern)


# ---------------------------------------------------------------------
# grey morphology
# ---------------------------------------------------------------------

def _grey_structure(size, footprint, structure, nd, name):
  if structure is not None:
    st = np.asarray(sp.lazify(structure).glom(), dtype=float)
    fp = np.ones(st.shape, bool) if footprint is None else \
        np.asarray(sp.lazify(footprint).glom()).astype(bool)
    return fp, st
  fp = _footprint_of(size, footprint, nd, name)
  return fp, None


def grey_erosion(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  """min over the (origin-shifted) footprint of ``x - structure`` —
  one shifted-stack device kernel."""
  del output, axes
  import jax.numpy as jnp
  X = sp.lazify(input)
  fp, st = _grey_structure(size, footprint, structure, len(X.shape),
                           "grey_erosion")
  add = None if st is None else -st
  return _rank_core(X, fp, origin, mode, cval,
                    lambda s: jnp.min(s, axis=0), add=add)


def grey_dilation(input, size=None, footprint=None, structure=None,
                  output=None, mode: str = "reflect", cval: float = 0.0,
                  origin=0, *, axes=None):
  """max over the REFLECTED footprint of ``x + structure`` (scipy's
  convolve-style flip) — one shifted-stack device kernel."""
  del output, axes
  import jax.numpy as jnp
  X = sp.lazify(input)
  fp, st = _grey_structure(size, footprint, structure, len(X.shape),
                           "grey_dilation")
  add = None if st is None else st[tuple(
      slice(None, None, -1) for _ in range(st.ndim))]
  return _rank_core(X, fp, origin, mode, cval,
                    lambda s: jnp.max(s, axis=0), flip=True, add=add)


def grey_opening(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  e = grey_erosion(input, size, footprint, structure, None, mode, cval,
                   origin)
  return grey_dilation(e, size, footprint, structure, output, mode,
                       cval, origin, axes=axes)


def grey_closing(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  d = grey_dilation(input, size, footprint, structure, None, mode,
                    cval, origin)
  return grey_erosion(d, size, footprint, structure, output, mode,
                      cval, origin, axes=axes)


def morphological_gradient(input, size=None, footprint=None,
                           structure=None, output=None,
                           mode: str = "reflect", cval: float = 0.0,
                           origin=0, *, axes=None):
  del axes
  return grey_dilation(input, size, footprint, structure, None, mode,
                       cval, origin) \
      - grey_erosion(input, size, footprint, structure, output, mode,
                     cval, origin)


def morphological_laplace(input, size=None, footprint=None,
                          structure=None, output=None,
                          mode: str = "reflect", cval: float = 0.0,
                          origin=0, *, axes=None):
  del axes
  X = sp.lazify(input)
  return grey_dilation(X, size, footprint, structure, None, mode, cval,
                       origin) \
      + grey_erosion(X, size, footprint, structure, output, mode, cval,
                     origin) - 2.0 * X


def white_tophat(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  del axes
  X = sp.lazify(input)
  return X - grey_opening(X, size, footprint, structure, output, mode,
                          cval, origin)


def black_tophat(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  del axes
  X = sp.lazify(input)
  return grey_closing(X, size, footprint, structure, output, mode,
                      cval, origin) - X


# ---------------------------------------------------------------------
# binary morphology (+ geodesic flood fills in one while_loop)
# ---------------------------------------------------------------------

def generate_binary_structure(rank: int, connectivity: int):
  """Structuring element from chebyshev connectivity (host constant)."""
  import scipy.ndimage as ndi
  return ndi.generate_binary_structure(rank, connectivity)


def iterate_structure(structure, iterations: int, origin=None):
  import scipy.ndimage as ndi
  out = ndi.iterate_structure(
      np.asarray(sp.lazify(structure).glom()).astype(bool),
      int(iterations), origin)
  return out


def _binary_core(input, structure, origin, border_value, flip,
                 op_is_erosion, mask=None):
  X = sp.lazify(input)
  nd = len(X.shape)
  st = (generate_binary_structure(nd, 1) if structure is None
        else np.asarray(sp.lazify(structure).glom()).astype(bool))
  fp2, offs = _fp_offsets(st, origin, flip)
  del fp2
  M = None if mask is None else sp.lazify(mask)

  def kern(*ops):
    import jax.numpy as jnp
    xx = ops[0]
    xb = xx != 0
    pads = "constant"
    stack = _stack_windows(
        xb, offs, pads,
        {"constant_values": bool(border_value)})
    out = jnp.all(stack, axis=0) if op_is_erosion \
        else jnp.any(stack, axis=0)
    if len(ops) > 1:
      out = jnp.where(ops[1] != 0, out, xb)
    return out

  args = [X] if M is None else [X, M]
  return sp.map(args, kern)


def binary_erosion(input, structure=None, iterations: int = 1,
                   mask=None, output=None, border_value: int = 0,
                   origin=0, brute_force: bool = False):
  """Binary erosion — windowed ``all`` over the structuring element
  (device); ``iterations`` composes kernels."""
  del output, brute_force
  out = sp.lazify(input)
  for _ in range(max(int(iterations), 1)):
    out = _binary_core(out, structure, origin, border_value, False,
                       True, mask)
  return out


def binary_dilation(input, structure=None, iterations: int = 1,
                    mask=None, output=None, border_value: int = 0,
                    origin=0, brute_force: bool = False):
  """Binary dilation — windowed ``any`` over the REFLECTED element;
  ``iterations=0`` (dilate to stability) runs as ONE device
  while_loop with a changed-flag stop."""
  del output, brute_force
  if int(iterations) == 0:
    return _flood(input, structure, mask, origin, border_value)
  out = sp.lazify(input)
  for _ in range(max(int(iterations), 1)):
    out = _binary_core(out, structure, origin, border_value, True,
                       False, mask)
  return out


def _flood(seed, structure, mask, origin, border_value):
  """Geodesic dilation until stable: one fused while_loop."""
  X = sp.lazify(seed)
  nd = len(X.shape)
  st = (generate_binary_structure(nd, 1) if structure is None
        else np.asarray(sp.lazify(structure).glom()).astype(bool))
  _, offs = _fp_offsets(st, origin, True)
  M = None if mask is None else sp.lazify(mask)

  def kern(*ops):
    import jax
    import jax.numpy as jnp
    xb = ops[0] != 0
    mk = None if len(ops) == 1 else (ops[1] != 0)

    def body(c):
      cur, _ = c
      stack = _stack_windows(cur, offs, "constant",
                             {"constant_values": bool(border_value)})
      nxt = jnp.any(stack, axis=0) | cur
      if mk is not None:
        nxt = nxt & mk
      return nxt, jnp.any(nxt != cur)

    def cond(c):
      return c[1]

    seed0 = xb if mk is None else (xb & mk)
    out, _ = jax.lax.while_loop(cond, body,
                                (seed0, jnp.asarray(True)))
    return out

  return sp.map([X] if M is None else [X, M], kern)


def binary_propagation(input, structure=None, mask=None, output=None,
                       border_value: int = 0, origin=0):
  """Geodesic propagation of ``input`` inside ``mask`` — the fused
  flood-fill while_loop."""
  del output
  return _flood(input, structure, mask, origin, border_value)


def binary_fill_holes(input, structure=None, output=None, origin=0):
  """Fill holes: flood the COMPLEMENT from the border (border_value=1
  seeds the outside), then un-flooded complement cells are holes."""
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  st = (generate_binary_structure(nd, 1) if structure is None
        else np.asarray(sp.lazify(structure).glom()).astype(bool))
  _, offs = _fp_offsets(st, origin, True)

  def kern(xx):
    import jax
    import jax.numpy as jnp
    inside = xx != 0
    comp = ~inside

    def body(c):
      cur, _ = c
      stack = _stack_windows(cur, offs, "constant",
                             {"constant_values": True})
      nxt = (jnp.any(stack, axis=0) | cur) & comp
      return nxt, jnp.any(nxt != cur)

    seed = comp & (jnp.any(_stack_windows(
        jnp.zeros_like(inside), offs, "constant",
        {"constant_values": True}), axis=0))
    out, _ = jax.lax.while_loop(lambda c: c[1], body,
                                (seed, jnp.asarray(True)))
    return inside | (comp & ~out)

  return sp.map([X], kern)


def binary_opening(input, structure=None, iterations: int = 1,
                   output=None, origin=0, mask=None,
                   border_value: int = 0, brute_force: bool = False):
  e = binary_erosion(input, structure, iterations, mask, None,
                     border_value, origin, brute_force)
  return binary_dilation(e, structure, iterations, mask, output,
                         border_value, origin, brute_force)


def binary_closing(input, structure=None, iterations: int = 1,
                   output=None, origin=0, mask=None,
                   border_value: int = 0, brute_force: bool = False):
  d = binary_dilation(input, structure, iterations, mask, None,
                      border_value, origin, brute_force)
  return binary_erosion(d, structure, iterations, mask, output,
                        border_value, origin, brute_force)


def binary_hit_or_miss(input, structure1=None, structure2=None,
                       output=None, origin1=0, origin2=None):
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  s1 = (generate_binary_structure(nd, 1) if structure1 is None
        else np.asarray(sp.lazify(structure1).glom()).astype(bool))
  if structure2 is None:
    s2 = np.logical_not(s1)
  else:
    s2 = np.asarray(sp.lazify(structure2).glom()).astype(bool)
  if origin2 is None:
    origin2 = origin1
  e1 = binary_erosion(X, s1, 1, None, None, 0, origin1)
  e2 = binary_erosion(1 - X, s2, 1, None, None, 0, origin2)
  return sp.logical_and(e1, e2)


# ---------------------------------------------------------------------
# label + per-label measurements (one-hot matmul segment reductions)
# ---------------------------------------------------------------------

def label(input, structure=None, output=None):
  """Connected components — min-label propagation in ONE device
  while_loop (the csgraph pattern: every pixel starts as its own
  label, each round takes the component-wise min over the structure
  neighborhood), then one host renumber pass for scipy's consecutive
  1..n labels.  Returns ``(labels, num_features)``."""
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  st = (generate_binary_structure(nd, 1) if structure is None
        else np.asarray(sp.lazify(structure).glom()).astype(bool))
  _, offs = _fp_offsets(st, 0, False)
  n_tot = int(np.prod(X.shape))

  def kern(xx):
    import jax
    import jax.numpy as jnp
    fg = xx != 0
    init = jnp.where(
        fg, jnp.arange(n_tot, dtype=jnp.int32).reshape(xx.shape),
        jnp.int32(n_tot))

    def body(c):
      cur, _ = c
      stack = _stack_windows(cur, offs, "constant",
                             {"constant_values": n_tot})
      nxt = jnp.where(fg, jnp.minimum(jnp.min(stack, axis=0), cur),
                      jnp.int32(n_tot))
      return nxt, jnp.any(nxt != cur)

    out, _ = jax.lax.while_loop(lambda c: c[1], body,
                                (init, jnp.asarray(True)))
    return jnp.where(fg, out, -1)

  raw = np.asarray(sp.map([X], kern).evaluate().glom())
  uniq = np.unique(raw[raw >= 0])
  lut = np.zeros(n_tot + 1, dtype=np.int32)
  lut[uniq] = np.arange(1, uniq.size + 1, dtype=np.int32)
  labels = np.where(raw >= 0, lut[np.maximum(raw, 0)], 0)
  return labels, int(uniq.size)


def _index_arr(index, labels):
  if index is None:
    return None, False
  idx = np.atleast_1d(np.asarray(index, dtype=np.int32))
  return idx, np.isscalar(index) or np.ndim(index) == 0


def _label_sums(input, labels, idx):
  """Per-label sums via ONE one-hot matmul (flattened input @ one-hot
  membership) — the matmul segment-sum idiom."""
  X = sp.lazify(input)
  L = sp.lazify(labels)

  def kern(xx, ll):
    import jax.numpy as jnp
    dt = jnp.result_type(xx.dtype, jnp.float32)
    lf = ll.reshape(-1)
    oh = (lf[:, None] ==
          jnp.asarray(idx, jnp.int32)[None, :]).astype(dt)
    # creation exprs (ones_like counts) may fold to broadcastable
    # scalars — normalize to the labels grid
    xf = jnp.broadcast_to(xx.astype(dt), ll.shape).reshape(-1)
    return xf @ oh

  return sp.map([X, L], kern)


def sum_labels(input, labels=None, index=None):
  """Per-label sums — one one-hot matmul; no labels = plain sum."""
  X = sp.lazify(input)
  if labels is None:
    return float(np.asarray(sp.sum(X).glom()))
  if index is None:
    return float(np.asarray(sp.sum(
        sp.where(sp.lazify(labels) > 0, X, sp.zeros_like(X))).glom()))
  idx, scalar = _index_arr(index, labels)
  out = np.asarray(_label_sums(X, labels, idx).evaluate().glom())
  return float(out[0]) if scalar else out


sum = sum_labels  # scipy alias (shadows builtins.sum INSIDE this module)


def mean(input, labels=None, index=None):
  X = sp.lazify(input)
  if labels is None:
    return float(np.asarray(sp.mean(X).glom()))
  if index is None:
    m = sp.lazify(labels) > 0
    tot = float(np.asarray(sp.sum(sp.where(m, X, sp.zeros_like(X)))
                           .glom()))
    cnt = float(np.asarray(sp.sum(m.astype(np.float64)).glom()))
    return tot / max(cnt, 1.0)
  idx, scalar = _index_arr(index, labels)
  sums = np.asarray(_label_sums(X, labels, idx).evaluate().glom())
  cnts = np.asarray(_label_sums(sp.ones_like(X), labels, idx)
                    .evaluate().glom())
  out = sums / np.maximum(cnts, 1.0)
  return float(out[0]) if scalar else out


def variance(input, labels=None, index=None):
  X = sp.lazify(input)
  if labels is None:
    return float(np.asarray(sp.var(X).glom()))
  if index is None:
    import scipy.ndimage as ndi
    return ndi.variance(np.asarray(X.glom()),
                        np.asarray(sp.lazify(labels).glom()))
  idx, scalar = _index_arr(index, labels)
  sums = np.asarray(_label_sums(X, labels, idx).evaluate().glom())
  sq = np.asarray(_label_sums(X * X, labels, idx).evaluate().glom())
  cnts = np.asarray(_label_sums(sp.ones_like(X), labels, idx)
                    .evaluate().glom())
  cnts = np.maximum(cnts, 1.0)
  mu = sums / cnts
  out = sq / cnts - mu * mu
  return float(out[0]) if scalar else out


def standard_deviation(input, labels=None, index=None):
  v = variance(input, labels, index)
  return np.sqrt(v)


def _label_extreme(input, labels, index, is_min: bool):
  X = sp.lazify(input)
  L = sp.lazify(labels)
  idx, scalar = _index_arr(index, labels)

  def kern(xx, ll):
    import jax.numpy as jnp
    dt = jnp.result_type(xx.dtype, jnp.float32)
    fill = jnp.asarray(np.inf if is_min else -np.inf, dt)
    memb = (ll.reshape(-1)[None, :] ==
            jnp.asarray(idx, jnp.int32)[:, None])
    xf = jnp.broadcast_to(xx.astype(dt), ll.shape).reshape(-1)
    vals = jnp.where(memb, xf[None, :], fill)
    return jnp.min(vals, axis=1) if is_min else jnp.max(vals, axis=1)

  out = np.asarray(sp.map([X, L], kern).evaluate().glom())
  return (float(out[0]) if scalar else out), idx, scalar


def minimum(input, labels=None, index=None):
  if labels is None:
    return float(np.asarray(sp.min(sp.lazify(input)).glom()))
  if index is None:
    index = 1
  return _label_extreme(input, labels, index, True)[0]


def maximum(input, labels=None, index=None):
  if labels is None:
    return float(np.asarray(sp.max(sp.lazify(input)).glom()))
  if index is None:
    index = 1
  return _label_extreme(input, labels, index, False)[0]


def _label_argpos(input, labels, index, is_min: bool):
  X = sp.lazify(input)
  L = sp.lazify(labels)
  idx, scalar = _index_arr(index if index is not None else 1, labels)
  shape = X.shape

  def kern(xx, ll):
    import jax.numpy as jnp
    dt = jnp.result_type(xx.dtype, jnp.float32)
    fill = jnp.asarray(np.inf if is_min else -np.inf, dt)
    memb = (ll.reshape(-1)[None, :] ==
            jnp.asarray(idx, jnp.int32)[:, None])
    xf = jnp.broadcast_to(xx.astype(dt), ll.shape).reshape(-1)
    vals = jnp.where(memb, xf[None, :], fill)
    return (jnp.argmin(vals, axis=1) if is_min
            else jnp.argmax(vals, axis=1)).astype(jnp.int32)

  flat = np.asarray(sp.map([X, L], kern).evaluate().glom())
  pos = [tuple(int(v) for v in np.unravel_index(p, shape)) for p in flat]
  return pos[0] if scalar else pos


def minimum_position(input, labels=None, index=None):
  if labels is None:
    X = sp.lazify(input)
    flat = int(np.asarray(sp.argmin(X).glom()))
    return tuple(int(v) for v in np.unravel_index(flat, X.shape))
  return _label_argpos(input, labels, index, True)


def maximum_position(input, labels=None, index=None):
  if labels is None:
    X = sp.lazify(input)
    flat = int(np.asarray(sp.argmax(X).glom()))
    return tuple(int(v) for v in np.unravel_index(flat, X.shape))
  return _label_argpos(input, labels, index, False)


def extrema(input, labels=None, index=None):
  """(min, max, min_position, max_position) — the device reductions
  above composed."""
  return (minimum(input, labels, index), maximum(input, labels, index),
          minimum_position(input, labels, index),
          maximum_position(input, labels, index))


def center_of_mass(input, labels=None, index=None):
  X = sp.lazify(input)
  shape = X.shape
  grids = np.meshgrid(*[np.arange(s, dtype=float) for s in shape],
                      indexing="ij")
  if labels is None:
    tot = float(np.asarray(sp.sum(X).glom()))
    return tuple(float(np.asarray(sp.sum(X * sp.Val(g)).glom())) / tot
                 for g in grids)
  idx, scalar = _index_arr(index if index is not None else 1, labels)
  mass = np.asarray(_label_sums(X, labels, idx).evaluate().glom())
  coords = [np.asarray(_label_sums(X * sp.Val(g), labels, idx)
                       .evaluate().glom()) for g in grids]
  out = [tuple(c[i] / mass[i] for c in coords)
         for i in range(idx.size)]
  return out[0] if scalar else out


def histogram(input, min, max, bins, labels=None, index=None):
  """Per-label histograms — host composition over the device-masked
  values (scipy returns object arrays here)."""
  import scipy.ndimage as ndi
  a = np.asarray(sp.lazify(input).glom())
  lb = None if labels is None else np.asarray(sp.lazify(labels).glom())
  return ndi.histogram(a, min, max, bins, lb, index)


def median(input, labels=None, index=None):
  return _host_nd("median", "variable-size per-label sorts",
                  input, labels=None if labels is None else
                  np.asarray(sp.lazify(labels).glom()), index=index)


def labeled_comprehension(input, labels, index, func, out_dtype,
                          default, pass_positions: bool = False):
  return _host_nd("labeled_comprehension", "per-label python callable",
                  input, labels, index, func, out_dtype, default,
                  pass_positions)


def find_objects(input, max_label: int = 0):
  return _host_nd("find_objects", "variable-length slice list",
                  input, max_label)


def value_indices(arr, *, ignore_value=None):
  return _host_nd("value_indices", "variable-length index dict", arr,
                  ignore_value=ignore_value)


# ---------------------------------------------------------------------
# fourier filters (exact spectral multipliers, applied lazily)
# ---------------------------------------------------------------------

def _fourier_mult(name, input, args, n, axis):
  """scipy's fourier_* multiply the (already-transformed) input by a
  shape-only multiplier — recover it EXACTLY by running scipy on a
  ones array (host, one pass), then multiply lazily on device."""
  import scipy.ndimage as ndi
  X = sp.lazify(input)
  ones = np.ones(X.shape,
                 complex if np.issubdtype(np.dtype(X.aval().dtype),
                                          np.complexfloating) else float)
  m = getattr(ndi, name)(ones, *args, n=n, axis=axis)
  return X * sp.Val(np.asarray(m))


def fourier_gaussian(input, sigma, n: int = -1, axis: int = -1,
                     output=None):
  del output
  return _fourier_mult("fourier_gaussian", input, (sigma,), n, axis)


def fourier_uniform(input, size, n: int = -1, axis: int = -1,
                    output=None):
  del output
  return _fourier_mult("fourier_uniform", input, (size,), n, axis)


def fourier_ellipsoid(input, size, n: int = -1, axis: int = -1,
                      output=None):
  del output
  return _fourier_mult("fourier_ellipsoid", input, (size,), n, axis)


def fourier_shift(input, shift, n: int = -1, axis: int = -1,
                  output=None):
  del output
  return _fourier_mult("fourier_shift", input, (shift,), n, axis)


# ---------------------------------------------------------------------
# interpolation: device gathers for order <= 1, host splines above
# ---------------------------------------------------------------------

_JAX_COORD_MODES = {"constant", "nearest", "mirror", "reflect", "wrap"}


def map_coordinates(input, coordinates, output=None, order: int = 3,
                    mode: str = "constant", cval: float = 0.0,
                    prefilter: bool = True):
  """Coordinate-gather interpolation — ON DEVICE for order <= 1
  (jax.scipy.ndimage); spline orders route host with a notice."""
  del output, prefilter
  if order > 1 or mode not in _JAX_COORD_MODES:
    return _host_nd("map_coordinates",
                    f"spline order {order} prefiltering",
                    input, np.asarray(sp.lazify(coordinates).glom()),
                    order=order, mode=mode, cval=cval)
  X = sp.lazify(input)
  C = sp.lazify(coordinates)

  def kern(xx, cc):
    import jax.numpy as jnp
    import jax.scipy.ndimage as jndi
    out = jndi.map_coordinates(xx, list(cc), order=order, mode=mode,
                               cval=cval)
    if mode == "constant":
      # scipy fills cval for ANY coordinate outside [0, n-1]; jax
      # blends partially-outside points with the edge sample
      valid = jnp.ones(out.shape, bool)
      for d in range(xx.ndim):
        valid &= (cc[d] >= 0) & (cc[d] <= xx.shape[d] - 1)
      out = jnp.where(valid, out, jnp.asarray(cval, out.dtype))
    return out

  return sp.map([X, C], kern)


def _affine_grid(shape_out, matrix, offset, nd):
  grids = np.meshgrid(*[np.arange(s, dtype=float) for s in shape_out],
                      indexing="ij")
  pts = np.stack([g.ravel() for g in grids])        # (nd, N)
  src = matrix @ pts + np.asarray(offset, float)[:, None]
  return src.reshape((nd,) + tuple(shape_out))


def affine_transform(input, matrix, offset=0.0, output_shape=None,
                     output=None, order: int = 3,
                     mode: str = "constant", cval: float = 0.0,
                     prefilter: bool = True):
  """Affine warp — host grid build + device gather for order <= 1."""
  X = sp.lazify(input)
  nd = len(X.shape)
  m = np.asarray(sp.lazify(matrix).glom(), dtype=float)
  off = np.broadcast_to(np.asarray(offset, float), (nd,))
  if m.ndim == 1:
    m = np.diag(m)
  elif m.ndim == 2 and m.shape == (nd + 1, nd + 1):
    off = m[:nd, nd]
    m = m[:nd, :nd]
  shape_out = tuple(output_shape) if output_shape is not None \
      else X.shape
  if order > 1 or mode not in _JAX_COORD_MODES:
    return _host_nd("affine_transform",
                    f"spline order {order} prefiltering", X, m,
                    offset=off, output_shape=shape_out, order=order,
                    mode=mode, cval=cval, prefilter=prefilter)
  coords = _affine_grid(shape_out, m, off, nd)
  return map_coordinates(X, coords, output, order, mode, cval)


def shift(input, shift, output=None, order: int = 3,
          mode: str = "constant", cval: float = 0.0,
          prefilter: bool = True):
  X = sp.lazify(input)
  nd = len(X.shape)
  sh = np.broadcast_to(np.asarray(shift, float), (nd,))
  return affine_transform(X, np.eye(nd), offset=-sh, output=output,
                          order=order, mode=mode, cval=cval,
                          prefilter=prefilter)


def zoom(input, zoom, output=None, order: int = 3,
         mode: str = "constant", cval: float = 0.0,
         prefilter: bool = True, *, grid_mode: bool = False):
  X = sp.lazify(input)
  nd = len(X.shape)
  z = np.broadcast_to(np.asarray(zoom, float), (nd,))
  shape_out = tuple(int(round(s * zz)) for s, zz in zip(X.shape, z))
  if grid_mode:
    return _host_nd("zoom", "grid_mode variant", X, z, order=order,
                    mode=mode, cval=cval, prefilter=prefilter,
                    grid_mode=True)
  if order > 1 or mode not in _JAX_COORD_MODES:
    return _host_nd("zoom", f"spline order {order} prefiltering", X, z,
                    order=order, mode=mode, cval=cval,
                    prefilter=prefilter)
  # scipy's endpoint-preserving scale: (in_size-1)/(out_size-1).  Build
  # the grid as (i*(s-1))/(o-1) — the numerator product of exact ints
  # keeps the LAST output point at exactly s-1; i*((s-1)/(o-1)) rounds
  # a hair past it and the exact constant-mode bounds mask then filled
  # the whole edge row with cval (caught on the 192->96 chip stage).
  axes_1d = [np.arange(o, dtype=float) * (s - 1) / max(o - 1, 1)
             for s, o in zip(X.shape, shape_out)]
  grids = np.meshgrid(*axes_1d, indexing="ij")
  coords = np.stack(grids)
  return map_coordinates(X, coords, output, order, mode, cval)


def rotate(input, angle: float, axes=(1, 0), reshape: bool = True,
           output=None, order: int = 3, mode: str = "constant",
           cval: float = 0.0, prefilter: bool = True):
  """Plane rotation — host rotation-matrix/grid build + the device
  gather (order <= 1)."""
  X = sp.lazify(input)
  nd = len(X.shape)
  ax0, ax1 = (a % nd for a in axes)
  if nd != 2 or {ax0, ax1} != {0, 1}:
    return _host_nd("rotate", "N-D plane extraction", X, angle,
                    axes=axes, reshape=reshape, order=order, mode=mode,
                    cval=cval, prefilter=prefilter)
  a = np.deg2rad(angle)
  R = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
  in_shape = np.asarray(X.shape, float)
  if reshape:
    corners = np.array([[0, 0], [0, in_shape[1] - 1],
                        [in_shape[0] - 1, 0],
                        [in_shape[0] - 1, in_shape[1] - 1]]).T
    rot = np.linalg.inv(R) @ corners
    out_shape = tuple(int(np.ceil(v.max() - v.min() + 0.5))
                      for v in rot)
  else:
    out_shape = X.shape
  c_in = (in_shape - 1) / 2.0
  c_out = (np.asarray(out_shape, float) - 1) / 2.0
  offset = c_in - R @ c_out
  return affine_transform(X, R, offset=offset, output_shape=out_shape,
                          output=output, order=order, mode=mode,
                          cval=cval, prefilter=prefilter)


def geometric_transform(input, mapping, output_shape=None, output=None,
                        order: int = 3, mode: str = "constant",
                        cval: float = 0.0, prefilter: bool = True,
                        extra_arguments=(), extra_keywords=None):
  return _host_nd("geometric_transform", "per-point python mapping",
                  input, mapping, output_shape=output_shape,
                  order=order, mode=mode, cval=cval,
                  prefilter=prefilter, extra_arguments=extra_arguments,
                  extra_keywords=extra_keywords or {})


def spline_filter(input, order: int = 3, output=np.float64,
                  mode: str = "mirror"):
  return _host_nd("spline_filter", "sequential IIR prefilter recursion",
                  input, order, output=output, mode=mode)


def spline_filter1d(input, order: int = 3, axis: int = -1,
                    output=np.float64, mode: str = "mirror"):
  return _host_nd("spline_filter1d",
                  "sequential IIR prefilter recursion", input, order,
                  axis=axis, output=output, mode=mode)


# ---------------------------------------------------------------------
# host boundaries
# ---------------------------------------------------------------------

def distance_transform_edt(input, sampling=None,
                           return_distances: bool = True,
                           return_indices: bool = False,
                           distances=None, indices=None):
  return _host_nd("distance_transform_edt",
                  "Felzenszwalb-Huttenlocher sequential passes", input,
                  sampling=sampling, return_distances=return_distances,
                  return_indices=return_indices, distances=distances,
                  indices=indices)


def distance_transform_cdt(input, metric="chessboard",
                           return_distances: bool = True,
                           return_indices: bool = False,
                           distances=None, indices=None):
  return _host_nd("distance_transform_cdt", "sequential chamfer passes",
                  input, metric=metric,
                  return_distances=return_distances,
                  return_indices=return_indices, distances=distances,
                  indices=indices)


def distance_transform_bf(input, metric="euclidean", sampling=None,
                          return_distances: bool = True,
                          return_indices: bool = False, distances=None,
                          indices=None):
  return _host_nd("distance_transform_bf", "brute-force host reference",
                  input, metric=metric, sampling=sampling,
                  return_distances=return_distances,
                  return_indices=return_indices, distances=distances,
                  indices=indices)


def watershed_ift(input, markers, structure=None, output=None):
  del output
  return _host_nd("watershed_ift", "priority-queue flooding", input,
                  markers, structure=structure)


def generic_filter(input, function, size=None, footprint=None,
                   output=None, mode: str = "reflect", cval: float = 0.0,
                   origin=0, extra_arguments=(), extra_keywords=None):
  """Per-window python callable — host boundary (for vectorized
  callables use :func:`vectorized_filter`, which runs on device)."""
  del output
  return _host_nd("generic_filter", "per-window python callable",
                  input, function, size=size, footprint=footprint,
                  mode=mode, cval=cval, origin=origin,
                  extra_arguments=extra_arguments,
                  extra_keywords=extra_keywords or {})


def generic_filter1d(input, function, filter_size, axis: int = -1,
                     output=None, mode: str = "reflect",
                     cval: float = 0.0, origin=0, extra_arguments=(),
                     extra_keywords=None):
  del output
  return _host_nd("generic_filter1d", "per-line python callable",
                  input, function, filter_size, axis=axis, mode=mode,
                  cval=cval, origin=origin,
                  extra_arguments=extra_arguments,
                  extra_keywords=extra_keywords or {})
