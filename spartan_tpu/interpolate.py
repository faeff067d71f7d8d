"""``sp.interpolate`` — the scipy.interpolate surface, on device.

Piecewise-polynomial evaluation is the canonical gather+FLOP device
workload: ``searchsorted`` interval lookup -> coefficient gather ->
static-degree Horner (power basis) or de Casteljau (Bernstein), all
inside one ``sp.map`` kernel, so a million-point spline evaluation is
one fused memory pass.  Construction is device too where the algorithm
is parallel: ``CubicSpline`` solves its tridiagonal system with a
Thomas ``lax.scan`` (the lfilter IIR-recurrence pattern; periodic via
Sherman-Morrison on two scans), Pchip/Akima derivative estimates are
branch-free ``where`` selects, and B-spline interpolation/LSQ fitting
assemble their collocation/design matrices on device and solve with
matmuls.  ``RBFInterpolator`` is a pure matmul workload (pairwise kernel
matrices + dense solve).  Evaluation of host-fitted splines (FITPACK
``splrep``/``UnivariateSpline``) runs on device through the same de
Boor kernel, so only the one-shot fit leaves the chip.

Host boundary (``_HOST_NAMES``): FITPACK smoothing fits (sequential
knot placement), Qhull-based N-D scattered interpolation
(LinearNDInterpolator / CloughTocher2D — simplex walks), and the
small poly1d-returning utilities (lagrange/pade) — the
once-per-process-notice convention.

Reference parity: the spartan reference has no interpolate module;
SURVEY.md §2.5 'broader demo set' motivates the beyond-parity scipy
surfaces.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

import spartan_tpu as sp
from spartan_tpu.expr.base import Expr
from spartan_tpu.special import _f
from spartan_tpu.util import log_info

_py_callable = callable

_host_noticed = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info("sp.interpolate.%s: sequential fit / computational-geometry "
           "algorithm — runs EAGERLY on the host (scipy), the "
           "sp.linalg.eig convention.", name)


def _np(a):
  """Concretize a (possibly lazy) operand to a host numpy array."""
  if isinstance(a, Expr):
    return np.asarray(sp.lazify(a).glom())
  return np.asarray(a)


def _asfloat_np(a):
  a = _np(a)
  if a.dtype.kind in "biu":
    a = a.astype(np.float64)
  return a


# =====================================================================
# device kernels (concrete jnp arrays)
# =====================================================================

def _interval_index(xb, xq, ascending):
  """Index i of the piece containing each query (extrapolation pieces
  clipped to the first/last interval — scipy's convention)."""
  m = xb.shape[0] - 1
  if ascending:
    i = jnp.searchsorted(xb, xq, side="right") - 1
  else:
    i = m - jnp.searchsorted(xb[::-1], xq, side="left")
  return jnp.clip(i, 0, m - 1)


def _falling(k, nu):
  """Falling factorial k*(k-1)*...*(k-nu+1) (python ints)."""
  out = 1
  for j in range(nu):
    out *= (k - j)
  return out


def _ppoly_eval(c, xb, xq, nu, extrapolate, ascending):
  """Evaluate sum_j c[j,i] * (xq - xb[i])**(k-j), nu-th derivative.

  c: (k+1, m, *trailing); xb: (m+1,); xq: (nq,).  Static nu/extrapolate.
  Returns (nq, *trailing)."""
  c = _f(c)
  xq = _f(xq)
  k = c.shape[0] - 1
  lo = xb[0] if ascending else xb[-1]
  hi = xb[-1] if ascending else xb[0]
  if extrapolate == "periodic":
    period = hi - lo
    xq = lo + jnp.mod(xq - lo, period)
  i = _interval_index(xb, xq, ascending)
  t = xq - xb[i]
  # Horner over the first k+1-nu coefficients with falling-factorial
  # derivative weights: coefficient c[j] contributes
  # c[j] * (k-j)(k-j-1)...(k-j-nu+1) * t**(k-j-nu).
  tb = t.reshape(t.shape + (1,) * (c.ndim - 2))
  if nu > k:
    res = jnp.zeros(xq.shape + c.shape[2:], dtype=c.dtype)
  else:
    res = c[0, i] * _falling(k, nu)
    for j in range(1, k + 1 - nu):
      res = res * tb + c[j, i] * _falling(k - j, nu)
  if extrapolate is False:
    inside = (xq >= jnp.minimum(lo, hi)) & (xq <= jnp.maximum(lo, hi))
    res = jnp.where(inside.reshape(tb.shape[:1] + (1,) * (c.ndim - 2)),
                    res, jnp.nan)
  return res


def _bpoly_eval(c, xb, xq, nu, extrapolate, ascending):
  """Bernstein-basis piecewise eval (de Casteljau on the gathered
  control points); nu-th derivative via the forward-difference coef
  transform applied in-kernel (static nu)."""
  c = _f(c)
  xq = _f(xq)
  k = c.shape[0] - 1
  lo = xb[0] if ascending else xb[-1]
  hi = xb[-1] if ascending else xb[0]
  if extrapolate == "periodic":
    xq = lo + jnp.mod(xq - lo, hi - lo)
  i = _interval_index(xb, xq, ascending)
  h = xb[i + 1] - xb[i]
  s = (xq - xb[i]) / h
  # gather control points: (k+1, nq, *trailing)
  pts = c[:, i]
  hb = h.reshape(h.shape + (1,) * (c.ndim - 2))
  sb = s.reshape(h.shape + (1,) * (c.ndim - 2))
  # derivative: d/dx sum c_a b_{a,k}(s) = (k/h) sum (c_{a+1}-c_a) b_{a,k-1}
  deg = k
  for _ in range(nu):
    if deg == 0:
      return jnp.zeros(xq.shape + c.shape[2:], dtype=c.dtype)
    pts = (pts[1:] - pts[:-1]) * (deg / hb)
    deg -= 1
  # de Casteljau
  while pts.shape[0] > 1:
    pts = pts[:-1] * (1.0 - sb) + pts[1:] * sb
  res = pts[0]
  if extrapolate is False:
    inside = (xq >= jnp.minimum(lo, hi)) & (xq <= jnp.maximum(lo, hi))
    res = jnp.where(inside.reshape(sb.shape), res, jnp.nan)
  return res


def _thomas(dl, d, du, b):
  """Tridiagonal solve via two lax.scan sweeps (the lfilter pattern).

  dl/d/du: (n,) sub/main/super diagonals (dl[0] and du[-1] ignored);
  b: (n, *trailing).  Differentiable; O(n) sequential but each step is
  a tiny fused elementwise op — the honest device answer for spline systems."""
  d = _f(d)
  b = _f(b)
  dl = _f(dl)
  du = _f(du)
  bt = b.reshape(b.shape[0], -1)

  def fwd(carry, inp):
    cp_prev, dp_prev = carry
    dli, di, dui, bi = inp
    denom = di - dli * cp_prev
    cp = dui / denom
    dp = (bi - dli * dp_prev) / denom
    return (cp, dp), (cp, dp)

  zero = jnp.zeros((bt.shape[1],), bt.dtype)
  (_, _), (cps, dps) = lax.scan(
      fwd, (jnp.zeros((), d.dtype), zero), (dl, d, du, bt))

  def bwd(x_next, inp):
    cp, dp = inp
    x = dp - cp[None] * x_next if cp.ndim == 0 else dp - cp * x_next
    return x, x

  _, xs = lax.scan(bwd, zero, (cps, dps), reverse=True)
  return xs.reshape(b.shape)


def _cyclic_thomas(dl, d, du, b, corner_ul, corner_lr):
  """Cyclic tridiagonal solve (corners corner_ul = A[0,n-1],
  corner_lr = A[n-1,0]) via Sherman-Morrison on two Thomas solves."""
  d = _f(d)
  b = _f(b)
  n = d.shape[0]
  gamma = -d[0]
  dmod = d.at[0].add(-gamma).at[n - 1].add(
      -corner_lr * corner_ul / gamma)
  u = jnp.zeros((n,), d.dtype).at[0].set(gamma).at[n - 1].set(corner_lr)
  y = _thomas(dl, dmod, du, b)
  q = _thomas(dl, dmod, du, u[:, None] if b.ndim > 1 else u)
  if b.ndim > 1:
    q = q.reshape(n, *([1] * (b.ndim - 1)))
    vy = y[0] + (corner_ul / gamma) * y[n - 1]
    vq = q[0] + (corner_ul / gamma) * q[n - 1]
  else:
    vy = y[0] + (corner_ul / gamma) * y[n - 1]
    vq = q[0] + (corner_ul / gamma) * q[n - 1]
  return y - q * (vy / (1.0 + vq))


def _hermite_power_coefs(x, y, s):
  """Power-basis coefs (4, m, *trailing) of the cubic Hermite
  interpolant with knot values y and knot derivatives s."""
  h = jnp.diff(x)
  hb = h.reshape(h.shape + (1,) * (y.ndim - 1))
  m = jnp.diff(y, axis=0) / hb
  c3 = (s[:-1] + s[1:] - 2.0 * m) / (hb * hb)
  c2 = (3.0 * m - 2.0 * s[:-1] - s[1:]) / hb
  return jnp.stack([c3, c2, s[:-1], y[:-1]], axis=0)


def _pchip_derivs(x, y):
  """Fritsch–Carlson monotone derivative estimates (scipy pchip)."""
  h = jnp.diff(x)
  hb = h.reshape(h.shape + (1,) * (y.ndim - 1))
  mk = jnp.diff(y, axis=0) / hb
  hk0, hk1 = hb[:-1], hb[1:]
  m0, m1 = mk[:-1], mk[1:]
  w1 = 2.0 * hk1 + hk0
  w2 = hk1 + 2.0 * hk0
  # weighted harmonic mean where slopes share a sign, else 0
  smk = jnp.sign(m0) * jnp.sign(m1)
  cond = (smk > 0)
  denom = jnp.where(cond, w1 / jnp.where(m0 == 0, 1.0, m0)
                    + w2 / jnp.where(m1 == 0, 1.0, m1), 1.0)
  interior = jnp.where(cond, (w1 + w2) / denom, 0.0)

  def edge(h0, h1, mA, mB):
    d = ((2.0 * h0 + h1) * mA - h0 * mB) / (h0 + h1)
    d = jnp.where(jnp.sign(d) != jnp.sign(mA), 0.0, d)
    bad = (jnp.sign(mA) != jnp.sign(mB)) & (jnp.abs(d) > 3.0 * jnp.abs(mA))
    return jnp.where(bad, 3.0 * mA, d)

  left = edge(hb[0], hb[1], mk[0], mk[1])[None]
  right = edge(hb[-1], hb[-2], mk[-1], mk[-2])[None]
  return jnp.concatenate([left, interior, right], axis=0)


def _akima_derivs(x, y, makima):
  """Akima (or modified-Akima) derivative estimates."""
  h = jnp.diff(x)
  hb = h.reshape(h.shape + (1,) * (y.ndim - 1))
  mk = jnp.diff(y, axis=0) / hb
  # extend slopes by quadratic extrapolation (scipy's ghost slopes)
  mL1 = 2.0 * mk[0] - mk[1]
  mL2 = 2.0 * mL1 - mk[0]
  mR1 = 2.0 * mk[-1] - mk[-2]
  mR2 = 2.0 * mR1 - mk[-1]
  me = jnp.concatenate([mL2[None], mL1[None], mk, mR1[None], mR2[None]],
                       axis=0)
  # derivative at knot i uses slopes me[i..i+3] (me index offset 2)
  dm = jnp.abs(jnp.diff(me, axis=0))
  if makima:
    pm = jnp.abs(me[1:] + me[:-1]) * 0.5
    w1 = dm[2:] + pm[2:]      # |m_{i+1}-m_i| + |m_{i+1}+m_i|/2
    w2 = dm[:-2] + pm[:-2]    # |m_{i-1}-m_{i-2}| + ...
  else:
    w1 = dm[2:]
    w2 = dm[:-2]
  denom = w1 + w2
  safe = jnp.where(denom == 0, 1.0, denom)
  t = (w1 * me[1:-2] + w2 * me[2:-1]) / safe
  # where both weights vanish scipy yields (m_{i-1}+m_i)/2 for makima
  # (w includes pm) and 0.5*(m-+m+) Akima convention as well
  fallback = 0.5 * (me[1:-2] + me[2:-1])
  return jnp.where(denom == 0, fallback, t)


def _natural_rows():
  pass  # documentation anchor (rows built inline in _cubic_system)


def _cubic_spline_derivs(x, y, bc_type, bc_vals):
  """Knot derivatives s for a C2 cubic spline via the tridiagonal
  system (Thomas lax.scan).  bc_type: ('not-a-knot'|'natural'|
  'clamped'|'periodic'| (order, ) parametrized ends via bc_vals)."""
  n = x.shape[0]
  h = jnp.diff(x)
  hb = h.reshape(h.shape + (1,) * (y.ndim - 1))
  mk = jnp.diff(y, axis=0) / hb
  trailing = y.shape[1:]

  if bc_type == "periodic":
    # unknowns s_0..s_{n-2}; row i (cyclic indices, h_{-1} = h_{n-2}):
    #   h_i s_{i-1} + 2(h_{i-1}+h_i) s_i + h_{i-1} s_{i+1}
    #     = 3(h_i m_{i-1} + h_{i-1} m_i)
    hw = jnp.concatenate([h[-1:], h])  # hw[i] = h_{i-1}
    d = 2.0 * (hw[:-1] + h)
    mw = jnp.concatenate([mk[-1:], mk], axis=0)
    rhs = 3.0 * (h.reshape(h.shape + (1,) * (y.ndim - 1)) * mw[:-1]
                 + hw[:-1].reshape(h.shape + (1,) * (y.ndim - 1)) * mk)
    nu = n - 1  # number of unknowns
    if nu <= 3:
      # corners overlap the band — build the tiny dense cyclic matrix
      A = jnp.zeros((nu, nu), d.dtype)
      for i in range(nu):
        A = A.at[i, (i - 1) % nu].add(h[i])
        A = A.at[i, i].add(d[i])
        A = A.at[i, (i + 1) % nu].add(hw[i])
      s_inner = jnp.linalg.solve(A, rhs.reshape(nu, -1))
    else:
      sub = jnp.concatenate([jnp.zeros((1,), h.dtype), h[1:]])
      sup = jnp.concatenate([hw[:-2], jnp.zeros((1,), h.dtype)])
      # corners: A[0, nu-1] = h_0 (row 0 couples s_{-1} = s_{n-2});
      # A[nu-1, 0] = hw[nu-1] = h_{n-3}'s successor wrap = h_{i-1}|i=nu-1
      s_inner = _cyclic_thomas(sub, d, sup, rhs.reshape(nu, -1),
                               corner_ul=h[0], corner_lr=hw[nu - 1])
    s_inner = s_inner.reshape((nu,) + trailing)
    return jnp.concatenate([s_inner, s_inner[:1]], axis=0)

  # rows 1..n-2 are the standard interior equations; end rows by bc
  dl = jnp.zeros((n,), x.dtype)
  d = jnp.zeros((n,), x.dtype)
  du = jnp.zeros((n,), x.dtype)
  rhs = jnp.zeros((n,) + trailing, y.dtype)
  if n > 2:
    dl = dl.at[1:-1].set(h[1:])
    d = d.at[1:-1].set(2.0 * (h[:-1] + h[1:]))
    du = du.at[1:-1].set(h[:-1])
    interior = 3.0 * (
        h[1:].reshape((-1,) + (1,) * (y.ndim - 1)) * mk[:-1]
        + h[:-1].reshape((-1,) + (1,) * (y.ndim - 1)) * mk[1:])
    rhs = rhs.at[1:-1].set(interior)

  def end_rows(side):
    kind, val = (bc_type[0], bc_vals[0]) if side == 0 else \
        (bc_type[1], bc_vals[1])
    if kind == "clamped":          # s = val
      return 1.0, 0.0, jnp.broadcast_to(_f(jnp.asarray(val)), trailing)
    if kind == "natural":          # y'' = 0
      if side == 0:
        return 2.0, 1.0, 3.0 * mk[0]
      return 2.0, 1.0, 3.0 * mk[-1]
    if kind == "second":           # y'' = val
      v = jnp.broadcast_to(_f(jnp.asarray(val)), trailing)
      if side == 0:
        return 2.0, 1.0, 3.0 * mk[0] - 0.5 * v * h[0]
      return 2.0, 1.0, 3.0 * mk[-1] + 0.5 * v * h[-1]
    if kind == "not-a-knot":
      # scipy's reduced first/last row (third-derivative continuity
      # eliminated against the adjacent interior equation)
      if side == 0:
        dd = x[2] - x[0]
        diag, off = h[1], dd
        b = ((h[0] + 2.0 * dd) * h[1] * mk[0] + h[0] * h[0] * mk[1]) / dd
        return diag, off, b
      dd = x[-1] - x[-3]
      diag, off = h[-2], dd
      b = (h[-1] * h[-1] * mk[-2]
           + (2.0 * dd + h[-1]) * h[-2] * mk[-1]) / dd
      return diag, off, b
    raise ValueError(f"unknown bc kind {kind!r}")

  d0, u0, b0 = end_rows(0)
  dn, ln_, bn = end_rows(1)
  d = d.at[0].set(d0).at[-1].set(dn)
  du = du.at[0].set(u0)
  dl = dl.at[-1].set(ln_)
  rhs = rhs.at[0].set(b0).at[-1].set(bn)
  return _thomas(dl, d, du, rhs.reshape(n, -1)).reshape((n,) + trailing)


# =====================================================================
# PPoly / BPoly
# =====================================================================

class PPoly:
  """Piecewise power-basis polynomial with lazy device evaluation.

  ``c`` (k+1, m, *trailing) and ``x`` (m+1) are stored as lazy Exprs;
  ``__call__`` lowers to searchsorted + coefficient gather + Horner in
  one fused ``sp.map`` kernel (scipy.interpolate.PPoly semantics)."""

  _eval_kern = staticmethod(_ppoly_eval)

  def __init__(self, c, x, extrapolate=None, axis=0):
    if axis != 0:
      raise NotImplementedError("PPoly axis != 0 (move axes on y "
                                "before construction)")
    cx = _np(x) if not isinstance(x, Expr) else None
    self.x = sp.lazify(np.asarray(cx, dtype=np.float64)
                       if cx is not None else x)
    self.c = sp.lazify(c)
    if len(self.x.shape) != 1 or self.x.shape[0] < 2:
      raise ValueError("x must be 1-D with at least 2 breakpoints")
    if len(self.c.shape) < 2 or self.c.shape[1] != self.x.shape[0] - 1:
      raise ValueError(f"c shape {self.c.shape} does not match "
                       f"{self.x.shape[0] - 1} intervals")
    if cx is not None:
      if cx.shape[0] > 1 and cx[1] < cx[0]:
        self._ascending = False
        if not (np.diff(cx) < 0).all():
          raise ValueError("x must be strictly monotonic")
      else:
        self._ascending = True
        if not (np.diff(cx) > 0).all():
          raise ValueError("x must be strictly monotonic")
    else:
      self._ascending = True
    self.extrapolate = True if extrapolate is None else extrapolate

  # -- construction ---------------------------------------------------
  @classmethod
  def construct_fast(cls, c, x, extrapolate=None, axis=0):
    return cls(c, x, extrapolate=extrapolate, axis=axis)

  @classmethod
  def from_spline(cls, tck, extrapolate=None):
    import scipy.interpolate as _si
    _host_notice("PPoly.from_spline")
    if isinstance(tck, _si.BSpline) or isinstance(tck, BSpline):
      t, c, k = (np.asarray(_np(tck.t)), _np(tck.c), int(tck.k))
    else:
      t, c, k = tck
    ref = _si.PPoly.from_spline((np.asarray(t, float),
                                 np.asarray(c, float), int(k)),
                                extrapolate=extrapolate)
    return cls(ref.c, ref.x, extrapolate=ref.extrapolate)

  @classmethod
  def from_bernstein_basis(cls, bp, extrapolate=None):
    # Bernstein -> power basis: static (k+1)x(k+1) transform applied
    # per interval on device, with per-interval h**(-a) scaling.
    k = bp.c.shape[0] - 1
    from math import comb
    M = np.zeros((k + 1, k + 1))
    # b_{a,k}(s) = sum_j C(k,a) C(k-a, j-a) (-1)^{j-a} s^j
    for a in range(k + 1):
      for j in range(a, k + 1):
        M[j, a] = comb(k, a) * comb(k - a, j - a) * (-1) ** (j - a)

    def kern(c, xb):
      c = _f(c)
      h = jnp.diff(xb)
      # power coefs in s: (k+1, m, ...) ascending power j
      cs = jnp.tensordot(jnp.asarray(M, c.dtype), c, axes=(1, 0))
      # s = t/h  ->  coef of t^j is cs[j] / h^j; PPoly stores highest
      # power first
      powers = jnp.arange(k + 1, dtype=c.dtype)
      hp = h[None] ** powers[:, None]
      hp = hp.reshape(hp.shape + (1,) * (c.ndim - 2))
      return (cs / hp)[::-1]

    c_new = sp.map([bp.c, bp.x], kern)
    extra = bp.extrapolate if extrapolate is None else extrapolate
    out = cls.__new__(cls)
    PPoly.__init__(out, c_new, bp.x, extrapolate=extra)
    out._ascending = bp._ascending
    return out

  # -- evaluation -----------------------------------------------------
  def __call__(self, x, nu=0, extrapolate=None):
    extra = self.extrapolate if extrapolate is None else extrapolate
    xq = sp.lazify(x)
    shape = xq.shape
    kern = type(self)._eval_kern
    asc = self._ascending

    def k(c, xb, q):
      res = kern(c, xb, jnp.ravel(_f(q)), nu, extra, asc)
      return res.reshape(shape + res.shape[1:])

    return sp.map([self.c, self.x, xq], k)

  # -- calculus -------------------------------------------------------
  def derivative(self, nu=1):
    if nu < 0:
      return self.antiderivative(-nu)
    k = self.c.shape[0] - 1
    if nu == 0:
      c_new = self.c
    elif nu > k:
      c_new = sp.map([self.c], lambda c: jnp.zeros(
          (1,) + c.shape[1:], _f(c).dtype))
    else:
      def kern(c):
        c = _f(c)
        for _ in range(nu):
          deg = c.shape[0] - 1
          w = jnp.arange(deg, 0, -1, dtype=c.dtype)
          c = c[:-1] * w.reshape((-1,) + (1,) * (c.ndim - 1))
        return c
      c_new = sp.map([self.c], kern)
    out = PPoly.__new__(type(self) if type(self) is PPoly else PPoly)
    PPoly.__init__(out, c_new, self.x,
                   extrapolate=self.extrapolate)
    out._ascending = self._ascending
    return out

  def antiderivative(self, nu=1):
    if nu < 0:
      return self.derivative(-nu)
    c_expr, x_expr = self.c, self.x
    asc = self._ascending

    def kern(c, xb):
      c = _f(c)
      xb = _f(xb)
      h = jnp.diff(xb)
      for _ in range(nu):
        deg = c.shape[0] - 1
        w = jnp.arange(deg + 1, 0, -1, dtype=c.dtype)
        ci = c / w.reshape((-1,) + (1,) * (c.ndim - 1))
        # continuity constants: value of each piece's indefinite at its
        # right edge, excl-cumsummed
        hb = h.reshape((-1,) + (1,) * (c.ndim - 2))
        val = ci[0]
        for j in range(1, ci.shape[0]):
          val = val * hb + ci[j]
        val = val * hb
        consts = jnp.cumsum(val, axis=0)
        consts = jnp.concatenate(
            [jnp.zeros_like(consts[:1]), consts[:-1]], axis=0)
        c = jnp.concatenate([ci, consts[None]], axis=0)
      return c

    c_new = sp.map([c_expr, x_expr], kern)
    out = PPoly.__new__(PPoly)
    extra = self.extrapolate
    if extra == "periodic":
      extra = False  # scipy: antiderivative of periodic is not periodic
    PPoly.__init__(out, c_new, x_expr, extrapolate=extra)
    out._ascending = asc
    return out

  def integrate(self, a, b, extrapolate=None):
    extra = self.extrapolate if extrapolate is None else extrapolate
    F = self.antiderivative()
    if extra == "periodic":
      # scipy: reduce [a,b] to whole periods + remainder inside range
      xs = _np(self.x)
      lo, hi = (xs[0], xs[-1]) if self._ascending else (xs[-1], xs[0])
      period = hi - lo
      sign = 1.0
      if b < a:
        a, b = b, a
        sign = -1.0
      n_per = np.floor((b - a) / period)
      whole = sp.map([F(hi), F(lo)], lambda u, v: (u - v) * n_per)
      aw = lo + np.mod(a - lo, period)
      bw = aw + (b - a - n_per * period)
      if bw <= hi:
        rem = sp.map([F(bw), F(aw)], lambda u, v: u - v)
      else:
        rem = sp.map([F(hi), F(aw), F(lo + (bw - hi)), F(lo)],
                     lambda u, v, w, z: (u - v) + (w - z))
      return sp.map([whole, rem], lambda u, v: (u + v) * sign)
    sign = 1.0
    if b < a:
      a, b = b, a
      sign = -1.0
    out = sp.map([F(b, extrapolate=extra), F(a, extrapolate=extra)],
                 lambda u, v: (u - v) * sign)
    return out

  # -- host-boundary methods -------------------------------------------
  def _to_scipy(self):
    import scipy.interpolate as _si
    return _si.PPoly(np.asarray(_np(self.c), float),
                     np.asarray(_np(self.x), float),
                     extrapolate=self.extrapolate)

  def solve(self, y=0.0, discontinuity=True, extrapolate=None):
    _host_notice("PPoly.solve")
    return self._to_scipy().solve(y, discontinuity, extrapolate)

  def roots(self, discontinuity=True, extrapolate=None):
    _host_notice("PPoly.roots")
    return self._to_scipy().roots(discontinuity, extrapolate)

  def extend(self, c, x, right=True):
    cn, xn = _np(c), _np(x)
    co, xo = _np(self.c), _np(self.x)
    k = max(cn.shape[0], co.shape[0])

    def pad(cc):
      if cc.shape[0] < k:
        z = np.zeros((k - cc.shape[0],) + cc.shape[1:], cc.dtype)
        return np.concatenate([z, cc], axis=0)
      return cc
    if right == (self._ascending):
      c2 = np.concatenate([pad(co), pad(cn)], axis=1)
      x2 = np.concatenate([xo, xn])
    else:
      c2 = np.concatenate([pad(cn), pad(co)], axis=1)
      x2 = np.concatenate([xn, xo])
    out = PPoly(c2, x2, extrapolate=self.extrapolate)
    return out


class BPoly(PPoly):
  """Piecewise Bernstein-basis polynomial (device de Casteljau)."""

  _eval_kern = staticmethod(_bpoly_eval)

  @classmethod
  def from_power_basis(cls, pp, extrapolate=None):
    k = pp.c.shape[0] - 1
    from math import comb
    # t^j on [0,h]: t^j = h^j s^j; s^j = sum_a (C(a,j)/C(k,j)) b_{a,k}
    M = np.zeros((k + 1, k + 1))
    for j in range(k + 1):
      for a in range(j, k + 1):
        M[a, j] = comb(a, j) / comb(k, j)

    def kern(c, xb):
      c = _f(c)
      h = jnp.diff(xb)
      powers = jnp.arange(k + 1, dtype=c.dtype)
      hp = h[None] ** powers[:, None]
      hp = hp.reshape(hp.shape + (1,) * (c.ndim - 2))
      cs = c[::-1] * hp  # ascending-power coefs in s
      return jnp.tensordot(jnp.asarray(M, c.dtype), cs, axes=(1, 0))

    c_new = sp.map([pp.c, pp.x], kern)
    extra = pp.extrapolate if extrapolate is None else extrapolate
    out = cls.__new__(cls)
    PPoly.__init__(out, c_new, pp.x, extrapolate=extra)
    out._ascending = pp._ascending
    return out

  @classmethod
  def from_derivatives(cls, xi, yi, orders=None, extrapolate=None):
    # construction is a tiny per-breakpoint combinatorial setup —
    # host scipy builds the control net; evaluation stays device.
    import scipy.interpolate as _si
    ref = _si.BPoly.from_derivatives(
        np.asarray(_np(xi), float),
        [np.asarray(_np(y), float) for y in yi] if isinstance(yi, list)
        else np.asarray(_np(yi), float),
        orders=orders, extrapolate=extrapolate)
    out = cls.__new__(cls)
    PPoly.__init__(out, ref.c, ref.x, extrapolate=ref.extrapolate)
    out._ascending = True
    return out

  def derivative(self, nu=1):
    if nu < 0:
      return self.antiderivative(-nu)
    if nu == 0:
      c_new = self.c
    else:
      def kern(c, xb):
        c = _f(c)
        h = jnp.diff(xb)
        hb = h.reshape((-1,) + (1,) * (c.ndim - 2))
        for _ in range(nu):
          deg = c.shape[0] - 1
          if deg == 0:
            return jnp.zeros((1,) + c.shape[1:], c.dtype)
          c = (c[1:] - c[:-1]) * (deg / hb)
        return c
      c_new = sp.map([self.c, self.x], kern)
    out = BPoly.__new__(BPoly)
    PPoly.__init__(out, c_new, self.x, extrapolate=self.extrapolate)
    out._ascending = self._ascending
    return out

  def antiderivative(self, nu=1):
    if nu < 0:
      return self.derivative(-nu)

    def kern(c, xb):
      c = _f(c)
      h = jnp.diff(xb)
      hb = h.reshape((-1,) + (1,) * (c.ndim - 2))
      for _ in range(nu):
        k = c.shape[0] - 1
        # antiderivative control points: running sums scaled by h/(k+1)
        cs = jnp.cumsum(c, axis=0) * (hb / (k + 1))
        c = jnp.concatenate([jnp.zeros_like(cs[:1]), cs], axis=0)
        # continuity: add exclusive cumsum of right-edge values
        # (last control point = value at right edge)
        edge = c[-1]
        consts = jnp.cumsum(edge, axis=0)
        consts = jnp.concatenate(
            [jnp.zeros_like(consts[:1]), consts[:-1]], axis=0)
        c = c + consts[None]
      return c

    c_new = sp.map([self.c, self.x], kern)
    out = BPoly.__new__(BPoly)
    extra = self.extrapolate
    if extra == "periodic":
      extra = False
    PPoly.__init__(out, c_new, self.x, extrapolate=extra)
    out._ascending = self._ascending
    return out

  def integrate(self, a, b, extrapolate=None):
    return PPoly.integrate(self, a, b, extrapolate=extrapolate)

  def solve(self, y=0.0, discontinuity=True, extrapolate=None):
    _host_notice("BPoly.solve")
    return PPoly.from_bernstein_basis(self)._to_scipy().solve(
        y, discontinuity, extrapolate)

  def roots(self, discontinuity=True, extrapolate=None):
    return self.solve(0.0, discontinuity, extrapolate)


# =====================================================================
# the cubic family
# =====================================================================

def _canonical_y(x, y, axis):
  """Sort/validate x on host (breakpoints are metadata); move the
  interpolation axis of y to the front, lazily."""
  xc = _asfloat_np(x)
  if xc.ndim != 1 or xc.shape[0] < 2:
    raise ValueError("x must be 1-D with at least 2 points")
  Y = sp.lazify(y)
  nd = len(Y.shape)
  axis = axis % nd
  if Y.shape[axis] != xc.shape[0]:
    raise ValueError(f"y.shape[{axis}] = {Y.shape[axis]} != "
                     f"len(x) = {xc.shape[0]}")
  if axis != 0:
    Y = sp.map([Y], lambda a: jnp.moveaxis(a, axis, 0))
  flip = False
  if xc.shape[0] > 1 and xc[1] < xc[0]:
    if not (np.diff(xc) < 0).all():
      raise ValueError("x must be strictly monotonic")
    xc = xc[::-1].copy()
    Y = sp.map([Y], lambda a: a[::-1])
    flip = True
  elif not (np.diff(xc) > 0).all():
    raise ValueError("x must be strictly increasing")
  return xc, Y, axis, flip


class _AxisPPolyMixin:
  """__call__ that restores the user's axis layout (scipy's axis=)."""

  def __call__(self, x, nu=0, extrapolate=None):
    out = PPoly.__call__(self, x, nu=nu, extrapolate=extrapolate)
    ax = getattr(self, "axis", 0)
    if ax:
      xq_nd = len(sp.lazify(x).shape)
      out = sp.map([out], lambda a: jnp.moveaxis(
          a, tuple(range(xq_nd)),
          tuple(range(ax, ax + xq_nd))))
    return out


class CubicHermiteSpline(_AxisPPolyMixin, PPoly):
  """Cubic Hermite from values + derivatives (device construction)."""

  def __init__(self, x, y, dydx, axis=0, extrapolate=None):
    xc, Y, axis, flip = _canonical_y(x, y, axis)
    D = sp.lazify(dydx)
    if axis != 0:
      D = sp.map([D], lambda a: jnp.moveaxis(a, axis, 0))
    if flip:
      # dy/dx at a knot is orientation-independent: plain reversal
      D = sp.map([D], lambda a: a[::-1])
    c = sp.map([Y, D], lambda yy, dd: _hermite_power_coefs(
        jnp.asarray(xc, _f(yy).dtype), _f(yy), _f(dd)))
    PPoly.__init__(self, c, xc, extrapolate=extrapolate)
    self.axis = axis


class CubicSpline(_AxisPPolyMixin, PPoly):
  """C2 cubic spline; the tridiagonal system solves on device via a
  Thomas ``lax.scan`` (periodic: Sherman–Morrison on two scans)."""

  def __init__(self, x, y, axis=0, bc_type="not-a-knot",
               extrapolate=None):
    xc, Y, axis, flip = _canonical_y(x, y, axis)
    n = xc.shape[0]
    bc, bc_vals = self._parse_bc(bc_type, n)
    if bc == "periodic" and extrapolate is None:
      extrapolate = "periodic"

    xj = jnp.asarray(xc)

    nak = bc == ("not-a-knot", "not-a-knot")
    if n == 2 and nak:
      def kern(yy):
        yy = _f(yy)
        hb = (xc[1] - xc[0])
        m = (yy[1:] - yy[:-1]) / hb
        s = jnp.concatenate([m, m], axis=0)
        return _hermite_power_coefs(xj.astype(yy.dtype), yy, s)
      c = sp.map([Y], kern)
    elif n == 3 and nak:
      # single parabola through three points (scipy's special case)
      def kern(yy):
        yy = _f(yy)
        xl = xj.astype(yy.dtype)
        h0, h1 = xl[1] - xl[0], xl[2] - xl[1]
        m0 = (yy[1] - yy[0]) / h0
        m1 = (yy[2] - yy[1]) / h1
        a = (m1 - m0) / (h0 + h1)          # quadratic coef
        s = jnp.stack([m0 - a * h0, m0 + a * h0, m1 + a * h1], axis=0)
        return _hermite_power_coefs(xl, yy, s)
      c = sp.map([Y], kern)
    else:
      def kern(yy):
        yy = _f(yy)
        s = _cubic_spline_derivs(xj.astype(yy.dtype), yy, bc, bc_vals)
        return _hermite_power_coefs(xj.astype(yy.dtype), yy, s)
      c = sp.map([Y], kern)
    PPoly.__init__(self, c, xc, extrapolate=extrapolate)
    self.axis = axis

  @staticmethod
  def _parse_bc(bc_type, n):
    if isinstance(bc_type, str):
      if bc_type == "periodic":
        return bc_type, (None, None)
      if bc_type == "not-a-knot":
        return ("not-a-knot", "not-a-knot"), (None, None)
      if bc_type == "natural":
        return ("natural", "natural"), (None, None)
      if bc_type == "clamped":
        return ("clamped", "clamped"), (0.0, 0.0)
      raise ValueError(f"unknown bc_type {bc_type!r}")
    lo, hi = bc_type

    def one(b):
      if isinstance(b, str):
        if b == "clamped":
          return "clamped", 0.0
        if b == "natural":
          return "natural", None
        if b == "not-a-knot":
          return "not-a-knot", None
        raise ValueError(f"unknown bc {b!r}")
      order, val = b
      if order == 1:
        return "clamped", val
      if order == 2:
        return "second", val
      raise ValueError("derivative order must be 1 or 2")
    (k0, v0), (k1, v1) = one(lo), one(hi)
    return (k0, k1), (v0, v1)


class PchipInterpolator(CubicHermiteSpline):
  """Monotone cubic (Fritsch–Carlson), fully device."""

  def __init__(self, x, y, axis=0, extrapolate=None):
    xc, Y, axis, _ = _canonical_y(x, y, axis)
    if xc.shape[0] < 2:
      raise ValueError("need at least 2 points")
    xj = jnp.asarray(xc)
    if xc.shape[0] == 2:
      def kern(yy):
        yy = _f(yy)
        m = (yy[1:] - yy[:-1]) / (xc[1] - xc[0])
        s = jnp.concatenate([m, m], axis=0)
        return _hermite_power_coefs(xj.astype(yy.dtype), yy, s)
    else:
      def kern(yy):
        yy = _f(yy)
        s = _pchip_derivs(xj.astype(yy.dtype), yy)
        return _hermite_power_coefs(xj.astype(yy.dtype), yy, s)
    c = sp.map([Y], kern)
    PPoly.__init__(self, c, xc,
                   extrapolate=True if extrapolate is None
                   else extrapolate)
    self.axis = axis


pchip = PchipInterpolator


class Akima1DInterpolator(CubicHermiteSpline):
  """Akima / modified-Akima cubic (device where-select weights)."""

  def __init__(self, x, y, axis=0, *, method="akima", extrapolate=None):
    if method not in ("akima", "makima"):
      raise NotImplementedError(f"method {method!r}")
    xc, Y, axis, _ = _canonical_y(x, y, axis)
    if xc.shape[0] < 3:
      raise ValueError("need at least 3 points for Akima")
    xj = jnp.asarray(xc)
    mk = method == "makima"

    def kern(yy):
      yy = _f(yy)
      s = _akima_derivs(xj.astype(yy.dtype), yy, mk)
      return _hermite_power_coefs(xj.astype(yy.dtype), yy, s)
    c = sp.map([Y], kern)
    PPoly.__init__(self, c, xc,
                   extrapolate=False if extrapolate is None
                   else extrapolate)
    self.axis = axis


# =====================================================================
# interp1d
# =====================================================================

class interp1d:
  """scipy.interpolate.interp1d — device searchsorted/gather kernels
  for the direct kinds; spline kinds route through
  ``make_interp_spline`` (device collocation solve)."""

  def __init__(self, x, y, kind="linear", axis=-1, copy=True,
               bounds_error=None, fill_value=np.nan,
               assume_sorted=False):
    xc = _asfloat_np(x)
    if xc.ndim != 1:
      raise ValueError("x must be 1-D")
    Y = sp.lazify(y)
    nd = len(Y.shape)
    axis = axis % nd
    if not assume_sorted:
      order = np.argsort(xc, kind="stable")
      if not (order == np.arange(len(xc))).all():
        xc = xc[order]
        oj = jnp.asarray(order)
        Y = sp.map([Y], lambda a: jnp.take(a, oj, axis=axis))
    if Y.shape[axis] != xc.shape[0]:
      raise ValueError("x and y arguments must be of equal length "
                       "along the interpolation axis")
    if axis != 0:
      Y = sp.map([Y], lambda a: jnp.moveaxis(a, axis, 0))
    self.x, self._y, self.axis, self.kind = xc, Y, axis, kind
    self._extrap = (fill_value == "extrapolate") \
        if isinstance(fill_value, str) else False
    if self._extrap:
      if bounds_error:
        raise ValueError("cannot extrapolate and raise at the same time")
      bounds_error = False
    self.bounds_error = True if bounds_error is None else bounds_error
    if self.bounds_error and not isinstance(fill_value, str) and \
       not (np.isscalar(fill_value) and np.isnan(fill_value)):
      pass
    if isinstance(fill_value, tuple):
      self._fill = (np.asarray(fill_value[0], float),
                    np.asarray(fill_value[1], float))
    elif not isinstance(fill_value, str):
      fv = np.asarray(fill_value, float)
      self._fill = (fv, fv)
    else:
      self._fill = (np.nan, np.nan)
    kmap = {"slinear": 1, "quadratic": 2, "cubic": 3}
    if kind in kmap or (isinstance(kind, int) and kind > 0):
      k = kmap.get(kind, kind)
      self._spline = make_interp_spline(xc, Y, k=k)
    elif kind in ("linear", "nearest", "nearest-up", "previous",
                  "next", "zero") or kind == 0:
      self._spline = None
      if kind == 0:
        self.kind = "zero"
    else:
      raise NotImplementedError(f"kind {kind!r}")

  def __call__(self, xq):
    XQ = sp.lazify(xq)
    qshape = XQ.shape
    xj = jnp.asarray(self.x)
    n = self.x.shape[0]
    kind = self.kind
    lo_f, hi_f = self._fill
    extrap = self._extrap
    xlo, xhi = self.x[0], self.x[-1]

    if self.bounds_error:
      # bounds check needs concrete queries — scipy raises eagerly
      qc = _np(xq)
      if (qc < xlo).any() or (qc > xhi).any():
        raise ValueError("A value in x_new is out of the "
                         "interpolation range.")

    if self._spline is not None:
      raw = self._spline(XQ)
      if extrap:
        out = raw
      else:
        def fillk(r, q):
          q = _f(q)
          mask_shape = q.shape + (1,) * (len(r.shape) - q.ndim)
          below = (q < xlo).reshape(mask_shape)
          above = (q > xhi).reshape(mask_shape)
          r = jnp.where(below, jnp.asarray(lo_f, r.dtype), r)
          return jnp.where(above, jnp.asarray(hi_f, r.dtype), r)
        out = sp.map([raw, XQ], fillk)
    else:
      def kern(yy, q):
        yy = _f(yy)
        qf = jnp.ravel(_f(q))
        xl = xj.astype(qf.dtype)
        if kind == "linear":
          i = jnp.clip(jnp.searchsorted(xl, qf, side="right") - 1,
                       0, n - 2)
          t = (qf - xl[i]) / (xl[i + 1] - xl[i])
          tb = t.reshape(t.shape + (1,) * (yy.ndim - 1))
          res = yy[i] * (1 - tb) + yy[i + 1] * tb
        elif kind in ("nearest", "nearest-up"):
          side = "left" if kind == "nearest" else "right"
          mid = 0.5 * (xl[:-1] + xl[1:])
          i = jnp.searchsorted(mid, qf, side=side)
          res = yy[i]
        elif kind in ("previous", "zero"):
          i = jnp.clip(jnp.searchsorted(xl, qf, side="right") - 1, 0,
                       n - (2 if kind == "zero" else 1))
          res = yy[i]
        elif kind == "next":
          i = jnp.clip(jnp.searchsorted(xl, qf, side="left"), 0, n - 1)
          res = yy[i]
        else:  # pragma: no cover
          raise AssertionError(kind)
        if not extrap:
          mshape = qf.shape + (1,) * (yy.ndim - 1)
          res = jnp.where((qf < xl[0]).reshape(mshape),
                          jnp.asarray(lo_f, res.dtype), res)
          res = jnp.where((qf > xl[-1]).reshape(mshape),
                          jnp.asarray(hi_f, res.dtype), res)
        return res.reshape(qshape + yy.shape[1:])
      out = sp.map([self._y, XQ], kern)

    if self.axis:
      ax = self.axis
      ql = len(qshape)
      out = sp.map([out], lambda a: jnp.moveaxis(
          a, tuple(range(ql)), tuple(range(ax, ax + ql))))
    return out


# =====================================================================
# B-splines (device de Boor)
# =====================================================================

def _bspl_derivative_tck(t, c, k, nu):
  """nu-fold B-spline derivative coefficient transform (jnp, static
  nu/k): returns (t', c', k-nu)."""
  for _ in range(nu):
    if k == 0:
      return t[1:-1], jnp.zeros((1,) + c.shape[1:], c.dtype), 0
    dt = t[k + 1:-1] - t[1:-k - 1]
    dtb = dt.reshape((-1,) + (1,) * (c.ndim - 1))
    safe = jnp.where(dtb == 0, 1.0, dtb)
    c = jnp.where(dtb == 0, 0.0, k * (c[1:] - c[:-1]) / safe)
    t = t[1:-1]
    k -= 1
  return t, c, k


def _deboor_eval(t, c, k, xq, extrapolate):
  """De Boor evaluation: t (nt,), c (n, *trailing), xq (nq,) ->
  (nq, *trailing).  Static k/extrapolate; repeated knots handled via
  where-guarded alphas."""
  c = _f(c)
  xq = _f(xq)
  t = t.astype(xq.dtype)
  n = c.shape[0]
  lo, hi = t[k], t[n]
  if extrapolate == "periodic":
    xq = lo + jnp.mod(xq - lo, hi - lo)
  i = jnp.clip(jnp.searchsorted(t, xq, side="right") - 1, k, n - 1)
  d = [c[i - k + j] for j in range(k + 1)]
  for r in range(1, k + 1):
    for j in range(k, r - 1, -1):
      denom = t[i + j - r + 1] - t[i + j - k]
      safe = jnp.where(denom == 0, 1.0, denom)
      alpha = jnp.where(denom == 0, 0.0, (xq - t[i + j - k]) / safe)
      ab = alpha.reshape(alpha.shape + (1,) * (c.ndim - 1))
      d[j] = (1.0 - ab) * d[j - 1] + ab * d[j]
  res = d[k]
  if extrapolate is False:
    inside = (xq >= lo) & (xq <= hi)
    res = jnp.where(inside.reshape(xq.shape + (1,) * (c.ndim - 1)),
                    res, jnp.nan)
  return res


def _basis_matrix(t, k, xq, nu=0, extrapolate=True):
  """(nq, ncoef) matrix of nu-th-derivative B-spline basis values —
  vmapped one-hot de Boor columns (exact, O(n^2 k^2) fused FLOPs)."""
  n = t.shape[0] - k - 1

  def col(cj):
    tt, cc, kk = _bspl_derivative_tck(t, cj, k, nu)
    return _deboor_eval(tt, cc, kk, xq, extrapolate)

  return jax.vmap(col, in_axes=0, out_axes=1)(
      jnp.eye(n, dtype=xq.dtype))


class BSpline:
  """scipy.interpolate.BSpline with lazy device evaluation (de Boor
  kernel in one ``sp.map``; derivative/antiderivative are device coef
  transforms)."""

  def __init__(self, t, c, k, extrapolate=True, axis=0):
    tc = _asfloat_np(t)
    if tc.ndim != 1:
      raise ValueError("knots must be 1-D")
    self.t = tc
    self.k = int(k)
    C = sp.lazify(c)
    n = tc.shape[0] - self.k - 1
    if n < self.k + 1:
      raise ValueError("need at least %d knots for degree %d"
                       % (2 * self.k + 2, self.k))
    nd = len(C.shape)
    axis = axis % nd if nd else 0
    if C.shape[axis] != n:
      raise ValueError(f"c.shape[{axis}] = {C.shape[axis]} != "
                       f"nt - k - 1 = {n}")
    if axis != 0:
      C = sp.map([C], lambda a: jnp.moveaxis(a, axis, 0))
    self.c = C
    self.axis = axis
    self.extrapolate = extrapolate

  @classmethod
  def construct_fast(cls, t, c, k, extrapolate=True, axis=0):
    return cls(t, c, k, extrapolate=extrapolate, axis=axis)

  @classmethod
  def basis_element(cls, t, extrapolate=True):
    tc = _asfloat_np(t)
    k = tc.shape[0] - 2
    t_full = np.concatenate([[tc[0]] * k, tc, [tc[-1]] * k]) if k else tc
    c = np.zeros(t_full.shape[0] - k - 1)
    c[k] = 1.0
    return cls(t_full, c, k, extrapolate=extrapolate)

  @classmethod
  def design_matrix(cls, x, t, k, extrapolate=False):
    _host_notice("BSpline.design_matrix")
    import scipy.interpolate as _si
    return _si.BSpline.design_matrix(
        np.asarray(_np(x), float), np.asarray(_np(t), float), int(k),
        extrapolate=extrapolate)

  def __call__(self, x, nu=0, extrapolate=None):
    extra = self.extrapolate if extrapolate is None else extrapolate
    XQ = sp.lazify(x)
    qshape = XQ.shape
    tj = jnp.asarray(self.t)
    k = self.k

    def kern(cc, q):
      cc = _f(cc)
      tt, cv, kk = _bspl_derivative_tck(tj.astype(cc.dtype), cc, k, nu)
      res = _deboor_eval(tt, cv, kk, jnp.ravel(_f(q)), extra)
      return res.reshape(qshape + res.shape[1:])

    out = sp.map([self.c, XQ], kern)
    if self.axis:
      ax, ql = self.axis, len(qshape)
      out = sp.map([out], lambda a: jnp.moveaxis(
          a, tuple(range(ql)), tuple(range(ax, ax + ql))))
    return out

  def derivative(self, nu=1):
    if nu < 0:
      return self.antiderivative(-nu)
    k2 = self.k - nu
    if k2 < 0:
      raise ValueError(f"order of derivative {nu} > degree {self.k}")
    tj = jnp.asarray(self.t)
    k = self.k
    c_new = sp.map([self.c], lambda cc: _bspl_derivative_tck(
        tj.astype(_f(cc).dtype), _f(cc), k, nu)[1])
    extra = self.extrapolate
    out = BSpline.__new__(BSpline)
    BSpline.__init__(out, self.t[nu:len(self.t) - nu], c_new, k2,
                     extrapolate=extra)
    return out

  def antiderivative(self, nu=1):
    if nu < 0:
      return self.derivative(-nu)
    t, k = self.t, self.k
    c_expr = self.c
    for _ in range(nu):
      tj = jnp.asarray(t)
      kk = k

      def kern(cc, _t=tj, _k=kk):
        cc = _f(cc)
        tt = _t.astype(cc.dtype)
        w = (tt[_k + 1:] - tt[:-(_k + 1)]) / (_k + 1)
        wb = w.reshape((-1,) + (1,) * (cc.ndim - 1))
        cs = jnp.cumsum(cc * wb, axis=0)
        return jnp.concatenate([jnp.zeros_like(cs[:1]), cs], axis=0)

      c_expr = sp.map([c_expr], kern)
      t = np.concatenate([t[:1], t, t[-1:]])
      k += 1
    extra = self.extrapolate
    if extra == "periodic":
      extra = False
    out = BSpline.__new__(BSpline)
    BSpline.__init__(out, t, c_expr, k, extrapolate=extra)
    return out

  def integrate(self, a, b, extrapolate=None):
    extra = self.extrapolate if extrapolate is None else extrapolate
    n = len(self.t) - self.k - 1
    lo, hi = float(self.t[self.k]), float(self.t[n])
    F = self.antiderivative()
    sign = 1.0
    if b < a:
      a, b = b, a
      sign = -1.0
    if extra == "periodic":
      period = hi - lo
      n_per = np.floor((b - a) / period)
      aw = lo + np.mod(a - lo, period)
      bw = aw + (b - a - n_per * period)
      parts = [sp.map([F(hi), F(lo)], lambda u, v: (u - v) * n_per)]
      if bw <= hi:
        parts.append(sp.map([F(bw), F(aw)], lambda u, v: u - v))
      else:
        parts.append(sp.map([F(hi), F(aw), F(lo + (bw - hi)), F(lo)],
                            lambda u, v, w, z: (u - v) + (w - z)))
      return sp.map(parts, lambda u, v: (u + v) * sign)
    if extra is False or extra is None:
      a, b = np.clip(a, lo, hi), np.clip(b, lo, hi)
    return sp.map([F(b), F(a)], lambda u, v: (u - v) * sign)

  def insert_knot(self, x, m=1):
    _host_notice("BSpline.insert_knot")
    import scipy.interpolate as _si
    ref = _si.BSpline(np.asarray(self.t, float),
                      np.asarray(_np(self.c), float), self.k,
                      extrapolate=(self.extrapolate
                                   if self.extrapolate != "periodic"
                                   else True)).insert_knot(x, m)
    return BSpline(ref.t, ref.c, ref.k, extrapolate=self.extrapolate)

  @property
  def tck(self):
    return (self.t, self.c, self.k)


def _default_knots(x, k, bc_type):
  """scipy make_interp_spline knot vectors (host metadata)."""
  n = x.shape[0]
  if bc_type == "periodic":
    left = x[0] - (x[-1] - x[-(k + 1):-1][::-1])[::-1] if k > 1 else \
        x[0] - (x[-1] - x[-2:-1])
    # t = [x0 - (x_{n-1} - x_{n-1-j}) for j=k..1] + x + mirrored right
    lpad = x[0] - (x[-1] - x[n - 1 - k:n - 1])
    rpad = x[-1] + (x[1:k + 1] - x[0])
    return np.concatenate([lpad, x, rpad])
  if bc_type is None:
    if k == 0:
      return np.concatenate([x, x[-1:]])
    if k % 2 == 1:
      m = (k + 1) // 2
      interior = x[m:n - m]
    else:
      m = k // 2
      mid = 0.5 * (x[:-1] + x[1:])
      interior = mid[m:n - 1 - m]
    return np.concatenate([[x[0]] * (k + 1), interior,
                           [x[-1]] * (k + 1)])
  # derivative-condition bcs: all data sites interior
  return np.concatenate([[x[0]] * (k + 1), x[1:-1], [x[-1]] * (k + 1)])


def _parse_spline_bc(bc_type, k):
  """Normalize bc_type to (left_conds, right_conds) lists of
  (order, value), or the strings None/'periodic'."""
  if bc_type is None or bc_type == "periodic":
    return bc_type
  if isinstance(bc_type, str):
    if bc_type == "not-a-knot":
      return None
    if bc_type == "natural":
      return ([(2, 0.0)], [(2, 0.0)])
    if bc_type == "clamped":
      return ([(1, 0.0)], [(1, 0.0)])
    raise ValueError(f"unknown bc_type {bc_type!r}")
  lo, hi = bc_type

  def side(b):
    if b is None:
      return []
    if isinstance(b, tuple) and len(b) == 2 and np.isscalar(b[0]):
      return [b]
    return list(b)
  return (side(lo), side(hi))


def make_interp_spline(x, y, k=3, t=None, bc_type=None, axis=0,
                       check_finite=True):
  """Interpolating B-spline: device collocation matrix (vmapped
  one-hot de Boor basis columns) + dense matmul-based solve.  For large n the
  O(n^3) dense solve is the tradeoff — use CubicSpline (Thomas scan,
  O(n)) for big 1-D problems."""
  xc, Y, axis, flip = _canonical_y(x, y, axis)
  k = int(k)
  n = xc.shape[0]
  bc = _parse_spline_bc(bc_type, k)
  if k == 0 and bc is None and t is None:
    tv = _default_knots(xc, 0, None)
    out = BSpline.__new__(BSpline)
    BSpline.__init__(out, tv, Y, 0)
    out.axis = axis
    return out
  if t is not None:
    tv = _asfloat_np(t)
  else:
    tv = _default_knots(xc, k, "periodic" if bc == "periodic" else
                        (None if bc is None else "bc"))
  ncoef = tv.shape[0] - k - 1
  xj = jnp.asarray(xc)
  tj = jnp.asarray(tv)

  if bc == "periodic":
    nderiv = ncoef - n
    def kern(yy):
      yy = _f(yy)
      tl = tj.astype(yy.dtype)
      A_int = _basis_matrix(tl, k, xj.astype(yy.dtype))
      rows = [A_int]
      for nu in range(1, nderiv + 1):
        b0 = _basis_matrix(tl, k, xj[:1].astype(yy.dtype), nu=nu)
        bn = _basis_matrix(tl, k, xj[-1:].astype(yy.dtype), nu=nu)
        rows.append(b0 - bn)
      A = jnp.concatenate(rows, axis=0)
      rhs = jnp.concatenate(
          [yy.reshape(n, -1),
           jnp.zeros((nderiv, int(np.prod(yy.shape[1:]) or 1)),
                     yy.dtype)], axis=0)
      sol = jnp.linalg.solve(A, rhs)
      return sol.reshape((ncoef,) + yy.shape[1:])
    c = sp.map([Y], kern)
  elif bc is None:
    def kern(yy):
      yy = _f(yy)
      A = _basis_matrix(tj.astype(yy.dtype), k, xj.astype(yy.dtype))
      sol = jnp.linalg.solve(A, yy.reshape(n, -1))
      return sol.reshape((ncoef,) + yy.shape[1:])
    c = sp.map([Y], kern)
  else:
    left, right = bc
    if len(left) + len(right) != ncoef - n:
      raise ValueError(f"number of boundary conditions "
                       f"{len(left) + len(right)} != {ncoef - n}")
    lvals = [np.asarray(v, float) for _, v in left]
    rvals = [np.asarray(v, float) for _, v in right]
    def kern(yy):
      yy = _f(yy)
      tl = tj.astype(yy.dtype)
      xl = xj.astype(yy.dtype)
      rows = []
      rh = []
      tcols = int(np.prod(yy.shape[1:]) or 1)
      for (order, _), v in zip(left, lvals):
        rows.append(_basis_matrix(tl, k, xl[:1], nu=int(order)))
        rh.append(jnp.broadcast_to(jnp.asarray(v, yy.dtype),
                                   yy.shape[1:]).reshape(1, tcols))
      rows.append(_basis_matrix(tl, k, xl))
      rh.append(yy.reshape(n, -1))
      for (order, _), v in zip(right, rvals):
        rows.append(_basis_matrix(tl, k, xl[-1:], nu=int(order)))
        rh.append(jnp.broadcast_to(jnp.asarray(v, yy.dtype),
                                   yy.shape[1:]).reshape(1, tcols))
      A = jnp.concatenate(rows, axis=0)
      rhs = jnp.concatenate(rh, axis=0)
      sol = jnp.linalg.solve(A, rhs)
      return sol.reshape((ncoef,) + yy.shape[1:])
    c = sp.map([Y], kern)

  out = BSpline.__new__(BSpline)
  BSpline.__init__(out, tv, c, k,
                   extrapolate="periodic" if bc == "periodic" else True)
  out.axis = axis
  return out


def make_lsq_spline(x, y, t, k=3, w=None, axis=0, check_finite=True):
  """Least-squares B-spline with fixed knots: device design matrix +
  normal-equations solve on the matrix units."""
  xc, Y, axis, flip = _canonical_y(x, y, axis)
  tv = _asfloat_np(t)
  k = int(k)
  ncoef = tv.shape[0] - k - 1
  xj = jnp.asarray(xc)
  tj = jnp.asarray(tv)
  wj = None if w is None else jnp.asarray(_asfloat_np(w))

  def kern(yy):
    yy = _f(yy)
    A = _basis_matrix(tj.astype(yy.dtype), k, xj.astype(yy.dtype))
    rhs = yy.reshape(xc.shape[0], -1)
    if wj is not None:
      # scipy convention: minimize sum (w_j * (g(x_j) - y_j))**2
      ws = wj.astype(yy.dtype)[:, None]
      A = A * ws
      rhs = rhs * ws
    AtA = jnp.matmul(A.T, A, precision="highest")
    Atb = jnp.matmul(A.T, rhs, precision="highest")
    sol = jnp.linalg.solve(AtA, Atb)
    return sol.reshape((ncoef,) + yy.shape[1:])

  c = sp.map([Y], kern)
  out = BSpline.__new__(BSpline)
  BSpline.__init__(out, tv, c, k)
  out.axis = axis
  return out


# ---------------------------------------------------------------------
# FITPACK-compatible tck surface: host fits, device evaluation
# ---------------------------------------------------------------------

def _tck_parts(tck):
  if isinstance(tck, BSpline):
    return np.asarray(tck.t, float), tck.c, int(tck.k)
  t, c, k = tck
  t = np.asarray(_np(t), float)
  C = sp.lazify(c)
  n = t.shape[0] - int(k) - 1
  if C.shape and C.shape[0] > n:
    C = C[:n]  # FITPACK pads c with k+1 trailing zeros
  return t, C, int(k)


def splev(x, tck, der=0, ext=0):
  """Device B-spline evaluation of a (t, c, k) tuple (or BSpline).
  ext: 0 extrapolate, 1 zero, 2 raise, 3 clamp (scipy codes)."""
  t, c, k = _tck_parts(tck)
  n = t.shape[0] - k - 1
  lo, hi = t[k], t[n]
  XQ = sp.lazify(x)
  qshape = XQ.shape
  if ext == 2:
    qc = _np(x)
    if (qc < lo).any() or (qc > hi).any():
      raise ValueError("x out of bounds with ext=2")
  tj = jnp.asarray(t)
  C = sp.lazify(c)
  listy = isinstance(c, (list, tuple)) and not isinstance(c, np.ndarray)

  def kern(cc, q):
    cc = _f(cc)
    q = jnp.ravel(_f(q))
    if ext == 3:
      q = jnp.clip(q, lo, hi)
    tt, cv, kk = _bspl_derivative_tck(tj.astype(cc.dtype), cc, k, der)
    res = _deboor_eval(tt, cv, kk, q, True)
    if ext == 1:
      inside = (q >= lo) & (q <= hi)
      res = jnp.where(inside.reshape(q.shape + (1,) * (res.ndim - 1)),
                      res, 0.0)
    return res.reshape(qshape + res.shape[1:])

  del listy
  return sp.map([C, XQ], kern)


def splint(a, b, tck, full_output=0):
  t, c, k = _tck_parts(tck)
  bs = BSpline(t, c, k, extrapolate=True)
  # FITPACK convention: integrand assumed zero outside the support
  out = bs.integrate(a, b, extrapolate=False)
  if full_output:
    _host_notice("splint(full_output)")
    import scipy.interpolate as _si
    return out, _si.splint(a, b, (t, np.asarray(_np(c), float), k),
                           full_output=1)[1]
  return out


def splder(tck, n=1):
  t, c, k = _tck_parts(tck)
  bs = BSpline(t, c, k).derivative(n)
  return (bs.t, bs.c, bs.k)


def splantider(tck, n=1):
  t, c, k = _tck_parts(tck)
  bs = BSpline(t, c, k).antiderivative(n)
  return (bs.t, bs.c, bs.k)


def spalde(x, tck):
  """All derivatives 0..k at each point (list-of-arrays contract)."""
  t, c, k = _tck_parts(tck)
  cols = [splev(x, (t, c, k), der=nu) for nu in range(k + 1)]
  stacked = sp.map(cols, lambda *a: jnp.stack(a, axis=-1))
  return stacked


# host FITPACK fits (sequential knot placement — the fit is the host
# boundary; evaluation of the returned tck/BSpline is device)

def splrep(x, y, w=None, xb=None, xe=None, k=3, task=0, s=None, t=None,
           full_output=0, per=0, quiet=1):
  _host_notice("splrep")
  import scipy.interpolate as _si
  return _si.splrep(_asfloat_np(x), _asfloat_np(y), w=w, xb=xb, xe=xe,
                    k=k, task=task, s=s, t=t, full_output=full_output,
                    per=per, quiet=quiet)


def splprep(x, w=None, u=None, ub=None, ue=None, k=3, task=0, s=None,
            t=None, full_output=0, per=0, quiet=1):
  _host_notice("splprep")
  import scipy.interpolate as _si
  xs = [_asfloat_np(xi) for xi in x] if isinstance(x, (list, tuple)) \
      else _asfloat_np(x)
  return _si.splprep(xs, w=w, u=u, ub=ub, ue=ue, k=k, task=task, s=s,
                     t=t, full_output=full_output, per=per, quiet=quiet)


def sproot(tck, mest=10):
  _host_notice("sproot")
  import scipy.interpolate as _si
  t, c, k = _tck_parts(tck)
  return _si.sproot((t, np.asarray(_np(c), float), k), mest=mest)


def insert(x, tck, m=1, per=0):
  _host_notice("insert")
  import scipy.interpolate as _si
  t, c, k = _tck_parts(tck)
  return _si.insert(x, (t, np.asarray(_np(c), float), k), m=m, per=per)


def generate_knots(x, y, *, w=None, xb=None, xe=None, k=3, s=0,
                   nest=None):
  _host_notice("generate_knots")
  import scipy.interpolate as _si
  return _si.generate_knots(_asfloat_np(x), _asfloat_np(y), w=w, xb=xb,
                            xe=xe, k=k, s=s, nest=nest)


def _wrap_scipy_bspline(ref, extrapolate=None):
  return BSpline(ref.t, ref.c, ref.k,
                 extrapolate=ref.extrapolate if extrapolate is None
                 else extrapolate, axis=getattr(ref, "axis", 0))


def make_splrep(x, y, *, w=None, xb=None, xe=None, k=3, s=0, t=None,
                nest=None):
  _host_notice("make_splrep")
  import scipy.interpolate as _si
  ref = _si.make_splrep(_asfloat_np(x), _asfloat_np(y), w=w, xb=xb,
                        xe=xe, k=k, s=s, t=t, nest=nest)
  return _wrap_scipy_bspline(ref)


def make_splprep(x, *, w=None, u=None, ub=None, ue=None, k=3, s=0,
                 t=None, nest=None):
  _host_notice("make_splprep")
  import scipy.interpolate as _si
  xs = [_asfloat_np(xi) for xi in x] if isinstance(x, (list, tuple)) \
      else _asfloat_np(x)
  ref, u_out = _si.make_splprep(xs, w=w, u=u, ub=ub, ue=ue, k=k, s=s,
                                t=t, nest=nest)
  return _wrap_scipy_bspline(ref), u_out


def make_smoothing_spline(x, y, w=None, lam=None):
  _host_notice("make_smoothing_spline")
  import scipy.interpolate as _si
  ref = _si.make_smoothing_spline(_asfloat_np(x), _asfloat_np(y),
                                  w=None if w is None
                                  else _asfloat_np(w), lam=lam)
  return _wrap_scipy_bspline(ref)


# ---------------------------------------------------------------------
# UnivariateSpline family: host FITPACK fit, device evaluation
# ---------------------------------------------------------------------

class UnivariateSpline:
  """Smoothing spline — the FIT is the host boundary (FITPACK's
  sequential knot insertion); evaluation/derivatives/integral run on
  device through the de Boor kernel."""

  _fit_name = "UnivariateSpline"

  def __init__(self, x, y, w=None, bbox=(None, None), k=3, s=None,
               ext=0, check_finite=False):
    _host_notice(self._fit_name)
    import scipy.interpolate as _si
    ref = getattr(_si, self._fit_name)(
        _asfloat_np(x), _asfloat_np(y),
        **self._fit_kw(w, bbox, k, s), ext=ext,
        check_finite=check_finite)
    self._init_from_scipy(ref, ext)

  @staticmethod
  def _fit_kw(w, bbox, k, s):
    return dict(w=w, bbox=bbox, k=k, s=s)

  def _init_from_scipy(self, ref, ext):
    t, c, k = ref._eval_args
    self._t, self._c, self._k = np.asarray(t, float), np.asarray(
        c, float), int(k)
    self._ref = ref
    self._ext = {0: "extrapolate", 1: "zeros", 2: "raise",
                 3: "const", "extrapolate": "extrapolate",
                 "zeros": "zeros", "raise": "raise",
                 "const": "const"}[ext]

  @classmethod
  def _from_tck(cls, t, c, k, ext="extrapolate"):
    self = cls.__new__(cls)
    self._t, self._c, self._k = np.asarray(t, float), np.asarray(
        c, float), int(k)
    self._ref = None
    self._ext = ext
    return self

  def __call__(self, x, nu=0, ext=None):
    extm = {None: self._ext, 0: "extrapolate", 1: "zeros",
            2: "raise", 3: "const"}[ext if ext in (None, 0, 1, 2, 3)
                                    else None]
    code = {"extrapolate": 0, "zeros": 1, "raise": 2, "const": 3}[extm]
    return splev(x, (self._t, self._c[:len(self._t) - self._k - 1],
                     self._k), der=nu, ext=code)

  def derivatives(self, x):
    return spalde(np.atleast_1d(x),
                  (self._t, self._c[:len(self._t) - self._k - 1],
                   self._k))

  def derivative(self, n=1):
    t, c, k = splder((self._t,
                      self._c[:len(self._t) - self._k - 1],
                      self._k), n)
    return UnivariateSpline._from_tck(t, np.asarray(_np(c), float), k,
                                      self._ext)

  def antiderivative(self, n=1):
    t, c, k = splantider((self._t,
                          self._c[:len(self._t) - self._k - 1],
                          self._k), n)
    return UnivariateSpline._from_tck(t, np.asarray(_np(c), float), k,
                                      self._ext)

  def integral(self, a, b):
    return splint(a, b, (self._t,
                         self._c[:len(self._t) - self._k - 1],
                         self._k))

  def roots(self):
    _host_notice("UnivariateSpline.roots")
    return sproot((self._t, self._c[:len(self._t) - self._k - 1],
                   self._k))

  def get_knots(self):
    return self._t[self._k:len(self._t) - self._k]

  def get_coeffs(self):
    return self._c[:len(self._t) - self._k - 1]

  def get_residual(self):
    if self._ref is None:
      raise AttributeError("no fit residual (constructed from tck)")
    return self._ref.get_residual()

  def set_smoothing_factor(self, s):
    if self._ref is None:
      raise AttributeError("no underlying fit")
    self._ref.set_smoothing_factor(s)
    self._init_from_scipy(self._ref,
                          {"extrapolate": 0, "zeros": 1, "raise": 2,
                           "const": 3}[self._ext])


class InterpolatedUnivariateSpline(UnivariateSpline):
  _fit_name = "InterpolatedUnivariateSpline"

  def __init__(self, x, y, w=None, bbox=(None, None), k=3, ext=0,
               check_finite=False):
    _host_notice(self._fit_name)
    import scipy.interpolate as _si
    ref = _si.InterpolatedUnivariateSpline(
        _asfloat_np(x), _asfloat_np(y), w=w, bbox=bbox, k=k, ext=ext,
        check_finite=check_finite)
    self._init_from_scipy(ref, ext)


class LSQUnivariateSpline(UnivariateSpline):
  _fit_name = "LSQUnivariateSpline"

  def __init__(self, x, y, t, w=None, bbox=(None, None), k=3, ext=0,
               check_finite=False):
    _host_notice(self._fit_name)
    import scipy.interpolate as _si
    ref = _si.LSQUnivariateSpline(
        _asfloat_np(x), _asfloat_np(y), _asfloat_np(t), w=w, bbox=bbox,
        k=k, ext=ext, check_finite=check_finite)
    self._init_from_scipy(ref, ext)


# ---------------------------------------------------------------------
# rectangular bivariate splines: host regrid fit, device tensor eval
# (two basis matmuls on the matrix units: Bx @ C @ By^T)
# ---------------------------------------------------------------------

class RectBivariateSpline:
  """scipy RectBivariateSpline — FITPACK regrid fit on host; every
  evaluation is two device basis matrices + matmuls."""

  def __init__(self, x, y, z, bbox=(None,) * 4, kx=3, ky=3, s=0):
    _host_notice("RectBivariateSpline")
    import scipy.interpolate as _si
    ref = _si.RectBivariateSpline(_asfloat_np(x), _asfloat_np(y),
                                  _np(z), bbox=bbox, kx=kx, ky=ky, s=s)
    tx, ty, c = ref.tck
    self.kx, self.ky = ref.degrees
    self._tx, self._ty = np.asarray(tx, float), np.asarray(ty, float)
    ncx = len(tx) - self.kx - 1
    ncy = len(ty) - self.ky - 1
    self._C = sp.lazify(np.asarray(c, float).reshape(ncx, ncy))
    self._ref = ref

  @property
  def tck(self):
    return (self._tx, self._ty, _np(self._C).ravel())

  @property
  def degrees(self):
    return (self.kx, self.ky)

  def get_knots(self):
    return (self._tx, self._ty)

  def get_coeffs(self):
    return _np(self._C).ravel()

  def get_residual(self):
    return self._ref.get_residual()

  def __call__(self, x, y, dx=0, dy=0, grid=True):
    X, Yq = sp.lazify(x), sp.lazify(y)
    xs, ys = X.shape, Yq.shape
    txj, tyj = jnp.asarray(self._tx), jnp.asarray(self._ty)
    kx, ky = self.kx, self.ky

    if grid:
      def kern(C, xv, yv):
        C = _f(C)
        Bx = _basis_matrix(txj.astype(C.dtype), kx,
                           jnp.ravel(_f(xv)), nu=dx)
        By = _basis_matrix(tyj.astype(C.dtype), ky,
                           jnp.ravel(_f(yv)), nu=dy)
        Z = jnp.matmul(jnp.matmul(Bx, C, precision="highest"), By.T,
                       precision="highest")
        return Z.reshape(xs + ys)
      return sp.map([self._C, X, Yq], kern)

    def kern(C, xv, yv):
      C = _f(C)
      Bx = _basis_matrix(txj.astype(C.dtype), kx,
                         jnp.ravel(_f(xv)), nu=dx)
      By = _basis_matrix(tyj.astype(C.dtype), ky,
                         jnp.ravel(_f(yv)), nu=dy)
      Z = jnp.einsum("qi,ij,qj->q", Bx, C, By,
                     precision="highest")
      return Z.reshape(xs)
    return sp.map([self._C, X, Yq], kern)

  def ev(self, xi, yi, dx=0, dy=0):
    return self(xi, yi, dx=dx, dy=dy, grid=False)

  def integral(self, xa, xb, ya, yb):
    # tensor-product: integrate the x- and y-antiderivative basis
    txj, tyj = jnp.asarray(self._tx), jnp.asarray(self._ty)
    kx, ky = self.kx, self.ky
    nx = len(self._tx) - kx - 1
    ny = len(self._ty) - ky - 1
    lox, hix = self._tx[kx], self._tx[nx]
    loy, hiy = self._ty[ky], self._ty[ny]
    xa_, xb_ = np.clip([xa, xb], lox, hix)
    ya_, yb_ = np.clip([ya, yb], loy, hiy)

    def kern(C):
      C = _f(C)
      # weights w_i = integral of B_i over [a, b]: evaluate the
      # antiderivative spline with one-hot coefs at b minus at a
      def iw(tj, k, a, b, ncoef):
        t2 = jnp.concatenate([tj[:1], tj, tj[-1:]])
        w = (tj[k + 1:] - tj[:-(k + 1)]) / (k + 1)

        def col(cj):
          cs = jnp.cumsum(cj * w, axis=0)
          c2 = jnp.concatenate([jnp.zeros_like(cs[:1]), cs], axis=0)
          q = jnp.asarray([a, b], C.dtype)
          v = _deboor_eval(t2.astype(C.dtype), c2, k + 1, q, True)
          return v[1] - v[0]
        return jax.vmap(col)(jnp.eye(ncoef, dtype=C.dtype))
      wx = iw(txj.astype(C.dtype), kx, xa_, xb_, nx)
      wy = iw(tyj.astype(C.dtype), ky, ya_, yb_, ny)
      return jnp.einsum("i,ij,j->", wx, C, wy, precision="highest")
    return sp.map([self._C], kern)

  def partial_derivative(self, dx, dy):
    _host_notice("RectBivariateSpline.partial_derivative")
    out = RectBivariateSpline.__new__(RectBivariateSpline)
    ref = self._ref.partial_derivative(dx, dy)
    tx, ty = ref.tck[0], ref.tck[1]
    out.kx, out.ky = ref.degrees
    out._tx, out._ty = np.asarray(tx, float), np.asarray(ty, float)
    ncx = len(tx) - out.kx - 1
    ncy = len(ty) - out.ky - 1
    out._C = sp.lazify(np.asarray(ref.tck[2], float).reshape(ncx, ncy))
    out._ref = ref
    return out


def bisplrep(x, y, z, w=None, xb=None, xe=None, yb=None, ye=None,
             kx=3, ky=3, task=0, s=None, eps=1e-16, tx=None, ty=None,
             full_output=0, nxest=None, nyest=None, quiet=1):
  _host_notice("bisplrep")
  import scipy.interpolate as _si
  return _si.bisplrep(_asfloat_np(x), _asfloat_np(y), _asfloat_np(z),
                      w=w, xb=xb, xe=xe, yb=yb, ye=ye, kx=kx, ky=ky,
                      task=task, s=s, eps=eps, tx=tx, ty=ty,
                      full_output=full_output, nxest=nxest,
                      nyest=nyest, quiet=quiet)


def bisplev(x, y, tck, dx=0, dy=0):
  """Device tensor-product B-spline grid evaluation (Bx @ C @ By^T)."""
  tx, ty, c, kx, ky = tck
  tx, ty = np.asarray(_np(tx), float), np.asarray(_np(ty), float)
  ncx, ncy = len(tx) - kx - 1, len(ty) - ky - 1
  C = sp.lazify(np.asarray(_np(c), float).reshape(ncx, ncy)
                if not isinstance(c, Expr) else c)
  X, Yq = sp.lazify(x), sp.lazify(y)
  xs, ys = X.shape, Yq.shape
  txj, tyj = jnp.asarray(tx), jnp.asarray(ty)

  def kern(Cc, xv, yv):
    Cc = _f(Cc)
    Bx = _basis_matrix(txj.astype(Cc.dtype), kx,
                       jnp.atleast_1d(jnp.ravel(_f(xv))), nu=dx)
    By = _basis_matrix(tyj.astype(Cc.dtype), ky,
                       jnp.atleast_1d(jnp.ravel(_f(yv))), nu=dy)
    Z = jnp.matmul(jnp.matmul(Bx, Cc, precision="highest"), By.T,
                   precision="highest")
    return Z.reshape(xs + ys) if (xs or ys) else Z.reshape(())

  return sp.map([C, X, Yq], kern)


# =====================================================================
# regular-grid interpolation (device)
# =====================================================================

class RegularGridInterpolator:
  """scipy RegularGridInterpolator — 'linear'/'nearest' are one fused
  2^d-corner gather kernel; 'slinear'/'cubic'/'quintic' precompute the
  tensor-product B-spline coefficient tensor on device (per-axis
  collocation solves) and evaluate with per-axis basis matrices folded
  on the matrix units.  'pchip' is the host boundary (nonlinear per-axis
  estimates, recursive evaluation)."""

  _SPLINE_K = {"slinear": 1, "cubic": 3, "quintic": 5}

  def __init__(self, points, values, method="linear",
               bounds_error=True, fill_value=np.nan, *, solver=None,
               solver_args=None):
    self.grid = tuple(np.asarray(_asfloat_np(p)) for p in points)
    for i, p in enumerate(self.grid):
      if p.ndim != 1 or p.shape[0] < 2:
        raise ValueError(f"points[{i}] must be 1-D with >= 2 points")
      if not (np.diff(p) > 0).all():
        if (np.diff(p) < 0).all():
          raise ValueError("descending grids not supported; flip "
                           "points and values")
        raise ValueError(f"points[{i}] must be strictly ascending")
    V = sp.lazify(values)
    d = len(self.grid)
    if tuple(V.shape[:d]) != tuple(p.shape[0] for p in self.grid):
      raise ValueError("values shape does not match the grid")
    self.values = V
    self.method = method
    self.bounds_error = bounds_error
    self.fill_value = fill_value
    self._d = d
    if method not in ("linear", "nearest", "pchip") and \
       method not in self._SPLINE_K:
      raise ValueError(f"method {method!r} is not defined")
    if method in self._SPLINE_K:
      k = self._SPLINE_K[method]
      for i, p in enumerate(self.grid):
        if p.shape[0] <= k:
          raise ValueError(f"{method} needs > {k} points per axis")

  def _spline_coef_expr(self, k):
    """Tensor-product spline coefficients: solve the 1-D collocation
    system along each grid axis in turn (device dense solves)."""
    grids = self.grid
    d = self._d

    def kern(vv):
      vv = _f(vv)
      C = vv
      for a in range(d):
        t = _default_knots(grids[a], k, None)
        tj = jnp.asarray(t, C.dtype)
        xj = jnp.asarray(grids[a], C.dtype)
        A = _basis_matrix(tj, k, xj)
        Cm = jnp.moveaxis(C, a, 0)
        sol = jnp.linalg.solve(A, Cm.reshape(Cm.shape[0], -1))
        C = jnp.moveaxis(sol.reshape(Cm.shape), 0, a)
      return C
    return sp.map([self.values], kern)

  def __call__(self, xi, method=None, *, nu=None):
    method = self.method if method is None else method
    if method == "pchip":
      _host_notice("RegularGridInterpolator(method='pchip')")
      import scipy.interpolate as _si
      ref = _si.RegularGridInterpolator(
          self.grid, _np(self.values), method="pchip",
          bounds_error=self.bounds_error, fill_value=self.fill_value)
      return ref(_np(xi))
    XI = sp.lazify(xi)
    xshape = XI.shape
    d = self._d
    if d > 1:
      if not xshape or xshape[-1] != d:
        raise ValueError(f"query last dim {xshape[-1] if xshape else 0}"
                         f" != grid ndim {d}")
      qshape = xshape[:-1]
    else:
      qshape = xshape if (not xshape or xshape[-1] != 1) else \
          xshape[:-1]
    grids = self.grid
    fillv = self.fill_value

    if self.bounds_error:
      qc = np.asarray(_np(xi), float).reshape(-1, d) if d > 1 else \
          np.asarray(_np(xi), float).reshape(-1, 1)
      for a in range(d):
        if (qc[:, a] < grids[a][0]).any() or \
           (qc[:, a] > grids[a][-1]).any():
          raise ValueError(f"one of the requested xi is out of bounds "
                           f"in dimension {a}")

    if method in self._SPLINE_K:
      k = self._SPLINE_K[method]
      C = self._spline_coef_expr(k)
      knots = [_default_knots(g, k, None) for g in grids]

      def kern(cc, q):
        cc = _f(cc)
        q = _f(q).reshape(-1, d) if d > 1 else _f(q).reshape(-1, 1)
        nq = q.shape[0]
        R = cc
        # fold axis 0 first with a (nq, nc) matmul, then the rest with
        # batched gathers kept dense (per-query basis rows)
        out = None
        # sequential fold keeping the query dim in front
        Bs = []
        for a in range(d):
          tj = jnp.asarray(knots[a], cc.dtype)
          Bs.append(_basis_matrix(tj, k, q[:, a]))
        R = jnp.einsum("qi,i...->q...", Bs[0], cc)
        for a in range(1, d):
          R = jnp.einsum("qi,qi...->q...", Bs[a], R)
        res = R
        if fillv is not None:
          outside = jnp.zeros((nq,), bool)
          for a in range(d):
            outside |= (q[:, a] < grids[a][0]) | (q[:, a] > grids[a][-1])
          res = jnp.where(
              outside.reshape((nq,) + (1,) * (res.ndim - 1)),
              jnp.asarray(fillv, res.dtype), res)
        return res.reshape(qshape + res.shape[1:])
      return sp.map([C, XI], kern)

    def kern(vv, q):
      vv = _f(vv)
      q = _f(q).reshape(-1, d) if d > 1 else _f(q).reshape(-1, 1)
      nq = q.shape[0]
      idx, frac = [], []
      for a in range(d):
        ga = jnp.asarray(grids[a], vv.dtype)
        na = ga.shape[0]
        ia = jnp.clip(jnp.searchsorted(ga, q[:, a], side="right") - 1,
                      0, na - 2)
        idx.append(ia)
        frac.append((q[:, a] - ga[ia]) / (ga[ia + 1] - ga[ia]))
      if method == "nearest":
        sel = tuple(jnp.where(frac[a] >= 0.5, idx[a] + 1, idx[a])
                    for a in range(d))
        res = vv[sel]
      else:  # linear
        res = 0.0
        for corner in range(2 ** d):
          w = 1.0
          sel = []
          for a in range(d):
            bit = (corner >> a) & 1
            sel.append(idx[a] + bit)
            w = w * (frac[a] if bit else (1.0 - frac[a]))
          wb = w.reshape((nq,) + (1,) * (vv.ndim - d))
          res = res + vv[tuple(sel)] * wb
      if fillv is not None:
        outside = jnp.zeros((nq,), bool)
        for a in range(d):
          outside |= (q[:, a] < grids[a][0]) | (q[:, a] > grids[a][-1])
        res = jnp.where(
            outside.reshape((nq,) + (1,) * (res.ndim - 1)),
            jnp.asarray(fillv, res.dtype), res)
      return res.reshape(qshape + res.shape[1:])
    return sp.map([self.values, XI], kern)


def interpn(points, values, xi, method="linear", bounds_error=True,
            fill_value=np.nan):
  """Multidimensional grid interpolation on device (RGI methods +
  'splinef2d' through the host boundary)."""
  if method == "splinef2d":
    _host_notice("interpn(method='splinef2d')")
    import scipy.interpolate as _si
    return _si.interpn(tuple(np.asarray(_asfloat_np(p))
                             for p in points), _np(values), _np(xi),
                       method="splinef2d", bounds_error=bounds_error,
                       fill_value=fill_value)
  rgi = RegularGridInterpolator(points, values, method=method,
                                bounds_error=bounds_error,
                                fill_value=fill_value)
  return rgi(xi)


# =====================================================================
# scattered N-D interpolation
# =====================================================================

class NearestNDInterpolator:
  """Nearest-neighbour scattered interpolation: one matmul pairwise-
  distance pass + argmin gather (the sp.spatial KDTree brute pattern)."""

  def __init__(self, x, y, rescale=False, tree_options=None):
    self._x = sp.lazify(x)
    self._y = sp.lazify(y)
    if len(self._x.shape) != 2:
      raise ValueError("x must be (n, d)")
    self._rescale = rescale

  def __call__(self, *args):
    if len(args) == 1:
      Q = sp.lazify(args[0])
    else:
      cols = [sp.lazify(a) for a in args]
      Q = sp.map(cols, lambda *cs: jnp.stack(
          [jnp.ravel(_f(c)) for c in cs], axis=-1))
    qshape = Q.shape[:-1]
    resc = self._rescale

    def kern(xx, yy, qq):
      xx, qq = _f(xx), _f(qq).reshape(-1, xx.shape[1])
      if resc:
        lo = xx.min(0)
        span = xx.max(0) - lo
        span = jnp.where(span == 0, 1.0, span)
        xx = (xx - lo) / span
        qq = (qq - lo) / span
      d2 = ((qq * qq).sum(-1)[:, None] + (xx * xx).sum(-1)[None, :]
            - 2.0 * jnp.matmul(qq, xx.T, precision="highest"))
      i = jnp.argmin(d2, axis=1)
      res = yy[i]
      return res.reshape(qshape + res.shape[1:])
    return sp.map([self._x, self._y, Q], kern)


def griddata(points, values, xi, method="linear", fill_value=np.nan,
             rescale=False):
  """Scattered-data interpolation: 'nearest' is the device matmul path;
  'linear'/'cubic' are the Qhull host boundary (simplex walks)."""
  if method == "nearest":
    interp = NearestNDInterpolator(
        np.atleast_2d(_asfloat_np(points)).reshape(
            len(_np(values)), -1), values, rescale=rescale)
    if isinstance(xi, tuple):
      return interp(*xi)
    xia = sp.lazify(xi)
    if len(xia.shape) == 1:
      xia = sp.map([xia], lambda a: _f(a)[:, None])
    return interp(xia)
  _host_notice(f"griddata(method={method!r})")
  import scipy.interpolate as _si
  pts = _np(points) if not isinstance(points, tuple) else \
      tuple(_np(p) for p in points)
  xq = _np(xi) if not isinstance(xi, tuple) else \
      tuple(_np(p) for p in xi)
  return _si.griddata(pts, _np(values), xq, method=method,
                      fill_value=fill_value, rescale=rescale)


# =====================================================================
# RBF interpolation (pure matmul: kernel matrices + dense solve)
# =====================================================================

_RBF_KERNELS = {
    "linear": lambda r: -r,
    "thin_plate_spline": lambda r: jnp.where(
        r == 0, 0.0, r * r * jnp.log(jnp.where(r == 0, 1.0, r))),
    "cubic": lambda r: r ** 3,
    "quintic": lambda r: -r ** 5,
    "multiquadric": lambda r: -jnp.sqrt(r * r + 1.0),
    "inverse_multiquadric": lambda r: 1.0 / jnp.sqrt(r * r + 1.0),
    "inverse_quadratic": lambda r: 1.0 / (r * r + 1.0),
    "gaussian": lambda r: jnp.exp(-r * r),
}

# minimum polynomial degree required for conditional positive
# definiteness (scipy's table)
_RBF_MIN_DEGREE = {
    "linear": 0, "thin_plate_spline": 1, "cubic": 1, "quintic": 2,
    "multiquadric": 0, "inverse_multiquadric": -1,
    "inverse_quadratic": -1, "gaussian": -1,
}
_RBF_SCALE_INVARIANT = {"linear", "thin_plate_spline", "cubic",
                        "quintic"}


def _monomial_powers(d, degree):
  """All exponent tuples with total degree <= degree (static)."""
  import itertools
  out = []
  for total in range(degree + 1):
    for combo in itertools.combinations_with_replacement(
        range(d), total):
      p = [0] * d
      for c in combo:
        p[c] += 1
      out.append(tuple(p))
  return out


def _pdist_mat(a, b):
  d2 = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
        - 2.0 * jnp.matmul(a, b.T, precision="highest"))
  return jnp.sqrt(jnp.maximum(d2, 0.0))


class RBFInterpolator:
  """scipy RBFInterpolator, fully on device: the (n+p)×(n+p) saddle
  system assembles from one matmul pairwise-distance pass and solves with
  ``jnp.linalg.solve``; evaluation is one cross-kernel matmul.
  ``neighbors=`` (local stencils) is the host boundary."""

  def __init__(self, y, d, neighbors=None, smoothing=0.0,
               kernel="thin_plate_spline", epsilon=None, degree=None):
    if neighbors is not None:
      _host_notice("RBFInterpolator(neighbors=...)")
      import scipy.interpolate as _si
      self._host = _si.RBFInterpolator(
          _asfloat_np(y), _asfloat_np(d), neighbors=neighbors,
          smoothing=smoothing, kernel=kernel, epsilon=epsilon,
          degree=degree)
      return
    self._host = None
    if kernel not in _RBF_KERNELS:
      raise ValueError(f"unknown kernel {kernel!r}")
    if epsilon is None:
      if kernel in _RBF_SCALE_INVARIANT:
        epsilon = 1.0
      else:
        raise ValueError(f"epsilon is required for kernel {kernel!r}")
    self.kernel, self.epsilon = kernel, float(epsilon)
    self._Y = sp.lazify(y)
    if len(self._Y.shape) != 2:
      raise ValueError("y must be (n, d)")
    n, ndim = self._Y.shape
    self._D = sp.lazify(d)
    self._dshape = self._D.shape[1:]
    min_deg = _RBF_MIN_DEGREE[kernel]
    if degree is None:
      degree = max(min_deg, 0)
    degree = int(degree)
    if degree < min_deg and degree != -1:
      raise ValueError(f"degree must be >= {min_deg} for {kernel!r}")
    self.degree = degree
    self._powers = [] if degree == -1 else _monomial_powers(ndim, degree)
    npoly = len(self._powers)
    if n < npoly:
      raise ValueError("not enough points for the polynomial tail")
    smo = np.broadcast_to(np.asarray(smoothing, float), (n,)).copy()
    kf = _RBF_KERNELS[kernel]
    eps = self.epsilon
    powers = self._powers

    def kern(yy, dd):
      yy = _f(yy)
      dd = _f(dd).reshape(n, -1)
      K = kf(eps * _pdist_mat(yy, yy)) + jnp.diag(
          jnp.asarray(smo, yy.dtype))
      if npoly:
        # shift/scale the monomial basis for conditioning (scipy does
        # the same; the interpolant is basis-invariant)
        mid = 0.5 * (yy.max(0) + yy.min(0))
        scale = 0.5 * (yy.max(0) - yy.min(0))
        scale = jnp.where(scale == 0, 1.0, scale)
        ys = (yy - mid) / scale
        P = jnp.stack([jnp.prod(ys ** jnp.asarray(p, yy.dtype), -1)
                       for p in powers], axis=1)
        A = jnp.concatenate([
            jnp.concatenate([K, P], axis=1),
            jnp.concatenate([P.T, jnp.zeros((npoly, npoly), yy.dtype)],
                            axis=1)], axis=0)
        rhs = jnp.concatenate(
            [dd, jnp.zeros((npoly, dd.shape[1]), yy.dtype)], axis=0)
      else:
        A, rhs = K, dd
      return jnp.linalg.solve(A, rhs)

    self._coef = sp.map([self._Y, self._D], kern)

  def __call__(self, x):
    if self._host is not None:
      return self._host(_np(x))
    Q = sp.lazify(x)
    qshape = Q.shape[:-1]
    kf = _RBF_KERNELS[self.kernel]
    eps = self.epsilon
    powers = self._powers
    npoly = len(powers)
    n = self._Y.shape[0]
    dshape = self._dshape

    def kern(yy, cc, qq):
      yy, cc = _f(yy), _f(cc)
      qq = _f(qq).reshape(-1, yy.shape[1])
      K = kf(eps * _pdist_mat(qq, yy))
      out = jnp.matmul(K, cc[:n], precision="highest")
      if npoly:
        mid = 0.5 * (yy.max(0) + yy.min(0))
        scale = 0.5 * (yy.max(0) - yy.min(0))
        scale = jnp.where(scale == 0, 1.0, scale)
        qs = (qq - mid) / scale
        P = jnp.stack([jnp.prod(qs ** jnp.asarray(p, yy.dtype), -1)
                       for p in powers], axis=1)
        out = out + jnp.matmul(P, cc[n:], precision="highest")
      return out.reshape(qshape + dshape)
    return sp.map([self._Y, self._coef, Q], kern)


class Rbf:
  """Legacy scipy Rbf — same matmul assembly/solve; default epsilon is
  the scipy average-distance heuristic computed on device."""

  _KERNELS = {
      "multiquadric": lambda r, e: jnp.sqrt((r / e) ** 2 + 1.0),
      "inverse": lambda r, e: 1.0 / jnp.sqrt((r / e) ** 2 + 1.0),
      "inverse_multiquadric":
          lambda r, e: 1.0 / jnp.sqrt((r / e) ** 2 + 1.0),
      "gaussian": lambda r, e: jnp.exp(-(r / e) ** 2),
      "linear": lambda r, e: r,
      "cubic": lambda r, e: r ** 3,
      "quintic": lambda r, e: r ** 5,
      "thin_plate": lambda r, e: jnp.where(
          r == 0, 0.0, r * r * jnp.log(jnp.where(r == 0, 1.0, r))),
  }

  def __init__(self, *args, **kwargs):
    arrays = [sp.lazify(a) for a in args]
    self._X = sp.map(arrays[:-1], lambda *cs: jnp.stack(
        [jnp.ravel(_f(c)) for c in cs], axis=1))
    self._d = arrays[-1]
    self.function = kwargs.pop("function", "multiquadric")
    self.epsilon = kwargs.pop("epsilon", None)
    self.smooth = float(kwargs.pop("smooth", 0.0))
    self.mode = kwargs.pop("mode", "1-D")
    self.norm = kwargs.pop("norm", "euclidean")
    if self.norm != "euclidean":
      raise NotImplementedError("only euclidean norm on device")
    if _py_callable(self.function):
      kf0 = self.function
      kf = lambda r, e: kf0(r)  # noqa: E731  (jax-traceable callable)
    else:
      name = self.function.lower()
      if name not in self._KERNELS:
        raise ValueError(f"unknown Rbf function {self.function!r}")
      kf = self._KERNELS[name]
    self._kf = kf
    n = self._X.shape[0]
    eps_given = self.epsilon
    smooth = self.smooth
    mode = self.mode

    def kern(xx, dd):
      xx, dd = _f(xx), _f(dd)
      r = _pdist_mat(xx, xx)
      if eps_given is None:
        # scipy heuristic: average distance between nodes based on a
        # bounding hypercube
        lo, hi = xx.min(0), xx.max(0)
        edges = hi - lo
        edges = edges[edges > 0] if False else jnp.where(
            edges == 0, 1.0, edges)
        e = jnp.power(jnp.prod(edges) / n, 1.0 / xx.shape[1])
      else:
        e = jnp.asarray(eps_given, xx.dtype)
      A = kf(r, e) - smooth * jnp.eye(n, dtype=xx.dtype)
      rhs = dd.reshape(n, -1) if mode == "1-D" else dd.reshape(n, -1)
      return jnp.linalg.solve(A, rhs), e

    self._coef = sp.map([self._X, self._d], lambda x, d: kern(x, d)[0])
    self._eps = sp.map([self._X, self._d], lambda x, d: kern(x, d)[1])

  def __call__(self, *args):
    pts = [sp.lazify(a) for a in args]
    qshape = pts[0].shape
    kf = self._kf
    dsh = self._d.shape[1:] if self.mode != "1-D" else ()

    def kern(xx, cc, ee, *qs):
      xx, cc = _f(xx), _f(cc)
      qq = jnp.stack([jnp.ravel(_f(q)) for q in qs], axis=1)
      K = kf(_pdist_mat(qq.astype(xx.dtype), xx), ee)
      out = jnp.matmul(K, cc, precision="highest")
      return out.reshape(qshape + dsh)
    return sp.map([self._X, self._coef, self._eps] + pts, kern)

  @property
  def A(self):
    _host_notice("Rbf.A")
    n = self._X.shape[0]
    xx = _np(self._X)
    import scipy.spatial.distance as sd
    r = sd.squareform(sd.pdist(xx))
    e = float(_np(self._eps))
    import numpy as _n
    return _n.asarray(
        jax.device_get(self._kf(jnp.asarray(r), e))) - \
        self.smooth * np.eye(n)


# =====================================================================
# global polynomial interpolators (device)
# =====================================================================

class BarycentricInterpolator:
  """Barycentric Lagrange interpolation (Berrut–Trefethen): weights
  and evaluation in one device kernel (O(n^2) weight pass, O(n·nq)
  eval, capacity-rescaled for overflow safety)."""

  def __init__(self, xi, yi=None, axis=0, *, wi=None, rng=None):
    self._x = sp.lazify(xi)
    if len(self._x.shape) != 1:
      raise ValueError("xi must be 1-D")
    n = self._x.shape[0]
    if wi is not None:
      self._w = sp.lazify(wi)
    else:
      def wk(xx):
        xx = _f(xx)
        scale = 4.0 / (xx.max() - xx.min())
        xs = xx * scale
        diff = xs[:, None] - xs[None, :]
        diff = diff + jnp.eye(n, dtype=xx.dtype)
        # log-space magnitude + sign product for overflow safety
        logw = -jnp.sum(jnp.log(jnp.abs(diff)), axis=1)
        sign = jnp.prod(jnp.sign(diff), axis=1)
        logw = logw - logw.max()
        return sign * jnp.exp(logw)
      self._w = sp.map([self._x], wk)
    self.axis = axis
    self._y = None
    if yi is not None:
      self.set_yi(yi, axis=axis)

  def set_yi(self, yi, axis=None):
    axis = self.axis if axis is None else axis
    Y = sp.lazify(yi)
    if axis % max(len(Y.shape), 1) != 0:
      Y = sp.map([Y], lambda a: jnp.moveaxis(a, axis, 0))
    self._y = Y

  def __call__(self, x):
    if self._y is None:
      raise ValueError("no yi set")
    Q = sp.lazify(x)
    qshape = Q.shape

    def kern(xx, ww, yy, qq):
      xx, ww, yy = _f(xx), _f(ww), _f(yy)
      q = jnp.ravel(_f(qq))
      diff = q[:, None] - xx[None, :]
      exact = diff == 0
      any_exact = exact.any(axis=1)
      safe = jnp.where(exact, 1.0, diff)
      terms = ww[None, :] / safe           # (nq, n)
      denom = terms.sum(axis=1)
      num = jnp.tensordot(terms, yy, axes=(1, 0))
      interp = num / denom.reshape((-1,) + (1,) * (yy.ndim - 1))
      hit = jnp.tensordot(exact.astype(yy.dtype), yy, axes=(1, 0))
      res = jnp.where(any_exact.reshape((-1,) + (1,) * (yy.ndim - 1)),
                      hit, interp)
      return res.reshape(qshape + yy.shape[1:])
    return sp.map([self._x, self._w, self._y, Q], kern)

  def derivative(self, x, der=1):
    _host_notice("BarycentricInterpolator.derivative")
    import scipy.interpolate as _si
    ref = _si.BarycentricInterpolator(_np(self._x), _np(self._y),
                                      axis=0)
    return ref.derivative(_np(x), der=der)


class KroghInterpolator:
  """Hermite/Newton interpolation via a masked divided-difference
  triangle (one fori-style static loop, fully vectorized) + Newton
  Horner evaluation — all device."""

  def __init__(self, xi, yi, axis=0):
    self._x = sp.lazify(xi)
    Y = sp.lazify(yi)
    nd = max(len(Y.shape), 1)
    if axis % nd != 0:
      Y = sp.map([Y], lambda a: jnp.moveaxis(a, axis, 0))
    self._y = Y
    n = self._x.shape[0]
    if n > 64:
      log_info("KroghInterpolator with n=%d: polynomial interpolation "
               "is ill-conditioned beyond ~20 points", n)

    def ck(xx, yy):
      xx, yy = _f(xx), _f(yy)
      # divided differences with Hermite repeats (derivative data):
      # repeated abscissae take the derivative column scipy-style
      coefs = [yy[0]]
      cur = yy
      fact = 1.0
      for j in range(1, n):
        dx = xx[j:] - xx[:-j]
        same = dx == 0
        safe = jnp.where(same, 1.0, dx)
        dxb = safe.reshape((-1,) + (1,) * (yy.ndim - 1))
        fact = fact * j
        diff = (cur[1:] - cur[:-1]) / dxb
        # Hermite case (dx==0) requires derivative inputs; plain data
        # with distinct xi never hits it
        cur = jnp.where(same.reshape((-1,) + (1,) * (yy.ndim - 1)),
                        0.0, diff)
        coefs.append(cur[0])
      return jnp.stack(coefs, axis=0)
    self._c = sp.map([self._x, self._y], ck)
    self._n = n

  def __call__(self, x):
    Q = sp.lazify(x)
    qshape = Q.shape
    n = self._n

    def kern(xx, cc, qq):
      xx, cc = _f(xx), _f(cc)
      q = jnp.ravel(_f(qq))
      res = jnp.broadcast_to(cc[n - 1],
                             (q.shape[0],) + cc.shape[1:]).astype(
          cc.dtype)
      for j in range(n - 2, -1, -1):
        t = (q - xx[j]).reshape((-1,) + (1,) * (cc.ndim - 1))
        res = res * t + cc[j]
      return res.reshape(qshape + cc.shape[1:])
    return sp.map([self._x, self._c, Q], kern)

  def derivative(self, x, der=1):
    return self.derivatives(x, der=der + 1)[der]

  def derivatives(self, x, der=None):
    _host_notice("KroghInterpolator.derivatives")
    import scipy.interpolate as _si
    ref = _si.KroghInterpolator(_np(self._x), _np(self._y), axis=0)
    return ref.derivatives(_np(x), der=der)


class FloaterHormannInterpolator:
  """Floater–Hormann barycentric rational interpolation: the O(n·d)
  weight table is static host metadata; evaluation is the same device
  barycentric kernel."""

  def __init__(self, points, values, *, d=3):
    x = _asfloat_np(points)
    n = x.shape[0]
    d = int(min(d, n - 1))
    w = np.zeros(n)
    for i in range(n):
      lo = max(i - d, 0)
      hi = min(i, n - 1 - d)
      s = 0.0
      for j in range(lo, hi + 1):
        prod = 1.0
        for k in range(j, j + d + 1):
          if k != i:
            prod /= abs(x[i] - x[k])
        s += prod
      w[i] = (-1.0) ** (i - d) * s
    self._b = BarycentricInterpolator(x, values, wi=w)

  def __call__(self, z):
    return self._b(z)


def barycentric_interpolate(xi, yi, x, axis=0, *, der=0, rng=None):
  if der != 0:
    _host_notice("barycentric_interpolate(der!=0)")
    import scipy.interpolate as _si
    return _si.barycentric_interpolate(_np(xi), _np(yi), _np(x),
                                       axis=axis, der=der)
  return BarycentricInterpolator(xi, yi, axis=axis)(x)


def krogh_interpolate(xi, yi, x, der=0, axis=0):
  if der != 0 and der != [0]:
    _host_notice("krogh_interpolate(der!=0)")
    import scipy.interpolate as _si
    return _si.krogh_interpolate(_np(xi), _np(yi), _np(x), der=der,
                                 axis=axis)
  return KroghInterpolator(xi, yi, axis=axis)(x)


def pchip_interpolate(xi, yi, x, der=0, axis=0):
  P = PchipInterpolator(xi, yi, axis=axis)
  if np.isscalar(der) or isinstance(der, int):
    return P(x, nu=der)
  return [P(x, nu=d) for d in der]


# =====================================================================
# N-D piecewise polynomials / tensor B-splines (device evaluation)
# =====================================================================

class NdPPoly:
  """N-D tensor-product power-basis piecewise polynomial: per-axis
  searchsorted + one flattened corner-block gather + nested static
  Horner, all in one device kernel (scipy.interpolate.NdPPoly)."""

  def __init__(self, c, x, extrapolate=None):
    self.x = tuple(np.asarray(_asfloat_np(xa)) for xa in x)
    self.c = sp.lazify(c)
    d = len(self.x)
    cshape = self.c.shape
    self._d = d
    self._ks = tuple(cshape[a] - 1 for a in range(d))
    for a, xa in enumerate(self.x):
      if cshape[d + a] != xa.shape[0] - 1:
        raise ValueError(f"axis {a}: {cshape[d + a]} pieces vs "
                         f"{xa.shape[0] - 1} intervals")
    self.extrapolate = True if extrapolate is None else bool(extrapolate)

  @classmethod
  def construct_fast(cls, c, x, extrapolate=None):
    return cls(c, x, extrapolate=extrapolate)

  def __call__(self, x, nu=None, extrapolate=None):
    extra = self.extrapolate if extrapolate is None else extrapolate
    if nu is None:
      nu = (0,) * self._d
    nu = tuple(int(v) for v in nu)
    Q = sp.lazify(x)
    qshape = Q.shape[:-1] if len(Q.shape) > 1 else ()
    d = self._d
    ks = self._ks
    grids = self.x
    msizes = tuple(g.shape[0] - 1 for g in grids)

    def kern(cc, qq):
      cc = _f(cc)
      q = _f(qq).reshape(-1, d)
      nq = q.shape[0]
      idx, ts = [], []
      for a in range(d):
        ga = jnp.asarray(grids[a], cc.dtype)
        ia = jnp.clip(jnp.searchsorted(ga, q[:, a], side="right") - 1,
                      0, msizes[a] - 2 + 1)
        ia = jnp.clip(ia, 0, msizes[a] - 1)
        idx.append(ia)
        ts.append(q[:, a] - ga[ia])
      # flatten the grid axes of c and gather the per-query blocks
      powers = cc.shape[:d]
      trailing = cc.shape[2 * d:]
      cf = cc.reshape(powers + (-1,) + trailing)
      flat = idx[0]
      for a in range(1, d):
        flat = flat * msizes[a] + idx[a]
      blk = jnp.take(cf, flat, axis=d)  # (k1+1..kd+1, nq, *tr)
      # nested Horner with per-axis derivative factors
      res = blk
      for a in range(d - 1, -1, -1):
        k, nua = ks[a], nu[a]
        t = ts[a].reshape((nq,) + (1,) * (res.ndim - a - 2))
        if nua > k:
          res = jnp.zeros(res.shape[:a] + res.shape[a + 1:],
                          res.dtype)[..., :0].sum(-1) if False else \
              res.sum(axis=a) * 0.0
          continue
        acc = res[(slice(None),) * a + (0,)] * _falling(k, nua)
        for j in range(1, k + 1 - nua):
          acc = acc * t + res[(slice(None),) * a + (j,)] * \
              _falling(k - j, nua)
        res = acc
      if extra is False:
        outside = jnp.zeros((nq,), bool)
        for a in range(d):
          outside |= (q[:, a] < grids[a][0]) | (q[:, a] > grids[a][-1])
        res = jnp.where(
            outside.reshape((nq,) + (1,) * (res.ndim - 1)),
            jnp.nan, res)
      return res.reshape(qshape + trailing)
    return sp.map([self.c, Q], kern)

  def _to_scipy(self):
    import scipy.interpolate as _si
    return _si.NdPPoly(np.asarray(_np(self.c), float), self.x,
                       extrapolate=self.extrapolate)

  def derivative(self, nu):
    _host_notice("NdPPoly.derivative")
    ref = self._to_scipy().derivative(nu)
    return NdPPoly(ref.c, ref.x, extrapolate=ref.extrapolate)

  def antiderivative(self, nu):
    _host_notice("NdPPoly.antiderivative")
    ref = self._to_scipy().antiderivative(nu)
    return NdPPoly(ref.c, ref.x, extrapolate=ref.extrapolate)

  def integrate(self, ranges, extrapolate=None):
    _host_notice("NdPPoly.integrate")
    return self._to_scipy().integrate(ranges, extrapolate=extrapolate)

  def integrate_1d(self, a, b, axis, extrapolate=None):
    _host_notice("NdPPoly.integrate_1d")
    ref = self._to_scipy().integrate_1d(a, b, axis,
                                        extrapolate=extrapolate)
    if isinstance(ref, np.ndarray):
      return ref
    return NdPPoly(ref.c, ref.x, extrapolate=ref.extrapolate)


class NdBSpline:
  """N-D tensor-product B-spline evaluation: per-axis dense basis
  matrices (vmapped one-hot de Boor) folded on the matrix units."""

  def __init__(self, t, c, k, *, extrapolate=None):
    self.t = tuple(np.asarray(_asfloat_np(ta)) for ta in t)
    d = len(self.t)
    self.k = tuple(np.broadcast_to(np.asarray(k, int), (d,)).tolist())
    self.c = sp.lazify(c)
    self._d = d
    self.extrapolate = True if extrapolate is None else bool(extrapolate)
    for a in range(d):
      if self.c.shape[a] != self.t[a].shape[0] - self.k[a] - 1:
        raise ValueError(f"axis {a}: c dim {self.c.shape[a]} != "
                         f"{self.t[a].shape[0] - self.k[a] - 1}")

  def __call__(self, xi, *, nu=None, extrapolate=None):
    extra = self.extrapolate if extrapolate is None else bool(extrapolate)
    if nu is None:
      nu = (0,) * self._d
    nu = tuple(int(v) for v in nu)
    Q = sp.lazify(xi)
    qshape = Q.shape[:-1] if len(Q.shape) > 1 else ()
    d = self._d
    knots, degs = self.t, self.k

    def kern(cc, qq):
      cc = _f(cc)
      q = _f(qq).reshape(-1, d)
      nq = q.shape[0]
      Bs = []
      for a in range(d):
        tj = jnp.asarray(knots[a], cc.dtype)
        Bs.append(_basis_matrix(tj, degs[a], q[:, a], nu=nu[a],
                                extrapolate=True))
      R = jnp.einsum("qi,i...->q...", Bs[0], cc)
      for a in range(1, d):
        R = jnp.einsum("qi,qi...->q...", Bs[a], R)
      if extra is False:
        outside = jnp.zeros((nq,), bool)
        for a in range(d):
          na = knots[a].shape[0] - degs[a] - 1
          outside |= (q[:, a] < knots[a][degs[a]]) | \
              (q[:, a] > knots[a][na])
        R = jnp.where(outside.reshape((nq,) + (1,) * (R.ndim - 1)),
                      jnp.nan, R)
      return R.reshape(qshape + R.shape[1:])
    return sp.map([self.c, Q], kern)

  @classmethod
  def design_matrix(cls, xvals, t, k, extrapolate=True):
    _host_notice("NdBSpline.design_matrix")
    import scipy.interpolate as _si
    return _si.NdBSpline.design_matrix(
        _np(xvals), tuple(np.asarray(_np(ta), float) for ta in t), k,
        extrapolate=extrapolate)


# =====================================================================
# poly1d-returning utilities and the host boundary
# =====================================================================

def lagrange(x, w):
  """Returns np.poly1d (the scipy contract) — host."""
  _host_notice("lagrange")
  import scipy.interpolate as _si
  return _si.lagrange(_asfloat_np(x), _asfloat_np(w))


def pade(an, m, n=None):
  _host_notice("pade")
  import scipy.interpolate as _si
  return _si.pade(_asfloat_np(an), m, n)


def approximate_taylor_polynomial(f, x, degree, scale, order=None):
  _host_notice("approximate_taylor_polynomial")
  import scipy.interpolate as _si
  fn = (lambda v: np.asarray(_np(f(v)))) if _py_callable(f) else f
  return _si.approximate_taylor_polynomial(fn, x, degree, scale,
                                           order=order)


class interp2d:
  """Removed in scipy 1.14 — mirrored error (use RectBivariateSpline
  / RegularGridInterpolator / bisplev)."""

  def __init__(self, *a, **kw):
    raise NotImplementedError(
        "`interp2d` has been removed in SciPy 1.14.0 (mirrored here). "
        "Use RectBivariateSpline for regular grids or "
        "bisplrep/bisplev for scattered 2-D data.")


# host-boundary re-exports: Qhull-based scattered N-D interpolation
# (sequential simplex walks), sphere/scattered FITPACK fits, AAA
# greedy rational approximation — the sp.spatial Qhull convention.
from scipy.interpolate import (  # noqa: E402
    AAA, BivariateSpline, CloughTocher2DInterpolator,
    LinearNDInterpolator, LSQBivariateSpline, LSQSphereBivariateSpline,
    RectSphereBivariateSpline, SmoothBivariateSpline,
    SmoothSphereBivariateSpline)

_HOST_NAMES = [
    # re-exported scipy classes (qhull / FITPACK-surface / rational)
    "AAA", "BivariateSpline", "CloughTocher2DInterpolator",
    "LinearNDInterpolator", "LSQBivariateSpline",
    "LSQSphereBivariateSpline", "RectSphereBivariateSpline",
    "SmoothBivariateSpline", "SmoothSphereBivariateSpline",
    # host fits with device evaluation (the fit is the algorithm)
    "UnivariateSpline", "InterpolatedUnivariateSpline",
    "LSQUnivariateSpline", "RectBivariateSpline",
    "splrep", "splprep", "bisplrep", "sproot", "insert",
    "generate_knots", "make_splrep", "make_splprep",
    "make_smoothing_spline",
    # poly1d-returning utilities
    "lagrange", "pade", "approximate_taylor_polynomial",
    # removed upstream (scipy 1.14); mirrored error stub, runs nothing
    "interp2d",
]

__all__ = sorted(n for n in dir()
                 if not n.startswith("_") and n not in
                 ("annotations", "jax", "jnp", "lax", "np", "sp",
                  "Expr", "log_info"))
