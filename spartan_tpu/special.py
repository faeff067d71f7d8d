"""``sp.special`` — the scipy.special surface, on device.

The reference has no special-function module (beyond-parity surface,
the sp.signal/sp.ndimage pattern).  Special functions are pure
elementwise math — exactly what vector units are built for — so the
design goal is
to keep as much of the namespace as possible on the lazy device path
where it FUSES into surrounding expressions:

* **jax-native core** — every jax.scipy.special lowering (gamma/beta/
  erf/Bessel-I/zeta/hyp/... ~45 names) wrapped as lazy map ops.
* **composition layer** — names scipy implements in Cephes but that
  are exact compositions of the core: ``erfcx`` via ``log_ndtr``
  (no overflow), ``cosm1`` via half-angle, ``powm1`` via expm1∘log,
  ``exprel``, the degree-trig family, ``rgamma``, ``agm`` (fixed-
  iteration AGM loop) and the complete elliptic integrals ``ellipk``/
  ``ellipkm1``/``ellipe`` built on it.
* **device inverses** — ``gammaincinv``/``gammainccinv``/
  ``betaincinv``/``erfcinv``/``kolmogi``/... : fixed-count bisection
  (80 halvings, data-independent — compiler-friendly) + a short
  Newton polish using the closed-form derivative.  These power every
  distribution ``ppf`` in ``sp.stats``.
* **distribution-CDF family** — ``stdtr``/``chdtr``/``fdtr``/
  ``pdtr``/``bdtr``/``nbdtr``/``gdtr`` (+ ``*c`` complements and
  ``*i`` inverses) as exact betainc/gammainc identities, and the
  ``kolmogorov`` alternating series.
* **orthogonal polynomial evaluation** — ``eval_legendre``/
  ``eval_chebyt``/... by the three-term recurrence, unrolled over the
  static integer degree.
* **host boundary** — everything else (Struve, Mathieu, Airy zeros,
  incomplete elliptic, exact combinatorics, ...) auto-wraps the
  scipy.special call with the once-per-process notice
  (the ``sp.linalg.eig`` convention); ``_HOST_NAMES`` is the single
  source of truth the parity audit reads.

Reference parity: the spartan reference exposes no special functions;
SURVEY.md §2.5 'broader demo set' motivates the beyond-parity scipy
surfaces.
"""

from __future__ import annotations

import inspect as _inspect

import jax
import jax.numpy as jnp
import jax.scipy.special as _jss
import numpy as np
import scipy.special as _ss

import spartan_tpu as sp
from spartan_tpu.expr.base import Expr
from spartan_tpu.util import log_info

_py_callable = callable


def _f(x):
  """Promote integer/bool operands to the mesh float (scipy promotes
  ints to float64; x64-off canonicalizes to f32)."""
  x = jnp.asarray(x)
  if jnp.issubdtype(x.dtype, jnp.inexact):
    return x
  return x.astype(jnp.float64 if jax.config.jax_enable_x64
                  else jnp.float32)


def _mapn(kern, *args):
  return sp.map([sp.lazify(a) for a in args], kern)


def _direct(jfn, name, nargs, doc):
  if nargs == 1:
    def op(x):
      return _mapn(lambda xx: jfn(_f(xx)), x)
  elif nargs == 2:
    def op(a, b):
      return _mapn(lambda aa, bb: jfn(_f(aa), _f(bb)), a, b)
  else:
    def op(a, b, c):
      return _mapn(lambda aa, bb, cc: jfn(_f(aa), _f(bb), _f(cc)),
                   a, b, c)
  op.__name__ = name
  op.__doc__ = doc
  return op


# ---------------------------------------------------------------------
# jax-native core (lazy wraps of jax.scipy.special lowerings)
# ---------------------------------------------------------------------

_JAX_DIRECT = {
    # name: (jax fn, nargs)
    "gamma": (_jss.gamma, 1), "gammaln": (_jss.gammaln, 1),
    "gammasgn": (_jss.gammasgn, 1), "digamma": (_jss.digamma, 1),
    "psi": (_jss.digamma, 1),
    "gammainc": (_jss.gammainc, 2), "gammaincc": (_jss.gammaincc, 2),
    "beta": (_jss.beta, 2), "betaln": (_jss.betaln, 2),
    "betainc": (_jss.betainc, 3),
    "erf": (_jss.erf, 1), "erfc": (_jss.erfc, 1),
    "erfinv": (_jss.erfinv, 1),
    "ndtr": (_jss.ndtr, 1), "ndtri": (_jss.ndtri, 1),
    "log_ndtr": (_jss.log_ndtr, 1),
    "expit": (_jss.expit, 1), "logit": (_jss.logit, 1),
    "entr": (_jss.entr, 1), "rel_entr": (_jss.rel_entr, 2),
    "kl_div": (_jss.kl_div, 2),
    "xlogy": (_jss.xlogy, 2), "xlog1py": (_jss.xlog1py, 2),
    "exp1": (_jss.exp1, 1), "expi": (_jss.expi, 1),
    "expn": (_jss.expn, 2),
    "i0": (_jss.i0, 1), "i0e": (_jss.i0e, 1),
    "i1": (_jss.i1, 1), "i1e": (_jss.i1e, 1),
    "zeta": (_jss.zeta, 2),
    "poch": (_jss.poch, 2),
    "hyp1f1": (_jss.hyp1f1, 3), "hyp2f1": (_jss.hyp2f1, 4),
    "spence": (_jss.spence, 1),
    "polygamma": (_jss.polygamma, 2),
}


def multigammaln(a, d):
  """Log multivariate gamma; ``d`` is a static int (jax contract)."""
  d = int(d)
  return _mapn(lambda aa: _jss.multigammaln(_f(aa), d), a)

for _n, (_fn, _na) in _JAX_DIRECT.items():
  if _na == 4:
    def _op4(a, b, c, x, _fn=_fn):
      return _mapn(lambda aa, bb, cc, xx:
                   _fn(_f(aa), _f(bb), _f(cc), _f(xx)), a, b, c, x)
    _op4.__name__ = _n
    _op4.__doc__ = f"Lazy elementwise scipy.special.{_n} (jax lowering)."
    globals()[_n] = _op4
  else:
    globals()[_n] = _direct(
        _fn, _n, _na,
        f"Lazy elementwise scipy.special.{_n} (jax lowering).")


def logsumexp(a, axis=None, b=None, keepdims=False, return_sign=False):
  """Lazy logsumexp (jax lowering; f64-stable reduction on device)."""
  ops = [sp.lazify(a)] + ([sp.lazify(b)] if b is not None else [])

  def kern(aa, *bb):
    return _jss.logsumexp(_f(aa), axis=axis,
                          b=(_f(bb[0]) if bb else None),
                          keepdims=keepdims, return_sign=return_sign)
  return sp.map(ops, kern)


def softmax(x, axis=None):
  """Lazy softmax along ``axis`` (jax lowering)."""
  return _mapn(lambda xx: _jss.softmax(_f(xx), axis=axis), x)


def log_softmax(x, axis=None):
  """Lazy log_softmax along ``axis`` (jax lowering)."""
  return _mapn(lambda xx: _jss.log_softmax(_f(xx), axis=axis), x)


def fresnel(x):
  """Fresnel integrals (S, C) — jax lowering, two lazy outputs."""
  X = sp.lazify(x)
  return (sp.map([X], lambda xx: _jss.fresnel(_f(xx))[0]),
          sp.map([X], lambda xx: _jss.fresnel(_f(xx))[1]))


def sici(x):
  """Sine/cosine integrals (Si, Ci) — jax lowering."""
  X = sp.lazify(x)
  return (sp.map([X], lambda xx: _jss.sici(_f(xx))[0]),
          sp.map([X], lambda xx: _jss.sici(_f(xx))[1]))


def jn(n, x):
  """Integer-order Bessel J_n via jax's recurrence lowering (the
  ``v=n`` row of ``bessel_jn``).  ``n`` must be a static int."""
  n = int(n)
  return _mapn(lambda xx: _jss.bessel_jn(_f(xx), v=max(n, 1))[n], x)


def j0(x):
  """Bessel J_0 (jax ``bessel_jn`` recurrence)."""
  return jn(0, x)


def j1(x):
  """Bessel J_1 (jax ``bessel_jn`` recurrence)."""
  return jn(1, x)


def factorial(n, exact=False):
  """n! — device Γ(n+1) for ``exact=False``; exact ints route host."""
  if exact:
    return _host_call("factorial", n, exact=True)
  return _mapn(lambda nn: _jss.factorial(_f(nn)), n)


def sph_harm_y(n, m, theta, phi, *, diff_n=0):
  """Spherical harmonics (jax lowering; complex)."""
  if diff_n != 0:
    return _host_call("sph_harm_y", n, m, theta, phi, diff_n=diff_n)

  def kern(nn, mm, tt, pp):
    return _jss.sph_harm_y(jnp.asarray(nn, jnp.int32).ravel(),
                           jnp.asarray(mm, jnp.int32).ravel(),
                           _f(tt).ravel(), _f(pp).ravel()
                           ).reshape(jnp.broadcast_shapes(
                               jnp.shape(nn), jnp.shape(mm),
                               jnp.shape(tt), jnp.shape(pp)))
  return _mapn(kern, n, m, theta, phi)


# ---------------------------------------------------------------------
# composition layer (exact identities over the core)
# ---------------------------------------------------------------------

_LN2 = float(np.log(2.0))


def erfcx(x):
  """Scaled complementary error function exp(x²)·erfc(x): the
  log_ndtr identity below x=12 (no erfc underflow), the divergent
  asymptotic series 1/(x√π)·Σ(-1)^k (2k-1)!!/(2x²)^k above it
  (log_ndtr's deep tail carries ~3e-9 relative noise; 10 series
  terms saturate f64 for x ≥ 12)."""
  def kern(xx):
    xx = _f(xx)
    core = jnp.exp(xx ** 2 + _LN2
                   + _jss.log_ndtr(-np.sqrt(2.0) * xx))
    xs = jnp.maximum(xx, 12.0)
    inv2x2 = 1.0 / (2.0 * xs * xs)
    s = jnp.ones_like(xs)
    term = jnp.ones_like(xs)
    for k in range(1, 11):
      term = term * (-(2 * k - 1)) * inv2x2
      s = s + term
    tail = s / (xs * np.sqrt(np.pi))
    return jnp.where(xx >= 12.0, tail, core)
  return _mapn(kern, x)


def erfcinv(y):
  """Inverse of erfc: -ndtri(y/2)/√2 (exact tail identity)."""
  return _mapn(lambda yy: -_jss.ndtri(_f(yy) / 2) / np.sqrt(2.0), y)


def rgamma(x):
  """1/Γ(x) via gammasgn·exp(-gammaln) (finite everywhere)."""
  return _mapn(lambda xx: _jss.gammasgn(_f(xx))
               * jnp.exp(-_jss.gammaln(_f(xx))), x)


def cosm1(x):
  """cos(x) - 1 without cancellation: -2·sin²(x/2)."""
  return _mapn(lambda xx: -2.0 * jnp.sin(_f(xx) / 2) ** 2, x)


def powm1(x, y):
  """x**y - 1 without cancellation: expm1(y·log x) on the smooth
  branch, direct power elsewhere (negative x / exact zeros)."""
  def kern(xx, yy):
    xx, yy = _f(xx), _f(yy)
    safe = xx > 0
    smooth = jnp.expm1(yy * jnp.log(jnp.where(safe, xx, 1.0)))
    return jnp.where(safe, smooth, xx ** yy - 1.0)
  return _mapn(kern, x, y)


def exprel(x):
  """(exp(x)-1)/x with the x→0 limit handled."""
  def kern(xx):
    xx = _f(xx)
    tiny = jnp.abs(xx) < jnp.finfo(xx.dtype).eps
    return jnp.where(tiny, 1.0 + xx / 2,
                     jnp.expm1(xx) / jnp.where(tiny, 1.0, xx))
  return _mapn(kern, x)


def exp2(x):
  """2**x (lazy)."""
  return _mapn(lambda xx: jnp.exp2(_f(xx)), x)


def exp10(x):
  """10**x (lazy)."""
  return _mapn(lambda xx: 10.0 ** _f(xx), x)


def cbrt(x):
  """Real cube root (lazy)."""
  return _mapn(lambda xx: jnp.cbrt(_f(xx)), x)


def log1p(x):
  """log(1+x) (lazy)."""
  return _mapn(lambda xx: jnp.log1p(_f(xx)), x)


def expm1(x):
  """exp(x)-1 (lazy)."""
  return _mapn(lambda xx: jnp.expm1(_f(xx)), x)


def log_expit(x):
  """log(expit(x)) = -softplus(-x) (stable)."""
  return _mapn(lambda xx: -jax.nn.softplus(-_f(xx)), x)


def logaddexp(a, b):
  """Stable log(e^a + e^b) (lazy)."""
  return _mapn(lambda aa, bb: jnp.logaddexp(_f(aa), _f(bb)), a, b)


def softplus(x):
  """log(1 + e^x) (lazy, stable)."""
  return _mapn(lambda xx: jax.nn.softplus(_f(xx)), x)


def huber(delta, r):
  """Huber loss (scipy convention: 0.5r² core, δ(|r|-δ/2) tails)."""
  def kern(dd, rr):
    dd, rr = _f(dd), _f(rr)
    a = jnp.abs(rr)
    out = jnp.where(a <= dd, 0.5 * rr * rr, dd * (a - 0.5 * dd))
    return jnp.where(dd < 0, jnp.inf, out)
  return _mapn(kern, delta, r)


def pseudo_huber(delta, r):
  """Smooth Huber: δ²(√(1+(r/δ)²) - 1)."""
  def kern(dd, rr):
    dd, rr = _f(dd), _f(rr)
    return dd ** 2 * (jnp.sqrt(1.0 + (rr / dd) ** 2) - 1.0)
  return _mapn(kern, delta, r)


def boxcox(x, lmbda):
  """Box-Cox transform (λ→0 limit = log x)."""
  def kern(xx, ll):
    xx, ll = _f(xx), _f(ll)
    small = jnp.abs(ll) < 1e-30
    return jnp.where(small, jnp.log(xx),
                     jnp.expm1(ll * jnp.log(xx))
                     / jnp.where(small, 1.0, ll))
  return _mapn(kern, x, lmbda)


def boxcox1p(x, lmbda):
  """Box-Cox of 1+x (log1p-stable)."""
  def kern(xx, ll):
    xx, ll = _f(xx), _f(ll)
    small = jnp.abs(ll) < 1e-30
    return jnp.where(small, jnp.log1p(xx),
                     jnp.expm1(ll * jnp.log1p(xx))
                     / jnp.where(small, 1.0, ll))
  return _mapn(kern, x, lmbda)


def inv_boxcox(y, lmbda):
  """Inverse Box-Cox."""
  def kern(yy, ll):
    yy, ll = _f(yy), _f(ll)
    small = jnp.abs(ll) < 1e-30
    return jnp.where(small, jnp.exp(yy),
                     jnp.exp(jnp.log1p(ll * yy)
                             / jnp.where(small, 1.0, ll)))
  return _mapn(kern, y, lmbda)


def inv_boxcox1p(y, lmbda):
  """Inverse Box-Cox of 1+x."""
  def kern(yy, ll):
    yy, ll = _f(yy), _f(ll)
    small = jnp.abs(ll) < 1e-30
    return jnp.where(small, jnp.expm1(yy),
                     jnp.expm1(jnp.log1p(ll * yy)
                               / jnp.where(small, 1.0, ll)))
  return _mapn(kern, y, lmbda)


def sindg(x):
  """sin of degrees (exact multiples handled by the radian map)."""
  return _mapn(lambda xx: jnp.sin(jnp.deg2rad(_f(xx))), x)


def cosdg(x):
  """cos of degrees."""
  return _mapn(lambda xx: jnp.cos(jnp.deg2rad(_f(xx))), x)


def tandg(x):
  """tan of degrees."""
  return _mapn(lambda xx: jnp.tan(jnp.deg2rad(_f(xx))), x)


def cotdg(x):
  """cot of degrees."""
  return _mapn(lambda xx: 1.0 / jnp.tan(jnp.deg2rad(_f(xx))), x)


def radian(d, m, s):
  """Radians from (degrees, minutes, seconds)."""
  return _mapn(lambda dd, mm, ss:
               jnp.deg2rad(_f(dd) + _f(mm) / 60.0 + _f(ss) / 3600.0),
               d, m, s)


def diric(x, n):
  """Dirichlet (periodic sinc) kernel sin(nx/2)/(n sin(x/2)) with the
  removable singularities at x = 2πk filled by the limit ±1."""
  n = int(n)

  def kern(xx):
    xx = _f(xx)
    half = xx / 2
    s = jnp.sin(half)
    near = jnp.abs(s) < 1e-9
    lim = jnp.sign(jnp.cos(half) ** (n + 1)) + jnp.zeros_like(xx)
    val = jnp.sin(n * half) / (n * jnp.where(near, 1.0, s))
    return jnp.where(near, lim, val)
  return _mapn(kern, x)


def agm(a, b):
  """Arithmetic-geometric mean — fixed 40-iteration contraction
  (quadratic convergence: 40 is far past f64 saturation)."""
  def kern(aa, bb):
    aa, bb = _f(aa), _f(bb)

    def body(i, c):
      x, y = c
      return ((x + y) / 2, jnp.sqrt(x * y))
    x, y = jax.lax.fori_loop(0, 40, body, (aa, bb))
    return (x + y) / 2
  return _mapn(kern, a, b)


def _agm_scan(m):
  """AGM iteration capturing the c_n sequence (for ellipe).

  Returns (agm value, Σ 2^{n-1} c_n²) for K and E of parameter m."""
  a0 = jnp.ones_like(m)
  b0 = jnp.sqrt(1.0 - m)
  ssum = 0.5 * m

  def body(i, c):
    a, b, s = c
    an = (a + b) / 2
    cn = (a - b) / 2
    s = s + (2.0 ** i) * cn ** 2 / 2.0
    return (an, jnp.sqrt(a * b), s)
  a, b, s = jax.lax.fori_loop(1, 42, body, (a0, b0, ssum))
  return a, s


def ellipk(m):
  """Complete elliptic integral K(m) = π/(2·AGM(1, √(1-m)))."""
  def kern(mm):
    mm = _f(mm)
    a, _ = _agm_scan(mm)
    out = np.pi / (2 * a)
    return jnp.where(mm == 1.0, jnp.inf, out)
  return _mapn(kern, m)


def ellipkm1(p):
  """K(1-p), accurate near m=1: AGM on b=√p directly."""
  def kern(pp):
    pp = _f(pp)

    def body(i, c):
      x, y = c
      return ((x + y) / 2, jnp.sqrt(x * y))
    x, y = jax.lax.fori_loop(0, 42, body,
                             (jnp.ones_like(pp), jnp.sqrt(pp)))
    return jnp.where(pp == 0.0, jnp.inf, np.pi / (x + y))
  return _mapn(kern, p)


def ellipe(m):
  """Complete elliptic integral E(m) via the AGM c_n sum:
  E = K·(1 - Σ 2^{n-1} c_n²)."""
  def kern(mm):
    mm = _f(mm)
    a, s = _agm_scan(mm)
    out = (np.pi / (2 * a)) * (1.0 - s)
    return jnp.where(mm == 1.0, jnp.ones_like(out), out)
  return _mapn(kern, m)


# ---------------------------------------------------------------------
# device inverses (fixed-count bisection + Newton polish)
# ---------------------------------------------------------------------

def _bisect(f, y, lo, hi, iters=80):
  """Solve f(x) = y for f increasing in x on [lo, hi] — fixed-count
  halving (data-independent trip count: one fused XLA loop)."""
  def body(i, c):
    lo, hi = c
    mid = (lo + hi) / 2
    gt = f(mid) >= y
    return (jnp.where(gt, lo, mid), jnp.where(gt, mid, hi))
  lo = jnp.broadcast_to(lo, jnp.shape(y)).astype(y.dtype)
  hi = jnp.broadcast_to(hi, jnp.shape(y)).astype(y.dtype)
  lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
  return (lo + hi) / 2


def _gammainc_solve(a, y, qside):
  # Bisect in u = log x: 90 halvings of the ~715-wide log domain give
  # machine-exact RELATIVE precision down to x ~ 3e-308 (linear-space
  # bisection capped tiny-x results at its absolute resolution ~1e-22).
  # qside solves the DECREASING complement Q(a, x) = y — resolving the
  # upper tail where P saturates at 1 - eps.
  hi = jnp.log(a + 60.0 * jnp.sqrt(a) + 745.0)  # Q reaches ~5e-324
  lo = jnp.full_like(a, -708.0)
  if qside:
    u = _bisect(lambda uu: -_jss.gammaincc(a, jnp.exp(uu)), -y, lo, hi,
                iters=90)
  else:
    u = _bisect(lambda uu: _jss.gammainc(a, jnp.exp(uu)), y, lo, hi,
                iters=90)
  return jnp.exp(u)


def _gammaincinv_kern(a, y):
  a, y = jnp.broadcast_arrays(a, y)
  xp = _gammainc_solve(a, y, False)
  xq = _gammainc_solve(a, 1.0 - y, True)
  x = jnp.where(y <= 0.5, xp, xq)
  return jnp.where((y <= 0), 0.0, jnp.where(y >= 1, jnp.inf, x))


def _gammainccinv_kern(a, q):
  a, q = jnp.broadcast_arrays(a, q)
  xq = _gammainc_solve(a, q, True)
  xp = _gammainc_solve(a, 1.0 - q, False)
  x = jnp.where(q <= 0.5, xq, xp)
  return jnp.where((q >= 1), 0.0, jnp.where(q <= 0, jnp.inf, x))


def gammaincinv(a, y):
  """Inverse of the regularized lower incomplete gamma P(a, ·) —
  80-step bisection + Newton polish, one fused device loop."""
  return _mapn(lambda aa, yy: _gammaincinv_kern(_f(aa), _f(yy)), a, y)


def gammainccinv(a, y):
  """Inverse of Q(a, ·) — solved on the complement side (tail-exact
  for tiny y, where 1-y would saturate)."""
  return _mapn(lambda aa, yy: _gammainccinv_kern(_f(aa), _f(yy)),
               a, y)


def _betaincinv_left(a, b, y):
  u = _bisect(lambda uu: _jss.betainc(a, b, jnp.exp(uu)), y,
              jnp.full_like(y, -708.0), jnp.zeros_like(y), iters=90)
  return jnp.exp(u)


def _betaincinv_kern(a, b, y):
  # Two mirrored log-space bisections (I_x(a,b) = 1 - I_{1-x}(b,a)):
  # the left solve is machine-exact for x→0, the mirror for x→1;
  # select by which tail y lives in.  Fixed trip counts, one kernel.
  a, b, y = jnp.broadcast_arrays(a, b, y)
  xl = _betaincinv_left(a, b, y)
  xr = 1.0 - _betaincinv_left(b, a, 1.0 - y)
  x = jnp.where(y <= 0.5, xl, xr)
  return jnp.where(y <= 0, 0.0, jnp.where(y >= 1, 1.0, x))


def betaincinv(a, b, y):
  """Inverse regularized incomplete beta — bisection + Newton."""
  return _mapn(lambda aa, bb, yy:
               _betaincinv_kern(_f(aa), _f(bb), _f(yy)), a, b, y)


def betainccinv(a, b, y):
  """Inverse of the complemented incomplete beta."""
  return _mapn(lambda aa, bb, yy:
               _betaincinv_kern(_f(aa), _f(bb), 1.0 - _f(yy)), a, b, y)


def _kolmogorov_kern(x):
  k = jnp.arange(1, 101, dtype=x.dtype)
  terms = jnp.where(k % 2 == 1, 1.0, -1.0) \
      * jnp.exp(-2.0 * (k ** 2) * (x[..., None] ** 2))
  out = 2.0 * terms.sum(-1)
  return jnp.clip(jnp.where(x <= 0, 1.0, out), 0.0, 1.0)


def kolmogorov(x):
  """Kolmogorov distribution survival fn (100-term alternating
  series — saturates f64 for x ≳ 0.04; below that the value is 1)."""
  return _mapn(lambda xx: _kolmogorov_kern(_f(xx)), x)


def kolmogi(p):
  """Inverse of ``kolmogorov`` (decreasing) — bisection on [0, 20]."""
  def kern(pp):
    pp = _f(pp)
    x = _bisect(lambda xx: -_kolmogorov_kern(xx), -pp,
                jnp.zeros_like(pp), jnp.full_like(pp, 20.0))
    return x
  return _mapn(kern, p)


# ---------------------------------------------------------------------
# distribution-CDF family (betainc/gammainc identities)
# ---------------------------------------------------------------------

def _stdtr_kern(df, t):
  df, t = jnp.broadcast_arrays(df, t)
  ib = _jss.betainc(df / 2, jnp.asarray(0.5, df.dtype),
                    df / (df + t ** 2))
  return jnp.where(t >= 0, 1.0 - 0.5 * ib, 0.5 * ib)


def stdtr(df, t):
  """Student t CDF via the incomplete beta identity."""
  return _mapn(lambda dd, tt: _stdtr_kern(_f(dd), _f(tt)), df, t)


def stdtrit(df, p):
  """Student t PPF (inverse of ``stdtr``)."""
  def kern(dd, pp):
    dd, pp = jnp.broadcast_arrays(_f(dd), _f(pp))
    q = 2.0 * jnp.minimum(pp, 1.0 - pp)
    xb = _betaincinv_kern(dd / 2, jnp.full_like(dd, 0.5), q)
    t = jnp.sqrt(dd * (1.0 - xb) / jnp.maximum(xb, 1e-300))
    return jnp.where(pp >= 0.5, t, -t)
  return _mapn(kern, df, p)


def chdtr(v, x):
  """χ² CDF = P(v/2, x/2)."""
  return _mapn(lambda vv, xx: _jss.gammainc(_f(vv) / 2, _f(xx) / 2),
               v, x)


def chdtrc(v, x):
  """χ² survival = Q(v/2, x/2)."""
  return _mapn(lambda vv, xx: _jss.gammaincc(_f(vv) / 2, _f(xx) / 2),
               v, x)


def chdtri(v, p):
  """Inverse χ² survival: x with chdtrc(v, x) = p."""
  return _mapn(lambda vv, pp:
               2.0 * _gammainccinv_kern(_f(vv) / 2, _f(pp)), v, p)


def fdtr(dfn, dfd, x):
  """F CDF via the incomplete beta identity."""
  def kern(a, b, xx):
    a, b, xx = _f(a), _f(b), _f(xx)
    return _jss.betainc(a / 2, b / 2, a * xx / (a * xx + b))
  return _mapn(kern, dfn, dfd, x)


def fdtrc(dfn, dfd, x):
  """F survival (complement form, no cancellation)."""
  def kern(a, b, xx):
    a, b, xx = _f(a), _f(b), _f(xx)
    return _jss.betainc(b / 2, a / 2, b / (b + a * xx))
  return _mapn(kern, dfn, dfd, x)


def fdtri(dfn, dfd, p):
  """F PPF (inverse of ``fdtr``)."""
  def kern(a, b, pp):
    a, b, pp = jnp.broadcast_arrays(_f(a), _f(b), _f(pp))
    w = _betaincinv_kern(a / 2, b / 2, pp)
    return b * w / (a * jnp.maximum(1.0 - w, 1e-300))
  return _mapn(kern, dfn, dfd, p)


def pdtr(k, m):
  """Poisson CDF = Q(⌊k⌋+1, m)."""
  return _mapn(lambda kk, mm:
               _jss.gammaincc(jnp.floor(_f(kk)) + 1, _f(mm)), k, m)


def pdtrc(k, m):
  """Poisson survival = P(⌊k⌋+1, m)."""
  return _mapn(lambda kk, mm:
               _jss.gammainc(jnp.floor(_f(kk)) + 1, _f(mm)), k, m)


def pdtri(k, p):
  """Poisson PPF in m: m with pdtr(k, m) = p."""
  return _mapn(lambda kk, pp:
               _gammainccinv_kern(jnp.floor(_f(kk)) + 1, _f(pp)),
               k, p)


def bdtr(k, n, p):
  """Binomial CDF via betainc(n-k, k+1, 1-p)."""
  def kern(kk, nn, pp):
    kk, nn, pp = jnp.broadcast_arrays(_f(kk), _f(nn), _f(pp))
    kk = jnp.floor(kk)
    full = kk >= nn
    out = _jss.betainc(jnp.maximum(nn - kk, 1e-30), kk + 1, 1.0 - pp)
    return jnp.where(full, 1.0, jnp.where(kk < 0, 0.0, out))
  return _mapn(kern, k, n, p)


def bdtrc(k, n, p):
  """Binomial survival via betainc(k+1, n-k, p)."""
  def kern(kk, nn, pp):
    kk, nn, pp = jnp.broadcast_arrays(_f(kk), _f(nn), _f(pp))
    kk = jnp.floor(kk)
    out = _jss.betainc(kk + 1, jnp.maximum(nn - kk, 1e-30), pp)
    return jnp.where(kk >= nn, 0.0, jnp.where(kk < 0, 1.0, out))
  return _mapn(kern, k, n, p)


def bdtri(k, n, y):
  """Binomial inverse in p: p with bdtr(k, n, p) = y."""
  def kern(kk, nn, yy):
    kk, nn, yy = jnp.broadcast_arrays(_f(kk), _f(nn), _f(yy))
    kk = jnp.floor(kk)
    return 1.0 - _betaincinv_kern(jnp.maximum(nn - kk, 1e-30),
                                  kk + 1, yy)
  return _mapn(kern, k, n, y)


def nbdtr(k, n, p):
  """Negative-binomial CDF = betainc(n, k+1, p)."""
  return _mapn(lambda kk, nn, pp:
               _jss.betainc(_f(nn), jnp.floor(_f(kk)) + 1, _f(pp)),
               k, n, p)


def nbdtrc(k, n, p):
  """Negative-binomial survival = betainc(k+1, n, 1-p)."""
  return _mapn(lambda kk, nn, pp:
               _jss.betainc(jnp.floor(_f(kk)) + 1, _f(nn),
                            1.0 - _f(pp)), k, n, p)


def nbdtri(k, n, y):
  """Negative-binomial inverse in p."""
  return _mapn(lambda kk, nn, yy:
               _betaincinv_kern(_f(nn), jnp.floor(_f(kk)) + 1, _f(yy)),
               k, n, y)


def gdtr(a, b, x):
  """Gamma CDF P(b, a·x)."""
  return _mapn(lambda aa, bb, xx:
               _jss.gammainc(_f(bb), _f(aa) * _f(xx)), a, b, x)


def gdtrc(a, b, x):
  """Gamma survival Q(b, a·x)."""
  return _mapn(lambda aa, bb, xx:
               _jss.gammaincc(_f(bb), _f(aa) * _f(xx)), a, b, x)


def gdtrix(a, b, p):
  """Gamma PPF in x: x with gdtr(a, b, x) = p."""
  return _mapn(lambda aa, bb, pp:
               _gammaincinv_kern(_f(bb), _f(pp)) / _f(aa), a, b, p)


# ---------------------------------------------------------------------
# combinatorics (Γ-based device forms; exact ints route host)
# ---------------------------------------------------------------------

def binom(x, y):
  """Generalized binomial coefficient Γ-identity (sign-correct via
  gammasgn products)."""
  def kern(xx, yy):
    xx, yy = _f(xx), _f(yy)
    lg = (_jss.gammaln(xx + 1) - _jss.gammaln(yy + 1)
          - _jss.gammaln(xx - yy + 1))
    sg = (_jss.gammasgn(xx + 1) * _jss.gammasgn(yy + 1)
          * _jss.gammasgn(xx - yy + 1))
    return sg * jnp.exp(lg)
  return _mapn(kern, x, y)


def comb(N, k, *, exact=False, repetition=False):
  """Combinations C(N, k); ``exact=True`` routes host (bigint)."""
  if exact:
    return _host_call("comb", N, k, exact=True, repetition=repetition)

  def kern(nn, kk):
    nn, kk = jnp.broadcast_arrays(_f(nn), _f(kk))
    if repetition:
      nn, kk = nn + kk - 1, kk
    ok = (kk >= 0) & (kk <= nn)
    out = jnp.exp(_jss.gammaln(nn + 1) - _jss.gammaln(kk + 1)
                  - _jss.gammaln(nn - kk + 1))
    return jnp.where(ok, out, 0.0)
  return _mapn(kern, N, k)


def perm(N, k, exact=False):
  """Permutations P(N, k); ``exact=True`` routes host."""
  if exact:
    return _host_call("perm", N, k, exact=True)

  def kern(nn, kk):
    nn, kk = jnp.broadcast_arrays(_f(nn), _f(kk))
    ok = (kk >= 0) & (kk <= nn)
    out = jnp.exp(_jss.gammaln(nn + 1) - _jss.gammaln(nn - kk + 1))
    return jnp.where(ok, out, 0.0)
  return _mapn(kern, N, k)


def factorial2(n, exact=False):
  """Double factorial n!! (Γ identity; exact ints route host)."""
  if exact:
    return _host_call("factorial2", n, exact=True)

  def kern(nn):
    nn = _f(nn)
    half = nn / 2
    even = jnp.exp(half * _LN2 + _jss.gammaln(half + 1))
    odd = jnp.exp(_jss.gammaln(nn + 2) - _jss.gammaln(nn / 2 + 1.5)
                  - ((nn + 1) / 2) * _LN2)
    out = jnp.where(jnp.floor(nn) % 2 == 0, even, odd)
    return jnp.where(nn < 0, jnp.where(nn == -1, 1.0, 0.0), out)
  return _mapn(kern, n)


def zetac(x):
  """ζ(x) - 1 (device; underflows to 0 past x≈53 where scipy keeps
  denormal-range precision — the series regime)."""
  return _mapn(lambda xx: _jss.zeta(_f(xx), 1.0) - 1.0, x)


# ---------------------------------------------------------------------
# orthogonal polynomial evaluation (three-term recurrences over the
# static integer degree — unrolled, fuses into one kernel)
# ---------------------------------------------------------------------

def _recurrence(n, x0, x1_fn, step, x):
  """Evaluate p_n(x) by a three-term recurrence with static n."""
  n = int(n)
  if n < 0:
    raise ValueError("polynomial degree must be >= 0")
  p_prev = jnp.full_like(x, x0)
  if n == 0:
    return p_prev
  p = x1_fn(x)
  for k in range(1, n):
    p_prev, p = p, step(k, x, p, p_prev)
  return p


def _poly_op(name, x0, x1_fn, step, doc):
  def op(n, x):
    n = int(n)
    return _mapn(lambda xx: _recurrence(n, x0, x1_fn, step, _f(xx)), x)
  op.__name__ = name
  op.__doc__ = doc
  return op


eval_legendre = _poly_op(
    "eval_legendre", 1.0, lambda x: x,
    lambda k, x, p, pm: ((2 * k + 1) * x * p - k * pm) / (k + 1),
    "Legendre P_n(x) by the three-term recurrence (device).")

eval_chebyt = _poly_op(
    "eval_chebyt", 1.0, lambda x: x,
    lambda k, x, p, pm: 2 * x * p - pm,
    "Chebyshev T_n(x) by recurrence (device).")

eval_chebyu = _poly_op(
    "eval_chebyu", 1.0, lambda x: 2 * x,
    lambda k, x, p, pm: 2 * x * p - pm,
    "Chebyshev U_n(x) by recurrence (device).")

eval_hermite = _poly_op(
    "eval_hermite", 1.0, lambda x: 2 * x,
    lambda k, x, p, pm: 2 * x * p - 2 * k * pm,
    "Physicists' Hermite H_n(x) by recurrence (device).")

eval_hermitenorm = _poly_op(
    "eval_hermitenorm", 1.0, lambda x: x,
    lambda k, x, p, pm: x * p - k * pm,
    "Probabilists' Hermite He_n(x) by recurrence (device).")

eval_laguerre = _poly_op(
    "eval_laguerre", 1.0, lambda x: 1 - x,
    lambda k, x, p, pm: ((2 * k + 1 - x) * p - k * pm) / (k + 1),
    "Laguerre L_n(x) by recurrence (device).")


def eval_genlaguerre(n, alpha, x):
  """Generalized Laguerre L_n^α(x) by recurrence (device)."""
  n = int(n)

  def kern(aa, xx):
    aa, xx = _f(aa), _f(xx)
    aa = jnp.broadcast_to(aa, jnp.broadcast_shapes(aa.shape, xx.shape))
    xx = jnp.broadcast_to(xx, aa.shape)
    p_prev = jnp.ones_like(xx)
    if n == 0:
      return p_prev
    p = 1 + aa - xx
    for k in range(1, n):
      p_prev, p = p, (((2 * k + 1 + aa - xx) * p
                       - (k + aa) * p_prev) / (k + 1))
    return p
  return _mapn(kern, alpha, x)


def eval_gegenbauer(n, alpha, x):
  """Gegenbauer C_n^α(x) by recurrence (device)."""
  n = int(n)

  def kern(aa, xx):
    aa, xx = _f(aa), _f(xx)
    aa = jnp.broadcast_to(aa, jnp.broadcast_shapes(aa.shape, xx.shape))
    xx = jnp.broadcast_to(xx, aa.shape)
    p_prev = jnp.ones_like(xx)
    if n == 0:
      return p_prev
    p = 2 * aa * xx
    for k in range(1, n):
      p_prev, p = p, ((2 * (k + aa) * xx * p
                       - (k + 2 * aa - 1) * p_prev) / (k + 1))
    return p
  return _mapn(kern, alpha, x)


# ---------------------------------------------------------------------
# host boundary: everything else in scipy.special, auto-wrapped with
# the once-per-process notice.  _HOST_NAMES is the single source of
# truth the parity audit reads.
# ---------------------------------------------------------------------

_host_noticed = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info("sp.special.%s: no XLA elementwise lowering — runs EAGERLY "
           "on the host (scipy.special), the sp.linalg.eig convention.",
           name)


def _host_call(name, *args, **kw):
  _host_notice(name)
  conv = [np.asarray(sp.lazify(a).glom())
          if isinstance(a, (Expr, np.ndarray, list, tuple)) else a
          for a in args]
  return getattr(_ss, name)(*conv, **kw)


def _host_special(name):
  def op(*args, **kw):
    return _host_call(name, *args, **kw)
  op.__name__ = name
  op.__doc__ = (f"scipy.special.{name} — host boundary (eager scipy "
                "call with a once-per-process notice).")
  return op


_HOST_NAMES = []
for _n in dir(_ss):
  if _n.startswith("_") or _n in globals():
    continue
  _obj = getattr(_ss, _n)
  if _inspect.ismodule(_obj):
    continue
  if _inspect.isclass(_obj):
    globals()[_n] = _obj          # errstate / warning classes
    _HOST_NAMES.append(_n)
  elif _py_callable(_obj):
    globals()[_n] = _host_special(_n)
    _HOST_NAMES.append(_n)
_HOST_NAMES = sorted(_HOST_NAMES)

__all__ = sorted(n for n in dir()
                 if not n.startswith("_") and n not in
                 ("annotations", "jax", "jnp", "np", "sp", "Expr",
                  "log_info"))
