"""``sp.stats`` — the scipy.stats surface, on device.

The reference has no statistics module (beyond-parity surface, the
sp.special pattern).  Three design layers:

* **device distributions** — the ~24 workhorse distributions
  (norm/t/chi2/gamma/beta/f/expon/uniform/lognorm/laplace/logistic/
  cauchy/gumbel/pareto/weibull_min/rayleigh/halfnorm/truncnorm +
  poisson/binom/nbinom/geom/bernoulli) are declarative device specs:
  a standardized logpdf, cdf, and ppf (built on ``sp.special``'s
  log-space bisection inverses), closed-form mean/var/entropy, and
  generic loc/scale handling.  Every method returns a lazy Expr that
  fuses into surrounding chains; ``rvs`` is inverse-CDF sampling
  through the device ppf (one fused kernel per draw), so every
  distribution with a ppf samples on-device.  Frozen
  (``norm(1, 2).pdf(x)``) and direct (``norm.pdf(x, 1, 2)``) calling
  conventions both work, like scipy.
* **descriptive + tests** — reductions (gmean/skew/kurtosis/moment/
  sem/iqr/...) are lazy device reductions; hypothesis tests compute
  the statistic on device and the p-value through the
  ``sp.special`` CDF identities (stdtr/chdtrc/fdtrc/ndtr/kolmogorov),
  returning scipy-shaped result objects.
* **host boundary** — the long tail (exotic distributions, exact
  small-sample tests, resampling machinery) re-exports scipy.stats
  with the once-per-process notice; ``_HOST_NAMES`` is the single
  source of truth the parity audit reads.

Reference parity: the spartan reference exposes no stats module;
SURVEY.md §2.5 'broader demo set' motivates the beyond-parity scipy
surfaces.
"""

from __future__ import annotations

import collections
import inspect as _inspect

import jax
import jax.numpy as jnp
import jax.scipy.special as _jss
import numpy as np
import scipy.stats as _sst

import spartan_tpu as sp
from spartan_tpu.expr.base import Expr
from spartan_tpu.special import (_betaincinv_kern, _f,
                                 _gammainccinv_kern, _gammaincinv_kern,
                                 _kolmogorov_kern)
from spartan_tpu.util import log_info

_py_callable = callable
_EULER = float(np.euler_gamma)


def _mapn(kern, *args):
  return sp.map([sp.lazify(a) for a in args], kern)


def _map_multi(kern, nout, *args):
  """Multi-output kernel -> one lazy Expr per output (the
  histogram2d pattern: each map selects [i] from the tuple; when the
  outputs are evaluated together the multi-root region shares the
  work, XLA CSE dedups otherwise)."""
  ops = [sp.lazify(a) for a in args]
  import functools as _ft
  return tuple(sp.map(ops, _ft.partial(
      lambda i_, *aa: kern(*aa)[i_], i)) for i in range(nout))


# ---------------------------------------------------------------------
# device distribution framework
# ---------------------------------------------------------------------

def _int_ppf(cdf_k, q, hi):
  """Smallest integer k with cdf(k) >= q — 64-step integer bisection
  (fixed trip count; invariant cdf(lo) < q <= cdf(hi))."""
  lo = jnp.full_like(q, -1.0)
  hi = jnp.broadcast_to(hi, q.shape).astype(q.dtype)

  def body(i, c):
    lo, hi = c
    mid = jnp.floor((lo + hi) / 2)
    ge = cdf_k(mid) >= q
    return (jnp.where(ge, lo, mid), jnp.where(ge, mid, hi))
  lo, hi = jax.lax.fori_loop(0, 64, body, (lo, hi))
  return hi


class _Frozen:
  """Frozen distribution: shape/loc/scale bound at construction."""

  def __init__(self, dist, args, kwds):
    self._dist, self._args, self._kwds = dist, args, kwds

  def __getattr__(self, name):
    meth = getattr(self._dist, name)

    def call(*a, **k):
      return meth(*a, *self._args, **{**self._kwds, **k})
    return call


class _DeviceDist:
  """Declarative device distribution (continuous or discrete).

  Hooks operate on the STANDARDIZED variable; loc/scale handling,
  derived methods (sf/isf/log*/median/std/interval/rvs) and the
  frozen-call convention are generic."""

  def __init__(self, name, nshape, logpdf, cdf, ppf, mean, var,
               entropy=None, support=(-np.inf, np.inf), discrete=False,
               sf=None, isf=None):
    self.name = name
    self._ns = nshape
    self._logpdf, self._cdf, self._ppf = logpdf, cdf, ppf
    self._mean_fn, self._var_fn, self._entropy_fn = mean, var, entropy
    self._support = support
    self._discrete = discrete
    self._sf, self._isf = sf, isf
    self.__doc__ = (f"Device {name} distribution (lazy Exprs; "
                    "scipy.stats calling conventions)")

  def __call__(self, *args, **kwds):
    return _Frozen(self, args, kwds)

  def _split(self, args, kwds):
    shp = list(args[:self._ns])
    rest = list(args[self._ns:])
    for i in range(len(shp), self._ns):
      shp.append(kwds.pop(f"arg{i}"))
    loc = kwds.pop("loc", rest[0] if rest else 0.0)
    if rest:
      rest = rest[1:]
    scale = kwds.pop("scale", rest[0] if rest else 1.0)
    if kwds:
      raise TypeError(f"{self.name}: unexpected kwargs {list(kwds)}")
    return shp, loc, scale

  # -- core methods ---------------------------------------------------

  def logpdf(self, x, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)

    def kern(xx, ll, ss, *sh):
      z = (_f(xx) - _f(ll)) / _f(ss)
      out = self._logpdf(z, *[_f(s) for s in sh]) - jnp.log(_f(ss))
      lob, hib = self._support
      ok = (z >= lob) & (z <= hib)
      return jnp.where(ok, out, -jnp.inf)
    return _mapn(kern, x, loc, scale, *shp)

  def pdf(self, x, *args, **kwds):
    return sp.exp(self.logpdf(x, *args, **kwds))

  def logpmf(self, k, *args, **kwds):
    if not self._discrete:
      raise AttributeError(f"{self.name} is continuous")
    return self.logpdf(k, *args, **kwds)

  def pmf(self, k, *args, **kwds):
    if not self._discrete:
      raise AttributeError(f"{self.name} is continuous")
    return sp.exp(self.logpdf(k, *args, **kwds))

  def cdf(self, x, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)

    def kern(xx, ll, ss, *sh):
      z = (_f(xx) - _f(ll)) / _f(ss)
      if self._discrete:
        z = jnp.floor(z)
      out = self._cdf(z, *[_f(s) for s in sh])
      lob, hib = self._support
      return jnp.clip(jnp.where(z < lob, 0.0,
                                jnp.where(z > hib, 1.0, out)), 0.0, 1.0)
    return _mapn(kern, x, loc, scale, *shp)

  def sf(self, x, *args, **kwds):
    if self._sf is not None:
      shp, loc, scale = self._split(args, kwds)

      def kern(xx, ll, ss, *sh):
        z = (_f(xx) - _f(ll)) / _f(ss)
        if self._discrete:
          z = jnp.floor(z)
        out = self._sf(z, *[_f(s) for s in sh])
        lob, hib = self._support
        return jnp.clip(jnp.where(z < lob, 1.0,
                                  jnp.where(z > hib, 0.0, out)),
                        0.0, 1.0)
      return _mapn(kern, x, loc, scale, *shp)
    return 1.0 - self.cdf(x, *args, **kwds)

  def logcdf(self, x, *args, **kwds):
    return sp.log(self.cdf(x, *args, **kwds))

  def logsf(self, x, *args, **kwds):
    return sp.log(self.sf(x, *args, **kwds))

  def ppf(self, q, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)

    def kern(qq, ll, ss, *sh):
      qq = _f(qq)
      z = self._ppf(qq, *[_f(s) for s in sh])
      out = _f(ll) + _f(ss) * z
      return jnp.where((qq < 0) | (qq > 1), jnp.nan, out)
    return _mapn(kern, q, loc, scale, *shp)

  def isf(self, q, *args, **kwds):
    if self._isf is not None:
      shp, loc, scale = self._split(args, kwds)

      def kern(qq, ll, ss, *sh):
        qq = _f(qq)
        z = self._isf(qq, *[_f(s) for s in sh])
        out = _f(ll) + _f(ss) * z
        return jnp.where((qq < 0) | (qq > 1), jnp.nan, out)
      return _mapn(kern, q, loc, scale, *shp)
    return self.ppf(1.0 - sp.lazify(q), *args, **kwds)

  # -- moments / summaries --------------------------------------------

  def mean(self, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)
    return _mapn(lambda ll, ss, *sh:
                 _f(ll) + _f(ss) * self._mean_fn(*[_f(s) for s in sh]),
                 loc, scale, *shp)

  def var(self, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)
    return _mapn(lambda ll, ss, *sh:
                 _f(ss) ** 2 * self._var_fn(*[_f(s) for s in sh]),
                 loc, scale, *shp)

  def std(self, *args, **kwds):
    return sp.sqrt(self.var(*args, **kwds))

  def median(self, *args, **kwds):
    return self.ppf(0.5, *args, **kwds)

  def entropy(self, *args, **kwds):
    if self._entropy_fn is None:
      return _host_call_dist(self.name, "entropy", args, kwds)
    shp, loc, scale = self._split(args, kwds)
    if self._discrete:
      return _mapn(lambda ll, ss, *sh:
                   self._entropy_fn(*[_f(s) for s in sh]),
                   loc, scale, *shp)
    return _mapn(lambda ll, ss, *sh:
                 self._entropy_fn(*[_f(s) for s in sh])
                 + jnp.log(_f(ss)), loc, scale, *shp)

  def stats(self, *args, **kwds):
    moments = kwds.pop("moments", "mv")
    out = []
    for m in moments:
      if m == "m":
        out.append(self.mean(*args, **kwds))
      elif m == "v":
        out.append(self.var(*args, **kwds))
      else:   # skew/kurtosis: host closed forms via scipy
        out.append(_host_call_dist(self.name, "stats", args,
                                   {**kwds, "moments": m}))
    return tuple(out)

  def interval(self, confidence, *args, **kwds):
    alpha = (1.0 - sp.lazify(confidence)) / 2.0
    return (self.ppf(alpha, *args, **kwds),
            self.isf(alpha, *args, **kwds))

  def support(self, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)
    lob, hib = self._support
    lo = sp.lazify(loc) + sp.lazify(scale) * lob if np.isfinite(lob) \
        else sp.lazify(np.float64(lob))
    hi = sp.lazify(loc) + sp.lazify(scale) * hib if np.isfinite(hib) \
        else sp.lazify(np.float64(hib))
    return lo, hi

  def moment(self, order, *args, **kwds):
    return _host_call_dist(self.name, "moment", (order,) + args, kwds)

  def fit(self, data, *args, **kwds):
    return _host_call_dist(self.name, "fit", (data,) + args, kwds)

  def rvs(self, *args, size=None, random_state=None, **kwds):
    """Inverse-CDF sampling through the device ppf (one fused
    kernel; every distribution with a device ppf samples on-device)."""
    shp, loc, scale = self._split(args, kwds)
    if size is None:
      size = ()
    if np.isscalar(size):
      size = (int(size),)
    seed = random_state if isinstance(random_state, (int, np.integer)) \
        else np.random.SeedSequence().entropy % (2 ** 31)
    u = sp.random.Generator(int(seed)).random(tuple(size))

    def kern(uu, ll, ss, *sh):
      z = self._ppf(_f(uu), *[_f(s) for s in sh])
      out = _f(ll) + _f(ss) * z
      return jnp.floor(out) if self._discrete else out
    return _mapn(kern, u, loc, scale, *shp)


def _host_call_dist(name, meth, args, kwds):
  _host_notice(f"{name}.{meth}")
  conv = [np.asarray(sp.lazify(a).glom())
          if isinstance(a, (Expr, np.ndarray)) else a for a in args]
  return getattr(getattr(_sst, name), meth)(*conv, **kwds)


# -- standardized hooks (z is the standardized variable) ---------------

_LOG_SQRT_2PI = float(0.5 * np.log(2 * np.pi))

norm = _DeviceDist(
    "norm", 0,
    logpdf=lambda z: -0.5 * z * z - _LOG_SQRT_2PI,
    cdf=lambda z: _jss.ndtr(z),
    ppf=lambda q: _jss.ndtri(q),
    mean=lambda: 0.0, var=lambda: 1.0,
    entropy=lambda: 0.5 * np.log(2 * np.pi * np.e),
    sf=lambda z: _jss.ndtr(-z), isf=lambda q: -_jss.ndtri(q))

t = _DeviceDist(
    "t", 1,
    logpdf=lambda z, df: (_jss.gammaln((df + 1) / 2)
                          - _jss.gammaln(df / 2)
                          - 0.5 * jnp.log(df * np.pi)
                          - (df + 1) / 2 * jnp.log1p(z * z / df)),
    cdf=lambda z, df: jnp.where(
        z >= 0,
        1.0 - 0.5 * _jss.betainc(df / 2, jnp.asarray(0.5, df.dtype),
                                 df / (df + z * z)),
        0.5 * _jss.betainc(df / 2, jnp.asarray(0.5, df.dtype),
                           df / (df + z * z))),
    ppf=lambda q, df: _t_ppf(q, df),
    mean=lambda df: jnp.where(df > 1, 0.0, jnp.nan),
    var=lambda df: jnp.where(df > 2, df / (df - 2),
                             jnp.where(df > 1, jnp.inf, jnp.nan)))


def _t_ppf(q, df):
  qq = 2.0 * jnp.minimum(q, 1.0 - q)
  xb = _betaincinv_kern(df / 2, jnp.full_like(df, 0.5), qq)
  tt = jnp.sqrt(df * (1.0 - xb) / jnp.maximum(xb, 1e-300))
  return jnp.where(q >= 0.5, tt, -tt)


chi2 = _DeviceDist(
    "chi2", 1,
    logpdf=lambda z, df: ((df / 2 - 1) * jnp.log(z) - z / 2
                          - _jss.gammaln(df / 2) - (df / 2) * _LN2J),
    cdf=lambda z, df: _jss.gammainc(df / 2, z / 2),
    sf=lambda z, df: _jss.gammaincc(df / 2, z / 2),
    ppf=lambda q, df: 2.0 * _gammaincinv_kern(df / 2, q),
    isf=lambda q, df: 2.0 * _gammainccinv_kern(df / 2, q),
    mean=lambda df: df, var=lambda df: 2.0 * df,
    support=(0.0, np.inf))

_LN2J = float(np.log(2.0))

gamma = _DeviceDist(
    "gamma", 1,
    logpdf=lambda z, a: ((a - 1) * jnp.log(z) - z - _jss.gammaln(a)),
    cdf=lambda z, a: _jss.gammainc(a, z),
    sf=lambda z, a: _jss.gammaincc(a, z),
    ppf=lambda q, a: _gammaincinv_kern(a, q),
    isf=lambda q, a: _gammainccinv_kern(a, q),
    mean=lambda a: a, var=lambda a: a,
    entropy=lambda a: a + _jss.gammaln(a)
    + (1 - a) * _jss.digamma(a),
    support=(0.0, np.inf))

beta = _DeviceDist(
    "beta", 2,
    logpdf=lambda z, a, b: ((a - 1) * jnp.log(z)
                            + (b - 1) * jnp.log1p(-z)
                            - _jss.betaln(a, b)),
    cdf=lambda z, a, b: _jss.betainc(a, b, z),
    ppf=lambda q, a, b: _betaincinv_kern(
        *jnp.broadcast_arrays(a, b, q)),
    mean=lambda a, b: a / (a + b),
    var=lambda a, b: a * b / ((a + b) ** 2 * (a + b + 1)),
    support=(0.0, 1.0))

f = _DeviceDist(
    "f", 2,
    logpdf=lambda z, dfn, dfd: (
        dfn / 2 * jnp.log(dfn) + dfd / 2 * jnp.log(dfd)
        + (dfn / 2 - 1) * jnp.log(z)
        - (dfn + dfd) / 2 * jnp.log(dfd + dfn * z)
        - _jss.betaln(dfn / 2, dfd / 2)),
    cdf=lambda z, dfn, dfd: _jss.betainc(
        dfn / 2, dfd / 2, dfn * z / (dfn * z + dfd)),
    sf=lambda z, dfn, dfd: _jss.betainc(
        dfd / 2, dfn / 2, dfd / (dfd + dfn * z)),
    ppf=lambda q, dfn, dfd: _f_ppf(q, dfn, dfd),
    mean=lambda dfn, dfd: jnp.where(dfd > 2, dfd / (dfd - 2), jnp.nan),
    var=lambda dfn, dfd: jnp.where(
        dfd > 4, 2 * dfd ** 2 * (dfn + dfd - 2)
        / (dfn * (dfd - 2) ** 2 * (dfd - 4)), jnp.nan),
    support=(0.0, np.inf))


def _f_ppf(q, dfn, dfd):
  dfn, dfd, q = jnp.broadcast_arrays(dfn, dfd, q)
  w = _betaincinv_kern(dfn / 2, dfd / 2, q)
  return dfd * w / (dfn * jnp.maximum(1.0 - w, 1e-300))


expon = _DeviceDist(
    "expon", 0,
    logpdf=lambda z: -z,
    cdf=lambda z: -jnp.expm1(-z),
    sf=lambda z: jnp.exp(-z),
    ppf=lambda q: -jnp.log1p(-q),
    isf=lambda q: -jnp.log(q),
    mean=lambda: 1.0, var=lambda: 1.0, entropy=lambda: 1.0,
    support=(0.0, np.inf))

uniform = _DeviceDist(
    "uniform", 0,
    logpdf=lambda z: jnp.zeros_like(z),
    cdf=lambda z: z,
    ppf=lambda q: q,
    mean=lambda: 0.5, var=lambda: 1.0 / 12, entropy=lambda: 0.0,
    support=(0.0, 1.0))

laplace = _DeviceDist(
    "laplace", 0,
    logpdf=lambda z: -jnp.abs(z) - _LN2J,
    cdf=lambda z: jnp.where(z >= 0, 1.0 - 0.5 * jnp.exp(-z),
                            0.5 * jnp.exp(z)),
    ppf=lambda q: jnp.where(q >= 0.5, -jnp.log(2 * (1 - q)),
                            jnp.log(2 * q)),
    mean=lambda: 0.0, var=lambda: 2.0,
    entropy=lambda: 1.0 + _LN2J)

logistic = _DeviceDist(
    "logistic", 0,
    logpdf=lambda z: -z - 2 * jax.nn.softplus(-z),
    cdf=lambda z: _jss.expit(z),
    sf=lambda z: _jss.expit(-z),
    ppf=lambda q: _jss.logit(q),
    isf=lambda q: -_jss.logit(q),
    mean=lambda: 0.0, var=lambda: np.pi ** 2 / 3, entropy=lambda: 2.0)

cauchy = _DeviceDist(
    "cauchy", 0,
    logpdf=lambda z: -jnp.log(np.pi) - jnp.log1p(z * z),
    cdf=lambda z: 0.5 + jnp.arctan(z) / np.pi,
    ppf=lambda q: jnp.tan(np.pi * (q - 0.5)),
    mean=lambda: jnp.nan, var=lambda: jnp.nan,
    entropy=lambda: np.log(4 * np.pi))

lognorm = _DeviceDist(
    "lognorm", 1,
    logpdf=lambda z, s: (-jnp.log(z) - jnp.log(s) - _LOG_SQRT_2PI
                         - jnp.log(z) ** 2 / (2 * s * s)),
    cdf=lambda z, s: _jss.ndtr(jnp.log(z) / s),
    sf=lambda z, s: _jss.ndtr(-jnp.log(z) / s),
    ppf=lambda q, s: jnp.exp(s * _jss.ndtri(q)),
    mean=lambda s: jnp.exp(s * s / 2),
    var=lambda s: (jnp.exp(s * s) - 1) * jnp.exp(s * s),
    support=(0.0, np.inf))

gumbel_r = _DeviceDist(
    "gumbel_r", 0,
    logpdf=lambda z: -z - jnp.exp(-z),
    cdf=lambda z: jnp.exp(-jnp.exp(-z)),
    ppf=lambda q: -jnp.log(-jnp.log(q)),
    mean=lambda: _EULER, var=lambda: np.pi ** 2 / 6,
    entropy=lambda: _EULER + 1.0)

gumbel_l = _DeviceDist(
    "gumbel_l", 0,
    logpdf=lambda z: z - jnp.exp(z),
    cdf=lambda z: -jnp.expm1(-jnp.exp(z)),
    sf=lambda z: jnp.exp(-jnp.exp(z)),
    ppf=lambda q: jnp.log(-jnp.log1p(-q)),
    mean=lambda: -_EULER, var=lambda: np.pi ** 2 / 6,
    entropy=lambda: _EULER + 1.0)

pareto = _DeviceDist(
    "pareto", 1,
    logpdf=lambda z, b: jnp.log(b) - (b + 1) * jnp.log(z),
    cdf=lambda z, b: 1.0 - z ** -b,
    sf=lambda z, b: z ** -b,
    ppf=lambda q, b: (1.0 - q) ** (-1.0 / b),
    isf=lambda q, b: q ** (-1.0 / b),
    mean=lambda b: jnp.where(b > 1, b / (b - 1), jnp.inf),
    var=lambda b: jnp.where(b > 2, b / ((b - 1) ** 2 * (b - 2)),
                            jnp.inf),
    support=(1.0, np.inf))

weibull_min = _DeviceDist(
    "weibull_min", 1,
    logpdf=lambda z, c: (jnp.log(c) + (c - 1) * jnp.log(z) - z ** c),
    cdf=lambda z, c: -jnp.expm1(-z ** c),
    sf=lambda z, c: jnp.exp(-z ** c),
    ppf=lambda q, c: (-jnp.log1p(-q)) ** (1.0 / c),
    mean=lambda c: jnp.exp(_jss.gammaln(1 + 1 / c)),
    var=lambda c: (jnp.exp(_jss.gammaln(1 + 2 / c))
                   - jnp.exp(2 * _jss.gammaln(1 + 1 / c))),
    support=(0.0, np.inf))

rayleigh = _DeviceDist(
    "rayleigh", 0,
    logpdf=lambda z: jnp.log(z) - z * z / 2,
    cdf=lambda z: -jnp.expm1(-z * z / 2),
    sf=lambda z: jnp.exp(-z * z / 2),
    ppf=lambda q: jnp.sqrt(-2 * jnp.log1p(-q)),
    mean=lambda: np.sqrt(np.pi / 2), var=lambda: 2 - np.pi / 2,
    support=(0.0, np.inf))

halfnorm = _DeviceDist(
    "halfnorm", 0,
    logpdf=lambda z: -z * z / 2 - _LOG_SQRT_2PI + _LN2J,
    cdf=lambda z: 2 * _jss.ndtr(z) - 1,
    ppf=lambda q: _jss.ndtri((q + 1) / 2),
    mean=lambda: np.sqrt(2 / np.pi), var=lambda: 1 - 2 / np.pi,
    support=(0.0, np.inf))

truncnorm = _DeviceDist(
    "truncnorm", 2,
    logpdf=lambda z, a, b: (-0.5 * z * z - _LOG_SQRT_2PI
                            - jnp.log(_jss.ndtr(b) - _jss.ndtr(a))),
    cdf=lambda z, a, b: ((_jss.ndtr(jnp.clip(z, a, b)) - _jss.ndtr(a))
                         / (_jss.ndtr(b) - _jss.ndtr(a))),
    ppf=lambda q, a, b: _jss.ndtri(
        _jss.ndtr(a) + q * (_jss.ndtr(b) - _jss.ndtr(a))),
    mean=lambda a, b: _tn_mean(a, b),
    var=lambda a, b: _tn_var(a, b))


def _phi(z):
  return jnp.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)


def _tn_mean(a, b):
  Z = _jss.ndtr(b) - _jss.ndtr(a)
  return (_phi(a) - _phi(b)) / Z


def _tn_var(a, b):
  Z = _jss.ndtr(b) - _jss.ndtr(a)
  m = (_phi(a) - _phi(b)) / Z
  return 1.0 + (a * _phi(a) - b * _phi(b)) / Z - m * m


# -- discrete ----------------------------------------------------------

poisson = _DeviceDist(
    "poisson", 1, discrete=True,
    logpdf=lambda k, mu: (k * jnp.log(mu) - mu
                          - _jss.gammaln(k + 1)),
    cdf=lambda k, mu: _jss.gammaincc(jnp.floor(k) + 1, mu),
    ppf=lambda q, mu: _int_ppf(
        lambda kk: _jss.gammaincc(kk + 1, mu), q,
        mu + 60 * jnp.sqrt(mu) + 60),
    mean=lambda mu: mu, var=lambda mu: mu,
    support=(0.0, np.inf))

binom = _DeviceDist(
    "binom", 2, discrete=True,
    logpdf=lambda k, n, p: (_jss.gammaln(n + 1) - _jss.gammaln(k + 1)
                            - _jss.gammaln(n - k + 1)
                            + _jss.xlogy(k, p)
                            + _jss.xlog1py(n - k, -p)),
    cdf=lambda k, n, p: _binom_cdf(k, n, p),
    ppf=lambda q, n, p: _int_ppf(
        lambda kk: _binom_cdf(kk, n, p), q, n),
    mean=lambda n, p: n * p, var=lambda n, p: n * p * (1 - p),
    support=(0.0, np.inf))


def _binom_cdf(k, n, p):
  k = jnp.floor(k)
  out = _jss.betainc(jnp.maximum(n - k, 1e-30), k + 1, 1.0 - p)
  return jnp.where(k >= n, 1.0, jnp.where(k < 0, 0.0, out))


nbinom = _DeviceDist(
    "nbinom", 2, discrete=True,
    logpdf=lambda k, n, p: (_jss.gammaln(k + n) - _jss.gammaln(k + 1)
                            - _jss.gammaln(n) + n * jnp.log(p)
                            + _jss.xlog1py(k, -p)),
    cdf=lambda k, n, p: _jss.betainc(n, jnp.floor(k) + 1, p),
    ppf=lambda q, n, p: _int_ppf(
        lambda kk: _jss.betainc(n, kk + 1, p), q,
        60 + 60 * n * (1 - p) / jnp.maximum(p * p, 1e-12)),
    mean=lambda n, p: n * (1 - p) / p,
    var=lambda n, p: n * (1 - p) / (p * p),
    support=(0.0, np.inf))

geom = _DeviceDist(
    "geom", 1, discrete=True,
    logpdf=lambda k, p: _jss.xlog1py(k - 1, -p) + jnp.log(p),
    cdf=lambda k, p: -jnp.expm1(_jss.xlog1py(jnp.floor(k), -p)),
    sf=lambda k, p: jnp.exp(_jss.xlog1py(jnp.floor(k), -p)),
    ppf=lambda q, p: jnp.ceil(jnp.log1p(-q) / jnp.log1p(-p)),
    mean=lambda p: 1.0 / p, var=lambda p: (1 - p) / (p * p),
    support=(1.0, np.inf))

bernoulli = _DeviceDist(
    "bernoulli", 1, discrete=True,
    logpdf=lambda k, p: _jss.xlogy(k, p) + _jss.xlog1py(1 - k, -p),
    cdf=lambda k, p: jnp.where(jnp.floor(k) >= 1, 1.0,
                               jnp.where(k < 0, 0.0, 1.0 - p)),
    ppf=lambda q, p: jnp.where(q > 1.0 - p, 1.0, 0.0),
    mean=lambda p: p, var=lambda p: p * (1 - p),
    entropy=lambda p: -(_jss.xlogy(p, p) + _jss.xlog1py(1 - p, -p)),
    support=(0.0, 1.0))

_DEVICE_DISTS = {
    "norm": norm, "t": t, "chi2": chi2, "gamma": gamma, "beta": beta,
    "f": f, "expon": expon, "uniform": uniform, "laplace": laplace,
    "logistic": logistic, "cauchy": cauchy, "lognorm": lognorm,
    "gumbel_r": gumbel_r, "gumbel_l": gumbel_l, "pareto": pareto,
    "weibull_min": weibull_min, "rayleigh": rayleigh,
    "halfnorm": halfnorm, "truncnorm": truncnorm, "poisson": poisson,
    "binom": binom, "nbinom": nbinom, "geom": geom,
    "bernoulli": bernoulli,
}

# ---------------------------------------------------------------------
# descriptive statistics (lazy device reductions)
# ---------------------------------------------------------------------

def gmean(a, axis=0, dtype=None, weights=None):
  """Geometric mean — exp of the (optionally weighted) mean log."""
  ops = [sp.lazify(a)] + ([sp.lazify(weights)]
                          if weights is not None else [])

  def kern(aa, *ww):
    la = jnp.log(_f(aa))
    if ww:
      w = _f(ww[0])
      return jnp.exp((la * w).sum(axis) / w.sum(axis))
    return jnp.exp(la.mean(axis))
  return sp.map(ops, kern)


def hmean(a, axis=0, dtype=None, weights=None):
  """Harmonic mean."""
  ops = [sp.lazify(a)] + ([sp.lazify(weights)]
                          if weights is not None else [])

  def kern(aa, *ww):
    inv = 1.0 / _f(aa)
    if ww:
      w = _f(ww[0])
      return w.sum(axis) / (inv * w).sum(axis)
    return 1.0 / inv.mean(axis)
  return sp.map(ops, kern)


def pmean(a, p, axis=0, dtype=None, weights=None):
  """Power (generalized) mean of order p."""
  if p == 0:
    return gmean(a, axis=axis, dtype=dtype, weights=weights)
  ops = [sp.lazify(a)] + ([sp.lazify(weights)]
                          if weights is not None else [])

  def kern(aa, *ww):
    ap = _f(aa) ** p
    if ww:
      w = _f(ww[0])
      return ((ap * w).sum(axis) / w.sum(axis)) ** (1.0 / p)
    return ap.mean(axis) ** (1.0 / p)
  return sp.map(ops, kern)


def moment(a, order=1, axis=0, nan_policy="propagate", *, center=None):
  """Central moment of the given order."""
  def kern(aa):
    aa = _f(aa)
    c = aa.mean(axis, keepdims=True) if center is None else center
    return ((aa - c) ** order).mean(axis)
  return _mapn(kern, a)


def skew(a, axis=0, bias=True, nan_policy="propagate"):
  """Sample skewness (Fisher-Pearson; bias=False applies the
  G1 correction)."""
  def kern(aa):
    aa = _f(aa)
    m = aa.mean(axis, keepdims=True)
    m2 = ((aa - m) ** 2).mean(axis)
    m3 = ((aa - m) ** 3).mean(axis)
    g1 = m3 / m2 ** 1.5
    if bias:
      return g1
    n = aa.shape[axis if axis is not None else 0] if axis is not None \
        else aa.size
    return g1 * jnp.sqrt(n * (n - 1.0)) / (n - 2.0)
  return _mapn(kern, a)


def kurtosis(a, axis=0, fisher=True, bias=True,
             nan_policy="propagate"):
  """Sample kurtosis (Fisher by default; bias=False applies G2)."""
  def kern(aa):
    aa = _f(aa)
    m = aa.mean(axis, keepdims=True)
    m2 = ((aa - m) ** 2).mean(axis)
    m4 = ((aa - m) ** 4).mean(axis)
    g2 = m4 / m2 ** 2 - 3.0
    if not bias:
      n = aa.shape[axis if axis is not None else 0] if axis is not None \
          else aa.size
      g2 = ((n - 1.0) / ((n - 2.0) * (n - 3.0))
            * ((n + 1.0) * g2 + 6.0))
    return g2 if fisher else g2 + 3.0
  return _mapn(kern, a)


def mode(a, axis=0, nan_policy="propagate", keepdims=False):
  """Most common value (jax.scipy.stats.mode)."""
  import jax.scipy.stats as _jst
  M = collections.namedtuple("ModeResult", ["mode", "count"])
  m, c = _map_multi(lambda aa: _jst.mode(aa, axis=axis,
                                         keepdims=keepdims), 2, a)
  return M(m, c)


def sem(a, axis=0, ddof=1, nan_policy="propagate"):
  """Standard error of the mean."""
  def kern(aa):
    aa = _f(aa)
    n = aa.shape[axis] if axis is not None else aa.size
    return aa.std(axis, ddof=ddof) / jnp.sqrt(jnp.asarray(n, aa.dtype))
  return _mapn(kern, a)


def zscore(a, axis=0, ddof=0, nan_policy="propagate"):
  """Z-scores along an axis."""
  def kern(aa):
    aa = _f(aa)
    return ((aa - aa.mean(axis, keepdims=True))
            / aa.std(axis, ddof=ddof, keepdims=True))
  return _mapn(kern, a)


def gzscore(a, axis=0, ddof=0, nan_policy="propagate"):
  """Geometric z-scores (z-scores of the logs)."""
  return zscore(sp.log(sp.lazify(a)), axis=axis, ddof=ddof)


def zmap(scores, compare, axis=0, ddof=0, nan_policy="propagate"):
  """Z-scores of ``scores`` relative to ``compare``."""
  def kern(ss, cc):
    cc = _f(cc)
    return ((_f(ss) - cc.mean(axis, keepdims=True))
            / cc.std(axis, ddof=ddof, keepdims=True))
  return _mapn(kern, scores, compare)


def iqr(x, axis=None, rng=(25, 75), scale=1.0,
        nan_policy="propagate", interpolation="linear"):
  """Interquartile range (device percentiles)."""
  def kern(xx):
    xx = _f(xx)
    lo, hi = rng
    q = jnp.percentile(xx, jnp.asarray([lo, hi], xx.dtype), axis=axis,
                       method=interpolation)
    s = 1.3489795003921634 if scale == "normal" else scale  # 2*ndtri(3/4)
    return (q[1] - q[0]) / s
  return _mapn(kern, x)


def median_abs_deviation(x, axis=0, center=None, scale=1.0,
                         nan_policy="propagate"):
  """Median absolute deviation."""
  def kern(xx):
    xx = _f(xx)
    c = jnp.median(xx, axis=axis, keepdims=True) if center is None \
        else center(xx, axis=axis, keepdims=True)
    s = 0.6744897501960817 if scale == "normal" else scale
    return jnp.median(jnp.abs(xx - c), axis=axis) / s
  return _mapn(kern, x)


def variation(a, axis=0, nan_policy="propagate", ddof=0):
  """Coefficient of variation std/mean."""
  def kern(aa):
    aa = _f(aa)
    return aa.std(axis, ddof=ddof) / aa.mean(axis)
  return _mapn(kern, a)


def tmean(a, limits=None, inclusive=(True, True), axis=None):
  """Trimmed mean over a value window."""
  return _trimmed(a, limits, inclusive, axis, "mean")


def tvar(a, limits=None, inclusive=(True, True), axis=0, ddof=1):
  """Trimmed variance."""
  return _trimmed(a, limits, inclusive, axis, "var", ddof=ddof)


def tstd(a, limits=None, inclusive=(True, True), axis=0, ddof=1):
  """Trimmed standard deviation."""
  return sp.sqrt(tvar(a, limits, inclusive, axis, ddof))


def tsem(a, limits=None, inclusive=(True, True), axis=0, ddof=1):
  """Trimmed standard error of the mean."""
  def kern(aa):
    aa = _f(aa)
    m = _limit_mask(aa, limits, inclusive)
    n = m.sum(axis)
    mu = jnp.where(m, aa, 0.0).sum(axis) / n
    v = (jnp.where(m, (aa - jnp.expand_dims(mu, axis or 0)) ** 2,
                   0.0).sum(axis) / (n - ddof))
    return jnp.sqrt(v / n)
  return _mapn(kern, a)


def tmin(a, lowerlimit=None, axis=0, inclusive=True,
         nan_policy="propagate"):
  """Trimmed minimum."""
  def kern(aa):
    aa = _f(aa)
    m = _limit_mask(aa, (lowerlimit, None), (inclusive, True))
    return jnp.where(m, aa, jnp.inf).min(axis)
  return _mapn(kern, a)


def tmax(a, upperlimit=None, axis=0, inclusive=True,
         nan_policy="propagate"):
  """Trimmed maximum."""
  def kern(aa):
    aa = _f(aa)
    m = _limit_mask(aa, (None, upperlimit), (True, inclusive))
    return jnp.where(m, aa, -jnp.inf).max(axis)
  return _mapn(kern, a)


def _limit_mask(aa, limits, inclusive):
  m = jnp.ones(aa.shape, bool)
  if limits is not None:
    lo, hi = limits
    il, ih = inclusive
    if lo is not None:
      m &= (aa >= lo) if il else (aa > lo)
    if hi is not None:
      m &= (aa <= hi) if ih else (aa < hi)
  return m


def _trimmed(a, limits, inclusive, axis, stat, ddof=1):
  def kern(aa):
    aa = _f(aa)
    m = _limit_mask(aa, limits, inclusive)
    n = m.sum(axis)
    mu = jnp.where(m, aa, 0.0).sum(axis) / n
    if stat == "mean":
      return mu
    c = aa - (jnp.expand_dims(mu, axis) if axis is not None else mu)
    return jnp.where(m, c * c, 0.0).sum(axis) / (n - ddof)
  return _mapn(kern, a)


def trim_mean(a, proportiontocut, axis=0):
  """Mean with the given fraction cut from each tail (sorted trim)."""
  def kern(aa):
    aa = jnp.sort(_f(aa), axis=axis)
    n = aa.shape[axis if axis is not None else 0]
    k = int(n * proportiontocut)
    sl = [slice(None)] * aa.ndim
    sl[axis if axis is not None else 0] = slice(k, n - k)
    return aa[tuple(sl)].mean(axis)
  return _mapn(kern, a)


def rankdata(a, method="average", *, axis=None,
             nan_policy="propagate"):
  """Ranks of the data (jax.scipy.stats.rankdata)."""
  import jax.scipy.stats as _jst
  return _mapn(lambda aa: _jst.rankdata(_f(aa), method=method,
                                        axis=axis), a)


def entropy(pk, qk=None, base=None, axis=0, *, nan_policy="propagate"):
  """Shannon entropy (or relative entropy when qk is given)."""
  ops = [sp.lazify(pk)] + ([sp.lazify(qk)] if qk is not None else [])

  def kern(pp, *qq):
    pp = _f(pp)
    pp = pp / pp.sum(axis, keepdims=True)
    if qq:
      q = _f(qq[0])
      q = q / q.sum(axis, keepdims=True)
      out = _jss.rel_entr(pp, q).sum(axis)
    else:
      out = _jss.entr(pp).sum(axis)
    return out / np.log(base) if base is not None else out
  return sp.map(ops, kern)


def circmean(samples, high=2 * np.pi, low=0, axis=None,
             nan_policy="propagate"):
  """Circular mean."""
  def kern(ss):
    ss = _f(ss)
    ang = (ss - low) * 2 * np.pi / (high - low)
    out = jnp.arctan2(jnp.sin(ang).mean(axis), jnp.cos(ang).mean(axis))
    return jnp.mod(out, 2 * np.pi) * (high - low) / (2 * np.pi) + low
  return _mapn(kern, samples)


def circvar(samples, high=2 * np.pi, low=0, axis=None,
            nan_policy="propagate"):
  """Circular variance 1 - |R|."""
  def kern(ss):
    ang = (_f(ss) - low) * 2 * np.pi / (high - low)
    R = jnp.sqrt(jnp.sin(ang).mean(axis) ** 2
                 + jnp.cos(ang).mean(axis) ** 2)
    return 1.0 - R
  return _mapn(kern, samples)


def circstd(samples, high=2 * np.pi, low=0, axis=None,
            nan_policy="propagate", *, normalize=False):
  """Circular standard deviation sqrt(-2 ln R)."""
  def kern(ss):
    ang = (_f(ss) - low) * 2 * np.pi / (high - low)
    R = jnp.sqrt(jnp.sin(ang).mean(axis) ** 2
                 + jnp.cos(ang).mean(axis) ** 2)
    out = jnp.sqrt(-2 * jnp.log(R))
    if not normalize:
      out = out * (high - low) / (2 * np.pi)
    return out
  return _mapn(kern, samples)


def gstd(a, axis=0, ddof=1):
  """Geometric standard deviation."""
  return sp.exp(sp.lazify(_mapn(
      lambda aa: jnp.log(_f(aa)).std(axis, ddof=ddof), a)))


def describe(a, axis=0, ddof=1, bias=True, nan_policy="propagate"):
  """Summary statistics (scipy's DescribeResult)."""
  D = collections.namedtuple(
      "DescribeResult",
      ["nobs", "minmax", "mean", "variance", "skewness", "kurtosis"])
  A = sp.lazify(a)
  n = A.shape[axis if axis is not None else 0]
  return D(n, (sp.min(A, axis=axis), sp.max(A, axis=axis)),
           sp.mean(A, axis=axis),
           _mapn(lambda aa: _f(aa).var(axis, ddof=ddof), a),
           skew(a, axis=axis, bias=bias),
           kurtosis(a, axis=axis, bias=bias))


# ---------------------------------------------------------------------
# correlation + hypothesis tests (device statistic; p-values through
# the sp.special CDF identities)
# ---------------------------------------------------------------------

_TT = collections.namedtuple("TtestResult", ["statistic", "pvalue"])
_PR = collections.namedtuple("PearsonRResult", ["statistic", "pvalue"])
_KS = collections.namedtuple("KstestResult", ["statistic", "pvalue"])
_CH = collections.namedtuple("Power_divergenceResult",
                             ["statistic", "pvalue"])
_F1 = collections.namedtuple("F_onewayResult", ["statistic", "pvalue"])
_SG = collections.namedtuple("SignificanceResult",
                             ["statistic", "pvalue"])
_NT = collections.namedtuple("NormaltestResult",
                             ["statistic", "pvalue"])
_LR = collections.namedtuple(
    "LinregressResult",
    ["slope", "intercept", "rvalue", "pvalue", "stderr",
     "intercept_stderr"])


def _t_sf2(tstat, df):
  """Two-sided t p-value via the betainc identity (device)."""
  return _jss.betainc(df / 2, jnp.asarray(0.5, tstat.dtype),
                      df / (df + tstat * tstat))


def ttest_1samp(a, popmean, axis=0, nan_policy="propagate",
                alternative="two-sided"):
  """One-sample t-test — statistic and p both on device."""
  def kern(aa, pm):
    aa = _f(aa)
    n = aa.shape[axis]
    d = aa.mean(axis) - _f(pm)
    se = aa.std(axis, ddof=1) / np.sqrt(n)
    tstat = d / se
    return tstat, _t_alt(tstat, jnp.asarray(float(n - 1), aa.dtype),
                         alternative)
  s, p = _map_multi(kern, 2, a, popmean)
  return _TT(s, p)


def _t_alt(tstat, df, alternative):
  p2 = _t_sf2(tstat, df)
  if alternative == "two-sided":
    return p2
  one = jnp.where(tstat >= 0, p2 / 2, 1 - p2 / 2)
  return one if alternative == "greater" else 1 - one


def ttest_ind(a, b, axis=0, equal_var=True, nan_policy="propagate",
              alternative="two-sided"):
  """Two-sample t-test (pooled or Welch)."""
  def kern(aa, bb):
    aa, bb = _f(aa), _f(bb)
    na, nb = aa.shape[axis], bb.shape[axis]
    va, vb = aa.var(axis, ddof=1), bb.var(axis, ddof=1)
    d = aa.mean(axis) - bb.mean(axis)
    if equal_var:
      sp2 = ((na - 1) * va + (nb - 1) * vb) / (na + nb - 2)
      se = jnp.sqrt(sp2 * (1.0 / na + 1.0 / nb))
      df = jnp.asarray(float(na + nb - 2), aa.dtype)
    else:
      se = jnp.sqrt(va / na + vb / nb)
      df = ((va / na + vb / nb) ** 2
            / ((va / na) ** 2 / (na - 1) + (vb / nb) ** 2 / (nb - 1)))
    tstat = d / se
    return tstat, _t_alt(tstat, df, alternative)
  s, p = _map_multi(kern, 2, a, b)
  return _TT(s, p)


def ttest_rel(a, b, axis=0, nan_policy="propagate",
              alternative="two-sided"):
  """Paired t-test."""
  return ttest_1samp(sp.lazify(a) - sp.lazify(b), 0.0, axis=axis,
                     alternative=alternative)


def pearsonr(x, y, *, alternative="two-sided", method=None, axis=0):
  """Pearson correlation with the exact t-based p-value."""
  def kern(xx, yy):
    xx, yy = _f(xx), _f(yy)
    n = xx.shape[axis if axis is not None else 0]
    xm = xx - xx.mean(axis, keepdims=True)
    ym = yy - yy.mean(axis, keepdims=True)
    r = ((xm * ym).sum(axis)
         / jnp.sqrt((xm * xm).sum(axis) * (ym * ym).sum(axis)))
    r = jnp.clip(r, -1.0, 1.0)
    df = jnp.asarray(float(n - 2), xx.dtype)
    tstat = r * jnp.sqrt(df / jnp.maximum(1.0 - r * r, 1e-300))
    return r, _t_alt(tstat, df, alternative)
  s, p = _map_multi(kern, 2, x, y)
  return _PR(s, p)


def spearmanr(a, b=None, axis=0, nan_policy="propagate",
              alternative="two-sided"):
  """Spearman rank correlation (device ranks + Pearson on ranks)."""
  if b is None:
    raise NotImplementedError("matrix form routes host: use "
                              "scipy.stats.spearmanr")
  ra = rankdata(a, axis=axis)
  rb = rankdata(b, axis=axis)
  out = pearsonr(ra, rb, alternative=alternative, axis=axis)
  return _SG(out.statistic, out.pvalue)


def pointbiserialr(x, y):
  """Point-biserial correlation (Pearson on the binary coding)."""
  out = pearsonr(x, y)
  return _SG(out.statistic, out.pvalue)


def kstest(rvs, cdf, args=(), N=20, alternative="two-sided",
           method="auto", axis=0):
  """One-sample KS test against a device-distribution cdf (asymptotic
  kolmogorov p)."""
  if isinstance(cdf, str):
    cdf_dist = _DEVICE_DISTS.get(cdf)
    if cdf_dist is None:
      return _host_call("kstest", rvs, cdf, args=args, N=N,
                        alternative=alternative, method=method)
    cdf = lambda x: cdf_dist.cdf(x, *args)  # noqa: E731
  X = sp.lazify(rvs)
  n = X.shape[0]
  F = sp.lazify(cdf(sp.sort(X)))

  def kern(ff):
    ff = _f(ff)
    i = jnp.arange(1, n + 1, dtype=ff.dtype)
    dplus = (i / n - ff).max()
    dminus = (ff - (i - 1) / n).max()
    d = jnp.maximum(dplus, dminus)
    p = _kolmogorov_kern(d * (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)))
    return d, jnp.clip(p, 0.0, 1.0)
  s, p = _map_multi(kern, 2, F)
  return _KS(s, p)


def ks_1samp(x, cdf, args=(), alternative="two-sided", method="auto",
             axis=0):
  """Alias of ``kstest`` for the one-sample form."""
  return kstest(x, cdf, args=args, alternative=alternative,
                method=method)


def ks_2samp(data1, data2, alternative="two-sided", method="auto",
             axis=0):
  """Two-sample KS test (device statistic; asymptotic p)."""
  X, Y = sp.lazify(data1), sp.lazify(data2)
  n1, n2 = X.shape[0], Y.shape[0]

  def kern(xx, yy):
    xx, yy = jnp.sort(_f(xx)), jnp.sort(_f(yy))
    allv = jnp.concatenate([xx, yy])
    # searchsorted yields int32; int32/int division would promote
    # to f32 in jax's lattice — cast to the data float first
    cdf1 = jnp.searchsorted(xx, allv, side="right").astype(xx.dtype) / n1
    cdf2 = jnp.searchsorted(yy, allv, side="right").astype(yy.dtype) / n2
    d = jnp.abs(cdf1 - cdf2).max()
    en = np.sqrt(n1 * n2 / (n1 + n2))
    p = _kolmogorov_kern(jnp.asarray(
        (en + 0.12 + 0.11 / en), xx.dtype) * d)
    return d, jnp.clip(p, 0.0, 1.0)
  s, p = _map_multi(kern, 2, X, Y)
  return _KS(s, p)


def power_divergence(f_obs, f_exp=None, ddof=0, axis=0, lambda_=None):
  """Cressie-Read power divergence (chisquare family)."""
  if lambda_ is None:
    lambda_ = 1.0
  elif isinstance(lambda_, str):
    lambda_ = {"pearson": 1.0, "log-likelihood": 0.0,
               "freeman-tukey": -0.5, "mod-log-likelihood": -1.0,
               "neyman": -2.0, "cressie-read": 2.0 / 3.0}[lambda_]
  ops = [sp.lazify(f_obs)] + ([sp.lazify(f_exp)]
                              if f_exp is not None else [])

  def kern(fo, *fe):
    fo = _f(fo)
    n = fo.shape[axis if axis is not None else 0]
    fx = _f(fe[0]) if fe else fo.mean(axis, keepdims=True) \
        + jnp.zeros_like(fo)
    if lambda_ == 1.0:
      stat = ((fo - fx) ** 2 / fx).sum(axis)
    elif lambda_ == 0.0:
      stat = 2.0 * _jss.xlogy(fo, fo / fx).sum(axis)
    else:
      stat = (2.0 / (lambda_ * (lambda_ + 1))
              * (fo * ((fo / fx) ** lambda_ - 1)).sum(axis))
    df = jnp.asarray(float(n - 1 - ddof), fo.dtype)
    return stat, _jss.gammaincc(df / 2, stat / 2)
  s, p = _map_multi(kern, 2, *ops)
  return _CH(s, p)


def chisquare(f_obs, f_exp=None, ddof=0, axis=0, *,
              sum_check=True):
  """Chi-square goodness of fit."""
  return power_divergence(f_obs, f_exp, ddof=ddof, axis=axis,
                          lambda_=1.0)


def f_oneway(*samples, axis=0):
  """One-way ANOVA — F statistic + fdtrc p, all device."""
  ops = [sp.lazify(s) for s in samples]
  k = len(ops)

  def kern(*ss):
    ss = [_f(s) for s in ss]
    ns = [s.shape[axis] for s in ss]
    n = sum(ns)
    grand = sum(s.sum(axis) for s in ss) / n
    ssb = sum(ni * (s.mean(axis) - grand) ** 2
              for s, ni in zip(ss, ns))
    ssw = sum(((s - s.mean(axis, keepdims=True)) ** 2).sum(axis)
              for s in ss)
    dfb, dfw = float(k - 1), float(n - k)
    F = (ssb / dfb) / (ssw / dfw)
    p = _jss.betainc(jnp.asarray(dfw / 2, F.dtype),
                     jnp.asarray(dfb / 2, F.dtype),
                     dfw / (dfw + dfb * F))
    return F, p
  s, p = _map_multi(kern, 2, *ops)
  return _F1(s, p)


def bartlett(*samples, axis=0):
  """Bartlett's equal-variance test (chi2 p on device)."""
  ops = [sp.lazify(s) for s in samples]
  k = len(ops)

  def kern(*ss):
    ss = [_f(s) for s in ss]
    ns = [s.shape[axis] for s in ss]
    N = sum(ns)
    vs = [s.var(axis, ddof=1) for s in ss]
    sp2 = sum((ni - 1) * v for ni, v in zip(ns, vs)) / (N - k)
    num = ((N - k) * jnp.log(sp2)
           - sum((ni - 1) * jnp.log(v) for ni, v in zip(ns, vs)))
    C = 1 + (sum(1.0 / (ni - 1) for ni in ns) - 1.0 / (N - k)) \
        / (3 * (k - 1))
    stat = num / C
    df = jnp.asarray(float(k - 1), stat.dtype)
    return stat, _jss.gammaincc(df / 2, stat / 2)
  s, p = _map_multi(kern, 2, *ops)
  return _SG(s, p)


def levene(*samples, center="median", proportiontocut=0.05, axis=0):
  """Levene's equal-variance test (Brown-Forsythe for median)."""
  ops = [sp.lazify(s) for s in samples]
  k = len(ops)

  def kern(*ss):
    ss = [_f(s) for s in ss]
    ns = [s.shape[axis] for s in ss]
    N = sum(ns)
    if center == "median":
      zs = [jnp.abs(s - jnp.median(s, axis, keepdims=True))
            for s in ss]
    else:
      zs = [jnp.abs(s - s.mean(axis, keepdims=True)) for s in ss]
    zbars = [z.mean(axis) for z in zs]
    zgrand = sum(z.sum(axis) for z in zs) / N
    num = (N - k) * sum(ni * (zb - zgrand) ** 2
                        for ni, zb in zip(ns, zbars))
    den = (k - 1) * sum(((z - z.mean(axis, keepdims=True)) ** 2)
                        .sum(axis) for z in zs)
    W = num / den
    dfb, dfw = float(k - 1), float(N - k)
    p = _jss.betainc(jnp.asarray(dfw / 2, W.dtype),
                     jnp.asarray(dfb / 2, W.dtype),
                     dfw / (dfw + dfb * W))
    return W, p
  s, p = _map_multi(kern, 2, *ops)
  return _SG(s, p)


def jarque_bera(x, *, axis=None):
  """Jarque-Bera normality test."""
  def kern(xx):
    xx = _f(xx)
    n = xx.size if axis is None else xx.shape[axis]
    m = xx.mean(axis, keepdims=True)
    m2 = ((xx - m) ** 2).mean(axis)
    s = ((xx - m) ** 3).mean(axis) / m2 ** 1.5
    kk = ((xx - m) ** 4).mean(axis) / m2 ** 2
    stat = n / 6.0 * (s * s + (kk - 3) ** 2 / 4)
    return stat, jnp.exp(-stat / 2)   # chi2(2) survival
  s, p = _map_multi(kern, 2, x)
  return _SG(s, p)


def skewtest(a, axis=0, nan_policy="propagate",
             alternative="two-sided"):
  """D'Agostino skewness test (Z-transform on device)."""
  def kern(aa):
    aa = _f(aa)
    n = float(aa.shape[axis if axis is not None else 0])
    m = aa.mean(axis, keepdims=True)
    m2 = ((aa - m) ** 2).mean(axis)
    b2 = ((aa - m) ** 3).mean(axis) / m2 ** 1.5
    y = b2 * jnp.sqrt((n + 1) * (n + 3) / (6.0 * (n - 2)))
    beta2 = (3.0 * (n ** 2 + 27 * n - 70) * (n + 1) * (n + 3)
             / ((n - 2.0) * (n + 5) * (n + 7) * (n + 9)))
    W2 = -1.0 + jnp.sqrt(2 * (beta2 - 1))
    delta = 1 / jnp.sqrt(0.5 * jnp.log(W2))
    alpha = jnp.sqrt(2.0 / (W2 - 1))
    y = jnp.where(y == 0, 1.0, y)
    Z = delta * jnp.log(y / alpha + jnp.sqrt((y / alpha) ** 2 + 1))
    return Z, _z_alt(Z, alternative)
  s, p = _map_multi(kern, 2, a)
  return _SG(s, p)


def _z_alt(Z, alternative):
  if alternative == "two-sided":
    return 2 * _jss.ndtr(-jnp.abs(Z))
  one = _jss.ndtr(-Z)
  return one if alternative == "greater" else 1 - one


def kurtosistest(a, axis=0, nan_policy="propagate",
                 alternative="two-sided"):
  """Anscombe-Glynn kurtosis test."""
  def kern(aa):
    aa = _f(aa)
    n = float(aa.shape[axis if axis is not None else 0])
    m = aa.mean(axis, keepdims=True)
    m2 = ((aa - m) ** 2).mean(axis)
    b2 = ((aa - m) ** 4).mean(axis) / m2 ** 2
    E = 3.0 * (n - 1) / (n + 1)
    var = (24.0 * n * (n - 2) * (n - 3)
           / ((n + 1) ** 2 * (n + 3) * (n + 5)))
    x = (b2 - E) / jnp.sqrt(var)
    beta1 = (6.0 * (n ** 2 - 5 * n + 2) / ((n + 7) * (n + 9))
             * jnp.sqrt(6.0 * (n + 3) * (n + 5)
                        / (n * (n - 2) * (n - 3))))
    A = 6.0 + 8.0 / beta1 * (2.0 / beta1
                             + jnp.sqrt(1 + 4.0 / beta1 ** 2))
    Z = ((1 - 2.0 / (9 * A))
         - ((1 - 2.0 / A) / (1 + x * jnp.sqrt(2.0 / (A - 4))))
         ** (1.0 / 3)) / jnp.sqrt(2.0 / (9 * A))
    return Z, _z_alt(Z, alternative)
  s, p = _map_multi(kern, 2, a)
  return _SG(s, p)


def normaltest(a, axis=0, nan_policy="propagate"):
  """D'Agostino-Pearson omnibus normality test K²."""
  s = skewtest(a, axis=axis)
  k = kurtosistest(a, axis=axis)
  k2 = sp.lazify(s.statistic) ** 2 + sp.lazify(k.statistic) ** 2
  p = _mapn(lambda st: jnp.exp(-_f(st) / 2), k2)
  return _NT(k2, p)


def linregress(x, y=None, alternative="two-sided"):
  """Simple linear regression with full scipy result fields."""
  def kern(xx, yy):
    xx, yy = _f(xx), _f(yy)
    n = float(xx.shape[0])
    xm, ym = xx.mean(), yy.mean()
    sxx = ((xx - xm) ** 2).sum()
    sxy = ((xx - xm) * (yy - ym)).sum()
    syy = ((yy - ym) ** 2).sum()
    slope = sxy / sxx
    intercept = ym - slope * xm
    r = jnp.clip(sxy / jnp.sqrt(sxx * syy), -1.0, 1.0)
    df = jnp.asarray(n - 2, xx.dtype)
    tstat = r * jnp.sqrt(df / jnp.maximum(1 - r * r, 1e-300))
    p = _t_alt(tstat, df, alternative)
    resid = syy - slope * sxy
    se = jnp.sqrt(resid / df / sxx)
    se_i = se * jnp.sqrt((xx * xx).mean())
    return slope, intercept, r, p, se, se_i
  return _LR(*_map_multi(kern, 6, x, y))


def mannwhitneyu(x, y, use_continuity=True, alternative="two-sided",
                 axis=0, method="auto"):
  """Mann-Whitney U (normal approximation with tie correction)."""
  X, Y = sp.lazify(x), sp.lazify(y)
  n1, n2 = X.shape[0], Y.shape[0]

  def kern(xx, yy):
    xx, yy = _f(xx), _f(yy)
    allv = jnp.concatenate([xx, yy])
    import jax.scipy.stats as _jst
    r = _jst.rankdata(allv)
    R1 = r[:n1].sum()
    U1 = R1 - n1 * (n1 + 1) / 2.0
    n = n1 + n2
    # tie correction: sum(t^3 - t) over tie groups
    sv = jnp.sort(allv)
    newg = jnp.concatenate([jnp.ones(1, bool), sv[1:] != sv[:-1]])
    gid = jnp.cumsum(newg) - 1
    tcounts = jnp.zeros(n, sv.dtype).at[gid].add(1.0)
    tie = (tcounts ** 3 - tcounts).sum()
    mu = n1 * n2 / 2.0
    s2 = n1 * n2 / 12.0 * ((n + 1) - tie / (n * (n - 1.0)))
    if alternative == "two-sided":
      num = jnp.abs(U1 - mu)
    elif alternative == "greater":
      num = U1 - mu
    else:
      num = mu - U1
    cc = 0.5 if use_continuity else 0.0
    z = (num - cc) / jnp.sqrt(s2)
    p = _jss.ndtr(-z)
    p = jnp.clip(2 * p if alternative == "two-sided" else p, 0.0, 1.0)
    return U1, p
  s, p = _map_multi(kern, 2, X, Y)
  M = collections.namedtuple("MannwhitneyuResult",
                             ["statistic", "pvalue"])
  return M(s, p)


def ranksums(x, y, alternative="two-sided", *, axis=0):
  """Wilcoxon rank-sum test (normal approximation)."""
  X, Y = sp.lazify(x), sp.lazify(y)
  n1, n2 = X.shape[0], Y.shape[0]

  def kern(xx, yy):
    import jax.scipy.stats as _jst
    allv = jnp.concatenate([_f(xx), _f(yy)])
    r = _jst.rankdata(allv)
    R1 = r[:n1].sum()
    mu = n1 * (n1 + n2 + 1) / 2.0
    z = (R1 - mu) / jnp.sqrt(n1 * n2 * (n1 + n2 + 1) / 12.0)
    return z, _z_alt(z, alternative)
  s, p = _map_multi(kern, 2, X, Y)
  return _SG(s, p)


def kruskal(*samples, nan_policy="propagate", axis=0):
  """Kruskal-Wallis H test (device ranks + chi2 p)."""
  ops = [sp.lazify(s) for s in samples]
  ns = [o.shape[0] for o in ops]
  k = len(ops)

  def kern(*ss):
    import jax.scipy.stats as _jst
    allv = jnp.concatenate([_f(s) for s in ss])
    n = allv.shape[0]
    r = _jst.rankdata(allv)
    H = 0.0
    off = 0
    for ni in ns:
      H = H + r[off:off + ni].sum() ** 2 / ni
      off += ni
    H = 12.0 / (n * (n + 1)) * H - 3 * (n + 1)
    sv = jnp.sort(allv)
    newg = jnp.concatenate([jnp.ones(1, bool), sv[1:] != sv[:-1]])
    gid = jnp.cumsum(newg) - 1
    tc = jnp.zeros(n, sv.dtype).at[gid].add(1.0)
    H = H / (1.0 - (tc ** 3 - tc).sum() / (n ** 3 - n))
    df = jnp.asarray(float(k - 1), H.dtype)
    return H, _jss.gammaincc(df / 2, H / 2)
  s, p = _map_multi(kern, 2, *ops)
  K = collections.namedtuple("KruskalResult", ["statistic", "pvalue"])
  return K(s, p)


def combine_pvalues(pvalues, method="fisher", weights=None):
  """Combine p-values (Fisher / Stouffer on device)."""
  def kern(pp):
    pp = _f(pp)
    k = pp.shape[0]
    if method == "fisher":
      stat = -2.0 * jnp.log(pp).sum()
      df = jnp.asarray(float(2 * k), pp.dtype)
      return stat, _jss.gammaincc(df / 2, stat / 2)
    if method == "stouffer":
      z = _jss.ndtri(1.0 - pp)
      stat = z.sum() / np.sqrt(k)
      return stat, _jss.ndtr(-stat)
    raise ValueError(f"unsupported method {method!r}")
  s, p = _map_multi(kern, 2, pvalues)
  return _SG(s, p)


def gaussian_kde(dataset, bw_method=None, weights=None):
  """Gaussian KDE (jax.scipy.stats.gaussian_kde — pairwise kernel
  sums ride the matrix units; evaluate/logpdf/pdf return device arrays)."""
  import jax.scipy.stats as _jst
  ds = np.asarray(sp.lazify(dataset).glom())
  w = None if weights is None else np.asarray(sp.lazify(weights).glom())
  return _jst.gaussian_kde(jnp.asarray(ds), bw_method=bw_method,
                           weights=None if w is None
                           else jnp.asarray(w))


# ---------------------------------------------------------------------
# host boundary: the rest of scipy.stats (exotic distributions keep
# their full scipy API as re-exported objects)
# ---------------------------------------------------------------------

_host_noticed = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info("sp.stats.%s: no device implementation — runs EAGERLY on "
           "the host (scipy.stats), the sp.linalg.eig convention.",
           name)


def _host_call(name, *args, **kw):
  _host_notice(name)
  conv = [np.asarray(sp.lazify(a).glom())
          if isinstance(a, (Expr, np.ndarray)) else a for a in args]
  return getattr(_sst, name)(*conv, **kw)


def _host_stats(name):
  def op(*args, **kw):
    return _host_call(name, *args, **kw)
  op.__name__ = name
  op.__doc__ = (f"scipy.stats.{name} — host boundary (eager scipy "
                "call with a once-per-process notice).")
  return op


_HOST_NAMES = []
for _n in dir(_sst):
  if _n.startswith("_") or _n in globals():
    continue
  _obj = getattr(_sst, _n)
  if _inspect.ismodule(_obj):
    globals()[_n] = _obj       # public submodules (qmc/contingency/
    continue                   # mstats/...) re-export whole, host
  if (_inspect.isclass(_obj) or not _py_callable(_obj)
      or isinstance(_obj, (_sst.rv_continuous, _sst.rv_discrete))
      or type(_obj).__module__.startswith("scipy.stats")):
    globals()[_n] = _obj       # result classes, rv_* bases, frozen
    _HOST_NAMES.append(_n)     # distribution objects (full scipy API)
  else:
    globals()[_n] = _host_stats(_n)
    _HOST_NAMES.append(_n)
_HOST_NAMES = sorted(_HOST_NAMES)

__all__ = sorted(n for n in dir()
                 if not n.startswith("_") and n not in
                 ("annotations", "jax", "jnp", "np", "sp", "Expr",
                  "collections", "log_info"))
