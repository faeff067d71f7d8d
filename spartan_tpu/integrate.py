"""``sp.integrate`` — the scipy.integrate surface, on device.

The reference has no integration module (SURVEY.md §2.5 — this is
beyond-parity surface, built the sp.optimize way): the ODE initial-value
solver is ONE compiled ``lax.while_loop`` carrying the whole adaptive
Runge–Kutta state (step size, FSAL derivative, and the ``t_eval`` output
buffer — accepted steps fill it with masked Hermite interpolation, so
there are no per-step host syncs at all), and the sampled-data rules
(trapezoid/simpson/romb) are vectorized lazy reductions.

Host boundaries (the sp.linalg.eig convention, logged once): QUADPACK's
adaptive quadrature (``quad``/``dblquad``/... — globally adaptive
subdivision is sequential host logic), the stiff ODE methods
(Radau/BDF/LSODA — variable-order Newton iterations with per-step
factorizations), ``odeint`` (LSODA semantics), and ``solve_bvp``.

Conventions:

* ``solve_ivp`` with ``t_eval=None`` returns only the endpoints
  ``t=[t0, tf]``: the adaptive interior step count is data-dependent
  (the framework's NotShapeable rule) — pass ``t_eval`` for interior
  samples, which is also scipy's recommended usage.
* ``fun(t, y)`` may be jax-traceable (jnp ops) or plain-python
  arithmetic on arrays; it is traced into the compiled loop.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp
from spartan_tpu.expr.base import Expr
from spartan_tpu.util import log_info

__all__ = [
    "trapezoid", "cumulative_trapezoid", "simpson", "cumulative_simpson",
    "romb", "fixed_quad", "newton_cotes", "qmc_quad", "tanhsinh",
    "solve_ivp", "odeint",
    "quad", "quad_vec", "dblquad", "tplquad", "nquad", "cubature",
    "nsum", "solve_bvp", "lebedev_rule",
    "OdeResult", "IntegrationWarning", "ODEintWarning",
    "RK23", "RK45", "DOP853", "Radau", "BDF", "LSODA",
    "OdeSolver", "OdeSolution", "DenseOutput", "ode", "complex_ode",
]

# scipy's solver/stepper CLASSES and warnings are host-side driver
# objects — re-exported (the sparse_linalg.SuperLU convention) so
# isinstance checks and warning filters interoperate.
from scipy.integrate import (  # noqa: E402
    IntegrationWarning, ODEintWarning, RK23, RK45, DOP853, Radau, BDF,
    LSODA, OdeSolver, OdeSolution, DenseOutput, ode, complex_ode,
)


class OdeResult(dict):
  """scipy-style bunch result (attribute access over a dict)."""

  def __getattr__(self, name):
    try:
      return self[name]
    except KeyError as e:  # pragma: no cover
      raise AttributeError(name) from e

  __setattr__ = dict.__setitem__

  def __repr__(self):
    return "\n".join(f"{k}: {v}" for k, v in sorted(self.items()))


# ---------------------------------------------------------------------
# sampled-data rules — vectorized lazy ops
# ---------------------------------------------------------------------

def trapezoid(y, x=None, dx: float = 1.0, axis: int = -1):
  """Composite trapezoid — the builtins ``trapz`` reduction."""
  return sp.trapz(y, x=x, dx=dx, axis=axis)


def cumulative_trapezoid(y, x=None, dx: float = 1.0, axis: int = -1,
                         initial=None):
  """Cumulative trapezoid — one lazy cumsum over panel areas."""
  y = sp.lazify(y)
  yl = sp.moveaxis(y, axis, -1) if axis not in (-1, y.ndim - 1) else y
  if x is not None:
    x = sp.lazify(x)
    d = x[1:] - x[:-1] if x.ndim == 1 else sp.moveaxis(
        x, axis, -1)[..., 1:] - sp.moveaxis(x, axis, -1)[..., :-1]
  else:
    d = dx
  panels = d * (yl[..., 1:] + yl[..., :-1]) / 2.0
  out = sp.cumsum(panels, axis=-1)
  if initial is not None:
    if initial != 0:
      raise ValueError("`initial` must be 0 or None (scipy 1.17)")
    pad = sp.zeros(tuple(out.shape[:-1]) + (1,), dtype=out.aval().dtype)
    out = sp.concatenate([pad, out], axis=-1)
  if axis not in (-1, y.ndim - 1):
    out = sp.moveaxis(out, -1, axis)
  return out


def _simpson_weights(n: int) -> np.ndarray:
  """Composite Simpson weights for n samples (odd n exact; even n uses
  scipy's corrected last interval)."""
  w = np.zeros(n)
  if n < 3:
    return np.array([0.5, 0.5])[:n] * (1 if n == 2 else 0)
  m = n if n % 2 == 1 else n - 1
  w[0:m - 2:2] += 1.0 / 3    # left ends
  w[1:m - 1:2] += 4.0 / 3    # midpoints
  w[2:m:2] += 1.0 / 3        # right ends
  if n % 2 == 0:  # scipy's even-sample correction (last 3 points)
    w[-3] += -1.0 / 12
    w[-2] += 8.0 / 12
    w[-1] += 5.0 / 12
  return w


def simpson(y, x=None, dx: float = 1.0, axis: int = -1):
  """Composite Simpson — one weighted lazy reduction for uniform
  spacing; non-uniform ``x`` uses scipy's per-pair quadratic formula
  (still one fused elementwise+reduce chain)."""
  y = sp.lazify(y)
  n = y.shape[axis]
  yl = sp.moveaxis(y, axis, -1) if axis not in (-1, y.ndim - 1) else y
  if x is None:
    w = sp.Val(_simpson_weights(n) * dx)
    out = sp.sum(yl * w, axis=-1)
    return out
  x = np.asarray(sp.lazify(x).glom(), dtype=float)
  if x.ndim != 1 or x.size != n:
    raise ValueError("x must be 1-D with len(x) == y.shape[axis]")
  # non-uniform composite Simpson (scipy's formulation): quadratic
  # through each sample triple; weights precomputed host-side (they
  # depend only on the grid), applied as one device reduction.
  w = np.zeros(n)
  m = n if n % 2 == 1 else n - 1
  for i in range(0, m - 2, 2):
    h0, h1 = x[i + 1] - x[i], x[i + 2] - x[i + 1]
    hsum, hprod = h0 + h1, h0 * h1
    h0div = h0 / h1 if h1 != 0 else 0.0
    w[i] += hsum / 6.0 * (2.0 - 1.0 / h0div if h0div else 0.0)
    w[i + 1] += hsum / 6.0 * (hsum * hsum / hprod if hprod else 0.0)
    w[i + 2] += hsum / 6.0 * (2.0 - h0div)
  if n % 2 == 0:  # trailing interval: scipy's corrected trapezoid
    h0 = x[-2] - x[-3] if n >= 3 else 0.0
    h1 = x[-1] - x[-2]
    if n >= 3 and h0 > 0:
      alpha = (2 * h1 * h1 + 3 * h0 * h1) / (6 * (h0 + h1))
      beta = (h1 * h1 + 3 * h0 * h1) / (6 * h0)
      eta = h1 ** 3 / (6 * h0 * (h0 + h1))
      w[-1] += alpha
      w[-2] += beta
      w[-3] -= eta
    else:
      w[-2] += h1 / 2
      w[-1] += h1 / 2
  return sp.sum(yl * sp.Val(w), axis=-1)


def cumulative_simpson(y, *, x=None, dx: float = 1.0, axis: int = -1,
                       initial=None):
  """Cumulative Simpson — host wrapper over scipy (its sub-interval
  split weights are awkward to vectorize exactly; the array is sampled
  data, already host-sized)."""
  import scipy.integrate as si
  ya = np.asarray(sp.lazify(y).glom())
  xa = None if x is None else np.asarray(sp.lazify(x).glom())
  return si.cumulative_simpson(ya, x=xa, dx=dx, axis=axis,
                               initial=initial)


def romb(y, dx: float = 1.0, axis: int = -1, show: bool = False):
  """Romberg integration of 2**k + 1 samples — the whole Richardson
  tableau is host-precomputed WEIGHTS (grid-only), applied as one
  device reduction."""
  del show
  y = sp.lazify(y)
  n = y.shape[axis]
  k = int(np.log2(n - 1))
  if 2 ** k + 1 != n:
    raise ValueError("Number of samples must be one plus a power of 2")
  # Build Romberg weights by running the tableau on indicator vectors:
  # the estimate is linear in y, so columns of the identity recover w.
  import scipy.integrate as si
  w = np.array([si.romb(np.eye(n)[i], dx=dx) for i in range(n)])
  yl = sp.moveaxis(y, axis, -1) if axis not in (-1, y.ndim - 1) else y
  return sp.sum(yl * sp.Val(w), axis=-1)


def fixed_quad(func, a: float, b: float, args=(), n: int = 5):
  """Fixed-order Gauss–Legendre — nodes host, ONE vectorized device
  evaluation of ``func`` over all n points."""
  nodes, weights = np.polynomial.legendre.leggauss(int(n))
  xm = 0.5 * (b + a) + 0.5 * (b - a) * nodes
  try:  # expr-native objective (TypeError = jnp ops reject Exprs)
    fx = func(sp.Val(xm), *args)
  except (TypeError, AttributeError):
    fx = None
  if not isinstance(fx, Expr):
    import jax.numpy as jnp
    fx = sp.map([sp.Val(xm)], lambda xs: jnp.asarray(func(xs, *args)))
  val = 0.5 * (b - a) * sp.sum(fx * sp.Val(weights), axis=-1)
  return float(np.asarray(sp.lazify(val).glom())), None


def newton_cotes(rn, equal: int = 0):
  """Newton–Cotes weights — exact host combinatorics (scipy)."""
  import scipy.integrate as si
  return si.newton_cotes(rn, equal)


def qmc_quad(func, a, b, *, n_estimates: int = 8, n_points: int = 1024,
             qrng=None, log: bool = False):
  """Quasi-Monte-Carlo integration — the Sobol points come from the
  host generator (RNG contract) but ALL ``n_estimates * n_points``
  evaluations run as one vmapped device batch."""
  import jax
  import jax.numpy as jnp
  from scipy.stats import qmc as _qmc
  a = np.atleast_1d(np.asarray(a, float))
  b = np.atleast_1d(np.asarray(b, float))
  d = a.size
  rng = qrng if qrng is not None else _qmc.Halton(d, seed=0)
  sets = np.stack([rng.random(n_points) for _ in range(n_estimates)])
  pts = a + sets * (b - a)              # (E, N, d)
  vol = float(np.prod(b - a))

  def one(x):
    out = func(x)
    return jnp.asarray(out)

  vals = np.asarray(jax.jit(jax.vmap(jax.vmap(one)))(jnp.asarray(pts)))
  ests = vals.mean(axis=1) * vol
  mean = float(ests.mean())
  se = float(ests.std(ddof=1) / np.sqrt(n_estimates))
  if log:
    mean, se = np.log(mean), se / abs(mean)
  return OdeResult(integral=mean, standard_error=se)


def tanhsinh(f, a: float, b: float, *, args=(), log: bool = False,
             maxlevel: int = 10, minlevel: int = 2, atol=None,
             rtol=None, preserve_shape: bool = False, callback=None):
  """tanh-sinh (double-exponential) quadrature — fixed-level device
  form: all abscissae up to ``maxlevel`` are host-precomputed, the
  function is evaluated in ONE vectorized device batch, and the level
  estimates are compared for the convergence report (scipy iterates
  levels adaptively on the host)."""
  del log, preserve_shape, callback
  if atol is None:
    atol = 0.0
  if rtol is None:
    rtol = 1e-12
  import jax
  import jax.numpy as jnp
  levels = []
  hs = [2.0 ** -k for k in range(minlevel, maxlevel + 1)]
  # abscissae/weights on (-1, 1): x = tanh(pi/2 sinh(t)), per level h
  for h in hs:
    t = np.arange(-int(4.0 / h), int(4.0 / h) + 1) * h
    x = np.tanh(0.5 * np.pi * np.sinh(t))
    w = h * 0.5 * np.pi * np.cosh(t) / np.cosh(0.5 * np.pi *
                                               np.sinh(t)) ** 2
    keep = np.abs(x) < 1.0 - 1e-15
    levels.append((x[keep], w[keep]))
  half = 0.5 * (b - a)
  mid = 0.5 * (b + a)

  def one(x):
    return jnp.asarray(f(x, *args))

  ests = []
  for x, w in levels:
    pts = mid + half * x
    vals = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(pts)))
    ests.append(half * float(np.sum(vals * w)))
  err = abs(ests[-1] - ests[-2]) if len(ests) > 1 else np.inf
  ok = err <= max(atol, rtol * abs(ests[-1]))
  return OdeResult(integral=ests[-1], error=err, success=bool(ok),
                   status=0 if ok else -2, maxlevel=maxlevel)


# ---------------------------------------------------------------------
# solve_ivp — fused adaptive Runge–Kutta
# ---------------------------------------------------------------------

# Dormand–Prince 5(4) tableau (scipy's RK45)
_DP_A = np.array([
    [0, 0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
])
_DP_C = np.array([0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1])
_DP_B = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784,
                  11 / 84, 0])
_DP_E = np.array([71 / 57600, 0, -71 / 16695, 71 / 1920,
                  -17253 / 339200, 22 / 525, -1 / 40])

# Bogacki–Shampine 3(2) (scipy's RK23)
_BS_A = np.array([[0, 0, 0], [1 / 2, 0, 0], [0, 3 / 4, 0]])
_BS_C = np.array([0, 1 / 2, 3 / 4])
_BS_B = np.array([2 / 9, 1 / 3, 4 / 9, 0])
_BS_E = np.array([5 / 72, -1 / 12, -1 / 9, 1 / 8])

_HOST_IVP_METHODS = ("Radau", "BDF", "LSODA", "DOP853")


def solve_ivp(fun, t_span, y0, method: str = "RK45", t_eval=None,
              dense_output: bool = False, events=None, vectorized=False,
              args=None, rtol: float = 1e-3, atol: float = 1e-6,
              max_step: float = np.inf, first_step=None,
              max_steps: int = 100_000):
  """Initial-value ODE solve.

  ``RK45``/``RK23`` run as ONE compiled adaptive loop on device: the
  while_loop carries (t, y, f_FSAL, h, output buffer); every accepted
  step fills the ``t_eval`` points it crossed by cubic-Hermite
  interpolation with a masked select over the whole buffer — zero
  host round trips for the entire integration.  Stiff methods
  (Radau/BDF/LSODA) and DOP853 route to scipy on the host (variable-
  order Newton with per-step factorizations — the eig convention).

  ``t_eval=None`` returns the ENDPOINTS only (t=[t0, tf]): the
  adaptive interior step count is a data-dependent shape.  ``events``
  and ``dense_output`` route to the host path."""
  import jax
  import jax.numpy as jnp
  t0, tf = float(t_span[0]), float(t_span[1])
  if args is not None:
    _f = fun
    fun = lambda t, y: _f(t, y, *args)
  if (method in _HOST_IVP_METHODS or events is not None or dense_output
      or vectorized):
    import scipy.integrate as si
    _host_notice(f"solve_ivp[{method}]"
                 if method in _HOST_IVP_METHODS else
                 "solve_ivp[events/dense_output]")
    return si.solve_ivp(lambda t, y: np.asarray(fun(t, y), float),
                        (t0, tf), np.asarray(y0, float), method=method,
                        t_eval=t_eval, dense_output=dense_output,
                        events=events, rtol=rtol, atol=atol,
                        max_step=max_step, first_step=first_step)
  if method not in ("RK45", "RK23"):
    raise ValueError(f"unknown method {method!r}")
  A, C, B, E = ((_DP_A, _DP_C, _DP_B, _DP_E) if method == "RK45"
                else (_BS_A, _BS_C, _BS_B, _BS_E))
  err_exp = -1.0 / (5.0 if method == "RK45" else 3.0)
  n_stages = len(C)

  dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
  y0a = jnp.atleast_1d(jnp.asarray(y0, dt))
  n = y0a.size
  direction = 1.0 if tf >= t0 else -1.0
  te = (np.asarray(t_eval, float) if t_eval is not None
        else np.array([t0, tf]))
  if t_eval is not None:
    lo, hi = min(t0, tf), max(t0, tf)
    if te.min() < lo - 1e-12 or te.max() > hi + 1e-12:
      raise ValueError("t_eval values must lie within t_span")
  m = te.size
  tev = jnp.asarray(te, dt)

  def fj(t, y):
    return jnp.asarray(fun(t, y), dt).reshape(n)

  Aj = jnp.asarray(A, dt)
  Cj = jnp.asarray(C, dt)
  Bj = jnp.asarray(B, dt)
  Ej = jnp.asarray(E, dt)

  @jax.jit
  def run(y0a):
    f0 = fj(jnp.asarray(t0, dt), y0a)
    # scipy's initial-step heuristic (simplified first stage)
    sc = atol + rtol * jnp.abs(y0a)
    d0 = jnp.sqrt(jnp.mean((y0a / sc) ** 2))
    d1 = jnp.sqrt(jnp.mean((f0 / sc) ** 2))
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    h_init = (jnp.asarray(first_step, dt) if first_step is not None
              else jnp.minimum(h0, jnp.asarray(abs(tf - t0), dt)))
    h_init = jnp.minimum(h_init, jnp.asarray(max_step, dt))
    ys = jnp.zeros((m, n), dt)
    # t_eval points exactly at t0 fill immediately
    at0 = jnp.abs(tev - t0) <= 1e-14 * jnp.maximum(1.0, abs(t0))
    ys = jnp.where(at0[:, None], y0a[None, :], ys)

    def cond(s):
      t, y, f, h, ys, k, status = s
      return (status == 0) & (direction * (jnp.asarray(tf, dt) - t)
                              > 1e-14 * jnp.maximum(jnp.abs(t), 1.0))

    def body(s):
      t, y, f, h, ys, k, status = s
      h = jnp.minimum(h, jnp.asarray(max_step, dt))
      h = jnp.minimum(h, jnp.abs(jnp.asarray(tf, dt) - t))
      hd = direction * h
      # stages (FSAL: stage 0 derivative is carried)
      K = jnp.zeros((n_stages + 1, n), dt).at[0].set(f)

      def stage(i, K):
        ti = t + Cj[i] * hd
        yi = y + hd * (Aj[i] @ K[:n_stages])
        return K.at[i].set(jnp.where(i == 0, K[0], fj(ti, yi)))

      K = jax.lax.fori_loop(1, n_stages, stage, K)
      y_new = y + hd * (Bj[:n_stages] @ K[:n_stages])
      f_new = fj(t + hd, y_new)
      K = K.at[n_stages].set(f_new)
      err = hd * (Ej @ K)
      scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
      enorm = jnp.sqrt(jnp.mean((err / scale) ** 2))
      accept = enorm <= 1.0
      factor = jnp.clip(0.9 * jnp.power(jnp.maximum(enorm, 1e-16),
                                        err_exp), 0.2, 10.0)
      h2 = jnp.maximum(h * factor, 1e-14)
      t2 = jnp.where(accept, t + hd, t)
      y2 = jnp.where(accept, y_new, y)
      f2 = jnp.where(accept, f_new, f)
      # fill crossed t_eval points by cubic Hermite on (t, t+hd)
      theta = (tev - t) / jnp.where(hd == 0, 1.0, hd)
      in_step = accept & (theta > 0.0) & (theta <= 1.0)
      th = theta[:, None]
      h00 = 2 * th ** 3 - 3 * th ** 2 + 1
      h10 = th ** 3 - 2 * th ** 2 + th
      h01 = -2 * th ** 3 + 3 * th ** 2
      h11 = th ** 3 - th ** 2
      interp = (h00 * y[None, :] + h10 * hd * f[None, :]
                + h01 * y_new[None, :] + h11 * hd * f_new[None, :])
      ys2 = jnp.where(in_step[:, None], interp, ys)
      status2 = jnp.where(k + 1 >= max_steps, -1, status)
      return t2, y2, f2, h2, ys2, k + 1, status2

    t, y, f, h, ys, k, status = jax.lax.while_loop(
        cond, body, (jnp.asarray(t0, dt), y0a, f0, h_init, ys,
                     jnp.int32(0), jnp.int32(0)))
    # the final point lands exactly by construction
    at_tf = jnp.abs(tev - tf) <= 1e-12 * jnp.maximum(1.0, abs(tf))
    ys = jnp.where(at_tf[:, None], y[None, :], ys)
    return t, y, ys, k, status

  t_end, y_end, ys, k, status = run(y0a)
  status = int(status)
  res_t = te if t_eval is not None else np.array([t0, tf])
  ya = np.asarray(ys).T
  if t_eval is None:
    ya = np.stack([np.asarray(y0a), np.asarray(y_end)], axis=1)
  return OdeResult(
      t=res_t, y=ya, success=status == 0, status=status,
      message=("The solver successfully reached the end of the "
               "integration interval." if status == 0
               else "Step limit reached."),
      nfev=int(k) * (n_stages + 1), njev=0, nlu=0, sol=None,
      t_events=None, y_events=None)


def odeint(func, y0, t, args=(), Dfun=None, full_output: int = 0,
           tfirst: bool = False, **kw):
  """LSODA odeint — host boundary (stiff/non-stiff switching with
  per-step Jacobian factorizations).  For the fused device path use
  :func:`solve_ivp` (RK45/RK23)."""
  _host_notice("odeint")
  import scipy.integrate as si

  def f(y, tt, *a):
    out = func(y, tt, *a) if not tfirst else func(tt, y, *a)
    return np.asarray(sp.lazify(out).glom()) if isinstance(out, Expr) \
        else np.asarray(out, float)

  return si.odeint(f, np.asarray(sp.lazify(y0).glom()),
                   np.asarray(sp.lazify(t).glom()), args=args,
                   Dfun=Dfun, full_output=full_output, **kw)


# ---------------------------------------------------------------------
# host boundaries: adaptive QUADPACK / BVP / series
# ---------------------------------------------------------------------

_host_noticed: set = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info(
      "sp.integrate.%s: globally-adaptive/sequential algorithm — runs "
      "EAGERLY on the host (scipy.integrate), the sp.linalg.eig "
      "convention.", name)


def _host_int(name, *args, **kw):
  _host_notice(name)
  import scipy.integrate as si
  return getattr(si, name)(*args, **kw)


def quad(func, a, b, args=(), full_output=0, **kw):
  """Adaptive QUADPACK quadrature — host boundary (for a device batch
  use :func:`fixed_quad`/:func:`tanhsinh`/:func:`qmc_quad`)."""
  return _host_int("quad", func, a, b, args=args,
                   full_output=full_output, **kw)


def quad_vec(f, a, b, **kw):
  return _host_int("quad_vec", f, a, b, **kw)


def dblquad(func, a, b, gfun, hfun, args=(), **kw):
  return _host_int("dblquad", func, a, b, gfun, hfun, args=args, **kw)


def tplquad(func, a, b, gfun, hfun, qfun, rfun, args=(), **kw):
  return _host_int("tplquad", func, a, b, gfun, hfun, qfun, rfun,
                   args=args, **kw)


def nquad(func, ranges, args=None, opts=None, full_output=False):
  return _host_int("nquad", func, ranges, args=args, opts=opts,
                   full_output=full_output)


def cubature(f, a, b, **kw):
  return _host_int("cubature", f, a, b, **kw)


def nsum(f, a, b, *, step=1, args=(), log=False, maxterms=None,
         tolerances=None):
  kw = {} if maxterms is None else {"maxterms": maxterms}
  if tolerances is not None:
    kw["tolerances"] = tolerances
  return _host_int("nsum", f, a, b, step=step, args=args, log=log, **kw)


def solve_bvp(fun, bc, x, y, p=None, S=None, fun_jac=None, bc_jac=None,
              tol: float = 1e-3, max_nodes: int = 1000, verbose=0):
  """Two-point BVP collocation — host boundary (adaptive mesh)."""
  return _host_int("solve_bvp", fun, bc, np.asarray(x), np.asarray(y),
                   p=p, S=S, fun_jac=fun_jac, bc_jac=bc_jac, tol=tol,
                   max_nodes=max_nodes, verbose=verbose)


def lebedev_rule(n):
  """Lebedev sphere quadrature nodes/weights — host tables."""
  return _host_int("lebedev_rule", n)
