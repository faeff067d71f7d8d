"""``sp.optimize`` — the scipy.optimize surface over fused device loops.

The reference has no optimization module (its examples hand-roll SGD —
SURVEY.md §2.5); this is beyond-parity surface built the sparse_linalg
way: every iterative solver is ONE compiled ``jax.lax.while_loop`` (no
per-iteration host syncs), Jacobians/Hessians come from the autodiff
bridge (``jax.jacfwd`` over the lowered DAG), and the linear algebra in
each step (normal equations, Newton solves) runs on the matrix units.

Objective/residual functions may be either

* **expr-native**: a callable receiving a lazy ``Expr`` parameter vector
  and returning an ``Expr`` built from ``sp.*`` ops (the framework
  idiom), or
* **jax-traceable**: a callable on raw arrays using ``jnp``/numpy-style
  ops — wrapped into the lazy layer via one ``sp.map`` node.

Both lower through :func:`spartan_tpu.autodiff.as_function`, so
sharding, the optimizer passes, and the replication guards all apply.

Host boundaries (the sp.linalg.eig convention, logged once):
``linear_sum_assignment`` and ``nnls`` (exact active-set / Hungarian
algorithms are inherently sequential).
"""

from __future__ import annotations

import inspect

import numpy as np

import spartan_tpu as sp
from spartan_tpu.autodiff import as_function
from spartan_tpu.expr.base import Expr, Val
from spartan_tpu.util import log_info


__all__ = [
    "OptimizeResult", "least_squares", "curve_fit", "root",
    "root_scalar", "bisect", "newton", "minimize_scalar", "minimize",
    "linear_sum_assignment", "nnls",
]


class OptimizeResult(dict):
  """scipy-style result: a dict with attribute access."""

  def __getattr__(self, name):
    try:
      return self[name]
    except KeyError as e:  # pragma: no cover
      raise AttributeError(name) from e

  __setattr__ = dict.__setitem__

  def __repr__(self):
    return "\n".join(f"{k}: {v}" for k, v in sorted(self.items()))


def _float_dtype():
  import jax
  import jax.numpy as jnp
  return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _probe_objective(fun, leaf, args):
  """Lower a user callable to an Expr on ``leaf``, distinguishing
  "not expr-native" from "expr-native but buggy".

  TypeError/AttributeError from the probe call means the callable's ops
  reject an Expr argument (``jnp.*`` interop) — fall back to one
  ``sp.map`` node.  Any OTHER exception is remembered: if the map path
  then also fails (its shape trace is forced here so bugs surface NOW,
  not later inside a solver loop), the probe error is chained as the
  likely real bug instead of being silently swallowed (ADVICE r4)."""
  import jax.numpy as jnp
  probe_err = None
  try:
    out = fun(leaf, *args)
  except (TypeError, AttributeError):
    out = None
  except Exception as e:
    probe_err = e
    out = None
  if isinstance(out, Expr):
    return out
  name = getattr(fun, "__name__", repr(fun))
  try:
    out = sp.map([leaf], lambda p: jnp.asarray(fun(p, *args)))
    out.shape  # force the eval_shape trace so genuine bugs raise here
    return out
  except Exception as e2:
    if probe_err is not None:
      raise RuntimeError(
          f"objective {name!r} failed both on the lazy Expr parameter "
          f"({probe_err!r}) and under jax tracing ({e2!r}); the first "
          "error is likely the real bug in the objective") from probe_err
    raise


def _lower(fun, x0, args):
  """Callable → pure jax ``f(p)`` through the lazy layer.

  Expr-native callables build a DAG on a Val leaf; jax-traceable ones
  are wrapped in one map node.  Either way as_function applies the
  optimizer passes and autodiff-safe emission.  The leaf is built from
  the RAVELED x0 so scalar/2-D starts see the same (n,) vector the
  solvers pass in (ADVICE r4)."""
  import jax.numpy as jnp
  x0 = jnp.ravel(jnp.atleast_1d(jnp.asarray(x0, _float_dtype())))
  leaf = sp.lazify(np.asarray(x0))
  if not isinstance(leaf, Val):  # pragma: no cover
    raise TypeError("could not build a parameter leaf")
  out = _probe_objective(fun, leaf, args)
  fn, fargs = as_function(out, [leaf], differentiable=True)
  return (lambda p: jnp.ravel(jnp.asarray(fn(p)))), x0


# ---------------------------------------------------------------------
# nonlinear least squares
# ---------------------------------------------------------------------

def _parse_bounds(bounds, n, dtype, pairs=False):
  """scipy bounds forms → (lo, hi) (n,) arrays (±inf when unbounded).

  ``pairs=True`` is the minimize convention (a (lo, hi) pair PER
  parameter, or a Bounds object); ``pairs=False`` is the least_squares
  convention (one global (lo, hi) of scalars-or-arrays).  The two are
  shape-ambiguous at n=2, so the caller must say which."""
  import jax.numpy as jnp
  if bounds is None:
    bounds = (-np.inf, np.inf)
    pairs = False
  if hasattr(bounds, "lb"):  # scipy.optimize.Bounds
    lo, hi = bounds.lb, bounds.ub
  elif pairs:
    b = np.asarray(
        [[-np.inf if l is None else l, np.inf if h is None else h]
         for (l, h) in bounds], dtype=float)
    lo, hi = b[:, 0], b[:, 1]
  else:  # (lo, hi) scalars or arrays (least_squares convention)
    lo, hi = bounds
  lo = jnp.broadcast_to(jnp.asarray(lo, dtype), (n,))
  hi = jnp.broadcast_to(jnp.asarray(hi, dtype), (n,))
  if bool(jnp.any(lo > hi)):
    raise ValueError("each lower bound must be <= its upper bound")
  return lo, hi


def least_squares(fun, x0, args=(), method: str = None,
                  bounds=(-np.inf, np.inf),
                  xtol: float = 1e-10, gtol: float = 1e-10,
                  ftol: float = 1e-10, max_nfev: int = 200):
  """Nonlinear least squares, fused: the whole damped-Newton iteration
  (residual, ``jacfwd`` Jacobian, normal equations, trust-region damping
  update) is one compiled while_loop.

  ``method`` defaults to 'lm' unbounded and 'trf' when finite ``bounds``
  are given (scipy's 'lm' rejects bounds — same contract here).  The
  bounded path is a PROJECTED LM: each trial step is clipped into the
  box and optimality is measured on the projected gradient
  ``x - clip(x - g, lo, hi)`` — the KKT measure scipy's TRF reports.
  As the damping grows the step tends to a short projected-gradient
  step, so stalls at active bounds resolve toward the constrained
  optimum.  Parameter counts are assumed matmul-friendly-small (the J^T J
  normal equations are formed explicitly).

  Returns an :class:`OptimizeResult` with scipy's fields (``x``,
  ``cost``, ``fun``, ``jac``, ``grad``, ``optimality``, ``status``,
  ``success``, ``nfev``)."""
  import jax
  import jax.numpy as jnp
  resfn, x0 = _lower(fun, x0, args)
  n = x0.size
  lo, hi = _parse_bounds(bounds, n, x0.dtype)
  bounded = bool(jnp.any(jnp.isfinite(lo)) | jnp.any(jnp.isfinite(hi)))
  if method is None:
    method = "trf" if bounded else "lm"
  if method not in ("lm", "gn", "trf"):
    raise ValueError(f"method must be 'lm', 'gn' or 'trf', got {method!r}")
  if method in ("lm", "gn") and bounded:
    raise ValueError(f"method {method!r} doesn't support bounds; "
                     "use method='trf'")

  def clip(x):
    return jnp.clip(x, lo, hi) if bounded else x

  def proj_grad(x, g):
    return x - jnp.clip(x - g, lo, hi) if bounded else g

  def cost_of(r):
    return 0.5 * jnp.dot(r, r)

  @jax.jit
  def run(x0):
    x0 = clip(x0)
    r0 = resfn(x0)
    state = (x0, jnp.asarray(1e-3, x0.dtype), cost_of(r0),
             jnp.int32(0), jnp.int32(0))

    def cond(s):
      _, _, _, it, status = s
      return jnp.logical_and(status == 0, it < max_nfev)

    def body(s):
      x, lam, cost, it, status = s
      r = resfn(x)
      J = jax.jacfwd(resfn)(x)
      g = J.T @ r
      H = J.T @ J
      if bounded:
        # Bertsekas active-set freeze: coordinates AT a bound with the
        # gradient pushing outward leave the normal equations (a joint
        # Newton step would otherwise be ~0 for the free coordinates
        # once the clamped ones stop moving — measured stall)
        eps = 1e-10 + 1e-8 * jnp.abs(x)
        frozen = ((jnp.isfinite(lo) & (x <= lo + eps) & (g > 0)) |
                  (jnp.isfinite(hi) & (x >= hi - eps) & (g < 0)))
        F = (~frozen).astype(x.dtype)
        H = H * (F[:, None] * F[None, :]) + jnp.diag(1.0 - F)
        g_solve = g * F
      else:
        g_solve = g
      damp = lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-12)) \
          if method != "gn" else 0.0 * jnp.eye(n, dtype=x.dtype)
      dx = -jnp.linalg.solve(H + damp + 1e-14 * jnp.eye(n, dtype=x.dtype),
                             g_solve)
      x2 = clip(x + dx)
      step = x2 - x
      c2 = cost_of(resfn(x2))
      accept = c2 < cost
      x_new = jnp.where(accept, x2, x)
      lam_new = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12),
                          jnp.minimum(lam * 3.0, 1e12))
      cost_new = jnp.where(accept, c2, cost)
      # scipy status codes: 1 gtol, 2 ftol, 3 xtol
      st = jnp.where(jnp.max(jnp.abs(proj_grad(x, g))) < gtol, 1, 0)
      st = jnp.where((st == 0) & accept &
                     (cost - c2 <= ftol * jnp.maximum(cost, 1e-30)), 2, st)
      st = jnp.where((st == 0) & accept &
                     (jnp.linalg.norm(step) <
                      xtol * (xtol + jnp.linalg.norm(x))), 3, st)
      return x_new, lam_new, cost_new, it + 1, st.astype(jnp.int32)

    x, lam, cost, it, status = jax.lax.while_loop(cond, body, state)
    r = resfn(x)
    J = jax.jacfwd(resfn)(x)
    g = J.T @ r
    return x, cost_of(r), r, J, g, proj_grad(x, g), it, status

  x, cost, r, J, g, pg, it, status = run(x0)
  status = int(status)
  return OptimizeResult(
      x=np.asarray(x), cost=float(cost), fun=np.asarray(r),
      jac=np.asarray(J), grad=np.asarray(g),
      optimality=float(np.max(np.abs(np.asarray(pg)))),
      nfev=int(it), njev=int(it), status=status if status else 0,
      success=bool(status in (1, 2, 3)),
      message={0: "max_nfev reached", 1: "gtol satisfied",
               2: "ftol satisfied", 3: "xtol satisfied"}[status])


def curve_fit(f, xdata, ydata, p0=None, sigma=None,
              absolute_sigma: bool = False, **lsq_kw):
  """Fit ``f(x, *params)`` to data (scipy.optimize.curve_fit contract:
  returns ``(popt, pcov)``).  Rides :func:`least_squares` — one fused
  LM loop; the covariance comes from the final Jacobian's normal
  equations, scaled by the residual variance unless ``absolute_sigma``.
  """
  import jax.numpy as jnp
  xdata = np.asarray(xdata)
  ydata = np.asarray(ydata, dtype=float)
  if p0 is None:
    sig = inspect.signature(f)
    n = len(sig.parameters) - 1
    if n < 1:
      raise ValueError("cannot infer parameter count; pass p0")
    p0 = np.ones(n)
  p0 = np.atleast_1d(np.asarray(p0, dtype=float))
  n = p0.size
  w = None if sigma is None else 1.0 / np.asarray(sigma, dtype=float)

  def residual(p):
    model = f(xdata, *[p[i] for i in range(n)])
    r = model - ydata
    return r if w is None else r * w

  res = least_squares(residual, p0, **lsq_kw)
  m = res.fun.size
  JtJ = res.jac.T @ res.jac
  try:
    cov = np.linalg.inv(JtJ)
  except np.linalg.LinAlgError:
    cov = np.linalg.pinv(JtJ)
  if not absolute_sigma:
    dof = max(m - n, 1)
    cov = cov * (2.0 * res.cost / dof)
  return res.x, cov


# ---------------------------------------------------------------------
# root finding
# ---------------------------------------------------------------------

_ALPHAS = (1.0, 0.5, 0.25, 0.125)


def root(fun, x0, args=(), method: str = "newton", tol: float = 1e-10,
         maxiter: int = 100):
  """Vector root find: damped Newton with a 4-point backtracking line
  search, fused into one while_loop (``jacfwd`` Jacobian + matmul-based solve
  per step).  scipy's 'hybr' (MINPACK dogleg) is accepted as an alias —
  same fixed points, different globalization."""
  import jax
  import jax.numpy as jnp
  if method not in ("newton", "hybr"):
    raise ValueError(f"unknown method {method!r}")
  ffn, x0 = _lower(fun, x0, args)
  n = x0.size

  @jax.jit
  def run(x0):
    f0 = ffn(x0)

    def cond(s):
      x, fn2, it = s
      return jnp.logical_and(fn2 > tol * tol, it < maxiter)

    def body(s):
      x, fn2, it = s
      fv = ffn(x)
      J = jax.jacfwd(ffn)(x)
      dx = -jnp.linalg.solve(J + 1e-14 * jnp.eye(n, dtype=x.dtype), fv)
      cands = jnp.stack([x + a * dx for a in _ALPHAS])
      norms = jnp.stack([jnp.dot(ffn(c), ffn(c)) for c in cands])
      k = jnp.argmin(norms)
      return cands[k], norms[k], it + 1

    x, fn2, it = jax.lax.while_loop(
        cond, body, (x0, jnp.dot(f0, f0), jnp.int32(0)))
    return x, ffn(x), it

  x, fv, it = run(x0)
  fnorm = float(np.max(np.abs(np.asarray(fv))))
  return OptimizeResult(
      x=np.asarray(x), fun=np.asarray(fv), nfev=int(it) * 5,
      nit=int(it), success=bool(fnorm <= tol * max(1.0, fnorm + 1.0)
                                or float(np.dot(fv, fv)) <= tol * tol),
      message="converged" if float(np.dot(fv, fv)) <= tol * tol
      else "maxiter reached")


def bisect(f, a, b, args=(), xtol: float = 1e-12, maxiter: int = 200,
           full_output: bool = False):
  """Scalar bisection in one fused while_loop (f must bracket a root).

  ``full_output=True`` additionally returns ``(iterations, converged)``
  from the solver's own stopping criterion (interval width <= xtol)."""
  import jax
  import jax.numpy as jnp
  fa, fb = float(f(a, *args)), float(f(b, *args))
  if fa == 0:
    return (float(a), 0, True) if full_output else float(a)
  if fb == 0:
    return (float(b), 0, True) if full_output else float(b)
  if fa * fb > 0:
    raise ValueError("f(a) and f(b) must have opposite signs")
  dt = _float_dtype()

  def fj(x):
    return jnp.asarray(f(x, *args), dt)

  @jax.jit
  def run(a, b):
    def cond(s):
      a, b, it = s
      return jnp.logical_and(b - a > xtol, it < maxiter)

    def body(s):
      a, b, it = s
      m = 0.5 * (a + b)
      left = fj(a) * fj(m) <= 0
      return jnp.where(left, a, m), jnp.where(left, m, b), it + 1

    a, b, it = jax.lax.while_loop(
        cond, body, (jnp.asarray(a, dt), jnp.asarray(b, dt),
                     jnp.int32(0)))
    return 0.5 * (a + b), b - a, it

  root, width, it = run(a, b)
  if full_output:
    return float(root), int(it), bool(float(width) <= xtol)
  return float(root)


def newton(func, x0, args=(), tol: float = 1.48e-8, maxiter: int = 50,
           full_output: bool = False):
  """Scalar Newton iteration (derivative via ``jax.grad``), fused.

  ``full_output=True`` additionally returns ``(iterations, converged)``
  where converged means the last step satisfied ``|dx| <= tol``."""
  import jax
  import jax.numpy as jnp
  dt = _float_dtype()

  def fj(x):
    return jnp.asarray(func(x, *args), dt)

  g = jax.grad(lambda x: fj(x))

  @jax.jit
  def run(x0):
    def cond(s):
      x, dx, it = s
      return jnp.logical_and(jnp.abs(dx) > tol, it < maxiter)

    def body(s):
      x, _, it = s
      d = g(x)
      # zero-derivative guard: the fallback divisor must NEVER itself be
      # zero (sign(d)*eps + eps collapses to 0 for tiny negative d)
      safe = jnp.where(jnp.abs(d) < 1e-30,
                       jnp.where(d < 0, -1e-30, 1e-30), d)
      step = fj(x) / safe
      return x - step, step, it + 1

    x, dx, it = jax.lax.while_loop(
        cond, body, (jnp.asarray(x0, dt), jnp.asarray(2 * tol, dt),
                     jnp.int32(0)))
    return x, dx, it

  x, dx, it = run(x0)
  if full_output:
    conv = bool(np.isfinite(float(x)) and abs(float(dx)) <= tol)
    return float(x), int(it), conv
  return float(x)


def root_scalar(f, args=(), method: str = None, bracket=None, x0=None,
                xtol: float = 1e-12, maxiter: int = 200):
  """scipy.optimize.root_scalar front-end: 'bisect' with a bracket,
  'newton' with a start point (auto-picked).  ``iterations``/
  ``converged`` report the solver's ACTUAL work and its own stopping
  criterion (interval width / step size), not a fabricated count."""
  if method is None:
    method = "bisect" if bracket is not None else "newton"
  if method in ("bisect", "brentq"):
    if bracket is None:
      raise ValueError("bracket required for bisect")
    r, it, conv = bisect(f, bracket[0], bracket[1], args=args, xtol=xtol,
                         maxiter=maxiter, full_output=True)
    calls = 2 + 2 * it  # bracket check + two evals per bisection round
  elif method == "newton":
    if x0 is None:
      raise ValueError("x0 required for newton")
    r, it, conv = newton(f, x0, args=args, tol=xtol, maxiter=maxiter,
                         full_output=True)
    calls = 2 * it  # f and f' per step
  else:
    raise ValueError(f"unknown method {method!r}")
  return OptimizeResult(root=r, converged=conv,
                        function_calls=calls, iterations=it,
                        flag="converged" if conv else "not converged")


def minimize_scalar(f, bounds=None, bracket=None, args=(),
                    method: str = None, xtol: float = 1e-10,
                    maxiter: int = 200):
  """Golden-section scalar minimization in one fused while_loop."""
  import jax
  import jax.numpy as jnp
  if bounds is None and bracket is not None:
    bounds = (bracket[0], bracket[-1])
  if bounds is None:
    raise ValueError("bounds (or bracket) required")
  del method
  dt = _float_dtype()
  phi = (np.sqrt(5.0) - 1.0) / 2.0

  def fj(x):
    return jnp.asarray(f(x, *args), dt)

  @jax.jit
  def run(a, b):
    def cond(s):
      a, b, it = s
      return jnp.logical_and(b - a > xtol, it < maxiter)

    def body(s):
      a, b, it = s
      c = b - phi * (b - a)
      d = a + phi * (b - a)
      left = fj(c) < fj(d)
      return jnp.where(left, a, c), jnp.where(left, d, b), it + 1

    a, b, it = jax.lax.while_loop(
        cond, body, (jnp.asarray(bounds[0], dt),
                     jnp.asarray(bounds[1], dt), jnp.int32(0)))
    return 0.5 * (a + b), it

  x, it = run(*bounds)
  x = float(x)
  return OptimizeResult(x=x, fun=float(f(x, *args)), nit=int(it),
                        success=True)


def _minimize_bounded(f, x0, lo, hi, tol, maxiter):
  """Box-constrained minimization (the scipy L-BFGS-B role), fused.

  One compiled while_loop of DAMPED PROJECTED NEWTON steps: the Hessian
  is restricted to the free set (Bertsekas active-set rule — coordinates
  at a bound with the gradient pushing outward are frozen to identity
  rows), the damped solve ``(H_ff + λI) d = -g_ff`` is clipped into the
  box, and λ adapts LM-style (accept ⇒ λ/3, reject ⇒ λ·3) so large λ
  degrades gracefully to short projected-gradient steps — globally
  convergent, quadratic tail.  Stops on the projected-gradient KKT
  measure ``max|x - clip(x - g, lo, hi)| < tol``."""
  import jax
  import jax.numpy as jnp
  n = x0.size
  eye = jnp.eye(n, dtype=x0.dtype)

  @jax.jit
  def run(x0):
    x0 = jnp.clip(x0, lo, hi)
    f0 = f(x0)

    def proj_grad(x, g):
      return x - jnp.clip(x - g, lo, hi)

    def cond(s):
      x, fv, lam, it, status = s
      return jnp.logical_and(status == 0, it < maxiter)

    def body(s):
      x, fv, lam, it, status = s
      g = jax.grad(f)(x)
      H = jax.hessian(f)(x)
      eps_act = 1e-10 + 1e-8 * jnp.abs(x)
      frozen = ((jnp.isfinite(lo) & (x <= lo + eps_act) & (g > 0)) |
                (jnp.isfinite(hi) & (x >= hi - eps_act) & (g < 0)))
      F = (~frozen).astype(x.dtype)
      Hm = H * (F[:, None] * F[None, :]) + jnp.diag(1.0 - F) + lam * eye
      d = -jnp.linalg.solve(Hm, g * F)
      x2 = jnp.clip(x + d, lo, hi)
      f2 = f(x2)
      accept = jnp.isfinite(f2) & (f2 < fv)
      x_new = jnp.where(accept, x2, x)
      f_new = jnp.where(accept, f2, fv)
      lam_new = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12),
                          jnp.minimum(lam * 3.0, 1e12))
      pg = jnp.max(jnp.abs(proj_grad(x_new, jax.grad(f)(x_new))))
      st = jnp.where(pg < tol, 1, 0)
      return (x_new, f_new, lam_new, it + 1, st.astype(jnp.int32))

    state = (x0, f0, jnp.asarray(1e-4, x0.dtype), jnp.int32(0),
             jnp.int32(0))
    x, fv, lam, it, status = jax.lax.while_loop(cond, body, state)
    g = jax.grad(f)(x)
    return x, fv, proj_grad(x, g), it, status

  x, fv, pg, it, status = run(x0)
  return OptimizeResult(
      x=np.asarray(x), fun=float(fv), nit=int(it),
      status=int(status), success=bool(int(status) == 1),
      optimality=float(np.max(np.abs(np.asarray(pg)))),
      message="projected gradient below tol" if int(status) == 1
      else "maxiter reached")


def minimize(fun, x0=None, args=(), wrt=None, method: str = None,
             bounds=None, tol=None, options=None):
  """scipy.optimize.minimize front-end.

  Expr-native form: ``minimize(loss_expr, wrt=[leaves])`` delegates to
  :func:`spartan_tpu.minimize` (one-compile BFGS + Newton polish).
  Callable form: ``minimize(f, x0)`` lowers ``f`` through the lazy
  layer (expr-native or jax-traceable, like :func:`least_squares`) and
  runs the same fused BFGS — or, with ``bounds=`` (scipy's per-parameter
  ``(lo, hi)`` pairs or a ``Bounds`` object; method auto-picks
  'l-bfgs-b'), the fused projected-Newton box solver
  (:func:`_minimize_bounded`)."""
  from spartan_tpu import autodiff
  import jax.numpy as jnp
  opts = dict(options or {})
  if method is None:
    method = "l-bfgs-b" if bounds is not None else "bfgs"
  method = method.lower()
  if isinstance(fun, Expr):
    if wrt is None:
      raise ValueError("expr-form minimize needs wrt=[leaves]")
    if bounds is not None:
      raise ValueError("bounds= is supported in the callable form "
                       "minimize(f, x0, bounds=...); flatten the "
                       "parameters into one vector")
    params, info = autodiff.minimize(fun, wrt, method=method, tol=tol,
                                     options=options)
    return OptimizeResult(
        x=params if len(params) > 1 else np.asarray(params[0].glom()),
        fun=info["fun"], nit=info["nit"], success=info["success"],
        status=info["status"])
  if x0 is None:
    raise ValueError("callable-form minimize needs x0")
  if bounds is not None or method in ("l-bfgs-b", "tnc"):
    lossfn, x0v = _lower(fun, x0, args)
    f = lambda p: jnp.squeeze(lossfn(p))
    lo, hi = _parse_bounds(bounds, x0v.size, x0v.dtype, pairs=True)
    return _minimize_bounded(
        f, x0v, lo, hi, tol=tol if tol is not None else 1e-8,
        maxiter=int(opts.get("maxiter", 500)))
  x0 = np.atleast_1d(np.asarray(x0, dtype=float))
  leaf = sp.lazify(x0)
  loss = _probe_objective(fun, leaf, args)
  params, info = autodiff.minimize(loss, [leaf], method=method, tol=tol,
                                   options=options)
  return OptimizeResult(
      x=np.asarray(params[0].glom()), fun=info["fun"], nit=info["nit"],
      success=info["success"], status=info["status"])


# ---------------------------------------------------------------------
# host boundaries (inherently sequential exact algorithms)
# ---------------------------------------------------------------------

_host_noticed: set = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info(
      "sp.optimize.%s: inherently sequential exact algorithm — runs "
      "EAGERLY on the host (scipy.optimize), the sp.linalg.eig "
      "convention.", name)


def linear_sum_assignment(cost_matrix, maximize: bool = False):
  """Hungarian assignment — host boundary (scipy.optimize)."""
  _host_notice("linear_sum_assignment")
  import scipy.optimize as sopt
  c = np.asarray(sp.lazify(cost_matrix).glom())
  return sopt.linear_sum_assignment(c, maximize=maximize)


def nnls(A, b, maxiter=None):
  """Non-negative least squares — host boundary (active-set is
  sequential; for large problems use a projected-gradient FISTA on the
  lazy layer, see examples/lasso)."""
  _host_notice("nnls")
  import scipy.optimize as sopt
  return sopt.nnls(np.asarray(sp.lazify(A).glom()),
                   np.asarray(sp.lazify(b).glom()), maxiter=maxiter)


# ---------------------------------------------------------------------
# r5 parity sweep part 1: containers, warnings, quasi-Newton classes,
# test functions, derivative helpers.
# ---------------------------------------------------------------------

# OptimizeWarning / NoConvergence are RE-EXPORTED from scipy (not
# redefined): the host-boundary wrappers below (linprog, broyden1, ...)
# raise/emit scipy's classes, and a distinct local class would make
# `except sp.optimize.NoConvergence` silently never catch (code review
# r5s5).
from scipy.optimize import NoConvergence, OptimizeWarning  # noqa: E402


class Bounds:
  """Box-constraint container (scipy.optimize.Bounds): arrays broadcast
  against the parameter vector; consumed by minimize/least_squares/
  lsq_linear/differential_evolution."""

  def __init__(self, lb=-np.inf, ub=np.inf, keep_feasible=False):
    self.lb = np.asarray(lb, dtype=float)
    self.ub = np.asarray(ub, dtype=float)
    self.keep_feasible = keep_feasible

  def residual(self, x):
    x = np.asarray(x)
    return x - self.lb, self.ub - x

  def __repr__(self):
    return f"Bounds({self.lb!r}, {self.ub!r})"


class LinearConstraint:
  """``lb <= A @ x <= ub`` container (scipy parity; the fused solvers
  support box bounds — pass general constraints to the host-boundary
  ``linprog``/``milp``)."""

  def __init__(self, A, lb=-np.inf, ub=np.inf, keep_feasible=False):
    self.A = np.asarray(sp.lazify(A).glom())
    self.lb = np.asarray(lb, dtype=float)
    self.ub = np.asarray(ub, dtype=float)
    self.keep_feasible = keep_feasible

  def residual(self, x):
    ax = self.A @ np.asarray(x)
    return ax - self.lb, self.ub - ax


class NonlinearConstraint:
  """``lb <= fun(x) <= ub`` container (scipy parity)."""

  def __init__(self, fun, lb=-np.inf, ub=np.inf, jac=None, hess=None,
               keep_feasible=False, finite_diff_rel_step=None,
               finite_diff_jac_sparsity=None):
    self.fun = fun
    self.lb = np.asarray(lb, dtype=float)
    self.ub = np.asarray(ub, dtype=float)
    self.jac = jac
    self.hess = hess
    self.keep_feasible = keep_feasible
    self.finite_diff_rel_step = finite_diff_rel_step
    self.finite_diff_jac_sparsity = finite_diff_jac_sparsity


class RootResults:
  """Scalar-root result container (scipy.optimize.RootResults)."""

  def __init__(self, root, iterations, function_calls, flag,
               method="unknown"):
    self.root = root
    self.iterations = iterations
    self.function_calls = function_calls
    self.converged = flag == 0 or flag == "converged"
    self.flag = flag
    self.method = method

  def __repr__(self):
    keys = ("converged", "flag", "function_calls", "iterations",
            "root", "method")
    return "\n".join(f"{k:>20}: {getattr(self, k)}" for k in keys)


# Quasi-Newton update machinery and nonlin Jacobian classes: pure
# host-side numpy helper OBJECTS (they parameterize host minimizers and
# the host-boundary nonlin solvers below) — re-exported from scipy, the
# same convention as sparse_linalg.SuperLU.
from scipy.optimize import (  # noqa: E402
    HessianUpdateStrategy, BFGS, SR1, LbfgsInvHessProduct,
    BroydenFirst, InverseJacobian, KrylovJacobian,
)


def rosen(x):
  """Rosenbrock test function — expr-native (a lazy Expr in gives a
  lazy scalar out; numpy in gives a float)."""
  x = sp.lazify(x)
  out = sp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
  return out


def rosen_der(x):
  """Rosenbrock gradient — closed form, expr-native."""
  x = sp.lazify(x)
  xm, xp = x[:-1], x[1:]
  core = 200.0 * (xp - xm ** 2)
  dt = x.aval().dtype
  gl = sp.concatenate([-400.0 * xm * (xp - xm ** 2) - 2.0 * (1.0 - xm),
                       sp.zeros((1,), dtype=dt)])
  gr = sp.concatenate([sp.zeros((1,), dtype=dt), core])
  return gl + gr


def rosen_hess(x):
  """Rosenbrock Hessian — closed form (host numpy; the Hessian of the
  TEST function is diagnostic tooling, not a hot path)."""
  x = np.asarray(sp.lazify(x).glom(), dtype=float)
  n = x.size
  H = np.zeros((n, n))
  d = np.zeros(n)
  d[:-1] += 1200.0 * x[:-1] ** 2 - 400.0 * x[1:] + 2.0
  d[1:] += 200.0
  H[np.arange(n), np.arange(n)] = d
  off = -400.0 * x[:-1]
  H[np.arange(n - 1), np.arange(1, n)] = off
  H[np.arange(1, n), np.arange(n - 1)] = off
  return H


def rosen_hess_prod(x, p):
  """Rosenbrock Hessian-vector product."""
  return rosen_hess(x) @ np.asarray(sp.lazify(p).glom(), dtype=float)


def approx_fprime(xk, f, epsilon=None, *args):
  """Forward-difference gradient (scipy contract; host utility — for
  exact device gradients use ``sp.grad``)."""
  xk = np.asarray(sp.lazify(xk).glom(), dtype=float)
  if epsilon is None:
    epsilon = np.sqrt(np.finfo(float).eps)
  eps = np.broadcast_to(np.asarray(epsilon, dtype=float), xk.shape)
  f0 = float(np.asarray(sp.lazify(f(xk, *args)).glom()))
  g = np.empty_like(xk)
  for i in range(xk.size):
    xi = xk.copy()
    xi[i] += eps[i]
    g[i] = (float(np.asarray(sp.lazify(f(xi, *args)).glom())) - f0) / eps[i]
  return g


def check_grad(func, grad, x0, *args, epsilon=None, direction="all",
               rng=None, seed=None):
  """``|approx_fprime - grad|`` (scipy contract)."""
  x0 = np.asarray(sp.lazify(x0).glom(), dtype=float)
  ga = np.asarray(sp.lazify(grad(x0, *args)).glom(), dtype=float)
  if direction == "random":
    g = (rng if isinstance(rng, np.random.Generator)
         else np.random.default_rng(rng if rng is not None else seed))
    v = g.normal(size=x0.shape)
    v /= np.linalg.norm(v)
    fd = np.dot(approx_fprime(x0, func, epsilon, *args), v)
    return float(np.abs(fd - np.dot(ga, v)))
  fd = approx_fprime(x0, func, epsilon, *args)
  return float(np.sqrt(np.sum((fd - ga) ** 2)))


# ---------------------------------------------------------------------
# r5 parity sweep part 2: scalar roots (fused Brent/Ridder + host
# variants), fixed_point, scalar-minimizer front-ends.
# ---------------------------------------------------------------------

def brentq(f, a, b, args=(), xtol: float = 2e-12, rtol: float = None,
           maxiter: int = 100, full_output: bool = False, disp=True):
  """Brent's method (inverse-quadratic/secant/bisection) — the whole
  zeroin iteration as ONE fused while_loop (each branch decision is a
  where-select; one f evaluation per step, like the classic)."""
  import jax
  import jax.numpy as jnp
  del disp
  dt = _float_dtype()
  if rtol is None:
    rtol = float(4 * np.finfo(np.dtype(dt)).eps)

  def fj(x):
    return jnp.asarray(f(x, *args), dt)

  fa0 = float(fj(jnp.asarray(a, dt)))
  fb0 = float(fj(jnp.asarray(b, dt)))
  if fa0 * fb0 > 0:
    raise ValueError("f(a) and f(b) must have different signs")

  @jax.jit
  def run(a, b, fa, fb):
    def cond(s):
      a, b, c, d, e, fa, fb, fc, it, done = s
      return jnp.logical_and(~done, it < maxiter)

    def body(s):
      a, b, c, d, e, fa, fb, fc, it, done = s
      # re-bracket so b is best, c on the other side
      reb = fb * fc > 0
      c = jnp.where(reb, a, c)
      fc = jnp.where(reb, fa, fc)
      d = jnp.where(reb, b - a, d)
      e = jnp.where(reb, b - a, e)
      swap = jnp.abs(fc) < jnp.abs(fb)
      a2 = jnp.where(swap, b, a)
      b2 = jnp.where(swap, c, b)
      c2 = jnp.where(swap, a2, c)
      fa2 = jnp.where(swap, fb, fa)
      fb2 = jnp.where(swap, fc, fb)
      fc2 = jnp.where(swap, fa2, fc)
      tol1 = 0.5 * xtol + rtol * jnp.abs(b2)
      xm = 0.5 * (c2 - b2)
      finished = jnp.logical_or(jnp.abs(xm) <= tol1, fb2 == 0.0)
      # interpolation step
      s_ = fb2 / jnp.where(fa2 == 0, 1.0, fa2)
      sec = a2 == c2
      p_sec = 2.0 * xm * s_
      q_sec = 1.0 - s_
      qq = fa2 / jnp.where(fc2 == 0, 1.0, fc2)
      rr = fb2 / jnp.where(fc2 == 0, 1.0, fc2)
      p_iq = s_ * (2.0 * xm * qq * (qq - rr) - (b2 - a2) * (rr - 1.0))
      q_iq = (qq - 1.0) * (rr - 1.0) * (s_ - 1.0)
      p = jnp.where(sec, p_sec, p_iq)
      q = jnp.where(sec, q_sec, q_iq)
      q = jnp.where(p > 0, -q, q)
      p = jnp.abs(p)
      qs = jnp.where(q == 0, 1.0, q)
      accept = jnp.logical_and(
          jnp.logical_and(jnp.abs(e) >= tol1, jnp.abs(fa2) > jnp.abs(fb2)),
          2.0 * p < jnp.minimum(3.0 * xm * q - jnp.abs(tol1 * q),
                                jnp.abs(e * q)))
      d2 = jnp.where(accept, p / qs, xm)
      e2 = jnp.where(accept, d, d2)
      a3, fa3 = b2, fb2
      step = jnp.where(jnp.abs(d2) > tol1, d2,
                       jnp.where(xm >= 0, tol1, -tol1))
      b3 = jnp.where(finished, b2, b2 + step)
      fb3 = jnp.where(finished, fb2, fj(b3))
      return (a3, b3, c2, d2, e2, fa3, fb3, fc2,
              it + jnp.where(finished, 0, 1), finished)

    init = (a, b, a, b - a, b - a, fa, fb, fa, jnp.int32(0),
            jnp.asarray(False))
    a, b, c, d, e, fa, fb, fc, it, done = jax.lax.while_loop(
        cond, body, init)
    return b, it, done

  r, it, done = run(jnp.asarray(a, dt), jnp.asarray(b, dt),
                    jnp.asarray(fa0, dt), jnp.asarray(fb0, dt))
  r, it, conv = float(r), int(it), bool(done)
  if full_output:
    return r, RootResults(r, it, it + 2, 0 if conv else 1,
                          method="brentq")
  return r


def ridder(f, a, b, args=(), xtol: float = 2e-12, rtol: float = None,
           maxiter: int = 100, full_output: bool = False, disp=True):
  """Ridders' method — one fused while_loop (two f evals per step,
  exponential-fit root update + re-bracketing via where-selects)."""
  import jax
  import jax.numpy as jnp
  del disp
  dt = _float_dtype()
  if rtol is None:
    rtol = float(4 * np.finfo(np.dtype(dt)).eps)

  def fj(x):
    return jnp.asarray(f(x, *args), dt)

  fa0 = float(fj(jnp.asarray(a, dt)))
  fb0 = float(fj(jnp.asarray(b, dt)))
  if fa0 * fb0 > 0:
    raise ValueError("f(a) and f(b) must have different signs")

  @jax.jit
  def run(a, b, fa, fb):
    def cond(s):
      a, b, fa, fb, it = s
      tol1 = xtol + rtol * jnp.abs(0.5 * (a + b))
      return jnp.logical_and(jnp.abs(b - a) > tol1, it < maxiter)

    def body(s):
      a, b, fa, fb, it = s
      c = 0.5 * (a + b)
      fc = fj(c)
      sq = jnp.sqrt(jnp.maximum(fc * fc - fa * fb, 0.0))
      sqs = jnp.where(sq == 0, 1.0, sq)
      x = c + (c - a) * jnp.sign(fa - fb) * fc / sqs
      fx = fj(x)
      # re-bracket: prefer (c, x), else (a, x), else (x, b)
      cx = fc * fx < 0
      ax = fa * fx < 0
      lo = jnp.where(cx, jnp.minimum(c, x),
                     jnp.where(ax, a, jnp.minimum(x, b)))
      hi = jnp.where(cx, jnp.maximum(c, x),
                     jnp.where(ax, x, jnp.maximum(x, b)))
      flo = jnp.where(cx, jnp.where(c <= x, fc, fx),
                      jnp.where(ax, fa, jnp.where(x <= b, fx, fb)))
      fhi = jnp.where(cx, jnp.where(c <= x, fx, fc),
                      jnp.where(ax, fx, jnp.where(x <= b, fb, fx)))
      stall = sq == 0
      return (jnp.where(stall, a, lo), jnp.where(stall, b, hi),
              jnp.where(stall, fa, flo), jnp.where(stall, fb, fhi),
              it + 1)

    a, b, fa, fb, it = jax.lax.while_loop(
        cond, body, (a, b, fa, fb, jnp.int32(0)))
    root = jnp.where(jnp.abs(fa) < jnp.abs(fb), a, b)
    return root, it

  r, it = run(jnp.asarray(min(a, b), dt), jnp.asarray(max(a, b), dt),
              jnp.asarray(fa0 if a <= b else fb0, dt),
              jnp.asarray(fb0 if a <= b else fa0, dt))
  r, it = float(r), int(it)
  conv = it < maxiter
  if full_output:
    return r, RootResults(r, it, 2 * it + 2, 0 if conv else 1,
                          method="ridder")
  return r


def brenth(f, a, b, args=(), xtol: float = 2e-12, rtol: float = None,
           maxiter: int = 100, full_output: bool = False, disp=True):
  """Brent with hyperbolic extrapolation — same bracket contract as
  :func:`brentq`; routed to the fused brentq loop (the hyperbolic
  variant differs only in its interpolation formula)."""
  return brentq(f, a, b, args=args, xtol=xtol, rtol=rtol,
                maxiter=maxiter, full_output=full_output, disp=disp)


def toms748(f, a, b, args=(), k=1, xtol: float = 2e-12, rtol=None,
            maxiter: int = 100, full_output: bool = False, disp=True):
  """TOMS 748 — same bracket-to-xtol contract; routed to the fused
  Brent loop (Alefeld's cubic bookkeeping buys <2x fewer evals on
  scalar problems where each eval is already a fused device step)."""
  del k
  return brentq(f, a, b, args=args, xtol=xtol, rtol=rtol,
                maxiter=maxiter, full_output=full_output, disp=disp)


def fixed_point(func, x0, args=(), xtol: float = 1e-8,
                maxiter: int = 500, method: str = "del2"):
  """Fixed point of ``func`` — one fused while_loop; ``method='del2'``
  is scipy's Steffensen/Aitken acceleration, ``'iteration'`` plain."""
  import jax
  import jax.numpy as jnp
  if method not in ("del2", "iteration"):
    raise ValueError(f"unknown method {method!r}")
  dt = _float_dtype()
  x0a = jnp.atleast_1d(jnp.asarray(x0, dt))

  def fj(x):
    return jnp.asarray(func(x, *args), dt)

  @jax.jit
  def run(x0):
    def cond(s):
      x, rel, it = s
      return jnp.logical_and(rel >= xtol, it < maxiter)

    def body(s):
      x, rel, it = s
      p1 = fj(x)
      if method == "del2":
        p2 = fj(p1)
        d = p2 - 2.0 * p1 + x
        ds = jnp.where(d == 0, 1.0, d)
        p = jnp.where(d == 0, p2, x - (p1 - x) ** 2 / ds)
      else:
        p = p1
      rel2 = jnp.max(jnp.abs(jnp.where(p != 0, (p - x) / p, p - x)))
      return p, rel2, it + 1

    x, rel, it = jax.lax.while_loop(
        cond, body, (x0, jnp.asarray(np.inf, dt), jnp.int32(0)))
    return x, rel, it

  x, rel, it = run(x0a)
  if float(rel) >= xtol:
    raise RuntimeError(f"Failed to converge after {int(it)} iterations, "
                       f"value is {np.asarray(x)}")
  x = np.asarray(x)
  return x if np.ndim(x0) else x.reshape(np.shape(x0)) if x.size > 1 \
      else x[()] if x.ndim == 0 else float(x[0])


def fminbound(func, x1, x2, args=(), xtol: float = 1e-5,
              maxfun: int = 500, full_output: int = 0, disp: int = 1):
  """Bounded scalar minimization — the fused golden-section loop."""
  del disp
  res = minimize_scalar(func, bounds=(x1, x2), args=args, xtol=xtol,
                        maxiter=maxfun)
  if full_output:
    return res.x, res.fun, 0 if res.success else 1, res.nit
  return res.x


def brent(func, args=(), brack=None, tol: float = 1.48e-8,
          full_output: int = 0, maxiter: int = 500):
  """Scalar minimization given a bracket — the fused golden-section
  loop (Brent's parabolic steps buy ~2x fewer evals; each eval here is
  one fused device step)."""
  if brack is None:
    brack = bracket(func, args=args)[:3]
  a, b = min(brack[0], brack[-1]), max(brack[0], brack[-1])
  res = minimize_scalar(func, bounds=(a, b), args=args, xtol=tol,
                        maxiter=maxiter)
  if full_output:
    return res.x, res.fun, res.nit, res.nit * 2
  return res.x


def golden(func, args=(), brack=None, tol=None, full_output: int = 0,
           maxiter: int = 5000):
  """Golden-section scalar minimization (the fused loop directly)."""
  if tol is None:
    tol = np.sqrt(np.finfo(float).eps)
  if brack is None:
    brack = bracket(func, args=args)[:3]
  a, b = min(brack[0], brack[-1]), max(brack[0], brack[-1])
  res = minimize_scalar(func, bounds=(a, b), args=args, xtol=tol,
                        maxiter=maxiter)
  if full_output:
    return res.x, res.fun, res.nit * 2
  return res.x


def bracket(func, xa: float = 0.0, xb: float = 1.0, args=(),
            grow_limit: float = 110.0, maxiter: int = 1000):
  """Downhill bracket search (scipy contract: returns
  ``(xa, xb, xc, fa, fb, fc, funcalls)`` with ``fb < fa, fb < fc``) —
  host scalar bookkeeping around golden-ratio expansion."""
  gold = 1.618034
  fa = float(np.asarray(func(xa, *args)))
  fb = float(np.asarray(func(xb, *args)))
  calls = 2
  if fa < fb:
    xa, xb, fa, fb = xb, xa, fb, fa
  xc = xb + gold * (xb - xa)
  fc = float(np.asarray(func(xc, *args)))
  calls += 1
  it = 0
  while fc < fb:
    if it >= maxiter:
      raise RuntimeError("Too many iterations in bracket()")
    it += 1
    xd = xc + gold * (xc - xb)
    fd = float(np.asarray(func(xd, *args)))
    calls += 1
    xa, xb, xc = xb, xc, xd
    fa, fb, fc = fb, fc, fd
  return xa, xb, xc, fa, fb, fc, calls


# ---------------------------------------------------------------------
# r5 parity sweep part 3: simplex + global optimizers (fused), legacy
# fmin_* front-ends, bounded linear lsq, nonlin host boundaries.
# ---------------------------------------------------------------------

def _nelder_mead(f, x0, xatol, fatol, maxiter):
  """Fused Nelder–Mead: the (n+1, n) simplex is carried through ONE
  while_loop; reflection/expansion/contraction/shrink are where-selects
  and the shrink re-evaluation is a vmap — every candidate f is
  computed each step (n+4 evals/step, all inside the compiled loop)."""
  import jax
  import jax.numpy as jnp
  n = x0.size
  dt = x0.dtype

  @jax.jit
  def run(x0):
    pert = jnp.where(jnp.abs(x0) > 1e-12, 0.05 * jnp.abs(x0), 0.00025)
    simplex = jnp.concatenate(
        [x0[None, :], x0[None, :] + jnp.diag(pert)], axis=0)
    fv = jax.vmap(f)(simplex)

    def cond(s):
      simplex, fv, it = s
      sized = jnp.max(jnp.abs(simplex[1:] - simplex[0])) > xatol
      spread = jnp.max(jnp.abs(fv[1:] - fv[0])) > fatol
      return jnp.logical_and(jnp.logical_or(sized, spread), it < maxiter)

    def body(s):
      simplex, fv, it = s
      order = jnp.argsort(fv)
      simplex = simplex[order]
      fv = fv[order]
      best, worst = simplex[0], simplex[-1]
      centroid = jnp.mean(simplex[:-1], axis=0)
      xr = centroid + (centroid - worst)
      fr = f(xr)
      xe = centroid + 2.0 * (centroid - worst)
      fe = f(xe)
      x_oc = centroid + 0.5 * (xr - centroid)
      f_oc = f(x_oc)
      x_ic = centroid - 0.5 * (centroid - worst)
      f_ic = f(x_ic)
      # candidate replacement for the worst vertex
      expand = jnp.logical_and(fr < fv[0], fe < fr)
      reflect = jnp.logical_and(fr >= fv[0], fr < fv[-2])
      out_con = jnp.logical_and(fr >= fv[-2], fr < fv[-1])
      use_oc = jnp.logical_and(out_con, f_oc <= fr)
      use_ic = jnp.logical_and(fr >= fv[-1], f_ic < fv[-1])
      newx = jnp.where(expand, xe,
             jnp.where(jnp.logical_or(fr < fv[0], reflect), xr,
             jnp.where(use_oc, x_oc,
             jnp.where(use_ic, x_ic, worst))))
      newf = jnp.where(expand, fe,
             jnp.where(jnp.logical_or(fr < fv[0], reflect), fr,
             jnp.where(use_oc, f_oc,
             jnp.where(use_ic, f_ic, fv[-1]))))
      shrink = jnp.logical_and(
          jnp.logical_not(jnp.logical_or(
              jnp.logical_or(fr < fv[-2], use_oc), use_ic)),
          jnp.asarray(True))
      cand = simplex.at[-1].set(newx)
      candf = fv.at[-1].set(newf)
      shrunk = best[None, :] + 0.5 * (simplex - best[None, :])
      shrunkf = jax.vmap(f)(shrunk)
      simplex2 = jnp.where(shrink, shrunk, cand)
      fv2 = jnp.where(shrink, shrunkf, candf)
      return simplex2, fv2, it + 1

    simplex, fv, it = jax.lax.while_loop(
        cond, body, (simplex, fv, jnp.int32(0)))
    k = jnp.argmin(fv)
    return simplex[k], fv[k], it

  return run(x0)


def fmin(func, x0, args=(), xtol: float = 1e-4, ftol: float = 1e-4,
         maxiter: int = None, maxfun=None, full_output: int = 0,
         disp: int = 1, retall: int = 0, callback=None,
         initial_simplex=None):
  """Nelder–Mead (scipy fmin) — the FUSED simplex loop (derivative-
  free, one compiled while_loop)."""
  import jax.numpy as jnp
  del maxfun, disp, retall, callback, initial_simplex
  lossfn, x0v = _lower(func, x0, args)
  f = lambda p: jnp.squeeze(lossfn(p))
  maxiter = int(maxiter) if maxiter else 200 * x0v.size
  x, fx, it = _nelder_mead(f, x0v, xatol=xtol, fatol=ftol,
                           maxiter=maxiter)
  x = np.asarray(x)
  if full_output:
    return x, float(fx), int(it), int(it) * (x0v.size + 4), \
        0 if int(it) < maxiter else 1
  return x


def fmin_bfgs(f, x0, fprime=None, args=(), gtol: float = 1e-5, **kw):
  """BFGS front-end — the fused one-compile BFGS (gradients come from
  autodiff; an explicit ``fprime`` is accepted and ignored)."""
  del fprime
  res = minimize(f, x0, args=args, method="bfgs", tol=gtol)
  if kw.get("full_output"):
    return res.x, res.fun, None, None, 0, 0, res.status
  return res.x


def fmin_cg(f, x0, fprime=None, args=(), gtol: float = 1e-5, **kw):
  """Nonlinear-CG front-end — routed to the fused BFGS loop (same
  smooth-minimization contract; BFGS dominates CG at the matmul-friendly
  parameter counts these front-ends see)."""
  del fprime
  res = minimize(f, x0, args=args, method="bfgs", tol=gtol)
  if kw.get("full_output"):
    return res.x, res.fun, 0, 0, res.status
  return res.x


def fmin_ncg(f, x0, fprime=None, fhess_p=None, fhess=None, args=(),
             avextol: float = 1e-5, **kw):
  """Newton-CG front-end — the fused BFGS + Newton-polish loop already
  IS a (quasi-)Newton method; explicit Hessian callables are accepted
  and ignored (autodiff supplies exact curvature)."""
  del fprime, fhess_p, fhess
  res = minimize(f, x0, args=args, method="bfgs", tol=avextol)
  if kw.get("full_output"):
    return res.x, res.fun, 0, 0, 0, res.status
  return res.x


def fmin_powell(func, x0, args=(), xtol: float = 1e-4,
                ftol: float = 1e-4, maxiter: int = None, **kw):
  """Powell front-end — routed to the fused Nelder–Mead loop (the
  derivative-free contract; direction-set bookkeeping is sequential
  host logic the simplex loop replaces).  ``full_output`` returns
  scipy's 6-tuple; the ``direc`` slot is the identity (the simplex
  loop keeps no direction set)."""
  if not kw.get("full_output"):
    return fmin(func, x0, args=args, xtol=xtol, ftol=ftol,
                maxiter=maxiter)
  x, fx, it, fc, flag = fmin(func, x0, args=args, xtol=xtol, ftol=ftol,
                             maxiter=maxiter, full_output=True)
  return x, fx, np.eye(np.atleast_1d(np.asarray(x)).size), it, fc, flag


def fmin_l_bfgs_b(func, x0, fprime=None, args=(), approx_grad: int = 0,
                  bounds=None, m: int = 10, factr: float = 1e7,
                  pgtol: float = 1e-5, **kw):
  """L-BFGS-B front-end — the fused projected-Newton box solver.
  Returns scipy's ``(x, f, info_dict)`` triple."""
  del fprime, approx_grad, m
  tol = max(pgtol, factr * np.finfo(float).eps)
  res = minimize(func, x0, args=args, bounds=bounds, method="l-bfgs-b",
                 tol=tol, options={"maxiter": int(kw.get("maxiter", 500))})
  # the gradient at the minimum (scipy returns it in the info dict) —
  # one autodiff evaluation of the lowered objective
  import jax
  import jax.numpy as jnp
  lossfn, _ = _lower(func, res.x, args)
  grad = np.asarray(jax.grad(lambda p: jnp.squeeze(lossfn(p)))(
      jnp.asarray(np.ravel(res.x), _float_dtype())))
  return res.x, res.fun, {"grad": grad,
                          "task": b"CONVERGED" if res.success
                          else b"MAXITER", "nit": res.nit,
                          "funcalls": res.nit,
                          "warnflag": 0 if res.success else 1}


def fmin_tnc(func, x0, fprime=None, args=(), approx_grad: int = 0,
             bounds=None, **kw):
  """TNC front-end — the fused projected-Newton box solver.  Returns
  scipy's ``(x, nfeval, rc)``."""
  del fprime, approx_grad, kw
  res = minimize(func, x0, args=args, bounds=bounds, method="l-bfgs-b")
  return res.x, res.nit, 1 if res.success else 4


def leastsq(func, x0, args=(), Dfun=None, full_output: bool = False,
            col_deriv=False, ftol: float = 1.49012e-8,
            xtol: float = 1.49012e-8, gtol: float = 0.0,
            maxfev: int = 0, epsfcn=None, factor=100, diag=None):
  """MINPACK leastsq front-end — the fused LM loop.  Returns
  ``(x, ier)`` or the full 5-tuple."""
  del Dfun, col_deriv, epsfcn, factor, diag
  res = least_squares(func, x0, args=args, method="lm",
                      xtol=xtol, ftol=ftol, gtol=max(gtol, 1e-12),
                      max_nfev=int(maxfev) if maxfev else 200)
  ier = 1 if res.success else 5
  if full_output:
    J = np.asarray(res.jac)
    try:
      cov_x = np.linalg.inv(J.T @ J)
    except np.linalg.LinAlgError:
      cov_x = None
    info = {"nfev": res.nfev, "fvec": np.asarray(res.fun)}
    return res.x, cov_x, info, res.get("message", ""), ier
  return res.x, ier


def fsolve(func, x0, args=(), fprime=None, full_output: bool = False,
           col_deriv=0, xtol: float = 1.49012e-8, maxfev: int = 0,
           band=None, epsfcn=None, factor=100, diag=None):
  """MINPACK hybrd front-end — the fused damped-Newton vector root
  loop."""
  del fprime, col_deriv, band, epsfcn, factor, diag
  res = root(func, x0, args=args, method="hybr", tol=xtol,
             maxiter=int(maxfev) if maxfev else 100)
  if full_output:
    info = {"nfev": res.nfev, "fvec": np.asarray(res.fun)}
    return res.x, info, 1 if res.success else 5, res.get("message", "")
  return res.x


def lsq_linear(A, b, bounds=(-np.inf, np.inf), method: str = "trf",
               tol: float = 1e-10, max_iter: int = None, **kw):
  """Bounded linear least squares ``min |Ax-b|, lo<=x<=hi`` — the
  fused projected-Newton box loop with the EXACT quadratic objective
  (gradient/Hessian are closed-form; unbounded input short-circuits to
  the device lstsq kernel)."""
  import jax.numpy as jnp
  del method, kw
  Ae = sp.lazify(A)
  be = sp.lazify(b)
  m, n = Ae.shape
  dt = _float_dtype()
  Ad = jnp.asarray(np.asarray(Ae.glom()), dt)
  bd = jnp.asarray(np.asarray(be.glom()), dt)
  lo, hi = _parse_bounds(bounds, n, dt)
  if not (bool(jnp.any(jnp.isfinite(lo)))
          or bool(jnp.any(jnp.isfinite(hi)))):
    x = sp.linalg.lstsq(Ae, be)  # returns the solution expr directly
    xa = np.asarray(sp.lazify(x).glom())
    r = np.asarray(Ae.glom()) @ xa - np.asarray(be.glom())
    return OptimizeResult(x=xa, cost=0.5 * float(r @ r), fun=r,
                          optimality=float(np.abs(
                              np.asarray(Ae.glom()).T @ r).max()),
                          active_mask=np.zeros(n, int), nit=1,
                          status=1, success=True)

  def f(p):
    r = Ad @ p - bd
    return 0.5 * jnp.dot(r, r)

  res = _minimize_bounded(f, jnp.clip(jnp.zeros(n, dt), lo, hi), lo, hi,
                          tol=tol, maxiter=int(max_iter or 500))
  xa = np.asarray(res.x)
  r = np.asarray(Ad) @ xa - np.asarray(bd)
  g = np.asarray(Ad).T @ r
  active = np.where(xa <= np.asarray(lo) + 1e-12, -1,
                    np.where(xa >= np.asarray(hi) - 1e-12, 1, 0))
  pg = xa - np.clip(xa - g, np.asarray(lo), np.asarray(hi))
  return OptimizeResult(x=xa, cost=0.5 * float(r @ r), fun=r,
                        optimality=float(np.abs(pg).max()),
                        active_mask=active, nit=res.nit,
                        status=res.status, success=res.success)


def line_search(f, myfprime, xk, pk, gfk=None, old_fval=None,
                old_old_fval=None, args=(), c1=1e-4, c2=0.9,
                amax=None, extra_condition=None, maxiter=10):
  """Wolfe line search — host utility (scipy's zoom bookkeeping; the
  fused solvers embed their own backtracking)."""
  import scipy.optimize as sopt
  _host_notice("line_search")
  return sopt.line_search(f, myfprime, np.asarray(xk), np.asarray(pk),
                          gfk=gfk, old_fval=old_fval,
                          old_old_fval=old_old_fval, args=args, c1=c1,
                          c2=c2, amax=amax,
                          extra_condition=extra_condition,
                          maxiter=maxiter)


def differential_evolution(func, bounds, args=(), strategy="best1bin",
                           maxiter: int = 1000, popsize: int = 15,
                           tol: float = 0.01, mutation=(0.5, 1),
                           recombination: float = 0.7, seed=None,
                           polish: bool = True, init="random",
                           atol: float = 0, **kw):
  """Differential evolution ON DEVICE: the whole population rides one
  fused while_loop (generation = vectorized best1bin mutation +
  binomial crossover + a vmapped batch evaluation of every trial —
  population-parallel work the vector and matrix units eats), with scipy's
  std(f) <= atol + tol*|mean(f)| stop.  ``polish=True`` finishes with
  the fused projected-Newton box solver."""
  import jax
  import jax.numpy as jnp
  del strategy, init, kw
  dt = _float_dtype()
  if hasattr(bounds, "lb"):  # scipy Bounds object
    n_par = np.broadcast(np.asarray(bounds.lb),
                         np.asarray(bounds.ub)).size
    lob, hib = _parse_bounds(bounds, n_par, dt, pairs=True)
  else:
    blist = list(bounds)  # materialize ONCE (generators)
    lob, hib = _parse_bounds(blist, len(blist), dt, pairs=True)
  n = lob.shape[0]
  x0 = np.asarray(0.5 * (np.where(np.isfinite(lob), lob, -1.0)
                         + np.where(np.isfinite(hib), hib, 1.0)))
  lossfn, _ = _lower(func, x0, args)
  f = lambda p: jnp.squeeze(lossfn(p))
  NP = max(popsize * n, 5)
  lo_m, hi_m = float(mutation[0]), float(mutation[1])
  key0 = jax.random.PRNGKey(0 if seed is None else int(seed))

  @jax.jit
  def run(key):
    key, k1 = jax.random.split(key)
    pop = lob + jax.random.uniform(k1, (NP, n), dt) * (hib - lob)
    fv = jax.vmap(f)(pop)

    def cond(s):
      pop, fv, key, it = s
      conv = jnp.std(fv) <= atol + tol * jnp.abs(jnp.mean(fv))
      return jnp.logical_and(~conv, it < maxiter)

    def body(s):
      pop, fv, key, it = s
      key, km, kr1, kr2, kc, kf = jax.random.split(key, 6)
      best = pop[jnp.argmin(fv)]
      r1 = jax.random.randint(kr1, (NP,), 0, NP)
      r2 = jax.random.randint(kr2, (NP,), 0, NP)
      F = jax.random.uniform(kf, (), dt, lo_m, hi_m)  # dithering
      mutant = best[None, :] + F * (pop[r1] - pop[r2])
      cross = jax.random.uniform(kc, (NP, n), dt) < recombination
      force = jax.random.randint(km, (NP,), 0, n)
      cross = cross | (jnp.arange(n)[None, :] == force[:, None])
      trial = jnp.clip(jnp.where(cross, mutant, pop), lob, hib)
      ft = jax.vmap(f)(trial)
      better = ft < fv
      return (jnp.where(better[:, None], trial, pop),
              jnp.where(better, ft, fv), key, it + 1)

    pop, fv, key, it = jax.lax.while_loop(
        cond, body, (pop, fv, key, jnp.int32(0)))
    k = jnp.argmin(fv)
    return pop[k], fv[k], it

  x, fx, it = run(key0)
  nit = int(it)
  x = np.asarray(x)
  fx = float(fx)
  if polish:
    res = _minimize_bounded(f, jnp.asarray(x), lob, hib, tol=1e-10,
                            maxiter=200)
    if float(res.fun) <= fx:
      x, fx = np.asarray(res.x), float(res.fun)
  return OptimizeResult(x=x, fun=fx, nit=nit,
                        nfev=(nit + 1) * NP, success=True,
                        message="Optimization terminated successfully.")


def brute(func, ranges, args=(), Ns: int = 20, full_output: int = 0,
          finish=fmin, disp=False, workers=1):
  """Grid search ON DEVICE: the full grid is evaluated as one vmapped
  batch (scipy loops in python); ``finish`` polishes with the fused
  simplex by default."""
  import jax
  import jax.numpy as jnp
  del disp, workers
  axes = []
  for r in ranges:
    if isinstance(r, slice):
      if r.step is None:
        axes.append(np.linspace(r.start, r.stop, Ns))
      elif np.iscomplexobj(r.step):
        # np.mgrid convention: complex step = point COUNT, inclusive
        axes.append(np.linspace(r.start, r.stop, int(abs(r.step))))
      else:
        axes.append(np.arange(r.start, r.stop, r.step))
    else:
      axes.append(np.linspace(r[0], r[1], Ns))
  grids = np.meshgrid(*axes, indexing="ij")
  pts = np.stack([g.ravel() for g in grids], axis=1)
  n = pts.shape[1]
  lossfn, _ = _lower(func, pts[0], args)
  f = lambda p: jnp.squeeze(lossfn(p))
  fvals = np.asarray(jax.jit(jax.vmap(f))(jnp.asarray(
      pts, _float_dtype())))
  k = int(np.argmin(fvals))
  x0, f0 = pts[k], float(fvals[k])
  xmin, fmin_val = x0, f0
  if finish is not None:
    out = finish(func, x0, args=args, full_output=True)
    if float(out[1]) <= f0:
      xmin, fmin_val = np.asarray(out[0]), float(out[1])
  xmin = xmin if n > 1 else float(xmin[0])
  if full_output:
    grid = grids[0] if n == 1 else np.stack(grids)
    return xmin, fmin_val, grid, fvals.reshape(grids[0].shape)
  return xmin


# --- host boundaries: exact/adaptive sequential algorithms ------------

def _host_opt(name, why, *args, **kw):
  _host_notice(name)
  import scipy.optimize as sopt
  del why
  return getattr(sopt, name)(*args, **kw)


def _glom_f(fun):
  """User callable → host numpy callable (objectives passed to the
  host-boundary drivers may still be expr-native)."""
  def g(x, *a):
    out = fun(x, *a)
    return np.asarray(sp.lazify(out).glom()) if isinstance(out, Expr) \
        else out
  return g


def linprog(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, bounds=None,
            method="highs", callback=None, options=None,
            x0=None, integrality=None):
  """Linear programming — host boundary (HiGHS simplex/IPM pivoting
  is sequential)."""
  _host_notice("linprog")
  import scipy.optimize as sopt
  g = lambda M: None if M is None else np.asarray(sp.lazify(M).glom())
  return sopt.linprog(g(c), A_ub=g(A_ub), b_ub=g(b_ub), A_eq=g(A_eq),
                      b_eq=g(b_eq), bounds=bounds, method=method,
                      callback=callback, options=options, x0=x0,
                      integrality=integrality)


def milp(c, *, constraints=(), integrality=None, bounds=None,
         options=None):
  """Mixed-integer LP — host boundary (branch and bound)."""
  _host_notice("milp")
  import scipy.optimize as sopt
  return sopt.milp(np.asarray(sp.lazify(c).glom()),
                   constraints=constraints, integrality=integrality,
                   bounds=bounds, options=options)


def basinhopping(func, x0, niter=100, T=1.0, stepsize=0.5,
                 minimizer_kwargs=None, take_step=None,
                 accept_test=None, callback=None, interval=50,
                 disp=False, niter_success=None, rng=None, seed=None,
                 target_accept_rate=0.5, stepwise_factor=0.9):
  """Basin hopping — host boundary (adaptive Metropolis driver; for a
  device-parallel global search use differential_evolution)."""
  return _host_opt(
      "basinhopping", "", _glom_f(func), np.asarray(x0), niter=niter,
      T=T, stepsize=stepsize, minimizer_kwargs=minimizer_kwargs,
      take_step=take_step, accept_test=accept_test, callback=callback,
      interval=interval, disp=disp, niter_success=niter_success,
      rng=rng if rng is not None else seed,
      target_accept_rate=target_accept_rate,
      stepwise_factor=stepwise_factor)


def dual_annealing(func, bounds, args=(), maxiter=1000, **kw):
  """Dual annealing — host boundary (sequential acceptance chain)."""
  return _host_opt("dual_annealing", "", _glom_f(func), bounds,
                   args=args, maxiter=maxiter, **kw)


def shgo(func, bounds, args=(), constraints=None, n=100, iters=1,
         **kw):
  """SHGO — host boundary (simplicial homology bookkeeping)."""
  return _host_opt("shgo", "", _glom_f(func), bounds, args=args,
                   constraints=constraints, n=n, iters=iters, **kw)


def direct(func, bounds, *, args=(), **kw):
  """DIRECT — host boundary (rectangle-division bookkeeping)."""
  return _host_opt("direct", "", _glom_f(func), bounds, args=args, **kw)


def isotonic_regression(y, *, weights=None, increasing=True):
  """Isotonic regression — host boundary (PAVA is a sequential scan)."""
  return _host_opt("isotonic_regression", "",
                   np.asarray(sp.lazify(y).glom()), weights=weights,
                   increasing=increasing)


def quadratic_assignment(A, B, method="faq", options=None):
  """QAP — host boundary."""
  return _host_opt("quadratic_assignment", "",
                   np.asarray(sp.lazify(A).glom()),
                   np.asarray(sp.lazify(B).glom()),
                   method=method, options=options)


def _nonlin(name, F, xin, **kw):
  _host_notice(name)
  import scipy.optimize as sopt
  return getattr(sopt, name)(_glom_f(F), np.asarray(xin), **kw)


def broyden1(F, xin, **kw):
  """Broyden's good method — host boundary (scipy.optimize.nonlin
  driver; for fused device root-finding use :func:`root`)."""
  return _nonlin("broyden1", F, xin, **kw)


def broyden2(F, xin, **kw):
  """Broyden's bad method — host boundary."""
  return _nonlin("broyden2", F, xin, **kw)


def anderson(F, xin, **kw):
  """Anderson mixing — host boundary."""
  return _nonlin("anderson", F, xin, **kw)


def linearmixing(F, xin, **kw):
  """Scalar linear mixing — host boundary."""
  return _nonlin("linearmixing", F, xin, **kw)


def diagbroyden(F, xin, **kw):
  """Diagonal Broyden — host boundary."""
  return _nonlin("diagbroyden", F, xin, **kw)


def excitingmixing(F, xin, **kw):
  """Tuned diagonal mixing — host boundary."""
  return _nonlin("excitingmixing", F, xin, **kw)


def newton_krylov(F, xin, **kw):
  """Newton–Krylov — host boundary (scipy's adaptive LGMRES inner
  loop; for fused device Newton use :func:`root`)."""
  return _nonlin("newton_krylov", F, xin, **kw)


__all__ += [
    "OptimizeWarning", "NoConvergence", "Bounds", "LinearConstraint",
    "NonlinearConstraint", "RootResults",
    "HessianUpdateStrategy", "BFGS", "SR1", "LbfgsInvHessProduct",
    "BroydenFirst", "InverseJacobian", "KrylovJacobian",
    "rosen", "rosen_der", "rosen_hess", "rosen_hess_prod",
    "approx_fprime", "check_grad",
    "brentq", "brenth", "ridder", "toms748", "fixed_point",
    "fminbound", "brent", "golden", "bracket",
    "fmin", "fmin_bfgs", "fmin_cg", "fmin_ncg", "fmin_powell",
    "fmin_l_bfgs_b", "fmin_tnc", "leastsq", "fsolve", "lsq_linear",
    "line_search", "differential_evolution", "brute",
    "linprog", "milp", "basinhopping", "dual_annealing", "shgo",
    "direct", "isotonic_regression", "quadratic_assignment",
    "broyden1", "broyden2", "anderson", "linearmixing", "diagbroyden",
    "excitingmixing", "newton_krylov",
]


def fmin_cobyla(func, x0, cons, args=(), consargs=None, rhobeg=1.0,
                rhoend=1e-4, maxfun=1000, disp=None, catol=2e-4,
                *, callback=None):
  """COBYLA (inequality-constrained, derivative-free) — host boundary
  (sequential linear-approximation trust region)."""
  _host_notice("fmin_cobyla")
  import scipy.optimize as sopt
  return sopt.fmin_cobyla(_glom_f(func), np.asarray(x0), cons,
                          args=args, consargs=consargs, rhobeg=rhobeg,
                          rhoend=rhoend, maxfun=maxfun, disp=disp,
                          catol=catol, callback=callback)


def fmin_slsqp(func, x0, eqcons=(), f_eqcons=None, ieqcons=(),
               f_ieqcons=None, bounds=(), fprime=None, args=(), **kw):
  """SLSQP (general constrained) — host boundary (sequential QP
  subproblems)."""
  _host_notice("fmin_slsqp")
  import scipy.optimize as sopt
  return sopt.fmin_slsqp(_glom_f(func), np.asarray(x0), eqcons=eqcons,
                         f_eqcons=f_eqcons, ieqcons=ieqcons,
                         f_ieqcons=f_ieqcons, bounds=bounds,
                         fprime=fprime, args=args, **kw)


__all__ += ["fmin_cobyla", "fmin_slsqp"]
