"""Autodiff bridge: lazy DAGs as differentiable jax functions.

The reference has no autodiff — its examples hand-derive gradients
(SURVEY.md §2.5), and so do ours for parity.  But the rebuild's emitters
are jax-traceable by construction, so the whole functional-transform
toolbox comes for free: :func:`as_function` lowers a DAG to a pure
function of chosen leaves, and :func:`grad` / :func:`value_and_grad`
differentiate any scalar expr with respect to its inputs — a device-native
capability the RPC-based original could never offer.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spartan_tpu.core.array import SpartanArray
from spartan_tpu.expr import optimize as opt_mod
from spartan_tpu.expr.base import EmitCtx, Expr, Val


def as_function(expr: Expr, wrt: Sequence[Expr],
                differentiable: bool = False
                ) -> Tuple[Callable, List[jax.Array]]:
  """Lower ``expr``'s DAG to ``(fn, args)`` with ``fn(*args)`` pure jax.

  ``wrt`` must be ``Val`` leaves of the DAG (e.g. the exprs returned by
  ``sp.from_numpy``); every other leaf is closed over as a constant.
  Optimizer passes run first; leaf object identity survives them.
  ``differentiable=True`` asks emitters for autodiff-safe lowerings
  (no collective fast paths) — same values, same avals.
  """
  wrt_ids = [w.expr_id for w in wrt]
  for w in wrt:
    if not isinstance(w, Val):
      raise TypeError(f"wrt entries must be Val leaves, got {type(w)}")
  root = opt_mod.optimize(expr)

  # check the wrt leaves actually appear in the (optimized) DAG
  present = set()

  def scan(e: Expr):
    if isinstance(e, Val) and e.expr_id in wrt_ids:
      present.add(e.expr_id)

  root.visit(scan)
  missing = [i for i in wrt_ids if i not in present]
  if missing:
    raise ValueError(
        f"wrt leaves {missing} not found in the DAG (was a sub-expression "
        "already materialized and collapsed? pass opt_collapse_cached=False "
        "or rebuild the expr from un-evaluated leaves)")

  ctx = EmitCtx(abstract=False, differentiable=differentiable)
  pos = {eid: k for k, eid in enumerate(wrt_ids)}

  def fn(*args):
    env = {}

    def emit(e: Expr):
      if e.expr_id in env:
        return env[e.expr_id]
      if isinstance(e, Val):
        v = (args[pos[e.expr_id]] if e.expr_id in pos
             else e.leaf_value())
      else:
        v = e._emit(ctx, [emit(c) for c in e.children()])
      env[e.expr_id] = v
      return v

    return emit(root)

  args = [w.leaf_value() for w in wrt]
  return fn, args


def compile_fn(expr: Expr, wrt: Sequence[Expr], donate: Sequence[int] = ()):
  """Precompile a DAG into a reusable callable over the ``wrt`` leaves —
  the serving-style entry point: trace/compile once, then call with fresh
  values (numpy / jax / SpartanArray) at device speed.

      f = sp.compile(loss, wrt=[x_leaf])
      out = f(new_batch)          # SpartanArray

  ``donate`` lists wrt positions whose device buffers XLA may reuse for
  the outputs — the ``state = f(state)`` training-carry pattern runs
  without a second copy of the state in HBM.  A donated argument is
  consumed by the call (its buffer is gone afterwards); XLA silently
  skips donation when layouts/shardings don't line up, so it is always
  safe to request."""
  fn, args = as_function(expr, wrt)
  donate = tuple(int(i) for i in donate)
  jitted = jax.jit(fn, donate_argnums=donate) if donate else jax.jit(fn)
  # warm the compile with COPIES of donated slots — the template args are
  # the wrt leaves' live buffers, which the warm-up call must not consume
  warm = [jnp.array(a) if i in donate else a for i, a in enumerate(args)]
  jitted(*warm)  # compile now with the template shapes

  shapes = [tuple(a.shape) for a in args]

  def wrap(out):
    if isinstance(out, dict):
      return {k: SpartanArray(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
      return type(out)(SpartanArray(v) for v in out)
    return SpartanArray(out)

  def call(*new_vals):
    if len(new_vals) != len(args):
      raise TypeError(f"expected {len(args)} arguments, got {len(new_vals)}")
    vals = []
    for v, shp in zip(new_vals, shapes):
      data = v.data if isinstance(v, SpartanArray) else v
      if tuple(getattr(data, "shape", ())) != shp:
        raise ValueError(f"argument shape {getattr(data, 'shape', None)} "
                         f"!= compiled shape {shp}")
      vals.append(data)
    return wrap(jitted(*vals))

  return call


def grad(expr: Expr, wrt: Sequence[Expr]):
  """Gradients of a scalar expr w.r.t. leaf exprs → SpartanArrays."""
  fn, args = as_function(expr, wrt, differentiable=True)
  grads = jax.jit(jax.grad(fn, argnums=tuple(range(len(args)))))(*args)
  return [SpartanArray(g) for g in grads]


def value_and_grad(expr: Expr, wrt: Sequence[Expr]):
  fn, args = as_function(expr, wrt, differentiable=True)
  val, grads = jax.jit(
      jax.value_and_grad(fn, argnums=tuple(range(len(args)))))(*args)
  return SpartanArray(val), [SpartanArray(g) for g in grads]


def hessian(expr: Expr, wrt: Sequence[Expr]):
  """Full Hessians of a scalar expr w.r.t. each leaf.  For a single
  (d,) leaf returns one (d, d) SpartanArray; for several leaves, the
  list of per-leaf diagonal blocks (cross blocks via :func:`hvp`)."""
  fn, args = as_function(expr, wrt, differentiable=True)
  outs = []
  for i in range(len(args)):
    h = jax.jit(jax.hessian(fn, argnums=i))(*args)
    outs.append(SpartanArray(h))
  return outs[0] if len(outs) == 1 else outs


def hvp(expr: Expr, wrt: Sequence[Expr], vectors):
  """Hessian-vector products (forward-over-reverse — no materialized
  Hessian; the scalable curvature primitive for Newton-CG at scale)."""
  import jax.numpy as jnp
  fn, args = as_function(expr, wrt, differentiable=True)
  argnums = tuple(range(len(args)))

  def g(*a):
    return jax.grad(fn, argnums=argnums)(*a)

  vecs = tuple(jnp.asarray(v.glom() if isinstance(v, Expr)
                           else getattr(v, "data", v)) for v in vectors)
  _, tangents = jax.jit(lambda *a: jax.jvp(g, a, vecs))(*args)
  return [SpartanArray(t) for t in tangents]


def jvp(expr: Expr, wrt: Sequence[Expr], tangents):
  """Forward-mode: directional derivative of the DAG."""
  fn, args = as_function(expr, wrt, differentiable=True)
  primal, tangent = jax.jvp(fn, tuple(args),
                            tuple(jax.numpy.asarray(t) for t in tangents))
  return SpartanArray(primal), SpartanArray(tangent)


def minimize(loss_expr: Expr, wrt: Sequence[Expr], method: str = "bfgs",
             tol: Optional[float] = None, options: Optional[dict] = None,
             polish: bool = True):
  """Minimize a scalar lazy loss over its leaf parameters — the WHOLE
  optimization (line searches included) compiles into one on-device
  program via ``jax.scipy.optimize.minimize`` (BFGS).

  Multi-leaf ``wrt`` is flattened into one parameter vector and split
  back on return.  Returns ``(params, info)``: the optimized leaves as
  SpartanArrays and an info namespace (``fun``, ``nit``, ``success``).
  For stochastic/large-scale training use :func:`sgd_train`; for
  matrix-free curvature, :func:`hvp`."""
  import jax.numpy as jnp
  from jax.scipy.optimize import minimize as _jmin

  if method.lower() != "bfgs":
    raise ValueError("method must be 'bfgs' (jax.scipy.optimize backend)")
  fn, args = as_function(loss_expr, wrt, differentiable=True)
  shapes = [tuple(np.shape(a)) for a in args]
  sizes = [int(np.prod(s)) if s else 1 for s in shapes]
  bounds = np.cumsum([0] + sizes)

  def unflatten(x):
    return tuple(x[bounds[i]:bounds[i + 1]].reshape(shapes[i])
                 for i in range(len(shapes)))

  def flat_fn(x):
    return fn(*unflatten(x))

  fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
  x0 = jnp.concatenate([jnp.ravel(jnp.asarray(a, fdt)) for a in args])

  @jax.jit
  def run(x0):
    return _jmin(flat_fn, x0, method="BFGS", tol=tol,
                 options=options or {})

  res = run(x0)
  x, fun, success = res.x, float(res.fun), bool(res.success)
  # Newton polish: jax's BFGS zoom line search can stop early near flat
  # minima (status 3 — reproduced on a plain 16-dim least squares in
  # pure jax).  For small parameter counts, a few damped Newton steps on
  # the same lowered function finish the job exactly.
  if polish and x.size <= 512:
    @jax.jit
    def newton(x):
      g = jax.grad(flat_fn)(x)
      h = jax.hessian(flat_fn)(x)
      h = h + 1e-12 * jnp.eye(x.size, dtype=h.dtype)
      return x - jnp.linalg.solve(h, g), jnp.linalg.norm(g)

    for _ in range(5):
      x_new, gnorm = newton(x)
      if not np.isfinite(float(gnorm)) or float(gnorm) < 1e-12:
        break
      f_new = float(flat_fn(x_new))
      if not np.isfinite(f_new) or f_new > fun + 1e-12:
        break
      x, fun = x_new, f_new
    # success means CONVERGED, not merely improved: require the FINAL
    # gradient norm below a scale-aware bar (BFGS-success stays success)
    if not success:
      gfin = float(jnp.linalg.norm(jax.grad(flat_fn)(x)))
      success = np.isfinite(gfin) and gfin < (
          tol if tol is not None else 1e-6 * (1.0 + abs(fun)))
  parts = unflatten(x)
  return ([SpartanArray(jnp.asarray(p)) for p in parts],
          {"fun": fun, "nit": int(res.nit),
           "success": success, "status": int(res.status)})


def sgd_train(loss_expr: Expr, params: Sequence[Expr], lr: float,
              steps: int, collect_losses: bool = False):
  """One-compile SGD over ANY scalar lazy loss: differentiates the DAG
  w.r.t. the ``params`` leaves and runs all ``steps`` updates inside a
  single on-device ``lax.scan`` — the reference's per-step driver loop,
  collapsed into one program.

  Returns the updated params (SpartanArrays), plus the on-device loss
  curve when ``collect_losses``.
  """
  import jax.numpy as jnp
  from jax import lax

  fn, args = as_function(loss_expr, params, differentiable=True)
  grad_fn = jax.value_and_grad(fn, argnums=tuple(range(len(args))))

  @jax.jit
  def run(args):
    def step(ps, _):
      loss, grads = grad_fn(*ps)
      new = tuple(p - lr * g for p, g in zip(ps, grads))
      return new, loss

    final, losses = lax.scan(step, tuple(args), None, length=steps)
    return final, losses

  final, losses = run(tuple(args))
  out = [SpartanArray(p) for p in final]
  if collect_losses:
    return out, SpartanArray(losses)
  return out
