"""Autodiff bridge: jax.grad over lazy DAGs (JAX-native bonus — the
reference's examples hand-derive gradients; here both paths exist and must
agree)."""

import numpy as np
import pytest

import spartan_tpu as sp
from spartan_tpu import autodiff


def test_grad_quadratic(rng):
  x_np = rng.standard_normal((8, 8))
  x = sp.from_numpy(x_np)
  loss = sp.sum(x * x)
  (g,) = autodiff.grad(loss, [x])
  np.testing.assert_allclose(g.glom(), 2 * x_np, atol=1e-12)


def test_grad_matches_manual_linreg(rng):
  X_np = rng.standard_normal((64, 5))
  y_np = rng.standard_normal(64)
  w_np = rng.standard_normal(5)
  X, y, w = sp.from_numpy(X_np), sp.from_numpy(y_np), sp.from_numpy(w_np)
  loss = sp.sum((sp.dot(X, w) - y) ** 2) / 64.0
  (gw,) = autodiff.grad(loss, [w])
  manual = 2.0 / 64 * X_np.T @ (X_np @ w_np - y_np)
  np.testing.assert_allclose(gw.glom(), manual, atol=1e-10)


def test_value_and_grad(rng):
  x_np = rng.standard_normal(10)
  x = sp.from_numpy(x_np)
  v, (g,) = autodiff.value_and_grad(sp.sum(sp.exp(x)), [x])
  np.testing.assert_allclose(np.asarray(v.glom()), np.exp(x_np).sum(),
                             rtol=1e-12)
  np.testing.assert_allclose(g.glom(), np.exp(x_np), rtol=1e-12)


def test_grad_multiple_wrt(rng):
  a_np, b_np = rng.standard_normal(6), rng.standard_normal(6)
  a, b = sp.from_numpy(a_np), sp.from_numpy(b_np)
  loss = sp.sum(a * b + a)
  ga, gb = autodiff.grad(loss, [a, b])
  np.testing.assert_allclose(ga.glom(), b_np + 1, atol=1e-12)
  np.testing.assert_allclose(gb.glom(), a_np, atol=1e-12)


def test_jvp(rng):
  x_np = rng.standard_normal(7)
  t_np = rng.standard_normal(7)
  x = sp.from_numpy(x_np)
  primal, tangent = autodiff.jvp(sp.sum(x ** 2), [x], [t_np])
  np.testing.assert_allclose(np.asarray(tangent.glom()),
                             2 * (x_np * t_np).sum(), rtol=1e-10)


def test_wrt_not_in_dag_raises(rng):
  x = sp.from_numpy(rng.standard_normal(4))
  other = sp.from_numpy(rng.standard_normal(4))
  with pytest.raises(ValueError):
    autodiff.grad(sp.sum(x), [other])


def test_wrt_must_be_val(rng):
  x = sp.from_numpy(rng.standard_normal(4))
  e = x * 2.0
  with pytest.raises(TypeError):
    autodiff.grad(sp.sum(e), [e])


def test_grad_through_fused_chain(rng):
  """Gradient flows through map-map fusion and reduce fusion."""
  x_np = rng.standard_normal((8, 8))
  x = sp.from_numpy(x_np)
  loss = ((x + 1.0) * (x - 2.0)).sum()
  (g,) = autodiff.grad(loss, [x])
  np.testing.assert_allclose(g.glom(), 2 * x_np - 1.0, atol=1e-12)


def test_remat_preserves_value_and_grad(rng):
  """sp.remat: identical forward value; gradient flows (recomputed)."""
  x_np = rng.standard_normal((16, 16))
  x = sp.from_numpy(x_np)
  plain = sp.sum(sp.exp(x) * 2.0)
  re = sp.sum(sp.remat(sp.exp(sp.from_numpy(x_np)) * 2.0))
  np.testing.assert_allclose(re.glom(), plain.glom(), rtol=1e-12)
  x2 = sp.from_numpy(x_np)
  inner = sp.remat(sp.exp(x2) * 2.0)
  (g,) = autodiff.grad(sp.sum(inner), [x2])
  np.testing.assert_allclose(g.glom(), 2 * np.exp(x_np), rtol=1e-12)


def test_compile_serving_entry(rng):
  """sp.compile: trace once, call many times with fresh data."""
  from spartan_tpu.backend import evaluator
  x_np = rng.standard_normal((16, 8))
  w_np = rng.standard_normal(8)
  x, w = sp.from_numpy(x_np), sp.from_numpy(w_np)
  f = sp.compile(sp.tanh(sp.dot(x, w)), wrt=[x])
  for i in range(5):
    fresh = rng.standard_normal((16, 8))
    out = f(fresh)
    np.testing.assert_allclose(np.asarray(out.glom()),
                               np.tanh(fresh @ w_np), rtol=1e-12)
  with pytest.raises(ValueError, match="shape"):
    f(rng.standard_normal((4, 8)))
  with pytest.raises(TypeError, match="argument"):
    f()


def test_compile_container_outputs(rng):
  x_np = rng.standard_normal((8, 4))
  x = sp.from_numpy(x_np)
  f = sp.compile(sp.ListExpr([sp.sum(x, axis=0), sp.max(x)]), wrt=[x])
  fresh = rng.standard_normal((8, 4))
  s, m = f(fresh)
  np.testing.assert_allclose(np.asarray(s.glom()), fresh.sum(0), atol=1e-12)
  assert float(m.glom()) == fresh.max()


def test_compile_donated_carry(rng):
  """sp.compile(donate=...): the state=f(state) pattern — donated buffers
  are consumed; results stay exact and the template leaf survives."""
  w_np = rng.standard_normal(64)
  w = sp.from_numpy(w_np)
  step = sp.compile(0.5 * w + 1.0, wrt=[w], donate=[0])
  state, want = step(w_np), 0.5 * w_np + 1.0
  for _ in range(3):
    want = 0.5 * want + 1.0
    state = step(state)          # donates the previous state's buffer
  np.testing.assert_allclose(np.asarray(state.glom()), want, rtol=1e-12)
  # the template leaf's buffer was protected from the warm-up call
  np.testing.assert_allclose(np.asarray(sp.lazify(w).glom()), w_np,
                             rtol=1e-15)


def test_hessian_quadratic(rng):
  """Hessian of a quadratic form = A + A.T (exact)."""
  a = rng.standard_normal((6, 6))
  w = sp.from_numpy(rng.standard_normal(6))
  loss = sp.sum(w * sp.dot(sp.from_numpy(a), w))
  H = np.asarray(sp.hessian(loss, [w]).glom())
  np.testing.assert_allclose(H, a + a.T, rtol=1e-10, atol=1e-12)


def test_hvp_matches_full_hessian(rng):
  X = rng.standard_normal((64, 8))
  y = rng.standard_normal(64)
  w = sp.from_numpy(rng.standard_normal(8))
  loss = sp.sum((sp.dot(sp.from_numpy(X), w) - sp.from_numpy(y)) ** 2)
  v = rng.standard_normal(8)
  (got,) = sp.hvp(loss, [w], [sp.from_numpy(v)])
  want = 2.0 * X.T @ X @ v
  np.testing.assert_allclose(np.asarray(got.glom()), want, rtol=1e-9)


def test_minimize_bfgs_logreg(rng):
  """One-compile BFGS over a lazy logistic loss: converges to the same
  optimum scipy finds on the identical numpy function."""
  import scipy.optimize as sopt
  X = rng.standard_normal((256, 5))
  w_true = rng.standard_normal(5)
  y = (X @ w_true + 0.3 * rng.standard_normal(256) > 0).astype(np.float64)
  w = sp.from_numpy(np.zeros(5))
  z = sp.dot(sp.from_numpy(X), w)
  loss = sp.mean(sp.log1p(sp.exp(-z)) + (1.0 - sp.from_numpy(y)) * z) \
      + 1e-3 * sp.sum(w * w)
  (w_opt,), info = sp.minimize(loss, [w])
  assert info["success"]

  def np_loss(wv):
    zz = X @ wv
    return (np.log1p(np.exp(-zz)) + (1 - y) * zz).mean() + 1e-3 * (wv**2).sum()

  ref = sopt.minimize(np_loss, np.zeros(5), method="BFGS")
  np.testing.assert_allclose(np.asarray(w_opt.glom()), ref.x, atol=5e-4)
  # the Newton polish leaves us AT LEAST as optimal as scipy's stop point
  assert info["fun"] <= ref.fun + 1e-10


def test_minimize_multi_leaf(rng):
  a = sp.from_numpy(np.array([3.0]))
  b = sp.from_numpy(np.array([-2.0, 5.0]))
  loss = sp.sum((a - 1.0) ** 2) + sp.sum((b - np.array([2.0, -4.0])) ** 2)
  (ao, bo), info = sp.minimize(loss, [a, b])
  np.testing.assert_allclose(np.asarray(ao.glom()), [1.0], atol=1e-6)
  np.testing.assert_allclose(np.asarray(bo.glom()), [2.0, -4.0], atol=1e-6)
  assert info["fun"] < 1e-10
