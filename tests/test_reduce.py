"""Reductions vs NumPy oracle incl. float64 accumulation semantics
(reference: test_reduce.py; SURVEY.md §2.1 reduce — "dtype promotion /
float64 accumulation")."""

import numpy as np
import pytest

import spartan_tpu as sp
from spartan_tpu.util import Assert


@pytest.fixture
def a(rng):
  return rng.standard_normal((12, 16))


def test_sum_all(a):
  Assert.all_close(sp.from_numpy(a).sum(), a.sum(), rtol=1e-13)


def test_sum_axes(a):
  sa = sp.from_numpy(a)
  Assert.all_close(sa.sum(axis=0), a.sum(axis=0), rtol=1e-13)
  Assert.all_close(sa.sum(axis=1), a.sum(axis=1), rtol=1e-13)
  Assert.all_close(sa.sum(axis=1, keepdims=True), a.sum(axis=1, keepdims=True),
                   rtol=1e-13)


def test_float32_accumulates_in_f64(rng):
  """The reference's headline numeric semantic: f32 inputs accumulate (and
  return) float64."""
  x = rng.standard_normal(100_000).astype(np.float32)
  got = sp.from_numpy(x).sum().glom()
  assert got.dtype == np.float64
  np.testing.assert_allclose(got, x.astype(np.float64).sum(), rtol=1e-12)


def test_int_promotion(rng):
  x = rng.integers(0, 100, (50, 50), dtype=np.int32)
  got = sp.from_numpy(x).sum().glom()
  assert got.dtype == np.int64
  assert got == x.astype(np.int64).sum()
  b = np.array([[True, False], [True, True]])
  assert sp.from_numpy(b).sum().glom() == 3


def test_mean_std_var(a):
  sa = sp.from_numpy(a)
  Assert.all_close(sa.mean(), a.mean(), rtol=1e-13)
  Assert.all_close(sa.mean(axis=0), a.mean(axis=0), rtol=1e-13)
  Assert.all_close(sa.std(), a.std(), rtol=1e-12)
  Assert.all_close(sp.var(sa, axis=1), a.var(axis=1), rtol=1e-12)
  Assert.all_close(sp.std(sa, axis=0, ddof=1), a.std(axis=0, ddof=1),
                   rtol=1e-12)


def test_minmax_arg(a):
  sa = sp.from_numpy(a)
  Assert.all_eq(sa.max(), a.max())
  Assert.all_eq(sa.min(axis=0), a.min(axis=0))
  Assert.all_eq(sa.argmax(axis=1), a.argmax(axis=1))
  Assert.all_eq(sa.argmin(axis=0), a.argmin(axis=0))
  Assert.all_eq(sa.argmax(), a.argmax())


def test_prod(rng):
  x = rng.uniform(0.9, 1.1, (10, 10))
  Assert.all_close(sp.prod(sp.from_numpy(x), axis=0), x.prod(axis=0),
                   rtol=1e-12)


def test_bool_reductions(a):
  sa = sp.from_numpy(a)
  Assert.all_eq(sp.all(sa > -10), np.all(a > -10))
  Assert.all_eq(sp.any(sa > 100, axis=0), np.any(a > 100, axis=0))
  Assert.all_eq(sp.count_nonzero(sa > 0), np.count_nonzero(a > 0))


def test_norm(a):
  sa = sp.from_numpy(a)
  Assert.all_close(sp.norm(sa), np.linalg.norm(a), rtol=1e-12)
  v = a[0]
  Assert.all_close(sp.norm(sp.from_numpy(v), ord=1), np.linalg.norm(v, 1),
                   rtol=1e-12)


def test_nansum(a):
  b = a.copy()
  b[0, 0] = np.nan
  Assert.all_close(sp.nansum(sp.from_numpy(b)), np.nansum(b), rtol=1e-12)


def test_ptp(a):
  Assert.all_close(sp.ptp(sp.from_numpy(a), axis=0), np.ptp(a, axis=0),
                   rtol=1e-13)


class TestAffineReduceRewrite:
  """sum(a·x + b) → a·sum(x) + b·n strength reduction (perf pass:
  linear chains run as a pure sum plus a scalar epilogue)."""

  def _both(self, build, want, rtol=1e-12):
    from spartan_tpu.config import FLAGS
    on = build().glom()
    FLAGS.opt_affine_reduce = False
    try:
      off = build().glom()
    finally:
      FLAGS.opt_affine_reduce = True
    np.testing.assert_allclose(on, want, rtol=rtol)
    np.testing.assert_allclose(off, want, rtol=rtol)
    np.testing.assert_allclose(on, off, rtol=1e-11)

  def test_config1_chain(self, rng):
    b = rng.standard_normal((32, 48))
    self._both(lambda: (sp.ones((32, 48)) + sp.from_numpy(b) * 2.0).sum(),
               (1.0 + 2.0 * b).sum())

  def test_axis_reduce(self, rng):
    b = rng.standard_normal((16, 24))
    self._both(lambda: (3.0 * sp.from_numpy(b) - 1.0).sum(axis=0),
               (3.0 * b - 1.0).sum(axis=0))
    self._both(lambda: (sp.from_numpy(b) / 4.0 + 5.0).sum(axis=1),
               (b / 4.0 + 5.0).sum(axis=1))

  def test_mean(self, rng):
    b = rng.standard_normal((20, 20))
    self._both(lambda: ((sp.from_numpy(b) - 2.0) * 0.5).mean(),
               ((b - 2.0) * 0.5).mean())

  def test_negation_subtraction(self, rng):
    b = rng.standard_normal((10, 10))
    self._both(lambda: (1.0 - (-sp.from_numpy(b))).sum(),
               (1.0 + b).sum())

  def test_nonlinear_not_rewritten(self, rng):
    """x·x is not affine — values must still be exact via the normal path."""
    b = rng.standard_normal((12, 12))
    sb = sp.from_numpy(b)
    np.testing.assert_allclose((sb * sb).sum().glom(), (b * b).sum(),
                               rtol=1e-12)
    from spartan_tpu.expr.local import FnCallExpr, LocalInput
    from spartan_tpu.expr.reduce import _extract_affine
    import jax.numpy as jnp
    sq = FnCallExpr(jnp.multiply, [LocalInput(0), LocalInput(0)])
    got = _extract_affine(sq, 0)
    assert got is None

  def test_extract_affine_unit(self):
    from spartan_tpu.expr.local import FnCallExpr, LocalConst, LocalInput
    from spartan_tpu.expr.reduce import _extract_affine
    import jax.numpy as jnp
    # (x * s1 + s0) with x at slot 1, scalars at 0 and 2
    tree = FnCallExpr(jnp.add, [
        FnCallExpr(jnp.multiply, [LocalInput(1), LocalInput(2)]),
        LocalInput(0)])
    is_const, a_fn, b_fn = _extract_affine(tree, 1)
    assert not is_const
    deps = [7.0, None, 3.0]
    assert a_fn(deps) == 3.0 and b_fn(deps) == 7.0


def test_unsigned_accumulation(rng):
  """numpy accumulates unsigned ints in uint64, signed in int64."""
  for dt, want in [(np.uint16, np.uint64), (np.uint32, np.uint64),
                   (np.uint64, np.uint64), (np.int16, np.int64),
                   (np.int8, np.int64)]:
    x = rng.integers(0, 50, (16,)).astype(dt)
    got = sp.from_numpy(x).sum().glom()
    assert got.dtype == np.sum(x).dtype == want, (dt, got.dtype)
    assert got == np.sum(x)
    gc = sp.cumsum(sp.from_numpy(x)).glom()
    assert gc.dtype == np.cumsum(x).dtype, (dt, gc.dtype)


def test_custom_reduce_reference_form(rng, cluster):
  """Reference extensible reduce: local_reduce_fn over the (global) array;
  accumulate_fn/dtype_fn accepted for parity (reference
  spartan/expr/reduce.py reduce(...))."""
  import jax.numpy as jnp
  a = rng.standard_normal((16, 8))
  x = sp.from_numpy(a)
  # log-sum-exp: a real custom associative-ish reduction users write
  out = sp.reduce(x, axis=0,
                  local_reduce_fn=lambda v, axis: jnp.log(
                      jnp.sum(jnp.exp(v), axis=axis)),
                  accumulate_fn=lambda p, q: jnp.logaddexp(p, q))
  want = np.log(np.exp(a).sum(axis=0))
  np.testing.assert_allclose(out.glom(), want, rtol=1e-10)


def test_custom_reduce_with_fn_kw(rng, cluster):
  import jax.numpy as jnp
  a = rng.standard_normal((8, 8))
  out = sp.reduce(sp.from_numpy(a), axis=1,
                  local_reduce_fn=lambda v, axis, q: jnp.quantile(
                      v, q, axis=axis),
                  fn_kw={"q": 0.5})
  np.testing.assert_allclose(out.glom(), np.quantile(a, 0.5, axis=1),
                             rtol=1e-10)


def test_named_reduce_rejects_non_string_op(cluster):
  with pytest.raises(TypeError):
    sp.reduce(sp.ones((4, 4)), op=123)


def test_top_level_parity_exports(cluster):
  for name in ("reduce", "save", "load", "checkpoint", "from_file",
               "sparse", "SparseArray", "sparse_diagonal", "sprandn"):
    assert hasattr(sp, name), name


def test_affine_rewrite_int_input_float_coeff(rng):
  """Regression (ADVICE r1 high): sum(int_arr / 2) and sum(int_arr + 2.5)
  must accumulate in the FUSED chain's output dtype, not the raw int
  operand's — the affine rewrite used to truncate float coefficients
  into an int accumulator."""
  a = rng.integers(-20, 20, size=(8, 17)).astype(np.int32)
  sa = sp.from_numpy(a)
  Assert.all_close((sa / 2).sum(), (a / 2).sum(), rtol=1e-13)
  Assert.all_close((sa + 2.5).sum(), (a + 2.5).sum(), rtol=1e-13)
  Assert.all_close((sa * 0.25 - 1.5).mean(), (a * 0.25 - 1.5).mean(),
                   rtol=1e-13)
  # runtime dtype must agree with the node's aval
  e = (sa / 2).sum()
  assert np.dtype(e.dtype) == np.asarray(e.glom()).dtype


def test_tuple_axis(rng):
  """Regression (ADVICE r1 medium): tuple axes through reduce + the
  optimizer (axis=(1,) on a bare leaf; axis=(0,1) on a fused affine sum)."""
  a = rng.standard_normal((8, 6, 4))
  sa = sp.from_numpy(a)
  Assert.all_close(sp.sum(sa, axis=(1,)), a.sum(axis=(1,)), rtol=1e-13)
  Assert.all_close(sp.sum(sa, axis=(0, 1)), a.sum(axis=(0, 1)), rtol=1e-13)
  Assert.all_close(sp.sum(sa * 2.0 + 1.0, axis=(0, 1)),
                   (a * 2.0 + 1.0).sum(axis=(0, 1)), rtol=1e-13)
  Assert.all_close(sp.sum(sa, axis=(0, 2), keepdims=True),
                   a.sum(axis=(0, 2), keepdims=True), rtol=1e-13)
  Assert.all_close(sp.mean(sa + 1.0, axis=(1, 2)),
                   (a + 1.0).mean(axis=(1, 2)), rtol=1e-13)
  Assert.all_close(sp.sum(sa, axis=(-1, -2)), a.sum(axis=(-1, -2)),
                   rtol=1e-13)
