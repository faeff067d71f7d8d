"""Distributed matmul / outer (reference: test_dot.py; SURVEY.md §3.3)."""

import numpy as np
import pytest

import spartan_tpu as sp
from spartan_tpu.util import Assert


def test_matmul(rng):
  a = rng.standard_normal((16, 24))
  b = rng.standard_normal((24, 32))
  Assert.all_close(sp.dot(sp.from_numpy(a), sp.from_numpy(b)), a @ b,
                   rtol=1e-12)


def test_matvec(rng):
  a = rng.standard_normal((16, 24))
  v = rng.standard_normal((24,))
  Assert.all_close(sp.dot(sp.from_numpy(a), sp.from_numpy(v)), a @ v,
                   rtol=1e-12)


def test_vecmat(rng):
  a = rng.standard_normal((16, 24))
  v = rng.standard_normal((16,))
  Assert.all_close(sp.dot(sp.from_numpy(v), sp.from_numpy(a)), v @ a,
                   rtol=1e-12)


def test_vecvec(rng):
  u = rng.standard_normal((33,))
  v = rng.standard_normal((33,))
  Assert.all_close(sp.dot(sp.from_numpy(u), sp.from_numpy(v)), u @ v,
                   rtol=1e-12)


def test_matmul_operator(rng):
  a = rng.standard_normal((8, 8))
  b = rng.standard_normal((8, 8))
  Assert.all_close(sp.from_numpy(a) @ sp.from_numpy(b), a @ b, rtol=1e-12)


def test_outer(rng):
  u = rng.standard_normal((16,))
  v = rng.standard_normal((24,))
  Assert.all_close(sp.outer(sp.from_numpy(u), sp.from_numpy(v)),
                   np.outer(u, v), rtol=1e-12)


def test_dot_lazy_inputs(rng):
  """dot over unevaluated lazy inputs fuses into one region."""
  a = rng.standard_normal((12, 12))
  expr = sp.dot(sp.from_numpy(a) + 1.0, sp.from_numpy(a).T * 2.0)
  Assert.all_close(expr, (a + 1.0) @ (a.T * 2.0), rtol=1e-12)


def test_tensordot(rng):
  a = rng.standard_normal((4, 5, 6))
  b = rng.standard_normal((6, 5, 3))
  got = sp.tensordot(sp.from_numpy(a), sp.from_numpy(b),
                     axes=([2, 1], [0, 1]))
  Assert.all_close(got, np.tensordot(a, b, axes=([2, 1], [0, 1])),
                   rtol=1e-12)


def test_dot_chain_gradient_shape(rng):
  """The linreg gradient pattern: X.T @ (X @ w - y)."""
  x = rng.standard_normal((32, 8))
  y = rng.standard_normal((32,))
  w = rng.standard_normal((8,))
  sx, sy, sw = sp.from_numpy(x), sp.from_numpy(y), sp.from_numpy(w)
  grad = sp.dot(sx.T, sp.dot(sx, sw) - sy)
  Assert.all_close(grad, x.T @ (x @ w - y), rtol=1e-11)


def test_trace_diag(rng):
  a = rng.standard_normal((10, 10))
  sa = sp.from_numpy(a)
  Assert.all_close(sp.trace(sa), np.trace(a), rtol=1e-12)
  Assert.all_eq(sp.diagonal(sa), np.diagonal(a))
  v = rng.standard_normal((7,))
  Assert.all_eq(sp.diag(sp.from_numpy(v)), np.diag(v))


def test_einsum(rng):
  a = rng.standard_normal((6, 8))
  b = rng.standard_normal((8, 10))
  Assert.all_close(sp.einsum("ij,jk->ik", sp.from_numpy(a),
                             sp.from_numpy(b)),
                   np.einsum("ij,jk->ik", a, b), rtol=1e-12)
  c = rng.standard_normal((4, 6, 8))
  Assert.all_close(sp.einsum("bij,ij->b", sp.from_numpy(c),
                             sp.from_numpy(a)),
                   np.einsum("bij,ij->b", c, a), rtol=1e-12)
  Assert.all_close(sp.einsum("ii->", sp.from_numpy(a[:6, :6])),
                   np.einsum("ii->", a[:6, :6]), rtol=1e-12)


@pytest.mark.parametrize("op", ["dot", "tensordot"])
def test_f64_accumulation_widens_f32_operands(rng, op):
  """With f64 accumulation (float64_reductions under x64), an f32 × f32
  contraction must reach dot_general with f64 operands: XLA's GPU
  backend has no f32 × f32 → f64 GEMM.  Values match the f64 oracle."""
  import jax

  from spartan_tpu.expr.base import EmitCtx
  a = rng.standard_normal((16, 8)).astype(np.float32)
  b = rng.standard_normal((8, 4)).astype(np.float32)
  e = (sp.dot(sp.from_numpy(a), sp.from_numpy(b)) if op == "dot" else
       sp.tensordot(sp.from_numpy(a), sp.from_numpy(b), axes=1))
  jaxpr = jax.make_jaxpr(lambda x, y: e._emit(EmitCtx(), [x, y]))(a, b)
  dots = [q for q in jaxpr.jaxpr.eqns if q.primitive.name == "dot_general"]
  assert dots and all(v.aval.dtype == np.float64
                      for q in dots for v in q.invars)
  np.testing.assert_allclose(np.asarray(e.glom()),
                             a.astype(np.float64) @ b.astype(np.float64),
                             rtol=1e-12)
