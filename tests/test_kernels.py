"""Hot-path lowerings are plain XLA: full sums of elementwise chains fuse
into one reduction in the region XLA compiles, and on an accelerator
(platform patched to "gpu") every sum / SpMV / SpMM surface picks an XLA
route — no ``pallas_call`` in any region's jaxpr."""

import jax
import numpy as np
import pytest
import scipy.sparse as ss

import spartan_tpu as sp
from spartan_tpu.backend import evaluator
from spartan_tpu.backend import sparse as sps


@pytest.fixture
def regions(monkeypatch):
  """Record every region the evaluator compiles; returns a list that
  ``jaxprs()`` turns into the regions' jaxpr texts."""
  seen = []
  real = evaluator._make_runner

  def spy(root, leaf_index):
    run = real(root, leaf_index)

    def traced(*args):
      seen.append((run, [jax.ShapeDtypeStruct(a.shape, a.dtype)
                         for a in args]))
      return run(*args)
    return traced

  monkeypatch.setattr(evaluator, "_make_runner", spy)
  evaluator.clear_cache()

  class Regions(list):
    def jaxprs(self):
      return [str(jax.make_jaxpr(run)(*avals)) for run, avals in seen]
  out = Regions()
  yield out
  evaluator.clear_cache()


_SUMS = {
    # full sums over one operand: one XLA reduction each
    "identity": ((64, 128), lambda x: sp.sum(x), lambda h: h.sum()),
    "chain": ((64, 128), lambda x: sp.sum(sp.abs(1.0 + x * 2.0)),
              lambda h: np.abs(1.0 + h * 2.0).sum()),
    "nondivisible_rows": ((13, 20), lambda x: sp.sum(sp.exp(x) * x),
                          lambda h: (np.exp(h) * h).sum()),
    "config1": ((128, 256),
                lambda x: (sp.ones((128, 256), dtype=np.float32)
                           + x * 2.0).sum(),
                lambda h: (1.0 + 2.0 * h).sum()),
}


@pytest.mark.parametrize("case", sorted(_SUMS))
def test_full_sum_matches_numpy(rng, regions, case):
  shape, build, oracle = _SUMS[case]
  h = rng.standard_normal(shape).astype(np.float32)
  got = float(build(sp.from_numpy(h)).glom())
  np.testing.assert_allclose(got, oracle(h.astype(np.float64)), rtol=1e-6)
  texts = regions.jaxprs()
  assert texts and all("pallas_call" not in t for t in texts)
  assert any("reduce_sum" in t for t in texts)


def test_const_fold_unlocks_scalar_leaves(rng):
  """ConstFoldCreations: ones(shape) feeding a fused reduce becomes a
  scalar leaf (the affine rewrite then needs no materialized ones)."""
  from spartan_tpu.expr.ndarray import CreationExpr
  from spartan_tpu.expr.optimize import optimize
  b = sp.from_numpy(rng.standard_normal((16, 16)))
  e = optimize((sp.ones((16, 16)) + b * 2.0).sum())
  # after folding, no CreationExpr remains among the fused inputs
  assert not any(isinstance(c, CreationExpr) for c in e.inputs)
  # and the result is unchanged
  bn = b.value.glom()
  np.testing.assert_allclose(
      float(((sp.ones((16, 16)) + sp.from_numpy(bn) * 2.0).sum()).glom()),
      (1.0 + bn * 2.0).sum(), rtol=1e-12)


def _matrices(rng):
  """(structure, expected accelerator route, scipy matrix)."""
  blocks = [rng.standard_normal((128, 128)) for _ in range(3)]
  return [
      ("block", "bsr", ss.block_diag(blocks, format="csr")
       .astype(np.float32)),
      ("dense-ish", "dense", ss.random(
          512, 512, density=0.05, random_state=1, format="csr",
          dtype=np.float32)),
      ("unstructured", "ell", ss.random(
          1024, 1024, density=0.001, random_state=2, format="csr",
          dtype=np.float32)),
  ]


@pytest.mark.parametrize("surface", ["sum", "spmv", "spmm", "SpMVExpr",
                                     "SpMMExpr"])
def test_accelerator_routes_are_xla(rng, regions, as_gpu, surface):
  if surface == "sum":
    h = rng.random((64, 128), dtype=np.float32)
    b = sp.from_numpy(h)
    with as_gpu():
      e = sp.sum(sp.abs(1.0 + 2.0 * b))
    np.testing.assert_allclose(float(e.glom()),
                               np.abs(1.0 + 2.0 * h.astype(np.float64))
                               .sum(), rtol=1e-6)
    texts = regions.jaxprs()
    assert texts and all("pallas_call" not in t for t in texts)
    return
  for name, route, A in _matrices(rng):
    S = sps.from_scipy(A, dtype=np.float32)
    mat = surface in ("spmm", "SpMMExpr")
    rhs = (rng.standard_normal((A.shape[1], 8)) if mat
           else rng.standard_normal(A.shape[1])).astype(np.float32)
    want = A @ rhs
    if surface in ("spmv", "spmm"):
      fn = sps.spmm if mat else sps.spmv
      with as_gpu():
        got = np.asarray(fn(S, rhs))            # fills the route caches
        text = str(jax.make_jaxpr(lambda r: fn(S, r))(rhs))
      assert "pallas_call" not in text, (name, text[-400:])
      assert ("gather" in text) == (route != "dense"), (name, route)
    else:
      cls = sps.SpMMExpr if mat else sps.SpMVExpr
      with as_gpu():
        e = cls(S, sp.from_numpy(rhs))
      assert e.fmt == route, (name, e.fmt, route)
      got = np.asarray(e.glom())
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-5, (surface, name)
  texts = regions.jaxprs()
  assert all("pallas_call" not in t for t in texts)
