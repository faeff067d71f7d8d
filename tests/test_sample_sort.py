"""Distributed sample sort + exact selection (reference:
``spartan/expr/sort.py`` sample+shuffle sort; SURVEY.md §2.1 sort row).

The sample path is the rebuild of the reference's distributed sort:
exact rank splitters + ragged/dense bucket exchange
(``spartan_tpu/parallel/sample_sort.py``).  Tests force it with
``--sort_method=sample`` (the 'auto' default only engages above
``sort_sample_threshold`` elements) and compare against NumPy."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spartan_tpu as sp
from spartan_tpu.config import FLAGS
from spartan_tpu.parallel import sample_sort as ss


@contextlib.contextmanager
def sample_method():
  old = FLAGS.sort_method
  FLAGS.sort_method = "sample"
  try:
    yield
  finally:
    FLAGS.sort_method = old


def _sorted_eq(got, want):
  got, want = np.asarray(got), np.asarray(want)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  if got.dtype.kind == "f":
    np.testing.assert_array_equal(got, want)  # equal_nan for ==; exact
  else:
    assert np.array_equal(got, want)


CASES = [
    ("f32", lambda r: r.standard_normal(1 << 13).astype(np.float32)),
    ("f32-ties", lambda r: r.integers(0, 5, 1 << 13).astype(np.float32)),
    ("f32-const", lambda r: np.full(1 << 10, 3.14, np.float32)),
    ("f32-special", lambda r: np.concatenate(
        [np.array([-np.inf, np.inf, 0.0, -0.0] * 4, np.float32),
         r.standard_normal(1008).astype(np.float32) * 1e30])),
    ("f32-presorted", lambda r: np.sort(
        r.standard_normal(1 << 12).astype(np.float32))),
    ("f32-reversed", lambda r: np.sort(
        r.standard_normal(1 << 12).astype(np.float32))[::-1].copy()),
    ("f64", lambda r: r.standard_normal(1 << 12)),
    ("i32", lambda r: r.integers(-1000, 1000, 1 << 12).astype(np.int32)),
    ("i64", lambda r: r.integers(-10**12, 10**12, 1 << 12)),
    ("u32", lambda r: r.integers(0, 2**32, 1 << 12, dtype=np.uint32)),
    ("i8", lambda r: r.integers(-128, 128, 1 << 12).astype(np.int8)),
]


@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_sample_sort_matches_numpy(rng, name, make):
  a = make(rng)
  with sample_method():
    _sorted_eq(sp.sort(sp.from_numpy(a)).glom(), np.sort(a))


def test_sample_sort_nans(rng):
  a = np.concatenate([rng.standard_normal(1000).astype(np.float32),
                      np.array([np.nan, -np.nan] * 12, np.float32)])
  with sample_method():
    got = np.asarray(sp.sort(sp.from_numpy(a)).glom())
  want = np.sort(a)
  assert np.isnan(got[-24:]).all()
  np.testing.assert_array_equal(got[:-24], want[:-24])


def test_sample_argsort_stable(rng):
  a = rng.integers(0, 5, 1 << 12).astype(np.float32)
  with sample_method():
    gi = np.asarray(sp.argsort(sp.from_numpy(a)).glom())
  assert np.array_equal(gi, np.argsort(a, kind="stable"))


def test_sample_sort_axis_none_2d(rng):
  a = rng.standard_normal((64, 64)).astype(np.float32)
  with sample_method():
    _sorted_eq(sp.sort(sp.from_numpy(a), axis=None).glom(),
               np.sort(a, axis=None))


def test_sample_sort_feeds_lazy_chain(rng):
  a = rng.standard_normal(1 << 12).astype(np.float32)
  with sample_method():
    got = float(sp.sum(sp.sort(sp.from_numpy(a))[:100]).glom())
  np.testing.assert_allclose(got, np.sort(a)[:100].sum(), rtol=1e-5)


def test_sample_sort_uneven_falls_back(rng):
  # n not divisible by the 8-device mesh: routable() is False, the gather
  # lowering serves — same result, no crash.
  a = rng.standard_normal(1001).astype(np.float32)
  with sample_method():
    _sorted_eq(sp.sort(sp.from_numpy(a)).glom(), np.sort(a))


def test_sample_percentile_median_selection(rng):
  a = rng.standard_normal(1 << 13)
  sa = sp.from_numpy(a)
  with sample_method():
    for q in (0.0, 10.0, 50.0, 99.5, 100.0):
      np.testing.assert_allclose(float(sp.percentile(sa, q).glom()),
                                 np.percentile(a, q), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(sp.percentile(sa, [25.0, 75.0]).glom()),
        np.percentile(a, [25.0, 75.0]), rtol=1e-12)
    np.testing.assert_allclose(float(sp.median(sa).glom()), np.median(a),
                               rtol=1e-12)
    np.testing.assert_allclose(float(sp.quantile(sa, 0.31).glom()),
                               np.quantile(a, 0.31), rtol=1e-12)


def test_sample_percentile_nan_propagates(rng):
  """ADVICE r2 (medium): the rank-search route must return NaN when any
  input is NaN — matching numpy and the gather route — so identical
  programs can't give different answers depending on sort_method/mesh."""
  a = rng.standard_normal(1 << 12)
  a[137] = np.nan
  sa = sp.from_numpy(a)
  with sample_method():
    assert np.isnan(float(sp.percentile(sa, 50.0).glom()))
    assert np.isnan(float(sp.median(sa).glom()))
    out = np.asarray(sp.percentile(sa, [25.0, 75.0]).glom())
    assert np.isnan(out).all()
  # gather route agrees (was already NaN)
  assert np.isnan(float(sp.percentile(sp.from_numpy(a), 50.0).glom()))
  # and the NaN-aware spellings still select over the finite values
  with sample_method():
    np.testing.assert_allclose(float(sp.nanpercentile(sa, 50.0).glom()),
                               np.nanpercentile(a, 50.0), rtol=1e-12)


def test_sample_percentile_int_input(rng):
  a = rng.integers(0, 10**6, 1 << 12).astype(np.int32)
  with sample_method():
    np.testing.assert_allclose(
        float(sp.percentile(sp.from_numpy(a), 37.5).glom()),
        np.percentile(a, 37.5), rtol=1e-12)


def test_sample_partition_contract(rng):
  a = rng.standard_normal(1 << 12).astype(np.float32)
  k = 1000
  with sample_method():
    got = np.asarray(sp.partition(sp.from_numpy(a), k).glom())
  assert got[k] == np.partition(a, k)[k]
  assert (got[:k] <= got[k]).all() and (got[k:] >= got[k]).all()


def test_rank_values_exact(rng, cluster):
  a = rng.standard_normal(1 << 13).astype(np.float32)
  from jax.sharding import NamedSharding, PartitionSpec as P
  x = jax.device_put(jnp.asarray(a),
                     NamedSharding(cluster, P(tuple(cluster.axis_names))))
  ranks = [0, 1, 17, 4096, (1 << 13) - 1]
  got = np.asarray(ss.rank_values(x, ranks, cluster))
  np.testing.assert_array_equal(got, np.sort(a)[ranks])


def test_sample_sort_hlo_has_all_to_all(rng, cluster):
  """The sample lowering's bucket exchange is an all-to-all (dense path on
  CPU); the gather lowering all-gathers instead (asserted in
  test_sort.py).  SURVEY.md §2.4 collective-mapping evidence."""
  from jax.sharding import NamedSharding, PartitionSpec as P
  a = jax.device_put(jnp.asarray(rng.standard_normal(1 << 13),
                                 dtype=jnp.float32),
                     NamedSharding(cluster, P(tuple(cluster.axis_names))))
  hlo = jax.jit(lambda v: ss.sample_sort_traced(v, cluster)).lower(
      a).compile().as_text()
  assert "all-to-all" in hlo
  # the count exchanges are tiny all-gathers; no collective may carry the
  # full f32[8192] array (that would be the gather plan sneaking back in).
  for line in hlo.splitlines():
    if "all-gather" in line:
      assert f"f32[{1 << 13}]" not in line, line


def test_sample_sort_ragged_lowering_for_gpu(rng, cluster):
  """The GPU exchange lowers to ragged_all_to_all (can't execute on the
  CPU mesh — XLA:CPU has no ragged thunk — but the trace must build)."""
  from jax.sharding import NamedSharding, PartitionSpec as P
  a = jax.device_put(jnp.asarray(rng.standard_normal(1 << 12),
                                 dtype=jnp.float32),
                     NamedSharding(cluster, P(tuple(cluster.axis_names))))
  txt = jax.jit(lambda v: ss.sample_sort_traced(
      v, cluster, exchange="ragged")).lower(a).as_text()
  assert "ragged_all_to_all" in txt or "ragged-all-to-all" in txt


def test_auto_threshold_routing(rng, cluster):
  """'auto' stays on the gather plan below the threshold and switches to
  the sample plan above it (visible as all-to-all vs all-gather in the
  compiled HLO of the framework-emitted region)."""
  old = (FLAGS.sort_method, FLAGS.sort_sample_threshold)
  try:
    FLAGS.sort_method = "auto"
    FLAGS.sort_sample_threshold = 1 << 10
    a = rng.standard_normal(1 << 12).astype(np.float32)
    _sorted_eq(sp.sort(sp.from_numpy(a)).glom(), np.sort(a))  # above: sample
    FLAGS.sort_sample_threshold = 1 << 20
    _sorted_eq(sp.sort(sp.from_numpy(a)).glom(), np.sort(a))  # below: gather
  finally:
    FLAGS.sort_method, FLAGS.sort_sample_threshold = old


def test_dot_precision_plumbs_to_hlo(rng, cluster):
  """--dot_precision / sp.dot(precision=...) reaches the lowered dot
  (f32 matmuls may run reduced-precision passes at default — TF32 on a
  GPU; 'highest' restores the reference's numpy-BLAS accuracy)."""
  txt = jax.jit(lambda x: jnp.matmul(
      x, x, precision="highest")).lower(jnp.ones((8, 8))).as_text()
  assert "HIGHEST" in txt.upper()
  # framework result still matches the oracle
  a = sp.from_numpy(np.ones((64, 64), np.float32))
  e = sp.dot(a, a, precision="highest")
  np.testing.assert_allclose(np.asarray(e.glom()),
                             np.ones((64, 64)) @ np.ones((64, 64)))


def test_grad_through_sample_sort(rng):
  """Autodiff composes with the distributed sort: d(sum of top-k squared)
  routes gradients back through the exchange to the right inputs."""
  from spartan_tpu import autodiff
  a = rng.standard_normal(1 << 10)
  x = sp.from_numpy(a)
  with sample_method():
    loss = sp.sum(sp.sort(x)[-100:] ** 2)
    (g,) = autodiff.grad(loss, [x])
    gn = np.asarray(g.glom() if hasattr(g, "glom") else g)
  want = np.zeros_like(a)
  idx = np.argsort(a)[-100:]
  want[idx] = 2 * a[idx]
  np.testing.assert_allclose(gn, want, atol=1e-12)


def test_sort_differential_fuzz(rng):
  """Differential fuzz: random dtype/size/content 1-D sorts, sample
  method forced (non-divisible sizes exercise the gather fallback)."""
  dtypes = [np.float32, np.float64, np.int32, np.int64, np.int8,
            np.uint32, np.float16]
  with sample_method():
    for seed in range(40):
      r = np.random.default_rng(seed)
      n = int(r.integers(2, 5000))
      dt = dtypes[seed % len(dtypes)]
      if np.dtype(dt).kind == "f":
        a = (r.standard_normal(n)
             * 10.0 ** float(r.integers(-3, 4))).astype(dt)
        if r.integers(0, 2):
          a[r.integers(0, n, max(n // 10, 1))] = np.inf
          a[r.integers(0, n, max(n // 10, 1))] = -np.inf
      else:
        info = np.iinfo(dt)
        a = r.integers(info.min, info.max, n).astype(dt)
      got = np.asarray(sp.sort(sp.from_numpy(a)).glom())
      np.testing.assert_array_equal(got, np.sort(a), err_msg=f"seed={seed}")
      gi = np.asarray(sp.argsort(sp.from_numpy(a)).glom())
      assert np.array_equal(a[gi], np.sort(a)), f"argsort seed={seed}"
