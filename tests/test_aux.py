"""Aux subsystems: profiling hooks, DAG visualization, sklearn-style
estimators, netflix SGD, broadcast_to (SURVEY.md §5, §2.5)."""

import numpy as np
import pytest

import spartan_tpu as sp
from spartan_tpu import profiling
from spartan_tpu.expr import visualize


def test_region_stats_counters(rng):
  profiling.reset_region_stats()
  a = sp.from_numpy(rng.standard_normal((8, 8)))
  (a + 1.0).evaluate()
  s = profiling.region_stats()
  assert s["evals"] >= 1 and s["compiles"] >= 1


def test_step_timer():
  t = profiling.StepTimer()
  for _ in range(3):
    with t.step("x", bytes_moved=1000):
      pass
  s = t.summary()
  assert s["count"] == 3 and "median_gbps" in s


def test_annotate_runs(rng):
  with profiling.annotate("test-span"):
    sp.from_numpy(rng.standard_normal((4, 4))).evaluate()


def test_pretty_and_dot(rng):
  a = sp.from_numpy(rng.standard_normal((8, 8)))
  e = ((a + 1.0) * 2.0).sum()
  txt = visualize.pretty(e)
  assert "ReduceExpr" in txt and "Val" in txt
  dot = visualize.to_dot(e)
  assert dot.startswith("digraph") and "->" in dot


def test_dump_dot(rng, tmp_path):
  a = sp.from_numpy(rng.standard_normal((4, 4)))
  p = visualize.dump_dot(a + 1.0, str(tmp_path / "g.dot"))
  assert "digraph" in open(p).read()


def test_broadcast_to(rng):
  v = rng.standard_normal((1, 6))
  got = sp.broadcast_to(sp.from_numpy(v), (4, 6)).glom()
  np.testing.assert_array_equal(got, np.broadcast_to(v, (4, 6)))


def test_netflix_sgd_learns():
  from spartan_tpu.examples import netflix_sgd
  err = netflix_sgd.run(n_users=64, n_items=32, k=4, n_ratings=2048,
                        epochs=4)
  assert err < 0.5  # noise floor is 0.05; untrained is ~1.1


# --- sklearn-style estimators ---------------------------------------------

def test_learn_linear_regression(rng):
  from spartan_tpu.learn import LinearRegression
  X = rng.standard_normal((512, 6))
  w = rng.standard_normal(6)
  y = X @ w + 0.01 * rng.standard_normal(512)
  m = LinearRegression(iterations=200, alpha=0.1).fit(X, y)
  assert m.score(X, y) > 0.99


def test_learn_ridge(rng):
  from spartan_tpu.learn import Ridge
  X = rng.standard_normal((256, 4))
  w = rng.standard_normal(4)
  y = X @ w
  m = Ridge(alpha=1e-8).fit(X, y)
  np.testing.assert_allclose(m.coef_, w, atol=1e-6)


def test_learn_logistic(rng):
  from spartan_tpu.learn import LogisticRegression
  X = rng.standard_normal((512, 4))
  w = rng.standard_normal(4)
  y = (X @ w > 0).astype(int)
  m = LogisticRegression(iterations=100).fit(X, y)
  assert (m.predict(X) == y).mean() > 0.9


def test_learn_kmeans(rng):
  from spartan_tpu.learn import KMeans
  from spartan_tpu.examples.kmeans import make_data
  pts, _ = make_data(512, 4, 3, seed=3)
  m = KMeans(n_clusters=3, iterations=10, seed=3).fit(pts.value.glom())
  pred = m.predict(pts.value.glom())
  assert m.cluster_centers_.shape == (3, 4)
  assert set(np.unique(pred)) <= {0, 1, 2}


def test_learn_svc(rng):
  from spartan_tpu.learn import SVC
  X = rng.standard_normal((512, 4))
  w = rng.standard_normal(4)
  y = np.sign(X @ w + 1e-9)
  m = SVC(iterations=100).fit(X, y)
  assert (m.predict(X) == y).mean() > 0.95


def test_learn_naive_bayes():
  from spartan_tpu.learn import NaiveBayes
  from spartan_tpu.examples.naive_bayes import make_data
  X, slab, labels = make_data(512, 10, 3, seed=2)
  # use string class labels to exercise the class remapping
  str_labels = np.array(["a", "b", "c"])[labels]
  m = NaiveBayes().fit(X.value.glom(), str_labels)
  pred = m.predict(X.value.glom())
  assert (pred == str_labels).mean() > 0.9


def test_learn_pca(rng):
  from spartan_tpu.learn import PCA
  X = rng.standard_normal((512, 8)) * np.linspace(10, 1, 8)
  m = PCA(n_components=2).fit(X)
  assert m.components_.shape == (2, 8)
  Z = m.transform(X)
  assert Z.shape == (512, 2)
  assert m.explained_variance_[0] > m.explained_variance_[1]


def test_learn_truncated_svd(rng):
  from spartan_tpu.learn import TruncatedSVD
  import scipy.sparse as ss
  X = rng.standard_normal((200, 16))
  m = TruncatedSVD(n_components=3).fit(X)
  st = np.linalg.svd(X, compute_uv=False)[:3]
  np.testing.assert_allclose(m.singular_values_, st, atol=1e-9)
  Z = m.transform(X)
  assert Z.shape == (200, 3)
  # projection onto the top right-singular basis reproduces X's energy
  assert abs((Z ** 2).sum() - (st ** 2).sum()) < 1e-6 * (st ** 2).sum()
  # sparse design matrix without densify/centering
  Xs = ss.random(128, 24, density=0.2,
                 random_state=np.random.RandomState(0), format="csr")
  ms = TruncatedSVD(n_components=2).fit(sp.sparse.from_scipy(Xs))
  sts = np.linalg.svd(Xs.todense(), compute_uv=False)[:2]
  np.testing.assert_allclose(ms.singular_values_, np.asarray(sts).ravel(),
                             atol=1e-9)


def test_multi_output_region(rng):
  """ListExpr/DictExpr roots: several outputs from ONE fused region."""
  from spartan_tpu.backend import evaluator
  a = sp.from_numpy(rng.standard_normal((16, 16)))
  evaluator.clear_cache()
  start = evaluator.stats["compiles"]
  out = sp.evaluate(sp.ListExpr([a.sum(axis=0), a.sum(axis=1), (a * 2).max()]))
  assert evaluator.stats["compiles"] - start == 1  # one region, 3 outputs
  np.testing.assert_allclose(out[0].glom(), a.value.glom().sum(0), atol=1e-12)
  d = sp.evaluate(sp.DictExpr({"s": a.sum(), "m": a.mean()}))
  np.testing.assert_allclose(np.asarray(d["s"].glom()),
                             a.value.glom().sum(), rtol=1e-12)


def test_graft_entry_contract():
  """The driver's entry()/dryrun contract must keep working."""
  import importlib.util
  import os
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  spec = importlib.util.spec_from_file_location(
      "__graft_entry__", os.path.join(root, "__graft_entry__.py"))
  m = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(m)
  import jax
  fn, args = m.entry()
  # entry() must exercise the framework's own emission path (a lazy DAG
  # lowered through autodiff.as_function), not a hand-written jax model
  from spartan_tpu.expr.base import Expr
  assert isinstance(getattr(fn, "_spartan_expr", None), Expr)
  out = jax.jit(fn)(*args)
  assert out.shape == (8, 10)
  m.dryrun_multichip(8)


def test_learn_fuzzy_and_als(rng):
  from spartan_tpu.learn import ALS, FuzzyKMeans
  from spartan_tpu.examples.kmeans import make_data
  pts, _ = make_data(256, 3, 3, seed=5)
  m = FuzzyKMeans(n_clusters=3, iterations=5).fit(pts.value.glom())
  assert m.cluster_centers_.shape == (3, 3)
  np.testing.assert_allclose(m.membership_.sum(1), 1.0, atol=1e-8)
  U0 = rng.standard_normal((64, 4)); V0 = rng.standard_normal((32, 4))
  R = U0 @ V0.T
  a = ALS(n_factors=4, iterations=8, reg=0.01).fit(R)
  assert np.abs(a.predict() - R).mean() < 0.1


def test_eager_debug_mode(rng):
  """--eager evaluates every node at construction (reference debug flag)."""
  from spartan_tpu.config import FLAGS
  FLAGS.eager = True
  try:
    a = sp.from_numpy(rng.standard_normal((8, 8)))
    b = (a + 1.0) * 2.0
    assert b._cache is not None  # evaluated immediately
    s = sp.sum(b)
    assert s._cache is not None
    np.testing.assert_allclose(
        np.asarray(s.glom()),
        ((a.value.glom() + 1.0) * 2.0).sum(), rtol=1e-12)
  finally:
    FLAGS.eager = False

def test_learn_als_sparse_matches_dense(rng):
  """learn.ALS accepts a SparseArray ratings matrix (lazy SpMM path) and
  produces the dense run's factors exactly."""
  from spartan_tpu.backend import sparse as sps
  from spartan_tpu.learn.estimators import ALS
  dense = rng.standard_normal((64, 32, 4)) @ np.ones(4)
  dense[rng.random((64, 32)) < 0.6] = 0.0
  m1 = ALS(n_factors=4, iterations=3).fit(dense)
  m2 = ALS(n_factors=4, iterations=3).fit(sps.from_dense(dense))
  np.testing.assert_allclose(m2.user_factors_, m1.user_factors_, atol=1e-9)
  np.testing.assert_allclose(m2.item_factors_, m1.item_factors_, atol=1e-9)


def test_bench_orchestrator_contract():
  """The driver contract: `python bench.py` prints exactly ONE JSON line
  on stdout (stage results assemble into it), even when only a subset of
  stages runs.  Exercised on CPU (JAX_PLATFORMS=cpu) with a plan override
  (the verify stage is the cheapest)."""
  import json
  import os
  import subprocess
  import sys

  env = dict(os.environ, JAX_PLATFORMS="cpu",
             SPARTAN_BENCH_STAGES="verify", SPARTAN_BENCH_BUDGET="240")
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  out = subprocess.run([sys.executable, os.path.join(root, "bench.py")],
                       capture_output=True, text=True, timeout=280,
                       env=env, cwd=root)
  lines = [ln for ln in out.stdout.strip().splitlines() if ln.strip()]
  assert len(lines) == 1, out.stdout + out.stderr[-1000:]
  rec = json.loads(lines[0])
  assert rec["bench_diag"]["completed"] == ["verify"], rec
  assert rec.get("framework_verified") is True
  # the primary metric keys are always present (null when no c1 stage ran)
  assert set(rec) >= {"metric", "value", "unit", "vs_baseline"}


def test_platform_flag_registered():
  """--platform forces the jax backend in initialize; registration +
  default contract."""
  from spartan_tpu.config import FLAGS
  assert FLAGS.platform == "" or FLAGS.platform in ("cpu", "gpu")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_helper(monkeypatch, tmp_path, env_set):
  """enable_compile_cache: with JAX_COMPILATION_CACHE_DIR set it leaves
  the cache to JAX and sets nothing; without it the cache goes to the
  checkout's .jax_cache, a path derived from the package location."""
  import os

  import jax

  from spartan_tpu.util import enable_compile_cache
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  set_calls = []
  real_update = jax.config.update
  monkeypatch.setattr(jax.config, "update", lambda k, v: (
      set_calls.append((k, v)), real_update(k, v))[-1])
  old = jax.config.jax_compilation_cache_dir
  try:
    if env_set:
      monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
      assert enable_compile_cache() == str(tmp_path)
      assert set_calls == []
    else:
      monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
      path = enable_compile_cache()
      assert path == os.path.join(root, ".jax_cache")
      assert os.path.isdir(path)
      assert set_calls == [("jax_compilation_cache_dir", path)]
  finally:
    real_update("jax_compilation_cache_dir", old)


def test_pin_flush_clears_fn_key_cache():
  """ADVICE r3: the _pin_id overflow flush must clear _fn_key_cache and
  the SmartTiling plan cache too — retained entries can embed recycled
  id-strings and alias two different kernels."""
  from spartan_tpu.expr import base as B
  from spartan_tpu.expr.optimize import SmartTiling

  B.fn_key(lambda x: x + 1)
  assert B._fn_key_cache
  SmartTiling._plan_cache["__probe__"] = None

  class Big:
    nbytes = B._ID_PIN_BYTE_LIMIT + 1

  B._pin_id(Big())
  assert not B._fn_key_cache
  assert "__probe__" not in SmartTiling._plan_cache
