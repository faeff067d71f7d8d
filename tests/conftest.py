"""Test fixture: an 8-device CPU mesh in one process.

The reference tests boot a real local cluster of worker processes
(reference: ``spartan/tests/test_common.py`` ``ClusterTest`` — SURVEY.md
§4).  The SPMD analogue is ``--xla_force_host_platform_device_count=8``: 8
XLA CPU devices in one process with real NamedSharding/collective
semantics.  float64 is enabled for NumPy-parity oracles (the reference
accumulates reductions in f64).
"""

import contextlib
import os

# Must be set before the XLA CPU client is created.
_flag = "--xla_force_host_platform_device_count=8"
if _flag not in os.environ.get("XLA_FLAGS", ""):
  os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _flag).strip()

import jax

# Tests run on the virtual CPU mesh even where an accelerator is present.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

import spartan_tpu
from spartan_tpu.core import mesh as mesh_mod


@pytest.fixture(scope="session", autouse=True)
def cluster():
  """Session-wide default mesh over the 8 virtual CPU devices."""
  assert len(jax.devices()) == 8, (
      "expected 8 virtual CPU devices; XLA_FLAGS was applied too late")
  # Tests use small arrays as stand-ins for big ones: disable the
  # replicate-small-arrays default so sharded-path semantics (collectives,
  # SPMD lowering) stay exercised.  Dedicated tests re-enable it.
  from spartan_tpu.config import FLAGS
  FLAGS.replicate_small_bytes = 0
  m = mesh_mod.make_mesh((2, 4), ("x", "y"))
  mesh_mod.set_default_mesh(m)
  yield m
  mesh_mod.set_default_mesh(None)


@pytest.fixture
def rng():
  return np.random.default_rng(42)


class _AsGpu:
  """A device that reports platform 'gpu' (all else delegated)."""

  platform = "gpu"

  def __init__(self, dev):
    self._dev = dev

  def __getattr__(self, name):
    return getattr(self._dev, name)


@pytest.fixture
def as_gpu(monkeypatch):
  """Context manager: inside it ``jax.devices()`` reports GPUs, so route
  choices gated on the platform take their accelerator branch while the
  arrays stay on the CPU mesh."""
  @contextlib.contextmanager
  def ctx():
    real = jax.devices
    monkeypatch.setattr(
        jax, "devices", lambda *a, **k: [_AsGpu(d) for d in real(*a, **k)])
    try:
      yield
    finally:
      monkeypatch.setattr(jax, "devices", real)
  return ctx


@pytest.fixture
def sparse_route(as_gpu):
  """Context manager forcing one SpMV/SpMM route: 'ell' (the CPU default),
  'bsr' (accelerator auto-routing, any block expansion accepted) or
  'dense' (--sparse_force_dense)."""
  from spartan_tpu.config import FLAGS

  @contextlib.contextmanager
  def ctx(route):
    assert route in ("ell", "bsr", "dense"), route
    old = (FLAGS.sparse_force_dense, FLAGS.sparse_bsr_max_expansion,
           FLAGS.sparse_dense_route)
    try:
      FLAGS.sparse_force_dense = route == "dense"
      if route == "bsr":
        FLAGS.sparse_bsr_max_expansion = 1e30
        FLAGS.sparse_dense_route = False
        with as_gpu():
          yield
      else:
        yield
    finally:
      (FLAGS.sparse_force_dense, FLAGS.sparse_bsr_max_expansion,
       FLAGS.sparse_dense_route) = old
  return ctx


# ---------------------------------------------------------------------------
# Smoke tier (VERDICT r3 next #7): ``-m smoke`` runs a <3-min subset
# covering every subsystem; the full suite stays the default.  Cheap
# modules are smoke wholesale; heavy modules contribute hand-picked
# representatives (by their r4 durations).
# ---------------------------------------------------------------------------

_SMOKE_ALL_FILES = {
    "test_integration.py", "test_stencil.py", "test_parallel.py",
    "test_uneven_shapes.py", "test_arithmetic.py", "test_autodiff.py",
    "test_spmd_lowering.py", "test_sort.py", "test_reduce.py",
    "test_map.py", "test_fft.py", "test_scan.py", "test_slice.py",
    "test_dot.py", "test_loop.py", "test_promotion.py", "test_array.py",
    "test_shuffle.py", "test_optimization.py", "test_reshape.py",
    "test_broadcast.py", "test_ext.py", "test_extent.py",
    "test_tiling.py",
}

_SMOKE_TESTS = {
    "test_kernels.py": {
        "test_full_sum_matches_numpy", "test_const_fold_unlocks_scalar_leaves",
        "test_accelerator_routes_are_xla",
    },
    "test_sparse.py": {
        "test_from_scipy_roundtrip", "test_spmv_matches_scipy",
        "test_spmm_matches_scipy", "test_auto_route_detects_block_structure",
        "test_spmv_routes_blocksparse", "test_sharded_spmv_matches",
        "test_pagerank_sparse_matches_dense", "test_spmv_expr_fuses_into_dag",
        "test_spmm_dense_route_gates",
        "test_sparse_transpose_memoized", "test_sparse_save_load",
    },
    "test_examples.py": {
        "test_examples_runner_registry_complete", "test_ridge_closed_form",
        "test_heat_diffusion_matches_numpy_loop",
        "test_kmeans_step_matches_numpy",
        "test_linear_regression_matches_numpy_loop",
        "test_pagerank_sparse_single_compile",
        "test_convnet_forward_shapes_and_oracle",
        "test_cg_solve_fused_matches", "test_lasso_fista_matches_numpy_loop",
        "test_naive_bayes", "test_poisson_spectral_solve",
        "test_black_scholes_matches_closed_form",
        "test_ssvd_matches_numpy_svd", "test_tsqr_orthogonal_and_reconstructs",
    },
    "test_linalg.py": {
        "test_pinv", "test_eigh_full", "test_qr", "test_svd_full",
        "test_solve_general_lu", "test_inv_det_slogdet", "test_cholesky",
        "test_replication_guard_warns_on_sharded_factorization",
    },
    "test_sample_sort.py": {
        "test_sample_sort_nans", "test_sample_partition_contract",
        "test_sample_sort_ragged_lowering_for_gpu",
        "test_sample_sort_hlo_has_all_to_all",
        "test_auto_threshold_routing", 
        "test_grad_through_sample_sort",
    },
    "test_smart_tiling.py": {
        "test_plan_dot_prefers_2d_output",
        "test_plan_shuffle_charges_all_to_all",
        "test_plan_deep_shared_dag_fast", "test_plan_transpose_is_free",
        "test_gradient_chain_prefers_row_sharded_design_matrix",
        "test_plan_stencil_charges_halo",
        "test_smart_tile_applies_and_preserves_results",
        "test_validate_plan_returns_measurements",
    },
    "test_aux.py": {
        "test_region_stats_counters", "test_broadcast_to",
        "test_pin_flush_clears_fn_key_cache", "test_learn_ridge",
        "test_eager_debug_mode", "test_multi_output_region",
        "test_learn_kmeans", "test_learn_logistic",
        "test_bench_orchestrator_contract", "test_graft_entry_contract",
        "test_platform_flag_registered",
    },
    "test_fio.py": {
        "test_from_file", "test_save_load_roundtrip", "test_save_expr",
        "test_checkpoint_computes_then_restores",
        "test_checkpoint_in_larger_dag",
        "test_crash_mid_save_leaves_no_manifest",
    },
    "test_deep_chains.py": {
        "test_deep_local_kernel_traversals", "test_deep_add_chain_evaluates",
        "test_deep_chain_chunking_preserves_grad_error_clarity",
    },
    "test_numpy_parity3.py": {
        "test_block_and_apply_over_axes", "test_unique_result_forms",
        "test_linalg_array_api_additions", "test_creation_additions",
        "test_split_family", "test_vecdot_matrix_transpose",
    },
    "test_builtins_extra.py": {
        "test_at_functional_updates",
        "test_at_advanced_indexing_numpy_parity",
        "test_einsum_contraction_routing",
        "test_numpy_ufunc_interop_stays_lazy", 
    },
    "test_fuzz.py": {"test_fuzz_grad_finite_difference"},
    "test_sparse_linalg.py": {
        "test_cg_dense_matches_direct", "test_gmres_restarted_matches_direct",
        "test_eigsh_which_modes", "test_svds_tall_and_wide",
        "test_lsqr_overdetermined_matches_numpy",
    },
}


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "smoke: fast representative subset (see conftest)")


def pytest_collection_modifyitems(config, items):
  for item in items:
    fname = os.path.basename(str(item.fspath))
    base = item.name.split("[")[0]
    if fname in _SMOKE_ALL_FILES or base in _SMOKE_TESTS.get(fname, ()):
      item.add_marker(pytest.mark.smoke)
