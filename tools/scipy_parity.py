"""SciPy-surface parity audit (VERDICT r4 missing #5).

Extends the ``tools/numpy_parity.py`` pattern to the four scipy
namespaces the framework re-implements (sparse.linalg, sparse.csgraph,
linalg, optimize) plus scipy.sparse construction: enumerate the
upstream public callables, classify each as

* **covered** — a same-named spartan_tpu counterpart exists (tagged
  ``host`` when it is a documented host-boundary name: no XLA device
  kernel exists, it evaluates eagerly via scipy with a once-per-process
  notice — the sp.linalg.eig convention);
* **out of scope** — not an array computation this framework should own
  (test runners, BLAS plumbing, masked-array converters, ...), each
  with a stated reason;
* **MISSING** — in scope and absent (the audit's actionable residual).

Usage:
    python tools/scipy_parity.py          # summary + missing lists
    python tools/scipy_parity.py --md     # emit docs/PARITY_SCIPY.md
"""

from __future__ import annotations

import inspect
import sys

import scipy


# ---------------------------------------------------------------------
# per-namespace classification.  OUT_OF_SCOPE: name -> reason.
# HOST_BOUNDARY: names whose implementation is a documented host-eager
# scipy call (informational tag; they still count covered).
# ---------------------------------------------------------------------

OUT_OF_SCOPE = {
    "sparse.linalg": {
        "test": "scipy's bundled test runner",
    },
    "sparse.csgraph": {
        "test": "scipy's bundled test runner",
        "csgraph_from_masked": "masked arrays are a documented non-goal "
            "(ARCHITECTURE.md); use csgraph_from_dense with null_value",
        "csgraph_masked_from_dense": "masked arrays are a non-goal",
        "csgraph_to_masked": "masked arrays are a non-goal "
            "(csgraph_to_dense covers the round trip)",
    },
    "linalg": {
        "test": "scipy's bundled test runner",
        "get_blas_funcs": "BLAS function plumbing — XLA owns the kernels",
        "get_lapack_funcs": "LAPACK function plumbing — XLA owns the kernels",
        "find_best_blas_type": "BLAS dtype plumbing",
    },
    "optimize": {
        "test": "scipy's bundled test runner",
        "show_options": "interactive help printer",
        "linprog_verbose_callback": "legacy linprog display callback "
            "(printing machinery)",
    },
    "integrate": {
        "test": "scipy's bundled test runner",
    },
    "signal": {
        "test": "scipy's bundled test runner",
    },
    "ndimage": {
        "test": "scipy's bundled test runner",
    },
    "special": {
        "test": "scipy's bundled test runner",
    },
    "stats": {
        "test": "scipy's bundled test runner",
    },
    "spatial": {
        "test": "scipy's bundled test runner",
        "convex_hull_plot_2d": "matplotlib plotting helper",
        "delaunay_plot_2d": "matplotlib plotting helper",
        "voronoi_plot_2d": "matplotlib plotting helper",
    },
    "spatial.distance": {
        "CDistMetricWrapper": "scipy-internal metric plumbing",
        "PDistMetricWrapper": "scipy-internal metric plumbing",
        "MetricInfo": "scipy-internal metric registry",
        "Callable": "leaked typing import in scipy's namespace",
        "partial": "leaked functools import in scipy's namespace",
        "norm": "leaked numpy.linalg import in scipy's namespace",
    },
    "spatial.transform": {
        "test": "scipy's bundled test runner",
    },
    "fft": {
        "test": "scipy's bundled test runner",
        "register_backend": "scipy uarray backend plumbing — XLA owns "
            "transform execution",
        "set_backend": "scipy uarray backend plumbing",
        "set_global_backend": "scipy uarray backend plumbing",
        "skip_backend": "scipy uarray backend plumbing",
    },
    "cluster.vq": {
        "array_namespace": "leaked array-api-compat internal",
        "check_random_state": "leaked scipy._lib internal",
        "rng_integers": "leaked scipy._lib internal",
        "is_lazy_array": "leaked array-api internal",
        "xp_capabilities": "leaked array-api internal",
        "xp_copy": "leaked array-api internal",
        "xp_size": "leaked array-api internal",
        "cdist": "leaked import — lives at sp.spatial.distance.cdist",
        "deque": "leaked collections import",
    },
    "cluster.hierarchy": {},
    "sparse": {
        "get_index_dtype": "scipy-internal index-dtype plumbing",
        "safely_cast_index_arrays": "scipy-internal index plumbing",
        "dok_array": "incremental-mutation host format — construct via "
            "coo/csr/from_dense instead (device arrays are immutable)",
        "dok_matrix": "incremental-mutation host format",
        "lil_array": "incremental-mutation host format",
        "lil_matrix": "incremental-mutation host format",
        "expand_dims": "n-D sparse-array API — SparseArray is 2-D "
            "(matches the classic scipy.sparse matrix API)",
        "permute_dims": "n-D sparse-array API; use .T for 2-D transpose",
        "swapaxes": "n-D sparse-array API; use .T",
        "sparray": "scipy class-hierarchy base — isinstance checks use "
            "sp.sparse.issparse",
        "spmatrix": "scipy class-hierarchy base — use sp.sparse.issparse",
    },
    "interpolate": {
        "test": "scipy's bundled test runner",
    },
}

HOST_BOUNDARY = {
    "sparse.linalg": {
        "splu", "spilu", "factorized", "SuperLU",
        "funm_multiply_krylov", "lobpcg", "lgmres", "gcrotmk",
        "onenormest",
    },
    "sparse.csgraph": {
        "maximum_flow", "min_weight_full_bipartite_matching", "yen",
    },
    "linalg": {
        "schur", "rsf2csf", "hessenberg", "funm", "solve_sylvester",
        "solve_continuous_lyapunov", "solve_lyapunov",
        "solve_discrete_lyapunov", "ldl", "solve_banded", "solveh_banded",
        "subspace_angles", "matrix_balance", "eig", "qz", "ordqz",
        "cossin", "eig_banded", "eigvals_banded",
        "cholesky_banded", "cho_solve_banded", "solve_continuous_are",
        "solve_discrete_are", "qr_update", "qr_insert", "qr_delete",
        "qr_multiply", "solve_toeplitz", "expm_cond", "eigvals",
    },
    "optimize": {
        # differential_evolution/brute/fmin_tnc are DEVICE (fused
        # population loop / vmapped grid / projected-Newton box solver)
        "linear_sum_assignment", "nnls", "linprog", "milp",
        "basinhopping", "dual_annealing",
        "shgo", "direct", "isotonic_regression",
        "quadratic_assignment", "broyden1", "broyden2", "anderson",
        "linearmixing", "diagbroyden", "excitingmixing", "newton_krylov",
        "fmin_cobyla", "fmin_slsqp", "line_search",
    },
    "sparse": {
        "save_npz", "load_npz",
    },
    "ndimage": {
        "distance_transform_edt", "distance_transform_cdt",
        "distance_transform_bf", "watershed_ift", "generic_filter",
        "generic_filter1d", "geometric_transform", "spline_filter",
        "spline_filter1d", "median", "labeled_comprehension",
        "find_objects", "value_indices", "histogram",
        "generate_binary_structure", "iterate_structure",
    },
    "integrate": {
        "quad", "quad_vec", "dblquad", "tplquad", "nquad", "cubature",
        "nsum", "solve_bvp", "lebedev_rule", "odeint",
        "cumulative_simpson", "newton_cotes",
        # host driver classes, re-exported (SuperLU convention)
        "RK23", "RK45", "DOP853", "Radau", "BDF", "LSODA", "OdeSolver",
        "OdeSolution", "DenseOutput", "ode", "complex_ode",
        "IntegrationWarning", "ODEintWarning",
    },
}


def _integrate_mod():
  import scipy.integrate
  return scipy.integrate


def _signal_mod():
  import scipy.signal
  return scipy.signal


def _ndimage_mod():
  import scipy.ndimage
  return scipy.ndimage


def _special_mod():
  import scipy.special
  return scipy.special


def _stats_mod():
  import scipy.stats
  return scipy.stats


def _spatial_mod():
  import scipy.spatial
  import scipy.spatial.transform  # noqa: F401
  return scipy.spatial


def _fft_mod():
  import scipy.fft
  return scipy.fft


def _cluster_mod():
  import scipy.cluster
  import scipy.cluster.vq  # noqa: F401
  import scipy.cluster.hierarchy  # noqa: F401
  return scipy.cluster


def _interpolate_mod():
  import scipy.interpolate
  return scipy.interpolate


def _sp_namespaces():
  import spartan_tpu as sp
  import scipy.sparse.linalg  # noqa: F401
  import scipy.sparse.csgraph  # noqa: F401
  return [
      ("sparse.linalg", scipy.sparse.linalg, sp.sparse.linalg, True),
      ("sparse.csgraph", scipy.sparse.csgraph, sp.sparse.csgraph, True),
      ("linalg", scipy.linalg, sp.linalg, False),
      ("optimize", scipy.optimize, sp.optimize, True),
      ("integrate", _integrate_mod(), sp.integrate, True),
      ("signal", _signal_mod(), sp.signal, True),
      ("ndimage", _ndimage_mod(), sp.ndimage, True),
      ("special", _special_mod(), sp.special, True),
      ("stats", _stats_mod(), sp.stats, True),
      ("spatial", _spatial_mod(), sp.spatial, True),
      ("spatial.distance", _spatial_mod().distance,
       sp.spatial.distance, True),
      ("spatial.transform", _spatial_mod().transform,
       sp.spatial.transform, True),
      ("fft", _fft_mod(), sp.fft, True),
      ("cluster.vq", _cluster_mod().vq, sp.cluster.vq, True),
      ("cluster.hierarchy", _cluster_mod().hierarchy,
       sp.cluster.hierarchy, True),
      ("sparse", scipy.sparse, sp.sparse, True),
      ("interpolate", _interpolate_mod(), sp.interpolate, True),
  ]


def _public(mod, include_classes):
  out = []
  for n in dir(mod):
    if n.startswith("_"):
      continue
    obj = getattr(mod, n)
    if inspect.ismodule(obj):
      continue
    if inspect.isclass(obj):
      if not include_classes:
        continue
      out.append(n)
      continue
    if callable(obj):
      out.append(n)
  return sorted(out)


def audit():
  rows = []
  for key, smod, ours, inc in _sp_namespaces():
    names = _public(smod, inc)
    have = {n for n in dir(ours) if not n.startswith("_")}
    oos = OUT_OF_SCOPE.get(key, {})
    host = HOST_BOUNDARY.get(key, set())
    if key == "signal":
      # the signal module declares its own host re-export list (design-
      # time coefficient utilities) — single source of truth
      host = set(ours._REEXPORT)
    elif hasattr(ours, "_HOST_NAMES"):
      # module-declared host boundary — single source of truth
      # (special/stats auto-wraps, spatial qhull/transform re-exports)
      host = set(ours._HOST_NAMES)
    covered, host_cov, excluded, missing = [], [], [], []
    for n in names:
      if n in have:
        (host_cov if n in host else covered).append(n)
      elif n in oos:
        excluded.append(n)
      else:
        missing.append(n)
    stale = sorted((set(oos) | host) - set(names))
    rows.append(dict(ns=key, total=len(names), covered=covered,
                     host=host_cov, excluded=excluded, missing=missing,
                     stale=stale))
  return rows


def main(argv):
  rows = audit()
  md = "--md" in argv
  lines = []
  if md:
    lines.append("# SciPy surface parity\n")
    lines.append(f"Audited against scipy {scipy.__version__} "
                 "(`tools/scipy_parity.py`); regenerate with "
                 "`python tools/scipy_parity.py --md > "
                 "docs/PARITY_SCIPY.md`.\n")
    lines.append("`host` names are documented host-boundary wrappers "
                 "(no XLA device kernel — eager scipy with a once-per-"
                 "process notice, the `sp.linalg.eig` convention); "
                 "everything else covered runs through the lazy device "
                 "path.  Out-of-scope exclusions (with reasons) live in "
                 "the tool source.\n")
    lines.append("| namespace | device | host | of (in scope) | missing |")
    lines.append("|---|---|---|---|---|")
  bad = 0
  for r in rows:
    in_scope = r["total"] - len(r["excluded"])
    ndev, nhost = len(r["covered"]), len(r["host"])
    miss = " ".join(f"`{m}`" for m in r["missing"]) if md else \
        " ".join(r["missing"])
    if md:
      lines.append(f"| `scipy.{r['ns']}` | {ndev} | {nhost} | "
                   f"{in_scope} | {miss or '—'} |")
    else:
      lines.append(f"scipy.{r['ns']}: {ndev} device + {nhost} host = "
                   f"{ndev + nhost}/{in_scope} in scope; "
                   f"missing ({len(r['missing'])}): {miss or '—'}")
      if r["stale"]:
        lines.append(f"  [stale classification entries: "
                     f"{' '.join(r['stale'])}]")
    bad += len(r["missing"]) + len(r["stale"])
  print("\n".join(lines))
  return 1 if (bad and "--strict" in argv) else 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
