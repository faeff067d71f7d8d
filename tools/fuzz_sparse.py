"""Sparse-route differential fuzz: random (shape, density, dtype, route,
surface) SpMV/SpMM programs vs scipy oracles on the 8-device CPU mesh.

Usage (from the repo root): python tools/fuzz_sparse.py [n_seeds]

Covers: eager spmv/spmm, the SpMVExpr/SpMMExpr nodes (composed into a
downstream map), sp.dot dispatch (both operand orders), and sp.grad
through the expr — across the ELL gather and the forced densified route.
"""

import os
import sys

flag = "--xla_force_host_platform_device_count=8"
if flag not in os.environ.get("XLA_FLAGS", ""):
  os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + flag).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import scipy.sparse as ss  # noqa: E402

import spartan_tpu as sp  # noqa: E402
from spartan_tpu.backend import sparse as sps  # noqa: E402
from spartan_tpu.config import FLAGS  # noqa: E402


def one_case(seed: int) -> str:
  r = np.random.default_rng(seed)
  n = int(r.integers(1, 900))
  m = int(r.integers(1, 900))
  dens = float(r.choice([0.0, 0.005, 0.02, 0.1, 0.5]))
  dt = r.choice([np.float32, np.float64])
  route = str(r.choice(["ell", "dense"]))
  A = ss.random(n, m, density=dens, random_state=np.random.RandomState(seed),
                format="csr", dtype=np.float64).astype(dt)
  S = sps.from_scipy(A, dtype=dt)
  x = r.standard_normal(m).astype(dt)
  want = A @ x
  scale = max(np.abs(want).max(), 1.0)
  tol = 1e-9 if dt == np.float64 else 1e-5   # f32 summation-order noise
  FLAGS.sparse_force_dense = route == "dense"
  try:
    got = np.asarray(sps.spmv(S, x))
    if np.abs(got - want).max() / scale > tol:
      return f"seed {seed}: eager spmv mismatch ({route}, {n}x{m}, {dens})"
    e = (sps.spmv_expr(S, sp.from_numpy(x)) * 2.0 + 1.0)
    got2 = np.asarray(e.glom())
    if np.abs(got2 - (2.0 * want + 1.0)).max() / scale > 2 * tol + 1e-12:
      return f"seed {seed}: spmv_expr chain mismatch ({route})"
    k = int(r.integers(1, 6))
    B = r.standard_normal((m, k)).astype(dt)
    gotm = np.asarray(sp.dot(S, sp.from_numpy(B)).glom())
    if np.abs(gotm - A @ B).max() / scale > tol:
      return f"seed {seed}: sp.dot(S, B) mismatch ({route})"
    C = r.standard_normal((3, n)).astype(dt)
    gotr = np.asarray(sp.dot(sp.from_numpy(C), S).glom())
    if np.abs(gotr - C @ A.toarray()).max() / max(
        np.abs(C @ A.toarray()).max(), 1.0) > tol:
      return f"seed {seed}: sp.dot(C, S) mismatch"
    if dt == np.float32 and n >= 2 and r.random() < 0.7:
      xl = sp.from_numpy(x)
      c = r.standard_normal(n).astype(dt)
      (g,) = sp.grad(sp.sum(sps.spmv_expr(S, xl) * sp.from_numpy(c)),
                     wrt=[xl])
      gw = A.T @ c
      if np.abs(np.asarray(g.glom()) - gw).max() / max(
          np.abs(gw).max(), 1.0) > 1e-5:
        return f"seed {seed}: grad mismatch ({route})"
  finally:
    FLAGS.sparse_force_dense = False
  return ""


def main(n_seeds: int = 120) -> int:
  sp.initialize(["--log_level=40"])
  bad = 0
  for seed in range(n_seeds):
    try:
      msg = one_case(seed)
    except Exception as exc:  # noqa: BLE001
      msg = f"seed {seed}: EXC {type(exc).__name__}: {exc}"
    if msg:
      bad += 1
      print(msg, flush=True)
  print(f"fuzz_sparse: {n_seeds - bad}/{n_seeds} ok", flush=True)
  return 1 if bad else 0


if __name__ == "__main__":
  sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 120))
