"""Smoke run of spartan_tpu's main path on one GPU (or four, ``--multi-gpu``).

Drives the library end to end through ``sp.*`` — lazy exprs, ``evaluate``/
``glom``, ``make_fori``, ``sp.dot``, sparse ``S @ x`` (ELL and block-ELL
routes), ``sp.grad``, ``sparse.linalg.cg``, FFTs — at sizes users run,
with random data made from a seed, and checks every phase against NumPy or
SciPy on the host.  Each phase prints one JSON line (compile and run
seconds, route taken, and for each precision checked its max error beside
its tolerance); then the card's name and power limit as ``nvidia-smi``
reports them; and last the line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result line, if JAX finds no GPU or any phase
fails.  One process drives every card it uses.

  python chip_smoke.py               # one GPU: phases 1-9
  python chip_smoke.py --multi-gpu   # four GPUs: the sharded path only

Errors are max-norm relative: ``max|got - want| / max|want|``.  On the GPU
an f32 matmul at ``dot_precision=default`` may run on the TF32 tensor
cores (10 explicit mantissa bits), so every phase whose result passes
through a matmul is checked at both ``default`` and ``highest``.  With
the library's f64 accumulation (``float64_reductions``, on here) a dense
``sp.dot`` of f32 operands widens them to f64 instead, and its phases are
held to f64 tolerances.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import jax
import numpy as np
import scipy.sparse as ss

import spartan_tpu as sp
from spartan_tpu.backend import sparse as sps
from spartan_tpu.config import FLAGS
from spartan_tpu.examples import (heat, kmeans, linear_reg, pagerank,
                                  poisson)

F32 = np.float32
EPS32 = 2.0 ** -24      # f32 unit roundoff
EPS_TF32 = 2.0 ** -11   # TF32 unit roundoff (10 explicit mantissa bits)


def _rel_err(got, want) -> float:
  got = np.asarray(got, np.complex128 if np.iscomplexobj(got) else
                   np.float64)
  want = np.asarray(want)
  return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                1e-300))


def _time2(run):
  """Call ``run`` twice; the first call compiles.  Returns (result of the
  second call, first-call seconds minus run seconds, run seconds)."""
  def once():
    t0 = time.perf_counter()
    out = run()
    jax.block_until_ready(getattr(out, "data", out))
    return out, time.perf_counter() - t0
  _, t_first = once()
  out, t_run = once()
  return out, max(t_first - t_run, 0.0), t_run


@contextlib.contextmanager
def _precision(prec: str):
  """``FLAGS.dot_precision`` set to ``prec`` (a cache-key flag, so each
  precision compiles its own regions)."""
  old = FLAGS.dot_precision
  FLAGS.dot_precision = prec
  try:
    yield
  finally:
    FLAGS.dot_precision = old


def _record(phase: str, route: str, checks, compile_s: float,
            run_s: float, **extra) -> dict:
  ok = all(c["max_err"] <= c["tol"] for c in checks)
  return dict(phase=phase, ok=ok, route=route, checks=checks,
              compile_s=round(compile_s, 3), run_s=round(run_s, 4), **extra)


def _check(precision: str, err: float, tol: float, why: str) -> dict:
  return {"precision": precision, "max_err": err, "tol": tol, "why": why}


def _f64_acc() -> bool:
  """Dense sp.dot accumulates (and so multiplies) in f64."""
  return bool(FLAGS.float64_reductions and jax.config.jax_enable_x64)


# ---------------------------------------------------------------------------
# Phases.  Defaults are the sizes the GPU run uses; the CPU tests call the
# same functions at tiny sizes.
# ---------------------------------------------------------------------------

def phase_config1(n: int = 16384) -> dict:
  """Config 1: ``(ones + 2b).sum()`` over an n² f32 leaf (1 GiB at the
  default n) — the affine rewrite — and the non-affine chain
  ``sum(abs(1 + 2b))``, which XLA fuses into one reduction pass."""
  b = sp.rand(n, n).astype(F32).evaluate()
  bh = b.glom().astype(np.float64)
  want_aff = n * n + 2.0 * bh.sum()
  want_abs = np.abs(1.0 + 2.0 * bh).sum()
  got_aff, c1, r1 = _time2(lambda: float(
      (sp.ones((n, n), dtype=F32) + b * 2.0).sum().glom()))
  got_abs, c2, r2 = _time2(lambda: float(
      sp.sum(sp.abs(1.0 + 2.0 * b)).glom()))
  checks = [
      # f64 accumulation (float64_reductions) of exact f32 inputs
      _check("f64-acc", abs(got_aff - want_aff) / abs(want_aff), 1e-9,
             "f64 accumulation; tree-sum error ~log2(n^2)*2^-53"),
      # 1+2b rounds once in f32 per element; all terms are positive, so
      # the relative error of the sum is bounded by the per-term one
      _check("f32-map/f64-acc", abs(got_abs - want_abs) / abs(want_abs),
             4 * EPS32, "one f32 rounding per positive term"),
  ]
  return _record("config1", "affine-rewrite + xla-fused-reduce", checks,
                 c1 + c2, r1 + r2, n=n, run_s_affine=round(r1, 4),
                 run_s_nonaffine=round(r2, 4))


def phase_dot(n: int = 32768, rows: int = 64, seed: int = 1) -> dict:
  """Config 2: ``sp.dot`` of two n² f32 operands (4 GiB each at the
  default n); ``rows`` sampled rows of the product against NumPy f64."""
  rng = np.random.default_rng(seed)
  A = sp.rand(n, n).astype(F32).evaluate()
  B = sp.rand(n, n).astype(F32).evaluate()
  idx = np.sort(rng.choice(n, min(rows, n), replace=False))
  want = A.fetch(idx).astype(np.float64) @ B.glom().astype(np.float64)
  checks, c_tot, runs = [], 0.0, {}
  # operands are uniform in [0, 1): every product is positive, so the
  # relative error of a dot is bounded by that of one product
  tols = {"default": (3 * EPS_TF32, "TF32 rounds both inputs: <= 2*2^-11 "
                      "per positive product, plus f32 accumulation"),
          "highest": (1e-4, "f32 products, f32 accumulation over n terms: "
                      "~sqrt(n)*2^-24 typical, 10x margin")}
  if _f64_acc():
    tols = dict.fromkeys(tols, (1e-12, "operands widened to f64: f64 "
                                "products and accumulation"))
  for prec in ("default", "highest"):
    C, c, r = _time2(lambda: sp.dot(A, B, precision=prec).evaluate())
    got = C.fetch(idx)
    del C
    checks.append(_check(prec, _rel_err(got, want), *tols[prec]))
    c_tot += c
    runs[prec] = round(r, 4)
  return _record("dot", "xla-dot", checks, c_tot, runs["highest"], n=n,
                 run_s_by_precision=runs,
                 tflops_by_precision={k: round(2 * n ** 3 / v / 1e12, 2)
                                      for k, v in runs.items() if v > 0})


def phase_linreg(n: int = 1 << 20, d: int = 64, steps: int = 10,
                 lr: float = 0.1, seed: int = 2) -> dict:
  """Linear regression: ``make_fori`` gradient steps at n×d f32 against a
  NumPy f32 loop, and ``sp.grad`` of the same loss against the analytic
  gradient."""
  rng = np.random.default_rng(seed)
  Xh = rng.standard_normal((n, d)).astype(F32)
  yh = (Xh @ rng.standard_normal(d).astype(F32)
        + 0.1 * rng.standard_normal(n).astype(F32)).astype(F32)
  X, y = sp.from_numpy(Xh), sp.from_numpy(yh)
  w_np = np.zeros(d, F32)
  for _ in range(steps):
    w_np = w_np - F32(lr) * (Xh.T @ (Xh @ w_np - yh) * F32(2.0 / n))
  w0 = rng.standard_normal(d).astype(F32)
  X64, y64 = Xh.astype(np.float64), yh.astype(np.float64)
  g_want = 2.0 / n * X64.T @ (X64 @ w0.astype(np.float64) - y64)
  # errors relative to max|w|: the gradient sums n signed products, so an
  # input rounding of u per product gives ~u*sqrt(n)*|term| against a
  # gradient of ~sqrt(n)*|term|
  tols = {"default": (8 * EPS_TF32, "TF32 input rounding in X@w and X^T r"),
          "highest": (1e-4, "f32 sums of n terms in another order than "
                      "NumPy's")}
  if _f64_acc():
    # the device is exact to f64 here; the NumPy f32 loop is the noisy side
    tols = dict.fromkeys(tols, (1e-4, "f64 device sums vs the f32 NumPy "
                                "loop's own rounding over n terms"))
  checks, c_tot, r_fori = [], 0.0, 0.0
  for prec in ("default", "highest"):
    with _precision(prec):
      run = sp.make_fori(
          lambda w: linear_reg.gradient_step(X, y, w, lr),
          sp.from_numpy(np.zeros(d, F32)))
      w, c, r = _time2(lambda: run(steps).glom())
      checks.append(_check(prec, _rel_err(w, w_np), *tols[prec]))
      wl = sp.from_numpy(w0)
      loss = sp.sum((sp.dot(X, wl) - y) ** 2) / n
      g = np.asarray(sp.grad(loss, wrt=[wl])[0].glom())
      checks.append(_check(prec + "/grad", _rel_err(g, g_want),
                           *tols[prec]))
    c_tot += c
    r_fori = r
  return _record("linreg", "make_fori + sp.grad", checks, c_tot, r_fori,
                 n=n, d=d, steps=steps, ms_per_step=round(
                     1e3 * r_fori / steps, 4))


def phase_kmeans(n: int = 1 << 19, d: int = 64, k: int = 64,
                 steps: int = 5, seed: int = 3) -> dict:
  """k-means: ``make_fori`` steps at n×d f32, k centers, on data drawn
  around k well-separated centers (so no label is a near-tie that
  rounding could flip), against a NumPy f32 loop."""
  rng = np.random.default_rng(seed)
  truth = (10.0 * rng.standard_normal((k, d))).astype(F32)
  lab = rng.integers(0, k, n)
  ph = (truth[lab] + rng.standard_normal((n, d))).astype(F32)
  c0 = (truth + 0.5 * rng.standard_normal((k, d))).astype(F32)
  c_np = c0.copy()
  for _ in range(steps):
    lbl = np.argmin(-2.0 * ph @ c_np.T + (c_np * c_np).sum(1), axis=1)
    sums = np.zeros((k, d), np.float64)
    np.add.at(sums, lbl, ph)
    cnt = np.maximum(np.bincount(lbl, minlength=k), 1)
    c_np = (sums / cnt[:, None]).astype(F32)
  pts = sp.from_numpy(ph)
  tols = {"default": (4 * EPS_TF32, "TF32 rounding of the points in the "
                      "one-hot segment-sum matmul"),
          "highest": (1e-5, "f32 means; labels agree exactly")}
  if _f64_acc():
    tols = dict.fromkeys(tols, (1e-5, "f64 segment sums, f32 centers; "
                                "labels agree exactly"))
  checks, c_tot, r_run = [], 0.0, 0.0
  for prec in ("default", "highest"):
    with _precision(prec):
      run = sp.make_fori(
          lambda c: kmeans.update_centers(
              pts, kmeans.assign_labels(pts, c), k), sp.from_numpy(c0))
      cen, c, r = _time2(lambda: run(steps).glom())
    checks.append(_check(prec, _rel_err(cen, c_np), *tols[prec]))
    c_tot += c
    r_run = r
  return _record("kmeans", "make_fori", checks, c_tot, r_run, n=n, d=d,
                 k=k, steps=steps, ms_per_step=round(1e3 * r_run / steps, 4))


def _pagerank_ref(A, iters: int, damping: float = 0.85) -> np.ndarray:
  n = A.shape[0]
  A64 = A.astype(np.float64)
  r = np.full(n, 1.0 / n)
  for _ in range(iters):
    r = damping * (A64 @ r) + (1.0 - damping) / n
  return r


def _column_stochastic(A):
  colsum = np.asarray(A.sum(axis=0)).ravel()
  return (A @ ss.diags(1.0 / np.maximum(colsum, 1e-30))).tocsr()


def phase_pagerank_ell(n: int = 1 << 21, nnz_row: int = 16,
                       iters: int = 20, seed: int = 4) -> dict:
  """PageRank on an unstructured random graph (n nodes, ``nnz_row`` links
  per row; ~270 MB of ELL at the default n) through
  ``pagerank.fit_sparse`` — the ELL gather route."""
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(n, dtype=np.int32), nnz_row)
  cols = rng.integers(0, n, n * nnz_row, dtype=np.int32)
  A = _column_stochastic(ss.csr_matrix(
      (np.ones(n * nnz_row, F32), (rows, cols)), shape=(n, n)))
  del rows, cols
  S = sps.from_scipy(A, dtype=F32)
  fmt = sps.spmv_expr(S, sp.ones((n,), dtype=F32)).fmt
  assert fmt == "ell", f"unstructured graph took fmt={fmt!r}, not 'ell'"
  want = _pagerank_ref(A, iters)
  r, c, t = _time2(lambda: pagerank.fit_sparse(S, iterations=iters))
  checks = [_check("f32", _rel_err(r, want), 1e-5,
                   "f32 gather-multiply-sum (no matmul); power iteration "
                   "contracts, so rounding does not grow with iters")]
  return _record("pagerank_ell", fmt, checks, c, t, n=n, nnz=int(S.nnz),
                 ell_bytes=int(S.cols.nbytes + S.vals.nbytes),
                 ms_per_iter=round(1e3 * t / iters, 4))


def phase_pagerank_bsr(n_blocks: int = 832, blocks_per_row: int = 4,
                       bs: int = 128, iters: int = 20, seed: int = 5,
                       fmt: str = "bsr") -> dict:
  """PageRank on a block-structured graph (``bs``² dense blocks; 218 MB of
  block values at the defaults) — auto-routed to block-ELL on an
  accelerator (``fmt``; the CPU keeps ELL)."""
  rng = np.random.default_rng(seed)
  n = n_blocks * bs
  cols_b = rng.integers(0, n_blocks, n_blocks * blocks_per_row)
  data = rng.random((n_blocks * blocks_per_row, bs, bs), dtype=F32)
  A = _column_stochastic(ss.bsr_matrix(
      (data, cols_b, np.arange(n_blocks + 1) * blocks_per_row),
      shape=(n, n)).tocsr())
  del data
  S = sps.from_scipy(A, dtype=F32)
  got_fmt = sps.spmv_expr(S, sp.ones((n,), dtype=F32)).fmt
  assert got_fmt == fmt, f"block graph took fmt={got_fmt!r}, not {fmt!r}"
  want = _pagerank_ref(A, iters)
  tols = {"default": (EPS_TF32 / (1 - 0.85) * 2,
                      "TF32 block matvec: 2*2^-11 per iteration, damped "
                      "by 1/(1-0.85) over the power iteration"),
          "highest": (1e-5, "f32 block matvec")}
  checks, c_tot, t_run = [], 0.0, 0.0
  for prec in ("default", "highest"):
    with _precision(prec):
      r, c, t = _time2(lambda: pagerank.fit_sparse(S, iterations=iters))
    checks.append(_check(prec, _rel_err(r, want), *tols[prec]))
    c_tot += c
    t_run = t
  bsr = S.auto_route()
  return _record("pagerank_bsr", got_fmt, checks, c_tot, t_run, n=n,
                 nnz=int(S.nnz),
                 bsr_bytes=None if bsr is None else int(
                     bsr.block_vals.nbytes + bsr.block_cols.nbytes),
                 ms_per_iter=round(1e3 * t_run / iters, 4))


def phase_cg(grid: int = 2048, rtol: float = 1e-6, seed: int = 6) -> dict:
  """``sp.sparse.linalg.cg`` on the grid² 5-point Poisson matrix (f64),
  relative residual checked on the host with SciPy."""
  rng = np.random.default_rng(seed)
  T = ss.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(grid, grid))
  I = ss.identity(grid)
  A = (ss.kron(I, T) + ss.kron(T, I)).tocsr()
  b = rng.standard_normal(grid * grid)
  S = sps.from_scipy(A)
  fmt = sps.spmv_expr(S, sp.from_numpy(b)).fmt

  def solve():
    x, info = sp.sparse.linalg.cg(S, sp.from_numpy(b), rtol=rtol,
                                  maxiter=40 * grid)
    assert info == 0, f"cg did not converge (info={info})"
    return x
  x, c, t = _time2(solve)
  res = float(np.linalg.norm(b - A @ x.glom()) / np.linalg.norm(b))
  checks = [_check("f64", res, 2 * rtol,
                   "true residual vs the solver's recurrence residual "
                   "(stop at rtol); f64 drift ~eps*cond is far below")]
  return _record("cg", fmt, checks, c, t, unknowns=grid * grid)


def phase_stencils(n: int = 8192, iters: int = 10, seed: int = 7) -> dict:
  """``heat.simulate_padded`` and ``poisson.solve_jacobi`` at n² f32
  against their NumPy (f64) loops."""
  rng = np.random.default_rng(seed)
  u0 = rng.random((n, n), dtype=F32)
  f = rng.standard_normal((n, n)).astype(F32)
  u, c1, r1 = _time2(lambda: heat.simulate_padded(u0, iters, alpha=0.1))
  e_heat = _rel_err(u, heat.simulate_numpy(u0, iters, alpha=0.1))
  del u
  v, c2, r2 = _time2(lambda: poisson.solve_jacobi(f, iters))
  e_jac = _rel_err(v, poisson.solve_jacobi_numpy(f, iters))
  # a step sums 5 f32 terms (4 roundings) into values of the same scale
  tol = 8 * iters * EPS32
  checks = [_check("f32/heat", e_heat, tol, "4 f32 roundings per step"),
            _check("f32/jacobi", e_jac, tol, "4 f32 roundings per step")]
  # call times include moving the n² field to and from the host
  return _record("stencils", "xla-fori-shifted-add", checks, c1 + c2,
                 r1 + r2, n=n, iters=iters, call_s_heat=round(r1, 4),
                 call_s_jacobi=round(r2, 4))


def phase_fft(n: int = 4096, seed: int = 8) -> dict:
  """A complex64 n² leaf: ``sp.fft.fft2`` against NumPy, and the
  ``ifft2(fft2(z))`` round trip fetched back complex."""
  rng = np.random.default_rng(seed)
  zh = (rng.standard_normal((n, n))
        + 1j * rng.standard_normal((n, n))).astype(np.complex64)
  z = sp.from_numpy(zh)
  fz, c1, r1 = _time2(lambda: sp.fft.fft2(z).glom())
  e_fwd = _rel_err(fz, np.fft.fft2(zh.astype(np.complex128)))
  del fz
  back, c2, r2 = _time2(lambda: sp.fft.ifft2(sp.fft.fft2(z)).glom())
  assert np.iscomplexobj(back), f"round trip came back {back.dtype}"
  e_rt = _rel_err(back, zh)
  # FFT rounding grows ~log2(n^2) f32 roundings
  tol = 4 * np.log2(n * n) * EPS32
  checks = [_check("c64/fft2", e_fwd, tol, "~log2(n^2) f32 roundings"),
            _check("c64/roundtrip", e_rt, 2 * tol, "two transforms")]
  # on a >1-device mesh an n² transform at the default sizes is above
  # --fft_pencil_min_elems and takes the pencil (all_to_all) route
  from spartan_tpu.core.mesh import get_mesh
  route = "xla-fft" + ("/pencil" if get_mesh().devices.size > 1 else "")
  return _record("fft", route, checks, c1 + c2, r1 + r2, n=n,
                 dtype=str(back.dtype))


def phase_sort(n: int = 1 << 26, seed: int = 9) -> dict:
  """Distributed sample sort (``sort_method=sample``) of n f32 values."""
  from spartan_tpu.core.mesh import get_mesh
  from spartan_tpu.parallel import sample_sort
  xh = np.random.default_rng(seed).standard_normal(n).astype(F32)
  x = sp.from_numpy(xh)
  exchange = sample_sort._pick_exchange(get_mesh(), "auto")
  old = FLAGS.sort_method
  FLAGS.sort_method = "sample"
  try:
    got, c, t = _time2(lambda: sp.sort(x).glom())
  finally:
    FLAGS.sort_method = old
  exact = bool(np.array_equal(got, np.sort(xh)))
  checks = [_check("f32", 0.0 if exact else 1.0, 0.0, "a sort is exact")]
  return _record("sort", f"sample/{exchange}", checks, c, t, n=n)


SINGLE = [phase_config1, phase_dot, phase_linreg, phase_kmeans,
          phase_pagerank_ell, phase_pagerank_bsr, phase_cg,
          phase_stencils, phase_fft]
MULTI = [phase_config1, phase_dot, phase_linreg, phase_pagerank_ell,
         phase_sort, phase_fft]


def _nvidia_smi() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      timeout=60, check=True)
  return out.stdout.strip()


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--multi-gpu", action="store_true",
                  help="run the sharded path over four GPUs")
  args = ap.parse_args(argv)
  dev = jax.devices()[0]
  if dev.platform != "gpu":
    print(f"chip_smoke: no GPU (JAX found {dev.platform!r}); nothing run",
          file=sys.stderr)
    return 2
  n_use = 4 if args.multi_gpu else 1
  if len(jax.devices()) < n_use:
    print(f"chip_smoke: needs {n_use} GPUs, found {len(jax.devices())}",
          file=sys.stderr)
    return 2
  # the library accumulates reductions in f64 (float64_reductions)
  jax.config.update("jax_enable_x64", True)
  from spartan_tpu.core.mesh import make_mesh
  from spartan_tpu.util import enable_compile_cache
  enable_compile_cache()
  sp.initialize(["--log_level=30"],
                mesh=make_mesh(devices=jax.devices()[:n_use]))
  ok = True
  for phase in MULTI if args.multi_gpu else SINGLE:
    t0 = time.perf_counter()
    rec = phase()
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    rec["devices"] = n_use
    print(json.dumps(rec), flush=True)
    ok &= rec["ok"]
  print(_nvidia_smi(), flush=True)
  if not ok:
    print("chip_smoke: a phase exceeded its tolerance", file=sys.stderr)
    return 1
  print(json.dumps({"ok": True, "device": {
      "platform": dev.platform, "kind": dev.device_kind,
      "count": len(jax.devices())}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
