"""chip_smoke.py's phases at tiny sizes on the 8-device CPU mesh (the GPU
run uses the same functions at full size), and its refusal to run, or to
print a result, without a GPU."""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


TINY = {
    "phase_config1": dict(n=64),
    "phase_dot": dict(n=64, rows=8),
    "phase_linreg": dict(n=1024, d=8, steps=4),
    "phase_kmeans": dict(n=1024, d=8, k=4, steps=3),
    "phase_pagerank_ell": dict(n=1024, nnz_row=4, iters=10),
    # the CPU keeps ELL; block-ELL auto-routing is for accelerators
    "phase_pagerank_bsr": dict(n_blocks=8, blocks_per_row=2, bs=16,
                               iters=10, fmt="ell"),
    "phase_cg": dict(grid=16),
    "phase_stencils": dict(n=64, iters=5),
    "phase_fft": dict(n=64),
    "phase_sort": dict(n=1 << 12),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_tiny(smoke, name):
  rec = getattr(smoke, name)(**TINY[name])
  assert rec["ok"], rec
  assert rec["checks"] and all(c["max_err"] <= c["tol"]
                               for c in rec["checks"])
  assert rec["compile_s"] >= 0 and rec["run_s"] >= 0


def test_phase_lists_cover_issue_paths(smoke):
  assert [p.__name__ for p in smoke.SINGLE] == [
      "phase_config1", "phase_dot", "phase_linreg", "phase_kmeans",
      "phase_pagerank_ell", "phase_pagerank_bsr", "phase_cg",
      "phase_stencils", "phase_fft"]
  assert {p.__name__ for p in smoke.MULTI} >= {
      "phase_config1", "phase_dot", "phase_linreg", "phase_pagerank_ell",
      "phase_sort", "phase_fft"}


def test_main_without_gpu_exits_nonzero(smoke, capsys):
  assert smoke.main([]) != 0
  out = capsys.readouterr().out
  assert '"ok"' not in out
