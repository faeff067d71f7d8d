"""At-scale csgraph chip row (VERDICT r4 missing #1 / weak #4).

bellman_ford on a random directed graph at n=16384, ~500K edges,
4 sources: reports cold + warm wall time, relaxation rounds to
converge, per-round time, and max abs error vs scipy's dijkstra.

Run on the chip:
  PYTHONPATH=. timeout 600 \
      python -u tools/csgraph_scale_probe.py
"""
import time

import numpy as np
import scipy.sparse as ss
import scipy.sparse.csgraph as cs

t0 = time.time()
import spartan_tpu as sp  # noqa: E402
from spartan_tpu.csgraph import _as_sparse, _indices_array, _sssp  # noqa: E402

import jax  # noqa: E402

print(f"[{time.time()-t0:6.1f}s] device: {jax.devices()[0].device_kind}",
      flush=True)

N = 16384
NNZ = 500_000
r = np.random.default_rng(0)
rows = r.integers(0, N, NNZ)
cols = r.integers(0, N, NNZ)
keep = rows != cols
vals = r.uniform(0.1, 5.0, NNZ)
g = ss.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=(N, N))
g.sum_duplicates()
print(f"[{time.time()-t0:6.1f}s] graph: n={N} nnz={g.nnz} "
      f"max_deg={int(np.diff(g.indptr).max())}", flush=True)

G = _as_sparse(g)
srcs = _indices_array([0, 1, 2, 3], N)
print(f"[{time.time()-t0:6.1f}s] packed: ELL width={G.cols.shape[1]}",
      flush=True)

t1 = time.time()
dist, hit, rounds = _sssp(G, srcs, directed=True, unweighted=False,
                          detect_negative=True)
cold = time.time() - t1
t1 = time.time()
dist, hit, rounds = _sssp(G, srcs, directed=True, unweighted=False,
                          detect_negative=True)
warm = time.time() - t1

want = cs.dijkstra(g, directed=True, indices=[0, 1, 2, 3])
finite = np.isfinite(want)
err = np.abs(dist[finite] - want[finite]).max()
frac_reach = finite.mean()
print(f"[{time.time()-t0:6.1f}s] bellman_ford n={N} nnz={g.nnz}: "
      f"cold={cold:.2f}s warm={warm:.3f}s rounds={rounds} "
      f"per_round={1000*warm/max(rounds,1):.2f}ms "
      f"err={err:.2e} reach={frac_reach:.3f}", flush=True)
assert err < 1e-3, err
print("CSGRAPH_SCALE_OK", flush=True)
