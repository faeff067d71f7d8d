"""Every SpMV / SpMM route (``ell``, ``bsr``, ``dense``) against SciPy over
awkward matrices: square, rectangular with empty row blocks, tiny with
empty shards on the 8-device mesh, heavy duplicates in one row, and a
matrix whose ELL leaves are owner-sharded over the mesh.  Each case
checks the eager function, the lazy expr (composed into a downstream
map) and the gradient through the expr."""

import numpy as np
import pytest
import scipy.sparse as ss

import spartan_tpu as sp
from spartan_tpu.backend import sparse as sps


def _square(rng):
  n, per_row = 3000, 9
  r = rng.integers(0, n, n * per_row)
  c = rng.integers(0, n, n * per_row)
  v = rng.standard_normal(n * per_row).astype(np.float32)
  return ss.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()


def _rect_empty_blocks(rng):
  A = ss.random(4096, 2500, density=0.004, random_state=3, format="lil",
                dtype=np.float32)
  A[2048:3072, :] = 0          # a whole 1024-row block with no entries
  A = A.tocsr()
  A.eliminate_zeros()
  return A


def _tiny_empty_shards(rng):
  # 6 rows over 8 devices: the owner-sharded leaves pad to 8 rows, so
  # some shards hold only padding
  return ss.random(6, 2048, density=0.01, random_state=11, format="csr",
                   dtype=np.float32)


def _heavy_duplicates(rng):
  B = ss.lil_matrix((1100, 1100), dtype=np.float32)
  B[5, 0:200] = rng.standard_normal(200)
  B[5, 1024:1060] = rng.standard_normal(36)
  B[700, 3] = 1.5
  return B.tocsr()


def _owner_sharded(rng):
  return ss.random(2048, 2048, density=0.003, random_state=12,
                   format="csr", dtype=np.float32)


MATRICES = {"square": _square, "rect_empty_blocks": _rect_empty_blocks,
            "tiny_empty_shards": _tiny_empty_shards,
            "heavy_duplicates": _heavy_duplicates,
            "owner_sharded": _owner_sharded}
ROUTES = ["ell", "bsr", "dense"]
TOL = 1e-5    # f32 inputs on every route, relative to the result's max


def _rel(got, want):
  return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1.0)


def _check_leaf_placement(e, route, cluster):
  if route == "ell" and e.fmt == "ell":
    # owner-computes: cols/vals row-sharded over all 8 devices
    cols = e.inputs[0].value
    assert len({sh.device for sh in cols.addressable_shards}) == \
        int(cluster.devices.size)
    assert cols.shape[0] % int(cluster.devices.size) == 0


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmv_route(rng, sparse_route, cluster, name, route):
  A = MATRICES[name](rng)
  n, m = A.shape
  x = rng.standard_normal(m).astype(np.float32)
  c = rng.standard_normal(n).astype(np.float32)
  want = A @ x
  with sparse_route(route):
    S = sps.from_scipy(A, dtype=np.float32)
    got = sps.spmv(S, x)
    assert got.shape == (n,)
    assert _rel(got, want) < TOL, ("eager", name, route)
    e = sps.spmv_expr(S, sp.from_numpy(x))
    assert e.fmt == route, (name, e.fmt, route)
    _check_leaf_placement(e, route, cluster)
    chain = np.asarray((e * 0.85 + 0.15).glom())
    assert _rel(chain, 0.85 * want + 0.15) < TOL, ("expr", name, route)
    xl = sp.from_numpy(x)
    (g,) = sp.grad(sp.sum(sps.spmv_expr(S, xl) * sp.from_numpy(c)),
                   wrt=[xl])
    assert _rel(g.glom(), A.T @ c) < TOL, ("grad", name, route)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_route(rng, sparse_route, cluster, name, route):
  A = MATRICES[name](rng)
  n, m = A.shape
  k = 256 if name == "square" else 16   # one wide right-hand side
  B = rng.standard_normal((m, k)).astype(np.float32)
  want = A @ B
  with sparse_route(route):
    S = sps.from_scipy(A, dtype=np.float32)
    got = sps.spmm(S, B)
    assert got.shape == (n, k)
    assert _rel(got, want) < TOL, ("eager", name, route)
    e = sps.spmm_expr(S, sp.from_numpy(B))
    assert e.fmt == route, (name, e.fmt, route)
    _check_leaf_placement(e, route, cluster)
    chain = np.asarray((e * 2.0 + 1.0).glom())
    assert _rel(chain, 2.0 * want + 1.0) < 2 * TOL, ("expr", name, route)
    Bl = sp.from_numpy(B)
    (g,) = sp.grad(sp.sum(sps.spmm_expr(S, Bl) ** 2), wrt=[Bl])
    want_g = 2 * A.T @ want
    assert _rel(g.glom(), want_g) < 1e-4, ("grad", name, route)
