"""SpartanArray: the DistArray-parity surface (reference:
``spartan/array/distarray.py`` — create/fetch/update/foreach_tile/glom/
select; SURVEY.md §2.1)."""

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import spartan_tpu as sp
from spartan_tpu.core import array as array_mod
from spartan_tpu.core.extent import TileExtent
from spartan_tpu.core.tiling import Tiling


@pytest.fixture
def arr(rng):
  a = rng.standard_normal((16, 8))
  return sp.from_numpy(a).value, a


def test_create(cluster):
  a = array_mod.create((16, 8), dtype=np.float64, fill=3.0)
  np.testing.assert_array_equal(a.glom(), np.full((16, 8), 3.0))
  assert a.shape == (16, 8)


def test_glom_fetch_select(arr):
  a, host = arr
  np.testing.assert_array_equal(a.glom(), host)
  ext = TileExtent((2, 1), (5, 4), (16, 8))
  np.testing.assert_array_equal(a.fetch(ext), host[2:5, 1:4])
  np.testing.assert_array_equal(a.select((slice(0, 3), slice(None))),
                                host[:3])


def test_update_reducers(arr):
  a, host = arr
  patch = np.ones((3, 3))
  ext = TileExtent((1, 1), (4, 4), (16, 8))
  for reducer, npop in [(None, "set"), (np.add, "add"),
                        (np.maximum, "max"), (np.minimum, "min"),
                        (np.multiply, "mul")]:
    out = a.update(ext, patch, reducer)
    want = host.copy()
    region = want[1:4, 1:4]
    if npop == "set":
      want[1:4, 1:4] = patch
    elif npop == "add":
      want[1:4, 1:4] = region + patch
    elif npop == "max":
      want[1:4, 1:4] = np.maximum(region, patch)
    elif npop == "min":
      want[1:4, 1:4] = np.minimum(region, patch)
    elif npop == "mul":
      want[1:4, 1:4] = region * patch
    np.testing.assert_allclose(out.glom(), want, atol=1e-12)
  # original untouched (functional semantics)
  np.testing.assert_array_equal(a.glom(), host)


def test_bad_reducer_rejected(arr):
  a, _ = arr
  with pytest.raises(ValueError):
    a.update(TileExtent((0, 0), (1, 1), (16, 8)), np.ones((1, 1)),
             reducer="nope")


def test_foreach_tile_covers_array(arr):
  a, host = arr
  seen = np.zeros_like(host, dtype=bool)
  total = []

  def visit(ext, block):
    assert block.shape == ext.shape
    seen[ext.to_slice()] = True
    total.append(block.sum())

  a.foreach_tile(visit)
  assert seen.all()
  np.testing.assert_allclose(sum(total), host.sum(), rtol=1e-12)


def test_tile_extents_partition(arr):
  a, host = arr
  exts = a.tile_extents()
  assert sum(e.size for e in exts) == host.size
  # extents are disjoint
  cover = np.zeros_like(host, dtype=int)
  for e in exts:
    cover[e.to_slice()] += 1
  assert (cover == 1).all()


def test_reshard_preserves(arr, cluster):
  a, host = arr
  moved = a.reshard(Tiling(cluster, P(None, ("x", "y"))))
  np.testing.assert_array_equal(moved.glom(), host)


def test_astype_and_numpy_protocol(arr):
  a, host = arr
  assert a.astype(np.float32).dtype == np.float32
  np.testing.assert_array_equal(np.asarray(a), host)


def test_spartan_array_lazy_reentry(rng, cluster):
  """Operators/indexing/methods on an EVALUATED array re-enter the lazy
  layer (reference semantics: DistArrays are valid operands)."""
  an = rng.standard_normal((16, 8))
  a = sp.from_numpy(an).evaluate()
  got = np.asarray(((a * 2 + 1)[0:4]).sum(axis=0).glom())
  np.testing.assert_allclose(got, (an * 2 + 1)[0:4].sum(axis=0),
                             rtol=1e-12)
  np.testing.assert_allclose(np.asarray((2.0 * a).glom()), 2 * an)
  np.testing.assert_allclose(np.asarray((a @ an.T).glom()), an @ an.T,
                             rtol=1e-12)
  np.testing.assert_array_equal(np.asarray((a > 0).glom()), an > 0)
  np.testing.assert_allclose(np.asarray(a.T.glom()), an.T)
  np.testing.assert_allclose(np.asarray(a.clip(-1, 1).cumsum(0).glom()),
                             an.clip(-1, 1).cumsum(0), rtol=1e-12)
  assert abs(a.mean().item() - an.mean()) < 1e-12
  np.testing.assert_allclose(
      np.asarray(a.at[0, :].set(0.0).glom())[0], np.zeros(8))
  with pytest.raises(AttributeError):
    a.no_such_method


def test_spartan_array_numpy_left_and_hash(rng, cluster):
  """r3-s4 review: numpy-left operands dispatch lazily (no silent
  full gather); elementwise eq ⇒ unhashable like np.ndarray/Expr;
  shifts/invert re-enter the lazy layer; ddof flows through methods."""
  an = rng.standard_normal((4, 5))
  a = sp.from_numpy(an).evaluate()
  r = np.ones((4, 5)) * a
  assert not isinstance(r, np.ndarray)      # stayed lazy
  np.testing.assert_allclose(np.asarray(np.sin(a).glom()), np.sin(an))
  with pytest.raises(TypeError):
    hash(a)
  ia = sp.from_numpy(np.arange(4)).evaluate()
  np.testing.assert_array_equal(np.asarray((ia << 2).glom()),
                                np.arange(4) << 2)
  np.testing.assert_array_equal(np.asarray((~ia).glom()), ~np.arange(4))
  np.testing.assert_allclose(np.asarray(a.var(ddof=1).glom()),
                             an.var(ddof=1), rtol=1e-12)
  np.testing.assert_allclose(np.asarray(a.std(ddof=1).glom()),
                             an.std(ddof=1), rtol=1e-12)
