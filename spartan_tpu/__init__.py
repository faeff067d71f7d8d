"""spartan-tpu: a distributed array framework built on JAX.

A from-scratch rebuild of the capabilities of the reference distributed
array framework (spartan-array/spartan — lazy NumPy-like expression DAG
over tiled arrays; see SURVEY.md): user code builds a lazy expression
graph; an optimizer fuses chains of tile ops and picks shardings ("smart
tiling"); fused regions compile once with ``jax.jit`` and execute SPMD over
a ``jax.sharding.Mesh``, with XLA collectives over the interconnect
replacing the reference's master/worker RPC layer.

Public surface mirrors the reference's top-level API (reference:
``spartan/__init__.py`` — ``initialize``/``shutdown`` + re-exported expr
builtins; SURVEY.md §2.1).
"""

from __future__ import annotations

from typing import List, Optional

from spartan_tpu.config import FLAGS
from spartan_tpu import util
from spartan_tpu.core import (TileExtent, Tiling, SpartanArray, get_mesh,
                              make_mesh, set_default_mesh, with_mesh)

__version__ = "0.3.0"

_initialized = False


def initialize(argv: Optional[List[str]] = None, mesh=None) -> None:
  """Parse flags and install the default mesh.

  The reference's ``initialize`` parses flags, boots the master/worker
  cluster and installs a BlobCtx (SURVEY.md §3.1); here the whole cluster
  bring-up collapses into mesh construction — sharding is placement.
  """
  global _initialized
  FLAGS.parse(argv)
  util.set_log_level(FLAGS.log_level)
  if FLAGS.platform:
    # config.update AFTER importing jax: wins over JAX_PLATFORMS
    import jax
    jax.config.update("jax_platforms", FLAGS.platform)
  if FLAGS.multihost:
    import jax
    # multi-host SPMD: one controller per host, all devices in one mesh
    # (replaces the reference's ssh-spawned worker fleet)
    jax.distributed.initialize()
  if mesh is None:
    mesh = make_mesh()
  set_default_mesh(mesh)
  _initialized = True


def shutdown() -> None:
  global _initialized
  set_default_mesh(None)
  _initialized = False


# NumPy-style builtins (lazy expr constructors) — populated by the expr
# layer; imported late to avoid cycles.
from spartan_tpu.expr.builtins import *  # noqa: F401,F403,E402
from spartan_tpu.expr.builtins import __all__ as _builtin_all  # noqa: E402
from spartan_tpu.expr.base import (Expr, Val, ListExpr, TupleExpr, DictExpr,  # noqa: E402
                                   NotShapeable, evaluate, force, lazify)
from spartan_tpu.expr.map import map, map_with_location  # noqa: E402
from spartan_tpu.expr.shuffle import shuffle  # noqa: E402
from spartan_tpu.expr.smart_tiling import smart_tile, plan as tiling_plan  # noqa: E402
from spartan_tpu.expr.remat import remat  # noqa: E402
from spartan_tpu.expr.loop import fori_loop, make_fori, while_loop, scan_iters, cond  # noqa: E402
from spartan_tpu.autodiff import compile_fn as compile  # noqa: E402,A001
from spartan_tpu.autodiff import (grad, value_and_grad, jvp, hessian, hvp,  # noqa: E402
                                  minimize, sgd_train)
from spartan_tpu.expr.reduce import reduce  # noqa: E402,A001
from spartan_tpu.expr.fio import checkpoint, from_file, load, save  # noqa: E402
from spartan_tpu.backend import sparse  # noqa: E402
from spartan_tpu.backend.sparse import (SparseArray, sparse_diagonal,  # noqa: E402
                                        sprandn)
from spartan_tpu import linalg  # noqa: E402  (np.linalg-style surface)
from spartan_tpu import fft  # noqa: E402  (np.fft-style surface)
from spartan_tpu import random  # noqa: E402,A004  (np.random-style surface)
from spartan_tpu import sparse_linalg  # noqa: E402  (scipy.sparse.linalg)
sparse.linalg = sparse_linalg  # the scipy idiom: sp.sparse.linalg.cg(...)
from spartan_tpu import sparse_construct  # noqa: E402  (scipy.sparse builders)
for _name in sparse_construct.__all__:
  setattr(sparse, _name, getattr(sparse_construct, _name))
from spartan_tpu import optimize  # noqa: E402  (scipy.optimize surface)
from spartan_tpu import integrate  # noqa: E402  (scipy.integrate surface)
from spartan_tpu import signal  # noqa: E402  (scipy.signal surface)
from spartan_tpu import ndimage  # noqa: E402  (scipy.ndimage surface)
from spartan_tpu import special  # noqa: E402  (scipy.special surface)
from spartan_tpu import stats  # noqa: E402  (scipy.stats surface)
from spartan_tpu import spatial  # noqa: E402  (scipy.spatial surface)
from spartan_tpu import cluster  # noqa: E402  (scipy.cluster surface)
from spartan_tpu import interpolate  # noqa: E402  (scipy.interpolate)
from spartan_tpu import constants  # noqa: E402  (scipy.constants)
from spartan_tpu import differentiate  # noqa: E402  (scipy.differentiate)
from spartan_tpu import io  # noqa: E402  (scipy.io surface)
from spartan_tpu import csgraph  # noqa: E402  (scipy.sparse.csgraph)
sparse.csgraph = csgraph  # the scipy idiom: sp.sparse.csgraph.dijkstra(...)
from spartan_tpu import scipy_linalg  # noqa: E402  (scipy.linalg surface)
for _name in scipy_linalg.__all__:
  # merge non-conflicting names into sp.linalg (the array-API pattern);
  # overlapping names (cholesky/qr/solve/solve_triangular) keep the
  # framework-native blocked implementations already in sp.linalg
  if not hasattr(linalg, _name):
    setattr(linalg, _name, getattr(scipy_linalg, _name))
del _name

__all__ = ["initialize", "shutdown", "FLAGS", "util", "TileExtent", "Tiling",
           "SpartanArray", "get_mesh", "make_mesh", "with_mesh", "Expr",
           "Val", "ListExpr", "TupleExpr", "DictExpr", "NotShapeable",
           "evaluate", "force", "lazify", "map", "map_with_location",
           "shuffle", "smart_tile", "tiling_plan", "remat", "fori_loop", "make_fori",
           "while_loop", "scan_iters", "cond", "compile", "reduce",
           "grad", "value_and_grad", "jvp", "hessian", "hvp", "minimize", "sgd_train",
           "checkpoint", "from_file", "load", "save", "sparse", "linalg", "fft", "random",
           "sparse_linalg", "scipy_linalg", "optimize", "integrate", "signal", "ndimage",
           "special", "stats", "spatial", "cluster", "interpolate",
           "SparseArray", "sparse_diagonal", "sprandn"] + list(_builtin_all)
