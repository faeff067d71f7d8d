"""File IO, checkpointing, and host-side escape hatches.

Rebuild of the reference's IO layer (reference:
``spartan/expr/fio.py`` — per-tile pickle/npy save/load, ``from_numpy`` /
``from_file`` — and ``spartan/expr/checkpoint.py`` — persisting a
sub-DAG's result so lineage re-execution restarts from it; SURVEY.md §2.1,
§5).  The rebuild stores one ``.npy`` per logical shard plus a JSON
manifest (shape, dtype, mesh shape, PartitionSpec) and restores into an
identical NamedSharding — sharding-aware checkpoint/resume.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Optional, Sequence

import jax
import numpy as np

from spartan_tpu.core.array import SpartanArray, from_numpy as _from_numpy
from spartan_tpu.core.extent import TileExtent
from spartan_tpu.core.mesh import get_mesh
from spartan_tpu.core.tiling import Tiling
from spartan_tpu.expr.base import Expr, NotShapeable, Val, lazify
from spartan_tpu.util import log_info


class HostExpr(Expr):
  """Host-side numpy computation — a materialization boundary for ops whose
  output shape is data-dependent (unique/nonzero/unbounded bincount)."""

  _members = ("inputs",)
  _params = ("fn",)

  def __init__(self, inputs, fn: Callable):
    super().__init__(inputs=[lazify(v) for v in inputs], fn=fn)

  def aval(self):
    raise NotShapeable(f"host op {self.fn} has data-dependent shape")

  def _emit(self, ctx, deps):
    raise NotShapeable("host op must be evaluated eagerly")

  def evaluate_eager(self) -> SpartanArray:
    args = [c.evaluate().glom() for c in self.inputs]
    return _from_numpy(np.asarray(self.fn(*args)))


class CheckpointExpr(Expr):
  """Persist the child's result on first evaluation; later evaluations (and
  fresh processes) restore from disk instead of recomputing the lineage.

  ``_eager_boundary`` makes the evaluator materialize this node before
  tracing any enclosing DAG — the restore path must win over re-emission.
  """

  _members = ("inputs",)
  _params = ("path",)
  _eager_boundary = True

  def __init__(self, child, path: str):
    super().__init__(inputs=[lazify(child)], path=path)

  def aval(self):
    return self.inputs[0].aval()

  def _emit(self, ctx, deps):
    return deps[0]

  def evaluate_eager(self) -> SpartanArray:
    if os.path.exists(os.path.join(self.path, "manifest.json")):
      log_info("checkpoint restore: %s", self.path)
      restored = load(self.path)
      try:
        want = tuple(self.inputs[0].shape)
        if tuple(restored.shape) != want:
          from spartan_tpu.util import log_warn
          log_warn("checkpoint %s restored shape %s but the expression "
                   "produces %s — stale checkpoint? (path identifies the "
                   "artifact; delete it to recompute)", self.path,
                   tuple(restored.shape), want)
      except Exception:
        pass
      return restored
    result = self.inputs[0].evaluate()
    save(result, self.path)
    return result

  def evaluate(self):
    if self._cache is None:
      self._cache = self.evaluate_eager()
    return self._cache


def checkpoint(v, path: str) -> CheckpointExpr:
  return CheckpointExpr(v, path)


# ---------------------------------------------------------------------------
# save / load: one npy per logical shard + JSON manifest
# ---------------------------------------------------------------------------

def save(v, path: str) -> None:
  """Write a SpartanArray (or expr) as per-shard .npy files + manifest.

  Shards are pulled one at a time from the device's addressable shards —
  no full-array host materialization (the reference wrote per-tile files
  from each worker for the same reason).  Falls back to a glom when shards
  aren't all addressable in this process.
  """
  arr = v.evaluate() if isinstance(v, Expr) else v
  os.makedirs(path, exist_ok=True)
  extents = arr.tile_extents()
  manifest = {
      "shape": list(arr.shape),
      "dtype": str(arr.dtype),
      "mesh_shape": {k: int(s) for k, s in arr.tiling.mesh.shape.items()},
      "spec": [list(e) if isinstance(e, (tuple, list)) else e
               for e in tuple(arr.tiling.spec)],
      "num_shards": len(extents),
      "shards": [{"ul": list(e.ul), "lr": list(e.lr)} for e in extents],
  }

  def write_manifest():
    # Manifest is written LAST (tmp + atomic rename): its presence implies
    # every shard is on disk, so a crash mid-save leaves a recomputable
    # directory instead of a permanently-broken restore.
    tmp = os.path.join(path, f".manifest.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
      json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))

  ext_index = {(e.ul, e.lr): i for i, e in enumerate(extents)}
  written = set()
  try:
    shards = arr.data.addressable_shards
  except Exception:
    shards = []
  shape = arr.shape
  for sh in shards:
    idx = sh.index
    ul = tuple((sl.start or 0) for sl in idx)
    lr = tuple(sl.stop if sl.stop is not None else s
               for sl, s in zip(idx, shape))
    i = ext_index.get((ul, lr))
    if i is None or i in written:
      continue  # replica of an already-written tile
    # temp + rename: in multi-process runs two processes may hold
    # replicas of the same tile and race on the file — writes are
    # identical content, so an atomic rename makes either winner fine
    tmp = os.path.join(path, f".shard_{i:05d}.{os.getpid()}.tmp.npy")
    np.save(tmp, np.asarray(sh.data))
    os.replace(tmp, os.path.join(path, f"shard_{i:05d}.npy"))
    written.add(i)
  if len(written) != len(extents):
    import jax
    if jax.process_count() > 1:
      # multi-host: every process writes its ADDRESSABLE shards; the
      # missing ones belong to peer processes (caller synchronizes,
      # e.g. multihost_utils.sync_global_devices, before load — after
      # the barrier all shards named by the manifest exist)
      write_manifest()
      return
    # single-process odd layout: fill the gaps from a host gather
    host = arr.glom()
    for i, ext in enumerate(extents):
      if i not in written:
        np.save(os.path.join(path, f"shard_{i:05d}.npy"),
                host[ext.to_slice()])
  write_manifest()


def load(path: str, mesh=None) -> SpartanArray:
  """Restore an array saved by :func:`save` into an identical sharding."""
  with open(os.path.join(path, "manifest.json")) as f:
    manifest = json.load(f)
  shape = tuple(manifest["shape"])
  dtype = np.dtype(manifest["dtype"])
  out = np.empty(shape, dtype=dtype)
  for i, sh in enumerate(manifest["shards"]):
    ext = TileExtent(sh["ul"], sh["lr"], shape)
    out[ext.to_slice()] = np.load(os.path.join(path, f"shard_{i:05d}.npy"))
  mesh = mesh or get_mesh()
  from jax.sharding import PartitionSpec
  entries = tuple(tuple(e) if isinstance(e, list) else e
                  for e in manifest["spec"])
  # only restore the saved spec when the mesh still matches
  if {k: int(s) for k, s in mesh.shape.items()} == manifest["mesh_shape"]:
    tiling = Tiling(mesh, PartitionSpec(*entries))
  else:
    from spartan_tpu.core.tiling import auto_tiling
    tiling = auto_tiling(shape, None, mesh)
  return _from_numpy(out, tiling=tiling)


def from_file(path: str, tile_hint=None) -> Expr:
  """Lazy-load a .npy file / saved checkpoint dir as a leaf."""
  if os.path.isdir(path):
    return Val(load(path))
  return Val(_from_numpy(np.load(path), tile_hint))
