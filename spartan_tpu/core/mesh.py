"""Device-mesh management.

In the reference, array placement is the master's job — tile → worker maps
chosen round-robin/random/locality (reference: ``spartan/master.py``,
SURVEY.md §2.1).  In this rebuild *sharding is placement*: a global
``jax.sharding.Mesh`` over the slice, with ``NamedSharding`` PartitionSpecs
standing in for tile→worker maps, and XLA collectives over the
interconnect standing in for the RPC fetch/update protocol (SURVEY.md §2.4).

The default mesh factors the device count into a near-square 2-D mesh with
axes ``('x', 'y')`` (2-D tile grids map dims→axes directly; 1-D arrays shard
over the flattened ``('x','y')`` pair).  Axis types are ``Auto`` so classic
GSPMD sharding propagation applies inside jitted regions.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from spartan_tpu.config import FLAGS

_state = threading.local()


def _best_2d_factors(n: int) -> Tuple[int, int]:
  """Near-square factorization of ``n`` (1×n for primes)."""
  best = (1, n)
  f = 1
  while f * f <= n:
    if n % f == 0:
      best = (f, n // f)
    f += 1
  return best


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None,
              devices: Optional[List] = None) -> Mesh:
  """Build a mesh; defaults to a near-square 2-D mesh over all devices."""
  if devices is None:
    devices = jax.devices()
  n = len(devices)
  if shape is None:
    if FLAGS.mesh_shape:
      shape = tuple(int(s) for s in FLAGS.mesh_shape.lower().split("x"))
    else:
      shape = _best_2d_factors(n)
  shape = tuple(shape)
  if axis_names is None:
    axis_names = ("x", "y", "z")[: len(shape)]
  auto = (jax.sharding.AxisType.Auto,) * len(shape)
  return jax.make_mesh(shape, tuple(axis_names), devices=devices,
                       axis_types=auto)


def get_mesh() -> Mesh:
  """The active mesh: the innermost ``with_mesh`` context, else a process
  default built lazily over all devices."""
  stack = getattr(_state, "stack", None)
  if stack:
    return stack[-1]
  global _default_mesh
  if _default_mesh is None:
    _default_mesh = make_mesh()
  return _default_mesh


_default_mesh: Optional[Mesh] = None


def set_default_mesh(mesh: Optional[Mesh]) -> None:
  global _default_mesh
  _default_mesh = mesh


@contextlib.contextmanager
def with_mesh(mesh: Mesh):
  if not hasattr(_state, "stack"):
    _state.stack = []
  _state.stack.append(mesh)
  try:
    yield mesh
  finally:
    _state.stack.pop()


def replicated(mesh: Optional[Mesh] = None) -> NamedSharding:
  return NamedSharding(mesh or get_mesh(), PartitionSpec())


def num_devices(mesh: Optional[Mesh] = None) -> int:
  return (mesh or get_mesh()).devices.size
