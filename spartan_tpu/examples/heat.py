"""2-D heat-equation (Jacobi diffusion) via the stencil surface.

Reference parity: the reference's stencil module existed exactly for
this class of workload — per-tile kernels with cross-tile halo fetches
(``spartan/expr/stencil.py``, SURVEY.md §2.1/§2.3 CP row).  Here
the 5-point Laplacian is a single-channel `sp.stencil`, which the r3
emission lowers to shifted-add slices (see `expr/stencil.py`); the whole
time loop
runs on device in ONE compiled program via `sp.make_fori`, and on a
mesh the sharded-H slices get their halo exchanges from the SPMD
partitioner automatically.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

import spartan_tpu as sp


def step(u, alpha: float = 0.1):
  """One explicit Euler step of u_t = alpha * laplace(u), zero-boundary."""
  lap = np.array([[0.0, 1.0, 0.0],
                  [1.0, -4.0, 1.0],
                  [0.0, 1.0, 0.0]])
  u4 = sp.lazify(u).reshape((1, 1) + tuple(sp.lazify(u).shape))
  out = u4 + alpha * sp.stencil(u4, sp.Val(lap.reshape(1, 1, 3, 3)))
  return out.reshape(tuple(sp.lazify(u).shape))


def simulate(u0, iters: int = 100, alpha: float = 0.1):
  """Run `iters` diffusion steps in one compiled on-device loop."""
  run = sp.make_fori(lambda u: step(u, alpha), sp.lazify(u0))
  return run(iters)


@functools.partial(jax.jit, static_argnames=("coeffs", "steps", "unroll"))
def stencil_sweeps(u, add, coeffs, steps: int, unroll: int = 8):
  """``steps`` applications of ``u <- Σ_k coeffs[k]·shift_k(u) + add``
  over a zero boundary ring (``coeffs``: the 3x3 weights, row-major;
  ``add``: a constant field, or None).  One ``fori_loop`` on device; XLA
  fuses the pad and the shifted adds of a step into one pass, so each
  step reads and writes the field once."""
  n, m = u.shape

  def body(_, v):
    vp = jnp.pad(v, 1)
    out = jnp.zeros_like(v) if add is None else add
    for di in range(3):
      for dj in range(3):
        c = coeffs[di * 3 + dj]
        if c:
          out = out + c * vp[di:di + n, dj:dj + m]
    return out

  return lax.fori_loop(0, steps, body, u, unroll=max(1, unroll))


def simulate_padded(u0, iters: int = 100, alpha: float = 0.1,
                    unroll: int = 8):
  """Diffusion steps as one compiled on-device loop (VERDICT r3 next #3).

  The whole explicit-Euler step ``u + alpha*lap(u)`` is ONE 3x3 stencil
  with coefficients ``[[0,a,0],[a,1-4a,a],[0,a,0]]`` over the zero-padded
  field (:func:`stencil_sweeps`), ``unroll`` steps per loop trip, in f32.
  Returns the final field as a numpy array."""
  a = float(alpha)
  coeffs = (0.0, a, 0.0, a, 1.0 - 4.0 * a, a, 0.0, a, 0.0)
  u = jnp.asarray(np.asarray(u0), dtype=jnp.float32)
  return np.asarray(stencil_sweeps(u, None, coeffs, int(iters), unroll))


def simulate_numpy(u0, iters: int = 100, alpha: float = 0.1):
  u = np.asarray(u0, dtype=np.float64).copy()
  for _ in range(iters):
    up = np.pad(u, 1)
    lap = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
           - 4.0 * u)
    u = u + alpha * lap
  return u


def run(n: int = 256, iters: int = 200, seed: int = 0):
  rng = np.random.default_rng(seed)
  u0 = np.zeros((n, n))
  # a few hot spots diffusing outwards
  for _ in range(8):
    i, j = rng.integers(8, n - 8, 2)
    u0[i, j] = 100.0
  got = np.asarray(simulate(u0, iters).glom())
  want = simulate_numpy(u0, iters)
  err = float(np.abs(got - want).max())
  return err, float(got.sum())
