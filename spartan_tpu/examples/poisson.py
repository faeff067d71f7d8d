"""Spectral Poisson solver: ``∇²u = f`` on a periodic grid via FFT.

No reference equivalent (spartan had no FFT; SURVEY.md §2.1 builtins
row) — this demo exercises the `sp.fft` surface end-to-end: forward
transform, symbol multiply, inverse transform, all lazy and fused into
one compiled region; the residual check runs through the shifted-add
stencil emission (`examples/heat.py`'s Laplacian).
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp


def _inv_laplacian_symbol(n: int, h: float) -> np.ndarray:
  """Inverse eigenvalues of the 5-point Laplacian on an n×n periodic
  grid (zero mode pinned to 0 → mean-free solution)."""
  k = 2.0 * np.pi * np.fft.fftfreq(n)
  lam = (2.0 * np.cos(k[:, None]) + 2.0 * np.cos(k[None, :]) - 4.0) / h**2
  with np.errstate(divide="ignore"):
    inv = np.where(lam == 0.0, 0.0, 1.0 / np.where(lam == 0.0, 1.0, lam))
  # the symbol is REAL (eigenvalues of a symmetric stencil); keeping it
  # real also avoids complex host→device transfers (see core.from_numpy)
  return inv


def solve(f, h: float = 1.0):
  """Solve ``∇²u = f`` (periodic, mean-free): u = F⁻¹[ F[f] / λ(k) ]."""
  f = sp.lazify(f)
  n = f.shape[0]
  sym = sp.from_numpy(_inv_laplacian_symbol(n, h))
  return sp.real(sp.fft.ifft2(sp.fft.fft2(f) * sym))


def laplacian(u, h: float = 1.0):
  """Periodic 5-point Laplacian via the stencil surface (shifted-add
  emission); periodicity from explicit rolls."""
  u = sp.lazify(u)
  return (sp.roll(u, 1, axis=0) + sp.roll(u, -1, axis=0)
          + sp.roll(u, 1, axis=1) + sp.roll(u, -1, axis=1)
          - 4.0 * u) / h**2


def solve_jacobi(f, iters: int = 200, h: float = 1.0, unroll: int = 8):
  """Solve ``∇²u = f`` with ZERO (Dirichlet) boundary by weighted-Jacobi
  iteration (r4): each sweep ``u' = (u_N+u_S+u_E+u_W)/4 - h²f/4`` is one
  fused pass with the constant field added in
  (:func:`spartan_tpu.examples.heat.stencil_sweeps`), all sweeps in one
  compiled on-device loop, in f32.  Complements :func:`solve` (spectral,
  periodic).  Returns numpy."""
  import jax.numpy as jnp

  from spartan_tpu.examples.heat import stencil_sweeps

  fj = jnp.asarray(np.asarray(f), dtype=jnp.float32)
  coeffs = (0.0, 0.25, 0.0, 0.25, 0.0, 0.25, 0.0, 0.25, 0.0)
  g = -(h * h / 4.0) * fj
  return np.asarray(stencil_sweeps(jnp.zeros_like(fj), g, coeffs,
                                   int(iters), unroll))


def solve_jacobi_numpy(f, iters: int = 200, h: float = 1.0):
  f = np.asarray(f, np.float64)
  u = np.zeros_like(f)
  for _ in range(iters):
    up = np.pad(u, 1)
    u = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
         ) / 4.0 - (h * h / 4.0) * f
  return u


def run(n: int = 256, seed: int = 0):
  rng = np.random.default_rng(seed)
  f = rng.standard_normal((n, n))
  f -= f.mean()                       # periodic solvability condition
  u = solve(sp.from_numpy(f))
  # residual of the PDE the symbol discretizes, through the lazy DAG
  res = sp.max(sp.abs(laplacian(u) - sp.from_numpy(f)))
  return float(res.glom()), float(sp.std(u).glom())
