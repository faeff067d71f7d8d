"""Stencil / conv / pooling with cross-tile halos (reference:
expr/stencil.py used by the CNN example; SURVEY.md §2.1, §2.3)."""

import numpy as np
import pytest

import spartan_tpu as sp
from spartan_tpu.util import Assert


def _conv2d_ref(x, w, stride=1):
  """NCHW/OIHW SAME cross-correlation oracle in pure numpy (XLA SAME
  semantics: total pad = max((out-1)*stride + k - in, 0), low = pad // 2)."""
  n, c, h, wd = x.shape
  o, i, kh, kw = w.shape
  oh = -(-h // stride)
  ow = -(-wd // stride)
  pad_h = max((oh - 1) * stride + kh - h, 0)
  pad_w = max((ow - 1) * stride + kw - wd, 0)
  ph, pw = pad_h // 2, pad_w // 2
  xp = np.zeros((n, c, h + pad_h, wd + pad_w))
  xp[:, :, ph:ph + h, pw:pw + wd] = x
  out = np.zeros((n, o, oh, ow))
  for b in range(n):
    for f in range(o):
      for y in range(oh):
        for z in range(ow):
          patch = xp[b, :, y * stride:y * stride + kh,
                     z * stride:z * stride + kw]
          out[b, f, y, z] = (patch * w[f]).sum()
  return out


def test_conv_same(rng):
  x = rng.standard_normal((2, 3, 8, 8))
  w = rng.standard_normal((4, 3, 3, 3))
  got = sp.stencil(sp.from_numpy(x), sp.from_numpy(w)).glom()
  want = _conv2d_ref(x, w)
  np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_conv_stride2(rng):
  x = rng.standard_normal((1, 2, 8, 8))
  w = rng.standard_normal((3, 2, 3, 3))
  got = sp.stencil(sp.from_numpy(x), sp.from_numpy(w), stride=2).glom()
  want = _conv2d_ref(x, w, stride=2)
  np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_maxpool(rng):
  x = rng.standard_normal((2, 3, 8, 8))
  got = sp.maxpool(sp.from_numpy(x), 2).glom()
  want = x.reshape(2, 3, 4, 2, 4, 2).max(axis=(3, 5))
  np.testing.assert_array_equal(got, want)


def test_avgpool(rng):
  x = rng.standard_normal((1, 2, 4, 4))
  got = sp.avgpool(sp.from_numpy(x), 2).glom()
  want = x.reshape(1, 2, 2, 2, 2, 2).mean(axis=(3, 5))
  np.testing.assert_allclose(got, want, rtol=1e-12)


def test_stencil_feeds_lazy_chain(rng):
  x = rng.standard_normal((1, 1, 8, 8))
  w = rng.standard_normal((1, 1, 3, 3))
  expr = sp.maxpool(sp.stencil(sp.from_numpy(x), sp.from_numpy(w)), 2).sum()
  assert np.isfinite(expr.glom())


def test_single_channel_shifted_emit(rng):
  """O=I=1 stride-1 stencils take the shifted-add emission (one
  elementwise pass instead of a general conv); must agree with the conv
  oracle for every kernel shape / padding."""
  import jax
  import jax.numpy as jnp
  for kh, kw in [(3, 3), (2, 2), (5, 3), (1, 1), (4, 5), (7, 7)]:
    for pad in ("SAME", "VALID"):
      x = rng.standard_normal((2, 1, 12, 16))
      w = rng.standard_normal((1, 1, kh, kw))
      got = sp.stencil(sp.from_numpy(x), sp.from_numpy(w),
                       padding=pad).glom()
      want = jax.lax.conv_general_dilated(
          jnp.asarray(x), jnp.asarray(w), (1, 1), pad,
          dimension_numbers=("NCHW", "OIHW", "NCHW"))
      np.testing.assert_allclose(got, np.asarray(want),
                                 rtol=1e-12, atol=1e-12)


def test_single_channel_shifted_grad(rng):
  """grad flows through the shifted-add stencil emission for both x and
  the filter taps, matching the conv formulation."""
  import jax
  import jax.numpy as jnp
  from spartan_tpu import autodiff
  xe = rng.standard_normal((1, 1, 8, 8))
  we = rng.standard_normal((1, 1, 3, 3))
  X, W = sp.from_numpy(xe), sp.from_numpy(we)
  loss = sp.sum(sp.stencil(X, W) ** 2)
  gx, gw = [np.asarray(g.data) for g in autodiff.grad(loss, [X, W])]

  def jf(X, W):
    return jnp.sum(jax.lax.conv_general_dilated(
        X, W, (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW")) ** 2)

  jgx, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(xe), jnp.asarray(we))
  np.testing.assert_allclose(gx, np.asarray(jgx), rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(gw, np.asarray(jgw), rtol=1e-10, atol=1e-10)


def test_heat_simulate_padded_matches_numpy():
  """heat.simulate_padded (one on-device loop of fused shifted-add
  steps) ≡ the f64 numpy reference to f32 tolerance."""
  from spartan_tpu.examples import heat
  rng = np.random.default_rng(0)
  u0 = np.zeros((64, 256), np.float32)
  for _ in range(6):
    i, j = rng.integers(8, 56), rng.integers(8, 248)
    u0[i, j] = 100.0
  got = heat.simulate_padded(u0, iters=25, alpha=0.1, unroll=7)
  want = heat.simulate_numpy(u0, iters=25, alpha=0.1)
  np.testing.assert_allclose(got, want, atol=2e-3)


def test_poisson_jacobi_padded_matches_numpy():
  """r4: weighted-Jacobi Poisson sweeps (constant field fused into each
  step) ≡ the f64 numpy iterate to f32 tolerance, and the iterate
  actually reduces the Dirichlet residual."""
  from spartan_tpu.examples import poisson
  rng = np.random.default_rng(3)
  n, m = 64, 256
  f = rng.standard_normal((n, m)).astype(np.float32)
  got = poisson.solve_jacobi(f, iters=30, unroll=7)
  want = poisson.solve_jacobi_numpy(f, iters=30)
  np.testing.assert_allclose(got, want, atol=2e-4)
  # residual ∥∇²u - f∥ shrinks vs the zero initial guess
  up = np.pad(want, 1)
  lap = up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:] - 4 * want
  assert np.linalg.norm(lap - f) < 0.9 * np.linalg.norm(f)


