"""2-D stencil / convolution / pooling with cross-tile halos.

Rebuild of the reference's stencil module (reference:
``spartan/expr/stencil.py`` — 2-D stencil/convolution/maxpool whose
per-tile kernels fetch halo borders from neighbor tiles, used by the CNN
example; SURVEY.md §2.1, §2.3).  Two execution paths:

* the default traced path: ``lax.conv_general_dilated`` /
  ``lax.reduce_window`` — when the spatial dims are sharded, XLA's SPMD
  partitioner inserts the halo exchanges on the interconnect automatically;
* an explicit ``shard_map`` + ``lax.ppermute`` ring halo exchange
  (``spartan_tpu.parallel.halo``) — the CP/ring-attention primitive applied
  to stencils, for when you want the comm schedule in your own hands.

Data layout is NCHW (batch, channel, height, width), filters OIHW.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from spartan_tpu.expr.base import EmitCtx, Expr, lazify


def _pair(v) -> Tuple[int, int]:
  if isinstance(v, (tuple, list)):
    return (int(v[0]), int(v[1]))
  return (int(v), int(v))


class StencilExpr(Expr):
  """2-D convolution (cross-correlation) of NCHW images with OIHW filters."""

  _members = ("inputs",)
  _params = ("stride", "padding")

  def __init__(self, images, filters, stride=1, padding="SAME"):
    super().__init__(inputs=[lazify(images), lazify(filters)],
                     stride=_pair(stride), padding=padding)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x, w = deps
    acc = jnp.promote_types(x.dtype, w.dtype)
    # Single-channel stride-1 stencils (the classic Laplacian/blur case):
    # a general conv lowering is a poor fit for O=I=1: the shifted-add
    # formulation is one elementwise pass, fuses with neighbors,
    # differentiates through both operands, and SPMD-partitions (static
    # slices of a sharded array get halo exchanges automatically).
    if (self.stride == (1, 1) and w.ndim == 4
        and w.shape[0] == 1 and w.shape[1] == 1
        and w.shape[2] * w.shape[3] <= 49
        and self.padding in ("SAME", "VALID")):
      return self._emit_shifted(x, w, acc)
    return jax.lax.conv_general_dilated(
        x, w.astype(acc),
        window_strides=self.stride,
        padding=self.padding,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=acc if acc != jnp.float64 else None,
    ).astype(acc)

  def _emit_shifted(self, x, w, acc):
    kh, kw = int(w.shape[2]), int(w.shape[3])
    n, c, h, ww = x.shape
    if self.padding == "SAME":
      # XLA SAME at stride 1: pad_total = k-1, low half first
      ph0, pw0 = (kh - 1) // 2, (kw - 1) // 2
      xp = jnp.pad(x.astype(acc), ((0, 0), (0, 0),
                                   (ph0, kh - 1 - ph0),
                                   (pw0, kw - 1 - pw0)))
      oh, ow = h, ww
    else:  # VALID
      xp = x.astype(acc)
      oh, ow = h - kh + 1, ww - kw + 1
    # lax.conv_general_dilated is cross-correlation (no filter flip):
    # out[i,j] = sum_{di,dj} w[di, dj] * xp[i+di, j+dj]
    out = jnp.zeros((n, c, oh, ow), acc)
    for di in range(kh):
      for dj in range(kw):
        tap = w[0, 0, di, dj].astype(acc)
        out = out + tap * jax.lax.slice(
            xp, (0, 0, di, dj), (n, c, di + oh, dj + ow))
    return out


class PoolExpr(Expr):
  """Max/avg pooling over NCHW spatial dims."""

  _members = ("inputs",)
  _params = ("op", "pool", "stride", "padding")

  def __init__(self, images, pool_size=2, stride=None, op="max",
               padding="SAME"):
    pool = _pair(pool_size)
    stride = _pair(stride) if stride is not None else pool
    super().__init__(inputs=[lazify(images)], op=op, pool=pool,
                     stride=stride, padding=padding)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x = deps[0]
    window = (1, 1) + self.pool
    strides = (1, 1) + self.stride
    # non-overlapping, evenly-dividing pools: reshape-fold formulation —
    # identical result, and (unlike reduce_window) reverse-mode
    # differentiable under jit in current jax
    if (self.stride == self.pool and x.ndim == 4
        and x.shape[2] % self.pool[0] == 0
        and x.shape[3] % self.pool[1] == 0):
      n, c, h, w = x.shape
      ph, pw = self.pool
      folded = x.reshape(n, c, h // ph, ph, w // pw, pw)
      if self.op == "max":
        return folded.max(axis=(3, 5))
      if self.op == "avg":
        return folded.mean(axis=(3, 5))
    if self.op == "max":
      init = -jnp.inf if x.dtype.kind == "f" else jnp.iinfo(x.dtype).min
      return jax.lax.reduce_window(x, jnp.array(init, x.dtype),
                                   jax.lax.max, window, strides,
                                   self.padding)
    if self.op == "avg":
      s = jax.lax.reduce_window(x, jnp.array(0, x.dtype), jax.lax.add,
                                window, strides, self.padding)
      ones = jnp.ones_like(x)
      n = jax.lax.reduce_window(ones, jnp.array(0, x.dtype), jax.lax.add,
                                window, strides, self.padding)
      return s / n
    raise ValueError(self.op)


def stencil(images, filters, stride=1, padding="SAME") -> StencilExpr:
  return StencilExpr(images, filters, stride, padding)


def maxpool(images, pool_size=2, stride=None, padding="SAME") -> PoolExpr:
  return PoolExpr(images, pool_size, stride, "max", padding)


def avgpool(images, pool_size=2, stride=None, padding="SAME") -> PoolExpr:
  return PoolExpr(images, pool_size, stride, "avg", padding)
