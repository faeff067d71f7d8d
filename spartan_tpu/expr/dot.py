"""Distributed matmul / outer product.

Rebuild of the reference's dot (reference: ``spartan/expr/dot.py``
— per-A-tile kernels fetch matching B blocks and accumulate partial
products into C via an add-reducer, the "dot shuffle"; SURVEY.md §2.1,
§3.3).  Here the contraction is one traced ``dot_general``: XLA's SPMD
partitioner emits the all-gather of B / reduce-scatter of C over the
interconnect that the reference hand-rolled as RPC fetches + combiner
updates.  Matrix-unit targeting comes from ``preferred_element_type`` and
the AutoTiling pass keeping both operands and the result 2-D-sharded over the mesh.
"""

from __future__ import annotations

from typing import Any, List

import jax
import jax.numpy as jnp
import numpy as np

from spartan_tpu.config import FLAGS
from spartan_tpu.expr.base import EmitCtx, Expr, lazify


def _acc_type(a_dtype, b_dtype):
  out = np.promote_types(a_dtype, b_dtype)
  if out.kind == "f":
    # f32 accumulation for f32/bf16 inputs; f64 when the
    # reference's float64 semantics are on and x64 is live.
    if FLAGS.float64_reductions:
      return jax.dtypes.canonicalize_dtype(np.promote_types(out, np.float64))
    return jax.dtypes.canonicalize_dtype(np.promote_types(out, np.float32))
  return jax.dtypes.canonicalize_dtype(out)


def _widen(x, acc):
  """Cast a dot operand up to a 64-bit accumulator dtype.  XLA's GPU
  backend has no GEMM from f32/bf16 operands to an f64 (or c128) result,
  so f64 accumulation of narrower operands widens them first (exact)."""
  acc = jnp.dtype(acc)
  if acc.kind in "fc" and acc.itemsize >= 8 and x.dtype != acc:
    return x.astype(acc)
  return x


def _resolve_precision(precision):
  """Per-call precision, else the --dot_precision flag ('default' = the
  backend's fastest: TF32 tensor cores for f32 inputs on a GPU; 'highest'
  = f32-faithful multiplies, the reference's numpy-BLAS accuracy)."""
  p = precision if precision is not None else FLAGS.dot_precision
  return None if p in (None, "default") else p


class DotExpr(Expr):
  """Matrix/vector contraction of the trailing/leading dims."""

  _members = ("inputs",)
  _params = ("precision",)

  def __init__(self, a, b, precision=None):
    super().__init__(inputs=[lazify(a), lazify(b)], precision=precision)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    a, b = deps
    acc = _acc_type(a.dtype, b.dtype)
    a, b = _widen(a, acc), _widen(b, acc)
    out = jnp.matmul(a, b, preferred_element_type=acc,
                     precision=_resolve_precision(self.precision)) if (
        a.ndim >= 1 and b.ndim >= 1) else a * b
    # numpy semantics: result dtype is the promotion of the inputs, unless
    # f64 accumulation promoted it (reference returns the accumulator type)
    return out


class OuterExpr(Expr):
  """Outer product of two 1-D arrays (reference ``expr/outer.py``)."""

  _members = ("inputs",)
  _params = ()

  def __init__(self, a, b):
    super().__init__(inputs=[lazify(a), lazify(b)])

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    a, b = deps
    return jnp.outer(a, b)


class TensorDotExpr(Expr):
  """General tensordot (axes-based contraction)."""

  _members = ("inputs",)
  _params = ("axes",)

  def __init__(self, a, b, axes):
    super().__init__(inputs=[lazify(a), lazify(b)], axes=axes)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    a, b = deps
    acc = _acc_type(a.dtype, b.dtype)
    a, b = _widen(a, acc), _widen(b, acc)
    return jnp.tensordot(a, b, axes=self.axes,
                         preferred_element_type=acc,
                         precision=_resolve_precision(None))


def dot(a, b, precision=None) -> Expr:
  """Contraction; ``precision`` overrides --dot_precision for this node
  ('default' | 'high' | 'highest' — GPU f32 matmuls may run TF32 at
  'default'; numerics-critical algorithms want 'highest').

  Sparse operands dispatch to the sparse kernels (the reference's dot
  ran scipy for sparse tiles): ``dot(S, b)`` → SpMV/SpMM expr,
  ``dot(a, S)`` → ``(Sᵀ aᵀ)ᵀ`` via the host-side sparse transpose."""
  from spartan_tpu.backend import sparse as _sp
  a_sparse = isinstance(a, (_sp.SparseArray, _sp.BlockSparseArray))
  b_sparse = isinstance(b, (_sp.SparseArray, _sp.BlockSparseArray))
  if a_sparse:
    return _sp.sparse_dot(a, b, precision=precision)
  if b_sparse:
    if isinstance(b, _sp.BlockSparseArray):
      raise TypeError("dot(dense, BlockSparseArray) is unsupported — "
                      "transpose the product or use a SparseArray")
    bt = b.transpose()
    a_l = lazify(a)
    nd = len(a_l.aval().shape)
    if nd == 1:
      return _sp.sparse_dot(bt, a_l, precision=precision)  # v@S = Sᵀv
    if nd == 2:
      return _sp.sparse_dot(bt, a_l.T, precision=precision).T
    raise ValueError(f"dot(dense {nd}-D, sparse) unsupported")
  return DotExpr(a, b, precision=precision)


def outer(a, b) -> Expr:
  return OuterExpr(a, b)


def tensordot(a, b, axes=2) -> Expr:
  return TensorDotExpr(a, b, axes)
