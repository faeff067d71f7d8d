"""Rematerialization boundary for fused regions.

No reference analogue (the reference materializes every tile op); on an
accelerator the memory/FLOPs trade is first-class: ``remat(expr)`` wraps the
sub-DAG's emission in ``jax.checkpoint``, so reverse-mode autodiff
(``spartan_tpu.autodiff``) recomputes the region's intermediates instead
of storing them — the standard activation-checkpointing pattern, applied
at expr-DAG granularity.
"""

from __future__ import annotations

from typing import Any, List

import jax

from spartan_tpu.expr.base import EmitCtx, Expr, Val, lazify


class RematExpr(Expr):
  """Evaluates identically to ``child``; under ``jax.grad`` its interior
  is recomputed rather than saved.  Deps are the child subtree's leaves;
  the subtree structure is baked into the node (shared nodes crossing the
  boundary are recomputed inside — that is the point of remat)."""

  _members = ("inputs",)
  _params = ("child",)
  # the sub-DAG lives in a param and binds self.inputs by identity — the
  # evaluator's leaf-stripping must leave this node untouched
  _holds_subdag = True

  def __init__(self, child):
    child = lazify(child)
    # iterative pre-order leaf collection (deep sub-DAGs exceed the
    # recursion limit at construction time)
    leaves: List[Val] = []
    seen = set()
    stack = [child]
    while stack:
      e = stack.pop()
      if e.expr_id in seen:
        continue
      seen.add(e.expr_id)
      if isinstance(e, Val):
        leaves.append(e)
        continue
      for c in reversed(e.children()):
        stack.append(c)
    super().__init__(inputs=list(leaves), child=child)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    leaf_pos = {leaf.expr_id: i for i, leaf in enumerate(self.inputs)}
    child = self.child

    def run(*leaf_vals):
      env = {}

      def emit(e: Expr):
        if e.expr_id in env:
          return env[e.expr_id]
        if isinstance(e, Val):
          v = leaf_vals[leaf_pos[e.expr_id]]
        else:
          v = e._emit(ctx, [emit(c) for c in e.children()])
        env[e.expr_id] = v
        return v

      return emit(child)

    if ctx.abstract:
      return run(*deps)
    return jax.checkpoint(run)(*deps)

  def _sig_local(self, memo, result):
    return ("RematExpr", self.child.signature(dict(memo)),
            tuple(self._child_sig(c, memo, result) for c in self.inputs))


def remat(v) -> RematExpr:
  return RematExpr(v)
