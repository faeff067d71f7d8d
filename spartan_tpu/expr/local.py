"""Local-op IR: the fused per-region computation.

Rebuild of the reference's local-op IR (reference:
``spartan/expr/local.py`` — ``LocalExpr``/``LocalInput``/``FnCallExpr``
describing the fused per-tile kernel that map-fusion builds, with a
pretty-printer and a compile-to-python/Parakeet backend; SURVEY.md §2.1).

Here the IR compiles to a *jax-traceable callable*: the fusion passes in
``optimize.py`` compose chains of map kernels into one LocalExpr tree, and
the evaluator traces it straight into the enclosing jitted region — XLA
plays the role the reference delegated to Parakeet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from spartan_tpu.expr.base import fn_key


def _postorder(root: "LocalExpr", leaf_fn, call_fn):
  """Iterative post-order fold over a LocalExpr DAG, memoized by object
  identity (fusion splices shared producers into several consumer slots,
  and deep op chains fuse into trees thousands of levels deep — recursion
  here hits CPython's un-raisable C-frame limit)."""
  memo: Dict[int, Any] = {}
  stack = [(root, False)]
  while stack:
    node, expanded = stack.pop()
    key = id(node)
    if key in memo and not expanded:
      continue
    if isinstance(node, FnCallExpr):
      if expanded:
        memo[key] = call_fn(node, [memo[id(d)] for d in node.deps])
      else:
        stack.append((node, True))
        for d in reversed(node.deps):
          if id(d) not in memo:
            stack.append((d, False))
    else:
      memo[key] = leaf_fn(node)
  return memo[id(root)]


class LocalExpr:
  """Base class for local-computation nodes."""

  def evaluate(self, inputs: Sequence[Any]) -> Any:
    raise NotImplementedError

  def signature(self) -> Tuple:
    raise NotImplementedError

  def pretty(self, indent: int = 0) -> str:
    raise NotImplementedError

  def max_input(self) -> int:
    """Highest input slot referenced (−1 if none)."""
    raise NotImplementedError

  def __repr__(self):
    return self.pretty()


class LocalInput(LocalExpr):
  """Reads fused-region input slot ``idx``."""

  __slots__ = ("idx",)
  approx_size = 1

  def __init__(self, idx: int):
    self.idx = idx

  def evaluate(self, inputs):
    return inputs[self.idx]

  def signature(self):
    return ("in", self.idx)

  def pretty(self, indent=0):
    return " " * indent + f"%{self.idx}"

  def max_input(self):
    return self.idx


class LocalConst(LocalExpr):
  """A small captured constant (scalars baked into the kernel)."""

  __slots__ = ("value",)
  approx_size = 1

  def __init__(self, value):
    self.value = value

  def evaluate(self, inputs):
    return self.value

  def signature(self):
    return ("const", repr(self.value))

  def pretty(self, indent=0):
    return " " * indent + f"const({self.value!r})"

  def max_input(self):
    return -1


class FnCallExpr(LocalExpr):
  """Apply ``fn(*deps, **kw)``."""

  __slots__ = ("fn", "deps", "kw", "pretty_name", "_sig", "approx_size")

  def __init__(self, fn: Callable, deps: Sequence[LocalExpr],
               kw: Optional[Dict[str, Any]] = None,
               pretty_name: Optional[str] = None):
    self.fn = fn
    self.deps = list(deps)
    self.kw = dict(kw or {})
    self.pretty_name = pretty_name or getattr(fn, "__name__", "fn")
    self._sig = None  # LocalExpr trees are immutable: signature caches
    # tree-size upper bound (counts shared subtrees repeatedly — O(1) to
    # maintain, used only as a fusion-growth cap)
    self.approx_size = 1 + sum(d.approx_size for d in self.deps)

  def evaluate(self, inputs):
    return _postorder(
        self, lambda n: n.evaluate(inputs),
        lambda n, args: n.fn(*args, **n.kw))

  def signature(self):
    if self._sig is None:

      def call(n, dep_sigs):
        if n._sig is None:
          n._sig = ("call", fn_key(n.fn), tuple(dep_sigs),
                    tuple(sorted((k, repr(v)) for k, v in n.kw.items())))
        return n._sig

      self._sig = _postorder(
          self, lambda n: n.signature(),
          call)
    return self._sig

  def pretty(self, indent=0):
    def call(n, dep_strs):
      kw = (", " + ", ".join(f"{k}={v!r}" for k, v in n.kw.items())
            if n.kw else "")
      return f"{n.pretty_name}({', '.join(dep_strs)}{kw})"
    return " " * indent + _postorder(
        self, lambda n: n.pretty(), call)

  def max_input(self):
    return _postorder(
        self, lambda n: n.max_input(),
        lambda n, deps: max(deps, default=-1))


def substitute_inputs(node: LocalExpr,
                      mapping: Dict[int, LocalExpr]) -> LocalExpr:
  """Replace ``LocalInput(i)`` with ``mapping[i]`` (for splicing a producer
  kernel into a consumer during map-map fusion).  Identity-memoized, so
  subtree sharing is preserved in the rebuilt DAG."""
  return _postorder(
      node,
      lambda n: mapping.get(n.idx, n) if isinstance(n, LocalInput) else n,
      lambda n, deps: FnCallExpr(n.fn, deps, n.kw, n.pretty_name))


def shift_inputs(node: LocalExpr, offset_map: Dict[int, int]) -> LocalExpr:
  """Renumber input slots (identity-memoized, sharing-preserving)."""
  return _postorder(
      node,
      lambda n: (LocalInput(offset_map[n.idx])
                 if isinstance(n, LocalInput) else n),
      lambda n, deps: FnCallExpr(n.fn, deps, n.kw, n.pretty_name))


def compile_local(node: LocalExpr) -> Callable:
  """Compile a LocalExpr tree to a callable over region inputs."""
  def run(*inputs):
    return node.evaluate(inputs)
  return run
