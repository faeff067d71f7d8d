"""Lazy expression DAG.

Rebuild of the reference's expr frontend (reference:
``spartan/expr/base.py`` — ``Expr`` base with unique ``expr_id``, deferred
shape inference, eval cache, operator overloads, ``Val``/``AsArray``/
container wrappers, ``lazify``/``evaluate``; SURVEY.md §2.1, §3.2).

Differences by design (device-first): a node does not know how to execute
itself per-tile; it knows how to *emit* jax ops into a traced region
(:meth:`Expr._emit`).  The evaluator partitions the DAG at materialization
points, compiles each region once with ``jax.jit`` (cached by structural
signature), and runs it SPMD over the mesh — the jitted region plays the
role of the reference's fused ``LocalExpr`` kernels dispatched over tiles.

Shape/dtype inference is uniform: ``jax.eval_shape`` over the node's own
emitter (the emitter is the single source of truth).  Nodes whose output
shape depends on data (boolean masks) raise :class:`NotShapeable` and force
eager materialization, mirroring the reference's ``NotShapeable``.
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spartan_tpu.config import FLAGS
from spartan_tpu.core.array import SpartanArray
from spartan_tpu.core.tiling import Tiling

_counter = itertools.count()


class NotShapeable(Exception):
  """Raised when a node's shape cannot be known before evaluation."""


_fn_key_cache: Dict[int, Tuple[Any, Tuple]] = {}


def fn_key(fn: Any) -> Tuple:
  """Stable-ish structural identity for a kernel function, so that
  semantically-identical lambdas recreated across loop iterations still hit
  the compiled-region cache.  Memoized per function object (the repr walk
  over code/consts/closure is hot on the evaluator fast lane); the entry
  pins the function so the id stays valid."""
  if fn is None:
    return ("none",)
  hit = _fn_key_cache.get(id(fn))
  if hit is not None and hit[0] is fn:
    return hit[1]
  if isinstance(fn, functools.partial):
    key = ("partial", fn_key(fn.func), _safe_repr(fn.args),
           _safe_repr(tuple(sorted(fn.keywords.items()))))
  elif isinstance(fn, np.ufunc):
    key = ("ufunc", fn.__name__)
  else:
    code = getattr(fn, "__code__", None)
    if code is not None:
      # co_names is essential: attribute/global references are indices
      # into it, so e.g. ``v.astype(jnp.float32)`` and ``...int32`` have
      # IDENTICAL co_code. Defaults live outside co_consts.
      defaults = (_safe_repr(getattr(fn, "__defaults__", None)),
                  _safe_repr(getattr(fn, "__kwdefaults__", None)))
      closure = getattr(fn, "__closure__", None) or ()
      # closures over exprs/arrays may mutate — only cache closure-free fns
      if closure:
        cells = tuple(_safe_repr(c.cell_contents) for c in closure)
        return ("fn", fn.__qualname__, code.co_code, code.co_names,
                _safe_repr(code.co_consts), defaults, cells)
      key = ("fn", fn.__qualname__, code.co_code, code.co_names,
             _safe_repr(code.co_consts), defaults, ())
    else:
      key = ("obj", getattr(fn, "__module__", ""), getattr(fn, "__name__",
                                                           repr(fn)))
  if len(_fn_key_cache) > 4096:
    _fn_key_cache.clear()
  _fn_key_cache[id(fn)] = (fn, key)
  return key


# id()-keyed cache entries are only sound while the keyed object stays
# alive — otherwise a freed closure array's address can be recycled by a
# different same-shape array, and a structurally identical kernel would
# alias the stale compiled region (the r1 fn_key bug class, for data
# instead of bytecode; VERDICT r2 weak #5).  Pin every id-keyed object;
# bound the pinned bytes, and when the bound trips, flush BOTH the pins
# and every cache that may embed id-keys (recompiles are cheap, wrong
# answers are not).
_id_pins: Dict[int, Any] = {}
_id_pin_bytes = [0]
_ID_PIN_BYTE_LIMIT = 256 << 20


def _pin_id(obj: Any) -> int:
  oid = id(obj)
  if oid not in _id_pins:
    nbytes = int(getattr(obj, "nbytes", 256) or 256)
    if (_id_pin_bytes[0] + nbytes > _ID_PIN_BYTE_LIMIT
        or len(_id_pins) > 4096):
      _id_pins.clear()
      _id_pin_bytes[0] = 0
      _aval_cache.clear()
      # fn_key/plan caches can embed _safe_repr id-strings (via
      # __defaults__/co_consts arrays) — flush them too, or a recycled id
      # could alias two different kernels (ADVICE r3)
      _fn_key_cache.clear()
      try:
        from spartan_tpu.expr.optimize import SmartTiling as _ST
        _ST._plan_cache.clear()
      except Exception:
        pass
      try:
        from spartan_tpu.backend import evaluator as _ev
        _ev.clear_cache()
      except Exception:
        pass
    _id_pins[oid] = obj
    _id_pin_bytes[0] += nbytes
  return oid


def _safe_repr(obj: Any) -> str:
  """Bounded repr for cache keys; large arrays key by pinned identity."""
  if isinstance(obj, (np.ndarray, jax.Array)):
    if obj.size <= 16:
      return f"arr{obj.shape}{obj.dtype}{np.asarray(obj).tolist()}"
    return f"arr{obj.shape}{obj.dtype}@{_pin_id(obj)}"
  if isinstance(obj, SpartanArray):
    return f"sp{obj.shape}{obj.dtype}@{_pin_id(obj)}"
  if isinstance(obj, Expr):
    return f"expr@{obj.expr_id}"
  if isinstance(obj, tuple):
    return "(" + ",".join(_safe_repr(x) for x in obj) + ")"
  if callable(obj):
    return str(fn_key(obj))
  r = repr(obj)
  return r if len(r) <= 256 else r[:256] + f"...@{_pin_id(obj)}"


_aval_cache: Dict[Tuple, Any] = {}


def semantic_flags_fingerprint() -> Tuple:
  """Flags that change emitted computations — part of every cache key."""
  return (FLAGS.float64_reductions, FLAGS.opt_affine_reduce,
          FLAGS.sort_method, FLAGS.sort_sample_threshold,
          FLAGS.dot_precision,
          FLAGS.sparse_dense_route, FLAGS.sparse_force_dense,
          FLAGS.fft_pencil, FLAGS.fft_pencil_min_elems)


class Expr:
  """Base lazy node.

  Subclasses define:
    * ``_members``: names of child-expression slots (DAG edges),
    * ``_params``:  names of non-expr attributes (part of the cache key),
    * ``_emit(ctx, deps)``: build jax ops from dep values.
  """

  _members: Tuple[str, ...] = ()
  _params: Tuple[str, ...] = ()

  def __init__(self, **kw):
    self.expr_id = next(_counter)
    self._cache: Optional[SpartanArray] = None
    self._aval = None
    self.tiling_hint: Optional[Tiling] = None  # set by the AutoTiling pass
    for name in self._members:
      setattr(self, name, kw.pop(name))
    for name in self._params:
      setattr(self, name, kw.pop(name))
    if kw:
      raise TypeError(f"unexpected args for {type(self).__name__}: {kw}")
    if FLAGS.eager and not getattr(self, "_eager_skip", False):
      self.force()

  # -- DAG structure --------------------------------------------------------

  def children(self) -> List["Expr"]:
    out: List[Expr] = []
    for name in self._members:
      v = getattr(self, name)
      if isinstance(v, Expr):
        out.append(v)
      elif isinstance(v, (list, tuple)):
        out.extend(c for c in v if isinstance(c, Expr))
    return out

  def replace(self, **kw) -> "Expr":
    """Copy with some members/params replaced (used by optimizer passes).

    Bypasses ``__init__`` (subclasses have bespoke constructor signatures);
    attributes are copied field-by-field with a fresh ``expr_id``.
    """
    new = type(self).__new__(type(self))
    new.expr_id = next(_counter)
    new._cache = None
    # optimizer rewrites preserve shape/dtype semantics — keep the aval to
    # avoid re-running jax.eval_shape on every rebuilt node
    new._aval = self._aval
    new.tiling_hint = None
    for name in self._members + self._params:
      setattr(new, name, kw.pop(name, getattr(self, name)))
    if kw:
      raise TypeError(f"unknown fields for {type(self).__name__}: {kw}")
    return new

  def visit(self, fn: Callable[["Expr"], None],
            memo: Optional[set] = None) -> None:
    """Post-order DAG visit — iterative (deep op chains exceed CPython's
    recursion limit)."""
    memo = memo if memo is not None else set()
    stack = [(self, False)]
    while stack:
      node, expanded = stack.pop()
      if expanded:
        fn(node)
        continue
      if node.expr_id in memo:
        continue
      memo.add(node.expr_id)
      stack.append((node, True))
      for c in reversed(node.children()):
        if c.expr_id not in memo:
          stack.append((c, False))

  def signature(self, memo: Dict[int, Tuple]) -> Tuple:
    """Structural cache key (shape/dtype of leaves, ops/params of interior
    nodes) — the jit-region cache is keyed on this.

    Iterative post-order driver: deep op chains otherwise hit CPython's
    *C* recursion limit (un-raisable) through nested ``tuple(genexpr)``
    frames.  Per-node content comes from :meth:`_sig_local`, which runs
    after all children's signatures are in ``memo``.
    """
    hit = memo.get(self.expr_id)
    if hit is not None:
      return hit
    result: Dict[int, Tuple] = {}
    stack = [(self, False)]
    while stack:
      node, expanded = stack.pop()
      if node.expr_id in memo:
        continue
      if expanded:
        sig = node._sig_local(memo, result)
        result[node.expr_id] = sig
        # sharing-aware: later references collapse to a compact ordinal —
        # diamond-shared DAGs otherwise produce exponentially large
        # signature tuples (first occurrence stays fully expanded)
        node._sig_store(memo, sig)
        continue
      stack.append((node, True))
      for c in reversed(node.children()):
        if c.expr_id not in memo:
          stack.append((c, False))
    return result[self.expr_id]

  def _child_sig(self, c: "Expr", memo, result):
    """Signature of a child during the iterative walk: the FIRST
    reference consumes the full signature (pop), every later reference
    gets the compact memo marker — without the pop, diamond-shared DAGs
    embed the full child sig at every use site (exponential)."""
    r = result.pop(c.expr_id, None)
    return r if r is not None else memo[c.expr_id]

  def _sig_store(self, memo, sig) -> None:
    ordinal = memo.get("__node_counter__", 0)
    memo["__node_counter__"] = ordinal + 1
    memo[self.expr_id] = ("ref", ordinal)

  def _sig_local(self, memo, result) -> Tuple:
    """This node's signature, children's sigs already available."""
    parts: List[Any] = [type(self).__name__]
    for name in self._params:
      parts.append((name, _safe_repr(getattr(self, name))))
    for name in self._members:
      v = getattr(self, name)
      if isinstance(v, Expr):
        parts.append(self._child_sig(v, memo, result))
      elif isinstance(v, (list, tuple)):
        parts.append(tuple(self._child_sig(c, memo, result)
                           if isinstance(c, Expr) else _safe_repr(c)
                           for c in v))
      else:
        parts.append(_safe_repr(v))
    return tuple(parts)

  # -- shape/dtype inference ------------------------------------------------

  def _emit(self, ctx: "EmitCtx", deps: List[Any]):
    raise NotImplementedError(type(self).__name__)

  def aval(self) -> jax.ShapeDtypeStruct:
    """Abstract value via ``jax.eval_shape`` over the node's emitter.

    Cached per node AND globally by structural signature, so iterative
    workloads that rebuild the same DAG shapes every step skip the
    (millisecond-scale) abstract trace entirely.
    """
    if self._aval is None:
      # fill descendant avals bottom-up first (iteratively): per-node
      # inference then recurses at most one level into already-cached
      # children — deep op chains otherwise blow the Python stack at
      # construction time, before any evaluate() call sizes the limit
      order: List[Expr] = []
      self.visit(lambda n: order.append(n))
      for n in order[:-1]:
        if n._aval is None:
          n.aval()
      dep_avals = [c.aval() for c in self.children()]
      # the abstract value is a pure function of (node type, params,
      # child avals) — a LOCAL key, O(1) per node.  Keying by the full
      # subtree signature (as before) made chain construction O(n²).
      # _holds_subdag nodes (remat) bake a whole DAG into a param, so
      # they fall back to the full signature.
      if getattr(self, "_holds_subdag", False):
        key = (self.signature({}), semantic_flags_fingerprint())
      else:
        parts: List[Any] = [type(self).__name__]
        for name in self._params:
          v = getattr(self, name)
          sig_fn = getattr(v, "signature", None)
          if sig_fn is not None and not isinstance(v, Expr):
            parts.append(sig_fn())  # LocalExpr kernels: cached signature
          else:
            parts.append(_safe_repr(v))
        child_key = tuple(
            (tuple(a.shape), str(a.dtype),
             bool(getattr(a, "weak_type", False))) for a in dep_avals)
        key = (tuple(parts), child_key, semantic_flags_fingerprint())
      hit = _aval_cache.get(key)
      if hit is not None:
        self._aval = hit
        return hit
      ctx = EmitCtx(abstract=True)
      self._aval = jax.eval_shape(
          lambda *deps: self._emit(ctx, list(deps)), *dep_avals)
      if len(_aval_cache) > 4096:
        _aval_cache.clear()
      _aval_cache[key] = self._aval
    return self._aval

  @property
  def shape(self) -> Tuple[int, ...]:
    return tuple(self.aval().shape)

  @property
  def dtype(self):
    return self.aval().dtype

  @property
  def ndim(self) -> int:
    return len(self.shape)

  @property
  def size(self) -> int:
    return int(np.prod(self.shape)) if self.shape else 1

  # -- evaluation -----------------------------------------------------------

  def evaluate(self) -> SpartanArray:
    from spartan_tpu.backend import evaluator
    return evaluator.evaluate(self)

  force = evaluate

  def optimized(self) -> "Expr":
    from spartan_tpu.expr import optimize as opt
    return opt.optimize(self)

  def glom(self) -> np.ndarray:
    return self.evaluate().glom()

  def __array__(self, dtype=None):
    out = self.glom()
    return out.astype(dtype) if dtype is not None else out

  def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
    """Keep ``np.sin(expr)`` / ``np.add(a, expr)`` LAZY: dispatch to the
    same-named builtin (numpy-parity semantics) instead of numpy's
    silent ``__array__`` materialization — which gathered the whole
    array to the host.  Uncovered ufuncs/methods materialize explicitly
    (the old behavior), never raise."""
    if method == "__call__" and not kwargs:
      from spartan_tpu.expr import builtins as B
      fn = getattr(B, ufunc.__name__, None)
      if fn is not None and callable(fn):
        # construction errors (shape mismatch etc.) propagate — numpy
        # would raise the same; swallowing them here would silently
        # gather the whole distributed array to the host first.
        return fn(*inputs)
    mat = [np.asarray(x) if isinstance(x, Expr) else x for x in inputs]
    return getattr(ufunc, method)(*mat, **kwargs)

  # -- numpy-flavoured conveniences (match reference Expr surface) ----------

  @property
  def at(self):
    """jax-style functional updates: ``e.at[idx].set/add/mul/max/min(v)``
    → a new lazy expr (sugar over ``sp.write``/scatter-assign; the
    reference's in-place writes, functional)."""
    return _AtIndexer(self)

  def astype(self, dtype) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.astype(self, dtype)

  @property
  def T(self) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.transpose(self)

  def transpose(self, *axes) -> "Expr":
    from spartan_tpu.expr import builtins as B
    if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
      axes = tuple(axes[0])
    return B.transpose(self, axes or None)

  def reshape(self, *shape) -> "Expr":
    from spartan_tpu.expr import builtins as B
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
      shape = tuple(shape[0])
    return B.reshape(self, shape)

  def ravel(self) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.ravel(self)

  def sum(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.sum(self, axis=axis, keepdims=keepdims)

  def prod(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.prod(self, axis=axis, keepdims=keepdims)

  def mean(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.mean(self, axis=axis, keepdims=keepdims)

  def std(self, axis=None, ddof=0) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.std(self, axis=axis, ddof=ddof)

  def max(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.max(self, axis=axis, keepdims=keepdims)

  def min(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.min(self, axis=axis, keepdims=keepdims)

  def argmax(self, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.argmax(self, axis=axis)

  def argmin(self, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.argmin(self, axis=axis)

  def all(self, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.all(self, axis=axis)

  def any(self, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.any(self, axis=axis)

  def dot(self, other) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.dot(self, other)

  def outer(self, other) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.outer(self, other)

  # -- ndarray-method parity (delegations; np users call methods) -----------

  def var(self, axis=None, ddof=0) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.var(self, axis=axis, ddof=ddof)

  def cumsum(self, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.cumsum(self, axis=axis)

  def cumprod(self, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.cumprod(self, axis=axis)

  def clip(self, a_min=None, a_max=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.clip(self, a_min, a_max)

  def round(self, decimals=0) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.round(self, decimals=decimals)

  def conj(self) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.conj(self)

  conjugate = conj

  def copy(self) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.copy(self)

  def flatten(self) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.ravel(self)

  def squeeze(self, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.squeeze(self, axis=axis)

  def swapaxes(self, a, b) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.swapaxes(self, a, b)

  def repeat(self, repeats, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.repeat(self, repeats, axis=axis)

  def take(self, indices, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.take(self, indices, axis=axis)

  def choose(self, choices) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.choose(self, choices)

  def compress(self, cond, axis=None) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.compress(cond, self, axis=axis)

  def diagonal(self, offset=0) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.diagonal(self, offset=offset)

  def trace(self, offset=0) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.trace(self, offset=offset)

  def sort(self, axis=-1) -> "Expr":
    """Sorted COPY (exprs are immutable; np.ndarray.sort is in-place —
    documented deviation, same as the reference's lazy arrays)."""
    from spartan_tpu.expr import builtins as B
    return B.sort(self, axis=axis)

  def argsort(self, axis=-1) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.argsort(self, axis=axis)

  def partition(self, kth, axis=-1) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.partition(self, kth, axis=axis)

  def argpartition(self, kth, axis=-1) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.argpartition(self, kth, axis=axis)

  def searchsorted(self, queries, side="left") -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.searchsorted(self, queries, side=side)

  def nonzero(self) -> "Expr":
    from spartan_tpu.expr import builtins as B
    return B.nonzero(self)

  def resize(self, *new_shape) -> "Expr":
    from spartan_tpu.expr import builtins as B
    if len(new_shape) == 1 and isinstance(new_shape[0], (tuple, list)):
      new_shape = tuple(new_shape[0])
    return B.resize(self, new_shape)

  def item(self):
    """Fetch the single element as a python scalar (materializes)."""
    return np.asarray(self.glom()).item()

  def tolist(self):
    """Fetch to the driver as nested python lists (materializes)."""
    return np.asarray(self.glom()).tolist()

  # -- operators ------------------------------------------------------------

  def _binop(self, other, ufunc, reverse=False):
    from spartan_tpu.expr.map import map2
    a, b = (other, self) if reverse else (self, other)
    return map2(a, b, ufunc)

  def __add__(self, o): return self._binop(o, jnp.add)
  def __radd__(self, o): return self._binop(o, jnp.add, True)
  def __sub__(self, o): return self._binop(o, jnp.subtract)
  def __rsub__(self, o): return self._binop(o, jnp.subtract, True)
  def __mul__(self, o): return self._binop(o, jnp.multiply)
  def __rmul__(self, o): return self._binop(o, jnp.multiply, True)
  def __truediv__(self, o): return self._binop(o, jnp.true_divide)
  def __rtruediv__(self, o): return self._binop(o, jnp.true_divide, True)
  def __floordiv__(self, o): return self._binop(o, jnp.floor_divide)
  def __rfloordiv__(self, o): return self._binop(o, jnp.floor_divide, True)
  def __mod__(self, o): return self._binop(o, jnp.mod)
  def __rmod__(self, o): return self._binop(o, jnp.mod, True)
  def __pow__(self, o): return self._binop(o, jnp.power)
  def __rpow__(self, o): return self._binop(o, jnp.power, True)
  def __matmul__(self, o): return self.dot(o)
  def __neg__(self):
    from spartan_tpu.expr.map import map1
    return map1(self, jnp.negative)
  def __abs__(self):
    from spartan_tpu.expr.map import map1
    return map1(self, jnp.abs)
  def __lt__(self, o): return self._binop(o, jnp.less)
  def __le__(self, o): return self._binop(o, jnp.less_equal)
  def __gt__(self, o): return self._binop(o, jnp.greater)
  def __ge__(self, o): return self._binop(o, jnp.greater_equal)
  def __eq__(self, o):  # element-wise, like numpy
    return self._binop(o, jnp.equal)
  def __ne__(self, o): return self._binop(o, jnp.not_equal)
  __hash__ = None  # type: ignore[assignment]  # like np.ndarray

  def __and__(self, o): return self._binop(o, jnp.bitwise_and)
  def __rand__(self, o): return self._binop(o, jnp.bitwise_and, True)
  def __or__(self, o): return self._binop(o, jnp.bitwise_or)
  def __ror__(self, o): return self._binop(o, jnp.bitwise_or, True)
  def __xor__(self, o): return self._binop(o, jnp.bitwise_xor)
  def __rxor__(self, o): return self._binop(o, jnp.bitwise_xor, True)
  def __invert__(self):
    from spartan_tpu.expr.map import map1
    return map1(self, jnp.bitwise_not)
  def __lshift__(self, o): return self._binop(o, jnp.left_shift)
  def __rlshift__(self, o): return self._binop(o, jnp.left_shift, True)
  def __rshift__(self, o): return self._binop(o, jnp.right_shift)
  def __rrshift__(self, o): return self._binop(o, jnp.right_shift, True)
  def __pos__(self): return self

  def __bool__(self):
    # numpy semantics: size-1 arrays are truthy-convertible (forces
    # evaluation); larger arrays are ambiguous
    if self.size != 1:
      raise ValueError(
          "The truth value of an array with more than one element is "
          "ambiguous. Use sp.any()/sp.all() (this also forces evaluation "
          "of the lazy expr).")
    return bool(np.asarray(self.glom()).reshape(()))

  def __float__(self):
    if self.size != 1:
      raise TypeError("only size-1 exprs convert to float")
    return float(np.asarray(self.glom()).reshape(()))

  def __int__(self):
    if self.size != 1:
      raise TypeError("only size-1 exprs convert to int")
    return int(np.asarray(self.glom()).reshape(()))

  def __getitem__(self, idx) -> "Expr":
    from spartan_tpu.expr.slice import make_slice
    return make_slice(self, idx)

  def __setitem__(self, idx, value):
    raise TypeError(
        "exprs are immutable; use the functional update instead:\n"
        "  new = arr.at[idx].set(value)                     # jax-style\n"
        "  new = arr.at[idx].add(value)                     # merge\n"
        "  new = spartan_tpu.write(arr, idx, value, np.add) # region form")

  def __repr__(self):
    try:
      sd = f"shape={self.shape}, dtype={self.dtype}"
    except NotShapeable:
      sd = "shape=<data-dependent>"
    return f"{type(self).__name__}[{self.expr_id}]({sd})"


# Expr intentionally unhashable via __eq__/__hash__ numpy semantics above;
# DAG bookkeeping uses expr_id.  Restore identity-hash under a wrapper:
class _ExprKey:
  __slots__ = ("e",)

  def __init__(self, e: Expr):
    self.e = e

  def __hash__(self):
    return self.e.expr_id

  def __eq__(self, other):
    return isinstance(other, _ExprKey) and other.e is self.e


def ensure_recursion_budget(expr: "Expr") -> None:
  """Size the Python recursion limit to the DAG before any recursive
  walk (optimizer passes, emission, autodiff tracing): deep op chains
  exceed the default 1000-frame limit.  The iterative walkers
  (``visit``, ``signature``, LocalExpr folds) don't need this, but the
  rewriters and emitters are recursive by design — one frame per node."""
  import sys
  n = [0]
  expr.visit(lambda _: n.__setitem__(0, n[0] + 1))
  budget = 10 * n[0] + 1000
  if sys.getrecursionlimit() < budget:
    sys.setrecursionlimit(min(budget, 1_000_000))


class EmitCtx:
  """Context threaded through region emission.

  ``differentiable=True`` asks emitters to avoid constructs without
  autodiff rules (shard_map fast paths) — the autodiff
  bridge sets it so ``sp.grad`` works through every node; evaluation
  keeps the fast formulations."""

  def __init__(self, abstract: bool = False, differentiable: bool = False):
    self.abstract = abstract
    self.differentiable = differentiable


class Val(Expr):
  """Leaf wrapping a materialized value (SpartanArray / ndarray / scalar).

  (Reference: ``Val`` / ``AsArray`` wrappers.)
  """

  _members = ()
  _params = ("value",)

  def __init__(self, value):
    super().__init__(value=value)

  def _emit(self, ctx, deps):
    # The evaluator binds leaf arguments positionally; _emit is only used
    # for aval inference on the raw value.
    v = self.value
    if isinstance(v, SpartanArray):
      return jax.ShapeDtypeStruct(v.shape, v.dtype) if ctx.abstract else v.data
    return jnp.asarray(v)

  def aval(self):
    if self._aval is None:
      v = self.value
      if isinstance(v, (SpartanArray, jax.Array, np.ndarray)):
        self._aval = jax.ShapeDtypeStruct(
            v.shape, jax.dtypes.canonicalize_dtype(v.dtype))
      elif type(v) in (bool, int, float, complex):
        # exact python scalars stay WEAK-typed (numpy semantics: f32_arr *
        # 2.0 keeps f32).  numpy scalar types (np.float64 subclasses float!)
        # are STRONG under NEP 50 and fall through to asarray below.
        self._aval = jax.ShapeDtypeStruct(
            (), jax.dtypes.canonicalize_dtype(np.result_type(v)),
            weak_type=True)
      else:
        self._aval = jax.eval_shape(lambda: jnp.asarray(v))
    return self._aval

  def leaf_value(self):
    """The value to bind as a jit argument (python scalars pass through
    raw so jax keeps their weak dtype)."""
    v = self.value
    if isinstance(v, SpartanArray):
      return v.data
    if type(v) in (bool, int, float, complex):
      return v
    return jnp.asarray(v)

  def _sig_local(self, memo, result):
    a = self.aval()
    v = self.value
    spec = None
    if isinstance(v, SpartanArray):
      spec = str(v.tiling.spec)
    # the leaf ordinal distinguishes aliasing structure: dot(r, r) (one
    # leaf bound twice) must not share a compiled runner with dot(p, q)
    # (two leaves) — the runner's positional binding differs
    ordinal = memo.get("__leaf_counter__", 0)
    memo["__leaf_counter__"] = ordinal + 1
    return ("Val", ordinal, tuple(a.shape), str(a.dtype), spec)

  def _sig_store(self, memo, sig):
    memo[self.expr_id] = sig  # leaves stay small: re-reference by full sig


class ListExpr(Expr):
  """A list of sub-expressions evaluated together (one fused region,
  multiple outputs)."""

  _members = ("vals",)
  _params = ()

  def __init__(self, vals):
    super().__init__(vals=[lazify(v) for v in vals])

  def _emit(self, ctx, deps):
    return tuple(deps)

  def aval(self):
    return tuple(v.aval() for v in self.vals)

  def __iter__(self):
    return iter(self.vals)

  def __len__(self):
    return len(self.vals)


class TupleExpr(ListExpr):
  pass


class DictExpr(Expr):
  """A dict of sub-expressions evaluated together."""

  _members = ("vals",)
  _params = ("keys",)

  def __init__(self, d: Dict[str, Any]):
    keys = tuple(d.keys())
    super().__init__(vals=[lazify(d[k]) for k in keys], keys=keys)

  def _emit(self, ctx, deps):
    return dict(zip(self.keys, deps))

  def aval(self):
    return {k: v.aval() for k, v in zip(self.keys, self.vals)}

  def __getitem__(self, k):
    return self.vals[self.keys.index(k)]


class _AtIndexer:
  """``expr.at[idx]`` → an update handle (jax ``.at`` semantics, lazy)."""

  __slots__ = ("_e",)

  def __init__(self, e: "Expr"):
    self._e = e

  def __getitem__(self, idx):
    return _AtRef(self._e, idx)


class _AtRef:
  __slots__ = ("_e", "_idx")

  def __init__(self, e: "Expr", idx):
    self._e, self._idx = e, idx

  @staticmethod
  def _is_bool_index(i) -> bool:
    if isinstance(i, (Expr, np.ndarray)):
      return np.dtype(getattr(i, "dtype", None)) == np.bool_
    if isinstance(i, list):
      # asarray-based so NESTED bool lists (2-D masks as plain lists)
      # are recognized too (code-review r4 — they used to fall through
      # to the integer scatter and die opaquely at eval)
      try:
        arr = np.asarray(i)
      except Exception:
        return False
      return arr.size > 0 and arr.dtype == np.bool_
    return False

  def _bool_mask_update(self, mask, v, reducer):
    """``E.at[mask].<op>(v)`` via ``where`` — SCALAR (size-1) values
    only.  jax rejects traced boolean advanced indices in scatters, and
    numpy's compressed assignment (``v`` of length ``mask.sum()``) is
    data-dependent-shaped, so a non-scalar ``v`` under where() broadcast
    would SILENTLY diverge from numpy (code-review r4) — reject it."""
    from spartan_tpu.expr import builtins as B
    dst = self._e
    mask = lazify(mask)
    if mask.ndim > dst.ndim:
      raise IndexError(
          f".at boolean mask has {mask.ndim} dims; array has {dst.ndim}")
    if tuple(mask.shape) != tuple(dst.shape[:mask.ndim]):
      # numpy requires the mask to match the consumed axes exactly
      raise IndexError(
          f".at boolean mask shape {tuple(mask.shape)} does not match "
          f"array leading dims {tuple(dst.shape[:mask.ndim])}")
    if mask.ndim < dst.ndim:
      # numpy semantics: the mask consumes LEADING axes
      mask = B.reshape(mask, tuple(mask.shape) + (1,) * (dst.ndim - mask.ndim))
    v = lazify(v)
    if int(np.prod(v.shape)) != 1:
      raise NotImplementedError(
          ".at[bool_mask] supports scalar values only — numpy's "
          "compressed per-cell assignment (len(v) == mask.sum()) has a "
          "data-dependent shape; use integer indices (np.nonzero(mask)) "
          "for per-cell scatters")
    dt = dst.aval().dtype
    if reducer is None or reducer == "set":
      return B.where(mask, v, dst).astype(dt)
    ops = {np.add: lambda d, s: d + s, np.multiply: lambda d, s: d * s,
           np.maximum: B.maximum, np.minimum: B.minimum}
    for k, f in ops.items():
      if reducer is k or reducer == getattr(k, "__name__", None):
        return B.where(mask, f(dst, v), dst).astype(dt)
    raise NotImplementedError(f".at[bool_mask] with reducer {reducer!r}")

  def _go(self, v, reducer):
    from spartan_tpu.expr import write as W
    idx = self._idx
    if reducer is not None:
      # numpy ufunc-at casting rule: ib[mask] += 1.5 / np.add.at(ib, i,
      # 1.5) RAISE (add output float64 cannot cast to int64 same_kind);
      # the emitted astype(dst.dtype) would silently truncate instead
      # (code-review r4).  Plain .set keeps numpy's unsafe-cast
      # assignment semantics.
      dt = self._e.aval().dtype
      vt = lazify(v).aval().dtype
      if not np.can_cast(np.result_type(dt, vt), dt, casting="same_kind"):
        name = getattr(reducer, "__name__", reducer)
        raise TypeError(
            f".at[...].{name}: cannot cast {np.result_type(dt, vt)} "
            f"result to {dt} with casting rule 'same_kind' (numpy ufunc"
            f"-at parity)")
    if isinstance(idx, (Expr, np.ndarray, list)):
      if self._is_bool_index(idx):
        # boolean-mask update: jax scatters reject traced bool indices,
        # so lower to a where() (ADVICE r3 — used to fail opaquely at eval)
        return self._bool_mask_update(idx, v, reducer)
      if isinstance(idx, (np.ndarray, list)):
        # CONCRETE index arrays are bounds-checked at construction: jax
        # scatter silently DROPS out-of-bounds updates where numpy
        # raises (code-review r4 — the multi-axis path already checked)
        ia = np.asarray(idx)
        if not self._e.ndim:
          raise IndexError(".at index on a 0-d array")
        n0 = self._e.shape[0]
        if ia.size and (int(ia.min()) < -n0 or int(ia.max()) >= n0):
          raise IndexError(
              f".at index array has entries outside [-{n0}, {n0}) for "
              f"axis 0 with size {n0}")
        idx = ia % n0 if ia.size else ia
      # integer-array scatter: indices are DATA (an input), not a param
      return W.ScatterAssignExpr(self._e, idx, v, reducer)
    if isinstance(idx, tuple) and any(
        isinstance(i, (Expr, np.ndarray, list)) for i in idx):
      # multi-dim advanced scatter (E.at[rows, cols].add(v)): linearize
      # to a flat scatter so the index arrays stay DATA inputs (a static
      # 'region' param would bake them into the compile cache key)
      if not all(isinstance(i, (Expr, np.ndarray, list, int, np.integer))
                 for i in idx):
        raise NotImplementedError(
            "mixed slice/array advanced .at indexing is not supported — "
            "use sp.write for region updates or flat indices for scatter")
      if any(self._is_bool_index(i) for i in idx):
        raise NotImplementedError(
            "boolean masks inside multi-axis .at indexing are not "
            "supported — use a single full-shape mask or integer indices")
      from spartan_tpu.expr import builtins as B
      shape = tuple(self._e.shape)
      k = len(idx)
      if k > self._e.ndim:
        raise IndexError(
            f".at received {k} indices for a {self._e.ndim}-d array")
      # partial advanced indexing (k < ndim) scatters whole trailing
      # slices: linearize the k LEADING axes only and scatter rows of the
      # (prod(leading), *trailing) view (ADVICE r3 — used to silently
      # write single elements)
      lead, trail = shape[:k], shape[k:]
      strides = np.cumprod((1,) + lead[:0:-1])[::-1]
      flat = None
      for d, i in enumerate(idx):
        # normalize negative indices per-axis BEFORE linearizing (numpy
        # semantics; ADVICE r3 — raw idx*stride sums mapped (1,-1)→(0,3)).
        # CONCRETE indices are bounds-checked first: bare % would make a
        # user's out-of-bounds index silently wrap onto a different
        # element (code-review r4) where numpy raises.  Lazy Expr
        # indices can't be checked at construction; they wrap like mod.
        if isinstance(i, (int, np.integer)):
          if not -lead[d] <= int(i) < lead[d]:
            raise IndexError(
                f".at index {int(i)} is out of bounds for axis {d} with "
                f"size {lead[d]}")
          norm = lazify(int(i) % lead[d])
        elif isinstance(i, (np.ndarray, list)):
          ia = np.asarray(i)
          if ia.size and (int(ia.min()) < -lead[d]
                          or int(ia.max()) >= lead[d]):
            raise IndexError(
                f".at index array for axis {d} has entries outside "
                f"[-{lead[d]}, {lead[d]})")
          norm = lazify(ia % lead[d])
        else:
          norm = lazify(i) % lead[d]
        flat = norm * int(strides[d]) if flat is None else (
            flat + norm * int(strides[d]))
      dst = (B.ravel(self._e) if not trail
             else B.reshape(self._e, (int(np.prod(lead)),) + trail))
      out = W.ScatterAssignExpr(dst, flat, v, reducer)
      return B.reshape(out, shape)
    return W.WriteArrayExpr(self._e, idx, v, reducer)

  def set(self, v):
    return self._go(v, None)

  def add(self, v):
    return self._go(v, np.add)

  def multiply(self, v):
    return self._go(v, np.multiply)

  mul = multiply

  def max(self, v):
    return self._go(v, np.maximum)

  def min(self, v):
    return self._go(v, np.minimum)


def lazify(v: Any) -> Expr:
  """Wrap a concrete value as a leaf expr (reference ``lazify``)."""
  if isinstance(v, Expr):
    return v
  return Val(v)


def evaluate(expr: Any):
  """Evaluate an expr (or container of exprs) to SpartanArray(s)."""
  if isinstance(expr, Expr):
    return expr.evaluate()
  if isinstance(expr, (list, tuple)):
    return type(expr)(evaluate(e) for e in expr)
  if isinstance(expr, dict):
    return {k: evaluate(v) for k, v in expr.items()}
  return expr


force = evaluate


def glom(expr: Any) -> np.ndarray:
  return lazify(expr).glom()
