"""Logging, timing and assertion helpers.

Rebuild of the reference's utility substrate (reference:
``spartan/util.py`` — leveled logging, ``Timer``/``timeit``, ``Assert``
helpers used throughout the test suite, ``divup``; SURVEY.md §2.1).
"""

from __future__ import annotations

import functools
import logging
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict

import numpy as np

_log = logging.getLogger("spartan_tpu")
if not _log.handlers:
  _handler = logging.StreamHandler()
  _handler.setFormatter(
      logging.Formatter("%(asctime)s [%(levelname).1s] %(name)s: %(message)s",
                        datefmt="%H:%M:%S"))
  _log.addHandler(_handler)
  _log.propagate = False


def enable_compile_cache() -> str:
  """Turn on JAX's persistent compile cache; returns its directory.

  If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
  sets nothing.  Otherwise the cache goes to ``<checkout>/.jax_cache``,
  derived from this file's location: the path is part of the cache key,
  so it must not change from one run to the next."""
  env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
  if env:
    return env
  import jax
  path = os.path.join(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
      ".jax_cache")
  os.makedirs(path, exist_ok=True)
  jax.config.update("jax_compilation_cache_dir", path)
  return path


def set_log_level(level: int) -> None:
  _log.setLevel(level)


def log_debug(fmt: str, *args: Any) -> None:
  _log.debug(fmt, *args)


def log_info(fmt: str, *args: Any) -> None:
  _log.info(fmt, *args)


def log_warn(fmt: str, *args: Any) -> None:
  _log.warning(fmt, *args)


def log_error(fmt: str, *args: Any) -> None:
  _log.error(fmt, *args)


def divup(a: int, b: int) -> int:
  """Ceiling division."""
  return -(-a // b)


def memoize(fn: Callable) -> Callable:
  cache: Dict[Any, Any] = {}

  @functools.wraps(fn)
  def wrapper(*args):
    if args not in cache:
      cache[args] = fn(*args)
    return cache[args]

  wrapper.cache = cache  # type: ignore[attr-defined]
  return wrapper


class Timer:
  """Accumulating wall-clock timer usable as a context manager."""

  def __init__(self, name: str = ""):
    self.name = name
    self.elapsed = 0.0
    self.count = 0
    self._start = None

  def __enter__(self):
    self._start = time.perf_counter()
    return self

  def __exit__(self, *exc):
    self.elapsed += time.perf_counter() - self._start
    self.count += 1
    return False

  def __repr__(self):
    avg = self.elapsed / max(self.count, 1)
    return f"Timer({self.name}: total={self.elapsed:.4f}s n={self.count} avg={avg:.4f}s)"


@contextmanager
def timeit(name: str = "block", log: bool = True):
  """Time a block; optionally log the elapsed time."""
  start = time.perf_counter()
  holder = {"elapsed": None}
  try:
    yield holder
  finally:
    holder["elapsed"] = time.perf_counter() - start
    if log:
      log_info("%s took %.4fs", name, holder["elapsed"])


class Assert:
  """Assertion helpers mirroring the reference's test oracle idioms
  (``Assert.all_eq(spartan_result.glom(), numpy_result)``)."""

  @staticmethod
  def _to_np(x: Any) -> np.ndarray:
    glom = getattr(x, "glom", None)
    if callable(glom):
      x = glom()
    return np.asarray(x)

  @staticmethod
  def all_eq(a: Any, b: Any) -> None:
    a, b = Assert._to_np(a), Assert._to_np(b)
    assert a.shape == b.shape, f"shape mismatch: {a.shape} vs {b.shape}"
    if a.dtype.kind in "fc" or b.dtype.kind in "fc":
      np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    else:
      np.testing.assert_array_equal(a, b)

  @staticmethod
  def all_close(a: Any, b: Any, rtol: float = 1e-9, atol: float = 1e-10) -> None:
    a, b = Assert._to_np(a), Assert._to_np(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)

  @staticmethod
  def eq(a: Any, b: Any) -> None:
    assert a == b, f"{a!r} != {b!r}"

  @staticmethod
  def true(cond: Any, msg: str = "") -> None:
    assert cond, msg

  @staticmethod
  def isinstance(obj: Any, cls: type) -> None:
    assert isinstance(obj, cls), f"{obj!r} is not a {cls}"
