"""Logistic regression by batch gradient descent.

Reference: ``spartan/examples/logistic_reg.py`` (SURVEY.md §2.5, config 3)
— the linreg loop plus a sigmoid map, all fused into one region per step.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp


def sigmoid(v):
  return 1.0 / (1.0 + sp.exp(-v))


def gradient_step(X, y, w, alpha: float):
  n = X.shape[0]
  pred = sigmoid(sp.dot(X, w))
  grad = sp.dot(X.T, pred - y) * (1.0 / n)
  return w - alpha * grad


def fit(X, y, iterations: int = 50, alpha: float = 1.0):
  X, y = sp.lazify(X), sp.lazify(y)
  w = sp.zeros((X.shape[1],), dtype=np.float64)
  for _ in range(iterations):
    w = sp.Val(gradient_step(X, y, w, alpha).evaluate())
  return w.evaluate()


def fit_fused(X, y, iterations: int = 50, alpha: float = 1.0):
  """Whole training run in ONE compiled on-device loop (sp.make_fori) —
  no per-step host dispatch;
  semantically identical to :func:`fit`."""
  X, y = sp.lazify(X), sp.lazify(y)
  run = sp.make_fori(lambda w: gradient_step(X, y, w, alpha),
                     sp.zeros((X.shape[1],), dtype=np.float64))
  return run(iterations)


def predict(X, w):
  return sigmoid(sp.dot(sp.lazify(X), sp.lazify(w))) > 0.5


def make_data(n: int = 4096, d: int = 16, seed: int = 0):
  rng = np.random.default_rng(seed)
  X = rng.standard_normal((n, d))
  w_true = rng.standard_normal(d)
  y = (1.0 / (1.0 + np.exp(-X @ w_true)) > 0.5).astype(np.float64)
  return sp.from_numpy(X), sp.from_numpy(y), w_true


def run(n: int = 4096, d: int = 16, iterations: int = 50):
  X, y, w_true = make_data(n, d)
  w = fit(X, y, iterations)
  acc = (np.asarray(predict(X, w).glom()) ==
         (y.glom() > 0.5)).mean()
  return w, acc
