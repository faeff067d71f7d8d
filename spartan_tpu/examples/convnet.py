"""A small convolutional network forward pass (the reference's
convnet/mnist CNN example — SURVEY.md §2.5), built on the stencil /
maxpool exprs: conv → relu → pool → conv → relu → pool → flatten → dense.

Layout NCHW; the whole forward pass is one fused region, with the spatial
halo exchanges inserted by XLA's partitioner when H/W are sharded.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu as sp


def init_params(in_ch: int = 1, c1: int = 8, c2: int = 16,
                n_classes: int = 10, img: int = 28, seed: int = 0):
  rng = np.random.default_rng(seed)
  flat = c2 * (img // 4) * (img // 4)
  scale = 0.1
  return {
      "w1": rng.standard_normal((c1, in_ch, 3, 3)) * scale,
      "w2": rng.standard_normal((c2, c1, 3, 3)) * scale,
      "wd": rng.standard_normal((flat, n_classes)) * scale,
      "bd": np.zeros(n_classes),
  }


def relu(v):
  return sp.maximum(v, 0.0)


def forward(images, params):
  """images: (N, C, H, W) → logits (N, n_classes), fully lazy."""
  x = sp.lazify(images)
  n = x.shape[0]
  h1 = sp.maxpool(relu(sp.stencil(x, sp.lazify(params["w1"]))), 2)
  h2 = sp.maxpool(relu(sp.stencil(h1, sp.lazify(params["w2"]))), 2)
  flat = h2.reshape(n, int(np.prod(h2.shape[1:])))
  return sp.dot(flat, sp.lazify(params["wd"])) + sp.lazify(params["bd"])


def predict(images, params):
  return sp.argmax(forward(images, params), axis=1)


def loss_expr(images, labels, param_leaves):
  """Mean softmax cross-entropy as a lazy expr over Val parameter leaves
  (differentiable through spartan_tpu.autodiff)."""
  logits = forward(images, param_leaves)
  n = logits.shape[0]
  # logsumexp via expr ops (stable: subtract rowwise max)
  mx = sp.max(logits, axis=1, keepdims=True)
  lse = sp.log(sp.sum(sp.exp(logits - mx), axis=1)) + sp.squeeze(mx, axis=1)
  picked = sp.sum(logits * sp.lazify(labels), axis=1)  # labels one-hot
  return sp.sum(lse - picked) / float(n)


def train_step(images, labels_onehot, params, lr: float = 0.05):
  """One SGD step by differentiating the lazy DAG (autodiff bridge) —
  a capability the reference never had; its CNN example was
  forward-only."""
  from spartan_tpu import autodiff
  leaves = {k: sp.lazify(v) for k, v in params.items()}
  loss = loss_expr(sp.lazify(images), labels_onehot, leaves)
  names = list(leaves.keys())
  grads = autodiff.grad(loss, [leaves[k] for k in names])
  out = {}
  for k, g in zip(names, grads):
    out[k] = np.asarray(params[k]) - lr * np.asarray(g.glom())
  return out, loss


def fit_fused(images, labels, n_classes: int = 10, epochs: int = 3,
              lr: float = 0.05, seed: int = 0):
  """The whole CNN training run in ONE compiled on-device loop.

  ``train()`` below mirrors the reference's driver-loop shape (one
  evaluate + host round trip per parameter per step); this path
  differentiates the same lazy loss DAG and runs every SGD step inside a
  single ``lax.scan`` via :func:`spartan_tpu.sgd_train` — zero per-step
  host dispatch.
  Returns ``(params dict, loss curve ndarray)``; the loss curve is
  step-for-step identical to ``train()``'s (loss recorded at the
  pre-update parameters).
  """
  images = np.asarray(images)
  onehot = np.eye(n_classes)[np.asarray(labels)]
  params = init_params(in_ch=images.shape[1], n_classes=n_classes,
                       img=images.shape[2], seed=seed)
  import spartan_tpu as sp_mod
  leaves = {k: sp_mod.lazify(v) for k, v in params.items()}
  loss = loss_expr(sp_mod.lazify(images), onehot, leaves)
  names = list(leaves.keys())
  out, losses = sp_mod.sgd_train(loss, [leaves[k] for k in names], lr,
                                 epochs, collect_losses=True)
  fitted = {k: np.asarray(p.glom()) for k, p in zip(names, out)}
  return fitted, np.asarray(losses.glom())


def train(images, labels, n_classes: int = 10, epochs: int = 3,
          lr: float = 0.05, seed: int = 0):
  images = np.asarray(images)
  onehot = np.eye(n_classes)[np.asarray(labels)]
  params = init_params(in_ch=images.shape[1], n_classes=n_classes,
                       img=images.shape[2], seed=seed)
  losses = []
  for _ in range(epochs):
    params, loss = train_step(images, onehot, params, lr)
    losses.append(float(loss.glom()))
  return params, losses


def run(n: int = 32, img: int = 28, seed: int = 0):
  rng = np.random.default_rng(seed)
  images = rng.standard_normal((n, 1, img, img))
  params = init_params(img=img, seed=seed)
  logits = forward(sp.from_numpy(images), params)
  return logits.evaluate(), params, images
