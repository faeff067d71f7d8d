"""Estimator classes wrapping the example algorithms."""

from __future__ import annotations

from typing import Optional

import numpy as np

import spartan_tpu as sp
from spartan_tpu.examples import (kmeans as kmeans_mod, lasso as lasso_mod,
                                  linear_reg, logistic_reg, naive_bayes,
                                  pca as pca_mod, ridge_reg, svm as svm_mod)


def _lazy(X):
  return sp.lazify(X if not isinstance(X, np.ndarray)
                   else sp.from_numpy(X).value)


class LinearRegression:
  """Batch-GD linear regression (examples/linear_reg)."""

  def __init__(self, iterations: int = 100, alpha: float = 0.05):
    self.iterations = iterations
    self.alpha = alpha
    self.coef_ = None

  def fit(self, X, y):
    # fit_fused: the whole run is ONE compiled on-device loop (no
    # per-step host dispatch)
    w = linear_reg.fit_fused(_lazy(X), _lazy(y), self.iterations,
                             self.alpha)
    self.coef_ = np.asarray(w.glom())
    return self

  def predict(self, X):
    return np.asarray(sp.dot(_lazy(X), sp.from_numpy(self.coef_)).glom())

  def score(self, X, y):
    pred = self.predict(X)
    y = np.asarray(y)
    ss_res = ((y - pred) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    return 1.0 - ss_res / ss_tot


class Ridge:
  """Closed-form ridge regression (examples/ridge_reg)."""

  def __init__(self, alpha: float = 1.0):
    self.alpha = alpha
    self.coef_ = None

  def fit(self, X, y):
    self.coef_ = ridge_reg.fit(_lazy(X), _lazy(y), self.alpha)
    return self

  def predict(self, X):
    return np.asarray(sp.dot(_lazy(X), sp.from_numpy(self.coef_)).glom())


class GaussianMixture:
  """Diagonal-covariance GMM via EM in one compiled on-device loop
  (examples/gmm)."""

  def __init__(self, n_components: int = 2, iterations: int = 50,
               seed: int = 0):
    self.n_components = n_components
    self.iterations = iterations
    self.seed = seed
    self.means_ = self.variances_ = self.weights_ = None

  def fit(self, X):
    from spartan_tpu.examples import gmm
    self.means_, self.variances_, self.weights_ = gmm.fit_fused(
        _lazy(X), self.n_components, self.iterations, seed=self.seed)
    return self

  def predict(self, X):
    import numpy as _np
    X = _np.asarray(sp.lazify(_lazy(X)).glom())
    iv = 1.0 / self.variances_
    quad = ((X * X) @ iv.T - 2.0 * X @ (self.means_ * iv).T
            + (self.means_ ** 2 * iv).sum(1))
    logp = -0.5 * (quad + _np.log(self.variances_).sum(1)) + _np.log(
        self.weights_)
    return logp.argmax(1)


class SpectralClustering:
  """RBF-affinity spectral clustering (examples/spectral): sharded
  affinity/Laplacian exprs -> sp.linalg.eigh embedding -> fused k-means."""

  def __init__(self, n_clusters: int = 2, gamma: float = 10.0,
               iterations: int = 20, seed: int = 0):
    self.n_clusters = n_clusters
    self.gamma = gamma
    self.iterations = iterations
    self.seed = seed
    self.labels_ = None

  def fit(self, X):
    from spartan_tpu.examples import spectral
    self.labels_ = spectral.fit(_lazy(X), self.n_clusters, self.gamma,
                                self.iterations, seed=self.seed)
    return self

  def fit_predict(self, X):
    return self.fit(X).labels_


class Lasso:
  """L1-regularized regression — FISTA in one compiled on-device loop
  (examples/lasso)."""

  def __init__(self, alpha: float = 0.1, iterations: int = 200):
    self.alpha = alpha
    self.iterations = iterations
    self.coef_ = None

  def fit(self, X, y):
    w = lasso_mod.fit_fused(_lazy(X), _lazy(y), self.alpha,
                            self.iterations)
    self.coef_ = np.asarray(w.glom())
    return self

  def predict(self, X):
    return np.asarray(sp.dot(_lazy(X), sp.from_numpy(self.coef_)).glom())


class LogisticRegression:
  """Batch-GD logistic regression (examples/logistic_reg)."""

  def __init__(self, iterations: int = 100, alpha: float = 1.0):
    self.iterations = iterations
    self.alpha = alpha
    self.coef_ = None

  def fit(self, X, y):
    w = logistic_reg.fit_fused(
        _lazy(X), _lazy(np.asarray(y, dtype=np.float64)),
        self.iterations, self.alpha)
    self.coef_ = np.asarray(w.glom())
    return self

  def predict_proba(self, X):
    return np.asarray(
        logistic_reg.sigmoid(sp.dot(_lazy(X),
                                    sp.from_numpy(self.coef_))).glom())

  def predict(self, X):
    return (self.predict_proba(X) > 0.5).astype(np.int64)


class SVC:
  """Linear SVM by hinge-loss subgradient descent (examples/svm)."""

  def __init__(self, iterations: int = 200, alpha: float = 0.1,
               C: float = 10.0):
    self.iterations = iterations
    self.alpha = alpha
    self.C = C
    self.coef_ = None

  def fit(self, X, y):
    y = np.where(np.asarray(y) > 0, 1.0, -1.0)
    w = svm_mod.fit_fused(_lazy(X), _lazy(y), self.iterations,
                          self.alpha, self.C)
    self.coef_ = np.asarray(w.glom())
    return self

  def predict(self, X):
    return np.sign(np.asarray(
        sp.dot(_lazy(X), sp.from_numpy(self.coef_)).glom()))


class KMeans:
  """Lloyd's k-means with scatter-add updates (examples/kmeans)."""

  def __init__(self, n_clusters: int = 8, iterations: int = 20,
               seed: int = 0):
    self.n_clusters = n_clusters
    self.iterations = iterations
    self.seed = seed
    self.cluster_centers_ = None

  def fit(self, X):
    centers, labels = kmeans_mod.fit(_lazy(X), self.n_clusters,
                                     self.iterations, seed=self.seed)
    self.cluster_centers_ = np.asarray(centers.glom())
    self.labels_ = (np.asarray(labels.glom())
                    if labels is not None else None)
    return self

  def predict(self, X):
    labels = kmeans_mod.assign_labels(
        _lazy(X), sp.from_numpy(self.cluster_centers_))
    return np.asarray(labels.glom())


class NaiveBayes:
  """Multinomial naive Bayes (examples/naive_bayes)."""

  def __init__(self, alpha: float = 1.0):
    self.alpha = alpha

  def fit(self, X, y):
    y = np.asarray(y)
    self.classes_ = np.unique(y)
    remap = {c: i for i, c in enumerate(self.classes_)}
    yi = np.vectorize(remap.get)(y)
    lp, ll = naive_bayes.fit(_lazy(X), _lazy(yi), len(self.classes_),
                             self.alpha)
    self.log_prior_ = np.asarray(lp.glom())
    self.log_likelihood_ = np.asarray(ll.glom())
    return self

  def predict(self, X):
    idx = np.asarray(naive_bayes.predict(
        _lazy(X), sp.from_numpy(self.log_prior_),
        sp.from_numpy(self.log_likelihood_)).glom())
    return self.classes_[idx]


class FuzzyKMeans:
  """Soft k-means (examples/fuzzy_kmeans)."""

  def __init__(self, n_clusters: int = 8, iterations: int = 15,
               m: float = 2.0, seed: int = 0):
    self.n_clusters = n_clusters
    self.iterations = iterations
    self.m = m
    self.seed = seed

  def fit(self, X):
    from spartan_tpu.examples import fuzzy_kmeans
    centers, u = fuzzy_kmeans.fit_fused(_lazy(X), self.n_clusters,
                                        self.iterations, self.m, self.seed)
    self.cluster_centers_ = np.asarray(centers.glom())
    self.membership_ = np.asarray(u.glom())
    return self


class ALS:
  """Alternating least squares factorization (examples/als)."""

  def __init__(self, n_factors: int = 8, iterations: int = 10,
               reg: float = 0.1, seed: int = 0):
    self.n_factors = n_factors
    self.iterations = iterations
    self.reg = reg
    self.seed = seed

  def fit(self, R):
    """``R`` may be dense or a ``sparse.SparseArray`` (lazy SpMM path)."""
    from spartan_tpu.backend.sparse import SparseArray
    from spartan_tpu.examples import als as als_mod
    Rin = R if isinstance(R, SparseArray) else _lazy(R)
    self.user_factors_, self.item_factors_ = als_mod.fit(
        Rin, self.n_factors, self.iterations, self.reg, self.seed)
    return self

  def predict(self):
    return self.user_factors_ @ self.item_factors_.T


class PCA:
  """Principal component analysis by subspace iteration (examples/pca)."""

  def __init__(self, n_components: int = 2, iterations: int = 30):
    self.n_components = n_components
    self.iterations = iterations

  def fit(self, X):
    comps, evals = pca_mod.fit(_lazy(X), self.n_components, self.iterations)
    self.components_ = comps.T          # sklearn layout: (k, d)
    self.explained_variance_ = evals
    return self

  def transform(self, X):
    return np.asarray(pca_mod.transform(_lazy(X), self.components_.T).glom())

  def fit_transform(self, X):
    return self.fit(X).transform(X)


class TruncatedSVD:
  """Dimensionality reduction by top-k SVD (sklearn.decomposition
  idiom), computed by ``sparse_linalg.svds`` — thick-restart Lanczos on
  the Gram operator, so sparse and dense design matrices both work
  without centering (the sklearn contrast with PCA)."""

  def __init__(self, n_components: int = 2, ncv: int = None):
    self.n_components = n_components
    self.ncv = ncv

  def fit(self, X):
    from spartan_tpu import sparse_linalg as spl
    import spartan_tpu as sp
    u, s, vt = spl.svds(X if isinstance(
        X, (sp.sparse.SparseArray, sp.sparse.BlockSparseArray))
        else _lazy(X), self.n_components, ncv=self.ncv)
    order = np.argsort(s)[::-1]          # sklearn: descending
    self.singular_values_ = s[order]
    self.components_ = np.asarray(sp.lazify(vt).glom())[order]
    return self

  def transform(self, X):
    import spartan_tpu as sp
    sparse = isinstance(
        X, (sp.sparse.SparseArray, sp.sparse.BlockSparseArray))
    Xe = X if sparse else _lazy(X)
    kw = {} if sparse else {"precision": "highest"}
    return np.asarray(sp.lazify(
        sp.dot(Xe, sp.lazify(self.components_.T), **kw)).glom())

  def fit_transform(self, X):
    return self.fit(X).transform(X)


class KNeighborsClassifier:
  """k-NN classification (examples/knn): pairwise distances as one
  matmul, argpartition selection, one-hot-matmul majority vote."""

  def __init__(self, n_neighbors: int = 5):
    self.n_neighbors = n_neighbors

  def fit(self, X, y):
    yn = np.asarray(y, dtype=np.int64)
    self.classes_ = np.unique(yn)
    # keep the train set device-resident: re-uploading the full matrix
    # per predict() is a host-to-device copy each time
    self._X = _lazy(X).evaluate()
    self._y = _lazy(yn).evaluate()
    return self

  def predict(self, X):
    from spartan_tpu.examples import knn as knn_mod
    return np.asarray(knn_mod.predict(
        _lazy(X), _lazy(self._X), _lazy(self._y),
        k=self.n_neighbors,
        n_classes=int(self.classes_.max()) + 1).glom())

  def score(self, X, y):
    return float((self.predict(X) == np.asarray(y)).mean())
