"""``sp.spatial.transform`` — the scipy.spatial.transform surface.

``Rotation`` stores an ``(N, 4)`` scalar-last quaternion as a lazy
Expr; every representation conversion (matrix/rotvec/euler/mrp/quat),
composition, inversion, ``apply`` and ``Slerp`` interpolation is a
branch-free jnp kernel inside one ``sp.map`` — batched rotations lower
to a handful of fused elementwise passes (plus one small matmul for
``apply``/``as_matrix``), which is the whole workload on device: there is
no per-rotation control flow anywhere.  Euler extraction is the
general two-family (Tait-Bryan / proper) index-parity formulation with
a where-selected gimbal-lock branch, valid for all 24 conventions.
``mean`` is the largest eigenvector of the weighted quaternion outer
moment (device ``eigh``); ``align_vectors`` is Kabsch (device SVD).

Host boundary: ``RotationSpline`` and ``RigidTransform`` re-export the
scipy classes (the integrate RK45-driver convention); the exotic
Rotation classmethods (davenport family, ``create_group``, ``reduce``)
round-trip through scipy with the once-per-process notice.

Reference parity: the spartan reference has no spatial module;
SURVEY.md §2.5 'broader demo set' motivates the beyond-parity scipy
surfaces.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

import spartan_tpu as sp
from spartan_tpu.expr.base import Expr
from spartan_tpu.special import _f
from spartan_tpu.util import log_info

__all__ = ["Rotation", "Slerp", "RotationSpline", "RigidTransform"]

_host_noticed = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info("sp.spatial.transform.%s: sequential/tabular algorithm — "
           "runs EAGERLY on the host (scipy), the sp.linalg.eig "
           "convention.", name)


# ---------------------------------------------------------------------
# quaternion kernels (concrete jnp arrays, (..., 4) scalar-last)
# ---------------------------------------------------------------------

def _quat_mul(p, q):
  px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
  qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  return jnp.stack([
      pw * qx + px * qw + py * qz - pz * qy,
      pw * qy - px * qz + py * qw + pz * qx,
      pw * qz + px * qy - py * qx + pz * qw,
      pw * qw - px * qx - py * qy - pz * qz], axis=-1)


def _quat_norm(q):
  return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def _quat_canonical(q):
  """Flip sign so w >= 0 (ties broken toward +x/+y/+z like scipy)."""
  w = q[..., 3]
  x, y, z = q[..., 0], q[..., 1], q[..., 2]
  neg = (w < 0) | ((w == 0) & ((x < 0) | ((x == 0) & ((y < 0) | (
      (y == 0) & (z < 0))))))
  return jnp.where(neg[..., None], -q, q)


def _quat_to_matrix(q):
  x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  rows = [
      jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
      jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
      jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
  ]
  return jnp.stack(rows, axis=-2)


def _matrix_to_quat(M):
  """Branch-free Shepperd: build all four candidate quats, pick the
  numerically dominant one by argmax of the four trace combinations."""
  m = lambda i, j: M[..., i, j]
  tr = m(0, 0) + m(1, 1) + m(2, 2)
  tw = 1.0 + tr
  tx = 1.0 + m(0, 0) - m(1, 1) - m(2, 2)
  ty = 1.0 - m(0, 0) + m(1, 1) - m(2, 2)
  tz = 1.0 - m(0, 0) - m(1, 1) + m(2, 2)
  qw = jnp.stack([m(2, 1) - m(1, 2), m(0, 2) - m(2, 0),
                  m(1, 0) - m(0, 1), tw], -1)
  qx = jnp.stack([tx, m(0, 1) + m(1, 0), m(0, 2) + m(2, 0),
                  m(2, 1) - m(1, 2)], -1)
  qy = jnp.stack([m(0, 1) + m(1, 0), ty, m(1, 2) + m(2, 1),
                  m(0, 2) - m(2, 0)], -1)
  qz = jnp.stack([m(0, 2) + m(2, 0), m(1, 2) + m(2, 1), tz,
                  m(1, 0) - m(0, 1)], -1)
  ts = jnp.stack([tx, ty, tz, tw], -1)
  case = jnp.argmax(ts, axis=-1)[..., None]
  q = jnp.where(case == 0, qx, jnp.where(case == 1, qy,
                jnp.where(case == 2, qz, qw)))
  return _quat_norm(q)


def _quat_from_rotvec(v):
  t2 = (v * v).sum(-1)
  t = jnp.sqrt(t2)
  small = t < 1e-3
  # sin(t/2)/t with a 2-term Taylor for tiny angles
  scale = jnp.where(small, 0.5 - t2 / 48.0 + t2 * t2 / 3840.0,
                    jnp.sin(jnp.where(small, 1.0, t) / 2)
                    / jnp.where(small, 1.0, t))
  w = jnp.cos(t / 2)
  return jnp.concatenate([v * scale[..., None], w[..., None]], -1)


def _quat_to_rotvec(q):
  q = _quat_canonical(q)
  s = jnp.linalg.norm(q[..., :3], axis=-1)
  angle = 2.0 * jnp.arctan2(s, q[..., 3])
  small = angle < 1e-3
  a2 = angle * angle
  # angle / sin(angle/2), Taylor 2 + a^2/12 + 7a^4/2880 for tiny angles
  scale = jnp.where(small, 2.0 + a2 / 12.0 + 7.0 * a2 * a2 / 2880.0,
                    angle / jnp.sin(jnp.where(small, 1.0, angle) / 2))
  return q[..., :3] * scale[..., None]


def _quat_inv(q):
  return jnp.concatenate([-q[..., :3], q[..., 3:]], -1)


def _apply_quat(q, v, inverse=False):
  """Rotate (..., 3) vectors: v + 2w (u x v) + 2 u x (u x v)."""
  u = -q[..., :3] if inverse else q[..., :3]
  w = q[..., 3:]
  uv = jnp.cross(u, v)
  return v + 2.0 * (w * uv + jnp.cross(u, uv))


_AXES = {"x": 0, "y": 1, "z": 2}


def _elem_quat(axis, angle):
  """(...,) angles about a fixed axis index -> (..., 4) quats."""
  half = angle / 2
  zero = jnp.zeros_like(half)
  parts = [zero, zero, zero]
  parts[axis] = jnp.sin(half)
  parts.append(jnp.cos(half))
  return jnp.stack(parts, -1)


def _euler_to_quat(axes, intrinsic, angles):
  """angles (..., len(axes)) -> quats; intrinsic composes left-to-
  right (body frame), extrinsic right-to-left (scipy semantics)."""
  q = _elem_quat(axes[0], angles[..., 0])
  for i, ax in enumerate(axes[1:], start=1):
    e = _elem_quat(ax, angles[..., i])
    q = _quat_mul(q, e) if intrinsic else _quat_mul(e, q)
  return q


def _quat_to_euler(q, axes, intrinsic, degrees):
  """General 24-convention extraction (index/parity formulation over
  the rotation matrix; where-selected gimbal-lock branch that zeroes
  the third angle, matching scipy)."""
  if not intrinsic:
    # extrinsic(seq) == reversed(intrinsic(reversed(seq)))
    out = _quat_to_euler(q, axes[::-1], True, degrees)
    return out[..., ::-1]
  M = _quat_to_matrix(q)
  m = lambda a, b: M[..., a, b]
  i, j, k = axes
  eps = 1e-7
  if i == k:                      # proper Euler (e.g. ZXZ)
    l = 3 - i - j
    s = 1.0 if (i, j, l) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)) else -1.0
    cb = jnp.clip(m(i, i), -1.0, 1.0)
    b = jnp.arccos(cb)
    a = jnp.arctan2(m(j, i), -s * m(l, i))
    c = jnp.arctan2(m(i, j), s * m(i, l))
    lock = jnp.abs(cb) > 1.0 - eps
    sgn = jnp.sign(cb)
    a_lock = jnp.arctan2(-sgn * s * m(j, l), m(j, j))
    a = jnp.where(lock, a_lock, a)
    c = jnp.where(lock, 0.0, c)
  else:                           # Tait-Bryan (e.g. XYZ)
    s = 1.0 if (i, j, k) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)) else -1.0
    sb = jnp.clip(s * m(i, k), -1.0, 1.0)
    b = jnp.arcsin(sb)
    a = jnp.arctan2(-s * m(j, k), m(k, k))
    c = jnp.arctan2(-s * m(i, j), m(i, i))
    lock = jnp.abs(sb) > 1.0 - eps
    sgn = jnp.sign(sb)
    # at the lock only a∓c survives; parity cancels here (derived for
    # both b=±π/2 on cyclic and anticyclic sequences)
    a_lock = jnp.arctan2(sgn * m(j, i), m(j, j))
    a = jnp.where(lock, a_lock, a)
    c = jnp.where(lock, 0.0, c)
  out = jnp.stack([a, b, c], -1)
  return jnp.degrees(out) if degrees else out


def _parse_seq(seq):
  if not 1 <= len(seq) <= 3:
    raise ValueError(f"expected 1-3 axes, got {seq!r}")
  intrinsic = seq.isupper()
  if not intrinsic and not seq.islower():
    raise ValueError(f"cannot mix intrinsic/extrinsic axes in {seq!r}")
  axes = [_AXES[c] for c in seq.lower()]
  if any(a == b for a, b in zip(axes, axes[1:])):
    raise ValueError(f"consecutive axes must differ in {seq!r}")
  return axes, intrinsic


class Rotation:
  """Batched 3-D rotations as a lazy scalar-last quaternion Expr.

  Every conversion/composition lowers to branch-free jnp kernels in
  one ``sp.map``; outputs are lazy Exprs (``.glom()`` fetches)."""

  def __init__(self, quat, normalize=True, copy=True):
    q = sp.lazify(quat)
    if len(q.shape) == 1:
      if q.shape != (4,):
        raise ValueError(f"quaternion shape {q.shape}, expected (4,)")
      self._single = True
      q = sp.map([q], lambda a: a[None, :])
    else:
      if len(q.shape) != 2 or q.shape[1] != 4:
        raise ValueError(f"quaternion shape {q.shape}, expected (N, 4)")
      self._single = False
    if normalize:
      q = sp.map([q], lambda a: _quat_norm(_f(a)))
    self._quat = q

  # -- construction ----------------------------------------------------

  @classmethod
  def from_quat(cls, quat, *, scalar_first=False):
    if scalar_first:
      q = sp.lazify(quat)
      roll = (lambda a: jnp.concatenate([a[..., 1:], a[..., :1]], -1))
      q = sp.map([q], roll)
      return cls(q)
    return cls(quat)

  @classmethod
  def from_matrix(cls, matrix):
    M = sp.lazify(matrix)
    single = len(M.shape) == 2
    if single:
      M = sp.map([M], lambda a: a[None])
    q = sp.map([M], lambda a: _matrix_to_quat(_f(a)))
    out = cls(q, normalize=False)
    out._single = single
    return out

  @classmethod
  def from_rotvec(cls, rotvec, degrees=False):
    v = sp.lazify(rotvec)
    single = len(v.shape) == 1
    if single:
      v = sp.map([v], lambda a: a[None])
    d = degrees

    def kern(a):
      a = _f(a)
      return _quat_from_rotvec(jnp.radians(a) if d else a)
    q = sp.map([v], kern)
    out = cls(q, normalize=False)
    out._single = single
    return out

  @classmethod
  def from_euler(cls, seq, angles, degrees=False):
    axes, intrinsic = _parse_seq(seq)
    a = sp.lazify(angles)
    shp = a.shape
    d = degrees

    # scipy shape semantics: () (1-axis seq) or (L,) is a single
    # rotation; (N, L) is a batch — the last dim must match the seq
    if shp == () and len(axes) == 1:
      single = True
    elif len(shp) in (1, 2) and shp[-1] == len(axes):
      single = len(shp) == 1
    else:
      raise ValueError(f"angles shape {shp} does not match "
                       f"{len(axes)}-axis seq {seq!r}")

    def kern(ang):
      ang = _f(ang)
      ang = jnp.radians(ang) if d else ang
      ang = jnp.atleast_1d(ang)
      if ang.ndim == 1:
        ang = ang[None]
      return _euler_to_quat(axes, intrinsic, ang)
    q = sp.map([a], kern)
    out = cls(q, normalize=False)
    out._single = single
    return out

  @classmethod
  def from_mrp(cls, mrp):
    p = sp.lazify(mrp)
    single = len(p.shape) == 1
    if single:
      p = sp.map([p], lambda a: a[None])

    def kern(a):
      a = _f(a)
      n2 = (a * a).sum(-1, keepdims=True)
      return jnp.concatenate([2 * a / (1 + n2),
                              (1 - n2) / (1 + n2)], -1)
    q = sp.map([p], kern)
    out = cls(q, normalize=False)
    out._single = single
    return out

  @classmethod
  def identity(cls, num=None):
    n = 1 if num is None else num
    q = np.zeros((n, 4))
    q[:, 3] = 1.0
    out = cls(q, normalize=False)
    out._single = num is None
    return out

  @classmethod
  def random(cls, num=None, rng=None):
    g = np.random.default_rng(rng) if not isinstance(
        rng, np.random.Generator) else rng
    q = g.standard_normal((1 if num is None else num, 4))
    out = cls(q)           # constructor normalizes
    out._single = num is None
    return out

  @classmethod
  def concatenate(cls, rotations):
    qs = [r._quat for r in rotations]
    q = sp.map(qs, lambda *a: jnp.concatenate(a, 0))
    return cls(q, normalize=False)

  @classmethod
  def align_vectors(cls, a, b, weights=None, return_sensitivity=False):
    """Kabsch on device: SVD of the weighted cross-covariance."""
    if return_sensitivity:
      _host_notice("Rotation.align_vectors[sensitivity]")
      from scipy.spatial.transform import Rotation as _R
      ops = [np.asarray(sp.lazify(x).glom()) for x in (a, b)]
      w = None if weights is None else np.asarray(
          sp.lazify(weights).glom())
      est, rssd, sens = _R.align_vectors(*ops, weights=w,
                                         return_sensitivity=True)
      return cls.from_quat(est.as_quat()), rssd, sens
    A, B = sp.lazify(a), sp.lazify(b)
    ops = [A, B] + ([] if weights is None else [sp.lazify(weights)])

    def kern(aa, bb, *w):
      aa, bb = jnp.atleast_2d(_f(aa)), jnp.atleast_2d(_f(bb))
      ww = _f(w[0]) if w else jnp.ones(aa.shape[0], aa.dtype)
      Bm = (aa * ww[:, None]).T @ bb
      U, S, Vt = jnp.linalg.svd(Bm)
      det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
      Ufix = U.at[:, -1].multiply(jnp.sign(det))
      C = Ufix @ Vt
      ss = (ww[:, None] * (aa * aa + bb * bb)).sum()
      sv = S.at[-1].multiply(jnp.sign(det))
      rssd = jnp.sqrt(jnp.maximum(ss - 2.0 * sv.sum(), 0.0))
      return _matrix_to_quat(C[None]), rssd
    q = sp.map(ops, lambda *xs: kern(*xs)[0])
    rssd = sp.map(ops, lambda *xs: kern(*xs)[1])
    out = cls(q, normalize=False)
    out._single = True
    return out, rssd

  # -- host-boundary classmethods (tabular/sequential scipy) -----------

  @classmethod
  def create_group(cls, group, axis="Z"):
    _host_notice("Rotation.create_group")
    from scipy.spatial.transform import Rotation as _R
    return cls.from_quat(_R.create_group(group, axis=axis).as_quat())

  @classmethod
  def from_davenport(cls, axes, order, angles, degrees=False):
    _host_notice("Rotation.from_davenport")
    from scipy.spatial.transform import Rotation as _R
    ax = np.asarray(sp.lazify(axes).glom())
    ang = np.asarray(sp.lazify(angles).glom())
    return cls.from_quat(_R.from_davenport(
        ax, order, ang, degrees=degrees).as_quat())

  def as_davenport(self, axes, order, degrees=False):
    _host_notice("Rotation.as_davenport")
    return self._scipy().as_davenport(
        np.asarray(sp.lazify(axes).glom()), order, degrees=degrees)

  def reduce(self, left=None, right=None, return_indices=False):
    _host_notice("Rotation.reduce")
    out = self._scipy().reduce(
        None if left is None else left._scipy(),
        None if right is None else right._scipy(),
        return_indices=return_indices)
    if return_indices:
      red, li, ri = out
      return Rotation.from_quat(red.as_quat()), li, ri
    return Rotation.from_quat(out.as_quat())

  def _scipy(self):
    from scipy.spatial.transform import Rotation as _R
    # copy=True: glom buffers can be read-only; scipy's cython
    # memoryviews require writable input
    return _R.from_quat(np.array(sp.lazify(self.as_quat()).glom(),
                                 copy=True))

  # -- representations -------------------------------------------------

  def _sq(self, expr):
    """Squeeze the batch axis back off for single rotations."""
    if not self._single:
      return expr
    return sp.map([expr], lambda a: a[0])

  def as_quat(self, canonical=False, *, scalar_first=False):
    def kern(q):
      q = _quat_canonical(q) if canonical else q
      if scalar_first:
        q = jnp.concatenate([q[..., 3:], q[..., :3]], -1)
      return q
    return self._sq(sp.map([self._quat], kern))

  def as_matrix(self):
    return self._sq(sp.map([self._quat],
                           lambda q: _quat_to_matrix(_f(q))))

  def as_rotvec(self, degrees=False):
    d = degrees

    def kern(q):
      v = _quat_to_rotvec(_f(q))
      return jnp.degrees(v) if d else v
    return self._sq(sp.map([self._quat], kern))

  def as_euler(self, seq, degrees=False):
    axes, intrinsic = _parse_seq(seq)
    if len(axes) != 3:
      raise ValueError("as_euler needs a 3-axis sequence")
    return self._sq(sp.map(
        [self._quat],
        lambda q: _quat_to_euler(_f(q), axes, intrinsic, degrees)))

  def as_mrp(self):
    def kern(q):
      q = _quat_canonical(_f(q))
      return q[..., :3] / (1.0 + q[..., 3:])
    return self._sq(sp.map([self._quat], kern))

  # -- algebra ---------------------------------------------------------

  def apply(self, vectors, inverse=False):
    v = sp.lazify(vectors)
    vec_single = len(v.shape) == 1
    inv = inverse

    def kern(q, vv):
      vv = jnp.atleast_2d(_f(vv))
      out = _apply_quat(_f(q), vv, inverse=inv)
      return out
    out = sp.map([self._quat, v], kern)
    if self._single and vec_single:
      return sp.map([out], lambda a: a[0])
    return out

  def __mul__(self, other):
    q = sp.map([self._quat, other._quat],
               lambda p, r: _quat_norm(_quat_mul(_f(p), _f(r))))
    out = Rotation(q, normalize=False)
    out._single = self._single and other._single
    return out

  def __pow__(self, n, modulus=None):
    if modulus is not None:
      raise NotImplementedError("modulus not supported")
    nn = float(n)
    q = sp.map([self._quat],
               lambda p: _quat_from_rotvec(nn * _quat_to_rotvec(_f(p))))
    out = Rotation(q, normalize=False)
    out._single = self._single
    return out

  def inv(self):
    q = sp.map([self._quat], lambda p: _quat_inv(p))
    out = Rotation(q, normalize=False)
    out._single = self._single
    return out

  def magnitude(self):
    def kern(q):
      q = _f(q)
      return 2.0 * jnp.arctan2(jnp.linalg.norm(q[..., :3], axis=-1),
                               jnp.abs(q[..., 3]))
    return self._sq(sp.map([self._quat], kern))

  def mean(self, weights=None):
    ops = [self._quat] + ([] if weights is None
                          else [sp.lazify(weights)])

    def kern(q, *w):
      q = _f(q)
      ww = _f(w[0]) if w else jnp.ones(q.shape[0], q.dtype)
      K = (q * ww[:, None]).T @ q
      _, vecs = jnp.linalg.eigh(K)
      return vecs[:, -1][None]
    out = Rotation(sp.map(ops, kern), normalize=False)
    out._single = True
    return out

  def approx_equal(self, other, atol=None, degrees=False):
    tol = atol if atol is not None else (0.1 if degrees else 1e-8)
    if degrees and atol is not None:
      tol = np.radians(atol)
    diff = self * other.inv()
    return sp.map([diff.magnitude()], lambda m: m < tol)

  # -- container protocol ----------------------------------------------

  def __len__(self):
    if self._single:
      raise TypeError("single rotation has no len()")
    return self._quat.shape[0]

  def __getitem__(self, idx):
    if self._single:
      raise TypeError("single rotation is not subscriptable")
    out = Rotation(self._quat[idx], normalize=False)
    out._single = isinstance(idx, int) or (
        isinstance(idx, np.integer))
    if out._single:
      out._quat = sp.map([self._quat],
                         lambda q, i=int(idx): q[i][None])
    return out

  def __repr__(self):
    n = 1 if self._single else self._quat.shape[0]
    return f"Rotation({'single' if self._single else n}, lazy quat)"


class Slerp:
  """Spherical linear interpolation over keyframe rotations — one
  device kernel: searchsorted interval lookup + relative-rotvec scale
  (no per-query control flow)."""

  def __init__(self, times, rotations):
    if rotations._single or len(rotations) < 2:
      raise ValueError("Slerp needs >= 2 rotations")
    self.times = sp.lazify(times)
    if self.times.shape != (len(rotations),):
      raise ValueError("times must match the number of rotations")
    self.rotations = rotations

  def __call__(self, times):
    t = sp.lazify(times)
    single = len(t.shape) == 0

    def kern(knots, quats, tq):
      knots, quats, tq = _f(knots), _f(quats), jnp.atleast_1d(_f(tq))
      idx = jnp.clip(jnp.searchsorted(knots, tq, side="right") - 1,
                     0, knots.shape[0] - 2)
      q0, q1 = quats[idx], quats[idx + 1]
      alpha = (tq - knots[idx]) / (knots[idx + 1] - knots[idx])
      rel = _quat_mul(_quat_inv(q0), q1)
      step = _quat_from_rotvec(alpha[:, None] * _quat_to_rotvec(rel))
      return _quat_mul(q0, step)
    q = sp.map([self.times, self.rotations._quat, t], kern)
    out = Rotation(q, normalize=False)
    out._single = single
    return out


# host-boundary classes, re-exported whole (RK45-driver convention):
# cubic-spline angular-rate matching and rigid-body composition are
# sequential host algorithms scipy already owns.
from scipy.spatial.transform import RotationSpline  # noqa: E402
from scipy.spatial.transform import RigidTransform  # noqa: E402

_HOST_NAMES = ["RigidTransform", "RotationSpline"]
