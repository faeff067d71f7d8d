"""x64-off dtype semantics: the whole suite runs with x64 enabled (NumPy
parity); this spawns a subprocess with x64 OFF (JAX's default) and
smoke-tests the core paths under f32 canonicalization."""

import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import jax
jax.config.update('jax_platforms', 'cpu')
# x64 stays OFF — JAX's default
import numpy as np
import spartan_tpu as sp
from spartan_tpu.core import mesh as mesh_mod
mesh_mod.set_default_mesh(mesh_mod.make_mesh((2, 4), ('x', 'y')))

# f64 requests canonicalize to f32 silently
a = sp.ones((16, 16))
assert a.dtype == np.float32, a.dtype
v = float((a + sp.rand(16, 16) * 2.0).sum().glom())
assert np.isfinite(v)

# f64-accumulation flag degrades gracefully to f32
s = sp.from_numpy(np.ones(100, dtype=np.float32)).sum().glom()
assert s.dtype == np.float32 and s == 100.0, (s.dtype, s)

# int accumulation canonicalizes to int32
i = sp.from_numpy(np.arange(10, dtype=np.int32)).sum().glom()
assert i.dtype == np.int32 and i == 45, (i.dtype, i)

# example step end-to-end in f32
from spartan_tpu.examples import linear_reg
X, y, wt = linear_reg.make_data(256, 8)
w = linear_reg.fit(X, y, 20, alpha=0.05)
assert np.asarray(w.glom()).dtype == np.float32

# kmeans matmul path f32
from spartan_tpu.examples import kmeans
pts, _ = kmeans.make_data(128, 4, 3)
c, l = kmeans.fit(pts, 3, 3)
assert np.isfinite(np.asarray(c.glom())).all()

# affine rewrite under f32
b = np.random.rand(64, 64).astype(np.float32)
got = float((sp.ones((64, 64)) + sp.from_numpy(b) * 2.0).sum().glom())
want = (1.0 + 2.0 * b.astype(np.float64)).sum()
assert abs(got - want) / want < 1e-5, (got, want)
# r3 surfaces under f32: minimize with Newton polish; custom scan
rng = np.random.default_rng(0)
Xm = rng.standard_normal((512, 8)).astype(np.float32)
ym = (Xm @ rng.standard_normal(8)).astype(np.float32)
wl = sp.from_numpy(np.zeros(8, np.float32))
loss = sp.mean((sp.dot(sp.from_numpy(Xm), wl) - sp.from_numpy(ym)) ** 2)
(wo,), info = sp.minimize(loss, [wl])
wwant = np.linalg.lstsq(Xm.astype(np.float64), ym.astype(np.float64),
                        rcond=None)[0]
assert np.abs(np.asarray(wo.glom()) - wwant).max() < 1e-4, "minimize f32"
import jax.numpy as jnp
xs = rng.standard_normal(4096).astype(np.float32)
gs = np.asarray(sp.scan(sp.from_numpy(xs), scan_fn=jnp.maximum).glom())
assert (gs == np.maximum.accumulate(xs)).all(), "custom scan f32"
print("X64-OFF SMOKE OK")
"""


def test_tpu_mode_f32_semantics():
  env = dict(os.environ)
  env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
  env.pop("JAX_ENABLE_X64", None)
  r = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                     capture_output=True, text=True, timeout=300)
  assert "X64-OFF SMOKE OK" in r.stdout, (r.stdout[-2000:], r.stderr[-2000:])


def test_dryrun_16_virtual_devices():
  """The multi-chip path must scale past the 8-device test mesh (the
  driver may dry-run at other widths)."""
  entry = os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), "__graft_entry__.py")
  script = (
      "import jax\n"
      "jax.config.update('jax_platforms','cpu')\n"
      "import importlib.util\n"
      "spec = importlib.util.spec_from_file_location('__graft_entry__',"
      f" {entry!r})\n"
      "m = importlib.util.module_from_spec(spec)\n"
      "spec.loader.exec_module(m)\n"
      "m.dryrun_multichip(16)\n"
  )
  env = dict(os.environ)
  env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
  r = subprocess.run([sys.executable, "-c", script], env=env,
                     capture_output=True, text=True, timeout=300)
  assert "dryrun_multichip(16)" in r.stdout, (r.stdout[-1500:],
                                              r.stderr[-1500:])
