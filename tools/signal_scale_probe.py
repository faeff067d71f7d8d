"""At-scale chip rows for the r5 signal/integrate paths.

Measures (slope method where applicable; honest wall where the program
is one dispatch):
1. batched lfilter: butter(4) over (1024, 65536) f32 — one lax.scan of
   65536 steps carrying a (4, 1024) state; vs scipy host wall.
2. fused RK45 solve_ivp on a 256-dim linear system.
3. device differential_evolution, 2-D multimodal, popsize 15.

Run (from the repo root): PYTHONPATH=. python tools/signal_scale_probe.py
"""
import time

import numpy as np

import spartan_tpu as sp

sp.initialize(["--log_level=30"])
import jax
print("device:", jax.devices()[0].device_kind, flush=True)

import scipy.signal as ss

B, N = 1024, 65536
rng = np.random.default_rng(0)
x = rng.standard_normal((B, N)).astype(np.float32)
b, a = ss.butter(4, 0.1)

t0 = time.time()
y = sp.signal.lfilter(b, a, x, axis=1)
y1 = np.asarray(sp.lazify(y).glom())
t_cold = time.time() - t0

t0 = time.time()
y2 = float(np.asarray(sp.sum(sp.signal.lfilter(b, a, sp.Val(x),
                                               axis=1)).glom()))
t_warm = time.time() - t0

t0 = time.time()
yh = ss.lfilter(b, a, x.astype(np.float64), axis=1)
t_host = time.time() - t0
err = np.abs(y1 - yh).max()
rate = B * N / t_warm / 1e6
print(f"1. batched lfilter (1024x65536 f32): cold {t_cold:.2f}s warm "
      f"{t_warm:.2f}s = {rate:.0f} Msamp/s; scipy host {t_host:.2f}s "
      f"({B*N/t_host/1e6:.0f} Msamp/s); err={err:.2e}", flush=True)

# 2. solve_ivp: 256-dim stable linear system
import jax.numpy as jnp
n = 256
A = (rng.standard_normal((n, n)) * 0.1 - 2.0 * np.eye(n)).astype(
    np.float32)
Aj = jnp.asarray(A)
y0 = np.ones(n, np.float32)
te = np.linspace(0, 2.0, 9)
t0 = time.time()
res = sp.integrate.solve_ivp(lambda t, y: Aj @ y, (0, 2.0), y0,
                             t_eval=te, rtol=1e-6, atol=1e-8)
t_ivp_cold = time.time() - t0
t0 = time.time()
res = sp.integrate.solve_ivp(lambda t, y: Aj @ y, (0, 2.0), y0,
                             t_eval=te, rtol=1e-6, atol=1e-8)
t_ivp = time.time() - t0
import scipy.linalg as sla
want = sla.expm(2.0 * A.astype(np.float64)) @ y0
err_ivp = np.abs(res.y[:, -1] - want).max() / np.abs(want).max()
nsteps = res.nfev // 7
print(f"2. solve_ivp RK45 (n=256 linear, rtol 1e-6): cold "
      f"{t_ivp_cold:.2f}s warm {t_ivp:.2f}s, {nsteps} steps = "
      f"{nsteps/t_ivp:.0f} steps/s, rel err={err_ivp:.2e}", flush=True)

# 3. differential evolution, device population loop
f = lambda p: ((p[0] - jnp.pi) ** 2 + (p[1] - 2.0) ** 2
               + 2.0 * jnp.sin(5 * p[0]) ** 2 * jnp.sin(3 * p[1]) ** 2)
t0 = time.time()
de = sp.optimize.differential_evolution(f, [(0, 6), (0, 6)], seed=1,
                                        tol=1e-8, maxiter=400)
t_de_cold = time.time() - t0
t0 = time.time()
de = sp.optimize.differential_evolution(f, [(0, 6), (0, 6)], seed=1,
                                        tol=1e-8, maxiter=400)
t_de = time.time() - t0
print(f"3. device DE (2-D, pop 30, {de.nit} gens): cold "
      f"{t_de_cold:.2f}s warm {t_de:.2f}s, fun={de.fun:.2e} "
      f"x_err={np.abs(de.x - [np.pi, 2.0]).max():.2e}", flush=True)
print("DONE", flush=True)
