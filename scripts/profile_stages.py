#!/usr/bin/env python
"""Per-stage profiler for the binned substep: sort / bins / sweeps / gather.

Each stage runs in its own jit with a lax.scan of `reps` iterations and a
data dependency threaded through, so per-call dispatch amortizes.
Usage: python scripts/profile_stages.py [config] [reps]
"""
from __future__ import annotations

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable without PYTHONPATH
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from sph_tpu.app import configs as AC
from sph_tpu.neighbors import binned as B
from sph_tpu.neighbors import binned_sweeps as S
from sph_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

cfg_name = sys.argv[1] if len(sys.argv) > 1 else "default_131k"
reps = int(sys.argv[2]) if len(sys.argv) > 2 else 10

cfg = AC.CONFIGS[cfg_name]
state, params, sim = AC.build(cfg)
dims = sim.grid_dims
cap = sim.cell_capacity
print(f"config={cfg_name} n={state.n} dims={dims} cap={cap} "
      f"cells={np.prod(dims)}", file=sys.stderr)

key = B.compute_keys(state, params, dims)
contrib = state.contrib_mask(params.ghost_face_active)
s = B.sort_state(state, key, contrib)
bins = B.build_bins(s, params, dims, cap)
rho_raw = S.density_sweep(bins, params, dims, cap, True)
rho_p = jnp.maximum(rho_raw, 500.0)
pres_p = jnp.maximum(params.gas_constant * (rho_p - params.rest_density), 0.0)
rho_pad = S.pad_plane(rho_p, dims, 1.0)
pres_pad = S.pad_plane(pres_p, dims)


def timed(name, fn, *args):
    f = jax.jit(fn)
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    dt = (time.perf_counter() - t0) / reps * 1e3
    print(f"{name:24s} {dt:8.2f} ms/iter")
    return dt


def scan_sort(st, k, c):
    def body(carry, _):
        ss = B.sort_state(st, k + carry, c)
        return carry + (ss.rank[0] % 1), ss.pos[0, 0]
    return lax.scan(body, jnp.int32(0), None, length=reps)


def scan_keys(st):
    def body(carry, _):
        kk = B.compute_keys(st.replace(pos=st.pos + carry), params, dims)
        return carry + kk[0].astype(jnp.float32) * 1e-20, None
    return lax.scan(body, jnp.float32(0), None, length=reps)


def scan_bins(ss):
    def body(carry, _):
        bb = B.build_bins(ss._replace(rank=ss.rank + carry), params, dims, cap)
        return carry + (bb.overflow % 1), bb.px[0, 0, 0]
    return lax.scan(body, jnp.int32(0), None, length=reps)


def scan_density(bb):
    def body(carry, _):
        rr = S.density_sweep(bb._replace(px=bb.px + carry), params, dims, cap, True)
        return carry + rr[0, 0, 0] * 1e-20, None
    return lax.scan(body, jnp.float32(0), None, length=reps)


def scan_force(bb):
    def body(carry, _):
        out = S.force_sweep(bb._replace(px=bb.px + carry), rho_p, pres_p,
                            rho_pad, pres_pad, params, dims, cap, True)
        return carry + out[0][0, 0, 0] * 1e-20, None
    return lax.scan(body, jnp.float32(0), None, length=reps)


def scan_xsph(bb):
    npx = S.center(bb.px, dims)
    npy = S.center(bb.py, dims)
    npz = S.center(bb.pz, dims)
    nvx = S.center(bb.vx, dims)
    nvy = S.center(bb.vy, dims)
    nvz = S.center(bb.vz, dims)

    def body(carry, _):
        out = S.xsph_sweep(bb._replace(px=bb.px + carry), rho_pad,
                           npx, npy, npz, nvx, nvy, nvz, params, dims, cap, True)
        return carry + out[0][0, 0, 0] * 1e-20, None
    return lax.scan(body, jnp.float32(0), None, length=reps)


def scan_gather(ss):
    num_cells = int(np.prod(dims))
    results = jnp.stack([rho_p] * 11, axis=0)
    flat = results.reshape(11, cap * num_cells).T

    def body(carry, _):
        pslot = jnp.minimum(ss.rank + carry, cap - 1) * num_cells + jnp.minimum(
            ss.key, num_cells - 1)
        pp = flat[pslot]
        return carry + (pp[0, 0] * 1e-20).astype(jnp.int32), pp[0, 0]
    return lax.scan(body, jnp.int32(0), None, length=reps)


t_keys = timed("compute_keys", scan_keys, state)
t_sort = timed("sort(14 ops)", scan_sort, state, key, contrib)
t_bins = timed("build_bins(scatter)", scan_bins, s)
t_den = timed("density_sweep", scan_density, bins)
t_for = timed("force_sweep", scan_force, bins)
t_xsph = timed("xsph_sweep", scan_xsph, bins)
t_gat = timed("gather_back", scan_gather, s)
total = t_keys + t_sort + t_bins + t_den + t_for + t_xsph + t_gat
print(f"{'TOTAL (sum)':24s} {total:8.2f} ms")
