"""Multi-chip dry run — executable as ``python -m sph_tpu.parallel.dryrun N``.

Must run in a process where jax has NOT yet initialized a backend (the
caller sets ``JAX_PLATFORMS=cpu`` and
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` in the
environment first).  ``__graft_entry__.dryrun_multichip`` re-execs this
module in a clean subprocess when the live process already holds an
initialized (single-device) backend.

Exercises BOTH sharded engines on an N-device mesh and checks the slab
trajectory against the single-device binned engine:

1. slab domain decomposition (``parallel/slabs.py``) — per-device z-slab
   with ``lax.ppermute`` source/density halos + migration; 5 substeps,
   compared particle-for-particle to ``engine.step.run_substeps``.
2. gather-parallel brute engine (``parallel/domain.py``) — particle-axis
   sharding with ``all_gather`` neighbor exchange (fountain mode on).
"""
from __future__ import annotations

import sys


def run(n_devices: int) -> None:
    import time

    import jax
    import numpy as np

    t_start = time.time()

    def progress(msg: str) -> None:
        # Streamed per-stage progress: if an outer timeout kills the
        # run, the tail shows which stage was live.
        print(f"[dryrun +{time.time() - t_start:6.1f}s] {msg}", flush=True)

    ndev = len(jax.devices())
    if ndev < n_devices:
        raise RuntimeError(
            f"dryrun needs {n_devices} devices, backend has {ndev} "
            f"({jax.devices()[0].platform}); set JAX_PLATFORMS=cpu and "
            f"XLA_FLAGS=--xla_force_host_platform_device_count="
            f"{n_devices} before importing jax")

    from sph_tpu.core.params import (FluidParams, SimConfig,
                                     compute_grid_dims)
    from sph_tpu.core.state import spawn_standard, state_from_spawn
    from sph_tpu.engine.step import SceneBuffers, run_substeps
    from sph_tpu.parallel import domain, slabs

    # --- engine 1: slab decomposition + halo exchange + migration ---
    progress("stage 1: slab binned engine (1024 particles, 5 substeps)")
    half = np.array([7.0, 7.0, 7.0])
    spawn = spawn_standard(1024, seed=0)
    state = state_from_spawn(spawn)
    params = FluidParams.default().derive_mass()
    dims = compute_grid_dims(0, half, np.array([0.0, 0.0, 0.0]), 0.28)
    sim = SimConfig(n=state.n, grid_dims=dims, neighbor_impl="binned")
    mesh = slabs.make_mesh_slabs(n_devices)
    scfg = slabs.make_slab_config(sim, n_devices, state.n)
    st = slabs.shard_by_slab(state, params, scfg, mesh)
    step = slabs.make_slab_substep(mesh, scfg)
    n_sub = 5
    for _ in range(n_sub):
        st = step(st, params, params.dt)
    jax.block_until_ready(st.pos)
    sth = jax.device_get(st)
    assert not bool(np.isnan(np.asarray(sth.pos)).any())
    n_valid = int(np.asarray(sth.valid).sum())
    assert n_valid == int(np.asarray(state.valid).sum())

    # single-device reference trajectory (binned engine, same params)
    buf = SceneBuffers.create(sim)
    ref, buf = run_substeps(state, params, buf, params.dt, n_sub, sim)
    # the binned reference is exact only without capacity overflow
    assert int(buf.overflow) == 0, "binned reference overflowed"
    rvalid = np.asarray(ref.valid) > 0
    svalid = np.asarray(sth.valid) > 0
    ra = np.asarray(ref.pos)[rvalid]
    ra = ra[np.argsort(np.asarray(ref.orig_id)[rvalid], kind="stable")]
    sa = np.asarray(sth.pos)[svalid]
    sa = sa[np.argsort(np.asarray(sth.orig_id)[svalid], kind="stable")]
    err = float(np.abs(ra - sa).max())
    assert err < 1e-4, f"slab trajectory diverged from single-device: {err}"
    progress(f"stage 1 ok (max err {err:.2e})")

    # --- engine 2: gather-parallel brute ---
    progress("stage 2: gather-parallel brute engine")
    pad = 64 * n_devices
    spawn = spawn_standard(pad, seed=0)
    state2 = state_from_spawn(spawn, pad_to=pad)
    sim2 = SimConfig(n=pad, grid_dims=dims, neighbor_impl="brute",
                     fountain_mode=True)
    buffers = SceneBuffers.create(sim2)
    mesh2 = domain.make_mesh(n_devices)
    step2 = domain.make_sharded_substep(mesh2, sim2)
    st2 = domain.shard_state(state2, mesh2)
    st2, buffers = step2(st2, params, buffers, params.dt)
    jax.block_until_ready(st2.pos)
    assert not bool(np.isnan(np.asarray(st2.pos)).any())
    print(f"dryrun_multichip({n_devices}): ok — slab engine "
          f"({n_valid} particles, {n_devices} z-slabs, ppermute halos, "
          f"{n_sub}-substep trajectory matches single-device, "
          f"max err {err:.2e}) + gather engine ({pad} particles)")


if __name__ == "__main__":
    # Set the platform before the first backend use: the caller's
    # environment may name another platform.
    import jax

    from sph_tpu.utils.cache import enable_compile_cache

    _n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", _n)
    enable_compile_cache()
    run(_n)
