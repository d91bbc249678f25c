"""Multi-chip slab decomposition vs the single-device binned engine.

Runs on the virtual 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count); the same code path targets real
multi-GPU meshes.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sph_tpu.core import state as S
from sph_tpu.core.params import (FluidParams, SimConfig, compute_grid_dims,
                                 SHAPE_BOX)
from sph_tpu.engine.step import SceneBuffers, run_substeps
from sph_tpu.parallel import slabs


def _setup(n=2048, half=(6.0, 6.0, 6.0)):
    spawn = S.spawn_standard(n, h=0.28, box_half=half, seed=0)
    state = S.state_from_spawn(spawn)
    params = FluidParams.default(
        box_half=np.asarray(half, np.float32)).derive_mass()
    dims = compute_grid_dims(SHAPE_BOX, half, (0, 0, 0), 0.28)
    sim = SimConfig(n=state.n, grid_dims=dims, neighbor_impl="binned")
    return state, params, sim


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
def test_slab_engine_matches_single_device():
    state, params, sim = _setup()
    n_dev = 4
    mesh = slabs.make_mesh_slabs(n_dev)
    scfg = slabs.make_slab_config(sim, n_dev, state.n)

    # single-device reference
    buf = SceneBuffers.create(sim)
    ref, _ = run_substeps(state, params, buf, params.dt, 5, sim)

    # slab run: note global dims may be padded up to a multiple of n_dev
    st = slabs.shard_by_slab(state, params, scfg, mesh)
    step = slabs.make_slab_substep(mesh, scfg)
    for _ in range(5):
        st = step(st, params, params.dt)
    st = jax.device_get(st)

    rid = np.asarray(ref.orig_id)[np.asarray(ref.valid) > 0]
    rpos = np.asarray(ref.pos)[np.asarray(ref.valid) > 0]
    sid = np.asarray(st.orig_id)[np.asarray(st.valid) > 0]
    spos = np.asarray(st.pos)[np.asarray(st.valid) > 0]
    assert len(sid) == len(rid), "particles lost in migration"
    ra = rpos[np.argsort(rid, kind="stable")]
    sa = spos[np.argsort(sid, kind="stable")]
    err = np.abs(ra - sa).max()
    assert err < 1e-4, f"slab trajectory diverged: {err}"


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
def test_slab_migration_conserves_particles():
    state, params, sim = _setup(n=1024, half=(5.0, 5.0, 5.0))
    n_dev = 4
    mesh = slabs.make_mesh_slabs(n_dev)
    scfg = slabs.make_slab_config(sim, n_dev, state.n)
    st = slabs.shard_by_slab(state, params, scfg, mesh)
    step = slabs.make_slab_substep(mesh, scfg)
    n0 = int(np.asarray(state.valid).sum())
    for _ in range(10):
        st = step(st, params, params.dt)
    sth = jax.device_get(st)
    assert int(np.asarray(sth.valid).sum()) == n0
    assert not np.isnan(np.asarray(sth.pos)).any()
