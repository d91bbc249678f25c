"""Multi-chip particle parallelism over a ``jax.sharding.Mesh``.

A genuinely new capability versus the single-GPU reference (SURVEY.md
§2.4): the particle axis is sharded across devices with ``shard_map``, and
neighbor information crosses devices through XLA collectives (NCCL
between GPUs) in place of the reference's single-device
``glMemoryBarrier`` pipeline.

Round-1 engine: *gather parallelism* — every device owns N/D particles,
``all_gather``s the (much smaller) per-particle fields it needs for the
three neighbor sweeps, and computes its shard's density/forces/XSPH with
the brute-force pair sweeps.  This is exactly correct for any particle
configuration (no halo assumptions) and is how the dry-run validates the
full step over a virtual mesh.  Spatial slab decomposition with
``ppermute`` halo exchange is the planned upgrade for large N.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from sph_tpu.core.params import FluidParams, SimConfig
from sph_tpu.core.state import ParticleState
from sph_tpu.engine.step import SceneBuffers
from sph_tpu.physics import brute_force as BF
from sph_tpu.physics import common as C
from sph_tpu.physics import constraints, emitters

AXIS = "shard"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, axis_names=(AXIS,))


def shard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """Place the particle axis across the mesh (pos[N,3] -> PS('shard'))."""
    def put(x):
        spec = PS(AXIS) if x.ndim >= 1 else PS()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, state)


def _sharded_substep_body(state: ParticleState, params: FluidParams,
                          buffers: SceneBuffers, dt: jax.Array,
                          config: SimConfig) -> Tuple[ParticleState, SceneBuffers]:
    """Per-device body: local shard vs all-gathered neighbor arrays."""
    shard_n = state.n
    my = lax.axis_index(AXIS)
    ids_i = my * shard_n + jnp.arange(shard_n, dtype=jnp.int32)
    n_dev = lax.axis_size(AXIS)
    ids_j = jnp.arange(n_dev * shard_n, dtype=jnp.int32)

    contrib_i = state.contrib_mask(params.ghost_face_active)
    fluid = state.fluid_mask()

    # Neighbor sweep 1: density needs gathered positions + contrib.
    pos_all = lax.all_gather(state.pos, AXIS, tiled=True)
    vel_all = lax.all_gather(state.vel, AXIS, tiled=True)
    contrib_all = lax.all_gather(contrib_i, AXIS, tiled=True)

    rho_raw = BF.density_pass(state.pos, pos_all, contrib_all, params)
    density, pressure = C.finish_density(
        rho_raw, state.ghost, contrib_i, state.density, state.pressure, params)

    # Sweep 2 needs *fresh* neighbor density/pressure -> second collective.
    rho_all = lax.all_gather(density, AXIS, tiled=True)
    pres_all = lax.all_gather(pressure, AXIS, tiled=True)

    accum = BF.force_pass(state.pos, state.vel, pressure, ids_i,
                          pos_all, vel_all, rho_all, pres_all, contrib_all,
                          ids_j, params)
    acc = C.assemble_acc(accum, density, params)
    new_pos, new_vel = C.integrate(state.pos, state.vel, acc, dt)

    # Sweep 3: XSPH vs stale (pre-substep) gathered pos/vel.
    xsph_sum, xsph_norm = BF.xsph_pass(new_pos, new_vel, ids_i,
                                       pos_all, vel_all, rho_all,
                                       contrib_all, ids_j, params)
    new_vel = C.apply_xsph(new_vel, xsph_sum, xsph_norm)
    new_vel = C.speed_cap(new_vel, params.h, dt)
    foam = C.foam_update(state.foam, new_vel, density, params)

    ghost_on = contrib_i & (state.ghost > 0)
    state = state.replace(
        pos=C.select_updated(fluid, new_pos, state.pos),
        vel=jnp.where(ghost_on[:, None], 0.0,
                      C.select_updated(fluid, new_vel, state.vel)),
        acc=jnp.where(ghost_on[:, None], 0.0,
                      C.select_updated(fluid, acc, state.acc)),
        density=density,
        pressure=pressure,
        foam=C.select_updated(fluid, foam, state.foam),
    )

    # Constraints / modes are pointwise -> shard with no collectives.
    state = constraints.apply_container(state, params)
    if config.river_mode:
        state = constraints.apply_terrain(state, buffers.terrain, params)
        state = constraints.apply_channel(state, params, dt)
        state = emitters.stream_emit(state, params)
    if config.fountain_mode and not config.river_mode:
        state = emitters.fountain_recycle(state, params, dt,
                                          buffers.fountain_seed)
        buffers = buffers.replace(
            fountain_seed=buffers.fountain_seed + jnp.uint32(1))
    return state, buffers


def make_sharded_substep(mesh: Mesh, config: SimConfig):
    """Build a jitted multi-chip substep: state sharded on the particle
    axis, params/buffers replicated, collectives between devices."""
    state_spec = jax.tree_util.tree_map(lambda _: PS(AXIS),
                                        ParticleState.zeros(1))
    rep = PS()

    body = functools.partial(_sharded_substep_body, config=config)
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(state_spec,
                  jax.tree_util.tree_map(lambda _: rep, FluidParams.default()),
                  jax.tree_util.tree_map(lambda _: rep,
                                         SceneBuffers.create(config)),
                  rep),
        out_specs=(state_spec,
                   jax.tree_util.tree_map(lambda _: rep,
                                          SceneBuffers.create(config))),
        check_vma=False,
    )
    return jax.jit(mapped)
