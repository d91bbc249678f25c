"""Engine step composition: the equivalent of the reference's ``DispatchCompute``.

The reference's per-substep GPU pipeline (``SPHFluid3D.cpp:359-450``):

    ComputeGridExtents -> ClearGrid -> BuildGrid -> SPHFluid ->
    OBBConstraints -> [river: Terrain, Channel, StreamEmit] -> [Fountain]

collapses here into one pure function ``substep(state, params, buffers, dt)``
whose stage ordering is enforced by XLA dataflow — every
``glMemoryBarrier`` becomes free.  Frames run a fixed-dt substep loop
(mirroring ``Scene0p.cpp:1321-1333``) as a ``lax.scan`` with a static
substep count, so each (config, n_substeps) pair compiles once.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from sph_tpu.core.params import FluidParams, SimConfig
from sph_tpu.core.state import ParticleState
from sph_tpu.physics import brute_force, cell_solver, constraints, emitters
from sph_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
class SceneBuffers:
    """Auxiliary device buffers owned by the scene (terrain SSBO, stencil
    targets SSBO, fountain RNG counter — reference bindings 5 and 7)."""
    terrain: jax.Array          # [H,W] f32 heightfield (zeros when unused)
    stencil_targets: jax.Array  # [S,3] f32 (S = config.stencil_capacity or 1)
    stencil_count: jax.Array    # [] i32
    fountain_seed: jax.Array    # [] u32, advances per fountain dispatch
    overflow: jax.Array         # [] i32 most rows past cell_capacity in
                                # any substep since create (0 = exact)

    @classmethod
    def create(cls, config: SimConfig) -> "SceneBuffers":
        th, tw = config.terrain_res
        s = max(1, config.stencil_capacity)
        return cls(
            terrain=jnp.zeros((th, tw), jnp.float32),
            stencil_targets=jnp.zeros((s, 3), jnp.float32),
            stencil_count=jnp.zeros((), jnp.int32),
            fountain_seed=jnp.zeros((), jnp.uint32),
            overflow=jnp.zeros((), jnp.int32),
        )


def sph_solve(state: ParticleState, params: FluidParams, dt: jax.Array,
              config: SimConfig) -> Tuple[ParticleState, jax.Array]:
    """The SPH force/integrate stage with the configured neighbor engine.

    Returns the new state and the number of rows past ``cell_capacity``
    (always 0 for the all-pairs engines).  The cell engine leaves such
    rows out as neighbor sources and the binned engine moves them
    ballistically, so any nonzero count means inexact physics."""
    exact = jnp.zeros((), jnp.int32)
    if config.neighbor_impl == "brute":
        return brute_force.substep(state, params, dt), exact
    if config.neighbor_impl == "brute_pallas":
        from sph_tpu.physics import brute_pallas
        return brute_pallas.substep(state, params, dt), exact
    if config.neighbor_impl == "cell":
        return cell_solver.substep(state, params, dt, config)
    if config.neighbor_impl == "binned":
        from sph_tpu.neighbors import binned
        return binned.substep(state, params, dt, config)
    raise ValueError(f"unknown neighbor_impl: {config.neighbor_impl}")


def substep(state: ParticleState, params: FluidParams, buffers: SceneBuffers,
            dt: jax.Array, config: SimConfig
            ) -> Tuple[ParticleState, SceneBuffers]:
    """One full substep: solve -> container -> river -> fountain."""
    state, overflow = sph_solve(state, params, dt, config)
    buffers = buffers.replace(
        overflow=jnp.maximum(buffers.overflow, overflow))
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


@functools.partial(jax.jit, static_argnames=("n_substeps", "config"))
def run_substeps(state: ParticleState, params: FluidParams,
                 buffers: SceneBuffers, dt: jax.Array, n_substeps: int,
                 config: SimConfig) -> Tuple[ParticleState, SceneBuffers]:
    """``n_substeps`` fixed-dt substeps under one jit (lax.scan)."""
    def body(carry, _):
        st, buf = carry
        st, buf = substep(st, params, buf, dt, config)
        return (st, buf), None

    (state, buffers), _ = jax.lax.scan(body, (state, buffers), None,
                                       length=n_substeps)
    return state, buffers


def require_exact(buffers: SceneBuffers, where: str = "run") -> None:
    """Raise if any substep since ``buffers`` was created left rows past
    ``cell_capacity`` (inexact neighbor sums); see :func:`sph_solve`."""
    overflow = int(buffers.overflow)
    if overflow:
        raise RuntimeError(
            f"{where}: {overflow} rows overflowed cell_capacity in some "
            f"substep; their neighbor sums were inexact (raise "
            f"cell_capacity)")


def substeps_for_frame(frame_dt: float, dt: float, max_substeps: int,
                       accumulator: float) -> Tuple[int, float]:
    """Host-side fixed-timestep accumulator (``Scene0p.cpp:1321-1333``):
    consume whole ``dt`` steps from ``accumulator + frame_dt``, capped."""
    acc = accumulator + frame_dt
    n = 0
    while acc >= dt and n < max_substeps:
        acc -= dt
        n += 1
    return n, acc
