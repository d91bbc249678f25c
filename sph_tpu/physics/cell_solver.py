"""Cell-list WCSPH solver — vectorized jnp neighbor sweeps over dense bins.

Same physics as ``physics/brute_force.py`` (the oracle), but pairs are
enumerated through the sort-based cell list (``neighbors/grid.py``): for
each of the 27 neighbor-cell offsets, every particle gathers the K bin
slots of that cell and accumulates masked pair terms.  The 27-offset loop
is a ``lax.fori_loop`` over a constant offset table so the compiled graph
stays small; each iteration is a handful of [N,K] gathers + VPU math.

This is the GPU engine of configs 2-5: on an H100 it measured 10-23x
faster than the binned-plane engine at 131k-1M particles (PERF.md).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from sph_tpu.core.params import FluidParams, SimConfig, grid_min as grid_min_fn
from sph_tpu.core.state import ParticleState
from sph_tpu.neighbors import grid as G
from sph_tpu.physics import common as C
from sph_tpu.physics import kernels as K


def _offsets() -> jax.Array:
    return jnp.asarray(G.NEIGHBOR_OFFSETS)


def density_pass(cl: G.CellList, pos, contrib_f, params, dims, capacity):
    """rho_raw via 27 masked [N,K] gathers."""
    n = pos.shape[0]
    h = params.h
    h2 = h * h
    offsets = _offsets()

    def body(o, acc):
        j, mask = G.neighbor_slots(cl, offsets[o], dims, capacity)
        pj = pos[j]                                    # [N,K,3]
        cj = contrib_f[j]
        diff = pos[:, None, :] - pj
        r2 = jnp.sum(diff * diff, axis=-1)
        w = jnp.where(mask & (r2 < h2), K.poly6(r2, h) * cj, 0.0)
        return acc + jnp.sum(w, axis=1)

    acc = lax.fori_loop(0, 27, body, jnp.zeros((n,), jnp.float32))
    return params.mass * acc


def force_pass(cl: G.CellList, pos, vel, density, pressure, contrib_f,
               params, dims, capacity) -> C.ForceAccum:
    n = pos.shape[0]
    h = params.h
    offsets = _offsets()
    idx = jnp.arange(n, dtype=jnp.int32)

    def body(o, carry):
        fp, fv, gc, lc = carry
        j, mask = G.neighbor_slots(cl, offsets[o], dims, capacity)
        pj = pos[j]
        vj = vel[j]
        prj = pressure[j]
        rhoj = density[j]
        cj = contrib_f[j]
        rij = pos[:, None, :] - pj
        r = jnp.sqrt(jnp.sum(rij * rij, axis=-1))
        m = (mask & (idx[:, None] != j) & (r < h)
             & (rhoj > 0.0) & (cj > 0.0))
        dfp, dfv, dgc, dlc = C.pair_force_terms(
            rij, r, vel[:, None, :], vj, pressure[:, None], prj, rhoj,
            h, params.mass, m)
        return (fp + dfp.sum(1), fv + dfv.sum(1),
                gc + dgc.sum(1), lc + dlc.sum(1))

    z3 = jnp.zeros((n, 3), jnp.float32)
    z1 = jnp.zeros((n,), jnp.float32)
    fp, fv, gc, lc = lax.fori_loop(0, 27, body, (z3, z3, z3, z1))
    return C.ForceAccum(fp, fv, gc, lc)


def xsph_pass(cl: G.CellList, new_pos, new_vel, old_pos, old_vel, density,
              contrib_f, params, dims, capacity):
    n = new_pos.shape[0]
    h = params.h
    h2 = h * h
    offsets = _offsets()
    idx = jnp.arange(n, dtype=jnp.int32)

    def body(o, carry):
        s, norm = carry
        j, mask = G.neighbor_slots(cl, offsets[o], dims, capacity)
        pj = old_pos[j]
        vj = old_vel[j]
        rhoj = density[j]
        cj = contrib_f[j]
        diff = new_pos[:, None, :] - pj
        r2 = jnp.sum(diff * diff, axis=-1)
        m = mask & (idx[:, None] != j) & (r2 < h2) & (rhoj > 0.0) & (cj > 0.0)
        w = jnp.where(m, K.poly6(r2, h), 0.0)
        mw = w * params.mass / jnp.maximum(rhoj, 1e-12)
        s = s + jnp.sum((vj - new_vel[:, None, :]) * mw[..., None], axis=1)
        return s, norm + jnp.sum(w, axis=1)

    z3 = jnp.zeros((n, 3), jnp.float32)
    z1 = jnp.zeros((n,), jnp.float32)
    return lax.fori_loop(0, 27, body, (z3, z1))


def substep(state: ParticleState, params: FluidParams, dt: jax.Array,
            config: SimConfig) -> Tuple[ParticleState, jax.Array]:
    """One WCSPH substep with cell-list neighbor enumeration.

    Returns the new state and the count of rows past ``cell_capacity``;
    those rows are still updated but are no neighbor source."""
    dims = config.grid_dims
    cap = config.cell_capacity
    from sph_tpu.core.params import grid_cell_coords
    coords = grid_cell_coords(state.pos, params, dims)
    cl = G.build_cell_list(state.pos, state.valid, grid_min_fn(params),
                           params.h, dims, cap, coords=coords)

    contrib = state.contrib_mask(params.ghost_face_active)
    contrib_f = contrib.astype(jnp.float32)
    fluid = state.fluid_mask()

    rho_raw = density_pass(cl, state.pos, contrib_f, params, dims, cap)
    density, pressure = C.finish_density(
        rho_raw, state.ghost, contrib, state.density, state.pressure, params)

    accum = force_pass(cl, state.pos, state.vel, density, pressure,
                       contrib_f, params, dims, cap)
    acc = C.assemble_acc(accum, density, params)
    new_pos, new_vel = C.integrate(state.pos, state.vel, acc, dt)

    xsph_sum, xsph_norm = xsph_pass(cl, new_pos, new_vel, state.pos, state.vel,
                                    density, contrib_f, params, dims, cap)
    new_vel = C.apply_xsph(new_vel, xsph_sum, xsph_norm)
    new_vel = C.speed_cap(new_vel, params.h, dt)
    foam = C.foam_update(state.foam, new_vel, density, params)

    ghost_on = contrib & (state.ghost > 0)
    return state.replace(
        pos=C.select_updated(fluid, new_pos, state.pos),
        vel=jnp.where(ghost_on[:, None], 0.0,
                      C.select_updated(fluid, new_vel, state.vel)),
        acc=jnp.where(ghost_on[:, None], 0.0,
                      C.select_updated(fluid, acc, state.acc)),
        density=density,
        pressure=pressure,
        foam=C.select_updated(fluid, foam, state.foam),
    ), cl.overflow
