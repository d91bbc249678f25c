"""Dense binned-plane neighbor engine: a cell list without per-neighbor gathers.

The gather cell list (``physics/cell_solver.py``) reads every neighbor
slot through a row gather.  This engine restructures the whole substep so
the hot loops touch memory only through dense elementwise ops and slices
(on the GPU it measured 10-23x slower than the gather engine, PERF.md; it
stays as the local engine of the multi-device slab decomposition,
``parallel/slabs.py``):

1.  ``lax.sort`` with the cell key + all per-particle fields as payload
    operands (no permutation gathers).
2.  Per-cell rank from the sorted keys via ``associative_scan`` (no
    searchsorted, no gathers).
3.  ONE packed row scatter places each particle's fields into its unique
    slot of a dense [C, K] bin table (slot = key*K + rank, ascending and
    unique).
4.  The bins reshape into field planes ``[K, rows, x]`` where
    rows = y + ny*z (sublane-tiled) and x is the lane dimension, each
    halo-padded with a far-away sentinel position.  A neighbor-cell
    offset (dx, dy, dz) is then a plain slice: (dy, dz) land on the
    untiled rows axis (free strided addressing) and dx = +-1 is the
    cheapest possible lane shift.  The sweeps (``binned_sweeps.py``) are
    pure VPU math; empty slots and masked sources sit at the sentinel so
    the r^2 < h^2 test eliminates them with no flag traffic.
5.  ONE row gather brings per-slot results back to particle order.

Physics semantics match ``physics/brute_force.py`` (the oracle) exactly;
see ``physics/common.py`` for the shared pair math.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sph_tpu.core.params import FluidParams, SimConfig, grid_min as grid_min_fn
from sph_tpu.core.state import ParticleState
from sph_tpu.neighbors import binned_sweeps as S
from sph_tpu.physics import common as C

SENTINEL_POS = 1.0e7   # farther than any container; r^2 masks kill such pairs


class SortedState(NamedTuple):
    key: jax.Array        # [N] i32 cell key (num_cells for padding), ascending
    rank: jax.Array       # [N] i32 index within cell segment
    pos: jax.Array        # [N,3]
    vel: jax.Array        # [N,3]
    density: jax.Array    # [N]
    pressure: jax.Array   # [N]
    foam: jax.Array       # [N]
    flags: jax.Array      # [N] i32: ghost | active<<1 | valid<<2 | contrib<<3
    color_group: jax.Array  # [N] i32
    face: jax.Array       # [N] i32
    orig_id: jax.Array    # [N] i32 spawn identity


def compute_keys(state: ParticleState, params: FluidParams,
                 dims: Tuple[int, int, int]) -> jax.Array:
    from sph_tpu.core.params import grid_cell_coords
    nx, ny, nz = dims
    c = grid_cell_coords(state.pos, params, dims)
    key = c[:, 0] + nx * (c[:, 1] + ny * c[:, 2])
    return jnp.where(state.valid > 0, key, nx * ny * nz)


def sort_state(state: ParticleState, key: jax.Array,
               contrib: jax.Array) -> SortedState:
    """Multi-operand stable sort by cell key — the BuildGrid analogue.

    ``contrib`` is the per-particle neighbor-source mask (ghost-face
    activation folded in); it rides along as flag bit 3.
    """
    n = state.n
    packed = (state.ghost & 1) | ((state.active & 1) << 1) \
        | ((state.valid & 1) << 2) | (contrib.astype(jnp.int32) << 3)
    ops = lax.sort(
        (key,
         state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
         state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
         state.density, state.pressure, state.foam,
         packed, state.color_group, state.face, state.orig_id),
        dimension=0, num_keys=1, is_stable=True)
    (skey, px, py, pz, vx, vy, vz, rho, pres, foam,
     pflags, cg, face, oid) = ops

    # Rank within each equal-key segment: latest boundary via running max.
    iota = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([
        jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    seg_start = lax.associative_scan(jnp.maximum,
                                     jnp.where(is_start, iota, 0))
    rank = iota - seg_start

    return SortedState(
        key=skey, rank=rank,
        pos=jnp.stack([px, py, pz], -1), vel=jnp.stack([vx, vy, vz], -1),
        density=rho, pressure=pres, foam=foam,
        flags=pflags, color_group=cg, face=face, orig_id=oid)


def to_particle_state(s: SortedState) -> ParticleState:
    return ParticleState(
        pos=s.pos, vel=s.vel, acc=jnp.zeros_like(s.pos),
        density=s.density, pressure=s.pressure, foam=s.foam,
        ghost=s.flags & 1, active=(s.flags >> 1) & 1,
        face=s.face, color_group=s.color_group,
        valid=(s.flags >> 2) & 1, orig_id=s.orig_id)


class Bins(NamedTuple):
    """Field planes [K, RP, LX]: RP = rows + 2*(ny+1), LX = nx + 2.
    Cell (x, y, z) lives at [k, HR + y + ny*z, 1 + x]."""
    px: jax.Array
    py: jax.Array
    pz: jax.Array
    vx: jax.Array
    vy: jax.Array
    vz: jax.Array
    ghost_on: jax.Array   # 1.0 where the slot holds a contributing ghost
    in_bin: jax.Array     # [N] bool — rank < K
    overflow: jax.Array   # [] i32


def build_bins(s: SortedState, params: FluidParams,
               dims: Tuple[int, int, int], cap: int) -> Bins:
    """One packed scatter + reshape/pad -> sentinel-padded field planes."""
    nx, ny, nz = dims
    num_cells = nx * ny * nz
    rows = ny * nz
    n = s.key.shape[0]

    ghost = (s.flags & 1) > 0
    valid = ((s.flags >> 2) & 1) > 0
    contrib = ((s.flags >> 3) & 1) > 0

    in_bin = (s.rank < cap) & (s.key < num_cells)
    # Ascending unique slots; overflow/padding -> drop row num_cells*cap.
    slot = jnp.where(in_bin, s.key * cap + s.rank, num_cells * cap)

    # Sources that must not contribute sit at the sentinel.
    src_pos = jnp.where(contrib[:, None], s.pos, SENTINEL_POS)
    packed = jnp.concatenate([
        src_pos, s.vel,
        (contrib & ghost).astype(jnp.float32)[:, None],
        jnp.zeros((n, 1), jnp.float32),
    ], axis=1)                                           # [N, 8]

    table = jnp.concatenate([
        jnp.full((num_cells * cap + 1, 3), SENTINEL_POS, jnp.float32),
        jnp.zeros((num_cells * cap + 1, 5), jnp.float32)], axis=1)
    table = table.at[slot].set(packed, mode="drop", unique_indices=True)
    table = table[:num_cells * cap]                      # drop the spill row

    # [C*K, 8] -> [C, K, 8] -> [8, K, C] -> [8, K, rows, nx] -> halo pads.
    planes = jnp.transpose(table.reshape(num_cells, cap, 8), (2, 1, 0))
    planes = planes.reshape(8, cap, rows, nx)

    overflow = jnp.sum(((s.rank >= cap) & (s.key < num_cells)
                        & valid).astype(jnp.int32))
    return Bins(
        px=S.pad_plane(planes[0], dims, SENTINEL_POS),
        py=S.pad_plane(planes[1], dims, SENTINEL_POS),
        pz=S.pad_plane(planes[2], dims, SENTINEL_POS),
        vx=S.pad_plane(planes[3], dims),
        vy=S.pad_plane(planes[4], dims),
        vz=S.pad_plane(planes[5], dims),
        ghost_on=S.pad_plane(planes[6], dims),
        in_bin=in_bin, overflow=overflow)


def substep(state: ParticleState, params: FluidParams, dt: jax.Array,
            config: SimConfig) -> Tuple[ParticleState, jax.Array]:
    """Full binned-plane substep. Returns the state in SORTED order
    (particle identity lives in spawn order via orig_id) and the count of
    rows past ``cell_capacity``, which moved ballistically."""
    dims = config.grid_dims
    cap = config.cell_capacity
    unroll = config.sweep_unroll

    key = compute_keys(state, params, dims)
    s = sort_state(state, key,
                   state.contrib_mask(params.ghost_face_active))
    bins = build_bins(s, params, dims, cap)
    return (solve_from_bins(s, bins, params, dims, cap, unroll, dt),
            bins.overflow)


def solve_from_bins(s: SortedState, bins: Bins, params: FluidParams,
                    dims: Tuple[int, int, int], cap: int, unroll: bool,
                    dt: jax.Array, rho_halo_fix=None) -> ParticleState:
    """Sweeps + integration + reassembly from pre-built bins.  Split out
    so the multi-chip slab engine (``parallel/slabs.py``) can run it on
    LOCAL bins whose halo rows were filled by ppermute exchange.

    ``rho_halo_fix(rho_pad, pres_pad) -> (rho_pad, pres_pad)``: hook for
    that engine to fill the halo rows of the density/pressure planes with
    the neighbor slabs' edge values before the force sweep (single-device
    halo cells hold no particles, so the default pad values never pair).
    """
    num_cells = int(np.prod(dims))

    # --- density (plane layout) ---
    rho_raw = S.density_sweep(bins, params, dims, cap, unroll)
    rho0 = params.rest_density
    rho_p = jnp.maximum(rho_raw, C.DENSITY_FLOOR_FRAC * rho0)
    pres_p = jnp.maximum(params.gas_constant * (rho_p - rho0), 0.0)
    g_on = S.center(bins.ghost_on, dims) > 0.0
    rho_p = jnp.where(g_on, rho0, rho_p)
    pres_p = jnp.where(g_on, 0.0, pres_p)
    rho_pad = S.pad_plane(rho_p, dims, 1.0)
    pres_pad = S.pad_plane(pres_p, dims)
    if rho_halo_fix is not None:
        rho_pad, pres_pad = rho_halo_fix(rho_pad, pres_pad)

    # --- force sweep + acc assembly (SPHFluid.comp:156-166) ---
    fx, fy, fz, gcx, gcy, gcz, lc = S.force_sweep(
        bins, rho_p, pres_p, rho_pad, pres_pad, params, dims, cap, unroll)
    glen = jnp.sqrt(gcx * gcx + gcy * gcy + gcz * gcz)
    st_mag = jnp.where(glen > C.SURFACE_THRESHOLD,
                       -params.surface_tension * lc / jnp.maximum(glen, 1e-30),
                       0.0)
    rho_safe = jnp.maximum(rho_p, 1e-12)
    ax = (fx + st_mag * gcx + params.gravity[0] * rho_p) / rho_safe
    ay = (fy + st_mag * gcy + params.gravity[1] * rho_p) / rho_safe
    az = (fz + st_mag * gcz + params.gravity[2] * rho_p) / rho_safe

    # --- integrate (SPHFluid.comp:169-171) ---
    cvx = S.center(bins.vx, dims)
    cvy = S.center(bins.vy, dims)
    cvz = S.center(bins.vz, dims)
    nvx = (cvx + ax * dt) * C.VELOCITY_DAMPING
    nvy = (cvy + ay * dt) * C.VELOCITY_DAMPING
    nvz = (cvz + az * dt) * C.VELOCITY_DAMPING
    npx = S.center(bins.px, dims) + nvx * dt
    npy = S.center(bins.py, dims) + nvy * dt
    npz = S.center(bins.pz, dims) + nvz * dt

    # --- XSPH + speed cap ---
    xx, xy, xz, norm = S.xsph_sweep(bins, rho_pad, npx, npy, npz,
                                    nvx, nvy, nvz, params, dims, cap, unroll)
    inv = jnp.where(norm > 0.0, C.XSPH_COEFF / jnp.maximum(norm, 1e-30), 0.0)
    nvx = nvx + inv * xx
    nvy = nvy + inv * xy
    nvz = nvz + inv * xz
    max_speed = C.CFL_FRACTION * params.h / jnp.maximum(dt, 1e-6)
    sp = jnp.sqrt(nvx * nvx + nvy * nvy + nvz * nvz)
    scale = jnp.where(sp > max_speed, max_speed / jnp.maximum(sp, 1e-30), 1.0)
    nvx, nvy, nvz = nvx * scale, nvy * scale, nvz * scale

    # --- one row gather back to (sorted) particle order ---
    results = jnp.stack([npx, npy, npz, nvx, nvy, nvz, ax, ay, az,
                         rho_p, pres_p], axis=0)       # [11, K, rows, nx]
    flat = results.reshape(11, cap * num_cells).T      # [K*C, 11]
    pslot = jnp.minimum(s.rank, cap - 1) * num_cells + jnp.minimum(
        s.key, num_cells - 1)
    per_particle = flat[pslot]                          # [N, 11] one row gather

    new_pos = per_particle[:, 0:3]
    new_vel = per_particle[:, 3:6]
    new_acc = per_particle[:, 6:9]
    new_rho = per_particle[:, 9]
    new_pres = per_particle[:, 10]

    st = to_particle_state(s)
    contrib = st.contrib_mask(params.ghost_face_active)
    fluid = st.fluid_mask() & bins.in_bin

    # Overflowed fluid particles (rank >= K) fall back to a gravity-only
    # update so they keep moving instead of freezing (graceful degradation;
    # counted in bins.overflow for observability).
    ofl = st.fluid_mask() & ~bins.in_bin
    acc_g = jnp.broadcast_to(params.gravity[None, :], st.pos.shape)
    vel_g = C.speed_cap((st.vel + acc_g * dt) * C.VELOCITY_DAMPING,
                        params.h, dt)
    pos_g = st.pos + vel_g * dt

    density, pressure = C.finish_density(
        jnp.where(fluid, new_rho, st.density), st.ghost, contrib,
        st.density, st.pressure, params)
    foam = C.foam_update(st.foam, new_vel, density, params)

    ghost_on = contrib & (st.ghost > 0)
    pos = jnp.where(fluid[:, None], new_pos,
                    jnp.where(ofl[:, None], pos_g, st.pos))
    vel = jnp.where(fluid[:, None], new_vel,
                    jnp.where(ofl[:, None], vel_g, st.vel))
    vel = jnp.where(ghost_on[:, None], 0.0, vel)
    acc = jnp.where(fluid[:, None], new_acc,
                    jnp.where(ofl[:, None], acc_g, 0.0))
    acc = jnp.where(ghost_on[:, None], 0.0, acc)

    return st.replace(
        pos=pos, vel=vel, acc=acc,
        density=jnp.where(fluid, density, st.density),
        pressure=jnp.where(fluid, pressure, st.pressure),
        foam=jnp.where(fluid, foam, st.foam),
    )
