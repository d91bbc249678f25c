"""Multi-chip slab domain decomposition — the scaled neighbor engine.

Upgrade over ``parallel/domain.py``'s gather-parallel engine (which
all-gathers every particle): the grid's z axis is split into contiguous
slabs, one per device.  Each device owns ONLY the particles inside its
slab and runs the full binned-plane substep (``neighbors/binned.py``)
on its local grid; neighbor information crosses chips as TWO small
``lax.ppermute`` exchanges (NCCL between GPUs):

1. **source halo** — after local binning, each device sends its edge
   z-row plane blocks (``[8, K, ny, LX]`` per direction: pos/vel/ghost
   fields) to its slab neighbors, which write them into the sentinel
   halo rows of their local planes.  The 27-offset sweeps then see
   cross-slab pairs exactly as intra-slab ones.
2. **density halo** — the force/XSPH sweeps need neighbor *density*, so
   the per-slot rho/pressure planes exchange edge blocks the same way.

After integration + constraints, **migration** moves particles whose
new cell left the slab: leavers are packed to fixed-capacity buffers by
a direction-keyed sort (no gathers), shipped with two more ppermutes,
and merged into free slots by a validity-keyed sort.  The CFL speed cap
(0.4 h/substep, ``SPHFluid.comp:203-207``) guarantees a particle moves
at most one cell per substep, so one-slab-over migration is exact.

Within a slab the bin layout (sorted order, per-cell ranks) is identical
to the single-device run, so pair-sum order — and therefore the f32
trajectory — matches the single-device binned engine bit-for-bit until
a migration reorders a cell's residents.

Scope: container-constraint scenes (the bench configs). River/fountain
emitters recycle particles ACROSS slabs (a respawn teleports a particle
to the emitter's slab), which the migration step does not route yet —
use ``parallel/domain.py``'s gather-parallel engine for those modes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from sph_tpu.core.params import FluidParams, SimConfig, grid_min as grid_min_fn
from sph_tpu.core.state import ParticleState
from sph_tpu.neighbors import binned as B
from sph_tpu.neighbors import binned_sweeps as BS
from sph_tpu.physics import constraints

AXIS = "shard"

# Integer fields ride through migration as one packed int32 per row:
# orig_id[0:22] ghost[22] active[23] valid[24] face+1[26:29] color_group[29]
_OID_MASK = (1 << 22) - 1


def _pack_meta(state: ParticleState) -> jax.Array:
    return ((state.orig_id & _OID_MASK)
            | ((state.ghost & 1) << 22)
            | ((state.active & 1) << 23)
            | ((state.valid & 1) << 24)
            | (((jnp.clip(state.face, -1, 5) + 1) & 7) << 26)
            | ((state.color_group & 1) << 29))


def _unpack_meta(meta: jax.Array) -> dict:
    return dict(orig_id=meta & _OID_MASK, ghost=(meta >> 22) & 1,
                active=(meta >> 23) & 1, face=((meta >> 26) & 7) - 1,
                color_group=(meta >> 29) & 1)


def make_mesh_slabs(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, axis_names=(AXIS,))


@dataclasses.dataclass(frozen=True)
class SlabConfig:
    """Static decomposition parameters."""
    n_dev: int
    n_shard: int                     # particle capacity per device
    mig_cap: int                     # migration buffer rows per direction
    dims: Tuple[int, int, int]       # GLOBAL grid dims; nz % n_dev == 0
    cell_capacity: int = 8
    sweep_unroll: bool = False

    @property
    def nz_local(self) -> int:
        return self.dims[2] // self.n_dev

    @property
    def local_dims(self) -> Tuple[int, int, int]:
        return (self.dims[0], self.dims[1], self.nz_local)


def make_slab_config(sim: SimConfig, n_dev: int, n_total: int,
                     balance: float = 2.0) -> SlabConfig:
    """Size the per-device capacity with headroom for imbalance.

    Emitter modes (river/fountain) teleport respawned particles to the
    emitter's slab (``StreamEmit.comp:33-58``), so in the worst case a
    single slab must hold the ENTIRE population: capacity rises to
    ``n_total`` per shard.  State arrays are small (15 f32 fields);
    the big dense tables scale with the LOCAL GRID, not with shard
    capacity, so this costs little memory and keeps the router exact."""
    if sim.river_mode or sim.fountain_mode:
        balance = float(n_dev)
    nx, ny, nz = sim.grid_dims
    nz = ((nz + n_dev - 1) // n_dev) * n_dev
    n_shard = int(n_total / n_dev * balance)
    n_shard = max(64, ((n_shard + 63) // 64) * 64)
    return SlabConfig(n_dev=n_dev, n_shard=n_shard,
                      mig_cap=max(64, n_shard // 8),
                      dims=(nx, ny, nz),
                      cell_capacity=sim.cell_capacity,
                      sweep_unroll=sim.sweep_unroll)


def _local_keys(pos, valid, params: FluidParams, scfg: SlabConfig,
                z0: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(local cell key, global z cell) per particle; invalid -> spill."""
    from sph_tpu.core.params import grid_cell_coords
    nx, ny, nz_l = scfg.local_dims
    c = grid_cell_coords(pos, params, scfg.dims)
    gz = c[:, 2]
    lz = jnp.clip(gz - z0, 0, nz_l - 1)
    key = c[:, 0] + nx * (c[:, 1] + ny * lz)
    return jnp.where(valid > 0, key, nx * ny * nz_l), gz


def _edge_blocks(plane: jax.Array, scfg: SlabConfig, top: bool) -> jax.Array:
    """Interior edge z-row block [K, ny, LX] of a padded plane."""
    ny = scfg.dims[1]
    hr = BS.halo_rows(scfg.local_dims)
    rows = ny * scfg.nz_local
    r0 = hr + rows - ny if top else hr
    return lax.slice(plane, (0, r0, 0),
                     (plane.shape[0], r0 + ny, plane.shape[2]))


def _set_halo(plane: jax.Array, block: jax.Array, scfg: SlabConfig,
              top: bool) -> jax.Array:
    """Write a received edge block into the z halo rows of a plane."""
    ny = scfg.dims[1]
    hr = BS.halo_rows(scfg.local_dims)
    rows = ny * scfg.nz_local
    r0 = hr + rows if top else hr - ny
    return lax.dynamic_update_slice(plane, block, (0, r0, 0))


def _exchange(planes: jax.Array, scfg: SlabConfig) -> jax.Array:
    """Stacked planes [F, K, RP, LX]: fill z halos from slab neighbors.

    Non-wrapping: edge slabs keep their sentinel halo (the world border).
    """
    nd = scfg.n_dev
    up = [(i, i + 1) for i in range(nd - 1)]
    down = [(i, i - 1) for i in range(1, nd)]
    top = jax.vmap(lambda p: _edge_blocks(p, scfg, True))(planes)
    bot = jax.vmap(lambda p: _edge_blocks(p, scfg, False))(planes)
    from_below = lax.ppermute(top, AXIS, up)      # my bottom halo
    from_above = lax.ppermute(bot, AXIS, down)    # my top halo
    d = lax.axis_index(AXIS)
    have_below = (d > 0).astype(planes.dtype)
    have_above = (d < nd - 1).astype(planes.dtype)
    # keep sentinel at world borders: blend received block with existing
    halo_b = jax.vmap(lambda p: _edge_blocks_halo(p, scfg, False))(planes)
    halo_t = jax.vmap(lambda p: _edge_blocks_halo(p, scfg, True))(planes)
    nb = from_below * have_below + halo_b * (1.0 - have_below)
    na = from_above * have_above + halo_t * (1.0 - have_above)
    planes = jax.vmap(lambda p, b: _set_halo(p, b, scfg, False))(planes, nb)
    planes = jax.vmap(lambda p, b: _set_halo(p, b, scfg, True))(planes, na)
    return planes


def _edge_blocks_halo(plane: jax.Array, scfg: SlabConfig,
                      top: bool) -> jax.Array:
    """Current halo block (to preserve world-border sentinels)."""
    ny = scfg.dims[1]
    hr = BS.halo_rows(scfg.local_dims)
    rows = ny * scfg.nz_local
    r0 = hr + rows if top else hr - ny
    return lax.slice(plane, (0, r0, 0),
                     (plane.shape[0], r0 + ny, plane.shape[2]))


def _substep_body(state: ParticleState, params: FluidParams, dt: jax.Array,
                  scfg: SlabConfig) -> ParticleState:
    """Per-device slab substep (runs under shard_map)."""
    d = lax.axis_index(AXIS)
    z0 = d * scfg.nz_local
    ldims = scfg.local_dims
    cap = scfg.cell_capacity

    key, _ = _local_keys(state.pos, state.valid, params, scfg, z0)
    s = B.sort_state(state, key,
                     state.contrib_mask(params.ghost_face_active))
    bins = B.build_bins(s, params, ldims, cap)

    # --- source halo exchange (pos/vel/ghost planes) ---
    stacked = jnp.stack([bins.px, bins.py, bins.pz,
                         bins.vx, bins.vy, bins.vz, bins.ghost_on], 0)
    stacked = _exchange(stacked, scfg)
    bins = bins._replace(px=stacked[0], py=stacked[1], pz=stacked[2],
                         vx=stacked[3], vy=stacked[4], vz=stacked[5],
                         ghost_on=stacked[6])

    # --- density halo exchange hook ---
    def rho_halo_fix(rho_pad, pres_pad):
        st2 = _exchange(jnp.stack([rho_pad, pres_pad], 0), scfg)
        return st2[0], st2[1]

    out = B.solve_from_bins(s, bins, params, ldims, cap,
                            scfg.sweep_unroll, dt,
                            rho_halo_fix=rho_halo_fix)
    out = constraints.apply_container(out, params)
    return _migrate(out, params, scfg, z0)


def _migrate(state: ParticleState, params: FluidParams, scfg: SlabConfig,
             z0: jax.Array) -> ParticleState:
    """Ship particles whose new cell left the slab to the neighbor."""
    nd = scfg.n_dev
    _, gz = _local_keys(state.pos, state.valid, params, scfg, z0)
    valid = state.valid > 0
    go_up = valid & (gz >= z0 + scfg.nz_local)
    go_down = valid & (gz < z0)
    stay = valid & ~go_up & ~go_down

    # Pack rows [pos3 vel3 acc3 rho pres foam]; int fields ride in meta.
    meta = _pack_meta(state)
    rows = jnp.concatenate([
        state.pos, state.vel, state.acc,
        state.density[:, None], state.pressure[:, None],
        state.foam[:, None],
    ], axis=1)
    f = rows.shape[1]

    def pack(mask):
        """First mig_cap rows matching mask, via direction-keyed sort."""
        order_key = jnp.where(mask, 0, 1).astype(jnp.int32)
        ops = lax.sort((order_key, meta, *[rows[:, i] for i in range(f)]),
                       dimension=0, num_keys=1, is_stable=True)
        ok = ops[0][:scfg.mig_cap] == 0
        m = jnp.where(ok, ops[1][:scfg.mig_cap], 0)
        vals = jnp.stack(ops[2:], 1)[:scfg.mig_cap]
        return jnp.where(ok[:, None], vals, 0.0), m, ok

    up_rows, up_meta, up_ok = pack(go_up)
    dn_rows, dn_meta, dn_ok = pack(go_down)

    up_perm = [(i, i + 1) for i in range(nd - 1)]
    dn_perm = [(i, i - 1) for i in range(1, nd)]
    rx_from_below = lax.ppermute(up_rows, AXIS, up_perm)
    rx_b_meta = lax.ppermute(up_meta, AXIS, up_perm)
    rx_b_ok = lax.ppermute(up_ok, AXIS, up_perm)
    rx_from_above = lax.ppermute(dn_rows, AXIS, dn_perm)
    rx_a_meta = lax.ppermute(dn_meta, AXIS, dn_perm)
    rx_a_ok = lax.ppermute(dn_ok, AXIS, dn_perm)

    d = lax.axis_index(AXIS)
    rx_b_ok = rx_b_ok & (d > 0)
    rx_a_ok = rx_a_ok & (d < nd - 1)

    # Merge: stayers + arrivals, validity-keyed sort, keep n_shard rows.
    all_rows = jnp.concatenate([rows, rx_from_below, rx_from_above], 0)
    all_meta = jnp.concatenate([meta, rx_b_meta, rx_a_meta], 0)
    all_valid = jnp.concatenate([stay, rx_b_ok, rx_a_ok], 0)
    vkey = jnp.where(all_valid, 0, 1).astype(jnp.int32)
    ops = lax.sort((vkey, all_meta,
                    *[all_rows[:, i] for i in range(f)]),
                   dimension=0, num_keys=1, is_stable=True)
    keep = scfg.n_shard
    new_valid = ops[0][:keep] == 0
    new_meta = jnp.where(new_valid, ops[1][:keep], 0)
    vals = jnp.stack(ops[2:], 1)[:keep]
    m = _unpack_meta(new_meta)
    iv = new_valid.astype(jnp.int32)
    return ParticleState(
        pos=vals[:, 0:3], vel=vals[:, 3:6], acc=vals[:, 6:9],
        density=vals[:, 9], pressure=vals[:, 10], foam=vals[:, 11],
        ghost=m["ghost"] * iv, active=m["active"] * iv, face=m["face"],
        color_group=m["color_group"], valid=iv, orig_id=m["orig_id"])


def shard_by_slab(state: ParticleState, params: FluidParams,
                  scfg: SlabConfig, mesh: Mesh) -> ParticleState:
    """Host-side: distribute a global state into per-slab shards
    [n_dev * n_shard] (slab-major), device_put along the mesh."""
    import numpy as np
    import jax.numpy as _jnp
    from sph_tpu.core.params import grid_cell_coords
    c = np.asarray(grid_cell_coords(
        _jnp.asarray(state.pos), params, scfg.dims))
    gz = np.clip(c[:, 2], 0, scfg.dims[2] - 1)
    slab = np.clip(gz // scfg.nz_local, 0, scfg.n_dev - 1)
    valid = np.asarray(state.valid) > 0

    fields = [f.name for f in dataclasses.fields(ParticleState)]
    out = ParticleState.zeros(scfg.n_dev * scfg.n_shard)
    host = {k: np.array(getattr(out, k)) for k in fields}
    host["orig_id"][:] = 0
    for dshard in range(scfg.n_dev):
        idx = np.nonzero(valid & (slab == dshard))[0]
        if len(idx) > scfg.n_shard:
            raise ValueError(
                f"slab {dshard} holds {len(idx)} > capacity {scfg.n_shard}")
        base = dshard * scfg.n_shard
        for k in fields:
            src = np.asarray(getattr(state, k))
            host[k][base:base + len(idx)] = src[idx]
    arrs = {k: jnp.asarray(v) for k, v in host.items()}
    st = ParticleState(**arrs)
    spec = PS(AXIS)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, spec)), st)


def make_slab_substep(mesh: Mesh, scfg: SlabConfig):
    """Jitted multi-chip slab substep over the mesh."""
    state_spec = jax.tree_util.tree_map(lambda _: PS(AXIS),
                                        ParticleState.zeros(1))
    rep_params = jax.tree_util.tree_map(lambda _: PS(),
                                        FluidParams.default())
    body = functools.partial(_substep_body, scfg=scfg)
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(state_spec, rep_params, PS()),
        out_specs=state_spec,
        check_vma=False)
    return jax.jit(mapped)
