"""Particle state: struct-of-arrays pytree + host-side spawn logic.

The reference keeps an 80-byte AoS ``SPHParticle`` in an SSBO
(``SPHFluid3D.h:12-24``); here the same state lives as an SoA pytree so
each field is one contiguous f32/i32 array.  Spawn logic mirrors
``SPHFluidGPU::InitializeParticles`` (``SPHFluid3D.cpp:85-263``): lattice at
spacing 0.85h, bottom-anchored block filling 40% of container height,
rejection-sampled against the analytic shape, optional jitter, color-group
tagging by mix pattern.  Padding slots beyond the spawned count carry
``valid=0`` and are excluded from all sums (the analogue of sizing the
SSBO to the exact particle count).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sph_tpu.core import params as P
from sph_tpu.utils.pytree import pytree_dataclass

PAD = 256  # particle capacity rounded up to this multiple


@pytree_dataclass
class ParticleState:
    pos: jax.Array          # [N,3] f32
    vel: jax.Array          # [N,3] f32
    acc: jax.Array          # [N,3] f32
    density: jax.Array      # [N]   f32
    pressure: jax.Array     # [N]   f32
    foam: jax.Array         # [N]   f32  (reference padA)
    ghost: jax.Array        # [N]   i32  (isGhost)
    active: jax.Array       # [N]   i32  (isActive — ghost activation)
    face: jax.Array         # [N]   i32  ghost face id 0..5, -1 for fluid
    color_group: jax.Array  # [N]   i32  (reference padC, read as flags.z)
    valid: jax.Array        # [N]   i32  1 = real particle, 0 = padding
    orig_id: jax.Array      # [N]   i32  spawn identity (order-independent)

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @classmethod
    def zeros(cls, n: int) -> "ParticleState":
        f3 = jnp.zeros((n, 3), jnp.float32)
        f1 = jnp.zeros((n,), jnp.float32)
        i1 = jnp.zeros((n,), jnp.int32)
        return cls(pos=f3, vel=f3, acc=f3, density=f1, pressure=f1, foam=f1,
                   ghost=i1, active=i1, face=i1 - 1, color_group=i1, valid=i1,
                   orig_id=jnp.arange(n, dtype=jnp.int32))

    def contrib_mask(self, ghost_face_active: jax.Array) -> jax.Array:
        """[N] f32 — weight of each particle as a *neighbor source*.

        Fluid particles always contribute; ghost particles contribute only
        when their face is activated (per-face activation grids, BASELINE
        config 4).  Padding never contributes.
        """
        face = jnp.clip(self.face, 0, 5)
        face_on = ghost_face_active[face] > 0
        ghost_on = jnp.where(self.ghost > 0, face_on, True)
        return (self.valid > 0) & ghost_on

    def fluid_mask(self) -> jax.Array:
        """[N] bool — real, non-ghost particles (the integrated ones)."""
        return (self.valid > 0) & (self.ghost == 0)


# ---------------------------------------------------------------------------
# Host-side spawn (numpy) — mirrors InitializeParticles semantics
# ---------------------------------------------------------------------------

def _inside_shape_np(lx, ly, lz, shape_type: int, box_half, shape_aux,
                     margin: float) -> np.ndarray:
    """Vectorized rejection test in container-local coords.

    Mirrors the ``insideShape`` lambda (``SPHFluid3D.cpp:167-235``).
    """
    bh = np.asarray(box_half, np.float32)
    aux = np.asarray(shape_aux, np.float32)
    hf = P.effective_half_np(shape_type, bh)
    if shape_type == P.SHAPE_SPHERE:
        r = hf[0] - margin
        return lx * lx + ly * ly + lz * lz <= r * r
    if shape_type == P.SHAPE_CYLINDER:
        r = hf[0] - margin
        return (lx * lx + lz * lz <= r * r) & (np.abs(ly) <= hf[1] - margin)
    if shape_type == P.SHAPE_TORUS:
        R, r = bh[0], bh[1] - margin
        dr = np.sqrt(lx * lx + lz * lz) - R
        return (r > 0.0) & (dr * dr + ly * ly <= r * r)
    if shape_type == P.SHAPE_CAPSULE:
        r, H = bh[0] - margin, bh[1]
        dy = ly - np.clip(ly, -H, H)
        return lx * lx + lz * lz + dy * dy <= r * r
    if shape_type == P.SHAPE_HOURGLASS:
        baseR, H = bh[0], max(bh[1], 1e-6)
        neckR = min(bh[2], baseR)
        rmax = neckR + (baseR - neckR) * np.abs(ly) / H - margin
        ok_y = np.abs(ly) <= H - margin
        return ok_y & (rmax > 0.0) & (lx * lx + lz * lz <= rmax * rmax)
    if shape_type == P.SHAPE_EGG:
        a = max(bh[0] - margin, 1e-4)
        b = max(bh[1] - margin, 1e-4)
        u, v, w = lx / a, ly / b, lz / a
        return u * u + v * v + w * w <= 1.0
    if shape_type == P.SHAPE_STAR:
        R, H = bh[0], bh[1]
        pts = max(3.0, aux[0])
        depth = float(np.clip(aux[1], 0.0, 0.9))
        ok_y = np.abs(ly) <= H - margin
        ang = np.arctan2(lz, lx)
        rmax = R * (1.0 - depth * (0.5 + 0.5 * np.cos(pts * ang))) - margin
        return ok_y & (rmax > 0.0) & (lx * lx + lz * lz <= rmax * rmax)
    if shape_type == P.SHAPE_SUPERELLIPSOID:
        a = max(bh[0] - margin, 1e-4)
        b = max(bh[1] - margin, 1e-4)
        n = float(np.clip(aux[2], 0.6, 8.0))
        F = (np.abs(lx) / a) ** n + (np.abs(ly) / b) ** n + (np.abs(lz) / a) ** n
        return F <= 1.0
    if shape_type == P.SHAPE_TREFOIL:
        S, r = bh[0], bh[1] - margin
        if r <= 0.0:
            return np.zeros_like(lx, dtype=bool)
        t = 2.0 * np.pi * np.arange(48) / 48.0
        cx = S * (np.sin(t) + 2.0 * np.sin(2.0 * t))
        cy = S * 0.35 * (-np.sin(3.0 * t))
        cz = S * (np.cos(t) - 2.0 * np.cos(2.0 * t))
        d2 = ((lx[..., None] - cx) ** 2 + (ly[..., None] - cy) ** 2
              + (lz[..., None] - cz) ** 2).min(axis=-1)
        return d2 <= r * r
    return np.ones_like(lx, dtype=bool)  # box: whole lattice block


@dataclasses.dataclass
class SpawnResult:
    pos: np.ndarray
    vel: np.ndarray
    ghost: np.ndarray
    face: np.ndarray
    color_group: np.ndarray
    count: int


def spawn_standard(n_target: int, *, h: float = 0.28, rest_density: float = 1000.0,
                   box_center=(0.0, 0.0, 0.0), box_half=(7.0, 7.0, 7.0),
                   shape_type: int = P.SHAPE_BOX, shape_aux=(5.0, 0.35, 2.5),
                   mix_pattern: int = 0, use_jitter: bool = True,
                   jitter_amp: float = 0.20, seed: int = 0,
                   fill_fraction: float = 0.4,
                   box_euler_deg=(0.0, 0.0, 0.0),
                   spawn_rotation: str = "ignore") -> SpawnResult:
    """Bottom-anchored lattice spawn (``SPHFluid3D.cpp:159-259``).

    ``spawn_rotation`` — how a rotated container affects the lattice:

    - ``"ignore"`` (default): REFERENCE semantics — "rotation is ignored
      at spawn, as before; the constraint pass settles particles
      afterwards" (``SPHFluid3D.cpp:166-169``).  The container-frame
      lattice is emitted as world positions; for a rotated box the
      column corners start OUTSIDE and get projected onto the faces.
    - ``"local"``: the same container-frame lattice ROTATED into world
      (``p = c + R offset``) — inside the container by construction;
      used by the rotated_512k bench so it measures settled fluid
      instead of the projection-sheet transient (round-5 PERF.md:
      the "steady ~4.2k overflow" of rounds 3-4 was that transient).
    - ``"aabb"``: world-axis lattice over the rotated AABB,
      rejection-tested in local coords.  Measured round 5: the deep
      corner wedge this creates collapses at 512k (rho -> 5e4,
      NaN) — kept only for experiments.

    ``box_euler_deg == 0`` (any mode) reproduces the round-4 lattice
    bit-for-bit."""
    spacing = 0.85 * h
    margin = 0.5 * spacing
    hf = P.effective_half_np(shape_type, np.asarray(box_half, np.float32))
    c = np.asarray(box_center, np.float32)
    euler = np.asarray(box_euler_deg, np.float32)
    rot = P.rotation_matrix_np(euler)
    rotated = bool(np.any(euler != 0.0)) and spawn_rotation == "aabb"
    # world AABB of the rotated effective box: ext_i = sum_j |R_ij| hf_j
    # (SPHFluid3D.cpp:282-304)
    ext = (np.abs(rot) @ hf).astype(np.float32) if rotated else hf

    layers_y = max(1, int((2.0 * ext[1] * fill_fraction) / spacing))
    side_x = max(1, int((ext[0] * 1.7) / spacing))
    side_z = max(1, int((ext[2] * 1.7) / spacing))

    xi, yi, zi = np.meshgrid(np.arange(side_x), np.arange(layers_y),
                             np.arange(side_z), indexing="ij")
    rng = np.random.default_rng(seed)
    jshape = xi.shape

    def jit_():
        if not use_jitter:
            return np.zeros(jshape, np.float32)
        a = spacing * jitter_amp
        return rng.uniform(-a, a, jshape).astype(np.float32)

    # world-frame offsets from the container center
    wx = (-ext[0] * 0.85 + xi * spacing + jit_()).astype(np.float32)
    wy = (-ext[1] + spacing + yi * spacing + jit_()).astype(np.float32)
    wz = (-ext[2] * 0.85 + zi * spacing + jit_()).astype(np.float32)

    if rotated:
        # container-local coords for the rejection test: R^T w
        lx = rot[0, 0] * wx + rot[1, 0] * wy + rot[2, 0] * wz
        ly = rot[0, 1] * wx + rot[1, 1] * wy + rot[2, 1] * wz
        lz = rot[0, 2] * wx + rot[1, 2] * wy + rot[2, 2] * wz
    else:
        lx, ly, lz = wx, wy, wz

    inside = _inside_shape_np(lx, ly, lz, shape_type, box_half, shape_aux, margin)
    if rotated:
        # the box branch of _inside_shape_np accepts the whole lattice
        # (true only for the unrotated, box-bounded lattice); under
        # rotation the AABB-spanning lattice needs the explicit local-
        # frame bounds test (insideShape's box case, SPHFluid3D.cpp:171)
        inside = (inside
                  & (np.abs(lx) <= hf[0] - margin)
                  & (np.abs(ly) <= hf[1] - margin)
                  & (np.abs(lz) <= hf[2] - margin))

    # Color-group tag (SPHFluid3D.cpp:252-257)
    if mix_pattern == 1:
        cg = ((xi + yi + zi) & 1).astype(np.int32)
    elif mix_pattern == 2:
        cg = rng.integers(0, 2, jshape).astype(np.int32)
    else:
        cg = (lx >= 0.0).astype(np.int32)

    flat = inside.reshape(-1)
    order = np.nonzero(flat)[0][:n_target]   # lattice traversal order, capped
    pos_w = np.stack([wx.reshape(-1)[order], wy.reshape(-1)[order],
                      wz.reshape(-1)[order]], axis=-1)
    if spawn_rotation == "local" and np.any(euler != 0.0):
        # container-frame lattice rotated into world: p = c + R offset
        pos_w = pos_w @ rot.T
    pos = pos_w + c[None, :]
    count = pos.shape[0]
    return SpawnResult(
        pos=pos.astype(np.float32),
        vel=np.zeros((count, 3), np.float32),
        ghost=np.zeros((count,), np.int32),
        face=np.full((count,), -1, np.int32),
        color_group=cg.reshape(-1)[order].astype(np.int32),
        count=count,
    )


def spawn_ghost_box_shell(*, h: float = 0.28, box_center=(0.0, 0.0, 0.0),
                          box_half=(7.0, 7.0, 7.0), layers: int = 1) -> SpawnResult:
    """Ghost boundary particles on the 6 box faces, tagged per-face.

    The reference carries the machinery (``isGhost``/``isActive`` flags,
    shader short-circuits ``SPHFluid.comp:71-83``) but never spawns ghosts;
    BASELINE config 4 requires it, so the spawn itself is new design: a
    lattice shell just outside each face at in-plane spacing 0.85h.
    Face ids: 0 = -X, 1 = +X, 2 = -Y, 3 = +Y, 4 = -Z, 5 = +Z.

    Default is a SINGLE layer at 0.45h outside the face: a second layer
    would sit >h from every interior point — outside poly6 support, pure
    dead weight — and (being past the grid's 1-cell margin) would clamp
    into the edge cells of the spatial grid, inflating their slot
    occupancy and so the Pallas kernels' occupancy bounds grid-wide.
    """
    spacing = 0.85 * h
    hf = np.asarray(box_half, np.float32)
    c = np.asarray(box_center, np.float32)
    all_pos, all_face = [], []
    for axis in range(3):
        u_ax, v_ax = [a for a in range(3) if a != axis]
        nu = max(1, int(np.ceil(2 * hf[u_ax] / spacing)) + 1)
        nv = max(1, int(np.ceil(2 * hf[v_ax] / spacing)) + 1)
        us = np.linspace(-hf[u_ax], hf[u_ax], nu).astype(np.float32)
        vs = np.linspace(-hf[v_ax], hf[v_ax], nv).astype(np.float32)
        for side in (0, 1):  # -face, +face
            sgn = -1.0 if side == 0 else 1.0
            for layer in range(layers):
                w = sgn * (hf[axis] + (0.45 + 0.9 * layer) * h)
                uu, vv = np.meshgrid(us, vs, indexing="ij")
                p = np.zeros((uu.size, 3), np.float32)
                p[:, axis] = w
                p[:, u_ax] = uu.reshape(-1)
                p[:, v_ax] = vv.reshape(-1)
                all_pos.append(p + c[None, :])
                all_face.append(np.full((p.shape[0],), axis * 2 + side, np.int32))
    pos = np.concatenate(all_pos, 0)
    face = np.concatenate(all_face, 0)
    count = pos.shape[0]
    return SpawnResult(
        pos=pos, vel=np.zeros((count, 3), np.float32),
        ghost=np.ones((count,), np.int32), face=face,
        color_group=np.zeros((count,), np.int32), count=count,
    )


def spawn_river(n_target: int, terrain: "np.ndarray", *, h: float = 0.28,
                box_center=(0.0, 0.0, 0.0), box_half=(7.0, 7.0, 7.0),
                terrain_min=(-7.0, -7.0), terrain_size=(14.0, 14.0),
                river_amp: float = 2.0, river_freq: float = 0.25,
                river_phase: float = 0.0, river_channel_width: float = 3.0,
                river_emitter_pos=(0.0, 3.0, -9.0),
                use_jitter: bool = True, jitter_amp: float = 0.20,
                seed: int = 0) -> SpawnResult:
    """Channel-following spawner for river mode (``SPHFluid3D.cpp:104-158``)."""
    spacing = 0.85 * h
    rng = np.random.default_rng(seed)
    W, H = terrain.shape[1], terrain.shape[0]  # terrain[z, x]
    x_min, z_min = terrain_min
    x_size, z_size = terrain_size

    def sample_h(wx, wz):
        u = np.clip((wx - x_min) / x_size * (W - 1), 0.0, W - 2)
        v = np.clip((wz - z_min) / z_size * (H - 1), 0.0, H - 2)
        ix, iz = int(u), int(v)
        fx, fz = u - ix, v - iz
        h00 = terrain[iz, ix]
        h10 = terrain[iz, ix + 1]
        h01 = terrain[iz + 1, ix]
        h11 = terrain[iz + 1, ix + 1]
        return (h00 * (1 - fx) * (1 - fz) + h10 * fx * (1 - fz)
                + h01 * (1 - fx) * fz + h11 * fx * fz)

    def jit_():
        if not use_jitter:
            return 0.0
        return float(rng.uniform(-spacing * jitter_amp, spacing * jitter_amp))

    pos, vel, cg = [], [], []
    count = 0
    wz = z_min + spacing
    while wz < z_min + z_size - spacing and count < n_target:
        cx = box_center[0] + river_amp * np.sin(river_freq * wz + river_phase)
        wx = cx - river_channel_width
        while wx <= cx + river_channel_width and count < n_target:
            ty = sample_h(wx, wz)
            wy = ty + spacing
            while wy <= ty + 2.5 and count < n_target:
                pos.append([wx + jit_(), wy + jit_(), wz + jit_()])
                vel.append([0.0, 0.0, 0.5])
                cg.append(count & 1)
                count += 1
                wy += spacing
            wx += spacing
        wz += spacing
    # Top-up at the emitter if the channel didn't hold enough
    while count < n_target:
        rx = rng.uniform(-river_channel_width * 0.5, river_channel_width * 0.5)
        rz = rng.uniform(-river_channel_width * 0.5, river_channel_width * 0.5)
        wx = river_emitter_pos[0] + rx
        wz = river_emitter_pos[2] + rz
        ty = sample_h(wx, wz)
        pos.append([wx, ty + rng.uniform(0.0, 1.5), wz])
        vel.append([0.0, 0.0, 2.0])
        cg.append(count & 1)
        count += 1
    return SpawnResult(
        pos=np.asarray(pos, np.float32).reshape(count, 3),
        vel=np.asarray(vel, np.float32).reshape(count, 3),
        ghost=np.zeros((count,), np.int32),
        face=np.full((count,), -1, np.int32),
        color_group=np.asarray(cg, np.int32),
        count=count,
    )


def concat_spawns(*spawns: SpawnResult) -> SpawnResult:
    return SpawnResult(
        pos=np.concatenate([s.pos for s in spawns], 0),
        vel=np.concatenate([s.vel for s in spawns], 0),
        ghost=np.concatenate([s.ghost for s in spawns], 0),
        face=np.concatenate([s.face for s in spawns], 0),
        color_group=np.concatenate([s.color_group for s in spawns], 0),
        count=sum(s.count for s in spawns),
    )


def state_from_spawn(spawn: SpawnResult, pad_to: Optional[int] = None) -> ParticleState:
    """Pack a host spawn into a padded device ParticleState."""
    count = spawn.count
    n = pad_to if pad_to is not None else ((count + PAD - 1) // PAD) * PAD
    if n < count:
        raise ValueError(f"pad_to={n} < spawned count {count}")

    def pad3(a):
        out = np.zeros((n, 3), np.float32)
        out[:count] = a
        return out

    def pad1(a, fill=0):
        out = np.full((n,), fill, a.dtype)
        out[:count] = a
        return out

    valid = np.zeros((n,), np.int32)
    valid[:count] = 1
    return ParticleState(
        pos=jnp.asarray(pad3(spawn.pos)),
        vel=jnp.asarray(pad3(spawn.vel)),
        acc=jnp.zeros((n, 3), jnp.float32),
        density=jnp.zeros((n,), jnp.float32),
        pressure=jnp.zeros((n,), jnp.float32),
        foam=jnp.zeros((n,), jnp.float32),
        ghost=jnp.asarray(pad1(spawn.ghost)),
        active=jnp.asarray(pad1(np.ones((count,), np.int32))),
        face=jnp.asarray(pad1(spawn.face, fill=-1)),
        color_group=jnp.asarray(pad1(spawn.color_group)),
        valid=jnp.asarray(valid),
        orig_id=jnp.arange(n, dtype=jnp.int32),
    )
