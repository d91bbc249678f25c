"""Container / terrain / channel constraints as pure state transforms.

Ports the math (not the code) of the reference constraint shaders:

- ``shaders/OBBConstraints.comp`` — 10 analytic container shapes; particles
  outside are projected to the surface in container-local space and their
  velocity reflects with restitution + friction.
- ``shaders/TerrainConstraints.comp`` — heightfield collision with bilinear
  sampling and finite-difference normals.
- ``shaders/ChannelConstraint.comp`` — tangent-following flow gravity along
  a sinusoidal channel + hard lateral walls.

Each shape projector returns ``(q_local, n_local, hit)``; shape selection
is a single ``lax.switch`` on the traced shape id, so live shape changes
never recompile.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sph_tpu.core import params as P
from sph_tpu.core.params import FluidParams, rotation_matrix
from sph_tpu.core.state import ParticleState

_EPS = 1e-6


def _norm(v, axis=-1, keepdims=False):
    return jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=keepdims))


def _safe_unit(v, fallback=None):
    n = _norm(v, keepdims=True)
    u = v / jnp.maximum(n, 1e-12)
    if fallback is not None:
        u = jnp.where(n > _EPS, u, fallback)
    return u


# Every projector: p [N,3] local coords -> (q [N,3], n [N,3], hit [N] bool)

def _project_box(p, half, aux):
    q = jnp.clip(p, -half, half)
    delta = p - q
    hit = jnp.any(jnp.abs(delta) > 0.0, axis=-1)
    ad = jnp.abs(delta)
    # Normal along the most violated axis (OBBConstraints.comp:207-212)
    axis = jnp.argmax(ad, axis=-1)
    n = jax.nn.one_hot(axis, 3, dtype=p.dtype) * jnp.sign(
        jnp.take_along_axis(delta, axis[:, None], axis=-1))
    return q, n, hit


def _project_sphere(p, half, aux):
    r = half[0]
    d = _norm(p)
    up = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], p.dtype), p.shape)
    n = jnp.where((d > _EPS)[:, None], p / jnp.maximum(d, 1e-12)[:, None], up)
    return n * r, n, d > r


def _project_cylinder(p, half, aux):
    r, hh = half[0], half[1]
    rad = _norm(p[:, ::2])  # xz
    scale = jnp.where(rad > r, r / jnp.maximum(rad, _EPS), 1.0)
    q = jnp.stack([p[:, 0] * scale, jnp.clip(p[:, 1], -hh, hh),
                   p[:, 2] * scale], axis=-1)
    delta = p - q
    dl = _norm(delta)
    hit = dl > _EPS
    n = delta / jnp.maximum(dl, 1e-12)[:, None]
    return q, n, hit


def _project_torus(p, half, aux):
    R, r = half[0], half[1]
    lxz = _norm(p[:, ::2])
    ring_dir = jnp.where(
        (lxz > _EPS)[:, None], p[:, ::2] / jnp.maximum(lxz, 1e-12)[:, None],
        jnp.array([1.0, 0.0], p.dtype))
    ring = jnp.stack([ring_dir[:, 0] * R, jnp.zeros_like(lxz),
                      ring_dir[:, 1] * R], axis=-1)
    d = p - ring
    dl = _norm(d)
    n = d / jnp.maximum(dl, _EPS)[:, None]
    return ring + n * r, n, dl > r


def _project_capsule(p, half, aux):
    r, hh = half[0], half[1]
    seg = jnp.stack([jnp.zeros_like(p[:, 0]), jnp.clip(p[:, 1], -hh, hh),
                     jnp.zeros_like(p[:, 2])], axis=-1)
    d = p - seg
    dl = _norm(d)
    n = d / jnp.maximum(dl, _EPS)[:, None]
    return seg + n * r, n, dl > r


def _project_hourglass(p, half, aux):
    base_r, hh = half[0], jnp.maximum(half[1], 1e-6)
    neck_r = jnp.minimum(half[2], base_r)
    y_c = jnp.clip(p[:, 1], -hh, hh)
    r_max = neck_r + (base_r - neck_r) * jnp.abs(y_c) / hh
    lxz = _norm(p[:, ::2])
    scale = jnp.where(lxz > r_max, r_max / jnp.maximum(lxz, _EPS), 1.0)
    q = jnp.stack([p[:, 0] * scale, y_c, p[:, 2] * scale], axis=-1)
    delta = p - q
    dl = _norm(delta)
    return q, delta / jnp.maximum(dl, 1e-12)[:, None], dl > _EPS


def _project_egg(p, half, aux):
    a = jnp.maximum(half[0], 1e-6)
    b = jnp.maximum(half[1], 1e-6)
    e = jnp.stack([a, b, a])
    u = p / e[None, :]
    d = _norm(u)
    q = (u / jnp.maximum(d, 1e-12)[:, None]) * e[None, :]
    n = _safe_unit(q / (e * e)[None, :])
    return q, n, d > 1.0


def _project_star(p, half, aux):
    R, hh = half[0], half[1]
    pts = jnp.maximum(3.0, aux[0])
    depth = jnp.clip(aux[1], 0.0, 0.9)
    y_c = jnp.clip(p[:, 1], -hh, hh)
    ang = jnp.arctan2(p[:, 2], p[:, 0])
    r_max = R * (1.0 - depth * (0.5 + 0.5 * jnp.cos(pts * ang)))
    lxz = _norm(p[:, ::2])
    scale = jnp.where(lxz > r_max, r_max / jnp.maximum(lxz, _EPS), 1.0)
    q = jnp.stack([p[:, 0] * scale, y_c, p[:, 2] * scale], axis=-1)
    delta = p - q
    dl = _norm(delta)
    return q, delta / jnp.maximum(dl, 1e-12)[:, None], dl > _EPS


def _project_superellipsoid(p, half, aux):
    a = jnp.maximum(half[0], 1e-6)
    b = jnp.maximum(half[1], 1e-6)
    n_exp = jnp.clip(aux[2], 0.6, 8.0)
    e = jnp.stack([a, b, a])
    u = jnp.abs(p) / e[None, :]
    F = jnp.sum(jnp.maximum(u, 1e-12) ** n_exp, axis=-1)
    # Radial projection is exact: F(k p) = k^n F(p)
    k = jnp.maximum(F, 1e-12) ** (-1.0 / n_exp)
    q = p * k[:, None]
    g = (jnp.sign(p) * jnp.maximum(jnp.abs(q) / e[None, :], 1e-6) ** (n_exp - 1.0)
         / e[None, :])
    return q, _safe_unit(g), F > 1.0


_TREFOIL_T = 2.0 * np.pi * np.arange(48, dtype=np.float32) / 48.0
_TREFOIL_BASE = np.stack([
    np.sin(_TREFOIL_T) + 2.0 * np.sin(2.0 * _TREFOIL_T),
    0.35 * (-np.sin(3.0 * _TREFOIL_T)),
    np.cos(_TREFOIL_T) - 2.0 * np.cos(2.0 * _TREFOIL_T),
], axis=-1).astype(np.float32)  # [48,3] unit-scale knot samples


def _project_trefoil(p, half, aux):
    S, r = half[0], half[1]
    curve = S * jnp.asarray(_TREFOIL_BASE)                      # [48,3]
    d2 = jnp.sum((p[:, None, :] - curve[None, :, :]) ** 2, axis=-1)
    best = curve[jnp.argmin(d2, axis=-1)]                       # [N,3]
    d = p - best
    dl = _norm(d)
    n = d / jnp.maximum(dl, _EPS)[:, None]
    return best + n * r, n, dl > r


_PROJECTORS = [
    _project_box, _project_sphere, _project_cylinder, _project_torus,
    _project_capsule, _project_hourglass, _project_egg, _project_star,
    _project_superellipsoid, _project_trefoil,
]


def project_shape(p_local: jax.Array, shape_type: jax.Array,
                  box_half: jax.Array, shape_aux: jax.Array
                  ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Dispatch to the shape projector via lax.switch (traced shape id)."""
    idx = jnp.clip(shape_type, 0, P.NUM_SHAPES - 1)
    return jax.lax.switch(
        idx, [lambda p, h=h: h(p, box_half, shape_aux) for h in _PROJECTORS],
        p_local)


def apply_container(state: ParticleState, params: FluidParams) -> ParticleState:
    """OBB/analytic-shape containment with restitution + friction.

    Mirrors ``OBBConstraints.comp:41-237``: world -> local via R^T (p - c),
    project, normal back to world, reflect ``vn' = -e vn``,
    ``vt' = (1 - mu) vt``. Ghost particles are skipped.
    """
    rot = rotation_matrix(params.box_euler_deg)          # world_from_box
    rel = state.pos - params.box_center[None, :]
    p_local = P.rows_times(rel, rot)                     # R^T p per row
    q_local, n_local, hit = project_shape(
        p_local, params.shape_type, params.box_half, params.shape_aux)

    n_world = _safe_unit(P.rows_times(n_local, rot.T))
    new_pos = params.box_center[None, :] + P.rows_times(q_local, rot.T)
    vn = jnp.sum(state.vel * n_world, axis=-1, keepdims=True)
    v_n = vn * n_world
    v_t = state.vel - v_n
    new_vel = -params.wall_restitution * v_n + (1.0 - params.wall_friction) * v_t

    live = hit & (state.ghost == 0) & (state.valid > 0)
    return state.replace(
        pos=jnp.where(live[:, None], new_pos, state.pos),
        vel=jnp.where(live[:, None], new_vel, state.vel),
    )


def apply_container_planes(px, py, pz, vx, vy, vz, live,
                           params: FluidParams):
    """Component-wise plane form of :func:`apply_container` for the
    RESIDENT engine (SHAPE_BOX only): identical math on separate
    coordinate planes of the slot tables — a ``[T, 3]`` view of the
    ``[F, ...]`` table layout would materialize a 3-minor array at 42x
    tile padding (PERF.md finding 8), so the vector ops are unrolled
    per component.  ``live`` masks occupied fluid slots (empty slots
    carry SENTINEL_POS and must NOT be projected into the box).
    Returns the six updated planes."""
    rot = rotation_matrix(params.box_euler_deg)          # world_from_box
    c = params.box_center
    half = params.box_half
    e = params.wall_restitution
    mu = params.wall_friction
    dx, dy, dz = px - c[0], py - c[1], pz - c[2]
    # local = R^T d
    lx = rot[0, 0] * dx + rot[1, 0] * dy + rot[2, 0] * dz
    ly = rot[0, 1] * dx + rot[1, 1] * dy + rot[2, 1] * dz
    lz = rot[0, 2] * dx + rot[1, 2] * dy + rot[2, 2] * dz
    qx = jnp.clip(lx, -half[0], half[0])
    qy = jnp.clip(ly, -half[1], half[1])
    qz = jnp.clip(lz, -half[2], half[2])
    ex, ey, ez = lx - qx, ly - qy, lz - qz
    ax, ay, az = jnp.abs(ex), jnp.abs(ey), jnp.abs(ez)
    hit = (ax > 0.0) | (ay > 0.0) | (az > 0.0)
    # argmax(|e|) with first-max tie-breaking (_project_box:52)
    m0 = (ax >= ay) & (ax >= az)
    m1 = ~m0 & (ay >= az)
    m2 = ~m0 & ~m1
    nlx = jnp.where(m0, jnp.sign(ex), 0.0)
    nly = jnp.where(m1, jnp.sign(ey), 0.0)
    nlz = jnp.where(m2, jnp.sign(ez), 0.0)
    # world normal R n, then _safe_unit
    nwx = rot[0, 0] * nlx + rot[0, 1] * nly + rot[0, 2] * nlz
    nwy = rot[1, 0] * nlx + rot[1, 1] * nly + rot[1, 2] * nlz
    nwz = rot[2, 0] * nlx + rot[2, 1] * nly + rot[2, 2] * nlz
    nn = jnp.sqrt(nwx * nwx + nwy * nwy + nwz * nwz)
    inv = 1.0 / jnp.maximum(nn, 1e-12)
    nwx, nwy, nwz = nwx * inv, nwy * inv, nwz * inv
    npx = c[0] + rot[0, 0] * qx + rot[0, 1] * qy + rot[0, 2] * qz
    npy = c[1] + rot[1, 0] * qx + rot[1, 1] * qy + rot[1, 2] * qz
    npz = c[2] + rot[2, 0] * qx + rot[2, 1] * qy + rot[2, 2] * qz
    vn = vx * nwx + vy * nwy + vz * nwz
    nvx = -e * vn * nwx + (1.0 - mu) * (vx - vn * nwx)
    nvy = -e * vn * nwy + (1.0 - mu) * (vy - vn * nwy)
    nvz = -e * vn * nwz + (1.0 - mu) * (vz - vn * nwz)
    sel = hit & live
    return (jnp.where(sel, npx, px), jnp.where(sel, npy, py),
            jnp.where(sel, npz, pz), jnp.where(sel, nvx, vx),
            jnp.where(sel, nvy, vy), jnp.where(sel, nvz, vz))


# ---------------------------------------------------------------------------
# Terrain heightfield (river mode)
# ---------------------------------------------------------------------------

def sample_terrain_height(terrain: jax.Array, wx: jax.Array, wz: jax.Array,
                          tmin: jax.Array, tsize: jax.Array) -> jax.Array:
    """Bilinear heightfield sample; terrain is [H, W] indexed [z, x]
    (``TerrainConstraints.comp:20-33``)."""
    H, W = terrain.shape
    u = jnp.clip((wx - tmin[0]) / tsize[0] * (W - 1), 0.0, W - 2.0)
    v = jnp.clip((wz - tmin[1]) / tsize[1] * (H - 1), 0.0, H - 2.0)
    ix = u.astype(jnp.int32)
    iz = v.astype(jnp.int32)
    fx = u - ix
    fz = v - iz
    h00 = terrain[iz, ix]
    h10 = terrain[iz, ix + 1]
    h01 = terrain[iz + 1, ix]
    h11 = terrain[iz + 1, ix + 1]
    return ((h00 * (1 - fx) + h10 * fx) * (1 - fz)
            + (h01 * (1 - fx) + h11 * fx) * fz)


def terrain_normal(terrain: jax.Array, wx, wz, tmin, tsize) -> jax.Array:
    """Finite-difference outward normal (``TerrainConstraints.comp:36-44``)."""
    H, W = terrain.shape
    dx = tsize[0] / (W - 1)
    dz = tsize[1] / (H - 1)
    hr = sample_terrain_height(terrain, wx + dx, wz, tmin, tsize)
    hl = sample_terrain_height(terrain, wx - dx, wz, tmin, tsize)
    hf = sample_terrain_height(terrain, wx, wz + dz, tmin, tsize)
    hb = sample_terrain_height(terrain, wx, wz - dz, tmin, tsize)
    n = jnp.stack([hl - hr, jnp.broadcast_to(2.0 * dx, wx.shape), hb - hf], -1)
    return _safe_unit(n)


def apply_terrain(state: ParticleState, terrain: jax.Array,
                  params: FluidParams) -> ParticleState:
    """Heightfield collision (``TerrainConstraints.comp:47-82``)."""
    wx, wy, wz = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    tmin, tsize = params.terrain_min, params.terrain_size
    in_fp = ((wx >= tmin[0]) & (wx <= tmin[0] + tsize[0])
             & (wz >= tmin[1]) & (wz <= tmin[1] + tsize[1]))
    ty = sample_terrain_height(terrain, wx, wz, tmin, tsize)
    below = wy < ty
    live = in_fp & below & (state.ghost == 0) & (state.valid > 0)

    n = terrain_normal(terrain, wx, wz, tmin, tsize)
    new_pos = state.pos.at[:, 1].set(jnp.where(live, ty + 0.001, wy))
    vn = jnp.sum(state.vel * n, axis=-1)
    into = vn < 0.0
    v_n = vn[:, None] * n
    v_t = state.vel - v_n
    bounced = (-params.terrain_restitution * v_n
               + (1.0 - params.terrain_friction) * v_t)
    new_vel = jnp.where((live & into)[:, None], bounced, state.vel)
    return state.replace(pos=jnp.where(live[:, None], new_pos, state.pos),
                         vel=new_vel)


def apply_channel(state: ParticleState, params: FluidParams,
                  dt: jax.Array) -> ParticleState:
    """Sinusoidal channel flow + lateral walls (``ChannelConstraint.comp``)."""
    wz = state.pos[:, 2]
    cx = (params.box_center[0]
          + params.river_amp * jnp.sin(params.river_freq * wz + params.river_phase))
    dx = state.pos[:, 0] - cx

    # Tangent-following flow gravity
    tdx = params.river_amp * params.river_freq * jnp.cos(
        params.river_freq * wz + params.river_phase)
    tlen = jnp.sqrt(tdx * tdx + 1.0)
    live = (state.ghost == 0) & (state.valid > 0)
    g = params.river_flow_gravity * dt
    vel = state.vel
    vel = vel.at[:, 0].add(jnp.where(live, tdx / tlen * g, 0.0))
    vel = vel.at[:, 2].add(jnp.where(live, 1.0 / tlen * g, 0.0))

    # Hard lateral wall at the channel half-width
    outside = jnp.abs(dx) > params.river_channel_width
    wall_x = cx + jnp.sign(dx) * params.river_channel_width
    pos = state.pos.at[:, 0].set(
        jnp.where(live & outside, wall_x, state.pos[:, 0]))
    moving_out = dx * vel[:, 0] > 0.0
    vel = vel.at[:, 0].set(
        jnp.where(live & outside & moving_out, 0.0, vel[:, 0]))
    return state.replace(pos=pos, vel=vel)
