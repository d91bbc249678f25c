"""Velocity impulses — the audio-reactive "art" primitives.

Ports the behavior of the five impulse compute shaders (dispatched once per
*frame*, kicks pre-multiplied by dt on the host, reference
``SPHFluid3D.cpp:532-638`` / ``Scene0p.cpp:3133-3214``):

- wave:      sinusoidal directional kick in a Y band (``WaveImpulse.comp``)
- vortex:    whirlpool around the container's local Y axis (``VortexImpulse.comp``)
- attractor: softened inverse-distance gravity well (``AttractorImpulse.comp``)
- curl flow: divergence-free curl-noise drift (``CurlFlow.comp``)
- stencil:   spring toward per-particle target points (``StencilAttract.comp``)

All are pure transforms ``state -> state``; ghosts and padding are skipped.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from sph_tpu.core.params import FluidParams, rotation_matrix, effective_half
from sph_tpu.core.state import ParticleState


def _live(state: ParticleState) -> jax.Array:
    return (state.ghost == 0) & (state.valid > 0)


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / jnp.maximum(e1 - e0, 1e-12), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def wave_impulse(state: ParticleState, amplitude, wavelength, phase, direction,
                 y_min=-jnp.inf, y_max=jnp.inf) -> ParticleState:
    """v += dhat * A sin(2pi/lambda * p.dhat + phase) within [y_min, y_max]."""
    d = jnp.asarray(direction, jnp.float32)
    dlen = jnp.sqrt(jnp.sum(d * d))
    nd = jnp.where(dlen > 1e-6, d / jnp.maximum(dlen, 1e-12),
                   jnp.array([0.0, 1.0, 0.0], jnp.float32))
    k = 2.0 * jnp.pi / jnp.maximum(wavelength, 1e-6)
    theta = k * jnp.sum(state.pos * nd[None, :], axis=-1) + phase
    kick = amplitude * jnp.sin(theta)
    ok = (_live(state) & (state.pos[:, 1] >= y_min) & (state.pos[:, 1] <= y_max)
          & (wavelength > 1e-6) & (amplitude != 0.0))
    return state.replace(
        vel=state.vel + jnp.where(ok[:, None], kick[:, None] * nd[None, :], 0.0))


def vortex_impulse(state: ParticleState, params: FluidParams,
                   tangent_kick, inward_kick) -> ParticleState:
    """Whirlpool: tangential + inward kicks around container local +Y."""
    rot = rotation_matrix(params.box_euler_deg)
    axis = rot[:, 1]                                   # local +Y in world
    half = effective_half(params)
    radius = jnp.maximum(jnp.maximum(half[0], half[2]), 1e-4)

    rel = state.pos - params.box_center[None, :]
    radial = rel - axis[None, :] * jnp.sum(rel * axis[None, :], axis=-1,
                                           keepdims=True)
    r = jnp.sqrt(jnp.sum(radial * radial, axis=-1))
    r_hat = radial / jnp.maximum(r, 1e-12)[:, None]
    t_hat = jnp.cross(jnp.broadcast_to(axis, r_hat.shape), r_hat)
    fall = _smoothstep(0.0, 0.35 * radius, r)
    dv = t_hat * (tangent_kick * fall)[:, None] - r_hat * (inward_kick * fall)[:, None]
    ok = _live(state) & (r >= 1e-4)
    return state.replace(vel=state.vel + jnp.where(ok[:, None], dv, 0.0))


def attractor_impulse(state: ParticleState, point, pull_kick, radius) -> ParticleState:
    """Movable gravity well with softened core and outer fade."""
    point = jnp.asarray(point, jnp.float32)
    radius = jnp.maximum(radius, 0.1)
    soften = jnp.maximum(0.15 * radius, 0.2)          # SPHFluid3D.cpp:586
    rel = point[None, :] - state.pos
    d = jnp.sqrt(jnp.sum(rel * rel, axis=-1))
    pull = pull_kick * soften / (d + soften)
    pull = pull * (1.0 - _smoothstep(0.6 * radius, radius, d))
    dv = rel / jnp.maximum(d, 1e-12)[:, None] * pull[:, None]
    ok = _live(state) & (d >= 1e-5)
    return state.replace(vel=state.vel + jnp.where(ok[:, None], dv, 0.0))


# --- Curl-noise flow ("Silk Flow") -----------------------------------------

def _hash13(p: jax.Array) -> jax.Array:
    """Value-noise hash matching CurlFlow.comp's hash13 structure."""
    p = (p * 0.1031) % 1.0
    p = p + jnp.sum(p * (p[..., ::-1] + 31.32), axis=-1, keepdims=True)
    return ((p[..., 0] + p[..., 1]) * p[..., 2]) % 1.0


def _vnoise(p: jax.Array) -> jax.Array:
    i = jnp.floor(p)
    f = p - i
    f = f * f * (3.0 - 2.0 * f)

    def corner(dx, dy, dz):
        return _hash13(i + jnp.array([dx, dy, dz], p.dtype))

    n000, n100 = corner(0, 0, 0), corner(1, 0, 0)
    n010, n110 = corner(0, 1, 0), corner(1, 1, 0)
    n001, n101 = corner(0, 0, 1), corner(1, 0, 1)
    n011, n111 = corner(0, 1, 1), corner(1, 1, 1)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    def mix(a, b, t):
        return a + (b - a) * t

    return mix(mix(mix(n000, n100, fx), mix(n010, n110, fx), fy),
               mix(mix(n001, n101, fx), mix(n011, n111, fx), fy), fz)


_P2_OFF = jnp.array([31.416, 47.853, 12.793], jnp.float32)
_P3_OFF = jnp.array([-233.145, 93.912, 55.121], jnp.float32)


def curl_noise(q: jax.Array) -> jax.Array:
    """curl of three decorrelated value-noise potentials (central diff)."""
    hh = 0.35

    def p1(x):
        return _vnoise(x)

    def p2(x):
        return _vnoise(x + _P2_OFF)

    def p3(x):
        return _vnoise(x + _P3_OFF)

    ex = jnp.array([hh, 0.0, 0.0], jnp.float32)
    ey = jnp.array([0.0, hh, 0.0], jnp.float32)
    ez = jnp.array([0.0, 0.0, hh], jnp.float32)
    d_p3_dy = p3(q + ey) - p3(q - ey)
    d_p2_dz = p2(q + ez) - p2(q - ez)
    d_p1_dz = p1(q + ez) - p1(q - ez)
    d_p3_dx = p3(q + ex) - p3(q - ex)
    d_p2_dx = p2(q + ex) - p2(q - ex)
    d_p1_dy = p1(q + ey) - p1(q - ey)
    curl = jnp.stack([d_p3_dy - d_p2_dz, d_p1_dz - d_p3_dx,
                      d_p2_dx - d_p1_dy], axis=-1)
    return curl / (2.0 * hh)


def curl_flow(state: ParticleState, kick, scale, time) -> ParticleState:
    """Divergence-free drift; direction from curl noise, magnitude soft-capped."""
    scale = jnp.maximum(scale, 1e-3)
    q = state.pos * scale + jnp.stack(
        [jnp.float32(0.0), jnp.float32(0.0), jnp.asarray(time, jnp.float32)])
    curl = curl_noise(q)
    m = jnp.sqrt(jnp.sum(curl * curl, axis=-1))
    direction = jnp.where((m > 1e-5)[:, None],
                          curl / jnp.maximum(m, 1e-12)[:, None], 0.0)
    dv = direction * (jnp.minimum(m, 1.0) * kick)[:, None]
    return state.replace(
        vel=state.vel + jnp.where(_live(state)[:, None], dv, 0.0))


def stencil_attract(state: ParticleState, targets: jax.Array, num_targets,
                    pull_kick, damp) -> ParticleState:
    """Liquid Logo: particle i springs toward targets[i % num_targets].

    ``targets`` is a fixed-capacity [T,3] buffer; ``num_targets`` a traced
    count (0 disables).  Damp is clamped to 0.5 as in SPHFluid3D.cpp:631.
    """
    cap = targets.shape[0]
    num = jnp.clip(num_targets, 0, cap)
    idx = jnp.where(num > 0, state.orig_id % jnp.maximum(num, 1), 0)
    tgt = targets[idx]
    damp = jnp.minimum(damp, 0.5)
    d = tgt - state.pos
    new_vel = (state.vel + d * pull_kick) * (1.0 - damp)
    ok = _live(state) & (num > 0)
    return state.replace(vel=jnp.where(ok[:, None], new_vel, state.vel))
