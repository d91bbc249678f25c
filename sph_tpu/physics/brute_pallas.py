"""All-pairs WCSPH substep as two fused Pallas kernels on the Triton route.

``physics/brute_force.py`` is the golden oracle, but its ``lax.map`` x
``fori_loop`` over 256-row tiles runs as about a thousand tiny serial
kernels per pass at 8k particles: latency, not arithmetic.  This module
keeps the oracle's all-pairs O(N^2) semantics (BASELINE config 1
mandates brute-force neighbors, not a cell list) and evaluates them the
n-body way: one program per ``BI`` destination rows, looping over
power-of-two source chunks of ``BJ`` rows held in registers.

1. density (self-pairs INCLUDED, ``SPHFluid.comp:89-106``)
2. force + semi-implicit-Euler integrate + XSPH (fresh self vs stale
   neighbors, ``SPHFluid.comp:177-201``) + XSPH apply + CFL speed cap

Rows are padded to a multiple of the block with far-away sentinel
positions, and the kernels mask every source row at or past ``n``.  Pair
math matches ``physics/common.py`` term for term; only the summation
order differs, so trajectories match the oracle to float32 tolerance
(``tests/test_brute_pallas.py``).  The kernels compile for a GPU only;
the CPU tests run them in Pallas interpret mode.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from sph_tpu.core.params import FluidParams
from sph_tpu.core.state import ParticleState
from sph_tpu.physics import common as C

BI = 32          # destination rows per program
BJ = 32          # source rows per inner chunk
NUM_WARPS = 4
SENTINEL_POS = 1.0e7

_PI = 3.141592653589
# pvec slots: scalars the kernels read from one small operand
(_H, _H2, _MASS, _SPIKY, _VISC_LAP, _POLY6, _MU, _ST,
 _GX, _GY, _GZ, _DT) = range(12)


def make_pvec(params: FluidParams, dt: jax.Array) -> jax.Array:
    h = params.h
    return jnp.stack([
        h, h * h, params.mass,
        -45.0 / (_PI * h**6), 45.0 / (_PI * h**6),
        315.0 / (64.0 * _PI * h**9),
        params.viscosity, params.surface_tension,
        params.gravity[0], params.gravity[1], params.gravity[2],
        jnp.asarray(dt, jnp.float32),
    ]).astype(jnp.float32)


def _density_kernel(pvec_ref, px_ref, py_ref, pz_ref, c_ref, rho_ref, *,
                    n: int, bi: int, bj: int):
    """rho_raw rows: mass * sum_j contrib_j * poly6(r2), self included."""
    h2 = pvec_ref[_H2]
    rows = pl.ds(pl.program_id(0) * bi, bi)
    px, py, pz = px_ref[rows], py_ref[rows], pz_ref[rows]

    def body(t, acc):
        j0 = t * bj
        cols = pl.ds(j0, bj)
        in_range = (j0 + jnp.arange(bj)) < n
        dx = px[:, None] - px_ref[cols][None, :]
        dy = py[:, None] - py_ref[cols][None, :]
        dz = pz[:, None] - pz_ref[cols][None, :]
        r2 = dx * dx + dy * dy + dz * dz
        live = (in_range & (c_ref[cols] > 0.0))[None, :] & (r2 < h2)
        d = jnp.maximum(h2 - r2, 0.0)
        return acc + jnp.sum(jnp.where(live, d * d * d, 0.0), axis=1)

    acc = lax.fori_loop(0, pl.cdiv(n, bj), body,
                        jnp.zeros((bi,), jnp.float32))
    rho_ref[rows] = acc * (pvec_ref[_MASS] * pvec_ref[_POLY6])


def _force_kernel(pvec_ref, px_ref, py_ref, pz_ref, vx_ref, vy_ref, vz_ref,
                  rho_ref, pres_ref, c_ref,
                  npx_ref, npy_ref, npz_ref, nvx_ref, nvy_ref, nvz_ref,
                  ax_ref, ay_ref, az_ref, *, n: int, bi: int, bj: int):
    """Force + integrate + XSPH + apply + CFL cap for one row block."""
    h = pvec_ref[_H]
    h2 = pvec_ref[_H2]
    mass = pvec_ref[_MASS]
    spiky = pvec_ref[_SPIKY]
    visc_lap = pvec_ref[_VISC_LAP]
    poly6 = pvec_ref[_POLY6]
    mu = pvec_ref[_MU]
    dt = pvec_ref[_DT]

    i0 = pl.program_id(0) * bi
    rows = pl.ds(i0, bi)
    gi = i0 + jnp.arange(bi)
    px, py, pz = px_ref[rows], py_ref[rows], pz_ref[rows]
    vx, vy, vz = vx_ref[rows], vy_ref[rows], vz_ref[rows]
    rho_i, pres_i = rho_ref[rows], pres_ref[rows]
    n_chunks = pl.cdiv(n, bj)

    def sources(t):
        """Chunk t's source fields and its [bi, bj] pair mask base."""
        j0 = t * bj
        cols = pl.ds(j0, bj)
        gj = j0 + jnp.arange(bj)
        rho_j = rho_ref[cols]
        live_j = (gj < n) & (rho_j > 0.0) & (c_ref[cols] > 0.0)
        base = live_j[None, :] & (gi[:, None] != gj[None, :])
        return (px_ref[cols], py_ref[cols], pz_ref[cols], vx_ref[cols],
                vy_ref[cols], vz_ref[cols], rho_j, pres_ref[cols], base)

    def force_body(t, carry):
        fx, fy, fz, gx, gy, gz, lc = carry
        jx, jy, jz, jvx, jvy, jvz, rho_j, pres_j, base = sources(t)
        dx = px[:, None] - jx[None, :]
        dy = py[:, None] - jy[None, :]
        dz = pz[:, None] - jz[None, :]
        r2 = dx * dx + dy * dy + dz * dz
        r = jnp.sqrt(r2)
        mask = base & (r < h)
        # pair_force_terms (physics/common.py), mu folded into the
        # viscous term (assemble_acc applies it outside the sum)
        m_over_rho = jnp.where(
            mask, mass / jnp.maximum(rho_j, 1e-12)[None, :], 0.0)
        dcl = jnp.maximum(h - r, 0.0)
        gmag = jnp.where(r > 0.0,
                         spiky * dcl * dcl / jnp.maximum(r, 1e-12), 0.0)
        lapw = m_over_rho * visc_lap * dcl
        pscale = -(pres_i[:, None] + pres_j[None, :]) * 0.5 \
            * m_over_rho * gmag
        vscale = lapw * mu
        gscale = m_over_rho * gmag
        return (fx + jnp.sum(pscale * dx + vscale * (jvx[None, :]
                                                     - vx[:, None]), 1),
                fy + jnp.sum(pscale * dy + vscale * (jvy[None, :]
                                                     - vy[:, None]), 1),
                fz + jnp.sum(pscale * dz + vscale * (jvz[None, :]
                                                     - vz[:, None]), 1),
                gx + jnp.sum(gscale * dx, 1),
                gy + jnp.sum(gscale * dy, 1),
                gz + jnp.sum(gscale * dz, 1),
                lc + jnp.sum(lapw, 1))

    z = jnp.zeros((bi,), jnp.float32)
    fx, fy, fz, gx, gy, gz, lc = lax.fori_loop(
        0, n_chunks, force_body, (z, z, z, z, z, z, z))

    # assemble_acc + integrate (common.py)
    glen = jnp.sqrt(gx * gx + gy * gy + gz * gz)
    stm = jnp.where(glen > C.SURFACE_THRESHOLD,
                    -pvec_ref[_ST] * lc / jnp.maximum(glen, 1e-30), 0.0)
    rho_safe = jnp.maximum(rho_i, 1e-12)
    ax = (fx + stm * gx + pvec_ref[_GX] * rho_i) / rho_safe
    ay = (fy + stm * gy + pvec_ref[_GY] * rho_i) / rho_safe
    az = (fz + stm * gz + pvec_ref[_GZ] * rho_i) / rho_safe
    nvx = (vx + ax * dt) * C.VELOCITY_DAMPING
    nvy = (vy + ay * dt) * C.VELOCITY_DAMPING
    nvz = (vz + az * dt) * C.VELOCITY_DAMPING
    npx = px + nvx * dt
    npy = py + nvy * dt
    npz = pz + nvz * dt

    def xsph_body(t, carry):
        sx, sy, sz, norm = carry
        jx, jy, jz, jvx, jvy, jvz, rho_j, _, base = sources(t)
        dx = npx[:, None] - jx[None, :]
        dy = npy[:, None] - jy[None, :]
        dz = npz[:, None] - jz[None, :]
        r2 = dx * dx + dy * dy + dz * dz
        d = jnp.maximum(h2 - r2, 0.0)
        w = jnp.where(base & (r2 < h2), poly6 * d * d * d, 0.0)
        mw = w * mass / jnp.maximum(rho_j, 1e-12)[None, :]
        return (sx + jnp.sum(mw * (jvx[None, :] - nvx[:, None]), 1),
                sy + jnp.sum(mw * (jvy[None, :] - nvy[:, None]), 1),
                sz + jnp.sum(mw * (jvz[None, :] - nvz[:, None]), 1),
                norm + jnp.sum(w, 1))

    sx, sy, sz, norm = lax.fori_loop(0, n_chunks, xsph_body, (z, z, z, z))
    inv = jnp.where(norm > 0.0, C.XSPH_COEFF / jnp.maximum(norm, 1e-30), 0.0)
    nvx = nvx + inv * sx
    nvy = nvy + inv * sy
    nvz = nvz + inv * sz
    max_speed = C.CFL_FRACTION * h / jnp.maximum(dt, 1e-6)
    spd = jnp.sqrt(nvx * nvx + nvy * nvy + nvz * nvz)
    vscl = jnp.where(spd > max_speed, max_speed / jnp.maximum(spd, 1e-30),
                     1.0)

    for ref, val in ((npx_ref, npx), (npy_ref, npy), (npz_ref, npz),
                     (nvx_ref, nvx * vscl), (nvy_ref, nvy * vscl),
                     (nvz_ref, nvz * vscl), (ax_ref, ax), (ay_ref, ay),
                     (az_ref, az)):
        ref[rows] = val


def _call(kernel, n: int, np_: int, n_out: int, interpret: bool,
          bi: int, bj: int, name: str):
    return pl.pallas_call(
        functools.partial(kernel, n=n, bi=bi, bj=bj),
        grid=(np_ // bi,),
        out_shape=[jax.ShapeDtypeStruct((np_,), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=name)


def padded_rows(n: int, bi: int = BI, bj: int = BJ) -> int:
    """Row count padded to a multiple of both block sizes."""
    step = max(bi, bj)
    return -(-n // step) * step


def substep(state: ParticleState, params: FluidParams, dt: jax.Array,
            interpret: bool = False, bi: int = BI, bj: int = BJ
            ) -> ParticleState:
    """Drop-in for ``brute_force.substep`` (same all-pairs semantics, fused
    kernels).  Order-preserving: no sort, rows stay put."""
    n = state.n
    np_ = padded_rows(n, bi, bj)
    pad = np_ - n

    def padded(x, fill=0.0):
        return jnp.pad(x, (0, pad), constant_values=fill)

    pvec = make_pvec(params, dt)
    contrib = state.contrib_mask(params.ghost_face_active)
    pos = [padded(state.pos[:, k], SENTINEL_POS) for k in range(3)]
    vel = [padded(state.vel[:, k]) for k in range(3)]
    c = padded(contrib.astype(jnp.float32))

    rho_raw, = _call(_density_kernel, n, np_, 1, interpret, bi, bj,
                     "sph_brute_density")(pvec, *pos, c)
    density, pressure = C.finish_density(
        rho_raw[:n], state.ghost, contrib, state.density, state.pressure,
        params)

    out = _call(_force_kernel, n, np_, 9, interpret, bi, bj,
                "sph_brute_force_xsph")(
        pvec, *pos, *vel, padded(density), padded(pressure), c)
    new_pos = jnp.stack(out[0:3], axis=1)[:n]
    new_vel = jnp.stack(out[3:6], axis=1)[:n]
    acc = jnp.stack(out[6:9], axis=1)[:n]
    foam = C.foam_update(state.foam, new_vel, density, params)

    fluid = state.fluid_mask()
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
    )
