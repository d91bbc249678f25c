"""The three neighbor sweeps over binned field planes.

Each sweep enumerates the 27 neighbor-cell offsets x K source slots and
accumulates masked pair terms over [K, rows, nx] planes.  Two drivers share
the same inner pair math:

- ``unroll=True``  — the 27 offsets are a static python loop, every source
  a *static* slice, so XLA can fuse the whole sweep; the graph is ~27x
  bigger and compiles slowly.
- ``unroll=False`` — ``lax.fori_loop`` over the offset table with dynamic
  slices.  ~27x smaller graph, compiles fast (the default).

Pair-term semantics mirror ``physics/common.py`` / ``shaders/SPHFluid.comp``.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from sph_tpu.core.params import FluidParams
from sph_tpu.physics import common as C

_PI = 3.141592653589

OFFSETS = [(dx, dy, dz)
           for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
ZERO_OFF_INDEX = OFFSETS.index((0, 0, 0))
HALO_X = 1


def halo_rows(dims: Tuple[int, int, int]) -> int:
    return dims[1] + 1  # dy + ny*dz reaches at most +-(ny+1) rows


def pad_plane(plane: jax.Array, dims: Tuple[int, int, int],
              sentinel: float = 0.0) -> jax.Array:
    hr = halo_rows(dims)
    return jnp.pad(plane, ((0, 0), (hr, hr), (HALO_X, HALO_X)),
                   constant_values=sentinel)


def center(plane: jax.Array, dims: Tuple[int, int, int]) -> jax.Array:
    nx, ny, nz = dims
    hr = halo_rows(dims)
    return lax.slice(plane, (0, hr, HALO_X),
                     (plane.shape[0], hr + ny * nz, HALO_X + nx))


def _drive(dims: Tuple[int, int, int], cap: int, unroll: bool,
           make_src, inner, init_carry):
    """Run ``inner(carry, src, k2, is_zero_off)`` over 27 offsets x K slots.

    ``make_src(k2, dx, dy, dz)`` (static) / ``make_src_dyn(k2, r0, x0)``
    duality is hidden behind the closures below.
    """
    nx, ny, nz = dims
    hr = halo_rows(dims)
    if unroll:
        carry = init_carry
        for (dx, dy, dz) in OFFSETS:
            is_zero = (dx == 0 and dy == 0 and dz == 0)
            for k2 in range(cap):
                def src(plane, k2=k2, dx=dx, dy=dy, dz=dz):
                    r0 = hr + dy + ny * dz
                    return lax.slice(
                        plane, (k2, r0, HALO_X + dx),
                        (k2 + 1, r0 + ny * nz, HALO_X + dx + nx))
                carry = inner(carry, src, k2, is_zero)
        return carry

    offs = jnp.asarray(OFFSETS, jnp.int32)

    def body(o, carry):
        dx = offs[o, 0]
        dy = offs[o, 1]
        dz = offs[o, 2]
        r0 = hr + dy + ny * dz
        x0 = HALO_X + dx
        is_zero = o == ZERO_OFF_INDEX
        for k2 in range(cap):
            def src(plane, k2=k2):
                return lax.dynamic_slice(plane, (k2, r0, x0),
                                         (1, ny * nz, nx))
            carry = inner(carry, src, k2, is_zero)
        return carry

    return lax.fori_loop(0, 27, body, init_carry)


def _self_mask(is_zero, k2: int, cap: int, shape):
    """True on the (zero-offset, k1 == k2) self pair."""
    row = jax.nn.one_hot(k2, cap, dtype=bool, axis=0)[:, None, None]
    row = jnp.broadcast_to(row, shape)
    if isinstance(is_zero, bool):
        return row if is_zero else jnp.zeros(shape, bool)
    return jnp.broadcast_to(is_zero, shape) & row


def density_sweep(bins, params: FluidParams, dims, cap: int,
                  unroll: bool) -> jax.Array:
    """rho_raw planes [K, rows, nx].  Self-pairs included
    (``SPHFluid.comp:89-106``); sentinel slots fail r^2 < h^2."""
    h2 = params.h * params.h
    coef = 315.0 / (64.0 * _PI * params.h**9)
    cx = center(bins.px, dims)
    cy = center(bins.py, dims)
    cz = center(bins.pz, dims)

    def inner(acc, src, k2, is_zero):
        ddx = cx - src(bins.px)
        ddy = cy - src(bins.py)
        ddz = cz - src(bins.pz)
        r2 = ddx * ddx + ddy * ddy + ddz * ddz
        d = jnp.maximum(h2 - r2, 0.0)
        return acc + d * d * d

    acc = _drive(dims, cap, unroll, None, inner, jnp.zeros_like(cx))
    return params.mass * coef * acc


def force_sweep(bins, rho_p, pres_p, rho_pad, pres_pad,
                params: FluidParams, dims, cap: int, unroll: bool):
    """Pressure/viscosity forces + surface-tension accumulators.

    Returns (fx, fy, fz, gcx, gcy, gcz, lc) planes; viscosity is already
    scaled by mu and folded into f*.
    """
    h = params.h
    spiky_c = -45.0 / (_PI * h**6)
    visc_c = 45.0 / (_PI * h**6)
    cx = center(bins.px, dims)
    cy = center(bins.py, dims)
    cz = center(bins.pz, dims)
    cvx = center(bins.vx, dims)
    cvy = center(bins.vy, dims)
    cvz = center(bins.vz, dims)

    def inner(carry, src, k2, is_zero):
        fx, fy, fz, gcx, gcy, gcz, lc = carry
        ddx = cx - src(bins.px)
        ddy = cy - src(bins.py)
        ddz = cz - src(bins.pz)
        r2 = ddx * ddx + ddy * ddy + ddz * ddz
        r = jnp.sqrt(r2)
        inside = (r < h) & ~_self_mask(is_zero, k2, cap, r.shape)
        srho = src(rho_pad)
        spres = src(pres_pad)
        mw = jnp.where(inside, params.mass / srho, 0.0)
        dcl = jnp.maximum(h - r, 0.0)
        gmag = jnp.where(r > 0.0,
                         spiky_c * dcl * dcl / jnp.maximum(r, 1e-12), 0.0)
        lapw = visc_c * dcl
        pscale = -(pres_p + spres) * 0.5 * mw * gmag
        vscale = mw * lapw * params.viscosity
        fx = fx + pscale * ddx + vscale * (src(bins.vx) - cvx)
        fy = fy + pscale * ddy + vscale * (src(bins.vy) - cvy)
        fz = fz + pscale * ddz + vscale * (src(bins.vz) - cvz)
        gscale = mw * gmag
        gcx = gcx + gscale * ddx
        gcy = gcy + gscale * ddy
        gcz = gcz + gscale * ddz
        lc = lc + mw * lapw
        return (fx, fy, fz, gcx, gcy, gcz, lc)

    z = jnp.zeros_like(cx)
    return _drive(dims, cap, unroll, None, inner, (z, z, z, z, z, z, z))


def xsph_sweep(bins, rho_pad, npx, npy, npz, nvx, nvy, nvz,
               params: FluidParams, dims, cap: int, unroll: bool):
    """XSPH smoothing: fresh self pos/vel vs stale neighbor pos/vel
    (``SPHFluid.comp:177-201``)."""
    h2 = params.h * params.h
    poly6_c = 315.0 / (64.0 * _PI * params.h**9)

    def inner(carry, src, k2, is_zero):
        xx, xy, xz, norm = carry
        ddx = npx - src(bins.px)
        ddy = npy - src(bins.py)
        ddz = npz - src(bins.pz)
        r2 = ddx * ddx + ddy * ddy + ddz * ddz
        inside = (r2 < h2) & ~_self_mask(is_zero, k2, cap, r2.shape)
        d = jnp.maximum(h2 - r2, 0.0)
        w = jnp.where(inside, poly6_c * d * d * d, 0.0)
        mw = w * params.mass / src(rho_pad)
        xx = xx + mw * (src(bins.vx) - nvx)
        xy = xy + mw * (src(bins.vy) - nvy)
        xz = xz + mw * (src(bins.vz) - nvz)
        return (xx, xy, xz, norm + w)

    z = jnp.zeros_like(npx)
    return _drive(dims, cap, unroll, None, inner, (z, z, z, z))
