"""Shared palette block — vectorized rebuild of the reference's GLSL
palette system (``shaders/particleImpostor.frag:44-258``, duplicated in
``defaultFrag.glsl``): 24 palettes, 7 color drives, palette flow
animation, two-color groups, HSV grade, and fake-sphere lit shading.

Everything is pure ``jax.numpy`` over ``[N]`` particle batches (f32), so
palette evaluation jits and fuses into the headless export path on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

TWO_PI = 6.2831853

# color drives (particleImpostor.frag:44-55)
DRIVE_HEIGHT = 0
DRIVE_SPEED = 1
DRIVE_PRESSURE = 2
DRIVE_DENSITY = 3
DRIVE_VIEW_DEPTH = 4
DRIVE_VELOCITY_DIR = 5
DRIVE_RADIAL_DIST = 6

NUM_PALETTES = 24


@dataclasses.dataclass(frozen=True)
class VizParams:
    """Uniforms of the shared palette block (reference UI state)."""
    palette_id: int = 0
    palette_id2: int = -1          # two-color mode; <0 disables
    color_drive: int = 0
    height_min: float = -7.0
    height_max: float = 7.0
    viz_min: float = 0.0
    viz_max: float = 10.0
    box_center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    palette_flow: float = 0.0
    anim_time: float = 0.0
    irid_freq: float = 1.0
    irid_shift: float = 0.0
    duo_color_a: Tuple[float, float, float] = (0.1, 0.2, 0.9)
    duo_color_b: Tuple[float, float, float] = (0.95, 0.55, 0.15)
    pattern_scale: float = 0.35
    hue_shift: float = 0.0
    sat_mul: float = 1.0
    bright_mul: float = 1.0
    contrast_mul: float = 1.0
    invert_color: bool = False
    lit_sphere: bool = True
    sun_dir: Tuple[float, float, float] = (0.35, 0.8, 0.45)
    sun_color: Tuple[float, float, float] = (1.0, 0.96, 0.9)


def remap01(v, lo, hi):
    return jnp.clip((v - lo) / jnp.maximum(1e-6, hi - lo), 0.0, 1.0)


def rgb2hsv(c):
    """Branchless RGB->HSV over [..., 3] (frag:58-65 semantics)."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    d = mx - mn
    safe = jnp.maximum(d, 1e-10)
    h = jnp.where(
        mx == r, ((g - b) / safe) % 6.0,
        jnp.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = jnp.where(d <= 1e-10, 0.0, h / 6.0)
    s = jnp.where(mx > 1e-10, d / jnp.maximum(mx, 1e-10), 0.0)
    return jnp.stack([h, s, mx], axis=-1)


def hsv2rgb(c):
    """HSV->RGB over [..., 3] (frag:67-71 semantics)."""
    h, s, v = c[..., 0], c[..., 1], c[..., 2]
    k = jnp.stack([h + 1.0, h + 2.0 / 3.0, h + 1.0 / 3.0], axis=-1)
    p = jnp.abs((k % 1.0) * 6.0 - 3.0)
    return (v[..., None]
            * ((1.0 - s[..., None])
               + s[..., None] * jnp.clip(p - 1.0, 0.0, 1.0)))


def hash13(p):
    """Compact 3->1 hash (frag:74-78) for pattern palettes."""
    p = (p * 0.1031) % 1.0
    p = p + jnp.sum(p * (p[..., ::-1] + 31.32), axis=-1, keepdims=True)
    return ((p[..., 0] + p[..., 1]) * p[..., 2]) % 1.0


def vnoise(p):
    """Trilinear value noise (frag:80-94)."""
    i = jnp.floor(p)
    f = p - i
    f = f * f * (3.0 - 2.0 * f)

    def corner(dx, dy, dz):
        return hash13(i + jnp.asarray([dx, dy, dz], p.dtype))

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    lerp = lambda a, b, t: a + (b - a) * t
    n00 = lerp(corner(0, 0, 0), corner(1, 0, 0), fx)
    n10 = lerp(corner(0, 1, 0), corner(1, 1, 0), fx)
    n01 = lerp(corner(0, 0, 1), corner(1, 0, 1), fx)
    n11 = lerp(corner(0, 1, 1), corner(1, 1, 1), fx)
    return lerp(lerp(n00, n10, fy), lerp(n01, n11, fy), fz)


def fbm(p):
    """3-octave fbm (frag:96-103)."""
    v = 0.0
    a = 0.5
    for _ in range(3):
        v = v + a * vnoise(p)
        p = p * 2.03
        a = a * 0.5
    return v


def ramp4(t, c1, c2, c3, c4):
    """Piecewise 4-stop gradient (frag:133-137)."""
    c = [jnp.asarray(x, jnp.float32) for x in (c1, c2, c3, c4)]
    t = t[..., None]
    seg1 = c[0] + (c[1] - c[0]) * (t / 0.33)
    seg2 = c[1] + (c[2] - c[1]) * ((t - 0.33) / 0.33)
    seg3 = c[2] + (c[3] - c[2]) * ((t - 0.66) / 0.34)
    return jnp.where(t < 0.33, seg1, jnp.where(t < 0.66, seg2, seg3))


def height_palette(t):
    """Default blue->red height ramp (frag:105-120)."""
    return ramp4(t, (0.05, 0.15, 0.85), (0.25, 0.60, 0.90),
                 (0.80, 0.30, 0.40), (0.95, 0.10, 0.10))


def turbo(t):
    """Quadratic turbo fit (frag:122-127)."""
    t = jnp.clip(t, 0.0, 1.0)
    return jnp.stack([0.1357 + 4.0 * t - 4.5 * t * t,
                      2.0 * t - 1.0 * t * t,
                      0.6667 - 1.5 * t + 1.0 * t * t], axis=-1)


def iq_pal(t, a, b, c, d):
    """Cosine gradient (frag:129-131)."""
    a, b, c, d = (jnp.asarray(x, jnp.float32) for x in (a, b, c, d))
    return a + b * jnp.cos(TWO_PI * (c * t[..., None] + d))


def compute_drive(vp: VizParams, world_pos, view_pos, vel, pressure,
                  density):
    """The 7 color drives (frag:44-55) -> t in [0,1] per particle."""
    mode = vp.color_drive
    if mode == DRIVE_HEIGHT:
        return remap01(world_pos[:, 1], vp.height_min, vp.height_max)
    if mode == DRIVE_SPEED:
        return remap01(jnp.linalg.norm(vel, axis=-1), vp.viz_min, vp.viz_max)
    if mode == DRIVE_PRESSURE:
        return remap01(pressure, vp.viz_min, vp.viz_max)
    if mode == DRIVE_DENSITY:
        return remap01(density, vp.viz_min, vp.viz_max)
    if mode == DRIVE_VIEW_DEPTH:
        return remap01(-view_pos[:, 2], vp.viz_min, vp.viz_max)
    if mode == DRIVE_VELOCITY_DIR:
        vxz2 = vel[:, 0] ** 2 + vel[:, 2] ** 2
        ang = jnp.arctan2(vel[:, 2], vel[:, 0]) / TWO_PI + 0.5
        return jnp.where(vxz2 < 1e-12, 0.0, ang % 1.0)
    center = jnp.asarray(vp.box_center, jnp.float32)
    return remap01(jnp.linalg.norm(world_pos - center, axis=-1),
                   vp.viz_min, vp.viz_max)


def apply_palette(vp: VizParams, pid: int, t, facing, world_pos):
    """One palette id -> [N,3] RGB (frag:139-240)."""
    if vp.palette_flow != 0.0:
        t = (t + vp.palette_flow * vp.anim_time) % 1.0
    at = vp.anim_time

    if pid == 0:
        return height_palette(t)
    if pid == 1:
        return turbo(t)
    if pid == 2:    # Neon / Synthwave
        return ramp4(t, (0.05, 0.01, 0.18), (0.45, 0.05, 0.65),
                     (1.00, 0.15, 0.55), (0.15, 0.95, 1.00))
    if pid == 3:    # Fire / Lava
        return ramp4(t, (0.02, 0.00, 0.00), (0.55, 0.05, 0.00),
                     (1.00, 0.45, 0.00), (1.00, 0.95, 0.55))
    if pid == 4:    # Iridescent / Oil slick
        return iq_pal(t + vp.irid_freq * (1.0 - facing) + vp.irid_shift,
                      (0.5,) * 3, (0.5,) * 3, (1.0,) * 3, (0.00, 0.33, 0.67))
    if pid == 5:    # Ice
        return ramp4(t, (0.02, 0.08, 0.20), (0.15, 0.45, 0.75),
                     (0.55, 0.85, 0.95), (0.95, 1.00, 1.00))
    if pid == 6:    # Vaporwave
        return ramp4(t, (0.16, 0.06, 0.35), (0.85, 0.35, 0.85),
                     (1.00, 0.55, 0.75), (0.35, 0.95, 0.90))
    if pid == 7:    # Toxic
        return ramp4(t, (0.01, 0.03, 0.01), (0.05, 0.35, 0.05),
                     (0.45, 0.95, 0.10), (0.95, 1.00, 0.30))
    if pid == 8:    # Duotone
        a = jnp.asarray(vp.duo_color_a, jnp.float32)
        b = jnp.asarray(vp.duo_color_b, jnp.float32)
        return a + (b - a) * t[..., None]
    if pid == 9:    # Galaxy / Nebula
        return (iq_pal(t, (0.20, 0.10, 0.35), (0.35, 0.25, 0.55),
                       (1.00, 1.20, 0.70), (0.10, 0.35, 0.65))
                + jnp.asarray([0.10, 0.00, 0.25])
                * (1.0 - facing)[..., None])
    if pid == 10:   # Plasma
        p = jnp.sin(t * 12.566 + facing * TWO_PI) * 0.5 + 0.5
        q = jnp.sin(t * 8.377 - facing * 9.4248) * 0.5 + 0.5
        return jnp.stack([p, q, 1.0 - p * q], axis=-1)
    if pid == 11:   # Chrome
        base = jnp.broadcast_to(0.05 + 0.80 * t[..., None],
                                t.shape + (3,))
        return base + ((1.0 - facing) ** 2.0)[..., None]
    if pid == 12:   # Molten Gold
        base = ramp4(t, (0.10, 0.04, 0.00), (0.55, 0.28, 0.02),
                     (0.95, 0.65, 0.10), (1.00, 0.92, 0.55))
        glint = ((1.0 - facing) ** 2.5 * 0.6)[..., None]
        return base + jnp.asarray([1.00, 0.95, 0.80]) * glint
    if pid == 13:   # Acid Rings
        return iq_pal(t * 3.0 + vp.irid_freq * (1.0 - facing) * 2.0
                      + vp.irid_shift,
                      (0.5,) * 3, (0.5,) * 3, (2.0, 3.0, 4.0),
                      (0.00, 0.15, 0.35))
    if pid == 14:   # Aurora
        return iq_pal(t + at * 0.15, (0.15, 0.35, 0.35),
                      (0.25, 0.45, 0.45), (0.80, 1.00, 1.20),
                      (0.25, 0.55, 0.85))

    # world-space pattern palettes (frag:181-239)
    wp = (world_pos - jnp.asarray(vp.box_center, jnp.float32)) \
        * vp.pattern_scale

    if pid == 15:   # Marble Ink
        veins = jnp.sin((wp[:, 0] + wp[:, 1] * 0.7) * 1.8
                        + fbm(wp * 1.6 + jnp.asarray([0.0, at * 0.10, 0.0]))
                        * 5.0)
        v = jnp.clip((veins + 0.35) / 0.7, 0.0, 1.0)
        v = v * v * (3.0 - 2.0 * v)
        ink = jnp.asarray([0.03, 0.05, 0.14])
        vein = (jnp.asarray([0.92, 0.90, 0.85])
                + (jnp.asarray([0.95, 0.75, 0.35])
                   - jnp.asarray([0.92, 0.90, 0.85])) * t[..., None])
        return ink + (vein - ink) * v[..., None]
    if pid == 16:   # Lava Lamp
        blob = fbm(wp * 0.55 + jnp.asarray([0.0, -at * 0.12, 0.0]))
        m = jnp.clip((blob - 0.42) / 0.16, 0.0, 1.0)
        m = m * m * (3.0 - 2.0 * m)
        goo = iq_pal(t * 0.4 + blob, (0.70, 0.30, 0.10),
                     (0.35, 0.25, 0.10), (1.0,) * 3, (0.00, 0.10, 0.20))
        bg = jnp.asarray([0.12, 0.02, 0.22])
        return bg + (goo - bg) * m[..., None]
    if pid == 17:   # Disco Checker
        cp = wp * 1.2 + at * 0.25
        checker = (jnp.floor(cp[:, 0]) + jnp.floor(cp[:, 1])
                   + jnp.floor(cp[:, 2])) % 2.0
        h = (t + at * 0.05) % 1.0
        ca = hsv2rgb(jnp.stack([h, jnp.full_like(h, 0.85),
                                jnp.ones_like(h)], -1))
        cb = hsv2rgb(jnp.stack([(h + 0.5) % 1.0, jnp.full_like(h, 0.85),
                                jnp.full_like(h, 0.35)], -1))
        return ca + (cb - ca) * checker[..., None]
    if pid == 18:   # Stained Glass
        cell = jnp.floor(wp * 1.1)
        g = (wp * 1.1) % 1.0 - 0.5
        edge = jnp.max(jnp.abs(g), axis=-1)
        s = jnp.clip((edge - 0.32) / 0.18, 0.0, 1.0)
        grout = 1.0 - s * s * (3.0 - 2.0 * s)
        glass = hsv2rgb(jnp.stack([hash13(cell), jnp.full_like(edge, 0.75),
                                   jnp.full_like(edge, 0.9)], -1))
        return glass * ((0.15 + 0.85 * grout) * (0.6 + 0.4 * t))[..., None]
    if pid == 19:   # Psycho Swirl
        ang = jnp.arctan2(wp[:, 2], wp[:, 0]) / TWO_PI
        rad = jnp.sqrt(wp[:, 0] ** 2 + wp[:, 2] ** 2)
        hue = (ang + rad * 0.20 + at * 0.08 + t * 0.30) % 1.0
        return hsv2rgb(jnp.stack([hue, jnp.full_like(hue, 0.90),
                                  jnp.full_like(hue, 0.95)], -1))
    if pid == 20:   # Candy Stripes
        d = jnp.asarray([1.0, 0.35, 0.6])
        d = d / jnp.linalg.norm(d)
        s = jnp.sin(wp @ d * 5.0 + at * 0.8)
        band = jnp.clip((s + 0.25) / 0.5, 0.0, 1.0)
        band = band * band * (3.0 - 2.0 * band)
        a = jnp.asarray(vp.duo_color_a, jnp.float32)
        b = jnp.asarray(vp.duo_color_b, jnp.float32)
        return (a + (b - a) * band[..., None]) \
            * (0.65 + 0.35 * t)[..., None]
    if pid == 21:   # Electric (hologram edge glow)
        body = jnp.asarray([0.02, 0.02, 0.05])
        hue = (0.50 + t * 0.35) % 1.0
        glow = hsv2rgb(jnp.stack([hue, jnp.full_like(hue, 0.90),
                                  jnp.ones_like(hue)], -1))
        rim = (1.0 - facing) ** 1.5
        return body + glow * (rim * 1.4 + 0.08)[..., None]
    if pid == 22:   # Smoke
        n = fbm(wp * 0.8 + jnp.asarray([0.0, at * 0.05, 0.0]))
        v = jnp.clip(0.15 + 0.85 * n * (0.4 + 0.6 * t), 0.0, 1.0)
        return jnp.stack([v, v, v], axis=-1)
    # 23 = RGB Pop: posterized rainbow bands
    q = jnp.floor((t % 1.0) * 6.0) / 6.0
    return hsv2rgb(jnp.stack([q, jnp.ones_like(q), jnp.ones_like(q)], -1))


def apply_color_adjust(vp: VizParams, c):
    """HSV grade: hue shift, sat/bright/contrast, invert (frag:242-250)."""
    hsv = rgb2hsv(jnp.clip(c, 0.0, 1.0))
    h = (hsv[..., 0] + vp.hue_shift / 360.0) % 1.0
    s = jnp.clip(hsv[..., 1] * vp.sat_mul, 0.0, 1.0)
    c = hsv2rgb(jnp.stack([h, s, hsv[..., 2]], -1)) * vp.bright_mul
    c = (c - 0.5) * vp.contrast_mul + 0.5
    if vp.invert_color:
        c = 1.0 - c
    return jnp.clip(c, 0.0, 1.0)


def shade_lit(vp: VizParams, col, normal, view_dir, facing, view_mat3):
    """Fake-sphere lit shading (frag:252-258)."""
    sun = jnp.asarray(vp.sun_dir, jnp.float32)
    sun = sun / jnp.linalg.norm(sun)
    light = view_mat3 @ sun
    light = light / jnp.maximum(jnp.linalg.norm(light), 1e-9)
    diff = jnp.maximum(jnp.einsum("nc,c->n", normal, light), 0.0)
    half = light + view_dir
    half = half / jnp.maximum(
        jnp.linalg.norm(half, axis=-1, keepdims=True), 1e-9)
    spec = jnp.maximum(jnp.einsum("nc,nc->n", normal, half), 0.0) ** 48.0
    rim = (1.0 - facing) ** 3.0
    return (col * (0.35 + 0.65 * diff)[..., None]
            + jnp.asarray(vp.sun_color) * (spec * 0.6)[..., None]
            + col * (rim * 0.5)[..., None])


def particle_colors(vp: VizParams, world_pos, view_pos, vel, pressure,
                    density, color_group, facing=None):
    """Full per-particle color pipeline: drive -> palette (two-color
    groups via paletteId2, frag:273-275) -> HSV grade. ``facing`` is the
    N·V term (1.0 for flat export splats)."""
    if facing is None:
        facing = jnp.ones(world_pos.shape[0], jnp.float32)
    t = compute_drive(vp, world_pos, view_pos, vel, pressure, density)
    col = apply_palette(vp, vp.palette_id, t, facing, world_pos)
    if vp.palette_id2 >= 0:
        col2 = apply_palette(vp, vp.palette_id2, t, facing, world_pos)
        col = jnp.where((color_group == 1)[..., None], col2, col)
    return apply_color_adjust(vp, col)
