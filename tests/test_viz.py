"""Viz tests: palette math, color drives, HSV grade, headless splat."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from sph_tpu.viz import palettes as P
from sph_tpu.viz.camera import OrbitCamera, fit_camera
from sph_tpu.viz.splat import render_frame


def _t():
    return jnp.linspace(0.0, 1.0, 64)


@pytest.mark.parametrize("pid", range(P.NUM_PALETTES))
def test_all_palettes_finite(pid):
    vp = P.VizParams(palette_id=pid, anim_time=1.5)
    t = _t()
    n = t.shape[0]
    wp = jnp.stack([t * 4 - 2, t * 8 - 4, jnp.zeros(n)], -1)
    facing = jnp.full(n, 0.7)
    c = P.apply_palette(vp, pid, t, facing, wp)
    assert c.shape == (n, 3)
    assert bool(jnp.all(jnp.isfinite(c)))
    # palettes are colorful: not all-constant across t
    assert float(jnp.std(c)) > 1e-3


def test_hsv_roundtrip():
    rng = np.random.default_rng(0)
    rgb = jnp.asarray(rng.uniform(0.05, 0.95, (128, 3)), jnp.float32)
    back = P.hsv2rgb(P.rgb2hsv(rgb))
    np.testing.assert_allclose(np.asarray(back), np.asarray(rgb), atol=1e-5)


def test_turbo_endpoints():
    c = P.turbo(jnp.asarray([0.0, 0.6]))
    # t=0 dark blue; t=0.6 red-dominant (quadratic turbo fit,
    # particleImpostor.frag:122-127 — goes negative at t=1, clamped later)
    assert c[0, 2] > c[0, 0]
    assert c[1, 0] > c[1, 2]


def test_drives():
    n = 8
    pos = np.zeros((n, 3), np.float32)
    pos[:, 1] = np.linspace(-7, 7, n)
    vel = np.zeros((n, 3), np.float32)
    vel[:, 0] = np.linspace(0, 10, n)
    vpos = np.zeros((n, 3), np.float32)
    vpos[:, 2] = -np.linspace(1, 10, n)
    pres = np.linspace(0, 10, n).astype(np.float32)
    rho = np.linspace(0, 10, n).astype(np.float32)

    for drive in range(7):
        vp = P.VizParams(color_drive=drive, viz_min=0.0, viz_max=10.0)
        t = np.asarray(P.compute_drive(vp, jnp.asarray(pos),
                                       jnp.asarray(vpos), jnp.asarray(vel),
                                       jnp.asarray(pres), jnp.asarray(rho)))
        assert t.shape == (n,)
        assert (t >= 0).all() and (t <= 1).all()
        if drive in (P.DRIVE_HEIGHT, P.DRIVE_SPEED, P.DRIVE_PRESSURE,
                     P.DRIVE_DENSITY, P.DRIVE_VIEW_DEPTH):
            assert t[-1] > t[0]        # monotone in the driven quantity


def test_velocity_dir_drive_angle():
    vp = P.VizParams(color_drive=P.DRIVE_VELOCITY_DIR)
    vel = np.array([[1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, 0]], np.float32)
    z = np.zeros((4, 3), np.float32)
    t = np.asarray(P.compute_drive(vp, z, z, jnp.asarray(vel),
                                   np.zeros(4, np.float32),
                                   np.zeros(4, np.float32)))
    assert abs(t[0] - 0.5) < 1e-5      # +x -> atan2=0 -> 0.5
    assert t[1] < 0.01 or t[1] > 0.99  # -x wraps to 0/1
    assert abs(t[2] - 0.75) < 1e-5     # +z -> pi/2 -> 0.75
    assert t[3] == 0.0                 # zero velocity -> 0


def test_color_adjust_invert_and_hue():
    c = jnp.asarray([[0.8, 0.2, 0.2]])
    vp = P.VizParams(invert_color=True)
    out = np.asarray(P.apply_color_adjust(vp, c))
    np.testing.assert_allclose(out, [[0.2, 0.8, 0.8]], atol=1e-5)

    vp = P.VizParams(hue_shift=120.0)   # red -> green
    out = np.asarray(P.apply_color_adjust(vp, c))
    assert out[0, 1] > out[0, 0] and out[0, 1] > out[0, 2]


def test_two_color_groups():
    n = 4
    vp = P.VizParams(palette_id=8, palette_id2=3,
                     duo_color_a=(0, 0, 1), duo_color_b=(0, 0, 1))
    pos = np.zeros((n, 3), np.float32)
    group = np.array([0, 1, 0, 1])
    cols = np.asarray(P.particle_colors(
        vp, jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(pos),
        jnp.zeros(n), jnp.zeros(n), jnp.asarray(group)))
    # group 0 -> duotone blue; group 1 -> fire palette (red-dominant)
    assert cols[0, 2] > cols[0, 0]
    assert cols[1, 0] >= cols[1, 2]


def test_camera_projection_center():
    cam = OrbitCamera(yaw_deg=0.0, pitch_deg=0.0, distance=10.0)
    view = cam.view_matrix()
    target_view = view[:3, :3] @ cam.target + view[:3, 3]
    np.testing.assert_allclose(target_view, [0, 0, -10], atol=1e-5)
    eye_view = view[:3, :3] @ cam.eye() + view[:3, 3]
    np.testing.assert_allclose(eye_view, [0, 0, 0], atol=1e-5)


def test_render_frame_smoke(dam_break_small):
    state, params, dims = dam_break_small
    vp = P.VizParams(palette_id=1, color_drive=P.DRIVE_SPEED)
    cam = fit_camera(np.asarray([7.0, 7.0, 7.0]))
    img = render_frame(state, vp, cam, width=160, height=90)
    assert img.shape == (90, 160, 3)
    assert img.dtype == np.uint8
    # particles visible: image differs from pure background
    bg = np.array([0.03, 0.04, 0.06]) * 255
    diff = np.abs(img.astype(np.float32) - bg).sum(-1)
    assert (diff > 30).sum() > 50


def test_render_ghosts_hidden(dam_break_small):
    state, params, dims = dam_break_small
    ghost_state = dataclasses.replace(
        state, ghost=jnp.ones_like(state.ghost))
    vp = P.VizParams()
    cam = fit_camera(np.asarray([7.0, 7.0, 7.0]))
    img = render_frame(ghost_state, vp, cam, width=64, height=36)
    bg = (np.array([0.03, 0.04, 0.06]) * 255).astype(np.uint8)
    assert (img == bg[None, None, :]).all()


def _tiny_scene():
    from sph_tpu.core import state as S
    spawn = S.spawn_standard(512, h=0.28, box_half=(4.0, 4.0, 4.0), seed=3)
    st = S.state_from_spawn(spawn)
    vp = P.VizParams(palette_id=2, color_drive=P.DRIVE_SPEED,
                     lit_sphere=True)
    cam = fit_camera(np.asarray([4.0, 4.0, 4.0]))
    return st, vp, cam


def test_native_splat_matches_numpy(monkeypatch):
    """The C++ rasterizer and the numpy fallback agree (the native path
    is painter-exact across offsets, so allow a small differing-pixel
    fraction at particle overlaps)."""
    from sph_tpu import native
    from sph_tpu.viz import splat as SP
    if native.load("splat_raster") is None:
        import pytest
        pytest.skip("no native toolchain")
    st, vp, cam = _tiny_scene()
    a = SP.render_frame(st, vp, cam, width=160, height=120)
    monkeypatch.setattr(SP, "_native_lib", lambda: None)
    b = SP.render_frame(st, vp, cam, width=160, height=120)
    diff = (np.abs(a.astype(int) - b.astype(int)) > 2).any(axis=-1)
    assert diff.mean() < 0.02


def test_native_ssfr_splat_matches_numpy(monkeypatch):
    from sph_tpu import native
    from sph_tpu.viz import ssfr as SS
    lib = native.load("splat_raster")
    if lib is None:
        import pytest
        pytest.skip("no native toolchain")
    st, vp, cam = _tiny_scene()
    view = cam.view_matrix()
    proj = cam.proj_matrix(160 / 120)
    d1, t1, f1 = SS.splat_depth_thickness(
        st.pos, st.foam, view, proj, 160, 120, 0.2)
    monkeypatch.setattr(native, "load", lambda name: None)
    d2, t2, f2 = SS.splat_depth_thickness(
        st.pos, st.foam, view, proj, 160, 120, 0.2)
    # depth assignment differs only where splats overlap
    assert (np.abs(d1 - d2) > 1e-4).mean() < 0.02
    np.testing.assert_allclose(t1, t2, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f1, f2, rtol=1e-4, atol=1e-4)


# --- palette math pinned numerically to the GLSL formulas ---
# (beyond structural checks, assert per-palette
# values against hand-evaluated particleImpostor.frag constants)

def _vp(pid, **kw):
    from sph_tpu.viz.palettes import VizParams
    return VizParams(palette_id=pid, **kw)


def test_turbo_pinned_values():
    """turbo(t) quadratic fit (particleImpostor.frag:122-127)."""
    from sph_tpu.viz import palettes as P
    t = jnp.asarray([0.0, 0.25, 1.0, 1.5])  # 1.5 clamps to 1.0
    got = np.asarray(P.turbo(t))
    exp = np.array([
        [0.1357, 0.0, 0.6667],
        [0.1357 + 1.0 - 4.5 * 0.0625, 0.5 - 0.0625,
         0.6667 - 0.375 + 0.0625],
        [0.1357 + 4.0 - 4.5, 1.0, 0.6667 - 1.5 + 1.0],
        [0.1357 + 4.0 - 4.5, 1.0, 0.6667 - 1.5 + 1.0],
    ], np.float32)
    np.testing.assert_allclose(got, exp, atol=1e-6)


def test_ramp4_pinned_stops_and_midpoints():
    """ramp4 breakpoints at 0.33/0.66/0.34 (frag:133-137)."""
    from sph_tpu.viz import palettes as P
    c1, c2 = (0.05, 0.01, 0.18), (0.45, 0.05, 0.65)
    c3, c4 = (1.00, 0.45, 0.95), (1.00, 0.95, 1.00)  # frag pid 2 stops
    t = jnp.asarray([0.0, 0.165, 0.33, 0.495, 0.66, 1.0])
    got = np.asarray(P.ramp4(t, c1, c2, c3, c4))
    a = lambda c: np.asarray(c, np.float32)
    exp = np.stack([
        a(c1),
        0.5 * (a(c1) + a(c2)),
        a(c2),
        a(c2) + (a(c3) - a(c2)) * np.float32((0.495 - 0.33) / 0.33),
        a(c3),
        a(c4),
    ])
    np.testing.assert_allclose(got, exp, atol=2e-6)


def test_iq_pal_pinned_values():
    """iqPal cosine gradient a + b cos(2pi(c t + d)) (frag:129-131)."""
    from sph_tpu.viz import palettes as P
    a, b = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
    c, d = (1.0, 1.0, 1.0), (0.0, 0.33, 0.67)
    t = jnp.asarray([0.0, 0.5])
    got = np.asarray(P.iq_pal(t, a, b, c, d))
    tau = 2.0 * np.pi
    exp = np.array(
        [[0.5 + 0.5 * np.cos(tau * (tt + dd)) for dd in d]
         for tt in [0.0, 0.5]], np.float32)
    np.testing.assert_allclose(got, exp, atol=1e-6)


def test_plasma_palette_pinned_formula():
    """pid 10 Plasma: p/q sine mix (frag:161-165)."""
    from sph_tpu.viz import palettes as P
    t = np.float32(0.37)
    facing = np.float32(0.62)
    vp = _vp(10)
    got = np.asarray(P.apply_palette(
        vp, 10, jnp.asarray([t]), jnp.asarray([facing]),
        jnp.zeros((1, 3), jnp.float32)))[0]
    p = np.sin(t * 12.566 + facing * 6.2831853) * 0.5 + 0.5
    q = np.sin(t * 8.377 - facing * 9.4248) * 0.5 + 0.5
    exp = np.array([p, q, 1.0 - p * q], np.float32)
    np.testing.assert_allclose(got, exp, atol=1e-5)


def test_hsv2rgb_pinned_values():
    """hsv2rgb via the K-vector formulation (frag:66-70)."""
    from sph_tpu.viz import palettes as P

    def ref(h, s, v):
        out = []
        for off in (1.0, 2.0 / 3.0, 1.0 / 3.0):
            p = abs(((h + off) % 1.0) * 6.0 - 3.0)
            out.append(v * (1.0 * (1.0 - s)
                            + s * min(max(p - 1.0, 0.0), 1.0)))
        return out

    cases = [(0.0, 1.0, 1.0), (1.0 / 3.0, 1.0, 0.5), (0.78, 0.4, 0.9)]
    got = np.asarray(P.hsv2rgb(jnp.asarray(cases, jnp.float32)))
    exp = np.array([ref(*c) for c in cases], np.float32)
    np.testing.assert_allclose(got, exp, atol=1e-6)
    # sanity: pure red / green
    np.testing.assert_allclose(got[0], [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(got[1], [0.0, 0.5, 0.0], atol=1e-6)


def test_hash_noise_fbm_match_glsl_reference():
    """hash13 / vnoise / fbm pattern primitives (frag:73-103) against
    an independent float64 evaluation of the same GLSL formulas."""
    from sph_tpu.viz import palettes as P

    f32 = np.float32

    def hash13(p):
        # evaluated in float32 throughout — GLSL floats are 32-bit and
        # the fract-of-products is chaotic under precision changes
        p = np.asarray(p, f32)
        p = (p * f32(0.1031)) % f32(1.0)
        p = (p + np.dot(p, p[::-1] + f32(31.32)).astype(f32)).astype(f32)
        return ((p[0] + p[1]) * p[2]) % f32(1.0)

    def vnoise(p):
        p = np.asarray(p, f32)
        i = np.floor(p)
        f = p - i
        f = f * f * (f32(3.0) - f32(2.0) * f)
        mix = lambda a, b, t: a + (b - a) * t
        n = {k: hash13(i + np.asarray(k, f32))
             for k in [(x, y, z) for z in (0, 1) for y in (0, 1)
                       for x in (0, 1)]}
        return mix(
            mix(mix(n[(0, 0, 0)], n[(1, 0, 0)], f[0]),
                mix(n[(0, 1, 0)], n[(1, 1, 0)], f[0]), f[1]),
            mix(mix(n[(0, 0, 1)], n[(1, 0, 1)], f[0]),
                mix(n[(0, 1, 1)], n[(1, 1, 1)], f[0]), f[1]), f[2])

    def fbm(p):
        p = np.asarray(p, f32)
        v, a = f32(0.0), f32(0.5)
        for _ in range(3):
            v += a * vnoise(p)
            p = (p * f32(2.03)).astype(f32)
            a *= f32(0.5)
        return v

    pts = np.array([[0.3, 1.7, 2.9], [5.1, 0.2, 3.3], [9.9, 9.1, 0.7]])
    got_h = np.asarray(P.hash13(jnp.asarray(pts, jnp.float32)))
    exp_h = np.array([hash13(p) for p in pts])
    np.testing.assert_allclose(got_h, exp_h, atol=1e-4)
    got_n = np.asarray(P.vnoise(jnp.asarray(pts, jnp.float32)))
    exp_n = np.array([vnoise(p) for p in pts])
    np.testing.assert_allclose(got_n, exp_n, atol=1e-4)
    got_f = np.asarray(P.fbm(jnp.asarray(pts, jnp.float32)))
    exp_f = np.array([fbm(p) for p in pts])
    np.testing.assert_allclose(got_f, exp_f, atol=1e-4)
