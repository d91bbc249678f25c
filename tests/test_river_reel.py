"""River terrain generation + reel export tests."""
import os

import numpy as np
import pytest

from sph_tpu.audio.analyze import ReelAnalysis
from sph_tpu.scene.reel import ReelConfig, export_reel
from sph_tpu.scene.river import RiverSpec, generate_river_terrain, river_params
from sph_tpu.scene.scene import Scene
from sph_tpu.scene.settings import SceneSettings


def test_river_terrain_shape_and_channel():
    spec = RiverSpec.random(seed=3)
    half = [7.0, 7.0, 7.0]
    h = generate_river_terrain(spec, [0, 0, 0], half, res=(64, 64))
    assert h.shape == (64, 64)
    assert np.isfinite(h).all()
    y_base = -7.0
    # floor never punches through the box floor
    assert h.min() >= y_base - 0.3 - 1e-5
    # the channel is carved: min height is near the river floor, well
    # below the plateau
    assert h.min() < h.max() - spec.channel_depth * 0.8
    # channel follows the sinusoid: at each z row, the minimum column is
    # near center_x
    wz = -7.0 + (np.arange(64) / 63.0) * 14.0
    centers = spec.amp * np.sin(spec.freq * wz + spec.phase)
    wx = -7.0 + (np.arange(64) / 63.0) * 14.0
    argmin_x = wx[np.argmin(h, axis=1)]
    assert np.median(np.abs(argmin_x - centers)) < spec.channel_width


def test_river_terrain_deterministic():
    a = generate_river_terrain(RiverSpec.random(5), [0, 0, 0], [7, 7, 7])
    b = generate_river_terrain(RiverSpec.random(5), [0, 0, 0], [7, 7, 7])
    np.testing.assert_array_equal(a, b)
    c = generate_river_terrain(RiverSpec.random(6), [0, 0, 0], [7, 7, 7])
    assert not np.array_equal(a, c)


def test_river_params_wiring():
    from sph_tpu.core.params import FluidParams
    spec = RiverSpec.random(1)
    p = river_params(FluidParams.default(), spec, [0, 0, 0], [7, 7, 7])
    assert abs(float(p.river_amp) - spec.amp) < 1e-6
    emitter = np.asarray(p.river_emitter_pos)
    assert emitter[2] == pytest.approx(-6.5)        # upstream mouth
    assert float(p.river_sink_y) == pytest.approx(-6.7)
    assert float(p.gravity[1]) == pytest.approx(-120.0)


def _synthetic_analysis(n_frames=4, fps=30):
    a = ReelAnalysis(frame_count=n_frames, sample_rate=48000)
    a.bass = np.linspace(0.2, 1.0, n_frames).astype(np.float32)
    a.mid = np.full(n_frames, 0.3, np.float32)
    a.treble = np.full(n_frames, 0.1, np.float32)
    return a


def test_reel_export_deterministic(tmp_path):
    def make_scene():
        s = SceneSettings()
        s.particle_count = 1000
        s.audio_enabled = True
        s.time_step = 4e-3          # few substeps per frame, fast test
        return Scene(settings=s, neighbor_impl="cell", seed=1)

    cfg = ReelConfig(track_path="", out_dir=str(tmp_path / "a"),
                     fps=30, width=64, height=96)
    r1 = export_reel(make_scene(), cfg, analysis=_synthetic_analysis())
    assert r1.ok
    assert r1.frames_written == 4
    assert os.path.exists(r1.mux_script)

    cfg2 = ReelConfig(track_path="", out_dir=str(tmp_path / "b"),
                      fps=30, width=64, height=96)
    r2 = export_reel(make_scene(), cfg2, analysis=_synthetic_analysis())

    from sph_tpu.viz.splat import load_png
    for f in range(4):
        a = load_png(str(tmp_path / "a" / f"frame_{f:05d}.png"))
        b = load_png(str(tmp_path / "b" / f"frame_{f:05d}.png"))
        np.testing.assert_array_equal(a, b)


def test_reel_export_bad_track(tmp_path):
    s = SceneSettings()
    s.particle_count = 1000
    scene = Scene(settings=s, neighbor_impl="cell")
    r = export_reel(scene, ReelConfig(track_path="missing.ogg",
                                      out_dir=str(tmp_path)))
    assert not r.ok
    assert r.error

def test_preview_size_fit():
    """EnsurePreviewTarget sizing math (Scene0p.cpp:3240-3247): fill
    window height at the reel aspect, shrink to width on overflow."""
    from sph_tpu.scene.reel import preview_size
    # portrait 1080x1920 reel into a 960x540 landscape window
    pw, ph = preview_size(1080, 1920, 960, 540)
    assert (pw, ph) == (304, 540)
    # landscape reel wider than window: width-limited
    pw, ph = preview_size(1920, 1080, 960, 540)
    assert (pw, ph) == (960, 540)
    pw, ph = preview_size(1920, 1080, 500, 540)
    assert (pw, ph) == (500, 281)
    # degenerate windows floor at 2
    assert preview_size(1080, 1920, 1, 1) == (2, 2)


def test_reel_preview_reduced_res(tmp_path):
    """reel --preview: same deterministic
    pipeline at window-fitted reduced res, frames in <out>_preview."""
    from sph_tpu.scene.reel import preview_reel

    s = SceneSettings()
    s.particle_count = 1000
    s.audio_enabled = True
    s.time_step = 4e-3
    scene = Scene(settings=s, neighbor_impl="cell", seed=1)
    cfg = ReelConfig(track_path="", out_dir=str(tmp_path / "reel"),
                     fps=30, width=1080, height=1920, supersample=2)
    r = preview_reel(scene, cfg, window_w=96, window_h=64,
                     analysis=_synthetic_analysis(2))
    assert r.ok and r.frames_written == 2
    from sph_tpu.viz.splat import load_png
    img = load_png(str(tmp_path / "reel_preview" / "frame_00000.png"))
    assert img.shape[1::-1] == (36, 64)    # 1080:1920 aspect into 96x64
    assert not os.path.exists(tmp_path / "reel")   # full export untouched
