"""Scene layer tests: preset schema round-trip, structural split, art
presets, sequencer cuts/morphs, reaction driver, checkpointing."""
import dataclasses
import os

import numpy as np
import pytest

from sph_tpu.io import presets as pio
from sph_tpu.scene import art_presets as AP
from sph_tpu.scene import settings as SET
from sph_tpu.scene.reaction import (ReactionPhases, drive_audio_reaction,
                                    drive_continuous_wave)
from sph_tpu.scene.scene import Scene, params_from_settings
from sph_tpu.scene.sequencer import SeqCue, Sequencer
from sph_tpu.scene.settings import SceneSettings


def test_preset_roundtrip_identity():
    s = SceneSettings()
    s.viscosity = 7.25
    s.palette_id = 13
    s.duo_color_a = [0.1, 0.2, 0.3]
    s.logo_path = "logos/x.png"
    kv = SET.gather_preset(s)
    s2 = SET.apply_preset(SceneSettings(), kv, structural=True)
    for _, attr, kind, _s in SET.PRESET_FIELDS:
        a, b = getattr(s, attr), getattr(s2, attr)
        if kind == "f3":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=attr)
        elif kind == "f":
            assert abs(a - b) <= 1e-6 * max(1, abs(a)), attr
        else:
            assert a == b, attr


def test_preset_text_format_compatible():
    """Serialized text uses the reference's key names and parses back."""
    kv = SET.gather_preset(SceneSettings())
    text = pio.serialize(kv)
    assert "sim.restDensity=1000" in text
    assert "box.half=7,7,7" in text
    assert "look.paletteId=0" in text
    back = pio.parse(text)
    assert back["audio.bassForce"] == kv["audio.bassForce"]


def test_structural_split():
    """Non-structural apply must not touch respawn-requiring fields."""
    s = SceneSettings()
    kv = {"sim.particleCount": "99000", "look.mixPattern": "2",
          "sim.viscosity": "9.5", "motion.logoPath": "a.png"}
    live = SET.apply_preset(s, kv, structural=False)
    assert live.particle_count == s.particle_count
    assert live.mix_pattern == s.mix_pattern
    assert live.logo_path == s.logo_path
    assert abs(live.viscosity - 9.5) < 1e-6

    full = SET.apply_preset(s, kv, structural=True)
    assert full.particle_count == 99000
    assert full.mix_pattern == 2


def test_needs_respawn():
    s = SceneSettings()
    s2 = dataclasses.replace(s, viscosity=9.0)
    s2.box_half = list(s.box_half)
    assert not SET.needs_respawn(s, s2)
    s3 = dataclasses.replace(s)
    s3.particle_count = 1234567
    assert SET.needs_respawn(s, s3)
    s4 = dataclasses.replace(s)
    s4.shape_type = 3
    assert SET.needs_respawn(s, s4)


@pytest.mark.parametrize("which", range(len(AP.ART_PRESETS)))
def test_art_presets_apply(which):
    s = AP.apply_art_preset(SceneSettings(), which)
    assert s.audio_enabled
    assert 0 <= s.shape_type <= 9
    assert 0 <= s.palette_id < 24
    assert s.gravity_y < 0
    # canvas neutralizes grade
    assert s.hue_shift == 0.0 and s.sat_mul == 1.0


def test_surprise_me_deterministic():
    a = AP.surprise_me(SceneSettings(), seed=42)
    b = AP.surprise_me(SceneSettings(), seed=42)
    assert SET.gather_preset(a) == SET.gather_preset(b)
    c = AP.surprise_me(SceneSettings(), seed=43)
    assert SET.gather_preset(a) != SET.gather_preset(c)


def test_sequencer_cut_and_morph(tmp_path):
    pdir = str(tmp_path)
    hot = SceneSettings()
    hot.viscosity = 9.0
    hot.palette_id = 7
    pio.save_file(os.path.join(pdir, "hot.txt"), SET.gather_preset(hot))

    seq = Sequencer(preset_dir=pdir, enabled=True)
    seq.cues = [SeqCue(time=1.0, preset="hot", cut=True),
                SeqCue(time=5.0, preset="hot", morph_sec=2.0, cut=False)]

    s = SceneSettings()
    s = seq.tick(s, 0.5)
    assert s.palette_id == 0          # nothing fired yet
    s = seq.tick(s, 1.1)
    assert s.palette_id == 7          # cut slammed
    assert abs(s.viscosity - 9.0) < 1e-6

    # morph: halfway between current (9.0) and target (9.0) is 9.0; reset
    # to a cold look first to observe blending
    s.viscosity = 1.0
    s = seq.tick(s, 5.0)              # cue fires, morph starts at t=5
    mid = seq.tick(s, 6.0)            # halfway, smoothstep(0.5)=0.5
    assert 4.0 < mid.viscosity < 6.0
    done = seq.tick(mid, 7.5)
    assert abs(done.viscosity - 9.0) < 1e-4
    assert not seq.morph_active


def test_sequencer_persistence(tmp_path):
    path = os.path.join(tmp_path, "sequence.txt")
    seq = Sequencer()
    seq.cues = [SeqCue(2.5, "a", 1.0, True), SeqCue(9.0, "b", 3.0, False)]
    assert seq.save(path)
    back = Sequencer.load(path)
    assert len(back.cues) == 2
    assert back.cues[0].preset == "a" and back.cues[0].cut
    assert abs(back.cues[1].morph_sec - 3.0) < 1e-6


def test_reaction_driver(dam_break_small):
    state, params, dims = dam_break_small
    s = SceneSettings()
    s.spin_on = True
    s.attractor_on = True
    phases = ReactionPhases()
    v0 = np.asarray(state.vel)
    st, p, ph, live = drive_audio_reaction(
        state, params, s, phases, bass=1.0, mid=0.5, treble=0.3, dt=0.016)
    assert ph.bass_phase > 0 and ph.post_time > 0
    assert not np.allclose(np.asarray(st.vel), v0)   # impulses kicked
    g = np.asarray(p.gravity)
    assert g[0] != 0 or g[2] != 0                     # gravity spin tipped
    assert live.bright_mul >= s.bright_mul            # shimmer/flash kick
    # phases object is not mutated in place
    assert phases.bass_phase == 0.0


def test_continuous_wave(dam_break_small):
    state, params, dims = dam_break_small
    s = SceneSettings()
    s.continuous_wave = True
    st, ph = drive_continuous_wave(state, s, ReactionPhases(), 0.016)
    assert ph.wave_phase > 0
    assert not np.allclose(np.asarray(st.vel), np.asarray(state.vel))


def test_scene_update_and_checkpoint(tmp_path):
    s = SceneSettings()
    s.particle_count = 1000
    s.audio_enabled = True
    sc = Scene(settings=s, neighbor_impl="cell")
    n0 = sc.state.n
    n_sub = sc.update(0.016, bands=(0.8, 0.2, 0.1))
    assert n_sub > 0
    assert np.isfinite(np.asarray(sc.state.pos)).all()

    ck = os.path.join(tmp_path, "ck.npz")
    sc.save_checkpoint(ck)
    pos_before = np.asarray(sc.state.pos).copy()
    t_before = sc.sim_time

    sc.update(0.016, bands=(0.0, 0.0, 0.0))
    sc.load_checkpoint(ck)
    assert sc.state.n == n0
    np.testing.assert_allclose(np.asarray(sc.state.pos), pos_before,
                               atol=0)
    assert sc.sim_time == t_before


def test_scene_art_preset_respawn():
    s = SceneSettings()
    s.particle_count = 1000
    sc = Scene(settings=s, neighbor_impl="cell")
    sc.apply_art_preset(3)     # Club Water
    assert sc.settings.render_mode == 0
    assert abs(sc.settings.gravity_y + 980.0) < 1e-6
    assert np.isfinite(np.asarray(sc.state.pos)).all()


def test_params_from_settings():
    s = SceneSettings()
    s.viscosity = 4.5
    s.h = 0.3
    p = params_from_settings(s)
    assert abs(float(p.viscosity) - 4.5) < 1e-6
    # mass derived from h
    assert abs(float(p.mass) - 1000.0 * (0.85 * 0.3) ** 3) < 1e-3


def test_key_controller_live_controls():
    """run --realtime interactive surface (the ImGui-panel stand-in):
    keys mutate settings through apply_settings, orbit the camera, and
    quit cleanly; inert without a TTY."""
    from sph_tpu.app.keys import KeyController
    from sph_tpu.scene.scene import Scene

    scene = Scene()
    scene.settings = dataclasses.replace(scene.settings,
                                         particle_count=256)
    scene.respawn()
    kc = KeyController(scene)

    pal0 = scene.settings.palette_id
    assert kc.handle("]")
    assert scene.settings.palette_id == (pal0 + 1) % 24
    assert kc.handle("[")
    assert scene.settings.palette_id == pal0

    mode0 = scene.settings.render_mode
    kc.handle("m")
    assert scene.settings.render_mode == (mode0 + 1) % 3

    att0 = scene.settings.attractor_on
    kc.handle("t")
    assert scene.settings.attractor_on != att0

    yaw0 = scene.camera.yaw_deg
    kc.handle("d")
    assert scene.camera.yaw_deg == pytest.approx(yaw0 + 6.0)
    dist0 = scene.camera.distance
    kc.handle("-")
    assert scene.camera.distance == pytest.approx(dist0 * 1.1)

    kc.handle(" ")
    assert kc.paused
    kc.handle("r")
    assert scene.pending_reset
    assert not kc.handle("q")

    # no TTY: the context manager is inert and poll() is a no-op True
    with kc:
        assert kc.poll()


@pytest.mark.slow
def test_watchdog_recovers_from_nonfinite_state(tmp_path):
    """Failure containment (SURVEY §5.3): the NaN watchdog detects a
    blown-up state and restores the last checkpoint (or respawns)."""
    import jax.numpy as jnp
    from sph_tpu.scene.scene import Scene

    scene = Scene()
    scene.settings = dataclasses.replace(scene.settings,
                                         particle_count=256)
    scene.respawn()
    scene.watchdog_every = 1

    ckpt = str(tmp_path / "good.npz")
    scene.save_checkpoint(ckpt)

    # blow the state up (a bad live edit analogue)
    scene.state = scene.state.replace(
        pos=scene.state.pos.at[0, 0].set(jnp.nan))
    scene.update(1.0 / 60.0)
    assert np.isfinite(np.asarray(scene.state.pos)).all()

    # without a checkpoint it respawns instead
    scene2 = Scene()
    scene2.settings = dataclasses.replace(scene2.settings,
                                          particle_count=256)
    scene2.respawn()
    scene2.watchdog_every = 1
    scene2.state = scene2.state.replace(
        pos=scene2.state.pos.at[0, 0].set(jnp.nan))
    scene2.update(1.0 / 60.0)
    assert np.isfinite(np.asarray(scene2.state.pos)).all()

def test_quicksets_match_reference_bundles():
    """Stable/Splashy Water one-clicks (Scene0p.cpp:824-850)."""
    from sph_tpu.scene.quicksets import QUICKSETS, apply_quickset
    from sph_tpu.scene.settings import SceneSettings

    s = SceneSettings()
    st = apply_quickset(s, "stable")
    assert (st.h, st.gas_constant, st.viscosity) == (0.28, 2000.0, 3.5)
    assert st.surface_tension == 0.0 and st.time_step == 1e-3

    sp = apply_quickset(s, "splashy")
    assert (sp.h, sp.gas_constant, sp.viscosity) == (0.22, 6000.0, 1.2)
    assert sp.surface_tension == 0.12 and sp.time_step == 5e-4
    assert not sp.use_jitter and sp.wall_restitution == 0.05
    assert set(QUICKSETS) == {"stable", "splashy"}

    with pytest.raises(KeyError):
        apply_quickset(s, "nope")


def test_key_controller_quickset_and_param_mode():
    """Param-edit mode: the full preset schema
    is key-editable; structural edits respawn, live edits morph."""
    from sph_tpu.app.keys import KeyController, param_entries
    from sph_tpu.scene.scene import Scene

    scene = Scene()
    scene.settings = dataclasses.replace(scene.settings,
                                         particle_count=256)
    scene.respawn()
    kc = KeyController(scene, out=open(os.devnull, "w"))

    # quick-set key: splashy bundle + queued respawn
    kc.handle("U")
    assert scene.settings.gas_constant == 6000.0
    assert scene.pending_reset
    scene.pending_reset = False

    # the schema is fully exposed (~140 keys; f3 unrolls to 3 rows)
    entries = param_entries()
    assert len(entries) > 140
    labels = [e[0] for e in entries]
    assert "sim.gasConstant" in labels and "fx.bloom" in labels
    assert "box.half.y" in labels and "audio.bassForce" in labels

    # enter param mode, select sim.gasConstant, step it up live
    kc.handle("p")
    assert kc.param_mode
    kc.param_idx = labels.index("sim.gasConstant")
    g0 = scene.settings.gas_constant
    kc.handle("+")
    assert scene.settings.gas_constant == pytest.approx(g0 * 1.1)
    assert not scene.pending_reset          # live param: no respawn
    kc.handle("0")                          # reset to schema default
    assert scene.settings.gas_constant == 2000.0

    # f3 component edit
    kc.param_idx = labels.index("box.half.y")
    h0 = scene.settings.box_half[1]
    kc.handle("-")
    assert scene.settings.box_half[1] == pytest.approx(h0 - h0 * 0.1)

    # int + bool kinds
    kc.param_idx = labels.index("water.smoothIter")
    it0 = scene.settings.smooth_iterations
    kc.handle("+")
    assert scene.settings.smooth_iterations == it0 + 1
    kc.param_idx = labels.index("look.skyOn")
    sky0 = scene.settings.sky_on
    kc.handle("+")
    assert scene.settings.sky_on != sky0

    # structural param respawns through apply_settings
    n0 = scene.state.pos.shape[0]
    kc.param_idx = labels.index("sim.particleCount")
    kc.handle("+")
    assert scene.settings.particle_count == 257

    # keys j/k navigate; 'p' exits; zoom keys work again after exit
    i0 = kc.param_idx
    kc.handle("j")
    assert kc.param_idx == (i0 + 1) % len(entries)
    kc.handle("K")
    assert kc.param_idx == (i0 + 1 - 10) % len(entries)
    kc.handle("p")
    assert not kc.param_mode
    d0 = scene.camera.distance
    kc.handle("-")
    assert scene.camera.distance == pytest.approx(d0 * 1.1)

def test_shipped_presets_load_and_apply():
    """The repo ships curated presets/*.txt —
    one per art preset, regenerable bit-for-bit by
    scripts/gen_presets.py."""
    import glob

    from sph_tpu.scene.art_presets import (ART_PRESET_NAMES,
                                           apply_art_preset)
    from sph_tpu.scene.settings import (SceneSettings, apply_preset,
                                        gather_preset)

    root = os.path.join(os.path.dirname(__file__), "..", "presets")
    files = sorted(glob.glob(os.path.join(root, "*.txt")))
    assert len(files) >= len(ART_PRESET_NAMES)

    for path in files:
        kv = pio.load_file(path)
        assert kv is not None, path
        s = apply_preset(SceneSettings(), kv)
        assert 1000 <= s.particle_count <= 4_000_000
        assert 0 <= s.shape_type <= 9

    # shipped files == regenerated files (deterministic writer)
    for i, name in enumerate(ART_PRESET_NAMES):
        path = os.path.join(root, f"{pio.sanitize_name(name)}.txt")
        with open(path) as f:
            on_disk = f.read()
        fresh = pio.serialize(gather_preset(
            apply_art_preset(SceneSettings(), i)))
        assert on_disk == fresh, f"{name} drifted from its generator"


def test_live_box_growth_retracks_grid():
    """Live grid tracking: the reference
    recomputes grid extents every substep and reallocs on cell-count
    change (SPHFluid3D.cpp:282-304,366-375). box.half is a LIVE key, so
    growing the container must grow grid_dims (bucketed recompile), not
    silently clamp outliers into edge cells."""
    s = SceneSettings()
    s.particle_count = 1000
    sc = Scene(settings=s, neighbor_impl="cell")
    dims0 = sc.config.grid_dims

    import copy
    big = copy.deepcopy(s)
    big.box_half = [2.0 * s.box_half[0], 2.0 * s.box_half[1],
                    2.0 * s.box_half[2]]
    assert not SET.needs_respawn(s, big), "box.half must stay live"
    sc.apply_settings(big)
    dims1 = sc.config.grid_dims
    assert all(d1 > d0 for d1, d0 in zip(dims1, dims0)), (dims0, dims1)

    # the grown grid covers the grown box: required dims at the new box
    # are met exactly (no edge clamping)
    req = __import__("sph_tpu.core.params", fromlist=["x"]).compute_grid_dims(
        big.shape_type, np.asarray(big.box_half, np.float32),
        np.asarray(big.box_euler, np.float32), big.h)
    assert all(c >= r for c, r in zip(dims1, req))

    # a substep still runs on the rebuilt config
    n_sub = sc.update(0.016)
    assert n_sub > 0
    assert np.isfinite(np.asarray(sc.state.pos)).all()

    # shrinking back keeps the larger grid (no thrash) and still runs
    sc.apply_settings(s)
    assert sc.config.grid_dims == dims1
