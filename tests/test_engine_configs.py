"""The GPU engine (``cell``, chosen by measurement for configs 2-5) against
the brute-force oracle on scaled-down versions of each scene kind the
configs and presets run: box, rotated OBB with a wave impulse, ghost
shell, fountain recycling and river emission.  Full engine substeps
(container, emitters) on both sides; rows aligned by orig_id.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from sph_tpu.app import configs as AC
from sph_tpu.engine.step import SceneBuffers, run_substeps
from sph_tpu.physics.impulses import wave_impulse

HALF = (3.2, 3.2, 3.2)


def _box():
    cfg = dataclasses.replace(AC.CONFIGS["default_131k"], n_target=1500,
                              box_half=HALF)
    state, params, sim = AC.build(cfg)
    return state, params, sim, SceneBuffers.create(sim)


def _rotated():
    cfg = dataclasses.replace(AC.CONFIGS["rotated_512k"], n_target=1500,
                              box_half=HALF)
    state, params, sim = AC.build(cfg)
    state = wave_impulse(state, amplitude=0.3, wavelength=4.0, phase=0.7,
                         direction=jnp.asarray([1.0, 0.0, 0.3]))
    return state, params, sim, SceneBuffers.create(sim)


def _ghost():
    cfg = dataclasses.replace(AC.CONFIGS["ghost_1m"], n_target=1500,
                              box_half=HALF)
    state, params, sim = AC.build(cfg)
    assert int(np.asarray(state.ghost).sum()) > 0
    return state, params, sim, SceneBuffers.create(sim)


def _fountain():
    state, params, sim, _ = _box()
    sim = dataclasses.replace(sim, fountain_mode=True)
    params = params.replace(fountain_offset=jnp.asarray([0.0, -2.0, 0.0]),
                            fountain_drain_level=jnp.float32(-2.5))
    return state, params, sim, SceneBuffers.create(sim)


def _river():
    from sph_tpu.scene.river import (RiverSpec, generate_river_terrain,
                                     river_params)
    state, params, sim, _ = _box()
    # the emitter and sink pack rows into a few cells: 8 overflows here
    sim = dataclasses.replace(sim, river_mode=True, cell_capacity=16)
    spec = RiverSpec.random(3)
    terrain = generate_river_terrain(spec, (0.0, 0.0, 0.0), HALF,
                                     res=sim.terrain_res)
    params = river_params(params, spec, (0.0, 0.0, 0.0), HALF)
    buf = SceneBuffers.create(sim).replace(terrain=jnp.asarray(terrain))
    return state, params, sim, buf


def _by_id(state, field):
    valid = np.asarray(state.valid) > 0
    order = np.argsort(np.asarray(state.orig_id)[valid], kind="stable")
    return np.asarray(getattr(state, field))[valid][order]


@pytest.mark.parametrize("scene", [_box, _rotated, _ghost, _fountain, _river],
                         ids=["box", "rotated_obb", "ghost_shell", "fountain",
                              "river"])
def test_chosen_engine_matches_oracle(scene):
    state, params, sim, buf = scene()
    assert sim.neighbor_impl == "cell"
    n_sub = 6
    got, gbuf = run_substeps(state, params, buf, params.dt, n_sub, sim)
    brute = dataclasses.replace(sim, neighbor_impl="brute")
    ref, _ = run_substeps(state, params, buf, params.dt, n_sub, brute)
    assert int(gbuf.overflow) == 0
    assert _by_id(got, "pos").shape == _by_id(ref, "pos").shape
    dpos = np.abs(_by_id(got, "pos") - _by_id(ref, "pos")).max()
    drho = np.abs(_by_id(got, "density") - _by_id(ref, "density")).max()
    assert dpos < 5e-5, f"trajectory diverged: {dpos}"
    assert drho < 0.5, f"density diverged: {drho}"
