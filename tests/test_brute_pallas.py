"""Fused all-pairs kernels (Triton-route Pallas, interpret mode on CPU)
against the brute-force oracle.

Row counts cover a multiple of the block and a padded tail; ghost shells
cover inactive sources and ghost overrides.  The kernels compile for a GPU
only, so here they run with ``interpret=True``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sph_tpu.core import state as S
from sph_tpu.core.params import FluidParams
from sph_tpu.physics import brute_force, brute_pallas
from sph_tpu.physics import common as C


def _state(n_rows: int, ghosts: bool):
    half = (2.0, 2.0, 2.0)
    spawn = S.spawn_standard(n_rows, box_half=half, seed=5)
    if ghosts:
        shell = S.spawn_ghost_box_shell(box_half=half)
        spawn = S.concat_spawns(spawn, shell)
    state = S.state_from_spawn(spawn, pad_to=spawn.count + 3)
    params = FluidParams.default(box_half=half).derive_mass()
    if ghosts:   # one face off: its ghosts are no source and keep state
        params = params.replace(ghost_face_active=jnp.asarray(
            [1, 1, 1, 1, 0, 1], jnp.int32))
    return state, params


@pytest.fixture(params=[448, 701], ids=["rows_block_multiple", "rows_padded"])
def n_rows(request):
    return request.param


@pytest.mark.parametrize("ghosts", [False, True], ids=["fluid", "ghosts"])
def test_density_matches_oracle(n_rows, ghosts):
    state, params = _state(n_rows, ghosts)
    contrib = state.contrib_mask(params.ghost_face_active)
    ref = brute_force.density_pass(state.pos, state.pos, contrib, params)
    got = brute_pallas.substep(state, params, params.dt, interpret=True)
    ref_rho, _ = C.finish_density(ref, state.ghost, contrib, state.density,
                                  state.pressure, params)
    v = np.asarray(state.valid) > 0
    np.testing.assert_allclose(np.asarray(got.density)[v],
                               np.asarray(ref_rho)[v], rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("ghosts", [False, True], ids=["fluid", "ghosts"])
def test_substeps_match_oracle(n_rows, ghosts):
    state, params = _state(n_rows, ghosts)
    a = b = state
    step_ref = jax.jit(brute_force.substep)
    step_got = jax.jit(lambda s, p, d: brute_pallas.substep(
        s, p, d, interpret=True))
    for _ in range(3):
        a = step_ref(a, params, params.dt)
        b = step_got(b, params, params.dt)
    v = np.asarray(state.valid) > 0
    for field, tol in (("pos", 5e-5), ("vel", 5e-3), ("density", 0.5)):
        err = np.abs(np.asarray(getattr(a, field))
                     - np.asarray(getattr(b, field)))[v].max()
        assert err < tol, f"{field} diverged from the oracle: {err}"


def test_padding_and_block_sizes():
    """Rows pad to a multiple of both blocks; a padded sentinel row is no
    source, so results do not depend on the block shape."""
    assert brute_pallas.padded_rows(701, 64, 64) == 704
    assert brute_pallas.padded_rows(701, 32, 128) == 768
    state, params = _state(701, False)
    a = brute_pallas.substep(state, params, params.dt, interpret=True,
                             bi=32, bj=128)
    b = brute_pallas.substep(state, params, params.dt, interpret=True,
                             bi=64, bj=64)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               atol=1e-6)
