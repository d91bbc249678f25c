"""GPU-only checks: the compiled kernels and the chosen engine on the card.

These skip on a CPU-only host (see ``conftest.gpu_device``).  On a GPU
host: ``SPH_TEST_PLATFORMS=cpu,cuda python -m pytest tests/ -m gpu``.
"""
import dataclasses

import numpy as np
import pytest

import jax

from sph_tpu.app import configs as AC
from sph_tpu.engine.step import SceneBuffers, run_substeps

pytestmark = pytest.mark.gpu


def _by_id(state, field):
    valid = np.asarray(state.valid) > 0
    order = np.argsort(np.asarray(state.orig_id)[valid], kind="stable")
    return np.asarray(getattr(state, field))[valid][order]


def _compare(cfg, impl, n_sub, gpu_device):
    with jax.default_device(gpu_device):
        state, params, sim = AC.build(cfg)
        out = {}
        for name in (impl, "brute"):
            s = dataclasses.replace(sim, neighbor_impl=name)
            st, buf = run_substeps(state, params, SceneBuffers.create(s),
                                   params.dt, n_sub, s)
            assert int(buf.overflow) == 0
            assert next(iter(st.pos.devices())).platform == "gpu"
            out[name] = st
    dpos = np.abs(_by_id(out[impl], "pos") - _by_id(out["brute"], "pos"))
    drho = np.abs(_by_id(out[impl], "density")
                  - _by_id(out["brute"], "density"))
    assert dpos.max() < 5e-5 and drho.max() < 0.5, (dpos.max(), drho.max())


def test_brute_kernel_compiled_matches_oracle(gpu_device):
    _compare(AC.CONFIGS["dam_break_8k"], "brute_pallas", 5, gpu_device)


def test_cell_engine_on_gpu_matches_oracle(gpu_device):
    small = dataclasses.replace(AC.CONFIGS["default_131k"], n_target=16384,
                                box_half=(6.0, 6.0, 6.0))
    _compare(small, "cell", 5, gpu_device)
