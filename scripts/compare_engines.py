#!/usr/bin/env python
"""Time the neighbor engines against each other on the GPU, one process.

For each cell-list config (default_131k, rotated_512k, ghost_1m) and each
of the ``cell`` and ``binned`` engines: a warm-up window and a timed
window of ``--substeps`` substeps (the bench's own window, wave impulse
included), the rows past ``cell_capacity`` in any substep, and the
compile+warm-up seconds.  A run that overflows is repeated at the next
capacity in ``--capacities``.  For dam_break_8k: the ``brute`` oracle and
the fused ``brute_pallas`` kernel at each block shape in ``--blocks``,
with the kernel's largest position error against the oracle.

Prints one JSON object per measurement.

Usage: python scripts/compare_engines.py [--substeps 16]
       [--configs default_131k,rotated_512k,ghost_1m]
       [--capacities 8,12,16] [--blocks 16x64,32x32,32x64,64x64]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _time_window(run, state, buffers, n_sub):
    import jax
    t0 = time.perf_counter()
    state, buffers = jax.block_until_ready(run(state, buffers))
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, buffers = jax.block_until_ready(run(state, buffers))
    return state, buffers, warm, 1e3 * (time.perf_counter() - t0) / n_sub


def cell_configs(args, card: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from sph_tpu.app import configs as AC
    from sph_tpu.engine.step import SceneBuffers, run_substeps
    from sph_tpu.physics.impulses import wave_impulse

    caps = [int(c) for c in args.capacities.split(",")]
    for name in args.configs.split(","):
        cfg = AC.CONFIGS[name]
        state0, params, sim0 = AC.build(cfg)
        n_fluid = int(np.asarray(state0.fluid_mask()).sum())
        for impl in ("cell", "binned"):
            for cap in caps:
                sim = dataclasses.replace(sim0, neighbor_impl=impl,
                                          cell_capacity=cap)

                def run(st, buf, sim=sim):
                    if cfg.wave_impulse:
                        st = wave_impulse(
                            st, amplitude=60.0 * float(params.dt)
                            * args.substeps, wavelength=4.0, phase=0.7,
                            direction=jnp.asarray([1.0, 0.0, 0.3]))
                    return run_substeps(st, params, buf, params.dt,
                                        args.substeps, sim)

                st, buf, warm, ms = _time_window(
                    run, state0, SceneBuffers.create(sim), args.substeps)
                ovf = int(buf.overflow)
                _emit({"config": name, "impl": impl, "cell_capacity": cap,
                       "ms_per_substep": ms, "compile_warm_s": warm,
                       "overflow_rows": ovf,
                       "nan": bool(np.isnan(np.asarray(st.pos)).any()),
                       "n_fluid": n_fluid, "card": card})
                jax.clear_caches()
                if ovf == 0:
                    break


def brute_config(args, card: str) -> None:
    import jax

    from sph_tpu.app import configs as AC
    from sph_tpu.engine.step import SceneBuffers, run_substeps
    from sph_tpu.physics import brute_pallas, constraints

    state, params, sim = AC.build(AC.CONFIGS["dam_break_8k"],
                                  neighbor_impl="brute")
    n_sub = 20
    buf = SceneBuffers.create(sim)
    ref, _, warm, ms = _time_window(
        lambda st, b: run_substeps(st, params, b, params.dt, n_sub, sim),
        state, buf, n_sub)
    _emit({"config": "dam_break_8k", "impl": "brute", "ms_per_substep": ms,
           "compile_warm_s": warm, "card": card})
    # one window from the spawn state for the error check
    ref = jax.block_until_ready(run_substeps(
        state, params, buf, params.dt, n_sub, sim))[0]

    for blk in args.blocks.split(","):
        bi, bj = (int(v) for v in blk.split("x"))

        @jax.jit
        def window(st, b, bi=bi, bj=bj):
            def body(s, _):
                s = brute_pallas.substep(s, params, params.dt, bi=bi, bj=bj)
                return constraints.apply_container(s, params), None
            return jax.lax.scan(body, st, None, length=n_sub)[0], b

        got, _, warm, ms = _time_window(window, state, buf, n_sub)
        got = jax.block_until_ready(window(state, buf))[0]
        v = np.asarray(state.valid) > 0
        err = float(np.abs(np.asarray(got.pos) - np.asarray(ref.pos))[v].max())
        drho = float(np.abs(np.asarray(got.density)
                            - np.asarray(ref.density))[v].max())
        _emit({"config": "dam_break_8k", "impl": "brute_pallas",
               "block": blk, "ms_per_substep": ms, "compile_warm_s": warm,
               "max_pos_err_vs_brute": err, "max_rho_err_vs_brute": drho,
               "card": card})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--substeps", type=int, default=16)
    ap.add_argument("--configs", default="default_131k,rotated_512k,ghost_1m")
    ap.add_argument("--capacities", default="8,12,16")
    ap.add_argument("--blocks", default="16x64,32x32,32x64,64x64")
    ap.add_argument("--skip-brute", action="store_true")
    args = ap.parse_args()

    from sph_tpu.utils.cache import enable_compile_cache
    from sph_tpu.utils.device import card_info, require_gpu
    dev = require_gpu()
    enable_compile_cache()
    card = card_info()
    print(f"device: {dev.device_kind}; card: {card}", flush=True)
    if not args.skip_brute:
        brute_config(args, card)
    if args.configs:
        cell_configs(args, card)


if __name__ == "__main__":
    main()
