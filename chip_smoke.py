#!/usr/bin/env python
"""Prove that the simulator's main path runs on one GPU, in one process.

Phases (one line each; any failure stops the script with a traceback):

1. device     JAX's devices are GPUs; card name and power limit; cache dir
2. entry      ``__graft_entry__.entry()`` jitted, one substep
3. main path  default_131k through ``configs.build`` + ``run_substeps``,
              16 substeps (one frame at the reference's max_substeps):
              no NaN, fluid inside the container, speeds <= the CFL cap,
              no cell-capacity overflow; ms/substep and memory analysis
4. oracle     one substep of the config's engine against
              ``brute_force.substep`` at 131k, aligned by orig_id
5. brute      dam_break_8k, 20 substeps, fused ``brute_pallas`` kernels
              against the ``brute`` oracle
6. cells      rotated_512k (16 substeps + wave impulse: containment, no
              NaN) and ghost_1m (4 substeps: no overflow, memory analysis)
7. scene      a 50k ``Scene``, two frames, one ``render_frame`` written
              as PNG to a temp dir

The last line of stdout is one JSON object naming the device.  With
``--four-cards`` only the multi-device path runs: the slab engine over a
4-card mesh against single-card ``binned``, and the gather-parallel engine.

Usage: python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

POS_TOL = 5e-5       # tests/test_solver_equivalence.py
RHO_TOL = 0.5
SLAB_TOL = 1e-4      # parallel/dryrun.py stage 1
DOMAIN_TOL = 1e-5    # tests/test_parallel.py


def _line(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def _memory(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory analysis unavailable"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{f.replace('_size_in_bytes', '')}="
                     f"{getattr(ma, f, 0) / 2**20:.1f}MiB" for f in fields)


def _by_id(state, field: str) -> np.ndarray:
    valid = np.asarray(state.valid) > 0
    order = np.argsort(np.asarray(state.orig_id)[valid], kind="stable")
    return np.asarray(getattr(state, field))[valid][order]


def _physics_checks(state, params, cfg, overflow: int) -> None:
    """No NaN, fluid inside the (rotated) box, speeds <= CFL cap."""
    from sph_tpu.core.params import rotation_matrix_np
    fluid = np.asarray(state.fluid_mask())
    pos = np.asarray(state.pos, np.float64)[fluid]
    vel = np.asarray(state.vel, np.float64)[fluid]
    _check(np.isfinite(pos).all() and np.isfinite(vel).all(),
           f"{cfg.name}: NaN/inf in the state")
    local = pos @ rotation_matrix_np(cfg.box_euler_deg).astype(np.float64)
    outside = np.abs(local) - np.asarray(cfg.box_half)[None, :]
    _check(outside.max() <= 1e-4,
           f"{cfg.name}: fluid {outside.max():.3g} outside the container")
    cap = 0.4 * float(params.h) / float(params.dt)
    speed = np.linalg.norm(vel, axis=1).max()
    _check(speed <= cap * (1 + 1e-4),
           f"{cfg.name}: speed {speed:.4g} above the CFL cap {cap:.4g}")
    _check(overflow == 0,
           f"{cfg.name}: {overflow} rows overflowed cell_capacity")


def _wave(cfg, params, n_sub):
    import jax.numpy as jnp
    from sph_tpu.physics.impulses import wave_impulse
    if not cfg.wave_impulse:
        return lambda st: st
    return lambda st: wave_impulse(
        st, amplitude=60.0 * float(params.dt) * n_sub, wavelength=4.0,
        phase=0.7, direction=jnp.asarray([1.0, 0.0, 0.3]))


def _run_config(name: str, n_sub: int, phase: str, memory: bool) -> None:
    """Warm-up window + timed window of one config, then the checks."""
    import jax
    from sph_tpu.app import configs as AC
    from sph_tpu.engine.step import SceneBuffers, run_substeps

    cfg = AC.CONFIGS[name]
    state, params, sim = AC.build(cfg)
    buffers = SceneBuffers.create(sim)
    kick = jax.jit(_wave(cfg, params, n_sub))
    t0 = time.perf_counter()
    compiled = run_substeps.lower(state, params, buffers, params.dt,
                                  n_substeps=n_sub, config=sim).compile()
    state, buffers = jax.block_until_ready(
        compiled(kick(state), params, buffers, params.dt))
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, buffers = jax.block_until_ready(
        compiled(kick(state), params, buffers, params.dt))
    ms = 1e3 * (time.perf_counter() - t0) / n_sub
    _physics_checks(state, params, cfg, int(buffers.overflow))
    mem = f"; {_memory(compiled)}" if memory else ""
    _line(phase, f"{name} ok: engine={sim.neighbor_impl} "
          f"cell_capacity={sim.cell_capacity} rows={state.n} "
          f"{ms:.3f} ms/substep over {n_sub} substeps (compile+warm-up "
          f"{warm:.1f}s), overflow 0{mem}")


def phase_entry() -> None:
    import jax
    import __graft_entry__ as G
    fn, args = G.entry()
    state, _ = jax.block_until_ready(jax.jit(fn)(*args))
    _check(bool(np.isfinite(np.asarray(state.pos)).all()),
           "entry: NaN after one substep")
    _line("2 entry", f"entry() substep ok on {state.n} rows")


def phase_oracle() -> None:
    """One substep at 131k: the config's engine against the oracle."""
    import dataclasses

    import jax
    from sph_tpu.app import configs as AC
    from sph_tpu.engine.step import SceneBuffers, run_substeps

    cfg = AC.CONFIGS["default_131k"]
    state, params, sim = AC.build(cfg)
    brute = dataclasses.replace(sim, neighbor_impl="brute")
    outs = {}
    with jax.default_matmul_precision("highest"):
        for s in (sim, brute):
            t0 = time.perf_counter()
            out, buf = jax.block_until_ready(run_substeps(
                state, params, SceneBuffers.create(s), params.dt, 1, s))
            _check(int(buf.overflow) == 0, "oracle: capacity overflow")
            outs[s.neighbor_impl] = (out, time.perf_counter() - t0)
    got, ref = outs[sim.neighbor_impl][0], outs["brute"][0]
    dpos = np.abs(_by_id(got, "pos") - _by_id(ref, "pos")).max()
    drho = np.abs(_by_id(got, "density") - _by_id(ref, "density")).max()
    _check(dpos < POS_TOL and drho < RHO_TOL,
           f"oracle: {sim.neighbor_impl} vs brute at {state.n} rows: "
           f"max |dpos| {dpos:.3g} (< {POS_TOL}), max |drho| {drho:.3g} "
           f"(< {RHO_TOL})")
    _line("4 oracle", f"{sim.neighbor_impl} vs brute_force at {state.n} "
          f"rows, 1 substep: max |dpos| {dpos:.3g} (< {POS_TOL}), max "
          f"|drho| {drho:.3g} (< {RHO_TOL}); oracle took "
          f"{outs['brute'][1]:.1f}s")


def phase_brute() -> None:
    import dataclasses

    import jax
    from sph_tpu.app import configs as AC
    from sph_tpu.engine.step import SceneBuffers, run_substeps

    cfg = AC.CONFIGS["dam_break_8k"]
    state, params, sim = AC.build(cfg)
    n_sub = 20
    res = {}
    for impl in (sim.neighbor_impl, "brute"):
        s = dataclasses.replace(sim, neighbor_impl=impl)
        res[impl] = jax.block_until_ready(run_substeps(
            state, params, SceneBuffers.create(s), params.dt, n_sub, s))[0]
    got, ref = res[sim.neighbor_impl], res["brute"]
    dpos = np.abs(_by_id(got, "pos") - _by_id(ref, "pos")).max()
    drho = np.abs(_by_id(got, "density") - _by_id(ref, "density")).max()
    _check(dpos < POS_TOL and drho < RHO_TOL,
           f"brute: {sim.neighbor_impl} vs brute over {n_sub} substeps: "
           f"max |dpos| {dpos:.3g}, max |drho| {drho:.3g}")
    _line("5 brute", f"dam_break_8k {sim.neighbor_impl} vs brute over "
          f"{n_sub} substeps: max |dpos| {dpos:.3g}, max |drho| {drho:.3g}")


def phase_scene(out_dir: str) -> None:
    from sph_tpu.scene.scene import Scene
    from sph_tpu.scene.settings import SceneSettings
    from sph_tpu.viz import palettes as PAL
    from sph_tpu.viz.camera import fit_camera
    from sph_tpu.viz.splat import load_png, render_frame, save_png

    s = SceneSettings()
    s.particle_count = 50_000
    scene = Scene(settings=s, seed=0)
    n_sub = sum(scene.update(1.0 / 60.0) for _ in range(2))
    _check(int(scene.buffers.overflow) == 0, "scene: capacity overflow")
    cam = fit_camera(np.asarray(s.box_half, np.float32))
    img = render_frame(scene.state, PAL.VizParams(), cam, width=480,
                       height=270)
    path = os.path.join(out_dir, "scene_frame.png")
    save_png(img, path)
    back = load_png(path)
    _check(back.shape == img.shape and (back == img).all(),
           "scene: PNG round trip changed the frame")
    drawn = int((img != img[0, 0]).any(axis=2).sum())   # corner = background
    _check(drawn > 0, "scene: the frame shows no particle")
    _line("7 scene", f"50k scene ({scene.config.neighbor_impl}) stepped "
          f"2 frames / {n_sub} substeps; frame {img.shape[1]}x"
          f"{img.shape[0]} with {drawn} particle pixels -> {path}")


def four_cards() -> None:
    """Slab engine over a 4-card mesh vs single-card binned; gather engine."""
    import dataclasses

    import jax
    from sph_tpu.app import configs as AC
    from sph_tpu.engine.step import SceneBuffers, run_substeps
    from sph_tpu.parallel import domain, slabs

    n_dev = 4
    _check(len(jax.devices()) >= n_dev,
           f"--four-cards needs {n_dev} GPUs, found {len(jax.devices())}")
    cfg = AC.CONFIGS["default_131k"]
    state, params, sim = AC.build(cfg, neighbor_impl="binned")
    n_sub = 5
    ref, buf = jax.block_until_ready(run_substeps(
        state, params, SceneBuffers.create(sim), params.dt, n_sub, sim))
    _check(int(buf.overflow) == 0, "four-cards: reference overflowed")
    mesh = slabs.make_mesh_slabs(n_dev)
    scfg = slabs.make_slab_config(sim, n_dev, state.n)
    st = slabs.shard_by_slab(state, params, scfg, mesh)
    step = slabs.make_slab_substep(mesh, scfg)
    st = jax.block_until_ready(step(st, params, params.dt))  # compile
    t0 = time.perf_counter()
    for _ in range(n_sub - 1):
        st = step(st, params, params.dt)
    st = jax.device_get(jax.block_until_ready(st))
    ms = 1e3 * (time.perf_counter() - t0) / (n_sub - 1)
    _check(int((np.asarray(st.valid) > 0).sum())
           == int((np.asarray(ref.valid) > 0).sum()),
           "four-cards: slab migration lost particles")
    err = np.abs(_by_id(st, "pos") - _by_id(ref, "pos")).max()
    _check(err < SLAB_TOL, f"four-cards: slab vs single card {err:.3g}")
    _line("4x slabs", f"{state.n} rows over {n_dev} z-slabs, {n_sub} "
          f"substeps: max |dpos| vs single-card binned {err:.3g} "
          f"(< {SLAB_TOL}); {ms:.3f} ms/substep after compile")

    small = dataclasses.replace(AC.CONFIGS["dam_break_8k"],
                                n_target=1024 * n_dev)
    st2, params2, sim2 = AC.build(small, neighbor_impl="brute")
    mesh2 = domain.make_mesh(n_dev)
    step2 = domain.make_sharded_substep(mesh2, sim2)
    out2, _ = jax.block_until_ready(step2(
        domain.shard_state(st2, mesh2), params2, SceneBuffers.create(sim2),
        params2.dt))
    ref2, _ = jax.block_until_ready(run_substeps(
        st2, params2, SceneBuffers.create(sim2), params2.dt, 1, sim2))
    err2 = np.abs(_by_id(jax.device_get(out2), "pos")
                  - _by_id(ref2, "pos")).max()
    _check(err2 < DOMAIN_TOL,
           f"four-cards: gather engine vs single card {err2:.3g}")
    _line("4x domain", f"gather-parallel brute engine, {st2.n} rows on "
          f"{n_dev} cards, 1 substep: max |dpos| vs single card "
          f"{err2:.3g} (< {DOMAIN_TOL})")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card slab and gather engines")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    from sph_tpu.utils.cache import enable_compile_cache
    from sph_tpu.utils.device import card_info, require_gpu

    dev = require_gpu()
    cache = enable_compile_cache()
    card = card_info()
    _line("1 device", f"{len(jax.devices())} x {dev.device_kind}; "
          f"nvidia-smi: {card}; compile cache: {cache}")

    if args.four_cards:
        four_cards()
    else:
        phase_entry()
        _run_config("default_131k", 16, "3 main path", memory=True)
        phase_oracle()
        phase_brute()
        _run_config("rotated_512k", 16, "6 cells", memory=False)
        _run_config("ghost_1m", 4, "6 cells", memory=True)
        with tempfile.TemporaryDirectory() as tmp:
            phase_scene(tmp)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
