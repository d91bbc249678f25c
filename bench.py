#!/usr/bin/env python
"""Benchmark harness: prints ONE JSON line for one BASELINE config.

Metric: particle-steps/sec (fluid particles x substeps / wall seconds)
over one scanned window of ``n_substeps``, timed after a warm-up window of
the same length, on a GPU.  Baseline: the reference's implied sustained
design point on its dev GPU, ~4.8e7 particle-steps/sec (50k particles x
16 substeps x 60 fps; see BASELINE.md).  Diagnostics go to stderr.

Exits non-zero when JAX finds no GPU, when the state goes NaN, and when
any substep overflowed ``cell_capacity``.

Usage: python bench.py [config_name] [n_substeps] [neighbor_impl]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REFERENCE_BASELINE_PSTEPS = 4.8e7


def main() -> None:
    config_name = sys.argv[1] if len(sys.argv) > 1 else "ghost_1m"
    n_substeps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    impl_override = sys.argv[3] if len(sys.argv) > 3 else None

    import jax
    from sph_tpu.utils.cache import enable_compile_cache
    from sph_tpu.utils.device import card_info, require_gpu

    dev = require_gpu()
    print(f"[bench] device: {dev.device_kind} ({dev.platform}); card: "
          f"{card_info()}; compile cache: {enable_compile_cache()}",
          file=sys.stderr)

    from sph_tpu.app import configs as AC
    from sph_tpu.engine.step import SceneBuffers, require_exact, run_substeps

    if config_name not in AC.CONFIGS:
        sys.exit(f"unknown config '{config_name}'; "
                 f"available: {', '.join(sorted(AC.CONFIGS))}")
    cfg = AC.CONFIGS[config_name]
    state, params, sim = AC.build(cfg, neighbor_impl=impl_override)
    buffers = SceneBuffers.create(sim)
    n_fluid = int(np.asarray(state.fluid_mask()).sum())
    print(f"[bench] config={config_name} fluid={n_fluid} padded={state.n} "
          f"grid={sim.grid_dims} impl={sim.neighbor_impl} "
          f"cell_capacity={sim.cell_capacity}", file=sys.stderr)

    # Config 3 ("rotated OBB + continuous wave impulse"): the reference
    # kicks once per FRAME (Scene0p.cpp:1303-1307), dt-premultiplied; a
    # bench batch stands in for one frame.
    if cfg.wave_impulse:
        import jax.numpy as jnp
        from sph_tpu.physics.impulses import wave_impulse
        frame_prologue = jax.jit(lambda st: wave_impulse(
            st, amplitude=60.0 * float(params.dt) * n_substeps,
            wavelength=4.0, phase=0.7,
            direction=jnp.asarray([1.0, 0.0, 0.3])))
    else:
        def frame_prologue(st):
            return st

    # Warmup with the SAME substep count (scan length is a static jit arg,
    # so a different count would recompile inside the timed section).
    t0 = time.perf_counter()
    state, buffers = jax.block_until_ready(run_substeps(
        frame_prologue(state), params, buffers, params.dt, n_substeps, sim))
    print(f"[bench] compile+warmup: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    t0 = time.perf_counter()
    state, buffers = jax.block_until_ready(run_substeps(
        frame_prologue(state), params, buffers, params.dt, n_substeps, sim))
    elapsed = time.perf_counter() - t0

    ms_per_substep = 1e3 * elapsed / n_substeps
    psteps = n_fluid * n_substeps / elapsed
    print(f"[bench] {n_substeps} substeps in {elapsed:.4f}s "
          f"({ms_per_substep:.3f} ms/substep)", file=sys.stderr)

    if np.isnan(np.asarray(state.pos)).any():
        sys.exit("NaN in positions after bench run")
    # Capacity audit: neither cell-list engine has an exact fallback for
    # rows past cell_capacity (the reference's per-cell lists are
    # unbounded, BuildGrid.comp:34-38), so any overflow fails the run.
    require_exact(buffers, f"bench {config_name}")
    print("[bench] capacity overflow: 0 rows in every substep",
          file=sys.stderr)

    if cfg.viz_export:
        # BASELINE config 5: headless frame export in all 4 viz modes
        # (height/speed/pressure/density) from the final state.
        from sph_tpu.viz import palettes as PAL
        from sph_tpu.viz.camera import fit_camera
        from sph_tpu.viz.splat import render_frame, save_png
        out_dir = "bench_frames"
        os.makedirs(out_dir, exist_ok=True)
        cam = fit_camera(np.asarray(cfg.box_half, np.float32))
        t0 = time.perf_counter()
        for mode, name in ((PAL.DRIVE_HEIGHT, "height"),
                           (PAL.DRIVE_SPEED, "speed"),
                           (PAL.DRIVE_PRESSURE, "pressure"),
                           (PAL.DRIVE_DENSITY, "density")):
            vp = PAL.VizParams(
                palette_id=1, color_drive=mode,
                height_min=-cfg.box_half[1], height_max=cfg.box_half[1])
            img = render_frame(state, vp, cam, width=960, height=540,
                               particle_radius=0.5 * cfg.h)
            save_png(img, os.path.join(out_dir, f"{config_name}_{name}.png"))
        print(f"[bench] viz export (4 modes, {n_fluid} particles): "
              f"{time.perf_counter() - t0:.1f}s -> {out_dir}/",
              file=sys.stderr)

    print(json.dumps({
        "metric": f"particle-steps/sec @ {config_name}",
        "value": psteps,
        "unit": "particle-steps/sec",
        "vs_baseline": psteps / REFERENCE_BASELINE_PSTEPS,
        "ms_per_substep": ms_per_substep,
        "neighbor_impl": sim.neighbor_impl,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
