"""The five driver benchmark configurations (BASELINE.json `configs`).

1. dam_break_8k   — 8k particles, axis-aligned box, brute-force O(N^2)
                    neighbors (the CPU-runnable trajectory oracle).
2. default_131k   — 131k particles, cell-list neighbors + surface tension
                    (the reference's default-preset analogue).
3. rotated_512k   — 512k particles in a rotated OBB with wall restitution/
                    friction + continuous wave-impulse injection.
4. ghost_1m       — 1M particles with ghost boundary shells and per-face
                    activation grids.
5. export_4m      — 4M particles, multi-substep loop with headless frame
                    export in all viz modes (height/speed/pressure/density).

Box sizes are chosen so the reference's bottom-anchored 40%-fill lattice
spawn (``SPHFluid3D.cpp:85-263``) yields at least the target count; the
spawn then caps at the target, which reproduces the classic "dam column"
initial condition.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from sph_tpu.core import params as P
from sph_tpu.core.params import FluidParams, SimConfig, compute_grid_dims
from sph_tpu.core import state as S


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    n_target: int
    box_half: Tuple[float, float, float]
    h: float = 0.28
    neighbor_impl: str = "cell"
    box_euler_deg: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    surface_tension: float = 0.0728
    ghosts: bool = False
    wave_impulse: bool = False          # continuous wave each frame
    grid_cap: int = P.GRID_DIM_CAP
    cell_capacity: int = 8
    viz_export: bool = False
    spawn_rotation: str = "ignore"    # see core.state.spawn_standard:
                                      # "ignore" = reference semantics
                                      # (SPHFluid3D.cpp:166-169);
                                      # "local" = lattice rotated with
                                      # the container (rotated_512k)


CONFIGS = {
    # brute_pallas = the same all-pairs O(N^2) enumeration BASELINE
    # config 1 mandates, as two fused GPU kernels instead of the oracle's
    # lax.map tile loop (physics/brute_pallas.py).  Pass
    # neighbor_impl="brute" to run the lax.map oracle itself.
    "dam_break_8k": BenchConfig(
        name="dam_break_8k", n_target=8192, box_half=(7.0, 7.0, 7.0),
        neighbor_impl="brute_pallas", surface_tension=0.0),
    "default_131k": BenchConfig(
        name="default_131k", n_target=131072, box_half=(9.5, 9.5, 9.5)),
    "rotated_512k": BenchConfig(
        name="rotated_512k", n_target=524288, box_half=(15.0, 15.0, 15.0),
        box_euler_deg=(20.0, 0.0, 30.0), wave_impulse=True,
        # The lattice rotates WITH the container, so no particle spawns
        # outside it.  The reference ignores rotation at spawn
        # (SPHFluid3D.cpp:166-169) and lets the constraint pass collapse
        # the out-of-box corners onto the faces, which packs cells far
        # past any fixed capacity.
        spawn_rotation="local"),
    "ghost_1m": BenchConfig(
        name="ghost_1m", n_target=1_000_000, box_half=(18.5, 18.5, 18.5),
        # capacity 8 overflowed by one row within 32 substeps on the
        # card (PERF.md); 12 keeps every row a neighbor source
        ghosts=True, cell_capacity=12),
    "export_4m": BenchConfig(
        name="export_4m", n_target=4_000_000, box_half=(41.0, 41.0, 41.0),
        h=0.4, grid_cap=256, viz_export=True),
}


def build(cfg: BenchConfig, seed: int = 0, neighbor_impl: Optional[str] = None):
    """Spawn + configure: returns (state, params, sim_config)."""
    impl = neighbor_impl or cfg.neighbor_impl
    spawn = S.spawn_standard(
        cfg.n_target, h=cfg.h, box_half=cfg.box_half, seed=seed,
        box_euler_deg=cfg.box_euler_deg,
        spawn_rotation=cfg.spawn_rotation)
    if cfg.ghosts:
        shell = S.spawn_ghost_box_shell(h=cfg.h, box_half=cfg.box_half)
        spawn = S.concat_spawns(spawn, shell)
    state = S.state_from_spawn(spawn)
    params = FluidParams.default(
        h=cfg.h,
        box_half=np.asarray(cfg.box_half, np.float32),
        box_euler_deg=np.asarray(cfg.box_euler_deg, np.float32),
        surface_tension=cfg.surface_tension,
    ).derive_mass()
    dims = compute_grid_dims(P.SHAPE_BOX, np.asarray(cfg.box_half),
                             np.asarray(cfg.box_euler_deg), cfg.h,
                             cap=cfg.grid_cap)
    sim = SimConfig(n=state.n, grid_dims=dims, neighbor_impl=impl,
                    cell_capacity=cfg.cell_capacity)
    return state, params, sim
