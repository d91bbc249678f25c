"""sph_tpu — a JAX Smoothed Particle Hydrodynamics framework for GPUs.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
smilne36/ComponentFrameworks-smoothed-particle-hydrodynamics (a Windows/OpenGL
compute-shader SPH fluid simulator + music-visualizer art tool), re-designed
as JAX programs:

- The per-substep GPU dispatch pipeline (ClearGrid / BuildGrid / SPHFluid /
  OBBConstraints / impulse shaders, reference ``SPHFluid3D.cpp:359-450``)
  collapses into one jitted, purely functional step function.
- The atomicExchange linked-list spatial hash (``BuildGrid.comp``) becomes a
  sort-based cell list: cell-key sort + dense fixed-capacity bins feeding
  a vectorized jnp gather sweep (all-pairs scenes: a fused Pallas kernel).
- The Scene0p "god object" splits into engine/scene modules; render paths
  become a headless frame-export pipeline (palettes, color drives, splatting).
- Multi-chip scaling (a new capability) shards the particle axis over a
  ``jax.sharding.Mesh`` via ``shard_map``.

Layout:
    core/       ParticleState SoA pytree, FluidParams, container/shape specs
    physics/    SPH kernels, brute-force oracle + its fused Pallas kernel,
                cell-list solver, constraints, impulses, emitters
    neighbors/  cell keys, sorting, dense bins (gather and binned-plane)
    engine/     substep composition, frame loop, scene orchestration
    parallel/   multi-device domain decomposition (shard_map)
    io/         preset KV text format, state checkpointing
    audio/      band-split DSP, offline track analysis, drop detection
    viz/        palettes, color drives, point-splat renderer, frame export
    app/        CLI, benchmark configs
    native/     C++ host runtime (audio decode, PNG encode) via ctypes
"""

__version__ = "0.1.0"

from sph_tpu.core.params import FluidParams, SimConfig  # noqa: F401
from sph_tpu.core.state import ParticleState  # noqa: F401
