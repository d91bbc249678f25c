"""Simulation parameter structures.

``FluidParams`` mirrors the reference solver's live-tunable ``param_*``
fields (reference ``SPHFluid3D.h:94-189``) as a JAX pytree of traced scalars,
so every slider edit re-runs the same compiled step function without
recompilation.  ``SimConfig`` holds the *static* facts that shape the
compiled graph (particle count, grid dims, mode flags); changing one of
these triggers a (bucketed) recompile, mirroring the reference's
buffer-reallocation boundary (``SPHFluid3D.cpp:366-375``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sph_tpu.utils.pytree import pytree_dataclass

# Shape type ids — reference SPHFluid3D.h:117-118
SHAPE_BOX = 0
SHAPE_SPHERE = 1
SHAPE_CYLINDER = 2
SHAPE_TORUS = 3
SHAPE_CAPSULE = 4
SHAPE_HOURGLASS = 5
SHAPE_EGG = 6
SHAPE_STAR = 7
SHAPE_SUPERELLIPSOID = 8
SHAPE_TREFOIL = 9
NUM_SHAPES = 10

SHAPE_NAMES = (
    "box", "sphere", "cylinder", "torus", "capsule",
    "hourglass", "egg", "star", "superellipsoid", "trefoil",
)


def _f32(x) -> jax.Array:
    return jnp.asarray(x, dtype=jnp.float32)


def _vec3(x, y, z) -> jax.Array:
    return jnp.asarray([x, y, z], dtype=jnp.float32)


@pytree_dataclass
class FluidParams:
    """Live-tunable physics + container parameters (all traced float32/int32).

    Defaults mirror reference ``SPHFluid3D.h:94-123``. ``mass`` is
    auto-derived at spawn as ``rest_density * (0.85 h)^3``
    (reference ``SPHFluid3D.cpp:92``).
    """

    h: jax.Array                 # smoothing length
    mass: jax.Array
    rest_density: jax.Array
    gas_constant: jax.Array
    viscosity: jax.Array
    gravity: jax.Array           # [3]
    surface_tension: jax.Array
    dt: jax.Array                # default substep timestep
    foam_gen: jax.Array
    foam_vel_ref: jax.Array

    # Container (OBB / analytic shape)
    box_center: jax.Array        # [3]
    box_half: jax.Array          # [3] — per-shape meaning, see SPHFluid3D.h:113-115
    box_euler_deg: jax.Array     # [3] XYZ euler degrees
    shape_type: jax.Array        # i32 scalar, 0..9
    shape_aux: jax.Array         # [3] star: x=points y=depth | superellipsoid: z=exponent
    wall_restitution: jax.Array
    wall_friction: jax.Array

    # Ghost-boundary per-face activation (config 4): 6 flags -X,+X,-Y,+Y,-Z,+Z
    ghost_face_active: jax.Array  # [6] i32

    # Fountain mode live values (reference SPHFluid3D.h:144-152)
    fountain_offset: jax.Array    # [3] nozzle, container-relative
    fountain_radius: jax.Array
    fountain_spread: jax.Array
    fountain_jet_speed: jax.Array
    fountain_drain_level: jax.Array
    fountain_drain_per_sec: jax.Array

    # River / stream mode (reference SPHFluid3D.h:154-179)
    river_emitter_pos: jax.Array  # [3]
    river_emitter_vel: jax.Array  # [3]
    river_emitter_radius: jax.Array
    river_sink_y: jax.Array
    river_sink_z_max: jax.Array
    river_amp: jax.Array
    river_freq: jax.Array
    river_phase: jax.Array
    river_channel_width: jax.Array
    river_flow_gravity: jax.Array
    terrain_min: jax.Array        # [2] (x, z) world min
    terrain_size: jax.Array       # [2] (x, z) world extent
    terrain_restitution: jax.Array
    terrain_friction: jax.Array

    @classmethod
    def default(cls, **overrides) -> "FluidParams":
        vals = dict(
            h=_f32(0.28),
            mass=_f32(1000.0 * (0.28 * 0.85) ** 3),
            rest_density=_f32(1000.0),
            gas_constant=_f32(2000.0),
            viscosity=_f32(3.5),
            gravity=_vec3(0.0, -980.0, 0.0),
            surface_tension=_f32(0.0728),
            dt=_f32(1e-3),
            foam_gen=_f32(1.0),
            foam_vel_ref=_f32(8.0),
            box_center=_vec3(0, 0, 0),
            box_half=_vec3(7, 7, 7),
            box_euler_deg=_vec3(0, 0, 0),
            shape_type=jnp.asarray(SHAPE_BOX, dtype=jnp.int32),
            shape_aux=_vec3(5.0, 0.35, 2.5),
            wall_restitution=_f32(0.15),
            wall_friction=_f32(0.02),
            ghost_face_active=jnp.ones((6,), dtype=jnp.int32),
            fountain_offset=_vec3(0.0, -5.0, 0.0),
            fountain_radius=_f32(1.0),
            fountain_spread=_f32(0.25),
            fountain_jet_speed=_f32(25.0),
            fountain_drain_level=_f32(1.0),
            fountain_drain_per_sec=_f32(2.0),
            river_emitter_pos=_vec3(0, 3.0, -9.0),
            river_emitter_vel=_vec3(0, -0.5, 4.0),
            river_emitter_radius=_f32(1.5),
            river_sink_y=_f32(-8.5),
            river_sink_z_max=_f32(9.0),
            river_amp=_f32(2.0),
            river_freq=_f32(0.25),
            river_phase=_f32(0.0),
            river_channel_width=_f32(3.0),
            river_flow_gravity=_f32(80.0),
            terrain_min=jnp.asarray([-7.0, -10.0], dtype=jnp.float32),
            terrain_size=jnp.asarray([14.0, 20.0], dtype=jnp.float32),
            terrain_restitution=_f32(0.02),
            terrain_friction=_f32(0.05),
        )
        for k, v in overrides.items():
            if k not in vals:
                raise KeyError(f"unknown FluidParams field: {k}")
            proto = vals[k]
            vals[k] = jnp.asarray(v, dtype=proto.dtype).reshape(proto.shape)
        return cls(**vals)

    def derive_mass(self) -> "FluidParams":
        """mass = rest_density * spacing^3, spacing = 0.85 h (SPHFluid3D.cpp:89-92)."""
        spacing = 0.85 * self.h
        return self.replace(mass=self.rest_density * spacing**3)


def rotation_matrix(euler_deg: jax.Array) -> jax.Array:
    """World-from-box rotation, R = Rz @ Ry @ Rx of the XYZ euler angles.

    Matches the reference's column-major composition
    (``SPHFluid3D.cpp:13-30``): world = R @ local.
    """
    rad = euler_deg * (jnp.pi / 180.0)
    cx, sx = jnp.cos(rad[0]), jnp.sin(rad[0])
    cy, sy = jnp.cos(rad[1]), jnp.sin(rad[1])
    cz, sz = jnp.cos(rad[2]), jnp.sin(rad[2])
    rx = jnp.stack([
        jnp.stack([jnp.float32(1), jnp.float32(0), jnp.float32(0)]),
        jnp.stack([jnp.float32(0), cx, -sx]),
        jnp.stack([jnp.float32(0), sx, cx]),
    ])
    ry = jnp.stack([
        jnp.stack([cy, jnp.float32(0), sy]),
        jnp.stack([jnp.float32(0), jnp.float32(1), jnp.float32(0)]),
        jnp.stack([-sy, jnp.float32(0), cy]),
    ])
    rz = jnp.stack([
        jnp.stack([cz, -sz, jnp.float32(0)]),
        jnp.stack([sz, cz, jnp.float32(0)]),
        jnp.stack([jnp.float32(0), jnp.float32(0), jnp.float32(1)]),
    ])
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(rz, ry, precision=hi), rx,
                      precision=hi).astype(jnp.float32)


def rows_times(v: jax.Array, m: jax.Array) -> jax.Array:
    """``v @ m`` for [N,3] rows and a 3x3 ``m``, as float32 multiply-adds.

    A GPU may run a float32 ``@`` in TF32 (about three decimal digits);
    at container scale that error moves particles across cells and walls.
    """
    return v[:, 0:1] * m[0] + v[:, 1:2] * m[1] + v[:, 2:3] * m[2]


def effective_half(params: FluidParams) -> jax.Array:
    """Per-shape container half extents seen by grid/spawn code.

    Mirrors ``SPHFluidGPU::EffectiveHalf`` (``SPHFluid3D.h:125-141``).
    Works with traced ``shape_type`` via ``lax.switch``.
    """
    bh = params.box_half

    def box(_):
        return bh

    def sphere(_):
        return jnp.stack([bh[0], bh[0], bh[0]])

    def cylinder(_):
        return jnp.stack([bh[0], bh[1], bh[0]])

    def torus(_):
        return jnp.stack([bh[0] + bh[1], bh[1], bh[0] + bh[1]])

    def capsule(_):
        return jnp.stack([bh[0], bh[1] + bh[0], bh[0]])

    def cyl_like(_):
        return jnp.stack([bh[0], bh[1], bh[0]])

    def trefoil(_):
        return jnp.stack([
            3.0 * bh[0] + bh[1],
            0.35 * bh[0] + bh[1],
            3.0 * bh[0] + bh[1],
        ])

    fns = [box, sphere, cylinder, torus, capsule,
           cyl_like, cyl_like, cyl_like, cyl_like, trefoil]
    return jax.lax.switch(jnp.clip(params.shape_type, 0, NUM_SHAPES - 1), fns, None)


def effective_half_np(shape_type: int, box_half: np.ndarray) -> np.ndarray:
    """Host-side (numpy) EffectiveHalf, for spawn and static grid sizing."""
    bh = np.asarray(box_half, dtype=np.float32)
    if shape_type == SHAPE_SPHERE:
        return np.array([bh[0], bh[0], bh[0]], np.float32)
    if shape_type in (SHAPE_CYLINDER, SHAPE_HOURGLASS, SHAPE_EGG,
                      SHAPE_STAR, SHAPE_SUPERELLIPSOID):
        return np.array([bh[0], bh[1], bh[0]], np.float32)
    if shape_type == SHAPE_TORUS:
        return np.array([bh[0] + bh[1], bh[1], bh[0] + bh[1]], np.float32)
    if shape_type == SHAPE_CAPSULE:
        return np.array([bh[0], bh[1] + bh[0], bh[0]], np.float32)
    if shape_type == SHAPE_TREFOIL:
        return np.array([
            3.0 * bh[0] + bh[1],
            0.35 * bh[0] + bh[1],
            3.0 * bh[0] + bh[1],
        ], np.float32)
    return bh.copy()


def rotation_matrix_np(euler_deg) -> np.ndarray:
    rad = np.asarray(euler_deg, np.float64) * (np.pi / 180.0)
    cx, sx = np.cos(rad[0]), np.sin(rad[0])
    cy, sy = np.cos(rad[1]), np.sin(rad[1])
    cz, sz = np.cos(rad[2]), np.sin(rad[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)


# Neighbor engines: the all-pairs oracle, the same all-pairs sums as one
# fused GPU kernel, the gather cell list and the binned-plane cell list.
NEIGHBOR_IMPLS = ("brute", "brute_pallas", "cell", "binned")

GRID_DIM_CAP = 160  # per-axis cell cap, reference SPHFluid3D.cpp:298


def compute_grid_dims(shape_type: int, box_half, box_euler_deg, h: float,
                      round_to: int = 8,
                      cap: int = GRID_DIM_CAP) -> Tuple[int, int, int]:
    """Static grid dims from the rotated container's world AABB.

    Mirrors ``SPHFluidGPU::ComputeGridExtents`` (``SPHFluid3D.cpp:282-304``):
    ``ext_i = sum_j |R_ij| half_j + cellSize``, ``dim = ceil(2 ext / cell)``
    clamped to [1, 160] — then rounded UP to a multiple of ``round_to`` so
    live container edits rarely change the static dims (extra cells simply
    stay empty; jit shape stability beats exact sizing).
    """
    # Binning happens in CONTAINER-LOCAL frame (grid_cell_coords), so the
    # grid needs only the unrotated effective half + 1 cell margin — the
    # reference bins in world space over the rotated AABB
    # (SPHFluid3D.cpp:282-304), which inflates a rotated box's grid ~3x.
    del box_euler_deg
    half = effective_half_np(shape_type, np.asarray(box_half, np.float32))
    ext = half + h
    dims = []
    for e in ext:
        d = int(np.ceil((2.0 * e) / h))
        d = min(cap, max(1, d))
        d = min(cap, ((d + round_to - 1) // round_to) * round_to)
        dims.append(d)
    return tuple(dims)


def grid_min(params: FluidParams) -> jax.Array:
    """Traced CONTAINER-LOCAL grid origin (positions are rotated into the
    container frame before binning; see ``grid_cell_coords``)."""
    half = effective_half(params)
    return -(half + params.h)


def grid_cell_coords(pos: jax.Array, params: FluidParams,
                     dims) -> jax.Array:
    """[N,3] world positions -> [N,3] int32 cell coords, clipped.

    Bins in the container-LOCAL frame: ``local = R^T (p - c)``.  For an
    unrotated container this reduces exactly to the world-space binning
    (local - gmin == pos - world_gmin), and for rotated containers the
    grid stays tight instead of covering the rotated AABB.  Any spatial
    partition gives identical physics — only pair distances matter."""
    rot = rotation_matrix(params.box_euler_deg)
    local = rows_times(pos - params.box_center[None, :], rot)  # R^T d
    gmin = grid_min(params)
    c = jnp.floor((local - gmin[None, :]) / params.h).astype(jnp.int32)
    return jnp.clip(c, 0, jnp.asarray(dims, jnp.int32)[None, :] - 1)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static (hashable) compile-time configuration.

    The analogue of the reference's allocation-time decisions: particle
    buffer size, grid dims, mode flags (``SPHFluid3D.cpp:306-343,439-447``).
    """

    n: int                                 # padded particle capacity
    grid_dims: Tuple[int, int, int]        # (nx, ny, nz) static cell dims
    cell_capacity: int = 8                 # max particles binned per cell
    neighbor_impl: str = "cell"            # one of NEIGHBOR_IMPLS
    river_mode: bool = False
    fountain_mode: bool = False
    stencil_capacity: int = 0              # >0 enables Liquid Logo targets
    terrain_res: Tuple[int, int] = (64, 64)
    max_substeps: int = 16                 # per-frame cap, Scene0p.h:48
    sweep_unroll: bool = False             # binned engine: statically
                                           # unroll the 27 offsets (larger
                                           # graph, slower compiles)

    def __post_init__(self):
        if self.neighbor_impl not in NEIGHBOR_IMPLS:
            raise ValueError(
                f"unknown neighbor_impl {self.neighbor_impl!r}; "
                f"choose one of {NEIGHBOR_IMPLS}")

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.grid_dims
        return nx * ny * nz
