"""Scene orchestrator — the idiomatic split of the reference's Scene0p
god object (``Scene0p.{h,cpp}``, 3694 LoC) into composable pieces.

Owns: SceneSettings (every user-facing knob), the device-side sim state
(ParticleState + FluidParams + SceneBuffers), reaction phases, the orbit
camera, the sequencer, and an optional audio reactor.  Responsibilities:

- ``respawn()``      — settings -> spawn + params + jit config
  (reference ``ResetSimulation`` path, ``SPHFluid3D.cpp:641-659``)
- ``update(frame_dt, bands)`` — one frame: sequencer tick, audio
  reaction, fixed-dt substep loop (``Scene0p.cpp:1321-1333``)
- ``render()``       — headless frame via the viz subsystem
- ``save_preset``/``load_preset`` — the KV look system
- ``save_checkpoint``/``load_checkpoint`` — full binary state
  checkpointing (positions/velocities/flags + settings + phases), a
  capability the reference lacks (SURVEY.md §5.4)
- ``load_stencil_png`` — Liquid Logo targets from a PNG's bright pixels
  (``Scene0p.cpp:1805-1852``)
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from sph_tpu.core import params as P
from sph_tpu.core import state as S
from sph_tpu.core.params import FluidParams, SimConfig
from sph_tpu.engine import step as E
from sph_tpu.io import presets as pio
from sph_tpu.scene import art_presets as AP
from sph_tpu.scene import reaction as R
from sph_tpu.scene.sequencer import Sequencer
from sph_tpu.scene.settings import (SceneSettings, apply_preset,
                                    gather_preset, needs_respawn,
                                    to_viz_params, to_water_params)
from sph_tpu.viz.camera import OrbitCamera, fit_camera

MAX_SUBSTEPS_PER_FRAME = 16          # Scene0p.h:48
MAX_SUBSTEPS_SLOW_FRAME = 8          # Scene0p.cpp:1323 (dt > 33 ms)
STENCIL_CAPACITY = 4096


def params_from_settings(s: SceneSettings) -> FluidParams:
    """SceneSettings -> traced FluidParams (mass re-derived from h)."""
    return FluidParams.default(
        h=s.h, rest_density=s.rest_density, gas_constant=s.gas_constant,
        viscosity=s.viscosity, gravity=[0.0, s.gravity_y, 0.0],
        surface_tension=s.surface_tension, dt=s.time_step,
        foam_gen=s.foam_gen, foam_vel_ref=s.foam_vel_ref,
        box_center=s.box_center, box_half=s.box_half,
        box_euler_deg=s.box_euler, shape_type=s.shape_type,
        shape_aux=(s.shape_aux if any(s.shape_aux) else (5.0, 0.35, 2.5)),
        wall_restitution=s.wall_restitution, wall_friction=s.wall_friction,
        fountain_offset=s.fountain_pos, fountain_radius=s.fountain_radius,
        fountain_spread=s.fountain_spread, fountain_jet_speed=s.fountain_jet,
        fountain_drain_level=s.fountain_drain_level,
        fountain_drain_per_sec=s.fountain_drain_rate,
    ).derive_mass()


class Scene:
    def __init__(self, settings: Optional[SceneSettings] = None,
                 neighbor_impl: str = "cell", seed: int = 0,
                 preset_dir: str = "presets"):
        self.settings = settings or SceneSettings()
        self.neighbor_impl = neighbor_impl
        self.seed = seed
        self.preset_dir = preset_dir
        self.phases = R.ReactionPhases()
        self.live = R.LiveValues()
        self.sequencer = Sequencer(preset_dir=preset_dir)
        self.camera: OrbitCamera = fit_camera(self.settings.box_half)
        self.stencil_targets: Optional[np.ndarray] = None
        self.mesh_obj_path: str = ""     # OBJ asset for render mode 2
        self.auto_recover: bool = True   # NaN watchdog (SURVEY §5.3)
        self.watchdog_every: int = 30    # frames between probes
        self._frame_index = 0
        self._last_checkpoint: str = ""
        self.river_spec = None
        self.post_state = None
        self.last_frame_dt = 1.0 / 60.0
        self.dt_accumulator = 0.0
        self.sim_time = 0.0
        self.pending_reset = False

        self.state: Optional[S.ParticleState] = None
        self.params: Optional[FluidParams] = None
        self.config: Optional[SimConfig] = None
        self.buffers: Optional[E.SceneBuffers] = None
        self.respawn()

    # --- lifecycle -----------------------------------------------------

    def respawn(self) -> None:
        """Full reset: spawn from settings (ResetSimulation analogue)."""
        s = self.settings
        spawn = S.spawn_standard(
            s.particle_count, h=s.h, rest_density=s.rest_density,
            box_center=tuple(s.box_center), box_half=tuple(s.box_half),
            shape_type=s.shape_type, shape_aux=tuple(s.shape_aux)
            if any(s.shape_aux) else (5.0, 0.35, 2.5),
            mix_pattern=s.mix_pattern, use_jitter=s.use_jitter,
            jitter_amp=s.jitter_amp, seed=self.seed,
            box_euler_deg=tuple(s.box_euler))
        self.state = S.state_from_spawn(spawn)
        self.params = params_from_settings(s)
        dims = P.compute_grid_dims(
            s.shape_type, np.asarray(s.box_half, np.float32),
            np.asarray(s.box_euler, np.float32), s.h)
        self.config = SimConfig(
            n=self.state.n, grid_dims=dims,
            neighbor_impl=self.neighbor_impl,
            fountain_mode=s.fountain_on,
            stencil_capacity=(STENCIL_CAPACITY
                              if self.stencil_targets is not None else 0))
        self.buffers = E.SceneBuffers.create(self.config)
        if self.stencil_targets is not None:
            self._upload_stencil()
        self.dt_accumulator = 0.0
        self.pending_reset = False

    def _sync_params(self) -> None:
        """Push live-tunable settings into the traced params (no respawn,
        no recompile — everything traced)."""
        self.params = params_from_settings(self.settings).replace(
            gravity=self.params.gravity)   # reaction may have tipped it
        self._track_grid()

    def _track_grid(self) -> None:
        """Live grid tracking. The reference recomputes grid extents
        every substep and reallocs when the cell count changes
        (``SPHFluid3D.cpp:282-304,366-375``), so a live-grown container
        keeps correct binning. ``box.half`` is a LIVE (non-structural)
        key here: without this, growing the box past the spawn-time
        grid silently clamps outlying particles into edge cells. When
        the required dims exceed the current grid, rebuild the config
        with each growing axis bucketed up to the next multiple of 8
        cells — the bucket amortizes recompiles (the analogue of
        the realloc) under a continuous grow drag. Shrinks keep the
        larger grid (harmless: extra empty cells) until the next
        respawn resizes exactly."""
        s = self.settings
        req = P.compute_grid_dims(
            s.shape_type, np.asarray(s.box_half, np.float32),
            np.asarray(s.box_euler, np.float32), s.h)
        cur = self.config.grid_dims
        if all(r <= c for r, c in zip(req, cur)):
            return
        # compute_grid_dims already rounds to 8-cell buckets and caps
        new = tuple(max(r, c) for r, c in zip(req, cur))
        self.config = dataclasses.replace(self.config, grid_dims=new)

    def apply_settings(self, new: SceneSettings) -> None:
        if needs_respawn(self.settings, new):
            self.settings = new
            self.respawn()
        else:
            self.settings = new
            self._sync_params()

    def apply_art_preset(self, which: int) -> None:
        self.settings = AP.apply_art_preset(self.settings, which)
        self.respawn()

    def surprise_me(self, seed: Optional[int] = None) -> None:
        self.settings = AP.surprise_me(self.settings, seed)
        self.respawn()

    # --- frame update --------------------------------------------------

    def update(self, frame_dt: float,
               bands: Tuple[float, float, float] = (0.0, 0.0, 0.0),
               max_substeps: Optional[int] = None) -> int:
        """One frame: sequencer -> impulses -> substep loop.  Returns the
        number of substeps run."""
        s = self.settings

        if self.sequencer.enabled:
            new = self.sequencer.tick(s, self.sim_time)
            if new is not s:
                self.settings = s = new
                self._sync_params()

        if self.pending_reset:
            self.respawn()
            s = self.settings

        state = self.state
        params = self.params

        state, self.phases = R.drive_continuous_wave(
            state, s, self.phases, frame_dt)

        if s.audio_enabled:
            bass, mid, treble = bands
        else:
            bass = mid = treble = 0.0
        state, params, self.phases, self.live = R.drive_audio_reaction(
            state, params, s, self.phases, bass, mid, treble, frame_dt,
            stencil_targets=self.stencil_targets)
        params = params.replace(
            fountain_jet_speed=jnp.float32(self.live.fountain_jet))

        if max_substeps is None:
            max_substeps = (MAX_SUBSTEPS_SLOW_FRAME if frame_dt > 0.033
                            else MAX_SUBSTEPS_PER_FRAME)
        n_sub, self.dt_accumulator = E.substeps_for_frame(
            frame_dt, s.time_step, max_substeps, self.dt_accumulator)
        if n_sub > 0:
            state, self.buffers = E.run_substeps(
                state, params, self.buffers,
                jnp.float32(s.time_step), n_sub, self.config)

        # auto-orbit camera (Scene0p.cpp:560-591)
        if s.orbit_on:
            self.camera.yaw_deg += self.live.orbit_speed_deg * frame_dt

        self.state = state
        self.params = params
        self.sim_time += frame_dt
        self.last_frame_dt = frame_dt
        self._frame_index += 1
        if (self.auto_recover and n_sub > 0
                and self._frame_index % self.watchdog_every == 0):
            self._watchdog_check()
        return n_sub

    # --- failure containment (SURVEY §5.3) ------------------------------

    def _watchdog_check(self) -> None:
        """NaN/blowup watchdog: the physics clamps (density floor,
        pressure clamp, CFL cap) make divergence unlikely, but bad live
        parameter edits (dt spikes, giant impulses) can still blow the
        state up.  Detection samples a position slice every
        ``watchdog_every`` frames (one small device sync); recovery
        reloads the last good checkpoint when one was saved this
        session, else respawns — and logs loudly either way.  The
        reference has no equivalent (a NaN'd GL buffer just renders
        garbage forever)."""
        import numpy as _np
        probe = _np.asarray(self.state.pos[:1024])
        if _np.isfinite(probe).all():
            return
        from sph_tpu.utils import log
        if self._last_checkpoint and os.path.exists(self._last_checkpoint):
            log.error(f"watchdog: non-finite state at t={self.sim_time:.3f}"
                      f" — restoring checkpoint {self._last_checkpoint}")
            self.load_checkpoint(self._last_checkpoint)
        else:
            log.error(f"watchdog: non-finite state at t={self.sim_time:.3f}"
                      f" — respawning")
            self.respawn()

    # --- river mode ----------------------------------------------------

    def enable_river(self, seed: Optional[int] = None) -> None:
        """Procedural canyon + channel-following stream recycling
        (``SPHFluid3D.cpp:700-806``; latent in the reference UI,
        first-class here)."""
        from sph_tpu.scene.river import (RiverSpec, generate_river_terrain,
                                         river_params)
        spec = RiverSpec.random(self.seed if seed is None else seed)
        terrain = generate_river_terrain(
            spec, self.settings.box_center, self.settings.box_half,
            res=self.config.terrain_res)
        self.params = river_params(self.params, spec,
                                   self.settings.box_center,
                                   self.settings.box_half)
        self.config = dataclasses.replace(self.config, river_mode=True)
        self.buffers = self.buffers.replace(terrain=jnp.asarray(terrain))
        self.river_spec = spec

    # --- rendering -----------------------------------------------------

    def _camera_now(self) -> "OrbitCamera":
        return dataclasses.replace(
            self.camera,
            distance=self.camera.distance * self.live.cam_dist_scale)

    def render(self, width: int = 960, height: int = 540,
               apply_post: bool = True) -> np.ndarray:
        """One frame via the path selected by ``settings.render_mode``
        (0=SSFR water, 1=impostor splats, 2=lit mesh spheres —
        ``Scene0p.cpp:1412-1464``), then container wireframe overlay and
        the post-FX chain."""
        s = self.settings
        vp = to_viz_params(
            s, anim_time=self.phases.anim_time,
            hue_shift_live=self.live.hue_shift_deg,
            bright_mul_live=self.live.bright_mul)
        cam = self._camera_now()
        radius = 0.5 * s.h * self.live.radius_scale

        view_z = None
        if s.render_mode == 0:
            from sph_tpu.viz.ssfr import render_water
            # water writes no scene depth -> DOF skipped, like the
            # reference (Scene0p.cpp:2601-2603)
            img = render_water(self.state, to_water_params(s), cam,
                               width=width, height=height,
                               particle_radius=radius, vp=vp)
        else:
            from sph_tpu.viz.splat import render_frame, render_frame_mesh
            want_depth = apply_post and s.lens_aperture > 0.0
            background = tuple(s.bg_color)
            if self.river_spec is not None:
                # terrain triangle-mesh pass under the fluid (R12,
                # terrainVert/Frag.glsl + Scene0p.cpp:2942-3123)
                from sph_tpu.viz.terrain import draw_terrain
                bg_img = (np.broadcast_to(
                    np.asarray(s.bg_color, np.float32),
                    (height, width, 3)) * 255.0).astype(np.uint8)
                background = draw_terrain(
                    bg_img, np.asarray(self.buffers.terrain),
                    s.box_center, s.box_half,
                    cam.view_matrix(), cam.proj_matrix(width / height),
                    sun_dir=tuple(s.sun_dir), sun_color=tuple(s.sun_color))
            if s.render_mode == 2:
                # TRUE instanced mesh spheres (Mesh.cpp + the
                # defaultVert instancing path), z-buffer rasterized
                out = render_frame_mesh(
                    self.state, vp, cam, width=width, height=height,
                    particle_radius=radius, background=background,
                    mesh_obj=self.mesh_obj_path or None,
                    return_depth=want_depth)
            else:
                out = render_frame(self.state, vp, cam,
                                   width=width, height=height,
                                   particle_radius=radius,
                                   background=background,
                                   return_depth=want_depth)
            img, view_z = out if want_depth else (out, None)

        if s.show_outline:
            img = self._overlay_lines(img, cam, width, height)
        if apply_post:
            img = self._apply_post(img, view_z)
        return img

    def _overlay_lines(self, img: np.ndarray, cam, width: int,
                       height: int) -> np.ndarray:
        from sph_tpu.viz import wireframe as WF
        s = self.settings
        view = cam.view_matrix()
        proj = cam.proj_matrix(width / height)
        lines = WF.container_wireframe(
            s.shape_type, s.box_half, s.box_center, s.box_euler,
            aux=(tuple(s.shape_aux) if any(s.shape_aux)
                 else (5.0, 0.35, 2.5)))
        if self.river_spec is not None:
            lines += WF.river_bank_lines(
                self.river_spec, s.box_center, s.box_half)
        return WF.draw_polylines(img, lines, view, proj,
                                 color=tuple(s.outline_color))

    def _apply_post(self, img: np.ndarray, view_z=None) -> np.ndarray:
        from sph_tpu.viz import postfx as PF
        pp = PF.post_params_from_settings(self.settings)
        if not getattr(self, "post_state", None):
            self.post_state = PF.PostState()
        active = (pp.aperture > 0.0 or pp.trail_half_life > 1e-3
                  or pp.bloom_strength > 0.0 or pp.streak_strength > 0.0
                  or pp.kaleido_segments > 1 or pp.chromatic > 0.0
                  or pp.vignette > 0.0 or pp.grain > 0.0)
        if not active:
            return img
        out, self.post_state = PF.run_post_chain(
            jnp.asarray(img, jnp.float32) / 255.0, pp, self.post_state,
            self.last_frame_dt,
            view_z=(jnp.asarray(view_z) if view_z is not None else None))
        return (np.clip(np.asarray(out), 0.0, 1.0) * 255.0
                ).astype(np.uint8)

    def capture(self, path: str, size: str = "window",
                width: int = 960, height: int = 540,
                supersample: Optional[int] = None,
                trail_warmup_frames: int = 40) -> Tuple[int, int]:
        """High-quality still capture (``Scene0p::DoCapture``,
        ``Scene0p.cpp:3525-3695``): square/4K/window size, 2x supersample
        unless UV-warping post-FX are active, trail warmup when trails
        are on.  Returns the written (width, height)."""
        from sph_tpu.viz.splat import save_png
        s = self.settings
        if size == "square":
            width = height = 3000                 # Scene0p.cpp:3526
        elif size == "4k":
            width, height = 3840, 2160
        if supersample is None:
            warping = (s.kaleido_segments > 1 or s.chromatic > 0.0
                       or s.lens_aperture > 0.0)
            supersample = 1 if warping else 2     # Scene0p.cpp:3555-3558
        ss = max(1, supersample)

        if s.trail_half_life > 1e-3:              # Scene0p.cpp:3630-3641
            self.post_state = None
            for _ in range(trail_warmup_frames):
                self.update(1.0 / 60.0)
                self.render(width, height)

        img = self.render(width * ss, height * ss)
        if ss > 1:
            img = img.reshape(height, ss, width, ss, 3) \
                     .mean(axis=(1, 3)).astype(np.uint8)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_png(img, path)
        return width, height

    # --- presets -------------------------------------------------------

    def save_preset(self, name: str) -> bool:
        os.makedirs(self.preset_dir, exist_ok=True)
        path = os.path.join(self.preset_dir,
                            f"{pio.sanitize_name(name)}.txt")
        return pio.save_file(path, gather_preset(self.settings))

    def load_preset(self, name: str, structural: bool = True) -> bool:
        path = os.path.join(self.preset_dir,
                            f"{pio.sanitize_name(name)}.txt")
        kv = pio.load_file(path)
        if kv is None:
            return False
        new = apply_preset(self.settings, kv, structural=structural)
        if structural:
            self.settings = new
            self.respawn()
        else:
            self.apply_settings(new)
        return True

    # --- checkpointing (new capability, SURVEY.md §5.4) ---------------

    def save_checkpoint(self, path: str) -> None:
        self._last_checkpoint = path     # watchdog recovery target
        st = self.state
        np.savez_compressed(
            path,
            pos=np.asarray(st.pos), vel=np.asarray(st.vel),
            acc=np.asarray(st.acc), density=np.asarray(st.density),
            pressure=np.asarray(st.pressure), foam=np.asarray(st.foam),
            ghost=np.asarray(st.ghost), active=np.asarray(st.active),
            face=np.asarray(st.face),
            color_group=np.asarray(st.color_group),
            valid=np.asarray(st.valid), orig_id=np.asarray(st.orig_id),
            settings_kv=pio.serialize(gather_preset(self.settings)),
            phases=np.asarray([getattr(self.phases, f.name) for f in
                               dataclasses.fields(self.phases)]),
            sim_time=self.sim_time,
            dt_accumulator=self.dt_accumulator)

    def load_checkpoint(self, path: str) -> None:
        z = np.load(path, allow_pickle=False)
        kv = pio.parse(str(z["settings_kv"]))
        self.settings = apply_preset(self.settings, kv, structural=True)
        self.respawn()   # rebuild params/config/buffers at the right n
        self.state = S.ParticleState(
            pos=jnp.asarray(z["pos"]), vel=jnp.asarray(z["vel"]),
            acc=jnp.asarray(z["acc"]), density=jnp.asarray(z["density"]),
            pressure=jnp.asarray(z["pressure"]),
            foam=jnp.asarray(z["foam"]), ghost=jnp.asarray(z["ghost"]),
            active=jnp.asarray(z["active"]), face=jnp.asarray(z["face"]),
            color_group=jnp.asarray(z["color_group"]),
            valid=jnp.asarray(z["valid"]),
            orig_id=jnp.asarray(z["orig_id"]))
        for f, v in zip(dataclasses.fields(self.phases), z["phases"]):
            setattr(self.phases, f.name, float(v))
        self.sim_time = float(z["sim_time"])
        self.dt_accumulator = float(z["dt_accumulator"])

    # --- liquid logo ---------------------------------------------------

    def load_stencil_png(self, path: str,
                         brightness_threshold: float = 0.5) -> int:
        """PNG bright pixels -> 3D attractor targets in the container's
        XY plane (``Scene0p.cpp:1805-1852``).  Returns target count."""
        from sph_tpu.viz.splat import load_png
        rgb = load_png(path).astype(np.float32)[..., :3] / 255.0
        # ITU-R 601 luma, as an "L" conversion takes it (grey stays grey)
        img = (rgb @ np.array([0.299, 0.587, 0.114], np.float32)
               if rgb.shape[-1] == 3 else rgb[..., 0])
        hpx, wpx = img.shape
        ys, xs = np.nonzero(img > brightness_threshold)
        if len(xs) == 0:
            self.stencil_targets = None
            return 0
        # subsample to capacity, preserve aspect, center at container
        if len(xs) > STENCIL_CAPACITY:
            sel = np.random.default_rng(0).choice(
                len(xs), STENCIL_CAPACITY, replace=False)
            xs, ys = xs[sel], ys[sel]
        scale = self.settings.logo_scale / max(hpx, 1)
        cx = np.asarray(self.settings.box_center, np.float32)
        tx = (xs - wpx * 0.5) * scale + cx[0]
        ty = (hpx * 0.5 - ys) * scale + cx[1]
        tz = np.zeros_like(tx) + cx[2]
        self.stencil_targets = np.stack([tx, ty, tz], -1).astype(np.float32)
        self.settings.logo_path = path
        self.config = dataclasses.replace(
            self.config, stencil_capacity=STENCIL_CAPACITY)
        self.buffers = E.SceneBuffers.create(self.config)
        self._upload_stencil()
        return len(tx)

    def _upload_stencil(self) -> None:
        t = np.zeros((STENCIL_CAPACITY, 3), np.float32)
        n = min(len(self.stencil_targets), STENCIL_CAPACITY)
        t[:n] = self.stencil_targets[:n]
        self.buffers = self.buffers.replace(
            stencil_targets=jnp.asarray(t),
            stencil_count=jnp.int32(n))
