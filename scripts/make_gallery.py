#!/usr/bin/env python
"""Render a small doc gallery: one still per render path / scene mode.

CPU-friendly sizes (tiny particle counts, binned engine); deterministic
seeds; ``--gpu`` renders on the GPU instead. Writes docs/gallery/*.png.
"""
from __future__ import annotations

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable without PYTHONPATH
import os
import sys

import jax
if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

from sph_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from sph_tpu.scene.scene import Scene
from sph_tpu.scene.settings import SceneSettings
from sph_tpu.viz.splat import save_png

OUT = "docs/gallery"
W, H = 480, 270


def base_settings(**kw):
    s = SceneSettings()
    s.particle_count = 3000
    s.box_half = [5.0, 5.0, 5.0]
    s.show_outline = True
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def settle(scene, frames=30):
    for _ in range(frames):
        scene.update(1.0 / 60.0)


def shot(name, scene, zoom=1.0):
    scene.camera.distance *= zoom
    img = scene.render(W, H)
    scene.camera.distance /= zoom
    save_png(img, os.path.join(OUT, f"{name}.png"))
    print(f"wrote {name}.png")


def main():
    os.makedirs(OUT, exist_ok=True)

    # 1. impostor splats, speed-driven palette, lit spheres, box outline
    sc = Scene(base_settings(render_mode=1, palette_id=2, viz_mode=1,
                             lit_particles=True), neighbor_impl="binned",
               seed=7)
    settle(sc)
    shot("impostors_speed", sc, zoom=0.55)

    # 2. SSFR water surface with sky
    st = base_settings(render_mode=0, sky_on=True, show_outline=False,
                       thickness_strength=0.35, foam_amount=2.0)
    st.render_radius_scale = 2.2
    sc = Scene(st, neighbor_impl="binned", seed=3)
    settle(sc)
    shot("water_ssfr", sc, zoom=0.45)

    # 3. torus container wireframe, two-color groups
    sc = Scene(base_settings(render_mode=1, shape_type=3,
                             box_half=[4.0, 1.5, 4.0], two_color=True,
                             palette_id=6, palette_id2=12, mix_pattern=0),
               neighbor_impl="binned", seed=5)
    settle(sc)
    shot("torus_two_color", sc, zoom=0.6)

    # 4. river canyon with bank lines
    sc = Scene(base_settings(render_mode=1, particle_count=2000,
                             palette_id=14, viz_mode=0),
               neighbor_impl="binned", seed=11)
    sc.enable_river(11)
    settle(sc, 40)
    shot("river_canyon", sc, zoom=0.6)

    # 5. post chain: bloom + vignette over a stirred splash
    st = base_settings(render_mode=1, palette_id=19, viz_mode=1,
                       bloom_strength=1.2, bloom_threshold=0.25,
                       vignette=0.3, show_outline=True,
                       lit_particles=True, continuous_wave=True)
    sc = Scene(st, neighbor_impl="binned", seed=9)
    settle(sc, 45)
    shot("postfx_bloom", sc, zoom=0.55)


if __name__ == "__main__":
    main()
