"""Headless point-splat renderer — the export-path stand-in for the
reference's impostor pass (``shaders/particleImpostor.vert/frag``).

No GPU rasterizer exists here, so frames render by painter's algorithm:
particles sort back-to-front by view depth (one ``lax.sort``), then each
footprint offset writes colors into the flat image with ascending-index
overwrite semantics (``numpy`` fancy assignment on host).  Point size
follows the reference's perspective formula
``2r * P[1][1] / -z * H/2`` (``particleImpostor.vert:38-40``); each
splat is shaded as a fake sphere (disc normal + lit shading) like the
impostor fragment shader.

Color computation (drive -> palette -> grade) is the jitted pipeline in
``palettes.py`` and runs on the device; only screen-space composition is
host-side.  Off the hot path by design (SURVEY.md §7 item 11).
"""
from __future__ import annotations

import functools
import struct
import zlib
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sph_tpu.viz import palettes as P
from sph_tpu.viz.camera import OrbitCamera


def _project(pos: np.ndarray, view: np.ndarray, proj: np.ndarray,
             width: int, height: int):
    """World -> (pixel xy, view z, ndc ok mask)."""
    vp = pos @ view[:3, :3].T + view[:3, 3]
    clip = vp @ proj[:3, :3].T + proj[:3, 3]
    w = -vp[:, 2]
    ok = w > 1e-6
    safe_w = np.maximum(w, 1e-6)
    ndc = clip[:, :2] / safe_w[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * height
    return px, py, vp, ok


@functools.partial(jax.jit, static_argnums=(6,))
def _colors_device(pos, view_pos, vel, pressure, density, color_group,
                   vp_static):
    return P.particle_colors(vp_static, pos, view_pos, vel, pressure,
                             density, color_group)


def render_frame(state, vp: P.VizParams, cam: OrbitCamera,
                 width: int = 960, height: int = 540,
                 particle_radius: float = 0.12,
                 background: Tuple[float, float, float] = (0.03, 0.04, 0.06),
                 max_footprint: int = 4,
                 mask: Optional[np.ndarray] = None,
                 return_depth: bool = False):
    """Render a ParticleState to an [H, W, 3] uint8 frame.

    ``return_depth=True`` additionally returns the [H, W] view-depth
    buffer (0 = background) for the DOF post pass — the reference's
    scene depth, available in impostor/mesh modes only
    (``Scene0p.cpp:2601-2603``)."""
    view = cam.view_matrix()
    proj = cam.proj_matrix(width / height)

    pos = np.asarray(state.pos, np.float32)
    vel = np.asarray(state.vel, np.float32)
    pressure = np.asarray(state.pressure, np.float32)
    density = np.asarray(state.density, np.float32)
    group = np.asarray(state.color_group)

    valid = np.asarray(state.valid) > 0
    ghost = np.asarray(state.ghost) > 0
    draw = valid & ~ghost            # ghosts discard (impostor frag main)
    if mask is not None:
        draw &= np.asarray(mask)

    px, py, vpos, ok = _project(pos, view, proj, width, height)
    draw &= ok
    draw &= (px > -8) & (px < width + 8) & (py > -8) & (py < height + 8)

    # per-particle colors on device (jitted palette pipeline)
    colors = np.asarray(_colors_device(
        pos, vpos.astype(np.float32), vel, pressure, density, group, vp))

    # background: color tuple, or a pre-rendered [H,W,3] uint8 frame
    # (e.g. the terrain heightfield pass, viz/terrain.py)
    if isinstance(background, np.ndarray):
        base = background.astype(np.float32) / 255.0
    else:
        base = np.broadcast_to(np.asarray(background, np.float32),
                               (height, width, 3))

    idx = np.nonzero(draw)[0]
    if len(idx) == 0:
        out = (np.clip(base, 0, 1) * 255).astype(np.uint8)
        if return_depth:
            return out, np.zeros((height, width), np.float32)
        return out

    # painter's sort: far first, near last (ascending -z_view descending)
    depth = -vpos[idx, 2]
    order = np.argsort(-depth, kind="stable")
    idx = idx[order]

    # perspective point size in pixels (particleImpostor.vert:38-40)
    size_px = (2.0 * particle_radius * proj[1, 1]
               / np.maximum(depth[order], 1e-6) * height * 0.5)
    rad_px = np.clip(size_px * 0.5, 0.5, float(max_footprint))

    cx = px[idx]
    cy = py[idx]
    col = colors[idx]

    img = base.copy().reshape(-1, 3)
    zbuf = np.zeros((height * width,), np.float32)
    pdepth = depth[order]

    r = int(max_footprint)
    sun_world = np.asarray(vp.sun_dir, np.float32)
    sun_world /= max(np.linalg.norm(sun_world), 1e-9)
    light = view[:3, :3] @ sun_world

    lib = _native_lib()
    if lib is not None:
        import ctypes
        buf = np.ascontiguousarray(img, np.float32)
        fp = np.ctypeslib.as_ctypes_type(np.float32)

        def ptr(a):
            return np.ascontiguousarray(a, np.float32).ctypes.data_as(
                ctypes.POINTER(fp))

        lib.splat_raster(
            ctypes.c_int(len(idx)), ptr(cx), ptr(cy),
            ptr(rad_px), ptr(col), ctypes.c_int(width),
            ctypes.c_int(height),
            buf.ctypes.data_as(ctypes.POINTER(fp)),
            ctypes.c_int(1 if vp.lit_sphere else 0),
            ptr(light), ptr(np.asarray(vp.sun_color, np.float32)),
            ctypes.c_int(r),
            ptr(pdepth) if return_depth else None,
            zbuf.ctypes.data_as(ctypes.POINTER(fp))
            if return_depth else None)
        img = buf.reshape(height, width, 3)
        out = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
        if return_depth:
            return out, zbuf.reshape(height, width)
        return out

    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            d = np.sqrt(dx * dx + dy * dy)
            sel = d <= rad_px
            if not sel.any():
                continue
            x = (cx[sel] + dx).astype(np.int32)
            y = (cy[sel] + dy).astype(np.int32)
            inb = (x >= 0) & (x < width) & (y >= 0) & (y < height)
            if not inb.any():
                continue
            c = col[sel][inb]
            if vp.lit_sphere:
                # fake-sphere disc shading per footprint offset
                nr = np.minimum(d / np.maximum(rad_px[sel][inb], 0.5), 0.97)
                nz = np.sqrt(np.maximum(1.0 - nr * nr, 0.0))
                nx = (dx / max(d, 1e-6)) * nr
                ny = (-dy / max(d, 1e-6)) * nr
                diff = np.maximum(
                    nx * light[0] + ny * light[1] + nz * light[2], 0.0)
                shade = (0.35 + 0.65 * diff)[:, None]
                c = np.clip(c * shade + np.asarray(vp.sun_color)
                            * (np.maximum(diff, 0.0) ** 24.0 * 0.4)[:, None],
                            0.0, 1.0)
            img[y[inb] * width + x[inb]] = c
            if return_depth:
                zbuf[y[inb] * width + x[inb]] = pdepth[sel][inb]
    img = img.reshape(height, width, 3)
    out = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    if return_depth:
        return out, zbuf.reshape(height, width)
    return out


def _native_lib():
    """Native painter-splat rasterizer (sph_tpu/native/splat_raster.cpp);
    None -> numpy fallback."""
    from sph_tpu import native
    return native.load("splat_raster")


def save_png(img: np.ndarray, path: str) -> None:
    """Write an [H, W, 3] uint8 RGB image as an 8-bit PNG (stdlib only)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    # filter type 0 (None) on every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # color type -> samples/pixel


def load_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced grey/RGB(A) PNG as [H, W, C] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) "
                         f"PNGs are supported")
    c = _PNG_CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            # Sub / Average / Paeth depend on the pixel to the left
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - c] if x >= c else 0
                b = prev[x]
                d = prev[x - c] if x >= c else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - d
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - d)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else d)
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, c)


def render_frame_mesh(state, vp: P.VizParams, cam: OrbitCamera,
                      width: int = 960, height: int = 540,
                      particle_radius: float = 0.12,
                      background=(0.03, 0.04, 0.06),
                      mesh_obj: Optional[str] = None,
                      max_instances: int = 262144,
                      return_depth: bool = False):
    """TRUE instanced-mesh render (reference render mode 2): one unit
    mesh per particle, translated + scaled (``defaultVert.glsl:30-35``,
    ``Mesh.cpp:20-54``), z-buffered via ``viz/raster.py``.

    ``mesh_obj``: path to a wavefront OBJ; default is the built-in
    icosphere (the reference's own meshes/Sphere.obj asset is absent
    from its repo).  Instances beyond ``max_instances`` are dropped
    far-first to bound headless render cost."""
    from sph_tpu.viz import raster as R

    view = cam.view_matrix()
    proj = cam.proj_matrix(width / height)
    pos = np.asarray(state.pos, np.float32)
    vel = np.asarray(state.vel, np.float32)
    pressure = np.asarray(state.pressure, np.float32)
    density = np.asarray(state.density, np.float32)
    group = np.asarray(state.color_group)

    draw = (np.asarray(state.valid) > 0) & (np.asarray(state.ghost) == 0)
    px, py, vpos, ok = _project(pos, view, proj, width, height)
    draw &= ok
    draw &= (px > -64) & (px < width + 64) & (py > -64) & (py < height + 64)
    colors = np.asarray(_colors_device(
        pos, vpos.astype(np.float32), vel, pressure, density, group, vp))

    if isinstance(background, np.ndarray):
        img = background.astype(np.float32).copy()
    else:
        img = np.broadcast_to(
            np.asarray(background, np.float32) * 255.0,
            (height, width, 3)).copy()
    zbuf = np.full((height, width), np.inf, np.float32)

    idx = np.nonzero(draw)[0]
    if len(idx) > max_instances:
        near = np.argsort(-vpos[idx, 2], kind="stable")[-max_instances:]
        idx = idx[near]
    if len(idx):
        mesh = R.load_obj(mesh_obj) if mesh_obj else None
        R.draw_mesh_instances(img, zbuf, pos[idx], particle_radius,
                              colors[idx], view, proj, mesh=mesh,
                              sun_dir=tuple(np.asarray(vp.sun_dir)))
    out = np.clip(img, 0.0, 255.0).astype(np.uint8)
    if return_depth:
        depth = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
        return out, depth
    return out
