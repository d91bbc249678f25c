"""Infrastructure the main path stands on: the pytree dataclass, the
compile-cache location, float32-exact rotation products, engine
selection, the GPU-only guards, the overflow audit and the PNG codec."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sph_tpu.core import params as P
from sph_tpu.core.params import FluidParams, SimConfig
from sph_tpu.utils.pytree import pytree_dataclass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytree_dataclass
class _Pair:
    a: jax.Array
    b: jax.Array


def test_pytree_dataclass_flatten_unflatten():
    p = _Pair(a=jnp.ones(3), b=jnp.zeros(()))
    leaves, tree = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    q = jax.tree_util.tree_unflatten(tree, [x + 1 for x in leaves])
    assert isinstance(q, _Pair)
    np.testing.assert_array_equal(q.a, 2 * np.ones(3))
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(p)[0]]
    assert paths == [".a", ".b"]


def test_pytree_dataclass_replace_is_a_frozen_copy():
    p = _Pair(a=jnp.ones(2), b=jnp.zeros(()))
    q = p.replace(b=jnp.ones(()))
    assert float(q.b) == 1.0 and float(p.b) == 0.0
    with pytest.raises(AttributeError):
        p.a = jnp.zeros(2)
    with pytest.raises(TypeError):
        p.replace(c=1)


def test_pytree_dataclass_as_jit_argument():
    params = FluidParams.default()
    out = jax.jit(lambda prm: prm.replace(h=prm.h * 2))(params)
    assert isinstance(out, FluidParams)
    assert float(out.h) == pytest.approx(0.56)
    assert float(out.mass) == pytest.approx(float(params.mass))


def test_compile_cache_dir_env_unset(monkeypatch):
    from sph_tpu.utils import cache
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    from sph_tpu.utils import cache
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env


def _rot_state(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-16.0, 16.0, (n, 3)).astype(np.float32)
    return pos


def test_rotation_matrix_and_rows_times_match_float64():
    euler = np.array([20.0, 0.0, 30.0], np.float32)
    r64 = P.rotation_matrix_np(euler).astype(np.float64)
    r32 = np.asarray(P.rotation_matrix(jnp.asarray(euler)))
    np.testing.assert_allclose(r32, r64, atol=2e-7)
    pos = _rot_state()
    got = np.asarray(P.rows_times(jnp.asarray(pos), jnp.asarray(r32)))
    want = pos.astype(np.float64) @ r64
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_grid_cell_coords_match_float64_binning():
    half = np.array([15.0, 15.0, 15.0], np.float32)
    euler = np.array([20.0, 0.0, 30.0], np.float32)
    params = FluidParams.default(box_half=half, box_euler_deg=euler)
    dims = P.compute_grid_dims(P.SHAPE_BOX, half, euler, 0.28)
    pos = _rot_state(seed=1) * 0.9
    got = np.asarray(P.grid_cell_coords(jnp.asarray(pos), params, dims))
    local = pos.astype(np.float64) @ P.rotation_matrix_np(euler).astype(
        np.float64)
    exact = (local + (half + 0.28)) / 0.28
    want = np.clip(np.floor(exact), 0, np.asarray(dims) - 1)
    # float32 may only disagree for points within rounding of a cell face
    near_face = np.abs(exact - np.round(exact)) < 1e-4
    assert np.all((got == want) | near_face)
    assert (got != want).mean() < 1e-3


def test_rotated_container_projection_matches_float64():
    from sph_tpu.core.state import ParticleState
    from sph_tpu.physics import constraints
    half = np.array([15.0, 15.0, 15.0], np.float32)
    euler = np.array([20.0, 0.0, 30.0], np.float32)
    params = FluidParams.default(box_half=half, box_euler_deg=euler)
    pos = _rot_state(seed=2)
    st = ParticleState.zeros(pos.shape[0]).replace(
        pos=jnp.asarray(pos), valid=jnp.ones(pos.shape[0], jnp.int32))
    out = np.asarray(constraints.apply_container(st, params).pos, np.float64)
    r = P.rotation_matrix_np(euler).astype(np.float64)
    want = np.clip(pos.astype(np.float64) @ r, -half, half) @ r.T
    np.testing.assert_allclose(out, want, atol=2e-5)


def test_removed_pallas_engine_raises():
    with pytest.raises(ValueError, match="pallas"):
        SimConfig(n=256, grid_dims=(8, 8, 8), neighbor_impl="pallas")
    for impl in P.NEIGHBOR_IMPLS:
        SimConfig(n=256, grid_dims=(8, 8, 8), neighbor_impl=impl)


def test_chip_smoke_refuses_cpu_backend(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(SystemExit, match="no GPU"):
        mod.main()


def test_bench_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "bench.py", "dam_break_8k", "2"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no GPU" in proc.stderr


def _small_run(cap: int):
    from sph_tpu.core.state import spawn_standard, state_from_spawn
    from sph_tpu.engine.step import SceneBuffers, run_substeps
    half = (3.0, 3.0, 3.0)
    state = state_from_spawn(spawn_standard(1024, box_half=half, seed=1))
    params = FluidParams.default(box_half=half).derive_mass()
    dims = P.compute_grid_dims(0, np.asarray(half), np.zeros(3), 0.28)
    sim = SimConfig(n=state.n, grid_dims=dims, neighbor_impl="cell",
                    cell_capacity=cap)
    return run_substeps(state, params, SceneBuffers.create(sim),
                        params.dt, 3, sim)[1]


def test_overflow_audit_passes_exact_run():
    from sph_tpu.engine.step import require_exact
    buffers = _small_run(8)
    assert int(buffers.overflow) == 0
    require_exact(buffers, "cap 8")


def test_overflow_audit_raises_on_overflow():
    from sph_tpu.engine.step import require_exact
    buffers = _small_run(1)
    assert int(buffers.overflow) > 0
    with pytest.raises(RuntimeError, match="overflowed cell_capacity"):
        require_exact(buffers, "cap 1")


def test_png_round_trip(tmp_path):
    from sph_tpu.viz.splat import load_png, save_png
    img = np.random.default_rng(0).integers(0, 256, (17, 23, 3), np.uint8)
    path = str(tmp_path / "x.png")
    save_png(img, path)
    np.testing.assert_array_equal(load_png(path), img)


def test_png_reader_undoes_every_filter(tmp_path):
    """Scanlines written with the Sub, Up, Average and Paeth filters (as
    other encoders do) decode to the original pixels."""
    import struct
    import zlib
    from sph_tpu.viz.splat import load_png
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 7, 4), np.uint8)
    c, rows = 4, img.reshape(5, 28).astype(np.int32)
    raw = b""
    prev = np.zeros(28, np.int32)
    for y, ftype in enumerate([1, 2, 3, 4, 0]):
        line = rows[y]
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 0:
            pred = np.zeros(28, np.int32)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([ftype]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = line

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path = tmp_path / "f.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 6,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw))
                     + chunk(b"IEND", b""))
    np.testing.assert_array_equal(load_png(str(path)), img)
