"""The port's modules against their JAX counterparts, on the same
numpy-made inputs (ttrt_torch vs ttrt, on the CPU).

Tolerances: exact where both sides run the same float operations in the
same order (vector math in f64 and f32, scene leaves, packing, generators,
encoders); 1e-12 (f64) and 1e-6 (f32) for the camera pose, whose 3x3
products the port writes elementwise while JAX runs a matmul that may sum
in another order, and whose cos/sin come from two libraries.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttrt.assets as jassets
import ttrt.frames as jframes
import ttrt.vec as jvec
from ttrt.kernels import render_pallas
from ttrt.render import skybox as jskybox
from ttrt.scene import demo_scene as jax_demo_scene
from ttrt.term import encoder as jencoder
from ttrt.vec import Vec3 as JVec3

from make_torch_golden import jax_scene, scene_leaves
from ttrt_torch import assets, frames, vec
from ttrt_torch.kernels import render
from ttrt_torch.render import skybox
from ttrt_torch.scene import demo_scene, scene_from_numpy
from ttrt_torch.term import encoder

torch.set_num_threads(1)  # the test workers share the cores

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_normalize_guard_exact_f64():
    rng = np.random.default_rng(11)
    v = rng.normal(size=(3, 4096))
    v[:, :512] *= 1e-5  # below the 1e-4 guard: normalize is the identity
    v[:, 512:520] = 0.0
    want = JVec3(*(jnp.asarray(c) for c in v)).normalize()
    got = vec.Vec3(*(_t(c) for c in v)).normalize()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the guard: below 1e-4 the vector comes back bit for bit
    for c in range(3):
        np.testing.assert_array_equal(got[c][:520].numpy(), v[c, :520])


def test_normalize_exact_f32():
    rng = np.random.default_rng(18)
    v = rng.normal(size=(3, 4096)).astype(np.float32)
    v[:, :256] *= np.float32(1e-5)
    want = JVec3(*(jnp.asarray(c) for c in v)).normalize()
    got = vec.Vec3(*(torch.from_numpy(c) for c in v)).normalize()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sqrt_rn_is_correctly_rounded(dtype):
    """vec.sqrt_rn against numpy's IEEE sqrt, zero included, whatever
    PyTorch's own sqrt returns."""
    x = np.random.default_rng(19).uniform(0, 1e4, 100000)
    x[:16] = 0.0
    x = x.astype(np.float32 if dtype == torch.float32 else np.float64)
    np.testing.assert_array_equal(vec.sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_triangle_wave_exact_f64():
    t = np.concatenate([np.linspace(0.0, 40.0, 4001),
                        np.random.default_rng(12).uniform(0, 1e3, 2000)])
    np.testing.assert_array_equal(
        vec.triangle_wave(_t(t)).numpy(), np.asarray(jvec.triangle_wave(jnp.asarray(t))))


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float64, jnp.float64, 1e-12),
    (torch.float32, jnp.float32, 1e-6),
])
@pytest.mark.parametrize("t", [0.0, 0.7, 3.3, 57.25])
def test_orbit_camera_frame_matches_jax(dtype, jdtype, tol, t):
    want = jframes.orbit_camera_frame(t, jdtype)
    got = frames.orbit_camera_frame(t, dtype=dtype, device=CPU)
    assert got.basis.dtype == dtype
    np.testing.assert_allclose(got.basis.numpy(), np.asarray(want.basis),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(got.origin.numpy(), np.asarray(want.origin),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_rotate_basis_matches_jax_f64(axis):
    rng = np.random.default_rng(13)
    basis = rng.normal(size=(3, 3))
    want = getattr(jframes, f"rotate_basis_{axis}")(jnp.asarray(basis), 0.83)
    got = getattr(frames, f"rotate_basis_{axis}")(_t(basis), 0.83)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def _assert_leaves_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_demo_scene_leaves_equal_jax():
    jsky = jassets.skybox_from_faces(jassets.make_colors_skybox(8),
                                     jnp.float32, procedural="colors")
    tsky = assets.skybox_from_faces(assets.make_colors_skybox(8), device=CPU,
                                    procedural="colors")
    want = scene_leaves(jax_demo_scene(jsky, 40, 24, jnp.float32))
    got = scene_leaves(demo_scene(tsky, 40, 24, dtype=torch.float32,
                                  device=CPU))
    _assert_leaves_equal(got, want)


def test_scene_from_numpy_equals_demo_scene():
    jscene = jax_demo_scene(
        jassets.skybox_from_faces(jassets.make_colors_skybox(8),
                                  jnp.float32), 64, 32, jnp.float32)
    carried = scene_from_numpy(scene_leaves(jscene), "colors", device=CPU,
                               dtype=torch.float32)
    own = demo_scene(assets.skybox_from_faces(assets.make_colors_skybox(8),
                                              device=CPU, procedural="colors"),
                     64, 32, dtype=torch.float32, device=CPU)
    _assert_leaves_equal(scene_leaves(carried), scene_leaves(own))
    assert carried.skybox.procedural == "colors"


@pytest.mark.parametrize("name", ["colors", "uv_checker", "starfield"])
@pytest.mark.parametrize("dim", [16, 64])
def test_procedural_generators_byte_equal(name, dim):
    want = jassets.PROCEDURAL_SKYBOXES[name](dim)
    got = assets.PROCEDURAL_SKYBOXES[name](dim)
    assert got.dtype == np.uint8 and got.shape == (6, dim, dim, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,tag", [("colors", "colors"),
                                      ("uv_checker", "uv_checker"),
                                      ("milky_way", None)])
def test_load_skybox_matches_jax(name, tag):
    want = jassets.load_skybox(name)
    got = assets.load_skybox(name, device=CPU)
    assert got.procedural == want.procedural == tag
    np.testing.assert_array_equal(got.packed.numpy(),
                                  np.asarray(want.packed).astype(np.int64))


def test_load_skybox_unknown_name_raises():
    with pytest.raises(assets.AssetError):
        assets.load_skybox("no_such_sky", device=CPU)


def test_ppm_round_trip(tmp_path):
    img = np.random.default_rng(14).integers(0, 256, (7, 11, 3), np.uint8)
    path = tmp_path / "img.ppm"
    assets.write_ppm(str(path), img)
    np.testing.assert_array_equal(assets.read_ppm(str(path)), img)
    np.testing.assert_array_equal(jassets.read_ppm(str(path)), img)
    # '#' comments anywhere in the header
    data = b"P6\n# made by hand\n11 # width\n7\n255\n" + img.tobytes()
    np.testing.assert_array_equal(assets.read_ppm(data), img)


@pytest.mark.parametrize("data", [
    b"P5\n2 2\n255\n" + bytes(4),  # not P6
    b"P6\n2 2\n65535\n" + bytes(24),  # maxval must be 255
    b"P6\n2 2\n255\n" + bytes(5),  # truncated pixels
    b"P6\n2",  # EOF in the header
    b"P6\nx 2\n255\n" + bytes(12),  # malformed number
])
def test_ppm_bad_header_raises_asset_error(data):
    with pytest.raises(assets.AssetError):
        assets.read_ppm(data)


def test_skybox_tables_equal_jax():
    np.testing.assert_array_equal(skybox.CUBEMAP_AXES, jskybox.CUBEMAP_AXES)
    np.testing.assert_array_equal(skybox.U_AXIS, jskybox.U_AXIS)
    np.testing.assert_array_equal(skybox.V_AXIS, jskybox.V_AXIS)


def _cu_table(name: str) -> np.ndarray:
    src = (REPO / "ttrt_torch/kernels/csrc/common.cuh").read_text()
    m = re.search(name + r"\[6\]\[3\] = \{(.*?)\};", src, re.S)
    return np.array([float(v) for v in re.findall(r"-?\d+\.\d+", m.group(1))]
                    ).reshape(6, 3)


@pytest.mark.parametrize("name,table", [
    ("CUBEMAP_AXES", skybox.CUBEMAP_AXES),
    ("U_AXIS", skybox.U_AXIS),
    ("V_AXIS", skybox.V_AXIS),
    ("FACE_COLORS", np.array(render._FACE_COLORS01)),
])
def test_kernel_source_tables_match(name, table):
    """The CUDA kernels hold the cubemap tables as literals."""
    np.testing.assert_array_equal(_cu_table(name), table)


@pytest.mark.parametrize("name", ["colors", "uv_checker"])
@pytest.mark.parametrize("dim", [16, 256])
def test_procedural_sky_equals_generator_texels(name, dim):
    """The render kernel's in-kernel sky replays the generator's float32
    arithmetic: at the same (face, ui, vi) it equals texel/255 exactly."""
    rng = np.random.default_rng(15)
    d = [torch.from_numpy(c) for c in rng.normal(size=(3, 8192)).astype(np.float32)]
    face, ui, vi = render._sky_face_uv(*d, dim)
    got = render._procedural_texel(face, ui, vi, dim, name)
    texels = assets.PROCEDURAL_SKYBOXES[name](dim)[face.numpy(), vi.numpy(),
                                                   ui.numpy()]
    want = texels.astype(np.float32) / np.float32(255)
    for ch in range(3):
        np.testing.assert_array_equal(got[ch].numpy(), want[:, ch])


@pytest.mark.parametrize("offsets", [(0.0, 0.0), (3.0, 5.0)])
def test_pack_scene_equals_jax_exact(offsets):
    js = jax_scene(1.3)
    want = render_pallas.pack_scene(js, jnp.float32, *offsets)
    ts = scene_from_numpy(scene_leaves(js), "colors", device=CPU,
                          dtype=torch.float32)
    got = render.pack_scene(ts, torch.float32, *offsets)
    for field, w, g in zip(got._fields, want, got):
        assert g.dtype == torch.float32, field
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)


def _seeded_frames():
    rng = np.random.default_rng(16)
    for h, w in [(1, 1), (3, 5), (17, 31)]:
        yield rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("rgb", list(_seeded_frames()),
                         ids=lambda a: "x".join(map(str, a.shape[:2])))
def test_encode_ansi_frame_byte_equal_jax(rgb):
    # float channels that truncate back to the seeded bytes
    f = (rgb.astype(np.float32) + np.float32(0.5)) / np.float32(255)
    fb = vec.Vec3(*(torch.from_numpy(f[..., c].copy()) for c in range(3)))
    want = jencoder.encode_ansi_host(rgb)
    got = encoder.encode_ansi_frame(fb).numpy().tobytes()
    assert got == want
    jfb = JVec3(*(jnp.asarray(f[..., c]) for c in range(3)))
    assert got == np.asarray(jencoder.encode_ansi_frame(jfb)).tobytes()
    assert len(got) == encoder.ansi_buffer_size(rgb.shape[1], rgb.shape[0])
    template = encoder.ansi_template(rgb.shape[1], rgb.shape[0], CPU)
    assert encoder.encode_ansi_frame(fb, template).numpy().tobytes() == want
    assert encoder.encode_ansi_host(rgb) == want
    np.testing.assert_array_equal(encoder.encode_rgb_frame(fb).numpy(), rgb)
    np.testing.assert_array_equal(
        encoder.encode_rgb_frame(fb).numpy(),
        np.asarray(jencoder.encode_rgb_frame(jfb)))


def test_quantize_channel_truncates_like_jax():
    c = np.random.default_rng(17).uniform(0, 1, 4096).astype(np.float32)
    np.testing.assert_array_equal(
        encoder.quantize_channel(torch.from_numpy(c)).numpy(),
        np.asarray(jencoder.quantize_channel(jnp.asarray(c))))
