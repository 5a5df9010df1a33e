"""The port's JSON scene files (``ttrt_torch.scenefile``), the skybox
preview, and the banded still (``render.integrator.render_frame_tiled``)
against the JAX package on the CPU.

``scene_from_dict`` builds JAX's scene leaf for leaf and bit for bit, in
float32 and float64, defaults and the black stand-in lights included. A
JSON scene (chip_smoke.SCENE_FILE) rendered by the render kernel's plain
version meets the knife bar against JAX ``render_frame``. The banded frame
meets tests/test_tiled.py's bar against the whole frame, and equals eager
JAX's banded frame bit for bit.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from knife_util import assert_quantized_exact_off_knife
from make_torch_golden import SKY_DIM, scene_leaves
from ttrt.assets import make_colors_skybox, skybox_from_faces
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.frames import orbit_camera_frame as jax_orbit
from ttrt.render.integrator import render_frame as jax_render_frame
from ttrt.render.integrator import render_frame_tiled as jax_tiled
from ttrt.scene import demo_scene as jax_demo_scene
from ttrt.scenefile import scene_from_dict as jax_scene_from_dict

from ttrt_torch.config import RenderConfig
from ttrt_torch.frames import Frame
from ttrt_torch.kernels import render
from ttrt_torch.render import integrator
from ttrt_torch.scene import scene_from_numpy
from ttrt_torch.scenefile import (SceneFileError, load_scene_file,
                                  scene_from_dict)

torch.set_num_threads(1)  # the test workers share the cores

REPO = Path(__file__).resolve().parent.parent

# defaults everywhere; no directional light (the black stand-in), the
# default point light
MINIMAL = {"spheres": [{"center": [0.1, 0.2, 0.3]},
                       {"center": [1.5, 0, 0], "radius": 0.3}],
           "directional_lights": []}


def _run(*args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "ttrt_torch", *args],
                          cwd=REPO, env=env, capture_output=True,
                          timeout=timeout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scene_from_dict_leaves_bit_for_bit(dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    for desc in (chip_smoke.SCENE_FILE, MINIMAL,
                 {**MINIMAL, "skybox": "uv_checker",
                  "ground": {"y": -1.1, "reflectivity": 0.35}}):
        want = scene_leaves(jax_scene_from_dict(desc, 24, 12, jd))
        scene = scene_from_dict(desc, 24, 12, dtype=dtype, device="cpu")
        got = scene_leaves(scene)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            g = got[key]
            if key == "skybox.packed":  # JAX packs uint32, the port int32
                w, g = w.astype(np.int64), g.astype(np.int64)
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        assert scene.skybox.procedural == desc.get("skybox", "colors")
    stand_in = scene_from_dict(chip_smoke.SCENE_FILE, 8, 4, dtype=dtype,
                               device="cpu").point_lights
    assert stand_in.count == 1 and float(stand_in.intensity[0]) == 0.0


def test_bad_scene_rejected(tmp_path):
    with pytest.raises(SceneFileError):
        scene_from_dict({"spheres": []}, 8, 8, device="cpu")
    with pytest.raises(SceneFileError):
        scene_from_dict({"spheres": [{"center": [1, 2]}]}, 8, 8,
                        device="cpu")
    with pytest.raises(SceneFileError):
        scene_from_dict({"spheres": [{"center": [0, 0, 0]}],
                         "point_lights": [{"color": [1, 1, 1]}]}, 8, 8,
                        device="cpu")
    p = tmp_path / "bad.json"
    p.write_text("not json {")
    with pytest.raises(SceneFileError):
        load_scene_file(str(p), 8, 8, device="cpu")
    p.write_text("[1, 2]")
    with pytest.raises(SceneFileError, match="JSON object"):
        load_scene_file(str(p), 8, 8, device="cpu")
    with pytest.raises(SceneFileError, match="cannot read"):
        load_scene_file(str(tmp_path / "missing.json"), 8, 8, device="cpu")


def test_json_scene_plain_render_meets_knife_bar():
    W, H = 32, 16
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=2,
                           bounce_limit=10, dtype=jnp.float32)
    tcfg = RenderConfig(width=W, height=H, rays_per_pixel=2, bounce_limit=10)
    frame = jax.tree.map(lambda a: a.astype(jnp.float32),
                         jax_orbit(2.1, jnp.float32))
    js = jax_scene_from_dict(chip_smoke.SCENE_FILE, W, H,
                             jnp.float32).with_camera_frame(frame)
    ts = scene_from_dict(chip_smoke.SCENE_FILE, W, H, device="cpu")
    ts = ts.with_camera_frame(Frame(torch.as_tensor(np.array(frame.basis)),
                                    torch.as_tensor(np.array(frame.origin))))
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    before = render.render_frame_plain.launches
    fb, rays = render.render_frame(ts, tcfg)
    assert render.render_frame_plain.launches == before + 1
    out = fb.to_array().numpy()
    assert np.isfinite(out).all() and out.shape == (H, W, 3)
    assert_quantized_exact_off_knife(np.asarray(fb_ref.to_array()), out, js,
                                     jcfg, 0.20, rays_ref=rays_ref,
                                     rays_pal=int(rays))


def _scene_file(tmp_path) -> str:
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(chip_smoke.SCENE_FILE))
    return str(path)


def test_cli_scene_file_still_png(tmp_path):
    from PIL import Image

    out = tmp_path / "out.png"
    proc = _run("--device", "cpu", "--no-input", "--scene-file",
                _scene_file(tmp_path), "--still", str(out), "--width", "24",
                "--height", "12", "--spp", "1")
    assert proc.returncode == 0, proc.stderr.decode()
    with Image.open(out) as im:
        assert im.size == (24, 12)
        assert np.asarray(im).std() > 0


def test_cli_scene_file_stream(tmp_path):
    proc = _run("--device", "cpu", "--no-input", "--scene-file",
                _scene_file(tmp_path), "--frames", "2", "--width", "16",
                "--height", "8", "--spp", "2", "--bounces", "3")
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, 16, 8, 2)


def test_cli_show_skybox():
    proc = _run("--device", "cpu", "--no-input", "--show-skybox", "colors",
                "--width", "30")
    assert proc.returncode == 0, proc.stderr.decode()
    # a contact sheet of solid faces: truecolor cells present
    cells = re.findall(rb"\x1b\[48;2;(\d+);(\d+);(\d+)m  ", proc.stdout)
    assert len(cells) > 30
    assert len(set(cells)) == 6  # one color a face of 'colors'


def _tiled_setup(w=32, h=16, spp=2):
    """tests/test_tiled.py's frame in both packages."""
    jcfg = JaxRenderConfig(width=w, height=h, rays_per_pixel=spp,
                           bounce_limit=6, dtype=jnp.float32)
    tcfg = RenderConfig(width=w, height=h, rays_per_pixel=spp,
                        bounce_limit=6)
    js = jax_demo_scene(skybox_from_faces(make_colors_skybox(SKY_DIM),
                                          jnp.float32, procedural="colors"),
                        w, h, jnp.float32)
    frame = jax.tree.map(lambda a: a.astype(jnp.float32),
                         jax_orbit(1.2, jnp.float32))
    js = js.with_camera_frame(frame)
    ts = scene_from_numpy(scene_leaves(js), "colors", device="cpu",
                          dtype=torch.float32)
    return js, jcfg, ts, tcfg


def _tiled_bar(ref, til, rays, rays_t):
    """tests/test_tiled.py's bar: near-total agreement, rare bounded
    flips."""
    diff = np.abs(ref - til).max(axis=-1)
    assert float((diff > 1e-3).mean()) <= 0.03
    assert float(np.median(diff)) <= 2e-6
    assert abs(int(rays) - int(rays_t)) <= max(0.01 * int(rays), 32)


@pytest.mark.parametrize("n_bands", [2, 4, 8])
def test_tiled_matches_whole_frame_and_jax(n_bands):
    js, jcfg, ts, tcfg = _tiled_setup()
    fb, rays = integrator.render_frame(ts, tcfg, count_rays=True)
    fbt, rays_t = integrator.render_frame_tiled(ts, tcfg, n_bands,
                                                count_rays=True)
    til = fbt.to_array().numpy()
    assert til.shape == (16, 32, 3) and til.dtype == np.float32
    _tiled_bar(fb.to_array().numpy(), til, rays, rays_t)
    # eager JAX's banded frame bit for bit (compiled, XLA:CPU contracts
    # products into fused multiply-adds that the eager integrator does not)
    with jax.disable_jit():
        jfb, jrays = jax_tiled(js, jcfg, n_bands, count_rays=True)
    np.testing.assert_array_equal(til, np.asarray(jfb.to_array()))
    assert int(rays_t) == int(jrays)


def test_tiled_rejects_bad_band_count():
    _, _, ts, tcfg = _tiled_setup(h=10)
    with pytest.raises(ValueError, match="not divisible"):
        integrator.render_frame_tiled(ts, tcfg, 4)
