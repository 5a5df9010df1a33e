"""The port's ray-axis renderers (``ttrt_torch.parallel.sharding``) in a 2x2
world of four spawned gloo ranks, against JAX's ``ttrt.parallel.sharding``
on the conftest's virtual CPU mesh and against the port's own
single-device frames; ``--mesh`` on the CLI (a one-rank world).

Tolerances:

- the eager integrator in float64: 1e-12 against JAX's sharded frame (the
  sample sums reassociate across devices; JAX's own sharded-vs-single test
  uses the same bar) and equal trace counts;
- the kernels' plain sharded renderers in float32 against the whole plain
  frame: ``SUM_BOUND`` = N * 2^-23. With two sample slices a band, the
  slice sums are added apart and then together, so the N-term sum
  reassociates; each order is within (N - 1) u * N of the exact sum (u =
  2^-24, samples <= 1), and the 1/N scaling adds at most u a value:
  |d| <= 2 (N - 1) u + 2 u = N * 2^-23. Trace counts are equal;
- the path tracer: the world's frame equals the combine of the same
  partials computed here, bit for bit, and JAX's sharded kernel (interpret
  mode, the same device seeds) within ``chip_smoke.PATHTRACE_BAR``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_ranks
from make_torch_golden import (jax_area_lights, jax_frame_seed, jax_scene,
                               scene_leaves)
from ttrt.assets import make_colors_skybox, skybox_from_faces
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.frames import orbit_camera_frame
from ttrt.parallel.sharding import (make_mesh, pathtrace_frame_sharded_pallas,
                                    render_frame_sharded)
from ttrt.scene import demo_scene as jax_demo_scene

from ttrt_torch import assets
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import mesh_fused, pathtrace, render
from ttrt_torch.mesh.scene import many_sphere_scene
from ttrt_torch.parallel import sharding
from ttrt_torch.parallel.mesh import parse_spec
from ttrt_torch.render import pathtrace as estimator
from ttrt_torch.render.pathtrace import AreaLights
from ttrt_torch.scene import scene_from_numpy
from ttrt_torch.term.encoder import ansi_buffer_size

torch.set_num_threads(1)  # the test workers share the cores

REPO = Path(__file__).resolve().parent.parent
W, H, N, B = 16, 8, 4, 3
T = 1.234
MANY = 300
SEED = jax_frame_seed(0, T)
SUM_BOUND = N * 2.0 ** -23


def _jax_f64_scene():
    sky = skybox_from_faces(make_colors_skybox(8), jnp.float64)
    return jax_demo_scene(sky, W, H, jnp.float64).with_camera_frame(
        orbit_camera_frame(T, jnp.float64))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' results of ``torch_ranks.sharding_world``."""
    tmp = tmp_path_factory.mktemp("world_2x2")
    leaves = {f"f64.{k}": v for k, v in scene_leaves(_jax_f64_scene()).items()}
    leaves.update({f"f32.{k}": v
                   for k, v in scene_leaves(jax_scene(T, W, H)).items()})
    np.savez(tmp / "inputs.npz", config=np.array([W, H, N, B]), **leaves)
    return torch_ranks.run_world(torch_ranks.sharding_world, 4, tmp, MANY,
                                 SEED)


def _f32():
    ts = scene_from_numpy(scene_leaves(jax_scene(T, W, H)), "colors",
                          device="cpu", dtype=torch.float32)
    return ts, RenderConfig(width=W, height=H, rays_per_pixel=N,
                            bounce_limit=B)


def test_ranks_hold_one_frame(world):
    """Every rank of the 2x2 mesh sits at its row-major coordinate and
    returns the same whole frames; ``make_sharded_frame_fn``'s is a whole
    ANSI frame."""
    assert [r["rank"] for r in world] == [0, 1, 2, 3]
    assert [tuple(r["coordinate"]) for r in world] == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    for key in ("eager", "kernel", "fused", "pathtrace", "estimator",
                "ansi"):
        for r in world[1:]:
            assert np.array_equal(r[key], world[0][key]), key
    buf = world[0]["ansi"]
    assert len(buf) == ansi_buffer_size(W, H)
    assert buf[:6] == b"\033[0;0H"
    assert world[0]["ansi_rays"] > 0


def test_eager_f64_matches_jax_render_frame_sharded(world):
    js = _jax_f64_scene()
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=N,
                           bounce_limit=B, dtype=jnp.float64)
    fb, rays = render_frame_sharded(js, jcfg,
                                    make_mesh(2, 2, devices=jax.devices()[:4]))
    want = np.asarray(fb.to_array())
    assert world[0]["eager"].shape == (H, W, 3)
    np.testing.assert_allclose(world[0]["eager"], want, rtol=0, atol=1e-12)
    assert world[0]["eager_rays"] == int(rays)


def test_demo_kernel_sharded_matches_whole_plain_frame(world):
    ts, cfg = _f32()
    fb, rays = render.render_frame_plain(ts, cfg)
    d = np.abs(world[0]["kernel"] - fb.to_array().numpy())
    assert d.max() <= SUM_BOUND, d.max()
    assert world[0]["kernel_rays"] == int(rays)


def test_fused_sharded_matches_whole_plain_frame(world):
    ts, cfg = _f32()
    many = many_sphere_scene(assets.load_skybox("colors", device="cpu"),
                             MANY, W, H, device="cpu").with_camera_frame(
                                 ts.camera.frame)
    fb, rays = mesh_fused.render_frame_mesh_fused_plain(many, cfg)
    out = world[0]["fused"]
    assert np.isfinite(out).all() and out.std() > 0
    d = np.abs(out - fb.to_array().numpy())
    assert d.max() <= SUM_BOUND, d.max()
    assert world[0]["fused_rays"] == int(rays)


def test_pathtrace_sharded_paths_combine_the_rank_streams(world):
    """Both sharded path tracers equal, bit for bit, the combine of four
    partials made here at spp/4 from the ranks' device seeds, in mesh
    order."""
    ts, cfg = _f32()
    lights = estimator.default_area_lights(cfg, "cpu")
    local = cfg.with_(rays_per_pixel=N // 4)
    kern, est = [], []
    for idx in range(4):
        seed = sharding.device_seed(SEED, idx)
        kern.append(pathtrace.pathtrace_frame_plain(
            ts, lights, local, seed, reduce="sum")[0])
        gen = torch.Generator().manual_seed(seed & 0xFFFFFFFF)
        est.append(estimator.pathtrace_frame(ts, lights, local, gen,
                                             reduce="sum"))
    for key, parts in (("pathtrace", kern), ("estimator", est)):
        want = sharding.combine_pathtrace(parts, cfg).to_array().numpy()
        np.testing.assert_array_equal(world[0][key], want, err_msg=key)
        assert world[0][key].min() >= 0.0 and world[0][key].max() <= 1.0


def test_pathtrace_kernel_sharded_meets_jax_sharded_kernel(world):
    """Against ``pathtrace_frame_sharded_pallas`` (interpret mode) on the
    2x2 virtual mesh: the same device seeds, so the same random streams,
    within PATHTRACE_BAR."""
    jl = jax_area_lights()
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=N,
                           bounce_limit=B, dtype=jnp.float32)
    fb = pathtrace_frame_sharded_pallas(
        jax_scene(T, W, H), jl, jcfg, SEED,
        make_mesh(2, 2, devices=jax.devices()[:4]), interpret=True)
    chip_smoke.pathtrace_bar(np.asarray(fb.to_array()),
                             world[0]["pathtrace"])
    assert AreaLights.from_numpy(scene_leaves(jl), dtype=torch.float32,
                                 device="cpu").count == 1


def test_indivisible_mesh_refused_in_one_line(world):
    assert world[0]["refusals"] == [
        f"height {H + 1} not divisible by mesh rows 2",
        f"rays_per_pixel {N + 1} not divisible by mesh samples 2"]


def test_parse_spec():
    """``--mesh`` specs against the world size, with JAX's messages."""
    for spec, n, shape in (("auto", 3, (3, 1)), ("2x3", 6, (2, 3)),
                           ("1x2x2", 4, (1, 2, 2))):
        assert parse_spec(spec, n) == shape
    for spec, n, match in (("2x", 4, "expects 'auto'"),
                           ("0x4", 4, "expects 'auto'"),
                           ("2x2x2x2", 16, "expects 'auto'"),
                           ("2x2", 2, "needs 4 devices but 2 are")):
        with pytest.raises(ConfigError, match=match):
            parse_spec(spec, n)


def _run(*args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "ttrt_torch", *args],
                          cwd=REPO, env=env, capture_output=True,
                          timeout=timeout)


@pytest.mark.parametrize("extra", [[], ["--pathtrace"]])
def test_cli_mesh_auto_on_one_rank(extra):
    w, h, frames = 16, 8, 2
    proc = _run("--device", "cpu", "--mesh", "auto", "--width", str(w),
                "--height", str(h), "--spp", "2", "--bounces", "3",
                "--frames", str(frames), "--no-input", *extra)
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, w, h, frames)


def test_cli_mesh_refusals_are_one_line():
    for args, match in (
            (["--mesh", "2x"], "--mesh expects 'auto'"),
            (["--mesh", "2x2"],
             "--mesh 2x2 needs 4 devices but 1 are available"),
            (["--mesh", "1x1x1", "--pathtrace"], "--pathtrace shards samples"),
            (["--mesh", "1x1x1"], "needs a cluster-packed many-object scene")):
        proc = _run("--device", "cpu", "--frames", "1", "--no-input",
                    "--width", "4", "--height", "4", *args)
        assert proc.returncode == 1, args
        lines = proc.stderr.decode().strip().splitlines()
        assert len(lines) == 1 and match in lines[0], lines
        assert proc.stdout == b""
