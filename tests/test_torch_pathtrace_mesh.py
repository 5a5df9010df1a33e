"""The many-object path tracer on the CPU: ``pathtrace_frame`` on a
``MeshScene`` (the plain version of ``csrc/mesh.cu::pathtrace_mesh_kernel``)
against the benchmark's frozen reference, the demo scene through the
widened plain version unchanged, the rows of a frame, the kernel's gates,
``--pathtrace``'s routes for a ``MeshScene`` and their count, and the CLI.
"""

import hashlib
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_app import _run

from ttrt_torch import app, assets, routes
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels import pathtrace
from ttrt_torch.mesh.scene import many_sphere_scene
from ttrt_torch.render import pathtrace as estimator
from ttrt_torch.scene import Skybox
from ttrt_torch.term.encoder import encode_rgb_frame
from ttrt_torch.utils.profiling import PATH_STEPS

torch.set_num_threads(1)  # the test workers share the cores

F32 = torch.float32
CELL = "many10k_pt.orbit"


def _many(cfg, n_spheres: int, t: float, seed: int = 0):
    scene = many_sphere_scene(assets.load_skybox("colors", device="cpu"),
                              n_spheres, cfg.width, cfg.height, seed=seed,
                              dtype=F32, device="cpu")
    return scene.with_camera_frame(
        orbit_camera_frame(t, dtype=F32, device="cpu"))


@pytest.mark.parametrize("seed,t", [(0, 0.7), (2**31 + 17, 42.123)])
def test_plain_route_agrees_with_the_frozen_reference(seed, t):
    """200 spheres drawn from seed 0 over the floor, 48x28, 2 spp, 4
    bounces: the port's CPU route against the benchmark's reference, both
    quantized as C's (int)(c * 255), under the cell's own limits, and the
    work (nearest-hit traces, hits, unblocked shadow rays) within 1%. Both
    round every step alike and read equal here; the tolerance is the
    cell's, not zero, because the reference is a separate program whose
    own order of operations (its dense tester against the walk's plain
    version, each torch op on the live paths only) may move a path at a
    knife edge (a roulette draw, a shadow ray grazing a sphere), and one
    moved path of 2 moves its pixel by tens of levels."""
    from benchmark import cells, harness
    from benchmark.reference import many_pathtrace, sky_colors

    cell = cells.load_cell(CELL)
    config = {**cell["config"], "width": 48, "height": 28, "spp": 2,
              "bounces": 4, "n_spheres": 200}
    cfg = RenderConfig(width=48, height=28, rays_per_pixel=2,
                       bounce_limit=4)
    scene = _many(cfg, 200, t)
    lights = estimator.default_area_lights(cfg, "cpu")
    fb, work = pathtrace.pathtrace_frame(scene, lights, cfg,
                                         pathtrace.frame_seed(seed, t))
    ref = many_pathtrace.build(config, dtype=F32, device="cpu")
    want, ref_work = many_pathtrace.render(
        ref, sky_colors.build(config, device="cpu"), config, t, seed,
        dtype=F32, device="cpu")
    nums = harness.frame_numbers(encode_rgb_frame(fb).numpy(), want.numpy())
    limits = cell["workload"]["check"]["limits"]
    assert all(nums[n] <= limits[n] for n in harness.LIMITED), nums
    assert np.allclose(work.numpy(), ref_work, rtol=0.01), (work, ref_work)


def test_demo_scene_through_the_widened_plain_version_is_unchanged():
    """The demo scene's frames and work equal the plain version's before
    it took a MeshScene, bit for bit: the SHA-256 of each frame's float32
    bytes as that version computed them (16x8, 2 spp, 5 bounces, both
    reduce modes, two frame seeds)."""
    cfg = RenderConfig(width=16, height=8, rays_per_pixel=2, bounce_limit=5)
    scene = app.make_scene("demo", cfg, "colors", device="cpu")
    lights = estimator.default_area_lights(cfg, "cpu")
    want = {(0.7, 0, "mean"): ("cdee55f474ec9943", [426, 170, 110]),
            (0.7, 0, "sum"): ("3925a23ed72d65d4", [426, 170, 110]),
            (3.3, 2**31 + 17, "mean"): ("500cfdf431884f8e", [516, 261, 213]),
            (3.3, 2**31 + 17, "sum"): ("966ca7be4109b86a", [516, 261, 213])}
    for (t, seed, reduce), (digest, work) in want.items():
        s = scene.with_camera_frame(
            orbit_camera_frame(t, dtype=F32, device="cpu"))
        fb, w = pathtrace.pathtrace_frame(
            s, lights, cfg, pathtrace.frame_seed(seed, t), reduce=reduce)
        got = hashlib.sha256(
            fb.to_array().contiguous().numpy().tobytes()).hexdigest()[:16]
        assert (got, w.tolist()) == (digest, work), (t, seed, reduce)


@pytest.mark.parametrize("kind", ["demo", "many"])
def test_rows_are_the_whole_frame_rows(kind):
    """``rows`` renders those rows of the frame, each path with its ray
    index in the whole frame: bit for bit the whole frame's rows."""
    cfg = RenderConfig(width=20, height=9, rays_per_pixel=3, bounce_limit=4)
    scene = (_many(cfg, 120, 1.5) if kind == "many" else
             app.make_scene("demo", cfg, "colors", device="cpu"))
    lights = estimator.default_area_lights(cfg, "cpu")
    seed = pathtrace.frame_seed(5, 1.5)
    whole, _ = pathtrace.pathtrace_frame_plain(scene, lights, cfg, seed)
    rows = [8, 0, 4]
    part, work = pathtrace.pathtrace_frame_plain(scene, lights, cfg, seed,
                                                 rows=rows)
    assert np.array_equal(part.to_array().numpy(),
                          whole.to_array().numpy()[rows])
    assert int(work[0]) >= len(rows) * cfg.width * cfg.rays_per_pixel


def test_kernel_gates_on_a_mesh_scene():
    """A float32 MeshScene with its pack under a procedural sky is taken;
    float64, an image sky, no pack and more than 10 bounces are refused
    with the gates' messages."""
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    many = _many(cfg, 30, 0.0)
    lights = estimator.default_area_lights(cfg, "cpu")
    pathtrace.check_supported(many, lights, cfg)
    image_sky = many._replace(skybox=Skybox(many.skybox.packed, None))
    for scene, c, match in [
            (many, cfg.with_(dtype=torch.float64), "float32"),
            (image_sky, cfg, "procedural sky"),
            (many._replace(clusters=None), cfg, "cluster pack"),
            (many, cfg.with_(bounce_limit=11), "bounce_limit <= 10")]:
        with pytest.raises(ConfigError, match=match):
            pathtrace.pathtrace_frame(scene, lights, c, 0)


def test_pick_pathtracer_routes_a_mesh_scene():
    """auto and kernel: the kernel for a float32 MeshScene; the estimator
    for float64, an image sky, eager and a --mesh, where kernel is
    refused in one line."""
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    many = app.make_scene("many", cfg, "colors", device="cpu", n_spheres=40)
    lights = estimator.default_area_lights(cfg, "cpu")

    def pick(scene, lights, cfg, renderer="auto", mesh=None):
        """Whether the path-traced route is the kernel's."""
        return routes.pick(scene, cfg, renderer, mesh=mesh, pathtrace=True,
                           lights=lights).name == "pathtrace kernel"

    assert pick(many, lights, cfg) and pick(many, lights, cfg, "kernel")
    assert not pick(many, lights, cfg.with_(dtype=torch.float64))
    image_sky = many._replace(skybox=Skybox(many.skybox.packed, None))
    assert not pick(image_sky, lights, cfg)
    assert not pick(many, lights, cfg, "eager")
    # a device mesh as the route reads one: its axes and its size
    mesh = SimpleNamespace(mesh_dim_names=("rows", "samples"),
                           mesh=torch.zeros(1, 1), size=lambda: 1)
    assert not pick(many, lights, cfg, "auto", mesh)
    with pytest.raises(ConfigError, match="--renderer eager"):
        pick(many, lights, cfg, "kernel", mesh)
    demo = app.make_scene("demo", cfg, "colors", device="cpu")
    assert pick(demo, lights, cfg, "auto", mesh)


def test_path_steps_count_each_route():
    """``profiling.PATH_STEPS`` counts the loop's path-traced steps by
    route: the kernel's (its plain version here) on auto, the
    estimator's on eager; a new loop starts it anew."""
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2,
                       frame_rate=1e9)
    many = app.make_scene("many", cfg, "colors", device="cpu", n_spheres=40)
    for renderer, want in [("auto", (3, 0)), ("eager", (0, 3))]:
        before = pathtrace.pathtrace_frame_plain.launches
        app.run_animation(cfg, "colors", max_frames=3, interactive=False,
                          scene=many, stream=io.BytesIO(),
                          renderer=renderer, pathtrace=True)
        assert (PATH_STEPS.kernel, PATH_STEPS.estimator) == want
        assert (pathtrace.pathtrace_frame_plain.launches - before
                == want[0])


def test_cli_pathtrace_scene_many_stream():
    w, h, frames = 24, 8, 2
    proc = _run("-m", "ttrt_torch", "--device", "cpu", "--scene", "many",
                "--n-spheres", "300", "--pathtrace", "--width", str(w),
                "--height", str(h), "--spp", "2", "--bounces", "3",
                "--frames", str(frames), "--no-input")
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, w, h, frames)
