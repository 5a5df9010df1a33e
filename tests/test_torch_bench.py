"""The port's bench (``ttrt_torch/bench.py``) on the CPU.

``main()``'s contract with its tiers stubbed: one JSON line on stdout,
``<tier>_error`` and exit 1 when a tier raises or a key is missing, and
no measurement without a card. Then the real tier code at small sizes:
the numerators (traces a frame) of the rays, textured and 10k tiers equal
the JAX package's ``render_frame(count_rays=True)`` counts exactly on the
same camera windows; the path-tracing tier's step meets the bar of
tests/test_torch_pathtrace_kernel.py against JAX's kernel in interpret
mode, with the JAX bench's seed; the 64-body physics world from the numpy
seed matches JAX's ``physics_step`` from the same centers after 5 steps
within PHYSICS_TOL; every tier runs end to end on the CPU.
"""

import ast
import contextlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from make_torch_golden import jax_area_lights, jax_mesh_scene, jax_scene
from ttrt.assets import make_colors_skybox, skybox_from_faces
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.kernels.pathtrace_pallas import pathtrace_frame_pallas
from ttrt.physics import demo as jdemo
from ttrt.physics import world as jworld
from ttrt.render.integrator import render_frame as jax_render_frame
from ttrt.scene import Spheres as JaxSpheres
from ttrt.scene import demo_scene as jax_demo_scene
from ttrt.vec import Vec3 as JVec3

from ttrt_torch import bench
from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import mesh_fused, render
from ttrt_torch.physics.world import physics_step
from ttrt_torch.render import integrator
from ttrt_torch.render.pathtrace import default_area_lights
from ttrt_torch.term.encoder import ansi_buffer_size

torch.set_num_threads(1)  # the test workers share the cores

REPO = Path(__file__).resolve().parent.parent
# float32 state after 5 steps of 64 bodies: a few ulps of |x| <= 6, where
# XLA contracts products into fused multiply-adds the eager ops round apart
# (tests/test_torch_physics_world.py's float32 bar; measured 3.0e-8)
PHYSICS_TOL = 1e-6


def _stub_tiers(monkeypatch, calls=None):
    """Every tier replaced by one that returns its keys: each 1.0, each
    list of runs (or windows) [1.0] * its tier's position + 1."""
    for i, tier in enumerate(bench.TIERS):
        def fn(tier=tier, i=i, **kw):
            if calls is not None:
                calls.append((tier, kw))
            return {k: [1.0] * (i + 1) if k.endswith(("_runs", "_windows"))
                    else 1.0 for k in bench.TIER_KEYS[tier]}
        monkeypatch.setattr(bench, tier, fn)


def _run_main():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, "the bench prints exactly one stdout line"
    return rc, json.loads(lines[0])


@pytest.mark.parametrize("card", [True, False])
def test_main_prints_one_json_line(monkeypatch, card):
    calls = []
    _stub_tiers(monkeypatch, calls)
    if card:
        monkeypatch.setattr(bench, "_device_info",
                            lambda: ("Test card", 700.0))
    else:  # the real _device_info on a machine without a card
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _run_main()
    assert out["metric"] == bench.METRIC and out["unit"] == "Mray/s"
    assert "vs_baseline" not in out and "baseline" not in out
    if not card:
        assert rc == 1 and out["value"] == 0.0
        assert "no CUDA device" in out["error"] and not calls
        return
    assert rc == 0
    assert [c[0] for c in calls] == list(bench.TIERS)
    assert all(kw == {"repeats": bench.HEADLINE_RUNS} for _, kw in calls)
    assert bench.bad_keys(out) == []
    assert out["value"] == out["mrays_per_s"] == 1.0
    assert out["device"] == "Test card" and out["power_limit_w"] == 700.0
    # median_of counts each rate's own list of runs
    assert out["median_of"]["mrays_per_s"] == 1
    assert out["median_of"]["mrays_per_s_eager"] == 1
    assert out["median_of"]["fps_480x280_batched"] == 2
    assert out["median_of"]["mrays_10k_flyover"] == 4
    assert out["median_of"]["pathtrace_msamples_per_s"] == 7
    assert set(out["median_of"]) == {
        k.rsplit("_", 1)[0] for k in bench.LINE_KEYS
        if k.endswith(("_runs", "_windows"))}
    assert set(out["launches"]) == {fn.__name__ for pair in bench.COUNTERS
                                    for fn in pair}


def test_failed_tier_is_isolated_and_exits_1(monkeypatch):
    _stub_tiers(monkeypatch)
    monkeypatch.setattr(bench, "_device_info", lambda: ("Test card", 700.0))

    def bench_many_object(**kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(bench, "bench_many_object", bench_many_object)
    rc, out = _run_main()
    assert rc == 1
    assert "out of memory" in out["bench_many_object_error"]
    missing = bench.bad_keys(out)
    assert missing == list(bench.TIER_KEYS["bench_many_object"])
    # a key that is not a finite number > 0 also fails the run
    _stub_tiers(monkeypatch)
    physics = {"physics_steps_per_s_64body": 1.0,
               "physics_steps_per_s_64body_runs": [1.0],
               "physics_render_fps": float("nan"),
               "physics_render_fps_runs": [1.0],
               "physics_kernels_per_frame": 0}
    monkeypatch.setattr(bench, "bench_physics", lambda **kw: physics)
    rc, out = _run_main()
    assert rc == 1 and not [k for k in out if k.endswith("_error")]
    assert bench.bad_keys(out) == ["physics_render_fps",
                                   "physics_kernels_per_frame"]


def test_median_rate_pairs_each_run_with_its_numerator():
    run_rays, pers = [1e6, 2e6, 4e6], [1.0, 1.0, 4.0]
    assert bench._rates(run_rays, pers) == [1.0, 2.0, 1.0]
    # the mean numerator over the median time would read 2.33
    assert bench._median_rate(run_rays, pers) == 1.0

    seen = []

    def fake_render(scene, cfg, count_rays):
        assert count_rays
        seen.append(float(scene.camera.frame.origin[2]))
        return None, torch.tensor(100 + len(seen))

    scene = bench._demo(RenderConfig(width=4, height=2), "cpu")
    mean = bench._mean_rays(fake_render, scene, RenderConfig(), [0.0, 1.0])
    assert mean == (101 + 102) / 2 and len(set(seen)) == 2


def _cfgs(w, h, spp, bounces):
    return (JaxRenderConfig(width=w, height=h, rays_per_pixel=spp,
                            bounce_limit=bounces, dtype=jnp.float32),
            RenderConfig(width=w, height=h, rays_per_pixel=spp,
                         bounce_limit=bounces))


@pytest.mark.parametrize("tier", ["rays", "textured"])
def test_demo_numerators_equal_jax_counts(tier):
    """48x28, 2 spp, 3 bounces, the first three times of the tier's
    window: the kernel's (plain version's) traces a frame, and for the
    rays tier the float32 eager integrator's, against JAX
    ``render_frame``'s count on JAX's own scene and pose, within the trace
    bar of chip_smoke.py phase 2 (max(0.5%, 16)). Measured: the kernel's
    equal to JAX's at every time but t = 2.37, where a few knife-edge rays
    end elsewhere (11,226 against 11,232; JAX's own kernel, in interpret
    mode, reads 11,211 there); the eager integrator's 2-33 apart."""
    jcfg, cfg = _cfgs(48, 28, 2, 3)
    if tier == "rays":
        scene, ts = bench._demo(cfg, "cpu"), bench.window(2.0, 0.37, 3)
        sky = dict(sky_dim=256)
    else:
        scene = bench.textured_scene(cfg, "cpu")
        ts = bench.window(900.0, 0.37, 3)
        sky = dict(sky_dim=256, procedural=None)
        assert scene.skybox.procedural is None
    exact = 0
    for t in ts:
        _, want = jax_render_frame(jax_scene(t, 48, 28, **sky), jcfg,
                                   count_rays=True)
        got = bench._mean_rays(render.render_frame, scene, cfg, [t])
        assert chip_smoke._rays_close(int(want), got), (t, got, int(want))
        exact += got == int(want)
        if tier == "rays":
            eager = bench._mean_rays(integrator.render_frame, scene, cfg,
                                     [t])
            assert chip_smoke._rays_close(int(want), eager), (t, eager)
    assert exact >= len(ts) - 1, exact


def test_pathtrace_step_meets_jax_kernel():
    """24x14, 4 spp, 4 bounces, the tier's area light, the seed of
    ``bench.bench_seed``: the step (the kernel's plain version) against
    JAX's ``pathtrace_frame_pallas`` in interpret mode, at the bar of
    test_plain_matches_pallas_interpret (no pixel off by more than
    PT_TOL)."""
    jcfg, cfg = _cfgs(24, 14, 4, 4)
    for t in (0.7, 1700.0, 1700.41):
        assert bench.bench_seed(t) == int(
            (jnp.float32(t) * 997.0).astype(jnp.int32))
    t = bench.window(1700.0, 0.41, 2)[1]
    lights = default_area_lights(cfg, "cpu")
    step = bench.pathtrace_step(bench._demo(cfg, "cpu"), lights, cfg)
    out = step(t).to_array().numpy()
    ref = np.asarray(pathtrace_frame_pallas(
        jax_scene(t, 24, 14), jax_area_lights(), jcfg,
        jnp.int32(bench.bench_seed(t)), interpret=True).to_array())
    assert out.shape == (14, 24, 3) and np.isfinite(out).all()
    stats = chip_smoke.pathtrace_bar(ref, out)
    assert stats["differ_px"] == 0, stats


def test_many_object_numerators_equal_jax_counts():
    """A 500-sphere scene at 60x16, 2 spp, 3 bounces: the fused kernel's
    (plain version's) traces a frame, from inside the cloud and from the
    exterior camera, and the eager integrator's through the grid and
    through the dense tester, against JAX's eager ``render_frame`` on its
    own scene (the same seed) and pose, within the trace bar of
    chip_smoke.py phase 2 (max(0.5%, 16)). Measured: equal inside the
    cloud; from the exterior camera the fused kernel's walk 3 traces
    above JAX's grid walk (3,839 against 3,836)."""
    jcfg, cfg = _cfgs(60, 16, 2, 3)
    scene = bench.many_scene(500, cfg, "cpu")
    dense = bench.DenseMeshScene(*scene._replace(grid=None, clusters=None))
    for t, scale in ((bench.window(1300.0, 0.21, 1)[0], 1.0),
                     (1500.0, bench.FLYOVER_SCALE)):
        js = jax_mesh_scene(t, 500, 60, 16, sky_dim=64, procedural=None)
        if scale != 1.0:
            js = js.with_camera_frame(js.camera.frame._replace(
                origin=js.camera.frame.origin * scale))
        _, want = jax_render_frame(js, jcfg, count_rays=True)
        fused = bench._mean_rays(mesh_fused.render_frame_mesh_fused, scene,
                                 cfg, [t], scale)
        assert chip_smoke._rays_close(int(want), fused), (t, fused)
        if scale == 1.0:
            for s in (scene, dense):
                eager = bench._mean_rays(integrator.render_frame, s, cfg, [t])
                assert chip_smoke._rays_close(int(want), eager), (t, eager)


def test_physics_world_matches_jax():
    """The 64-body world from the numpy seed, built as bench.py builds its
    own, against JAX's ``physics_step`` (jitted, one substep of 1/60 s)
    from the same centers: pos and vel within PHYSICS_TOL after 5
    steps."""
    n = 64
    state, params = bench.physics_world(n, "cpu")
    centers = np.random.default_rng(0).uniform(
        -3.0, 3.0, (n, 3)).astype(np.float32)
    base = jax_demo_scene(skybox_from_faces(make_colors_skybox(8),
                                            jnp.float32), 16, 8, jnp.float32)
    jscene = base._replace(spheres=JaxSpheres(
        center=JVec3.from_array(jnp.asarray(centers)),
        radius=jnp.full((n,), 0.25, jnp.float32),
        material=base.spheres.material.take(jnp.zeros(n, jnp.int32))))
    jstate, jparams = jdemo.build_physics_demo(jscene, jnp.float32)
    jstep = jax.jit(lambda s: jworld.physics_step(s, jparams, 1.0 / 60.0,
                                                  substeps=1))
    for _ in range(5):
        state = physics_step(state, params, 1.0 / 60.0, substeps=1)
        jstate = jstep(jstate)
    got = [v.numpy() for v in (*state.pos, *state.vel)]
    want = [np.asarray(v) for v in jax.tree.leaves(jstate)[:6]]
    gap = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    assert gap <= PHYSICS_TOL, gap
    assert float(state.t) == float(jstate.t)


def test_bench_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "ttrt_torch" / "bench.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and all(n.split(".")[0] not in ("jax", "ttrt", "bench")
                         for n in names), names


def test_tiers_run_end_to_end_on_the_cpu():
    """Every tier at a tiny size on the CPU: each key of LINE_KEYS that
    the CPU measures is a finite number > 0, the card's keys are left out,
    and every frame went through a plain version (no kernel launch; the
    CPU's eager rays of a MeshScene walk its grid, not
    ``cluster_nearest_plain``)."""
    cfg = RenderConfig(width=16, height=8, rays_per_pixel=2, bounce_limit=3)
    for pair in bench.COUNTERS:
        for fn in pair:
            fn.launches = 0
    one = dict(device="cpu", repeats=1)
    line = {}
    line.update(bench.bench_rays(cfg=cfg, frames=2, eager_frames=1, **one))
    line.update(bench.bench_streaming(cfg=cfg, frames=2, **one))
    line.update(bench.bench_textured(cfg=cfg, frames=2, **one))
    line.update(bench.bench_many_object(cfg=cfg, n_spheres=40, frames=2,
                                        eager_frames=1, **one))
    line.update(bench.bench_many_object_100k(cfg=cfg, n_spheres=60,
                                             frames=2, **one))
    line.update(bench.bench_physics(n_bodies=4, steps=2, cfg=cfg, frames=1,
                                    **one))
    line.update(bench.bench_pathtrace(cfg=cfg, tier_cfg=cfg, frames=2,
                                      eager_frames=1, **one))
    on_cpu = [k for k in bench.LINE_KEYS if k not in bench.DEVICE_KEYS
              and k not in ("value", "power_limit_w")]
    assert bench.bad_keys(line, on_cpu) == []
    assert not set(line) & set(bench.DEVICE_KEYS)
    assert line["frame_bytes"] == ansi_buffer_size(16, 8)
    for kernel, plain in bench.COUNTERS:
        assert kernel.launches == 0, kernel.__name__
        if plain is not bench.mesh.cluster_nearest_plain:
            assert plain.launches > 0, plain.__name__
