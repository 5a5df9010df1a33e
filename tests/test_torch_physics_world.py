"""The port's physics tier (``ttrt_torch.physics.world`` and ``demo``, and
``--scene physics``) against the JAX package on the CPU.

``physics_step`` matches JAX's (jitted, as its app runs it) step after
step on pos and vel: in float64 within 1e-9 on the worlds of
tests/test_physics.py (two spheres head-on and settling, a ground bounce,
a sphere falling onto a box and one glancing off a box's side, 60 steps
each) and over 150 frames of the demo drop at 4 substeps a frame (its
first sphere-sphere contact comes at frame 132); the measured max |d| is
4.4e-16. In float32 over the same 150 frames within 1e-6, measured 2.4e-7
(about 2 ulps at the state's magnitude: XLA contracts products into fused
multiply-adds that the port's eager ops round apart). A physics frame's
plain render meets the knife bar against JAX's render of the same frame;
checkpoints cross between the packages both ways.

What the physics step kernel (``csrc/physics.cu``) rests on, on the CPU:
each pair's GJK query run alone equals the batched lockstep call bit for
bit, and ``physics_step`` on the CPU is the eager step, counted in
``profiling.PHYSICS_STEPS``, which each frame loop starts anew.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knife_util import assert_quantized_exact_off_knife
from make_torch_golden import SKY_DIM
from ttrt.assets import make_colors_skybox, skybox_from_faces
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.frames import orbit_camera_frame as jax_orbit
from ttrt.physics import demo as jdemo
from ttrt.physics import world as jworld
from ttrt.render.integrator import render_frame as jax_render_frame
from ttrt.scene import demo_scene as jax_demo_scene
from ttrt.vec import Vec3 as JVec3

from ttrt_torch import assets
from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import physics as kphysics
from ttrt_torch.kernels import render
from ttrt_torch.physics import demo, gjk, world
from ttrt_torch.scene import demo_scene
from ttrt_torch.utils import profiling
from ttrt_torch.vec import Vec3

torch.set_num_threads(1)  # the test workers share the cores

REPO = Path(__file__).resolve().parent.parent
F64_TOL = 1e-9
F32_TOL = 1e-6
DEMO_FRAMES = 150


def _jd(dtype):
    return jnp.float64 if dtype == torch.float64 else jnp.float32


def _leaves(state) -> list:
    """A state of either package as its 7 numpy leaves."""
    if isinstance(state, world.PhysicsState):
        return [l.numpy() for l in (*state.pos, *state.vel, state.t)]
    return [np.asarray(l) for l in jax.tree.leaves(state)]


def _gap(js, ts) -> float:
    return max(float(np.abs(a - b).max())
               for a, b in zip(_leaves(js)[:6], _leaves(ts)[:6]))


def _world(name, dtype):
    """(JAX state, JAX params, port state, port params, dt, substeps) of a
    world of tests/test_physics.py."""
    jd = _jd(dtype)
    pos, vel = [[-1.0, 0, 0], [1.0, 0, 0]], [[2.0, 0, 0], [-2.0, 0, 0]]
    kw, repl, dt, sub = {}, {"gravity": 0.0}, 0.01, 1
    if name == "head-on":
        radii, repl["restitution"] = [0.5, 0.5], 1.0
    elif name == "settle":
        radii = [0.5, 0.5]
    elif name == "ground":
        radii, pos, vel = [0.5], [[0.0, 2.0, 0]], [[0.0, 0, 0]]
        kw["restitution"], repl, dt, sub = 0.5, {}, 1 / 120, 2
    elif name == "box top":
        radii, pos, vel = [0.5], [[0.0, 2.0, 0]], [[0.0, 0, 0]]
        kw = {"restitution": 0.3,
              "obstacles": world.box_obstacle([0, 0, 0], [1, 1, 1])}
        repl, dt, sub = {}, 1 / 120, 2
    else:  # "box side"
        radii, pos, vel = [0.3], [[0.0, 0, 0]], [[3.0, 0, 0]]
        kw = {"restitution": 0.9,
              "obstacles": world.box_obstacle([2, 0, 0], [0.5, 5, 5])}
    jp = jworld.default_params(radii, dtype=jd, **kw)
    tp = world.default_params(radii, dtype=dtype, device="cpu", **kw)
    if "gravity" in repl:
        jp = jp._replace(gravity=jnp.zeros(3, jd))
        tp = tp._replace(gravity=torch.zeros(3, dtype=dtype))
    if "restitution" in repl:
        jp = jp._replace(restitution=jnp.asarray(repl["restitution"], jd))
        tp = tp._replace(restitution=torch.tensor(repl["restitution"],
                                                  dtype=dtype))
    p, v = np.asarray(pos, np.float64), np.asarray(vel, np.float64)
    js = jworld.PhysicsState(JVec3.from_array(jnp.asarray(p, jd)),
                             JVec3.from_array(jnp.asarray(v, jd)),
                             jnp.asarray(0.0, jd))
    ts = demo.physics_state_from_numpy(
        [*p.T, *v.T, np.zeros(())], dtype=dtype, device="cpu")
    return js, jp, ts, tp, dt, sub


@pytest.mark.parametrize("name", ["head-on", "settle", "ground", "box top",
                                  "box side"])
def test_physics_step_matches_jax_f64(name):
    js, jp, ts, tp, dt, sub = _world(name, torch.float64)
    step = jax.jit(lambda s: jworld.physics_step(s, jp, dt, substeps=sub))
    for i in range(60):
        js = step(js)
        ts = world.physics_step(ts, tp, dt, sub)
        assert _gap(js, ts) <= F64_TOL, (name, i, _gap(js, ts))
    assert ts.t.dtype == torch.float64
    assert float(ts.t) == float(js.t)
    if name in ("head-on", "box side"):  # the contact reversed the motion
        assert float(ts.vel.x[0]) < 0.0


def _demo_pair(dtype):
    jd = _jd(dtype)
    js = jax_demo_scene(skybox_from_faces(make_colors_skybox(SKY_DIM), jd),
                        24, 12, jd)
    ts = demo_scene(assets.load_skybox("colors", device="cpu"), 24, 12,
                    dtype=dtype, device="cpu")
    return jdemo.build_physics_demo(js, jd), demo.build_physics_demo(ts)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, F64_TOL),
                                       (torch.float32, F32_TOL)])
def test_demo_drop_matches_jax(dtype, tol):
    (js, jp), (ts, tp) = _demo_pair(dtype)
    dt = 1.0 / 60.0
    step = jax.jit(lambda s: jworld.physics_step(
        s, jp, jnp.asarray(dt, _jd(dtype)), substeps=demo.SUBSTEPS))
    ii, jj = world._pair_indices(6)
    closest = np.inf
    for i in range(DEMO_FRAMES):
        js = step(js)
        ts = world.physics_step(ts, tp, dt, demo.SUBSTEPS)
        assert _gap(js, ts) <= tol, (i, _gap(js, ts))
        p = ts.pos.to_array().numpy()
        closest = min(closest, np.linalg.norm(p[ii] - p[jj], axis=1).min())
    assert closest < 1.0 + 1e-3  # a pair touched: GJK's contact path ran


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32
                               else torch.int64)


def _lanes_alone(checked: dict):
    """A stand-in for ``gjk_distance`` in ``world``: the batched lockstep
    call, and each lane's query run alone (a batch of one, with its own
    early exit), which must give that lane's bits; counts the lanes and
    the touching ones into ``checked``."""
    def each_lane(sa, sb, x0):
        dist, normal = gjk.gjk_distance(sa, sb, x0)
        for q in range(dist.shape[0]):
            def lane(v):
                return Vec3(*(c[q:q + 1] for c in v))

            d1, n1 = gjk.gjk_distance(
                gjk.sphere_support(lane(sa.fn.center), sa.margin[q:q + 1]),
                gjk.sphere_support(lane(sb.fn.center), sb.margin[q:q + 1]),
                lane(x0))
            for alone, batched in zip((d1, *n1), (dist, *normal)):
                assert torch.equal(_bits(alone), _bits(batched[q:q + 1])), q
        checked["lanes"] += dist.shape[0]
        checked["touching"] += int((dist < 0).sum())
        return dist, normal

    return each_lane


def _sphere_support(center, radius):
    """``gjk.sphere_support`` with its centres kept on its function."""
    s = gjk.sphere_support(center, radius)
    fn = functools.partial(s.fn)
    fn.center = center
    return s._replace(fn=fn)


@pytest.mark.parametrize("name", ["demo", "head-on"])
def test_gjk_lane_alone_equals_lockstep_batch(name, monkeypatch):
    """What the physics step kernel rests on: a pair's GJK query run alone
    (one lane a pair, stopping at its own convergence) gives the bits of
    the batched lockstep loop, in every substep of the demo drop's first
    60 frames (4 substeps, 15 pairs; a pair touches in one substep) and of
    the head-on world's 40 steps, its contact included."""
    if name == "demo":
        ts, tp = _demo_pair(torch.float32)[1]
        dt, sub, frames = 1.0 / 60.0, demo.SUBSTEPS, 60
    else:
        _, _, ts, tp, dt, sub = _world(name, torch.float32)
        frames = 40
    checked = {"lanes": 0, "touching": 0}
    monkeypatch.setattr(world, "sphere_support", _sphere_support)
    monkeypatch.setattr(world, "gjk_distance", _lanes_alone(checked))
    with torch.inference_mode():  # a lone query is ~1,400 ATen ops
        for _ in range(frames):
            ts = world.physics_step(ts, tp, dt, sub)
    pairs = tp.radius.shape[0] * (tp.radius.shape[0] - 1) // 2
    assert checked["lanes"] == frames * sub * pairs
    assert checked["touching"] > 0, checked  # the contact path ran


def test_physics_step_on_the_cpu_is_the_eager_step():
    (_, _), (ts, tp) = _demo_pair(torch.float32)
    assert not kphysics.takes(ts, tp)
    profiling.PHYSICS_STEPS.reset()
    out = world.physics_step(ts, tp, 1.0 / 60.0, demo.SUBSTEPS)
    assert (profiling.PHYSICS_STEPS.kernel,
            profiling.PHYSICS_STEPS.eager) == (0, 1)
    plain = world.physics_step_plain(ts, tp, 1.0 / 60.0, demo.SUBSTEPS)
    for a, b in zip((*out.pos, *out.vel, out.t),
                    (*plain.pos, *plain.vel, plain.t)):
        assert torch.equal(_bits(a), _bits(b))
    with pytest.raises(ValueError):
        kphysics.physics_step_cuda(ts, tp, 1.0 / 60.0, demo.SUBSTEPS)


def test_recording_resets_the_physics_step_counts():
    profiling.PHYSICS_STEPS.kernel, profiling.PHYSICS_STEPS.eager = 3, 4
    with profiling.recording(profiling.StageTimers()):
        assert (profiling.PHYSICS_STEPS.kernel,
                profiling.PHYSICS_STEPS.eager) == (0, 0)
        profiling.PHYSICS_STEPS.eager += 1
    # kept after the loop, for the benchmark's reader
    assert profiling.PHYSICS_STEPS.eager == 1


def test_physics_frame_plain_render_meets_knife_bar():
    """Frame 45 of the demo drop (the spheres have fallen past the orbit
    camera's view of the ring): the port's frame step (no substep) renders
    JAX's state through the plain version; JAX renders it as its
    build_physics_frame_step does."""
    W, H = 32, 16
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=2,
                           bounce_limit=10, dtype=jnp.float32)
    tcfg = RenderConfig(width=W, height=H, rays_per_pixel=2, bounce_limit=10)
    js = jax_demo_scene(skybox_from_faces(make_colors_skybox(SKY_DIM),
                                          jnp.float32, procedural="colors"),
                        W, H, jnp.float32)
    jstate, jp = jdemo.build_physics_demo(js, jnp.float32)
    step = jax.jit(lambda s: jworld.physics_step(
        s, jp, jnp.asarray(jcfg.frame_duration, jnp.float32), substeps=4))
    for _ in range(45):
        jstate = step(jstate)
    offset = np.asarray([0.1, -0.2, 0.0])
    frame = jax_orbit(jstate.t * 0.3, jnp.float32)
    frame = frame._replace(origin=(frame.origin * 3.0).astype(jnp.float32)
                           + jnp.asarray(offset, jnp.float32))
    jframe = js._replace(spheres=js.spheres._replace(
        center=jstate.pos)).with_camera_frame(frame)
    fb_ref, rays_ref = jax.jit(
        lambda s: jax_render_frame(s, jcfg, count_rays=True))(jframe)

    ts = demo_scene(assets.load_skybox("colors", device="cpu"), W, H,
                    dtype=torch.float32, device="cpu")
    _, tp = demo.build_physics_demo(ts)
    tstate = demo.physics_state_from_numpy(_leaves(jstate),
                                           dtype=torch.float32, device="cpu")
    frame_step = demo.build_physics_frame_step(ts, tcfg, tp,
                                               render.render_frame,
                                               substeps=0)
    before = render.render_frame_plain.launches
    out_state, fb, rays = frame_step(
        tstate, torch.as_tensor(offset, dtype=torch.float32),
        count_rays=True)
    assert render.render_frame_plain.launches == before + 1
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(out_state),
                                                    _leaves(tstate)))
    out = fb.to_array().numpy()
    assert np.isfinite(out).all() and out.shape == (H, W, 3)
    assert_quantized_exact_off_knife(np.asarray(fb_ref.to_array()), out,
                                     jframe, jcfg, 0.20, rays_ref=rays_ref,
                                     rays_pal=int(rays))


def test_checkpoints_cross_between_packages(tmp_path):
    """port -> port, JAX -> port and port -> JAX, the '.npz' suffix added
    to a bare path by both."""
    (js, jp), (ts, tp) = _demo_pair(torch.float32)
    for _ in range(3):
        js = jworld.physics_step(js, jp, 1.0 / 60.0, substeps=4)
        ts = world.physics_step(ts, tp, 1.0 / 60.0, demo.SUBSTEPS)
    like = demo.build_physics_demo(
        demo_scene(assets.load_skybox("colors", device="cpu"), 8, 4,
                   dtype=torch.float32, device="cpu"))[0]
    assert demo.load_checkpoint(str(tmp_path / "none"), like) is None

    demo.save_checkpoint(str(tmp_path / "port.ckpt"), ts)
    assert (tmp_path / "port.ckpt.npz").exists()
    back = demo.load_checkpoint(str(tmp_path / "port.ckpt"), like)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(back),
                                                    _leaves(ts)))
    assert back.t.shape == () and back.t.dtype == torch.float32

    jdemo.save_checkpoint(str(tmp_path / "jax.ckpt"), js)
    from_jax = demo.load_checkpoint(str(tmp_path / "jax.ckpt.npz"), like)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(from_jax),
                                                    _leaves(js)))

    to_jax = jdemo.load_checkpoint(str(tmp_path / "port.ckpt"), js)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(to_jax),
                                                    _leaves(ts)))
    assert jax.tree.structure(to_jax) == jax.tree.structure(js)


def _run(*args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "ttrt_torch", *args],
                           cwd=REPO, env=env, capture_output=True,
                           timeout=timeout)


def test_cli_scene_physics_checkpoint_resumes(tmp_path):
    import chip_smoke

    ckpt = str(tmp_path / "state.ckpt")
    args = ("--device", "cpu", "--scene", "physics", "--no-input",
            "--width", "16", "--height", "8", "--spp", "1", "--bounces",
            "3", "--frames", "2", "--checkpoint", ckpt)
    for run in range(2):
        proc = _run(*args)
        assert proc.returncode == 0, proc.stderr.decode()
        chip_smoke.validate_stream(proc.stdout, 16, 8, 2)
        with np.load(ckpt + ".npz") as data:
            t = float(data["arr_6"])
        # 2 frames of 4 substeps of 1/60 s a run; the second resumed
        assert abs(t - (run + 1) * 2 / 60) < 1e-6, (run, t)
    assert b"resumed physics state at t=0.03s" in proc.stderr


def test_cli_mesh_refuses_scene_physics():
    proc = _run("--device", "cpu", "--scene", "physics", "--mesh", "auto",
                "--frames", "1", "--no-input")
    assert proc.returncode == 1 and proc.stdout == b""
    lines = proc.stderr.decode().strip().splitlines()
    assert len(lines) == 1 and "--mesh does not apply to --scene physics" \
        in lines[0], lines
