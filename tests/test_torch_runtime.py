"""The port's host runtime on the CPU: ``--encode auto``, the batched
loop (``--batch``) against the single-frame step and against JAX's
``build_frame_batch_step``, ``--profile`` and the frame metrics,
``--debug-nans`` and ``count_bits`` against JAX's."""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from knife_util import knife_mask, quantize_u8
from ttrt import app as jax_app
from ttrt import assets as jax_assets
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.frames import Frame as jax_frame
from ttrt.render.integrator import render_frame as jax_render_frame
from ttrt.scene import demo_scene as jax_demo_scene
from ttrt.utils import count_bits as jax_count_bits

from ttrt_torch import app, native
from ttrt_torch.config import RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels import pathtrace, render
from ttrt_torch.utils import count_bits
from ttrt_torch.utils.profiling import TRACE_FILE, StageTimers

torch.set_num_threads(1)  # the test workers share the cores

REPO = Path(__file__).resolve().parent.parent
W, H, SPP, BOUNCES = 48, 28, 2, 3


def _cfg(**kw):
    return RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                        bounce_limit=BOUNCES, **kw)


def _scene(cfg):
    return app.make_scene("demo", cfg, "colors", device="cpu")


def test_encode_auto_resolves_by_the_native_library(monkeypatch):
    assert app.resolve_encode("device") == "device"
    assert app.resolve_encode("host") == "host"
    assert app.resolve_encode("auto") == ("host" if native.available
                                          else "device")
    monkeypatch.setattr(native, "available", False)
    assert app.resolve_encode("auto") == "device"
    assert app.host_encoder(_cfg()) is app.encode_ansi_host


def _batch_times(t0, batch, fps=60.0):
    """JAX's frame times: t0 + k / fps in float32."""
    return (np.float32(t0) + np.arange(batch, dtype=np.float32)
            * np.float32(1.0 / fps)).tolist()


def test_batch_step_equals_the_single_step_bit_for_bit():
    cfg = _cfg()
    scene = _scene(cfg)
    offset = torch.tensor([0.05, -0.02, 0.0])
    frames = app.build_frame_batch_step(scene, cfg, 3)(1.5, offset)
    assert frames.shape == (3, H, W, 3) and frames.dtype == torch.uint8
    single = app.build_frame_step(scene, cfg, "host")
    for k, t in enumerate(_batch_times(1.5, 3)):
        assert torch.equal(frames[k], single(t, offset)), k
    assert len(set(f.numpy().tobytes() for f in frames)) == 3


def test_batch_step_meets_the_knife_bar_against_jax():
    """Each u8 frame of the port's batch step against JAX at the same frame
    time. Each package computes the camera pose itself, and the two poses
    may differ by an ulp (held at 1e-6 in tests/test_torch_modules.py), so
    the oracle is JAX ``render_frame`` of the JAX scene carrying the port's
    pose: every flip lies in the knife-edge classes of tests/knife_util.py
    (K1 | K2 of that scene, KQ from JAX's float frame), the knife share
    within its cap, at most 3% of pixels flipped. JAX's
    ``build_frame_batch_step`` renders the same frames: its u8 frames
    differ from that oracle on at most 3% of pixels (its own pose and
    XLA's fused multiply-adds)."""
    cfg = _cfg()
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=SPP,
                           bounce_limit=BOUNCES, dtype=jnp.float32)
    jscene = jax_demo_scene(jax_assets.load_skybox("colors", jnp.float32), W,
                            H, jnp.float32)
    jframes = np.asarray(jax_app.build_frame_batch_step(jscene, jcfg, 3)(
        jnp.asarray(1.5, jnp.float32), jnp.zeros(3, jnp.float32)))
    frames = app.build_frame_batch_step(_scene(cfg), cfg, 3)(
        1.5, torch.zeros(3)).numpy()
    for k, t in enumerate(_batch_times(1.5, 3)):
        pose = orbit_camera_frame(t, dtype=torch.float32, device="cpu")
        js = jscene.with_camera_frame(jax_frame(jnp.asarray(pose.basis),
                                                jnp.asarray(pose.origin)))
        ref = np.asarray(jax_render_frame(js, jcfg)[0].to_array(),
                         np.float64)
        q_ref = quantize_u8(ref)
        knife = (knife_mask(js, jcfg, q_ref, 3e-6)
                 | knife_mask(js, jcfg, q_ref, 1e-4))
        kq = np.abs(ref * 255 - np.round(ref * 255)) < 0.05
        flips = frames[k] != q_ref
        assert not (flips & ~knife[..., None] & ~kq).any(), k
        assert knife.mean() <= 0.20
        assert flips.any(axis=-1).sum() <= 0.03 * W * H
        assert (jframes[k] != q_ref).any(axis=-1).sum() <= 0.03 * W * H


def _run(*args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, timeout=timeout)


def test_cli_batch_emits_exactly_the_frames_asked_for():
    """--batch 3 --frames 5: two batches emitted (the second cut after two
    frames), the loop's issue rule renders a third."""
    w, h = 24, 8
    proc = _run("-m", "ttrt_torch", "--device", "cpu", "--batch", "3",
                "--frames", "5", "--no-input", "--width", str(w), "--height",
                str(h), "--spp", "2", "--bounces", "3", "--stats")
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, w, h, 5)
    assert b"frames: 5  batch: 3" in proc.stderr


def test_mesh_forces_batch_1_and_pathtrace_never_batches(monkeypatch,
                                                         capsys):
    def refuse(*args, **kw):
        raise AssertionError("took the batched loop")

    monkeypatch.setattr(app, "_run_animation_batched", refuse)
    cfg = RenderConfig(width=12, height=6, rays_per_pixel=2, bounce_limit=3,
                       frame_rate=1e9)
    for kw, launches in (({"pathtrace": True},
                          lambda: pathtrace.pathtrace_frame_plain.launches),
                         ({"mesh_spec": "auto"},
                          lambda: render.render_band_plain.launches)):
        sink = io.BytesIO()
        before = launches()
        app.run_animation(cfg, "colors", max_frames=2, interactive=False,
                          device="cpu", stream=sink, batch=3, **kw)
        chip_smoke.validate_stream(sink.getvalue(), 12, 6, 2)
        assert launches() == before + 2, kw
    assert "--mesh: forcing --batch 1" in capsys.readouterr().err


def test_profile_writes_a_trace_and_the_meter_counts_rays(tmp_path):
    """``--profile``'s trace file: the frame steps' spans (``pose``,
    ``write``: ``StageTimers`` marks each while the profiler runs) beside
    the ``aten::`` ops, on one timeline."""
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2,
                       frame_rate=1e9)
    timers = StageTimers()
    app.run_animation(cfg, "colors", max_frames=2, interactive=False,
                      device="cpu", stream=io.BytesIO(), timers=timers,
                      profile_dir=str(tmp_path / "prof"))
    assert timers.summary()["pose"]["n"] == 2
    trace = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    names = {e.get("name", "") for e in events}
    assert {"pose", "write", "render+copy"} <= names
    assert any(n.startswith("aten::") for n in names)
    # the spans and the ops they run share one clock
    pose = [e for e in events if e["name"] == "pose"]
    ops = [e for e in events if e["name"].startswith("aten::")]
    assert any(p["ts"] <= o["ts"] <= p["ts"] + p["dur"]
               for p in pose for o in ops)


def test_debug_nans_raises_on_a_non_finite_frame(monkeypatch):
    """A framebuffer patched to hold a NaN stops the demo, batched,
    path-traced and physics steps with FloatingPointError naming t; with
    the flag off the same frame goes through."""
    def poisoned(fn):
        def render_fn(*args, **kw):
            fb, rays = fn(*args, **kw)
            fb.x[0, 0] = torch.nan
            return fb, rays
        return render_fn

    monkeypatch.setattr(render, "render_frame",
                        poisoned(render.render_frame))
    monkeypatch.setattr(pathtrace, "pathtrace_frame",
                        poisoned(pathtrace.pathtrace_frame))
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    scene, off = _scene(cfg), torch.zeros(3)
    steps = {
        "demo": lambda d: app.build_frame_step(scene, cfg, "host",
                                               debug_nans=d)(0.5, off),
        "batch": lambda d: app.build_frame_batch_step(
            scene, cfg, 2, debug_nans=d)(0.5, off),
        "pathtrace": lambda d: app.build_pathtrace_frame_step(
            scene, cfg, "host", debug_nans=d)(0.5, off),
        "physics": lambda d: app.run_physics(
            cfg, max_frames=1, interactive=False, device="cpu",
            stream=io.BytesIO(), debug_nans=d),
    }
    for kind, step in steps.items():
        step(False)
        with pytest.raises(FloatingPointError,
                           match="non-finite framebuffer at t="):
            step(True)


def test_debug_nans_passes_demo_frames():
    cfg = RenderConfig(width=12, height=6, rays_per_pixel=2, bounce_limit=3,
                       frame_rate=1e9)
    for batch in (0, 2):
        sink = io.BytesIO()
        app.run_animation(cfg, "colors", max_frames=3, interactive=False,
                          device="cpu", stream=sink, batch=batch,
                          debug_nans=True)
        chip_smoke.validate_stream(sink.getvalue(), 12, 6, 3)


def test_count_bits_on_ints_equals_jax():
    values = [0, 1, 0b1011, 255, 0xFFFFFFFF, 0x1FFFFFFFF, -1, -2, -(1 << 31),
              (1 << 31) - 1, 123456789, -987654321]
    assert [count_bits(v) for v in values] == [jax_count_bits(v)
                                               for v in values]


@pytest.mark.parametrize("dtype,jdtype", [(torch.int32, jnp.int32),
                                          (torch.int64, jnp.int64)])
def test_count_bits_on_arrays_equals_jax(dtype, jdtype):
    rng = np.random.default_rng(21)
    a = rng.integers(-(1 << 31), 1 << 31, (7, 33), dtype=np.int64)
    a[0, :4] = [0, -1, (1 << 31) - 1, -(1 << 31)]
    got = count_bits(torch.as_tensor(a, dtype=dtype))
    want = np.asarray(jax_count_bits(jnp.asarray(a, jdtype)))
    assert got.dtype == torch.int32 and got.shape == a.shape
    np.testing.assert_array_equal(got.numpy(), want)
