"""The frozen reference against the port's CPU path at a tiny size, its
sphere draw against the port's scene, its counts against a hand count,
and the ANSI decoder against the port's encoders."""

import numpy as np
import pytest
import torch

from benchmark.metrics import _roofline
from benchmark.reference import (ansi, camera, demo, many, pathtrace,
                                 raytrace, sky_colors)
from benchmark.reference.vec import Vec3

F32 = torch.float32
CFG = {"kind": "demo", "width": 24, "height": 10, "spp": 3, "bounces": 4,
       "sky": "colors", "bilinear": False, "n_spheres": 300, "seed": 5}
SKY = sky_colors.build(CFG, device="cpu")


def _port(kind: str, seed: int):
    from ttrt_torch import app, assets
    from ttrt_torch.config import RenderConfig
    from ttrt_torch.mesh.scene import many_sphere_scene

    cfg = RenderConfig(width=CFG["width"], height=CFG["height"],
                       rays_per_pixel=CFG["spp"], bounce_limit=CFG["bounces"])
    if kind == "demo":
        return cfg, app.make_scene("demo", cfg, "colors", device="cpu")
    sky_ = assets.load_skybox("colors", device="cpu")
    scene = many_sphere_scene(sky_, CFG["n_spheres"], cfg.width, cfg.height,
                              seed=seed, dtype=F32, device="cpu")
    return cfg, scene._replace(grid=None)  # the CPU's dense tester


@pytest.mark.parametrize("kind,t", [("demo", 3.7), ("demo", 61.25),
                                    ("many", 0.4)])
def test_raytrace_equals_the_port_eager_integrator(kind, t):
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.render import integrator
    from ttrt_torch.term.encoder import encode_rgb_frame

    cfg, scene = _port(kind, 5)
    frame = orbit_camera_frame(t, dtype=F32, device="cpu")
    fb, traces = integrator.render_frame(scene.with_camera_frame(frame), cfg,
                                         count_rays=True)
    mod = demo if kind == "demo" else many
    ref = mod.build(CFG, dtype=F32, device="cpu")
    u8, ref_traces = raytrace.render(ref, SKY,
                                     {**CFG, "kind": kind}, t, 0, dtype=F32,
                                     device="cpu")
    assert np.array_equal(u8.numpy(), encode_rgb_frame(fb).numpy())
    assert ref_traces == int(traces)
    rows = [7, 0, 3]
    part, _ = raytrace.render(ref, SKY,
                              {**CFG, "kind": kind}, t, 0, rows, dtype=F32,
                              device="cpu")
    assert np.array_equal(part.numpy(), u8.numpy()[rows])


@pytest.mark.parametrize("seed,t", [(0, 0.7), (2**31 + 17, 42.123)])
def test_pathtrace_equals_the_port_plain_version(seed, t):
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import pathtrace as port_pt
    from ttrt_torch.render.pathtrace import default_area_lights
    from ttrt_torch.term.encoder import encode_rgb_frame

    cfg, scene = _port("demo", 0)
    fseed = port_pt.frame_seed(seed, t)
    assert pathtrace.frame_seed(seed, t) == fseed
    frame = orbit_camera_frame(t, dtype=F32, device="cpu")
    fb, work = port_pt.pathtrace_frame_plain(
        scene.with_camera_frame(frame), default_area_lights(cfg, "cpu"), cfg,
        fseed)
    u8, ref_work = pathtrace.render(None, SKY, CFG, t, seed, dtype=F32,
                                    device="cpu")
    assert np.array_equal(u8.numpy(), encode_rgb_frame(fb).numpy())
    assert list(ref_work) == work.tolist()


@pytest.mark.parametrize("seed", [3, 2**31 + 99])
def test_sphere_draw_equals_the_port_scene(seed):
    from ttrt_torch import assets
    from ttrt_torch.mesh.scene import many_sphere_scene

    port = many_sphere_scene(assets.load_skybox("colors", device="cpu"),
                             10_000, 48, 28, seed=seed, dtype=F32,
                             device="cpu")
    ref = many.build({"n_spheres": 10_000, "seed": seed}, dtype=F32,
                     device="cpu")
    for a, b in [(ref.spheres.center, port.spheres.center),
                 (ref.spheres.color, port.spheres.material.color)]:
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ref.spheres.radius, port.spheres.radius)
    assert torch.equal(ref.spheres.reflectivity,
                       port.spheres.material.reflectivity)
    tri = port.triangles
    rows = torch.stack([*tri.v0, *tri.e1, *tri.e2], dim=-1)
    assert torch.equal(ref.tri_rows, rows)


def test_orbit_camera_equals_the_port():
    from ttrt_torch.frames import orbit_camera_frame

    for t in (0.0, 1.5, 87.3):
        port = orbit_camera_frame(t, dtype=F32, device="cpu")
        ref = camera.orbit_camera(t, 480, 280, dtype=F32, device="cpu")
        assert torch.equal(ref.basis, port.basis)
        assert torch.equal(ref.origin, port.origin)


def test_counts_of_a_tiny_frame_equal_a_hand_count():
    """One ray straight down onto the ground from (0, 0, 5): a trace and
    a shadow ray for each of the 2 lights; the mirror ray goes straight
    up and misses: one trace. 4 traces. The bound of 4 traces on one
    pixel: 4 x (6 x 19 + 14) = 512 operations, 4 x (17 + 54 + 16 + 6 +
    7) + 16 = 416 bytes, so the bytes bound it."""
    scene = demo.build(CFG, dtype=F32, device="cpu")
    def t(*v):
        return Vec3(*(torch.tensor([x], dtype=F32) for x in v))

    color, traces = raytrace.trace_rays(scene, SKY,
                                        t(0.0, 0.0, 5.0), t(0.0, -1.0, 0.0),
                                        10)
    assert traces == 4
    assert _roofline.demo_bound_ms(traces, 1) == pytest.approx(
        1e3 * 416 / 3.35e12, rel=1e-12)
    assert _roofline.pathtrace_ops((3, 2, 1), 6, 1, 1) == (
        3 * (20 + 6 * 20) + 2 * (35 + 23 + 61) + 1 * 10
        + 1 * (6 * 21 + 14) + 1 * 14 + 129)


def test_ansi_decoder_reads_the_port_encoders_and_refuses_bad_bytes():
    from ttrt_torch import native
    from ttrt_torch.term.encoder import encode_ansi_host

    rgb = np.random.default_rng(1).integers(0, 256, (7, 11, 3), np.uint8)
    encoded = [encode_ansi_host(rgb)]
    if native.available:
        encoded.append(bytes(native.NativeAnsiEncoder(7, 11).encode(rgb)))
    for b in encoded:
        assert np.array_equal(ansi.decode(b, 11, 7), rgb)
    b = bytearray(encoded[0])
    for bad in (bytes(b[:-1]), bytes(b[:9]) + b"9" + bytes(b[10:]),
                bytes(b).replace(b"\033[0m", b"\033[1m", 1)):
        with pytest.raises(ansi.MalformedFrame):
            ansi.decode(bad, 11, 7)
    # a channel of 999 is three digits, but no u8
    b[6 + 7:6 + 10] = b"999"
    with pytest.raises(ansi.MalformedFrame):
        ansi.decode(bytes(b), 11, 7)
