"""The path-tracing kernel module (``ttrt_torch.kernels.pathtrace``) and
the bilinear procedural sky on the CPU: the counter-based RNG and the
frame seed bit for bit against JAX, the light packing and the kernel's
gates, the plain version against JAX's kernel (``pathtrace_frame_pallas``
in interpret mode, live at 3 bounces and through the stored 10-bounce
golden), the bilinear sky bit for bit against JAX's, and the demo kernel's
plain version with ``--bilinear`` against JAX ``render_frame``.

The plain version draws the JAX kernel's random stream draw for draw, so
it is held to JAX's kernel ray by ray, not only statistically. The two
differ where XLA's approximate ``rsqrt`` and its own fused multiply-adds
round a ray's direction differently; a knife edge then sends the ray
elsewhere. The bar is ``chip_smoke.pathtrace_bar`` (PATHTRACE_BAR there):
at most PT_SHARE = 2% of the pixels differ by more than PT_TOL = 1e-5 in a
channel, and the image means agree within 1e-3. Measured on the CPU
(``tests/pathtrace_gap.py``): at 16x8, 2 spp, 3 bounces no pixel differs
by more than 2.3e-6 (t = 0.7) and 1.5e-6 (t = 3.3); on the 64x32, 4 spp,
10-bounce golden 3 and 7 of 2048 pixels differ by more than 1e-5 (t = 0.7
and 3.3), by up to 0.27.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from knife_util import assert_quantized_exact_off_knife
from make_torch_golden import (PT_GOLDEN_PATH, jax_area_lights,
                               jax_frame_seed, jax_scene, scene_leaves)
from ttrt.assets import make_uv_checker_skybox
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.kernels import pathtrace_pallas as jpt
from ttrt.kernels import render_pallas
from ttrt.render.integrator import render_frame as jax_render_frame

from ttrt_torch.app import make_scene
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import pathtrace, render
from ttrt_torch.render.pathtrace import AreaLights
from ttrt_torch.scene import Skybox, scene_from_numpy

torch.set_num_threads(1)  # the test workers share the cores

def _torch_scene(js, procedural="colors"):
    return scene_from_numpy(scene_leaves(js), procedural, device="cpu",
                            dtype=torch.float32)


def _torch_lights(jl):
    return AreaLights.from_numpy(scene_leaves(jl), dtype=torch.float32,
                                 device="cpu")


def test_mix32_and_u01_are_jax_bit_for_bit():
    x = np.random.default_rng(11).integers(0, 1 << 32, 4096, dtype=np.uint64)
    want_h = np.asarray(jpt._mix32(jnp.asarray(x, jnp.uint32)))
    want_u = np.asarray(jpt._u01(jnp.asarray(want_h)))
    h = pathtrace.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(h.numpy(), want_h.astype(np.int64))
    u = pathtrace.u01(h)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), want_u)
    assert pathtrace.mix32(int(x[0])) == int(want_h[0])


def test_frame_seed_is_the_jax_apps():
    """t = 0.251: float32 gives int(t * 1000) = 250, float64 251."""
    assert int(np.float64(0.251) * 1000.0) == 251
    assert int(np.float32(0.251) * np.float32(1000.0)) == 250
    for seed, t in [(0, 0.0), (0, 0.7), (0, 3.3), (0, 0.251), (7, 1.234),
                    (123, 59.9), (2 ** 31 - 1, 0.001), (5, 1234.5678)]:
        assert pathtrace.frame_seed(seed, t) == jax_frame_seed(seed, t), (
            seed, t)
    assert pathtrace.frame_seed(0, 0.7) == 700


def test_area_light_packing_and_kernel_gates():
    jl = jax_area_lights()
    tl = _torch_lights(jl)
    np.testing.assert_array_equal(
        pathtrace.pack_area_lights(tl).numpy(),
        np.asarray(jpt.pack_area_lights(jl, jnp.float32)))
    ts = _torch_scene(jax_scene(0.7, 8, 4))
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    pathtrace.check_supported(ts, tl, cfg)
    eleven = AreaLights.create(np.zeros((11, 3)), np.ones(11),
                               np.ones((11, 3)), np.ones(11),
                               dtype=torch.float32, device="cpu")
    image_sky = ts._replace(skybox=Skybox(ts.skybox.packed, None))
    mesh = make_scene("many", cfg, "colors", device="cpu", n_spheres=20)
    pathtrace.check_supported(mesh, tl, cfg)
    for scene, lights, c, match in [
            (ts, tl, cfg.with_(dtype=torch.float64), "float32"),
            (ts, tl, cfg.with_(bounce_limit=11), "bounce_limit <= 10"),
            (ts, eleven, cfg, "<= 10 area lights"),
            (image_sky, tl, cfg, "procedural sky"),
            (mesh._replace(clusters=None), tl, cfg, "cluster pack")]:
        with pytest.raises(ConfigError, match=match):
            pathtrace.pathtrace_frame(scene, lights, c, 0)
    before = pathtrace.pathtrace_frame_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        pathtrace.pathtrace_frame_cuda(ts, tl, cfg, 0)
    assert pathtrace.pathtrace_frame_cuda.launches == before


def test_plain_matches_pallas_interpret():
    """16x8, 2 spp, 3 bounces: the plain version against JAX's kernel on
    the same scene, light and frame seed, through the bar; the work
    (nearest-hit traces, hits) the plain version counts is positive."""
    W, H, N, B = 16, 8, 2, 3
    js = jax_scene(0.7, W, H)
    jl = jax_area_lights()
    seed = jax_frame_seed(0, 0.7)
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=N,
                           bounce_limit=B, dtype=jnp.float32)
    ref = np.asarray(jpt.pathtrace_frame_pallas(
        js, jl, jcfg, seed, interpret=True).to_array())
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=N, bounce_limit=B)
    before = pathtrace.pathtrace_frame_plain.launches
    fb, work = pathtrace.pathtrace_frame(_torch_scene(js), _torch_lights(jl),
                                         cfg, seed)
    assert pathtrace.pathtrace_frame_plain.launches == before + 1
    out = fb.to_array().numpy()
    assert out.shape == (H, W, 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    stats = chip_smoke.pathtrace_bar(ref, out)
    assert stats["differ_px"] == 0, stats  # measured: max |d| 2.3e-6
    nearest, hits, unblocked = (int(v) for v in work)
    assert W * H * N <= nearest <= W * H * N * B and 0 < hits < nearest
    assert 0 < unblocked < hits  # one light: one NEE ray a hit


def test_plain_meets_stored_pathtrace_golden():
    """chip_smoke.py phase P2's check, run here with the plain version:
    the 10-bounce golden of tests/make_torch_golden.py, whose stored
    scenes must still be the JAX package's and whose seeds the port's
    ``frame_seed``."""
    with np.load(PT_GOLDEN_PATH) as g:
        W, H = (int(v) for v in g["config"][:2])
        for i, t in enumerate(g["times"]):
            prefix = f"scene{i}."
            leaves = {k[len(prefix):]: g[k] for k in g.files
                      if k.startswith(prefix)}
            for key, value in scene_leaves(jax_scene(t, W, H)).items():
                np.testing.assert_array_equal(leaves[key], value,
                                              err_msg=key)
            assert int(g[f"seed{i}"]) == pathtrace.frame_seed(0, float(t))
        for key, value in scene_leaves(jax_area_lights()).items():
            np.testing.assert_array_equal(g[f"lights.{key}"], value)
    stats = chip_smoke.check_pathtrace_golden(
        pathtrace.pathtrace_frame_plain, "cpu")
    assert len(stats) == 2 and max(s["share"] for s in stats) < 0.005


@pytest.mark.parametrize("kind", ["colors", "uv_checker"])
def test_bilinear_procedural_sky_is_jax_bit_for_bit(kind):
    """Random unit directions, some near face edges. The two normalizes
    round differently by design (XLA's rsqrt against the port's
    correctly rounded 1/sqrt and contracted dot), so the directions are
    those whose squared length is exactly 1 in both summation orders:
    both normalizes are then the identity, and the face, uv, taps and
    blend must agree bit for bit."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=(3, 16384))
    d[:, :256] = [[1.0], [1.0], [0.0]] + 1e-3 * d[:, :256]  # face edges
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    x, y, z = d
    plain = x * x + y * y + z * z
    fused = np.float32(np.float64(z) * z + np.float32(np.float64(x) * x
                                                      + np.float32(y * y)))
    d = d[:, (plain == 1.0) & (fused == 1.0)]
    assert d.shape[1] > 8192 and (np.abs(d[0] - d[1]) < 1e-2).sum() > 64
    want = render_pallas._sky_color_procedural_bilinear(
        *(jnp.asarray(c) for c in d), 16, kind)
    got = render.sky_color(
        *(torch.from_numpy(c) for c in d),
        Skybox(torch.zeros((6, 16, 16), dtype=torch.int32), kind), True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_demo_plain_bilinear_quantized_exact_off_knife():
    """The demo kernel's plain version with --bilinear on the uv_checker
    sky against JAX render_frame (whose sky is the bilinear gather of
    the stored texels), with the knife bar that JAX's own kernel meets
    on this frame (tests/test_pallas_kernel.py: t = 1.9, cap 0.27; a
    lerped sky has more perturbation-unstable pixels than nearest)."""
    W, H = 32, 16
    js = jax_scene(1.9, W, H, make_uv_checker_skybox, 16, "uv_checker")
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=2,
                           bounce_limit=10, dtype=jnp.float32,
                           skybox_bilinear=True)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=2, bounce_limit=10,
                       skybox_bilinear=True)
    fb, rays = render.render_frame(_torch_scene(js, "uv_checker"), cfg)
    nearest, _ = render.render_frame(_torch_scene(js, "uv_checker"),
                                     cfg.with_(skybox_bilinear=False))
    out = fb.to_array().numpy()
    assert np.abs(out - nearest.to_array().numpy()).max() > 1e-3
    assert_quantized_exact_off_knife(
        np.asarray(fb_ref.to_array()), out, js, jcfg, 0.27,
        rays_ref=rays_ref, rays_pal=int(rays))

