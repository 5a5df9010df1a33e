"""The eager Monte-Carlo estimator (``ttrt_torch.render.pathtrace``) on the
CPU, with the JAX package's own bars (tests/test_pathtrace.py and
tests/test_pathtrace_pallas.py:78-91): unit and cosine-distributed
samples, finite frames in [0, 1], the soft-shadow penumbra, and
statistical parity with JAX ``pathtrace_frame`` and with the port's own
path-tracing kernel (its plain version). The estimator draws from a
``torch.Generator`` and JAX from ``jax.random``, so the comparisons hold
means of many samples to Monte-Carlo error, not rays to rays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from make_torch_golden import jax_area_lights, jax_scene, scene_leaves
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.render.pathtrace import pathtrace_frame as jax_pathtrace_frame

from ttrt_torch import app
from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import pathtrace as kernel
from ttrt_torch.render import pathtrace as pt
from ttrt_torch.scene import scene_from_numpy
from ttrt_torch.vec import Vec3

torch.set_num_threads(1)  # the test workers share the cores

# JAX's statistical bars (tests/test_pathtrace_pallas.py:78-91): 64-sample
# means, image-wide within 0.01 and per pixel within 0.05 on average
IMAGE_MEAN_TOL = 0.01
PIXEL_MEAN_TOL = 0.05


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _setup(W=16, H=8, N=64, B=3, t=0.7, dtype=torch.float32):
    """The port's demo scene and light, carried across from JAX's, and the
    matching configs of both packages."""
    js = jax_scene(t, W, H)
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=N, bounce_limit=B,
                       dtype=dtype)
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=N,
                           bounce_limit=B, dtype=jnp.float32)
    scene = scene_from_numpy(scene_leaves(js), "colors", device="cpu",
                             dtype=dtype)
    lights = pt.AreaLights.from_numpy(scene_leaves(jax_area_lights()),
                                      dtype=dtype, device="cpu")
    return js, jcfg, scene, lights, cfg


def _stat_bar(ref: np.ndarray, out: np.ndarray) -> None:
    assert abs(ref.mean() - out.mean()) < IMAGE_MEAN_TOL, (ref.mean(),
                                                           out.mean())
    assert np.abs(ref - out).mean() < PIXEL_MEAN_TOL


def test_uniform_sphere_is_unit_and_covers():
    v = pt._uniform_sphere(_gen(1), torch.zeros(4096))
    np.testing.assert_allclose(v.length().numpy(), 1.0, atol=1e-5)
    for c in v:
        assert abs(float(c.mean())) < 0.06


def test_cosine_hemisphere_mean_cosine_is_two_thirds():
    n = Vec3(torch.zeros(4096), torch.ones(4096), torch.zeros(4096))
    cos = pt._cosine_hemisphere(_gen(2), n).dot(n).numpy()
    assert (cos >= -1e-6).all()
    assert abs(cos.mean() - 2.0 / 3.0) < 0.03


def test_frame_is_finite_in_range_and_follows_its_generator():
    _, _, scene, lights, cfg = _setup(W=24, H=12, N=8, B=4)
    fb1 = pt.pathtrace_frame(scene, lights, cfg, _gen(0))
    a1 = fb1.to_array().numpy()
    assert a1.shape == (12, 24, 3) and a1.dtype == np.float32
    assert np.isfinite(a1).all() and a1.min() >= 0 and a1.max() <= 1
    np.testing.assert_array_equal(
        pt.pathtrace_frame(scene, lights, cfg, _gen(0)).to_array().numpy(),
        a1)
    a2 = pt.pathtrace_frame(scene, lights, cfg, _gen(1)).to_array().numpy()
    assert not np.array_equal(a1, a2)
    assert abs(a1.mean() - a2.mean()) < 0.02
    # 'sum' is the unclipped sum of the same samples
    s = pt.pathtrace_frame(scene, lights, cfg, _gen(0), reduce="sum")
    np.testing.assert_allclose(
        np.clip(s.to_array().numpy() / cfg.rays_per_pixel, 0, 1), a1,
        rtol=1e-5, atol=1e-6)


def test_soft_shadow_penumbra():
    """tests/test_pathtrace.py's soft-shadow check: the demo's +y sphere
    (center (0, 1, 0), r = 0.5) shades the floor point (0.9, -2, 0) from a
    light at (0, 4, 0). A near-point light leaves it dark; a radius-1
    area light lets light into the penumbra."""
    _, _, scene, _, _ = _setup()
    n = 1024
    p = Vec3(torch.full((n,), 0.9), torch.full((n,), -2.0 + 1e-3),
             torch.zeros(n))
    up = Vec3(torch.zeros(n), torch.ones(n), torch.zeros(n))
    albedo = Vec3(*(torch.ones(n) for _ in range(3)))

    def mean_lum(radius):
        lights = pt.AreaLights.create([[0.0, 4.0, 0.0]], [radius],
                                      [[1.0, 1.0, 1.0]], [1e6],
                                      dtype=torch.float32, device="cpu")
        out = pt._direct_light(scene, lights, _gen(11), p, up, albedo)
        return float(out.x.mean())

    hard, soft = mean_lum(0.02), mean_lum(1.0)
    assert hard < 0.05
    assert soft > hard + 0.05


def test_statistical_parity_with_jax_estimator():
    """16x8, 64 spp, 3 bounces against JAX ``pathtrace_frame``."""
    js, jcfg, scene, lights, cfg = _setup()
    ref = np.asarray(jax_pathtrace_frame(js, jax_area_lights(), jcfg,
                                         jax.random.PRNGKey(3)).to_array())
    out = pt.pathtrace_frame(scene, lights, cfg, _gen(3)).to_array().numpy()
    _stat_bar(ref, out)


def test_statistical_parity_with_the_kernels_plain_version():
    """The same bar against the path-tracing kernel's plain version, the
    estimator the card runs: one estimator, two random streams."""
    _, _, scene, lights, cfg = _setup()
    ref, _ = kernel.pathtrace_frame_plain(scene, lights, cfg,
                                          kernel.frame_seed(3, 0.7))
    out = pt.pathtrace_frame(scene, lights, cfg, _gen(3))
    _stat_bar(ref.to_array().numpy(), out.to_array().numpy())


def test_float64_run():
    """Float64 throughout (the ``--f64`` route), against a float32 run of
    the same generator seed: means of 64 samples agree."""
    _, _, s64, l64, c64 = _setup(dtype=torch.float64)
    _, _, s32, l32, c32 = _setup()
    out = pt.pathtrace_frame(s64, l64, c64, _gen(5)).to_array().numpy()
    assert out.dtype == np.float64
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    ref = pt.pathtrace_frame(s32, l32, c32, _gen(5)).to_array().numpy()
    _stat_bar(ref, out)


def test_many_object_scene_traces_through_dispatch():
    """A ``MeshScene`` on the CPU: the estimator's traces go through
    ``render.dispatch`` to the dense tester, as JAX's do."""
    cfg = RenderConfig(width=12, height=6, rays_per_pixel=4, bounce_limit=3)
    scene = app.make_scene("many", cfg, "colors", device="cpu",
                           n_spheres=64)
    fb = pt.pathtrace_frame(scene, pt.default_area_lights(cfg, "cpu"), cfg,
                            _gen(0)).to_array().numpy()
    assert fb.shape == (6, 12, 3)
    assert np.isfinite(fb).all() and fb.min() >= 0 and fb.max() <= 1
    assert fb.std() > 0
