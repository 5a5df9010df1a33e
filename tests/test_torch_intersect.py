"""The eager integrator's building blocks against the JAX package on the
CPU: the demo scene's ``trace_ray``, ``sample_skybox`` and ``skybox_uv``
(nearest and bilinear, float32 and float64) and the trace dispatch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_torch_golden import SKY_DIM
from test_torch_integrator import _np, _scenes
from ttrt.assets import make_uv_checker_skybox, skybox_from_faces
from ttrt.render.intersect import trace_ray as jax_trace_ray
from ttrt.render.skybox import sample_skybox as jax_sample_skybox
from ttrt.render.skybox import skybox_uv as jax_skybox_uv
from ttrt.vec import Vec3 as JVec3

from ttrt_torch.render import dispatch
from ttrt_torch.render.intersect import trace_ray
from ttrt_torch.render.skybox import sample_skybox, skybox_uv
from ttrt_torch.scene import Skybox
from ttrt_torch.vec import Vec3

torch.set_num_threads(1)  # the test workers share the cores


def test_trace_ray_matches_jax_f64():
    js, ts = _scenes("demo", torch.float64)
    rng = np.random.default_rng(21)
    o = rng.uniform(-3, 3, (4096, 3))
    d = rng.normal(size=(4096, 3))
    hj = jax_trace_ray(js, JVec3(*(jnp.asarray(o[:, i]) for i in range(3))),
                       JVec3(*(jnp.asarray(d[:, i]) for i in range(3))))
    ht = trace_ray(ts, Vec3(*(torch.from_numpy(o[:, i]) for i in range(3))),
                   Vec3(*(torch.from_numpy(d[:, i]) for i in range(3))))
    kind = ht.kind.numpy()
    np.testing.assert_array_equal(kind, np.asarray(hj.kind))
    assert len(set(kind.tolist())) == 3  # misses, spheres and the ground
    for a, b in ((ht.point, hj.point), (ht.normal, hj.normal),
                 (ht.material.color, hj.material.color)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-13)
    np.testing.assert_allclose(ht.material.reflectivity.numpy(),
                               np.asarray(hj.material.reflectivity), atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bilinear", [False, True])
def test_sample_skybox_matches_jax(dtype, bilinear):
    """Nearest and bilinear texels of an image cubemap (the uv_checker
    faces, no procedural tag), as a plain gather."""
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    faces = make_uv_checker_skybox(SKY_DIM)
    jsky = skybox_from_faces(faces, jd)
    tsky = Skybox(torch.as_tensor(np.asarray(jsky.packed).astype(np.int32)),
                  None)
    rng = np.random.default_rng(33)
    d = rng.normal(size=(8192, 3)).astype(np.float64 if jd == jnp.float64
                                          else np.float32)
    jdir = JVec3(*(jnp.asarray(d[:, i]) for i in range(3)))
    tdir = Vec3(*(torch.from_numpy(np.ascontiguousarray(d[:, i]))
                  for i in range(3)))
    want = _np(jax_sample_skybox(jsky, jdir, bilinear=bilinear))
    got = _np(sample_skybox(tsky, tdir, bilinear=bilinear))
    assert got.dtype == want.dtype
    tol = 1e-12 if jd == jnp.float64 else 2e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    face_j, u_j, v_j = jax_skybox_uv(jdir)
    face_t, u_t, v_t = skybox_uv(tdir)
    np.testing.assert_array_equal(face_t.numpy(), np.asarray(face_j))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=tol)


def test_dispatch_refuses_unknown_scene_types():
    with pytest.raises(TypeError, match="no trace function"):
        dispatch.trace(object(), None, None)
