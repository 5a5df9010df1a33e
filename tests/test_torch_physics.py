"""The port's GJK distance queries (``ttrt_torch.physics.gjk``) and world
parameters against the JAX package on the CPU.

``gjk_distance`` matches JAX's in float64 within 1e-12 on the cases of
tests/test_physics.py (separated and penetrating spheres, a random batch
of sphere pairs, boxes apart, corner to corner and overlapping, a sphere
above a box), and its two loop ends (stop once every lane has converged,
or run all MAX_ITERS masked iterations) give the same bits.
``default_params`` equals JAX's bit for bit. ``--scene physics`` asked
for the card on a machine without one ends in one error line.
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

from ttrt.physics import gjk as jgjk
from ttrt.physics import world as jworld
from ttrt.vec import Vec3 as JVec3

from ttrt_torch.physics import gjk, world
from ttrt_torch.vec import Vec3

torch.set_num_threads(1)  # the test workers share the cores

TOL = 1e-12


def _box(center, half):
    return world.box_obstacle(center, half)[0]  # (8, 3)


def _cases():
    rng = np.random.default_rng(7)
    n = 64
    ca, cb = rng.uniform(-3, 3, (2, n, 3))
    ra, rb = rng.uniform(0.1, 1.0, (2, n))
    sph = lambda c, r: ("sphere", np.asarray(c, np.float64),  # noqa: E731
                        np.asarray(r, np.float64))
    box = lambda c, h: ("box", _box(c, h)[None])  # noqa: E731
    return {
        "separated": (sph([[0, 0, 0]], [1.0]), sph([[5, 0, 0]], [1.5]),
                      [[-5.0, 0, 0]]),
        "penetrating": (sph([[0, 0, 0]], [1.0]), sph([[1, 0, 0]], [1.0]),
                        [[-1.0, 0, 0]]),
        "batch": (sph(ca, ra), sph(cb, rb), ca - cb),
        "boxes apart": (box([0, 0, 0], [1, 1, 1]), box([4, 0, 0], [1, 1, 1]),
                        [[-4.0, 0, 0]]),
        "boxes corner": (box([0, 0, 0], [1, 1, 1]),
                         box([3, 3, 3], [1, 1, 1]), [[-1.0, -1, -1]]),
        "boxes overlap": (box([0, 0, 0], [1, 1, 1]),
                          box([1, 0, 0], [1, 1, 1]), [[-1.0, 0, 0]]),
        "sphere on box": (sph([[0, 5, 0]], [1.0]), box([0, 0, 0], [2, 2, 2]),
                          [[0, 5.0, 0]]),
    }


def _jax_support(body):
    if body[0] == "sphere":
        c = jnp.asarray(body[1], jnp.float64)
        return jgjk.sphere_support(JVec3.from_array(c),
                                   jnp.asarray(body[2], jnp.float64))
    return jgjk.polytope_support(jnp.asarray(body[1], jnp.float64))


def _torch_support(body):
    if body[0] == "sphere":
        c = torch.as_tensor(body[1], dtype=torch.float64)
        return gjk.sphere_support(Vec3.from_array(c),
                                  torch.as_tensor(body[2],
                                                  dtype=torch.float64))
    return gjk.polytope_support(torch.as_tensor(body[1],
                                                dtype=torch.float64))


@pytest.mark.parametrize("name", list(_cases()))
def test_gjk_distance_matches_jax_f64(name):
    a, b, x0 = _cases()[name]
    x0 = np.asarray(x0, np.float64)
    jd, jn = jax.jit(lambda x: jgjk.gjk_distance(
        _jax_support(a), _jax_support(b), JVec3.from_array(x)))(
            jnp.asarray(x0))
    tx0 = Vec3.from_array(torch.as_tensor(x0))
    d, n = gjk.gjk_distance(_torch_support(a), _torch_support(b), tx0)
    assert d.dtype == torch.float64
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=TOL)
    np.testing.assert_allclose(n.to_array().numpy(),
                               np.asarray(jn.to_array()), rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_default_params_bit_for_bit(dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    radii = [0.5, 0.3, 0.7, 0.45]
    obst = np.concatenate([world.box_obstacle([0, 0, 0], [1, 1, 1]),
                           world.box_obstacle([2, 0.5, -1], [0.3, 2, 0.7])])
    np.testing.assert_array_equal(
        obst, np.concatenate([jworld.box_obstacle([0, 0, 0], [1, 1, 1]),
                              jworld.box_obstacle([2, 0.5, -1],
                                                  [0.3, 2, 0.7])]))
    want = jworld.default_params(radii, dtype=jd, ground_y=-1.5,
                                 restitution=0.7, bounds=4.0, obstacles=obst)
    got = world.default_params(radii, dtype=dtype, device="cpu",
                               ground_y=-1.5, restitution=0.7, bounds=4.0,
                               obstacles=obst)
    for field in world.PhysicsParams._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def test_cli_scene_physics_without_a_card_exits_with_one_error_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "ttrt_torch", "--scene",
                           "physics", "--frames", "1", "--no-input"],
                          cwd=repo, env=env, capture_output=True,
                          timeout=120)
    assert proc.returncode == 1 and proc.stdout == b""
    lines = proc.stderr.decode().strip().splitlines()
    assert len(lines) == 1 and "no CUDA device" in lines[0], lines
