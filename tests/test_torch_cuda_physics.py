"""The physics step kernel (``csrc/physics.cu::physics_step_kernel``) on
the card.

The kernel steps a world in one launch: one block, a thread a body and a
thread a GJK pair, the substeps in a loop inside it. After every frame its
state's 7 leaves equal those of the eager step (``physics_step_plain``) on
the card bit for bit (``chip_smoke.physics_kernel_case``): 600 frames of
the demo drop (4 substeps), 300 of tests/test_physics.py's two spheres
head-on (``chip_smoke.physics_world``) and 300 of a pile of 2 and of 10
spheres (``chip_smoke.physics_pile``: 1 and 45 pairs, one and two warps),
each with touching pairs. ``physics_step`` routes a world the kernel takes
to it and counts the step in ``profiling.PHYSICS_STEPS``; obstacles,
bfloat16 and the CPU go to the eager step. Marked ``cuda``; each test skips
without a CUDA device. Run on the card without the repository's conftest
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_physics.py
"""

import pytest
import torch

import chip_smoke
from ttrt_torch.kernels import physics as kphysics
from ttrt_torch.physics import world
from ttrt_torch.utils import profiling
from ttrt_torch.vec import Vec3

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _world(name, device):
    if name.startswith("pile"):
        return chip_smoke.physics_pile(int(name[4:]), device)
    return chip_smoke.physics_world(name, device)


@pytest.mark.parametrize("name,frames", [("demo", 600), ("head-on", 300),
                                         ("pile2", 300), ("pile10", 300)])
def test_kernel_equals_eager_step_every_frame(cuda, name, frames):
    stats = chip_smoke.physics_kernel_case(*_world(name, cuda), frames)
    assert stats["first_mismatch"] is None, stats
    assert stats["touching_frames"] > 0, stats  # the contact path ran


def test_physics_step_routes_to_the_kernel(cuda):
    state, params, dt, substeps = _world("demo", cuda)
    profiling.PHYSICS_STEPS.reset()
    launches = kphysics.physics_step_cuda.launches
    out = world.physics_step(state, params, dt, substeps)
    assert (profiling.PHYSICS_STEPS.kernel,
            profiling.PHYSICS_STEPS.eager) == (1, 0)
    assert kphysics.physics_step_cuda.launches == launches + 1
    plain = world.physics_step_plain(state, params, dt, substeps)
    assert torch.equal(chip_smoke.physics_bits(out),
                       chip_smoke.physics_bits(plain))
    # the 7 leaves as the eager step returns them
    shapes = [x.shape for x in (*out.pos, *out.vel, out.t)]
    assert shapes == [(6,)] * 6 + [()]


def _bfloat16(state, params):
    """The world in bfloat16, as the benchmark's upper control steps it."""
    def cast(x):
        return x.to(torch.bfloat16)

    return (world.PhysicsState(Vec3(*map(cast, state.pos)),
                               Vec3(*map(cast, state.vel)), cast(state.t)),
            params._replace(radius=cast(params.radius),
                            inv_mass=cast(params.inv_mass),
                            gravity=cast(params.gravity),
                            restitution=cast(params.restitution),
                            ground_y=cast(params.ground_y),
                            bounds=cast(params.bounds)))


def test_physics_step_falls_back_to_the_eager_step(cuda):
    state, params, dt, substeps = _world("demo", cuda)
    box = world.box_obstacle([0.0, -1.0, 0.0], [1.0, 0.5, 1.0])
    worlds = {
        "obstacles": (state, params._replace(
            obstacles=torch.as_tensor(box, device=cuda))),
        "bfloat16": _bfloat16(state, params),
        "cpu": _world("demo", torch.device("cpu"))[:2],
    }
    for name, (s, p) in worlds.items():
        assert not kphysics.takes(s, p), name
        profiling.PHYSICS_STEPS.reset()
        launches = kphysics.physics_step_cuda.launches
        world.physics_step(s, p, dt, substeps)
        assert (profiling.PHYSICS_STEPS.kernel,
                profiling.PHYSICS_STEPS.eager) == (0, 1), name
        assert kphysics.physics_step_cuda.launches == launches, name
        with pytest.raises(ValueError):
            kphysics.physics_step_cuda(s, p, dt, substeps)


def test_block_sizing(cuda):
    """A thread a body and one a pair, in whole warps, one block; a world
    beyond one block goes to the eager step. The kernel keeps within its
    launch bound's 64 registers."""
    for n, threads in ((1, 32), (2, 32), (6, 32), (10, 64), (45, 992)):
        shape = kphysics.physics_layout(n)
        assert shape["threads_per_block"] == threads, (n, shape)
        assert shape["blocks"] == 1 and shape["registers"] <= 64, shape
    assert kphysics.fits(45) and not kphysics.fits(46)
    with pytest.raises(RuntimeError):
        kphysics.physics_layout(46)
    big = world.default_params([0.1] * 46, device=cuda)
    state = chip_smoke.physics_pile(46, cuda)[0]
    assert not kphysics.takes(state, big)


def test_run_physics_steps_every_frame_through_the_kernel(cuda):
    """The main path (``run_physics``, as ``--scene physics`` runs it):
    every frame's step is one launch of the kernel."""
    import io

    from ttrt_torch import app
    from ttrt_torch.config import RenderConfig

    cfg = RenderConfig(width=48, height=20, rays_per_pixel=2,
                       bounce_limit=3, frame_rate=1e9)
    launches = kphysics.physics_step_cuda.launches
    app.run_physics(cfg, "colors", 12, interactive=False, device=cuda,
                    stream=io.BytesIO())
    torch.cuda.synchronize()
    steps = profiling.PHYSICS_STEPS
    assert (steps.kernel, steps.eager) == (12, 0), vars(steps)
    assert kphysics.physics_step_cuda.launches == launches + 12
