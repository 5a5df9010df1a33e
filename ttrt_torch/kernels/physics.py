"""The physics step kernel (``csrc/physics.cu::physics_step_kernel``): its
route and its CUDA wrapper.

The kernel steps the sphere world of ``physics/world.py`` by ``substeps``
substeps in one launch of one block: a thread a body and a thread a GJK
pair, the substeps in a loop inside the kernel. It equals the eager step,
``physics/world.py::physics_step_plain``, bit for bit, which is its plain
version. No TPU kernel stands behind it: JAX jits the step into its frame
program, where the eager port launched a few thousand one-element kernels
a frame.

``takes`` is the route: a float32 world on one CUDA device, without
obstacles, whose bodies and pairs fit one block. ``physics_step_cuda``
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ttrt_torch.vec import Vec3

MAX_THREADS = 1024  # a block's threads: one a body, one a pair
LAYOUT_KEYS = ("threads_per_block", "blocks", "registers", "local_bytes",
               "shared_bytes")


def fits(n: int) -> bool:
    """Whether ``n`` bodies and their n(n-1)/2 pairs fit one block."""
    return n >= 1 and max(n, n * (n - 1) // 2) <= MAX_THREADS


def _tensors(state, params) -> tuple:
    return (*state.pos, *state.vel, state.t, params.radius, params.inv_mass,
            params.gravity, params.restitution, params.ground_y,
            params.bounds)


def takes(state, params) -> bool:
    """Whether the kernel steps this world: every tensor of the state and
    the parameters float32 on the parameters' CUDA device, no obstacles,
    and the bodies fit one block."""
    device = params.radius.device
    return (device.type == "cuda" and params.obstacles is None
            and fits(params.radius.shape[0])
            and all(x.device == device and x.dtype == torch.float32
                    for x in _tensors(state, params)))


def physics_step_cuda(state, params, dt, substeps: int = 1):
    """``physics_step_plain(state, params, dt, substeps)`` in one launch of
    the physics step kernel on the current stream: a new state of 7 fresh
    tensors (views of one buffer), without a wait for the device. Raises
    on a world the kernel does not take (``takes``) or a shape it does not
    expect."""
    from ttrt_torch.kernels import build

    if not takes(state, params):
        raise ValueError("the physics step kernel takes a float32 world on "
                         "one CUDA device, without obstacles, of at most 45 "
                         "bodies")
    n = params.radius.shape[0]
    shapes = [x.shape for x in _tensors(state, params)]
    if shapes != [(n,)] * 6 + [()] + [(n,)] * 2 + [(3,)] + [()] * 3:
        raise ValueError(f"physics_step_cuda: unexpected shapes {shapes}")
    device = params.radius.device
    dt = torch.as_tensor(dt, dtype=torch.float32, device=device)
    ins = [x.contiguous() for x in (*_tensors(state, params), dt)]
    out = torch.empty(6 * n + 1, dtype=torch.float32, device=device)
    rc = build.load().ttrt_physics_step(
        *(x.data_ptr() for x in ins), n, int(substeps), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"physics step kernel launch failed: CUDA error {rc}")
    physics_step_cuda.launches += 1
    c = out[:6 * n].view(6, n)
    return state._replace(pos=Vec3(c[0], c[1], c[2]),
                          vel=Vec3(c[3], c[4], c[5]), t=out[6 * n])


physics_step_cuda.launches = 0


def physics_layout(n: int) -> dict:
    """The launch ``physics_step_cuda`` takes for ``n`` bodies
    (``ttrt_physics_layout``): threads a block (the bodies or the pairs,
    whichever are more, in whole warps), blocks (1), and the kernel's
    registers, local (spill) bytes a thread and static shared bytes. Needs
    a CUDA device."""
    import ctypes

    from ttrt_torch.kernels import build

    out = (ctypes.c_int * len(LAYOUT_KEYS))()
    rc = build.load().ttrt_physics_layout(n, out)
    if rc != 0:
        raise RuntimeError(f"ttrt_physics_layout failed: CUDA error {rc}")
    return dict(zip(LAYOUT_KEYS, out))
