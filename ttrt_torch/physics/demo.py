"""Physics-tier demo: the six demo spheres dropped under gravity with GJK
contacts, rendered by the same scene and render stack (port of
``ttrt.physics.demo``).

JAX fuses a frame's physics substeps, render and encode into one jitted
program. Here the frame step runs the substeps through ``physics_step``
(on the card one launch of the physics step kernel, on the CPU the eager
step), then renders through the port's renderer (on the card the render
kernel, which packs the moved spheres every frame).

The state is explicit (``PhysicsState``), so checkpoint and resume are an
``np.savez`` round trip of its seven leaves in JAX's pytree order; a
checkpoint of either package resumes in the other.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ttrt_torch.config import RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.physics.world import (PhysicsParams, PhysicsState,
                                      default_params, physics_step)
from ttrt_torch.scene import Scene
from ttrt_torch.vec import Vec3, scalar_like

SUBSTEPS = 4  # physics substeps a frame


def build_physics_demo(scene: Scene) -> Tuple[PhysicsState, PhysicsParams]:
    """Start from the demo scene's sphere ring, lifted and given a small
    tangential kick so that the drop breaks symmetry; in the scene's dtype
    and on its device."""
    c = scene.spheres.center
    radius = scene.spheres.radius
    pos = Vec3(c.x * 2.0, c.y * 1.5 + 3.0, c.z * 2.0)
    # tangential kick: v = (z, 0, -x) * 0.8
    vel = Vec3(c.z * 0.8, torch.zeros_like(c.y), -c.x * 0.8)
    state = PhysicsState(pos=pos, vel=vel, t=torch.zeros_like(radius[0]))
    params = default_params(radius, dtype=radius.dtype, device=radius.device,
                            ground_y=-2.0, restitution=0.8, bounds=4.0)
    return state, params


def physics_camera(state: PhysicsState, cfg: RenderConfig,
                   cam_offset: torch.Tensor):
    """The frame's camera: the demo's orbit at 0.3 x the sim time, its
    origin pushed out 3x, plus the arrow keys' offset."""
    t = state.t * scalar_like(0.3, state.t)
    frame = orbit_camera_frame(t, dtype=cfg.dtype, device=t.device)
    return frame._replace(
        origin=frame.origin * scalar_like(3.0, frame.origin) + cam_offset)


def build_physics_frame_step(scene: Scene, cfg: RenderConfig,
                             params: PhysicsParams, render_fn,
                             substeps: int = SUBSTEPS, timers=None):
    """(state, cam_offset) -> (new state, framebuffer, trace count): the
    frame's physics substeps, then the scene with its sphere centres at the
    state's positions rendered by ``render_fn`` (a ``(scene, cfg,
    count_rays=...)`` renderer). ``timers`` (a ``StageTimers``) times the
    physics as its stage 'physics'."""
    dt = torch.tensor(cfg.frame_duration, dtype=cfg.dtype,
                      device=scene.spheres.radius.device)

    def frame_step(state: PhysicsState, cam_offset: torch.Tensor,
                   count_rays: bool = False):
        if timers is None:
            state = physics_step(state, params, dt, substeps)
        else:
            with timers.stage("physics"):
                state = physics_step(state, params, dt, substeps)
        s = scene._replace(
            spheres=scene.spheres._replace(center=state.pos)
        ).with_camera_frame(physics_camera(state, cfg, cam_offset))
        fb, rays = render_fn(s, cfg, count_rays=count_rays)
        return state, fb, rays

    return frame_step


def physics_state_from_numpy(leaves: Sequence[np.ndarray], *,
                             dtype: torch.dtype, device) -> PhysicsState:
    """A state from its seven leaves (pos.x, pos.y, pos.z, vel.x, vel.y,
    vel.z, t: the JAX pytree's flatten order) as numpy arrays."""
    if len(leaves) != 7:
        raise ValueError(f"a physics state has 7 leaves, got {len(leaves)}")
    t = [torch.as_tensor(np.array(l), dtype=dtype, device=device)
         for l in leaves]
    return PhysicsState(pos=Vec3(*t[:3]), vel=Vec3(*t[3:6]), t=t[6])


def _ckpt_path(path: str) -> str:
    """np.savez appends '.npz' when it is missing; normalize, so that save
    and load agree on the file (a bare '--checkpoint state.ckpt' must round
    trip)."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: PhysicsState) -> None:
    leaves = [*state.pos, *state.vel, state.t]
    np.savez(_ckpt_path(path), *[l.cpu().numpy() for l in leaves])


def load_checkpoint(path: str, like: PhysicsState) -> Optional[PhysicsState]:
    """The state saved at ``path`` in ``like``'s dtype and on its device,
    or None when there is no such file."""
    path = _ckpt_path(path)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        leaves = [data[k] for k in data.files]
    return physics_state_from_numpy(leaves, dtype=like.t.dtype,
                                    device=like.t.device)
