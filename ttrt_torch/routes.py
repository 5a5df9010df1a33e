"""The route of a frame: which code renders it, whether its step may be
captured as a CUDA graph, and what it counts (the JAX package's routing,
ttrt/app.py:73-80 and :190-266). ``pick`` decides once, before the first
frame, and refuses there a config that no route serves:

- an objects axis in the mesh (ray tracing): ``objects``, the eager
  integrator with the geometry sharded, for a cluster-packed float32
  ``MeshScene`` only;
- ``eager``, or ``auto`` in float64 or, path tracing, under an image
  cubemap (the kernels are procedural-sky only, as JAX's) or on a
  ``MeshScene`` over a mesh: ``eager`` (the integrator) or ``estimator``
  (the Monte-Carlo estimator);
- otherwise a kernel within its gates (``kernel`` asks for one; a path
  tracer's refusal points to ``--renderer eager``): ``pathtrace kernel``,
  ``fused kernel`` for a ``MeshScene``, ``demo kernel``.

Each route has a leaf on one device and one over a device mesh; a
kernel's leaf runs the CUDA kernel on CUDA tensors, its plain version on
CPU tensors.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import mesh_fused, render
from ttrt_torch.kernels import pathtrace as path_kernels
from ttrt_torch.mesh.scene import MeshScene
from ttrt_torch.parallel import mesh as pmesh
from ttrt_torch.parallel import objects, sharding
from ttrt_torch.render import integrator
from ttrt_torch.render import pathtrace as estimator
from ttrt_torch.utils.profiling import PATH_STEPS

RENDERERS = ("auto", "kernel", "eager")

# the routes a CUDA graph may hold, on one device: on CUDA tensors each
# dispatches to its kernel wrapper (render_frame_cuda,
# render_band_mesh_fused_cuda), which launches on torch's current stream
# through ctypes and reads no device value on the host. The integrator
# reads some, a mesh's ranks talk through collectives, and the path
# tracer's frame seed is a host value of each frame.
GRAPHABLE = ("demo kernel", "fused kernel")


class Route(NamedTuple):
    """A picked route. ``fn``: the ray-traced renderer, (scene, cfg, *,
    count_rays) -> (fb, rays); None for a path-traced route. ``frame``:
    (posed scene, t) -> fb, the frame at scene time t."""

    name: str
    fn: Optional[Callable]
    frame: Callable
    graphable: bool


def pick(scene, cfg: RenderConfig, renderer: str = "auto", *, mesh=None,
         pathtrace: bool = False, lights=None, seed: int = 0) -> Route:
    """The route of ``scene`` under ``cfg`` and ``renderer`` (one of
    ``RENDERERS``), over ``mesh`` when one is given. With ``pathtrace``:
    Monte-Carlo path tracing with ``lights`` (default: the demo's area
    light); each frame draws its own stream from ``seed`` and the scene
    time, a kernel with the JAX app's frame seed
    (``kernels.pathtrace.frame_seed``), the estimator with a generator
    seeded with it, and ``profiling.PATH_STEPS`` counts the frame."""
    device = scene.spheres.radius.device
    if pathtrace and lights is None:
        lights = estimator.default_area_lights(cfg, device)
    name = _choose(scene, cfg, renderer, mesh, pathtrace, lights)
    leaves = {  # route: (its leaf on one device, over a mesh)
        "eager": (integrator.render_frame, sharding.render_frame_sharded),
        "demo kernel": (render.render_frame,
                        sharding.render_frame_sharded_kernel),
        "fused kernel": (mesh_fused.render_frame_mesh_fused,
                         sharding.render_frame_sharded_mesh_fused),
        "objects": (None, objects.render_frame_sharded_objects),
        "pathtrace kernel": (path_kernels.pathtrace_frame,
                             sharding.pathtrace_frame_sharded_kernel),
        "estimator": (estimator.pathtrace_frame,
                      sharding.pathtrace_frame_sharded),
    }
    leaf = leaves[name][mesh is not None]
    if not pathtrace:
        fn = leaf if mesh is None else functools.partial(leaf, mesh=mesh)
        return Route(name, fn, lambda s, t: fn(s, cfg, count_rays=False)[0],
                     mesh is None and name in GRAPHABLE)
    if mesh is not None:
        def draw(s, fseed):
            return leaf(s, lights, cfg, fseed, mesh)
    elif name == "pathtrace kernel":
        def draw(s, fseed):
            return leaf(s, lights, cfg, fseed, count_rays=False)[0]
    else:
        def draw(s, fseed):
            return leaf(s, lights, cfg, frame_generator(fseed, device))
    counter = "kernel" if name == "pathtrace kernel" else "estimator"

    def frame(s, t):
        fseed = path_kernels.frame_seed(seed, t)
        PATH_STEPS.add(counter)
        return draw(s, fseed)

    return Route(name, None, frame, False)


def _choose(scene, cfg: RenderConfig, renderer: str, mesh, pathtrace: bool,
            lights) -> str:
    """``pick``'s decision (the module's docstring): the route's name, or
    a ConfigError. Over a mesh the height and spp must divide by its rows
    and samples (path tracing: the spp by its size, with no objects
    axis)."""
    if renderer not in RENDERERS:
        raise ConfigError(f"unknown renderer {renderer!r}")
    if mesh is not None and not pathtrace:
        sharding.check_mesh_divisible(cfg, mesh)
        if pmesh.OBJECTS in mesh.mesh_dim_names:
            if not (isinstance(scene, MeshScene)
                    and scene.clusters is not None):
                raise ConfigError(
                    "--mesh with an objects factor needs a cluster-packed "
                    "many-object scene (--scene many)")
            if cfg.dtype != torch.float32:
                raise ConfigError("--mesh with an objects factor traces "
                                  "through the float32 cluster_nearest: "
                                  "--f64 is refused with it")
            return "objects"
    many_over_mesh = mesh is not None and isinstance(scene, MeshScene)
    if renderer == "eager" or (renderer == "auto" and (
            cfg.dtype != torch.float32 or pathtrace and (
                many_over_mesh or scene.skybox.procedural is None))):
        check_f64_mesh_on_cpu(scene, cfg)
        name = "estimator" if pathtrace else "eager"
    elif pathtrace:
        try:
            if many_over_mesh:
                raise ConfigError("--pathtrace --mesh shards the demo "
                                  "scene's path-tracing kernel only")
            path_kernels.check_supported(scene, lights, cfg)
        except ConfigError as e:
            raise ConfigError(f"{e} (--renderer eager runs the Monte-Carlo "
                              "estimator)") from None
        name = "pathtrace kernel"
    elif isinstance(scene, MeshScene):
        mesh_fused.check_supported(scene, cfg)
        name = "fused kernel"
    else:
        render.check_supported(scene, cfg)
        name = "demo kernel"
    if pathtrace and mesh is not None:
        sharding.check_pathtrace_mesh(cfg, mesh)
    return name


def check_f64_mesh_on_cpu(scene, cfg: RenderConfig) -> None:
    """The eager routes trace a ``MeshScene`` on the card through the
    float32 ``cluster_nearest`` kernel: float64 needs the CPU (the JAX
    package traces it in float32 on an accelerator)."""
    if (isinstance(scene, MeshScene) and cfg.dtype != torch.float32
            and scene.spheres.radius.device.type != "cpu"):
        raise ConfigError("--f64 with --scene many needs --device cpu: "
                          "the card traces a MeshScene through the "
                          "float32 cluster_nearest kernel")


def frame_generator(seed: int, device) -> torch.Generator:
    """The eager estimator's random stream: a generator on ``device``."""
    return torch.Generator(device=device).manual_seed(seed & 0xFFFFFFFF)
