"""Trace dispatch: scene type -> batched trace function (port of
``ttrt.render.dispatch``).

The integrator and the lighting are generic over the scene: the demo
``Scene`` traces the linear object scan (``render.intersect.trace_ray``),
a ``MeshScene`` the many-object tracer (``mesh.scene.trace_ray_mesh``).
Both return the same ``Hit`` record. Scene modules register at import.
"""

from __future__ import annotations

from typing import Callable, Dict

_TRACE_FNS: Dict[type, Callable] = {}


def register_trace(scene_type: type, fn: Callable) -> None:
    _TRACE_FNS[scene_type] = fn


def trace(scene, o, d, *, sample_sky: bool = True, bilinear: bool = False):
    """Trace a ray batch against ``scene`` with its registered tracer."""
    fn = _TRACE_FNS.get(type(scene))
    if fn is None:
        # the registrations are import side effects of the scene modules
        import ttrt_torch.mesh.scene  # noqa: F401
        import ttrt_torch.render.intersect  # noqa: F401

        fn = _TRACE_FNS.get(type(scene))
    if fn is None:
        raise TypeError(
            f"no trace function registered for scene type {type(scene)!r}")
    return fn(scene, o, d, sample_sky=sample_sky, bilinear=bilinear)
