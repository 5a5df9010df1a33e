"""JSON scene descriptions (port of ``ttrt.scenefile``).

A declarative scene file lets users compose scenes without code (the
reference hard-codes its scene in main(), TerminalRayTracer.c:1256-1306):

```json
{
  "skybox": "colors",
  "spheres": [
    {"center": [1, 0, 0], "radius": 0.5,
     "color": [1, 0, 0], "reflectivity": 1.0}
  ],
  "ground": {"y": -2.0, "even_color": [1, 1, 1],
             "odd_color": [1, 0, 0], "reflectivity": 0.2},
  "directional_lights": [
    {"direction": [-1, -1, -1], "color": [1, 1, 1]}
  ],
  "point_lights": [
    {"position": [0, 0, 0], "color": [1, 1, 1], "intensity": 10}
  ]
}
```

Every field has the demo default, so a partial file is valid. The sphere
and light fields are rounded to float32 before the cast to the scene's
dtype, the ground's are not, as in the JAX package. Values are assembled
in numpy and copied to the device once.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ttrt_torch import assets
from ttrt_torch.scene import (GROUND_EVEN_COLOR, GROUND_ODD_COLOR, Camera,
                              DirectionalLights, Materials, Plane,
                              PointLights, Scene, Spheres, _vec3)
from ttrt_torch.vec import Vec3


class SceneFileError(ValueError):
    """Malformed scene description."""


def _vec_field(obj, key, default, n=3):
    v = obj.get(key, default)
    a = np.asarray(v, np.float64)
    if a.shape != (n,):
        raise SceneFileError(f"{key!r} must have {n} components, got {v!r}")
    return a


def scene_from_dict(desc: dict, width_px: int, height_px: int, *,
                    dtype: torch.dtype = torch.float32,
                    device="cuda") -> Scene:
    """Build a Scene on ``device`` from a parsed description (see the
    module docstring)."""
    f32 = np.float32
    kw = dict(dtype=dtype, device=device)

    def v3(rows):  # (n, 3) -> Vec3 of (n,) tensors
        return Vec3(*(torch.as_tensor(rows[:, i], **kw) for i in range(3)))

    sph_list = desc.get("spheres", [])
    if not isinstance(sph_list, list) or not sph_list:
        raise SceneFileError("scene needs a non-empty 'spheres' list")
    centers = np.stack(
        [_vec_field(s, "center", None) for s in sph_list]).astype(f32)
    radii = np.asarray([float(s.get("radius", 0.5)) for s in sph_list], f32)
    colors = np.stack(
        [_vec_field(s, "color", [1.0, 1.0, 1.0]) for s in sph_list]
    ).astype(f32)
    refl = np.asarray(
        [float(s.get("reflectivity", 0.8)) for s in sph_list], f32)
    spec = np.asarray(
        [float(s.get("specularity", 100.0)) for s in sph_list], f32)
    spheres = Spheres(
        center=v3(centers),
        radius=torch.as_tensor(radii, **kw),
        material=Materials(color=v3(colors),
                           reflectivity=torch.as_tensor(refl, **kw),
                           specularity=torch.as_tensor(spec, **kw)),
    )

    g = desc.get("ground", {})
    ground = Plane(
        point=_vec3(0.0, float(g.get("y", -2.0)), 0.0, **kw),
        normal=_vec3(0.0, 1.0, 0.0, **kw),
        even_material=Materials.create(
            _vec_field(g, "even_color", list(GROUND_EVEN_COLOR)),
            float(g.get("reflectivity", 0.2)), 100.0, **kw),
        odd_material=Materials.create(
            _vec_field(g, "odd_color", list(GROUND_ODD_COLOR)),
            float(g.get("reflectivity", 0.2)), 100.0, **kw),
    )

    dls = desc.get(
        "directional_lights",
        [{"direction": [-1.0, -1.0, -1.0], "color": [1.0, 1.0, 1.0]}])
    if dls:
        ddirs = np.stack(
            [_vec_field(l, "direction", None) for l in dls]).astype(f32)
        dcols = np.stack(
            [_vec_field(l, "color", [1.0, 1.0, 1.0]) for l in dls]
        ).astype(f32)
    else:  # no lights: a black stand-in keeps the light tables non-empty
        ddirs = np.array([[-1.0, -1.0, -1.0]], f32)
        dcols = np.zeros((1, 3), f32)

    pls = desc.get(
        "point_lights",
        [{"position": [0.0, 0.0, 0.0], "color": [1.0, 1.0, 1.0],
          "intensity": 10.0}])
    if pls:
        ppos = np.stack(
            [_vec_field(l, "position", None) for l in pls]).astype(f32)
        pcols = np.stack(
            [_vec_field(l, "color", [1.0, 1.0, 1.0]) for l in pls]
        ).astype(f32)
        pint = np.asarray(
            [float(l.get("intensity", 10.0)) for l in pls], f32)
    else:
        ppos = np.zeros((1, 3), f32)
        pcols = np.zeros((1, 3), f32)
        pint = np.zeros((1,), f32)

    return Scene(
        spheres=spheres,
        ground=ground,
        directional_lights=DirectionalLights(direction=v3(ddirs),
                                             color=v3(dcols)),
        point_lights=PointLights(position=v3(ppos), color=v3(pcols),
                                 intensity=torch.as_tensor(pint, **kw)),
        camera=Camera.default(width_px, height_px, **kw),
        skybox=assets.load_skybox(desc.get("skybox", "colors"),
                                  device=device),
    )


def load_scene_file(path: str, width_px: int, height_px: int, *,
                    dtype: torch.dtype = torch.float32,
                    device="cuda") -> Scene:
    """Read and build the scene of a JSON file; a file that cannot be
    read or parsed raises ``SceneFileError``."""
    try:
        with open(path) as f:
            desc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SceneFileError(f"cannot read scene file {path}: {e}") from None
    if not isinstance(desc, dict):
        raise SceneFileError("scene file must contain a JSON object")
    return scene_from_dict(desc, width_px, height_px, dtype=dtype,
                           device=device)
