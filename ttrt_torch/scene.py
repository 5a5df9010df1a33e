"""Scene model: struct-of-arrays containers for spheres, plane, lights,
camera and skybox (port of ``ttrt.scene``).

Mirrors the reference's scene structs (TerminalRayTracer.c:60-208) as
batched tensors: N spheres are ``(N,)`` component tensors. Every builder
takes an explicit ``dtype`` and ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ttrt_torch.frames import Frame
from ttrt_torch.vec import Vec3


# Hit-kind tags (ObjectType enum, TerminalRayTracer.c:61-67).
HIT_NONE = 0
HIT_SPHERE = 1
HIT_GROUND = 2
HIT_TRIANGLE = 3  # extension: the triangle mesh of the many-object tier


def _vec3(x, y, z, *, dtype, device) -> Vec3:
    return Vec3(*(torch.tensor(v, dtype=dtype, device=device) for v in (x, y, z)))


class Materials(NamedTuple):
    """Batch of materials (Material struct, TerminalRayTracer.c:113-119).
    ``specularity`` feeds only the optional Blinn-Phong term."""

    color: Vec3
    reflectivity: torch.Tensor
    specularity: torch.Tensor

    @staticmethod
    def create(colors, reflectivity, specularity=100.0, *, dtype,
               device) -> "Materials":
        colors = torch.as_tensor(np.asarray(colors), dtype=dtype, device=device)
        n = colors.shape[:-1]
        full = lambda v: torch.as_tensor(  # noqa: E731
            np.asarray(v), dtype=dtype, device=device).expand(n).clone()
        return Materials(Vec3.from_array(colors), full(reflectivity),
                         full(specularity))

    def take(self, idx: torch.Tensor) -> "Materials":
        """Per-ray materials gathered by object index."""
        return Materials(Vec3(*(c[idx] for c in self.color)),
                         self.reflectivity[idx], self.specularity[idx])


class Spheres(NamedTuple):
    """SoA sphere batch (Sphere struct, TerminalRayTracer.c:160-166)."""

    center: Vec3  # each component (N,)
    radius: torch.Tensor  # (N,)
    material: Materials  # each leaf (N,)

    @property
    def count(self) -> int:
        return self.radius.shape[-1]

    @staticmethod
    def create(centers, radii, colors, reflectivity, specularity=100.0, *,
               dtype, device) -> "Spheres":
        centers = torch.as_tensor(np.asarray(centers), dtype=dtype,
                                  device=device)
        radius = torch.as_tensor(np.asarray(radii), dtype=dtype,
                                 device=device).expand(centers.shape[:-1])
        return Spheres(
            center=Vec3.from_array(centers),
            radius=radius.clone(),
            material=Materials.create(colors, reflectivity, specularity,
                                      dtype=dtype, device=device),
        )


class Plane(NamedTuple):
    """Checkerboard ground plane (Plane struct, TerminalRayTracer.c:168-175)."""

    point: Vec3  # 0-dim components
    normal: Vec3
    even_material: Materials  # 0-dim leaves
    odd_material: Materials


class DirectionalLights(NamedTuple):
    """SoA directional lights (TerminalRayTracer.c:145-150)."""

    direction: Vec3  # (L,)
    color: Vec3

    @property
    def count(self) -> int:
        return self.direction.x.shape[-1]


class PointLights(NamedTuple):
    """SoA point lights with inverse-square falloff
    (TerminalRayTracer.c:152-158)."""

    position: Vec3  # (L,)
    color: Vec3
    intensity: torch.Tensor

    @property
    def count(self) -> int:
        return self.intensity.shape[-1]


class Camera(NamedTuple):
    """Pinhole camera: pose frame + screen geometry (Camera struct,
    TerminalRayTracer.c:177-184; defaults TerminalRayTracer.c:298-305:
    screen 1 m away, world size 5*(W/H) x 5 m)."""

    frame: Frame
    screen_distance: torch.Tensor
    screen_width: torch.Tensor
    screen_height: torch.Tensor

    @staticmethod
    def default(width_px: int, height_px: int, *, dtype,
                device) -> "Camera":
        s = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
        return Camera(
            frame=Frame.identity(dtype=dtype, device=device),
            screen_distance=s(1.0),
            screen_width=s(5.0 * width_px / height_px),
            screen_height=s(5.0),
        )


@dataclasses.dataclass(frozen=True)
class Skybox:
    """Cubemap skybox (Skybox struct, TerminalRayTracer.c:129-135): the six
    faces as one ``(6, dim, dim)`` int32 tensor of packed 0x00RRGGBB texels,
    face order +X,-X,+Y,-Y,+Z,-Z (TerminalRayTracer.c:132).

    ``procedural`` names the generator that produced the texels
    ('colors', 'uv_checker') or is None for image data. The render kernel
    evaluates a named pattern in place of a texel fetch, bit-identical to
    the stored texels."""

    packed: torch.Tensor
    procedural: Optional[str] = None

    @property
    def dim(self) -> int:
        return self.packed.shape[-1]


class Scene(NamedTuple):
    """Root aggregate (Scene struct, TerminalRayTracer.c:195-208)."""

    spheres: Spheres
    ground: Plane
    directional_lights: DirectionalLights
    point_lights: PointLights
    camera: Camera
    skybox: Skybox

    def with_camera_frame(self, frame: Frame) -> "Scene":
        return self._replace(camera=self.camera._replace(frame=frame))


GROUND_EVEN_COLOR = (1.0, 1.0, 1.0)  # TerminalRayTracer.c:88
GROUND_ODD_COLOR = (1.0, 0.0, 0.0)  # TerminalRayTracer.c:89


def demo_scene(skybox: Skybox, width_px: int = 480, height_px: int = 280, *,
               dtype: torch.dtype, device) -> Scene:
    """The hard-coded demo: 6 axis spheres, checker ground, one directional
    + one point light (TerminalRayTracer.c:1256-1306)."""
    spheres = Spheres.create(
        centers=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                 [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
        radii=np.full((6,), 0.5),
        colors=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                [0.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 0.0]],
        reflectivity=[1.0, 0.8, 0.8, 0.8, 0.8, 0.8],
        specularity=100.0,
        dtype=dtype, device=device,
    )
    kw = dict(dtype=dtype, device=device)
    ground = Plane(
        point=_vec3(0.0, -2.0, 0.0, **kw),
        normal=_vec3(0.0, 1.0, 0.0, **kw),
        even_material=Materials.create(GROUND_EVEN_COLOR, 0.2, 100.0, **kw),
        odd_material=Materials.create(GROUND_ODD_COLOR, 0.2, 100.0, **kw),
    )
    rows = lambda v: Vec3.from_array(torch.tensor([v], **kw))  # noqa: E731
    return Scene(
        spheres=spheres,
        ground=ground,
        directional_lights=DirectionalLights(
            direction=rows([-1.0, -1.0, -1.0]), color=rows([1.0, 1.0, 1.0])),
        point_lights=PointLights(
            position=rows([0.0, 0.0, 0.0]), color=rows([1.0, 1.0, 1.0]),
            intensity=torch.tensor([10.0], **kw)),
        camera=Camera.default(width_px, height_px, **kw),
        skybox=skybox,
    )


def scene_from_numpy(arrays: Mapping[str, np.ndarray],
                     procedural: Optional[str], *, device,
                     dtype: torch.dtype) -> Scene:
    """Build a Scene from numpy leaves keyed by field path
    (``"spheres.center.x"``, ``"camera.frame.basis"``, ``"skybox.packed"``,
    ...), the layout of the JAX package's ``Scene`` pytree. This carries a
    scene, camera pose included, from the JAX package into the port. Leaves
    of a ``MeshScene`` (``"triangles.v0.x"``, ...; no grid, no pack) give a
    ``ttrt_torch.mesh.MeshScene`` with the port's own cluster pack."""

    def t(key):
        return torch.as_tensor(np.array(arrays[key]), dtype=dtype,
                               device=device)

    def v3(prefix):
        return Vec3(t(prefix + ".x"), t(prefix + ".y"), t(prefix + ".z"))

    def mat(prefix):
        return Materials(v3(prefix + ".color"), t(prefix + ".reflectivity"),
                         t(prefix + ".specularity"))

    packed = np.asarray(arrays["skybox.packed"]).astype(np.int32)
    common = dict(
        spheres=Spheres(v3("spheres.center"), t("spheres.radius"),
                        mat("spheres.material")),
        directional_lights=DirectionalLights(
            v3("directional_lights.direction"),
            v3("directional_lights.color")),
        point_lights=PointLights(v3("point_lights.position"),
                                 v3("point_lights.color"),
                                 t("point_lights.intensity")),
        camera=Camera(
            Frame(t("camera.frame.basis"), t("camera.frame.origin")),
            t("camera.screen_distance"), t("camera.screen_width"),
            t("camera.screen_height")),
        skybox=Skybox(torch.as_tensor(packed, device=device), procedural),
    )
    if "triangles.v0.x" not in arrays:
        return Scene(ground=Plane(v3("ground.point"), v3("ground.normal"),
                                  mat("ground.even_material"),
                                  mat("ground.odd_material")), **common)
    # a MeshScene: the port builds its own cluster pack from the leaves
    from ttrt_torch.mesh.clusters import pack_clusters
    from ttrt_torch.mesh.scene import MeshScene
    from ttrt_torch.mesh.triangles import Triangles

    tris = Triangles(v3("triangles.v0"), v3("triangles.e1"),
                     v3("triangles.e2"), v3("triangles.normal"),
                     mat("triangles.material"))
    return MeshScene(triangles=tris, grid=None,
                     clusters=pack_clusters(common["spheres"], tris),
                     **common)
