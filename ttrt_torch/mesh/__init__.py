"""The many-object tier: spheres and a triangle-mesh floor, the uniform
grid, the Morton cluster pack and the dense tester (port of
``ttrt.mesh``)."""

from ttrt_torch.mesh.grid import UniformGrid, build_grid  # noqa: F401
from ttrt_torch.mesh.scene import MeshScene, many_sphere_scene  # noqa: F401
