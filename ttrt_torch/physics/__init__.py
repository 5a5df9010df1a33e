"""The physics tier (port of ``ttrt.physics``): batched GJK collision
queries and rigid-body stepping of the sphere world, each frame rendered
by the port's renderer."""

from ttrt_torch.physics.gjk import (gjk_distance, polytope_support,
                                    sphere_support)
from ttrt_torch.physics.world import (PhysicsParams, PhysicsState,
                                      physics_step, physics_step_plain)
