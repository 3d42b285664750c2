"""The drop simulation: heightfield ground, batched rigid-body stepper, engine and URDF files."""

from pegasus_tpu_torch.physics.rigid_body import (
    RigidBodyParams,
    RigidBodyState,
    simulate,
    step,
)
from pegasus_tpu_torch.physics.engine import PhysicsEngine
