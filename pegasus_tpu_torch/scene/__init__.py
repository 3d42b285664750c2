"""Scene composition, camera paths, recorded trajectories and preview video."""

from pegasus_tpu_torch.scene.composition import SceneTemplate, pose_scene
from pegasus_tpu_torch.scene.trajectory import Trajectory
