"""Live sanity check on the PyTorch/CUDA port: spin an asset and watch the
SE(3) + SH rotation of ``GaussianCloud.transformed`` hold up.

The port's counterpart of ``examples/rotating_object.py`` (the reference's
rotating-object viewer loop, src/gs/gs_object_rotation.py:49-118, applying
Rz(0.05) per frame), rendering each frame with ``rasterize`` on the card and
writing an mp4 (needs cv2).

Usage:
  python examples/torch_rotating_object.py [point_cloud.ply] [out.mp4] [n_frames] [size]
"""

import sys

import numpy as np
import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.utils.pose import rotate_z


def main(ply_path=None, out="rotating_object.mp4", n_frames: int = 126, size: int = 480,
         device="cuda"):
    """Write the mp4; returns the frames as one uint8 array [F, H, W, 3]."""
    import cv2

    if ply_path:
        from pegasus_tpu_torch.gs.ply import load_gs_ply

        cloud = load_gs_ply(ply_path, device=device)
    else:
        from pegasus_tpu_torch.testing import make_box_cloud

        cloud = make_box_cloud(np.random.default_rng(0), n=2000, device=device)
    cloud = cloud.with_object_id(0)

    center = cloud.centroid().cpu().numpy()
    spread = np.linalg.norm(cloud.xyz.cpu().numpy() - center, axis=1)
    radius = float(np.quantile(spread, 0.95)) * 3.5
    cam = Camera.look_at(eye=center + np.array([radius, 0, radius * 0.5]), target=center,
                         up=(0, 0, 1), fovx=np.deg2rad(50), fovy=np.deg2rad(50), width=size,
                         height=size, device=device)
    writer = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), 20, (size, size))
    R = rotate_z(0.05)  # the reference's per-frame increment
    frames = []
    with torch.no_grad():
        for _ in range(n_frames):  # 126 = a full revolution
            rgb = rasterize(cloud, cam, background=(1.0, 1.0, 1.0), max_objects=1).rgb
            frame = torch.clamp(rgb * 255, 0, 255).to(torch.uint8).cpu().numpy()
            writer.write(frame[:, :, ::-1])
            frames.append(frame)
            cloud = cloud.transformed(R, np.zeros(3))
    writer.release()
    return np.stack(frames)


if __name__ == "__main__":
    args = sys.argv[1:]
    out = args[1] if len(args) > 1 else "rotating_object.mp4"
    main(args[0] if args else None, out, int(args[2]) if len(args) > 2 else 126,
         int(args[3]) if len(args) > 3 else 480)
    print(f"wrote {out}")
