"""Copied verbatim from ``pegasus_tpu/scene/video.py``; only the import lines differ.

Preview video streams (rgb / seg / overlay / depth / object-center).

Mirror of the reference's five cv2.VideoWriter streams
(reference: src/gs/pegasus_setup.py:262-306).  Host-side only.
"""

from __future__ import annotations

import os

import numpy as np


class VideoStreams:
    STREAMS = ("rgb", "object_center", "seg", "rgb_seg", "depth")

    def __init__(self, output: str, width: int, height: int, fps: int = 10):
        import cv2

        os.makedirs(output, exist_ok=True)
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        size = (width, height)
        self._cv2 = cv2
        self.writers = {
            name: cv2.VideoWriter(
                os.path.join(output, f"{name}_video.mp4"), fourcc, fps, size
            )
            for name in self.STREAMS
        }

    def write_frame(
        self,
        rgb: np.ndarray | None = None,  # [H,W,3] uint8 RGB
        depth: np.ndarray | None = None,  # [H,W] float meters
        seg: np.ndarray | None = None,  # [H,W,3] float [0,1]
        center_image: np.ndarray | None = None,  # [H,W,3] uint8
        max_distance_in_meter: float = 5.0,
    ) -> None:
        cv2 = self._cv2
        seg_u8 = None
        if seg is not None:
            seg_u8 = (np.ascontiguousarray(seg) * 255).astype(np.uint8)
        if rgb is not None:
            self.writers["rgb"].write(cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
            if seg_u8 is not None:
                overlay = cv2.addWeighted(rgb, 1.0, seg_u8, 0.5, 0)
                self.writers["rgb_seg"].write(
                    cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR)
                )
        if center_image is not None:
            self.writers["object_center"].write(
                cv2.cvtColor(center_image, cv2.COLOR_RGB2BGR)
            )
        if seg_u8 is not None:
            self.writers["seg"].write(cv2.cvtColor(seg_u8, cv2.COLOR_RGB2BGR))
        if depth is not None:
            d8 = np.floor(
                np.clip(depth / max_distance_in_meter, 0, 1) * 255
            ).astype(np.uint8)
            self.writers["depth"].write(cv2.cvtColor(d8, cv2.COLOR_GRAY2BGR))

    def close(self) -> None:
        for w in self.writers.values():
            w.release()


def draw_object_centers(
    rgb: np.ndarray,
    centers_world: np.ndarray,  # [K, 3]
    K: np.ndarray,
    R_w2c: np.ndarray,
    t_w2c: np.ndarray,
    colors: np.ndarray,  # [K, 3] float [0,1]
    radius: int = 6,
) -> np.ndarray:
    """Debug overlay of projected object centers
    (reference: src/gs/pegasus_setup.py:228-260)."""
    import cv2

    img = rgb.copy()
    for k in range(len(centers_world)):
        p_cam = R_w2c @ centers_world[k] + t_w2c
        if p_cam[2] <= 1e-6:
            continue
        uv = K @ p_cam
        u, v = int(uv[0] / uv[2]), int(uv[1] / uv[2])
        color = tuple(int(c * 255) for c in colors[k % len(colors)])
        img = cv2.circle(img, (u, v), radius, color, -1)
    return img
