"""Preview video streams (rgb / seg / overlay / depth / object-center).

Mirror of the reference's five cv2.VideoWriter streams
(reference: src/gs/pegasus_setup.py:262-306), as in
``pegasus_tpu/scene/video.py``, except that the frames are encoded on one
worker thread of the streams' own.  The caller only hands a frame over;
the worker makes and encodes it, so the caller's thread (the generation
chunk loop, which issues the device's launches) spends no time on the
videos.  Host-side only.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
import time
from typing import Callable

import numpy as np


class VideoStreams:
    """The five streams, written by one worker thread in the order the
    frames were handed over.

    ``write_frame`` hands over copies of ready frames (the reference's
    call); ``submit`` hands over a callable that the worker calls to make
    the frame's keywords (``write_frame``'s, or 8-bit ``seg_u8`` and
    ``depth_u8`` planes in place of ``seg`` and ``depth``), so a caller can
    leave the frame's making to the worker too.  At most ``QUEUE_FRAMES`` frames wait: a caller that
    hands over more blocks until the worker has taken one.  ``close``
    writes the frames still waiting, joins the worker, releases the
    writers and re-raises the worker's first error on the caller's thread;
    after an error the worker writes nothing more, and the next
    ``write_frame`` or ``submit`` raises it.

    Counters: ``frames`` handed over, ``wait_s`` blocked on a full queue,
    ``drain_s`` that ``close`` waited for the frames still waiting.
    """

    STREAMS = ("rgb", "object_center", "seg", "rgb_seg", "depth")
    QUEUE_FRAMES = 16  # two chunks at the default frame_chunk of 8 (about 3 MB a 640x480 frame)

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
        self.frames = 0
        self.wait_s = 0.0
        self.drain_s = 0.0
        self._error: Exception | None = None
        self._queue: queue.Queue = queue.Queue(maxsize=self.QUEUE_FRAMES)
        self._worker = threading.Thread(target=self._work, name="video-streams", daemon=True)
        self._worker.start()

    def write_frame(
        self,
        rgb: np.ndarray | None = None,  # [H,W,3] uint8 RGB
        depth: np.ndarray | None = None,  # [H,W] float meters
        seg: np.ndarray | None = None,  # [H,W,3] float [0,1]
        center_image: np.ndarray | None = None,  # [H,W,3] uint8
        max_distance_in_meter: float = 5.0,
    ) -> None:
        """Hand over one frame: copies of the arrays, so the caller may
        reuse its buffers once this returns."""
        frame = {
            k: None if v is None else np.array(v)
            for k, v in (("rgb", rgb), ("depth", depth), ("seg", seg), ("center_image", center_image))
        }
        self.submit(lambda: dict(frame, max_distance_in_meter=max_distance_in_meter))

    def submit(self, make_frame: Callable[[], dict]) -> None:
        """Hand over one frame as ``make_frame``, which the worker calls for
        ``write_frame``'s keywords.  Whatever it reads must not change
        until the worker has written the frame: nothing it holds may
        alias a buffer the caller reuses."""
        if self._error is not None:
            raise self._error
        try:
            self._queue.put_nowait(make_frame)
        except queue.Full:
            t0 = time.perf_counter()
            self._queue.put(make_frame)
            self.wait_s += time.perf_counter() - t0
        self.frames += 1

    def _work(self) -> None:
        while True:
            make_frame = self._queue.get()
            if make_frame is None:
                return
            if self._error is None:
                try:
                    self._encode(**make_frame())
                except Exception as e:  # noqa: BLE001 — re-raised on the caller's thread
                    self._error = e

    def _encode(
        self,
        rgb: np.ndarray | None = None,
        depth: np.ndarray | None = None,
        seg: np.ndarray | None = None,
        center_image: np.ndarray | None = None,
        max_distance_in_meter: float = 5.0,
        seg_u8: np.ndarray | None = None,  # [H,W,3] uint8, in place of ``seg``
        depth_u8: np.ndarray | None = None,  # [H,W] uint8 ``depth_to_u8``, in place of ``depth``
    ) -> None:
        cv2 = self._cv2
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
            depth_u8 = depth_to_u8(depth, max_distance_in_meter)
        if depth_u8 is not None:
            self.writers["depth"].write(cv2.cvtColor(depth_u8, cv2.COLOR_GRAY2BGR))

    def close(self) -> None:
        """Write the frames still waiting, join the worker, release the
        writers; then re-raise the worker's error, if it had one."""
        t0 = time.perf_counter()
        self._queue.put(None)
        self._worker.join()
        self.drain_s += time.perf_counter() - t0
        for w in self.writers.values():
            w.release()
        if self._error is not None:
            raise self._error


def depth_to_u8(depth: np.ndarray, max_distance_in_meter: float = 5.0) -> np.ndarray:
    """The depth stream's 8-bit plane of depth in metres."""
    return np.floor(np.clip(depth / max_distance_in_meter, 0, 1) * 255).astype(np.uint8)


@functools.cache
def _depth_mm_table(max_distance_in_meter: float) -> np.ndarray:
    return depth_to_u8(np.arange(1 << 16).astype(np.float32) / 1000.0, max_distance_in_meter)


def depth_mm_to_u8(depth_mm: np.ndarray, max_distance_in_meter: float = 5.0) -> np.ndarray:
    """``depth_to_u8(depth_mm.astype(np.float32) / 1000)`` of uint16
    millimetres, the same bytes, as one lookup in a table of all 65,536."""
    return _depth_mm_table(max_distance_in_meter)[depth_mm]


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
