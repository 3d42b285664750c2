"""The preview videos' worker thread (``scene/video.py::VideoStreams``).

The streams make and encode every frame on one worker thread of their
own; the caller only hands frames over.  Each case holds the five mp4s,
decoded with ``cv2.VideoCapture``, frame for frame equal to streams that
the test encodes on its own thread with the arithmetic the frames were
made with when the caller encoded them itself (written out below); an
error on the worker surfaces from ``close``; the queue of waiting frames
never holds more than its bound.  Numpy and cv2 only, on the CPU.
"""

import functools
import threading
import time

import cv2
import numpy as np
import pytest

from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.pegasus import _video_frame
from pegasus_tpu_torch.scene.video import VideoStreams, depth_mm_to_u8, draw_object_centers

W, H, FPS = 64, 48, 10
CHUNK = 8
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]])
COLORS = np.array([[1.0, 0.2, 0.1], [0.1, 0.9, 0.4], [0.3, 0.3, 1.0]])


def frames(n: int, seed: int = 7):
    """n frames as the chunk loop hands them over: rgb, depth_mm (uint16),
    the semantic image (uint8), the camera and two object centres."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        depth_mm = rng.integers(0, 8000, (H, W), dtype=np.uint16)
        sem_u8 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        angle = 0.1 * i
        R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]])
        t = np.array([0.0, 0.0, 3.0])
        centers = rng.uniform(-0.5, 0.5, (2, 3))
        yield rgb, depth_mm, sem_u8, centers, R, t


def encode_here(path, items) -> None:
    """The frames encoded on this thread, as the chunk loop encoded them
    before the worker: the centre overlay, the semantic image through
    float, depth in metres, then the five streams' conversions."""
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writers = {name: cv2.VideoWriter(str(path / f"{name}_video.mp4"), fourcc, FPS, (W, H))
               for name in VideoStreams.STREAMS}
    for rgb, depth_mm, sem_u8, centers, R, t in items:
        center_image = draw_object_centers(rgb, centers, K, R, t, COLORS)
        seg = sem_u8.astype(np.float32) / 255.0
        depth = depth_mm.astype(np.float32) / 1000.0
        seg_u8 = (np.ascontiguousarray(seg) * 255).astype(np.uint8)
        writers["rgb"].write(cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        overlay = cv2.addWeighted(rgb, 1.0, seg_u8, 0.5, 0)
        writers["rgb_seg"].write(cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
        writers["object_center"].write(cv2.cvtColor(center_image, cv2.COLOR_RGB2BGR))
        writers["seg"].write(cv2.cvtColor(seg_u8, cv2.COLOR_RGB2BGR))
        d8 = np.floor(np.clip(depth / 5.0, 0, 1) * 255).astype(np.uint8)
        writers["depth"].write(cv2.cvtColor(d8, cv2.COLOR_GRAY2BGR))
    for w in writers.values():
        w.release()


def decoded(path) -> list:
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


@pytest.mark.parametrize("route", ["submit", "write_frame"])
@pytest.mark.parametrize("n_frames", [2 * CHUNK, 3 * CHUNK - 3])
def test_worker_streams_equal_streams_encoded_here(route, n_frames, tmp_path):
    """Every decoded frame of every stream equals this thread's encoding.
    ``submit`` is the chunk loop's route (the worker makes the frame);
    ``write_frame`` hands over ready frames from buffers the caller
    overwrites as soon as the call returns."""
    items = list(frames(n_frames))
    streams = VideoStreams(str(tmp_path / "worker"), W, H, fps=FPS)
    if route == "submit":
        for rgb, depth_mm, sem_u8, centers, R, t in items:
            streams.submit(functools.partial(_video_frame, rgb, depth_mm, sem_u8, centers, K, R, t,
                                             COLORS))
    else:
        buffers = [np.empty((H, W, 3), np.uint8), np.empty((H, W), np.float32),
                   np.empty((H, W, 3), np.float32), np.empty((H, W, 3), np.uint8)]
        for rgb, depth_mm, sem_u8, centers, R, t in items:
            buffers[0][:] = rgb
            buffers[1][:] = depth_mm.astype(np.float32) / 1000.0
            buffers[2][:] = sem_u8.astype(np.float32) / 255.0
            buffers[3][:] = draw_object_centers(rgb, centers, K, R, t, COLORS)
            streams.write_frame(rgb=buffers[0], depth=buffers[1], seg=buffers[2],
                                center_image=buffers[3])
            for b in buffers:  # the caller reuses its buffers at once
                b.fill(0)
    streams.close()
    assert streams.frames == n_frames
    (tmp_path / "here").mkdir()
    encode_here(tmp_path / "here", items)
    for name in VideoStreams.STREAMS:
        got = decoded(tmp_path / "worker" / f"{name}_video.mp4")
        want = decoded(tmp_path / "here" / f"{name}_video.mp4")
        assert len(got) == len(want) == n_frames, name
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w), (name, i)


def test_the_chunk_loops_planes_are_the_float_arithmetics_bytes():
    """The chunk loop hands the worker the semantic image and depth's
    8-bit plane as bytes: the bytes of the float arithmetic written out in
    ``encode_here``, for every uint8 and every uint16 millimetre value."""
    x = np.arange(256, dtype=np.uint8)
    assert np.array_equal((np.ascontiguousarray(x.astype(np.float32) / 255.0) * 255).astype(np.uint8), x)
    mm = np.arange(1 << 16, dtype=np.uint16)
    for distance in (5.0, 2.5):
        want = np.floor(np.clip((mm.astype(np.float32) / 1000.0) / distance, 0, 1) * 255).astype(np.uint8)
        got = depth_mm_to_u8(mm.reshape(256, 256), distance)
        assert got.dtype == np.uint8 and np.array_equal(got.reshape(-1), want), distance


def test_the_workers_error_surfaces_from_close(tmp_path):
    """The frames before the error are written; the error is raised on the
    caller's thread by the next hand-over and by ``close``."""
    streams = VideoStreams(str(tmp_path), W, H, fps=FPS)
    items = list(frames(5))
    for rgb, depth_mm, sem_u8, centers, R, t in items[:3]:
        streams.submit(functools.partial(_video_frame, rgb, depth_mm, sem_u8, centers, K, R, t,
                                         COLORS))

    def broken():
        raise ValueError("the frame could not be made")

    streams.submit(broken)
    deadline = time.monotonic() + 30
    while streams._error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(ValueError, match="could not be made"):
        streams.write_frame(rgb=items[3][0])
    with pytest.raises(ValueError, match="could not be made"):
        streams.close()
    assert not streams._worker.is_alive()
    for name in VideoStreams.STREAMS:
        assert len(decoded(tmp_path / f"{name}_video.mp4")) == 3, name


def test_the_queue_never_holds_more_than_its_bound(tmp_path):
    """With the worker held, a caller that hands over more frames than the
    bound blocks once the queue is full; the blocked time is counted, and
    every frame is written once the worker goes on."""
    bound = VideoStreams.QUEUE_FRAMES
    assert bound == 2 * GenerationConfig().frame_chunk
    streams = VideoStreams(str(tmp_path), W, H, fps=FPS)
    gate, handed, sizes = threading.Event(), [], []
    rgb = next(frames(1))[0]

    def held():
        gate.wait()
        return {"rgb": rgb}

    def caller():
        for i in range(3 * bound):
            streams.submit(held)
            handed.append(i)

    thread = threading.Thread(target=caller)
    thread.start()
    deadline = time.monotonic() + 30
    while len(handed) < bound + 1 and time.monotonic() < deadline:
        sizes.append(streams._queue.qsize())
        time.sleep(0.005)
    time.sleep(0.2)
    sizes.append(streams._queue.qsize())
    # one frame in the worker's hands, the bound's worth waiting, the caller blocked
    assert len(handed) == bound + 1 and thread.is_alive()
    assert max(sizes) == bound
    gate.set()
    thread.join(30)
    assert not thread.is_alive()
    streams.close()
    assert len(handed) == streams.frames == 3 * bound
    assert streams.wait_s > 0.1
    assert len(decoded(tmp_path / "rgb_video.mp4")) == 3 * bound
