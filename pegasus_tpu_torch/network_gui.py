"""SIBR remote-viewer TCP protocol (Inria ``network_gui`` wire format).

Port of ``pegasus_tpu/network_gui.py``.  The socket half (``init``,
``try_connect``, ``_recv_exact``, ``read``, ``send``, ``serve_frame``,
``close``) is the reference's code; the camera decode builds this
package's ``Camera`` on the caller's device, and the viewer renders with
``ops.rasterize_cuda.rasterize`` (the forward kernel on the card) where the
reference renders with its golden compositor.

  client -> server:  4-byte little-endian length, then a JSON object with
      resolution_x/y, train, fov_x/fov_y, z_near/z_far, shs_python,
      rot_scale_python, keep_alive, scaling_modifier, view_matrix (16),
      view_projection_matrix (16);
  server -> client:  raw H*W*3 uint8 image bytes (row-major RGB), then
      4-byte little-endian length + ascii "verify" string (the model
      path in the reference).

Module-level API mirrors the reference: ``init``, ``try_connect``,
``receive``, ``send`` and the module global ``conn``.  ``request_message``
is the client side's encoding of a camera (the inverse of
``camera_from_message``).  The serving loops drop a connection only on the
socket and protocol errors of ``PROTOCOL_ERRORS``; an error of the render
propagates (the reference drops the connection on any exception).
``z_near`` / ``z_far`` fill the ``Camera``'s ``znear`` / ``zfar``, which
the projection does not read, as in the reference.
"""

from __future__ import annotations

import json
import socket
import time
from typing import Optional, Tuple

import numpy as np
import torch

from pegasus_tpu_torch.device import DEFAULT_DEVICE

host = "127.0.0.1"
port = 6009
conn: Optional[socket.socket] = None
addr = None
listener: Optional[socket.socket] = None

# what a dropped or garbled connection raises: the socket's own errors
# (socket.timeout, BlockingIOError and ConnectionError are OSErrors), and
# a message that is not the protocol's JSON or lacks a key (ValueError
# covers json.JSONDecodeError and UnicodeDecodeError)
PROTOCOL_ERRORS = (OSError, ValueError, KeyError)


def init(wish_host: str = "127.0.0.1", wish_port: int = 6009) -> None:
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def try_connect() -> None:
    global conn, addr
    if listener is None:
        return
    try:
        conn, addr = listener.accept()
        conn.settimeout(None)
    except (BlockingIOError, socket.timeout, OSError):
        pass


def _recv_exact(n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed")
        buf += chunk
    return buf


def read() -> dict:
    n = int.from_bytes(_recv_exact(4), "little")
    return json.loads(_recv_exact(n).decode("utf-8"))


def send(message_bytes: Optional[bytes], verify: str) -> None:
    if message_bytes is not None:
        conn.sendall(message_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def camera_from_message(message: dict, device=DEFAULT_DEVICE):
    """Decode the SIBR camera: view_matrix is the transposed W2C with
    columns 1,2 sign-flipped (the Inria MiniCam convention)."""
    from pegasus_tpu_torch.camera import Camera

    V = np.asarray(message["view_matrix"], np.float32).reshape(4, 4)
    V[:, 1] = -V[:, 1]
    V[:, 2] = -V[:, 2]
    W2C = V.T  # rows [R_w2c | t]
    return Camera.create(
        W2C[:3, :3], W2C[:3, 3], float(message["fov_x"]), float(message["fov_y"]),
        int(message["resolution_x"]), int(message["resolution_y"]), device=device,
    ).replace(znear=float(message.get("z_near", 0.01)), zfar=float(message.get("z_far", 100.0)))


def request_message(cam=None, train: bool = False, keep_alive: bool = True,
                    scaling_modifier: float = 1.0) -> bytes:
    """A client's request for ``cam`` (None: no camera, resolution 0),
    length prefix included: what a SIBR viewer sends."""
    w = h = 0
    view = np.eye(4, dtype=np.float32)
    fovx = fovy = 1.0
    znear, zfar = 0.01, 100.0
    if cam is not None:
        W2C = np.eye(4, dtype=np.float32)
        W2C[:3, :3] = cam.R_w2c.cpu().numpy()
        W2C[:3, 3] = cam.t_w2c.cpu().numpy()
        view = W2C.T.copy()
        view[:, 1] = -view[:, 1]
        view[:, 2] = -view[:, 2]
        w, h, fovx, fovy = cam.width, cam.height, cam.fovx, cam.fovy
        znear, zfar = cam.znear, cam.zfar
    msg = {
        "resolution_x": w, "resolution_y": h, "train": train,
        "fov_x": fovx, "fov_y": fovy, "z_near": znear, "z_far": zfar,
        "shs_python": False, "rot_scale_python": False, "keep_alive": keep_alive,
        "scaling_modifier": scaling_modifier,
        "view_matrix": [float(v) for v in view.flatten()],
        "view_projection_matrix": [float(v) for v in np.eye(4).flatten()],
    }
    payload = json.dumps(msg).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload


def receive(device=DEFAULT_DEVICE) -> Tuple[object, bool, bool, bool, bool, float]:
    """(custom_cam, do_training, shs_python, rot_scale_python, keep_alive,
    scaling_modifier) — the reference's 6-tuple; the camera lies on
    ``device``."""
    message = read()
    width = message["resolution_x"]
    height = message["resolution_y"]
    custom_cam = None
    if width != 0 and height != 0:
        custom_cam = camera_from_message(message, device=device)
    return (
        custom_cam,
        bool(message.get("train", False)),
        bool(message.get("shs_python", False)),
        bool(message.get("rot_scale_python", False)),
        bool(message.get("keep_alive", True)),
        float(message.get("scaling_modifier", 1.0)),
    )


def frame_bytes(rgb: torch.Tensor) -> bytes:
    """[H, W, 3] float colour in [0, 1] -> the wire's uint8 RGB bytes
    (clipped, then truncated, as the reference's ``astype`` does)."""
    return (torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy().tobytes()


def serve_frame(rgb01: np.ndarray, verify: str = "pegasus_tpu") -> None:
    """Send one rendered frame ([H, W, 3] float 0..1 or uint8)."""
    img = np.asarray(rgb01)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    send(np.ascontiguousarray(img).tobytes(), verify)


def close() -> None:
    global conn, listener
    if conn is not None:
        try:
            conn.close()
        except OSError:
            pass
        conn = None
    if listener is not None:
        try:
            listener.close()
        except OSError:
            pass
        listener = None


def gaussian_splatting_viewer(
    ply_path: str,
    ip: str = "127.0.0.1",
    port_: int = 6009,
    max_frames: Optional[int] = None,
    background=(0.0, 0.0, 0.0),
    device=DEFAULT_DEVICE,
) -> int:
    """Serve one GS ply to a SIBR remote viewer over the wire protocol
    (reference: src/gs/gs_viewer.py:22-87), rendering each request with
    ``rasterize`` on ``device``.  Returns frames served."""
    global conn

    from pegasus_tpu_torch.gs.ply import load_gs_ply
    from pegasus_tpu_torch.ops.rasterize_cuda import rasterize

    cloud = load_gs_ply(ply_path, device=device)
    k = int(cloud.object_id.max()) + 1 if cloud.num_splats else 1
    init(ip, port_)
    served = 0
    try:
        while max_frames is None or served < max_frames:
            if conn is None:
                try_connect()
                if conn is None:
                    time.sleep(0.001)
                continue
            try:
                cam, _, _, _, keep_alive, scaling = receive(cloud.device)
            except PROTOCOL_ERRORS:
                conn = None
                continue
            img_bytes = None
            if cam is not None:
                out = rasterize(cloud, cam, background=background,
                                scaling_modifier=scaling, max_objects=k)
                img_bytes = frame_bytes(out.rgb)
                served += 1
            try:
                send(img_bytes, str(ply_path))
            except PROTOCOL_ERRORS:
                conn = None
                continue
            if not keep_alive:
                break
    finally:
        close()
    return served
