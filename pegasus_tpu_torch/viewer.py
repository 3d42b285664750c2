"""Viewers: turntable renderer + browser-based live viewer.

Port of ``pegasus_tpu/viewer.py``: ``orbit_cameras`` is the same code
(building this package's cameras on ``device``), and the renders go
through ``rasterize_fn`` when one is given, called as the reference calls
it, else through ``ops.rasterize_cuda.rasterize`` (the forward kernel on
the card) where the JAX package defaults to ``rasterize_tiled``.  Either
renders the cloud with its object ids set to 0.  ``cv2`` and ``PIL``
are imported by the function that needs them; a missing one raises
``ImportError`` naming the package.

Replaces the reference's SIBR ``network_gui`` TCP loop and turntable
scripts (reference: src/gs/gs_viewer.py:22-87, src/gs/gs_object_rotation.py,
src/visualization/object_visualization.py:57-98,565-629) with:

  * ``orbit_cameras`` — camera orbit generator around a point;
  * ``render_turntable`` — mp4 of an asset spinning (visual sanity check of
    SE(3) + SH rotation, like gs_object_rotation.py's live Rz loop);
  * ``serve_viewer`` — a zero-dependency HTTP viewer: MJPEG stream plus
    arrow-key orbit controls (stands in for the SIBR remote GUI).
"""

from __future__ import annotations

import math
import threading
from typing import List

import numpy as np
import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.device import DEFAULT_DEVICE
from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize


def _need(package: str, what: str):
    """Import ``package`` for ``what``, or raise ImportError naming it."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{what} needs the {package!r} package, which is not installed") from e


def render_rgb_u8(cloud, cam, background, rasterize_fn=None) -> np.ndarray:
    """[H, W, 3] uint8 render of ``cloud`` from ``cam``, on the host:
    ``rasterize_fn(cloud, cam, background=)``, or ``rasterize`` at K = 1."""
    with torch.no_grad():
        if rasterize_fn is None:
            rgb = rasterize(cloud, cam, background=background, max_objects=1).rgb
        else:
            rgb = rasterize_fn(cloud, cam, background=background).rgb
        return torch.clamp(rgb * 255, 0, 255).to(torch.uint8).cpu().numpy()


def orbit_cameras(
    center=(0.0, 0.0, 0.0),
    radius: float = 0.5,
    elevation_deg: float = 30.0,
    n_views: int = 60,
    width: int = 640,
    height: int = 480,
    fov_deg: float = 50.0,
    device=DEFAULT_DEVICE,
) -> List[Camera]:
    """Cameras orbiting `center` (reference orbit generator contract,
    object_visualization.py:57-98)."""
    cams = []
    el = math.radians(elevation_deg)
    for i in range(n_views):
        az = 2 * math.pi * i / n_views
        eye = (
            center[0] + radius * math.cos(az) * math.cos(el),
            center[1] + radius * math.sin(az) * math.cos(el),
            center[2] + radius * math.sin(el),
        )
        cams.append(
            Camera.look_at(
                eye=eye, target=center, up=(0, 0, 1),
                fovx=math.radians(fov_deg), fovy=math.radians(fov_deg),
                width=width, height=height, device=device,
            )
        )
    return cams


def render_turntable(
    cloud: GaussianCloud,
    output_path: str,
    n_views: int = 60,
    fps: int = 20,
    width: int = 480,
    height: int = 480,
    radius: float | None = None,
    background=(1.0, 1.0, 1.0),
    rasterize_fn=None,
) -> str:
    """Turntable mp4 of one asset (reference:
    object_visualization.py:565-629); renders on the cloud's device with
    ``rasterize_fn``, or ``rasterize`` at K = 1, the cloud's ids set to 0."""
    cv2 = _need("cv2", "render_turntable")

    cloud = cloud.with_object_id(0)
    center = cloud.centroid().cpu().numpy()
    if radius is None:
        spread = cloud.xyz.cpu().numpy() - center
        radius = float(np.quantile(np.linalg.norm(spread, axis=1), 0.95)) * 3.0

    cams = orbit_cameras(
        center=center, radius=radius, n_views=n_views,
        width=width, height=height, device=cloud.device,
    )
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(str(output_path), fourcc, fps, (width, height))
    for cam in cams:
        rgb = render_rgb_u8(cloud, cam, background, rasterize_fn)
        writer.write(rgb[:, :, ::-1])
    writer.release()
    return str(output_path)


def serve_viewer(
    cloud: GaussianCloud,
    host: str = "127.0.0.1",
    port: int = 6009,
    width: int = 640,
    height: int = 480,
    background=(0.0, 0.0, 0.0),
    rasterize_fn=None,
    blocking: bool = True,
):
    """Minimal live viewer: http://host:port shows the scene; arrow keys
    orbit, +/- zooms.  Stands in for the SIBR network_gui socket protocol
    (reference: pegasus.py:84-86, 249-279) with plain HTTP; frames are
    JPEGs, rendered with ``rasterize_fn``, or ``rasterize`` at K = 1.
    ``blocking=False`` serves from a daemon thread and returns the server
    (``shutdown()`` stops it)."""
    import io
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    Image = _need("PIL.Image", "serve_viewer")

    cloud = cloud.with_object_id(0)
    center = cloud.centroid().cpu().numpy()

    page = f"""<!doctype html><title>pegasus-tpu viewer</title>
<body style="margin:0;background:#111;color:#eee;font-family:monospace">
<img id=v width={width} height={height} style="display:block;margin:auto">
<p style="text-align:center">arrows: orbit &nbsp; +/-: zoom</p>
<script>
const v=document.getElementById('v');
let az=0, el=30, r=1.0;
function refresh(){{v.src=`/frame?az=${{az}}&el=${{el}}&r=${{r}}&t=${{Date.now()}}`}}
document.onkeydown=e=>{{
 if(e.key=='ArrowLeft')az-=10; if(e.key=='ArrowRight')az+=10;
 if(e.key=='ArrowUp')el=Math.min(85,el+5); if(e.key=='ArrowDown')el=Math.max(-85,el-5);
 if(e.key=='+')r*=0.9; if(e.key=='-')r*=1.1; refresh();}};
refresh();
</script>"""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path.startswith("/frame"):
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                az = float(q.get("az", [0])[0])
                el = float(q.get("el", [30])[0])
                r = float(q.get("r", [1.0])[0])
                # the orbit camera at the requested azimuth
                cams = orbit_cameras(
                    center=center, radius=r, elevation_deg=el,
                    n_views=360, width=width, height=height, device=cloud.device,
                )
                rgb = render_rgb_u8(cloud, cams[int(az) % 360], background, rasterize_fn)
                buf = io.BytesIO()
                Image.fromarray(rgb).save(buf, "JPEG", quality=85)
                data = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                body = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    if blocking:
        print(f"pegasus-tpu-torch viewer at http://{host}:{port}")
        server.serve_forever()
    else:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server


def gaussian_splatting_viewer(ply_path: str, device=DEFAULT_DEVICE, **kwargs):
    """API mirror of the reference's viewer entry
    (reference: src/gs/gs_viewer.py:22-87): load one asset ply onto
    ``device`` and serve it."""
    from pegasus_tpu_torch.gs.ply import load_gs_ply

    cloud = load_gs_ply(ply_path, device=device)
    return serve_viewer(cloud, **kwargs)
