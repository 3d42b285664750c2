"""Frozen copy of pegasus_tpu_torch/gs/ply.py at commit 7a69f88, cut to what the benchmark calls.

Inria-3DGS PLY load/save without external deps.

Port of ``pegasus_tpu/gs/ply.py``: the numpy reader and writer are the
reference's; ``load_gs_ply`` returns this package's ``GaussianCloud`` on
``device``.  Schema (reference: src/gs/gaussian_model.py:193-288): a single
'vertex' element with float32 properties
  x y z nx ny nz f_dc_0..2 f_rest_0..(3*(D+1)^2-4) opacity scale_0..2 rot_0..3
where f_dc/f_rest are stored channel-major ([N, K, 3] transposed to
[N, 3, K] and flattened).
"""

from __future__ import annotations

import io
import os
from typing import Dict, Tuple

import numpy as np

from reference.frozen.device import DEFAULT_DEVICE
from reference.frozen.gs.cloud import GaussianCloud

_PLY_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "u2", "uint16": "u2", "short": "i2", "int16": "i2",
    "uint": "u4", "uint32": "u4", "int": "i4", "int32": "i4",
}


def _read_ply_header(f) -> Tuple[str, list, int]:
    """Returns (format, [(name, np_dtype)...], vertex_count). Only supports a
    single 'vertex' element (all GS plys) — list properties unsupported."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    props = []
    count = 0
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.strip().split()
        if not tokens:
            continue
        key = tokens[0].decode()
        if key == "format":
            fmt = tokens[1].decode()
        elif key == "element":
            in_vertex = tokens[1] == b"vertex"
            if in_vertex:
                count = int(tokens[2])
        elif key == "property" and in_vertex:
            if tokens[1] == b"list":
                raise ValueError("list properties not supported")
            props.append((tokens[2].decode(), _PLY_DTYPES[tokens[1].decode()]))
        elif key == "end_header":
            break
    return fmt, props, count


def read_ply_vertex_data(path: str) -> Dict[str, np.ndarray]:
    """Read all per-vertex properties of a PLY file into a dict of arrays."""
    with open(path, "rb") as f:
        fmt, props, count = _read_ply_header(f)
        if fmt == "binary_little_endian":
            dt = np.dtype([(n, "<" + d) for n, d in props])
            data = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
        elif fmt == "binary_big_endian":
            dt = np.dtype([(n, ">" + d) for n, d in props])
            data = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
        elif fmt == "ascii":
            raw = np.loadtxt(io.BytesIO(f.read()), dtype=np.float64, max_rows=count)
            raw = np.atleast_2d(raw)
            dt = np.dtype([(n, d) for n, d in props])
            data = np.zeros(count, dtype=dt)
            for i, (n, _) in enumerate(props):
                data[n] = raw[:, i]
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return {n: np.ascontiguousarray(data[n]) for n, _ in props}


def load_gs_ply(path: str, sh_degree: int = 3, device=DEFAULT_DEVICE) -> GaussianCloud:
    """Load an Inria GS checkpoint PLY into a GaussianCloud
    (port of load_ply, reference: src/gs/gaussian_model.py:231-288)."""
    v = read_ply_vertex_data(path)
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    opacity = v["opacity"].astype(np.float32).reshape(n, 1)

    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], axis=1).astype(
        np.float32
    ).reshape(n, 3, 1)

    n_rest = 3 * (sh_degree + 1) ** 2 - 3
    rest_names = [f"f_rest_{i}" for i in range(n_rest)]
    missing = [r for r in rest_names if r not in v]
    if missing:
        raise ValueError(
            f"PLY has {sum(1 for k in v if k.startswith('f_rest_'))} f_rest "
            f"properties; expected {n_rest} for sh_degree={sh_degree}"
        )
    if n_rest:
        f_rest = np.stack([v[r] for r in rest_names], axis=1).astype(np.float32)
        f_rest = f_rest.reshape(n, 3, (sh_degree + 1) ** 2 - 1)
    else:
        f_rest = np.zeros((n, 3, 0), np.float32)

    scale = np.stack([v[f"scale_{i}"] for i in range(3)], axis=1).astype(np.float32)
    rot = np.stack([v[f"rot_{i}"] for i in range(4)], axis=1).astype(np.float32)

    return GaussianCloud.create(
        xyz=xyz,
        f_dc=np.swapaxes(f_dc, 1, 2),  # [N, 1, 3]
        f_rest=np.swapaxes(f_rest, 1, 2),  # [N, K, 3]
        opacity=opacity,
        scale=scale,
        rot=rot,
        device=device,
    )


def save_gs_ply(cloud: GaussianCloud, path: str) -> None:
    """Write an Inria-compatible GS PLY
    (port of save_ply, reference: src/gs/gaussian_model.py:207-224)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cloud = cloud.to("cpu")
    xyz = np.asarray(cloud.xyz, np.float32)
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)
    f_dc = np.asarray(cloud.f_dc, np.float32)  # [N,1,3]
    f_rest = np.asarray(cloud.f_rest, np.float32)  # [N,K,3]
    # disk layout is channel-major (transpose(1,2).flatten)
    f_dc_flat = np.swapaxes(f_dc, 1, 2).reshape(n, -1)
    f_rest_flat = np.swapaxes(f_rest, 1, 2).reshape(n, -1)
    opacity = np.asarray(cloud.opacity, np.float32).reshape(n, 1)
    scale = np.asarray(cloud.scale, np.float32)
    rot = np.asarray(cloud.rot, np.float32)

    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(f_dc_flat.shape[1])]
    names += [f"f_rest_{i}" for i in range(f_rest_flat.shape[1])]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(scale.shape[1])]
    names += [f"rot_{i}" for i in range(rot.shape[1])]

    table = np.concatenate(
        [xyz, normals, f_dc_flat, f_rest_flat, opacity, scale, rot], axis=1
    ).astype("<f4")

    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property float {name}" for name in names]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode())
        f.write(table.tobytes())


