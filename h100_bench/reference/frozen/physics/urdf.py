"""Frozen copy of pegasus_tpu_torch/physics/urdf.py at commit 7a69f88.

Copied verbatim from ``pegasus_tpu/physics/urdf.py``; only the import lines differ.

URDF parsing and generation (no external deps).

Covers the two URDF roles in PEGASUS:
  * the physics engine reads back mass / center-of-mass / collision mesh
    from object URDFs (reference: src/engine/physical_simulation.py:82-92);
  * the (missing) ``URDFGenerator`` writes object/environment URDFs from a
    template with the alpha-shape mesh and center-of-mass inertial origin
    (contract: SURVEY 2.3.3, README.md:185, object_reconstruction.py:206-221).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class URDFInfo:
    name: str
    mass: float
    center_of_mass: np.ndarray  # [3]
    inertia_diag: np.ndarray  # [3] principal (ixx, iyy, izz)
    collision_mesh: str | None  # mesh filename relative to the URDF
    mesh_scale: np.ndarray  # [3]


def parse_urdf(path) -> URDFInfo:
    tree = ET.parse(str(path))
    robot = tree.getroot()
    name = robot.get("name", Path(path).stem)
    link = robot.find("link")
    mass = 1.0
    com = np.zeros(3)
    inertia = np.ones(3) * 1e-3
    mesh_file = None
    scale = np.ones(3)
    if link is not None:
        inertial = link.find("inertial")
        if inertial is not None:
            m = inertial.find("mass")
            if m is not None:
                mass = float(m.get("value", 1.0))
            origin = inertial.find("origin")
            if origin is not None and origin.get("xyz"):
                com = np.array([float(v) for v in origin.get("xyz").split()])
            inert = inertial.find("inertia")
            if inert is not None:
                inertia = np.array(
                    [
                        float(inert.get("ixx", 1e-3)),
                        float(inert.get("iyy", 1e-3)),
                        float(inert.get("izz", 1e-3)),
                    ]
                )
        collision = link.find("collision")
        if collision is None:
            collision = link.find("visual")
        if collision is not None:
            geom = collision.find("geometry")
            if geom is not None:
                mesh = geom.find("mesh")
                if mesh is not None:
                    mesh_file = mesh.get("filename")
                    if mesh.get("scale"):
                        scale = np.array(
                            [float(v) for v in mesh.get("scale").split()]
                        )
    return URDFInfo(
        name=name,
        mass=mass,
        center_of_mass=com,
        inertia_diag=inertia,
        collision_mesh=mesh_file,
        mesh_scale=scale,
    )


_URDF_TEMPLATE = """<?xml version="1.0"?>
<robot name="{name}">
  <link name="base_link">
    <inertial>
      <origin xyz="{com_x} {com_y} {com_z}" rpy="0 0 0"/>
      <mass value="{mass}"/>
      <inertia ixx="{ixx}" ixy="0" ixz="0" iyy="{iyy}" iyz="0" izz="{izz}"/>
    </inertial>
    <visual>
      <origin xyz="0 0 0" rpy="0 0 0"/>
      <geometry>
        <mesh filename="{mesh}" scale="1 1 1"/>
      </geometry>
    </visual>
    <collision>
      <origin xyz="0 0 0" rpy="0 0 0"/>
      <geometry>
        <mesh filename="{mesh}" scale="1 1 1"/>
      </geometry>
    </collision>
  </link>
</robot>
"""


def box_inertia(mass: float, extents: np.ndarray) -> np.ndarray:
    """Principal inertia of a solid box with side lengths `extents`."""
    a, b, c = extents
    return (mass / 12.0) * np.array(
        [b * b + c * c, a * a + c * c, a * a + b * b]
    )


def generate_urdf(
    urdf_path,
    mesh_filename: str,
    name: str,
    mass: float,
    center_of_mass,
    inertia_diag=None,
    mesh_extents=None,
    static: bool = False,
) -> None:
    """Write a single-link URDF (URDFGenerator contract, SURVEY 2.3.3).

    Environments use mass 0 (static in Bullet convention); objects carry a
    center-of-mass inertial origin that the physics engine reads back
    (reference: physical_simulation.py:82-92).
    """
    if static:
        mass = 0.0
    if inertia_diag is None:
        ext = np.asarray(mesh_extents if mesh_extents is not None else (0.1, 0.1, 0.1))
        inertia_diag = box_inertia(max(mass, 1e-6), ext)
    com = np.asarray(center_of_mass, np.float64)
    content = _URDF_TEMPLATE.format(
        name=name,
        com_x=com[0],
        com_y=com[1],
        com_z=com[2],
        mass=mass,
        ixx=inertia_diag[0],
        iyy=inertia_diag[1],
        izz=inertia_diag[2],
        mesh=mesh_filename,
    )
    os.makedirs(os.path.dirname(os.path.abspath(str(urdf_path))), exist_ok=True)
    with open(urdf_path, "w") as f:
        f.write(content)
