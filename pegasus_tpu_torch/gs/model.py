"""Mutable ``GaussianModel`` facade over the immutable GaussianCloud.

Port of ``pegasus_tpu/gs/model.py``: the same methods over this package's
``GaussianCloud``, whose tensors stay on the device the cloud was loaded to
(``device``, the card by default); ``mask_points`` and
``denoise_point_cloud`` work on host copies, like the JAX package's.

Compatibility surface for code written against the reference's
``GaussianModel`` (reference: src/gs/gaussian_model.py:459-654): the same
method names mutate an internal GaussianCloud functionally.  New code
should use GaussianCloud directly; this class exists so reference-style
scripts port by changing only imports.
"""

from __future__ import annotations

import numpy as np
import torch

from pegasus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pegasus_tpu_torch.gs.cloud import GaussianCloud, merge as _merge
from pegasus_tpu_torch.gs.ply import load_gs_ply, save_gs_ply
from pegasus_tpu_torch.utils import quaternion as quat
from pegasus_tpu_torch.utils import sh as shlib


class GaussianModel:
    def __init__(self, sh_degree: int = 3, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.max_sh_degree = sh_degree
        self.active_sh_degree = sh_degree
        self.cloud: GaussianCloud | None = None
        self.meta_info = None
        self.R_init = None
        self.t_init = None

    # -- I/O (reference: gaussian_model.py:207-288) -----------------------------

    def load_ply(self, path: str, clean_pcd: bool = False) -> "GaussianModel":
        self.cloud = load_gs_ply(path, sh_degree=self.max_sh_degree, device=self.device)
        if clean_pcd:
            self.denoise_point_cloud(nb_points=16, radius=0.03)
        return self

    def save_ply(self, path: str) -> None:
        save_gs_ply(self.cloud, path)

    # -- reference property surface ----------------------------------------------

    @property
    def get_xyz(self):
        return self.cloud.xyz

    @property
    def get_scaling(self):
        return self.cloud.get_scaling()

    @property
    def get_rotation(self):
        return self.cloud.get_rotation()

    @property
    def get_opacity(self):
        return self.cloud.get_opacity()

    @property
    def get_features(self):
        return self.cloud.get_features()

    def get_covariance(self, scaling_modifier: float = 1.0):
        return self.cloud.covariance(scaling_modifier)

    def get_point_cloud(self):
        """(points [N,3], colors [N,3]) numpy pair — stands in for the
        reference's open3d point cloud (gaussian_model.py:463-474)."""
        return self.cloud.xyz.cpu().numpy(), self.cloud.get_rgb().cpu().numpy()

    # -- SE(3) ops (reference: gaussian_model.py:482-582) -------------------------

    def apply_translation_on_xyz(self, t) -> None:
        self.cloud = self.cloud.translated(np.asarray(t))

    def apply_rotation_on_xyz(self, R, origin: bool = False) -> None:
        # rotation only (no quat/SH side effects in the reference method)
        c = self.cloud
        R = self._f32(R)
        p = torch.zeros(3, device=c.device) if origin else c.centroid()
        self.cloud = c.replace(xyz=(c.xyz - p) @ R.T + p)

    def apply_transformation_on_xyz(self, T) -> None:
        T = np.asarray(T)
        self.apply_rotation_on_xyz(T[:3, :3])
        self.apply_translation_on_xyz(T[:3, 3])

    def apply_rotation_on_splats(self, R) -> None:
        c = self.cloud
        r_quat = quat.rotmat_to_quat(self._f32(R))
        self.cloud = c.replace(rot=quat.quat_mul(r_quat[None], c.get_rotation()))

    def apply_rotation_on_sh(self, R) -> None:
        c = self.cloud
        if c.f_rest.shape[1]:
            self.cloud = c.replace(
                f_rest=shlib.rotate_sh_rest(c.f_rest, self._f32(R), deg=c.sh_degree)
            )

    def apply_transformation(self, T) -> None:
        T = np.asarray(T)
        self.cloud = self.cloud.transformed(T[:3, :3], T[:3, 3])

    # -- composition (reference: gaussian_model.py:584-631) ------------------------

    def merge_gaussians(self, gaussian: "GaussianModel") -> None:
        self.cloud = _merge([self.cloud, gaussian.cloud])

    def mask_points(self, mask) -> None:
        """Boolean keep-mask; True entries survive
        (reference: gaussian_model.py:598-623).  Hard-compacts like the
        reference (shapes change — host-side utility, not for jit)."""
        keep = torch.as_tensor(mask, dtype=torch.bool).cpu().numpy()
        host = lambda x: x.cpu().numpy()[keep]
        c = self.cloud
        self.cloud = GaussianCloud.create(
            xyz=host(c.xyz), f_dc=host(c.f_dc), f_rest=host(c.f_rest),
            opacity=host(c.opacity), scale=host(c.scale), rot=host(c.rot),
            object_id=host(c.object_id), device=c.device,
        )

    def translate_selected_points(self, mask, t) -> None:
        keep = torch.as_tensor(mask, dtype=torch.bool, device=self.cloud.device)
        delta = torch.where(keep[:, None], self._f32(t)[None], torch.zeros((), device=keep.device))
        self.cloud = self.cloud.replace(xyz=self.cloud.xyz + delta)

    def denoise_point_cloud(self, nb_points: int = 16, radius: float = 0.05,
                            debug: bool = False) -> None:
        """Radius-outlier removal (reference: gaussian_model.py:633-654;
        open3d remove_radius_outlier replaced by a cKDTree query)."""
        from scipy.spatial import cKDTree

        pts = self.cloud.xyz.cpu().numpy()
        tree = cKDTree(pts)
        counts = np.array(
            [len(ix) - 1 for ix in tree.query_ball_point(pts, r=radius)]
        )
        self.mask_points(counts >= nb_points)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.cloud.device)
