"""Gaussian-splat clouds and their PLY files."""

from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.gs.ply import load_gs_ply, save_gs_ply
