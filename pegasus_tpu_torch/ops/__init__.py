"""Projection, binning, compositing and the modality encoders."""

from pegasus_tpu_torch.ops.projection import project_gaussians
from pegasus_tpu_torch.ops.rasterize_ref import rasterize_reference
