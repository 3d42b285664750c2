"""Copied verbatim from ``pegasus_tpu/reconstruction/__init__.py``; only the import lines differ."""

from pegasus_tpu_torch.reconstruction.colmap_driver import COLMAPReconstruction
from pegasus_tpu_torch.reconstruction.pycolmap_driver import InProcessReconstruction
from pegasus_tpu_torch.reconstruction.alignment import ReconstructionAlignment
from pegasus_tpu_torch.reconstruction.urdf_gen import URDFGenerator
