"""Scale-out paths over a mesh of lanes (port of ``pegasus_tpu/parallel``).

A lane is a device with its own CUDA stream (``mesh.py``); one card may
stand in a mesh several times.  On a mesh: sharded dataset generation
(``generation.run_generation_sharded``, a lane per scene), scene variants
(``scene_batch.generate_scene_variants``, a slice of the variants per
lane) and the splat-sharded render (``sharded_render``).  ``split_batch``
is the port's counterpart of the reference's ``shard_batch``: it returns
one tree per lane where the reference returns one sharded array.
"""

from pegasus_tpu_torch.parallel.mesh import make_mesh, replicate, split_batch
from pegasus_tpu_torch.parallel.generation import run_generation_sharded
from pegasus_tpu_torch.parallel.scene_batch import generate_scene_variants

__all__ = [
    "make_mesh",
    "replicate",
    "split_batch",
    "run_generation_sharded",
    "generate_scene_variants",
]
