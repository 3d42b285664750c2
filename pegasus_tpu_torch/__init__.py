"""PEGASUS on PyTorch + CUDA: the dataset-generation and training paths of ``pegasus_tpu``.

A second package beside the JAX reference, with the same layout and names:
each module here has its counterpart at the same relative path in
``pegasus_tpu``, which the tests hold it against.  It imports ``torch`` and
never ``jax``, ``flax``, ``optax``, ``orbax`` or ``pegasus_tpu``.

What runs: the batched rigid-body drop (``physics/``, plain torch ops; on
the card one step is captured into a CUDA graph and replayed) or a recorded
physics trajectory (JSON) -> ``SceneTemplate`` build and posing -> per frame
project / exact tile binning / the hand-written
CUDA tile compositor (``csrc/composite_tiles.cu``) -> every modality ->
packed bytes -> the BOP writer.  Training (``training/trainer.py``) runs the
same compositor under ``torch.autograd`` with its hand-written backward
(``csrc/composite_tiles_bwd.cu``).  ``generate.py`` is the scene loop and the
CLI (``python -m pegasus_tpu_torch.generate``).  Around them: the asset
recipes (``reconstruction/``), the SIBR wire viewer (``network_gui.py``) and
``viewer.py``, the facades (``gs/model.py``, ``scene/setup.py``) and the
reference's helpers.

Float32 matrix products must run in full float32 to compare with the
reference at float32 tolerances.  That is PyTorch's default for matmuls
(``torch.backends.cuda.matmul.allow_tf32`` False); the package sets no
global flag, checks that one where a product needs it (``gs/knn.py``) and
runs no convolution (cuDNN's float32 convolutions default to TF32).
"""

__version__ = "0.1.0"

from pegasus_tpu_torch.gs.cloud import GaussianCloud, merge
from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.config import GenerationConfig

__all__ = ["GaussianCloud", "merge", "Camera", "GenerationConfig", "__version__"]
