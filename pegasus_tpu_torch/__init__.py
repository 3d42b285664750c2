"""PEGASUS on PyTorch + CUDA: the dataset-generation path of ``pegasus_tpu``.

A second package beside the JAX reference, with the same layout and names:
each module here has its counterpart at the same relative path in
``pegasus_tpu``, which the tests hold it against.  It imports ``torch`` and
never ``jax``, ``flax`` or ``pegasus_tpu``.

What runs: a recorded physics trajectory (JSON) -> ``SceneTemplate`` build
and posing -> per frame project / exact tile binning / the hand-written
CUDA tile compositor (``csrc/composite_tiles.cu``) -> every modality ->
packed bytes -> the BOP writer.  Physics (``init_bullet``) waits for its
own port.

Float32 matrix products run in full float32: TF32 is switched off for
matmuls and cuDNN when this package is imported, so device results compare
with the reference at float32 tolerances.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
