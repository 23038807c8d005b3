"""
nimrud_tpu_torch: the PyTorch / CUDA port of nimrud_tpu for one NVIDIA
Hopper GPU (H100, sm_90a).

It mirrors the JAX package's layout (``ops/``, ``features/``,
``learning/``, ``pipeline.py``, ``utils/workload.py``) and imports
neither jax nor ``nimrud_tpu``: the host-side NumPy it needs is copied
in, each copy naming its original.  The serving path's one TPU kernel,
``packed_moments``, is a hand-written CUDA kernel
(``csrc/packed_moments.cu``); every other step is plain PyTorch.

Float32 contract: the port's matrix products are full float32 on the
card.  TF32 is switched off here, explicitly, for both cuBLAS and
cuDNN (PyTorch's cuDNN default is TF32), so the plain moment twin and
the linear classifier compute what the reference computes.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
