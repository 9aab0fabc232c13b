"""AcademiCodec on PyTorch and CUDA: the port of ``academicodec_tpu`` to NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
``torch`` and numpy only. Public layouts match the JAX package (wav
``[B, T]``, codes ``[n_q, B, frames]``, HiFi-Codec tokens ``[B, frames, 4]``)
and parameter names follow the reference PyTorch ``state_dict``, so
reference ``.pth`` and ``g_*`` files load. Convolutions run ``[B, C, T]``.

Hand-written Hopper kernels live in ``csrc/`` and are bound in
``ops/cuda/``: the residual-VQ codebook search (``rvq.cu``), the fused
2-layer LSTM recurrence (``lstm2.cu``) and the HiFi-GAN resblock towers
(``resblock.cu``). Each wrapper runs its kernel for CUDA tensors and its
plain PyTorch version for CPU tensors only.
"""

from academicodec_tpu_torch.api import load_codec

__all__ = ["load_codec"]
