"""AcademiCodec on PyTorch and CUDA: the port of ``academicodec_tpu`` to NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
``torch`` and numpy only. Public layouts match the JAX package (wav
``[B, T]``, codes ``[n_q, B, frames]``) and parameter names follow the
reference PyTorch ``state_dict``, so reference ``.pth`` files load with
``load_state_dict``. Convolutions run ``[B, C, T]``.

Hand-written Hopper kernels live in ``csrc/`` and are bound in
``ops/cuda/``: the residual-VQ codebook search (``rvq.cu``) and the fused
2-layer LSTM recurrence (``lstm2.cu``). Each wrapper runs its kernel for
CUDA tensors and its plain PyTorch version for CPU tensors only.
"""

from academicodec_tpu_torch.api import load_codec

__all__ = ["load_codec"]
