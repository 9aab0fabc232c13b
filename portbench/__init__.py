"""The benchmark of the PyTorch/CUDA port (``academicodec_tpu_torch``); see README.md."""
