"""Plain f32 PyTorch references of the benchmarked models; they import torch alone."""
