"""Trainers of the port (the JAX package's academicodec_tpu/train)."""
