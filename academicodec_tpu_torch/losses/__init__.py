"""Training losses (the port's copy of academicodec_tpu/losses)."""
