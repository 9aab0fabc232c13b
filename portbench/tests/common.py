"""Tiny configurations and helpers for the benchmark's CPU tests."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json, portbench/, the port

ENCODEC = "encodec_24k_240d.roundtrip_bf16_b16"
HIFI = "hificodec_24k_320d.roundtrip_bf16_b16"
TOKENIZE = "hificodec_24k_320d.tokenize_f32_ragged"

# widths cut to run on the CPU in seconds; every cell in f32 (bf16 convs on the CPU are not held)
SS_TINY = {"config": dict(n_filters=4, dimension=32, bins=64, ratios=[2, 2], sample_rate=400),
           "traffic": dict(batch=2, clip_seconds=[0.5, 0.5], bucket_seconds=0.5, batches=2, trace_calls=2,
                           dtype="float32")}
HF_TINY = {"config": dict(upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4], upsample_initial_channel=32,
                          encoder_base_channels=8, resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
                          n_codes=64, sampling_rate=400),
           "traffic": dict(batch=3, clip_seconds=[0.5, 0.5], bucket_seconds=0.5, batches=2, trace_calls=2,
                           dtype="float32")}
TOK_TINY = {"config": HF_TINY["config"], "traffic": dict(HF_TINY["traffic"], clip_seconds=[0.2, 0.5])}
TINY = {ENCODEC: SS_TINY, HIFI: HF_TINY, TOKENIZE: TOK_TINY}


@pytest.fixture
def one_thread():
    """One torch thread: the tiny models are launch-bound, and parallel workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def python(code: str, cwd: Path = ROOT, path=(ROOT,), timeout: int = 300) -> subprocess.CompletedProcess:
    """``python -c code`` in a fresh process whose import path starts with ``path``,
    without a CUDA device and without JAX's platform settings."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(map(str, path)), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)
