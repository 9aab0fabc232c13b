"""``--multihost`` in both GAN trainer CLIs under ``torch.distributed.run``, and
chip_smoke's ``parallel`` phase rehearsed on the CPU.

Two ranks on the CPU (``--device cpu``: gloo), at the widths of
tests/test_torch_train_cli.py and tests/test_torch_train_hifi_cli.py, for
one epoch (the Encodec CLI then resumes for another). Both ranks print the
same losses (global-batch means), only rank 0 writes the log and the
checkpoints, and the checkpoints serve through ``cli.compress`` /
``cli.extract_tokens``. Then the card's
phase ``parallel`` (a) and (c) at a tiny width: the data-parallel code in a
gloo group of this process alone against the plain code, and data-parallel
serving against one device.
"""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from academicodec_tpu_torch.cli import compress as compress_cli
from academicodec_tpu_torch.cli import extract_tokens as extract_cli
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.utils.checkpoint import checkpoint_step, scan_checkpoint
from tests.test_torch_hificodec import TINY as HIFI_TINY
from tests.test_torch_train import TINY, one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.test_torch_train_cli import TINY_FLAGS, _write_tones
from tests.test_torch_train_hifi import TINY_DISCS, TINY_MODEL
from tests.test_torch_train_hifi_cli import _argv as hifi_argv
from tests.test_torch_train_hifi_cli import corpus  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def torchrun(module: str, args, log_dir, nproc: int = 2) -> list:
    """``python -m torch.distributed.run --nproc_per_node nproc -m module args``
    -> each rank's standard output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc), "--master_port",
           str(chip_smoke.free_port()), "--log_dir", str(log_dir), "-r", "3", "-m", module, *map(str, args)]
    r = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=600)
    logs = [sorted(glob.glob(os.path.join(str(log_dir), "**", str(rank), "stdout.log"), recursive=True))
            for rank in range(nproc)]
    out = [open(paths[-1]).read() if paths else "" for paths in logs]
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:], [o[-1500:] for o in out])
    return out


def _losses(stdout: str, pattern: str) -> list:
    """The loss lines, without their host-clock rates."""
    return [re.sub(r" ?s/b[ =:]+[\d.]+", "", line) for line in stdout.splitlines() if re.search(pattern, line)]


def test_train_encodec_multihost_two_ranks(tmp_path):
    data, out = str(tmp_path / "wavs"), tmp_path / "ckpt"
    _write_tones(data)
    argv = ["--multihost", "--device", "cpu", "--train_data_path", data, "--valid_data_path", data, "--path", out,
            *TINY_FLAGS, "--batch_size", "8", "--segment_seconds", "0.2", "--n_epochs", "0", "--print_freq", "1",
            "--debug_tiny_discs", "--discriminator_iter_start", "0"]
    ranks = torchrun("academicodec_tpu_torch.cli.train_encodec", argv, tmp_path / "run1")
    steps = [_losses(o, r"^epoch 0 (step|valid)") for o in ranks]
    assert len(steps[0]) == 3 and steps[0] == steps[1], steps  # 16 files, 4 a rank a step: 2 steps and valid
    assert "process 0 of 2" in ranks[0] and "process 1 of 2" in ranks[1]
    log = open(out / "logs" / "log.txt").read()
    assert "process 0 of 2" in log and "process 1 of 2" not in log  # rank 0 alone writes
    latest = scan_checkpoint(str(out), "latest")
    assert checkpoint_step(latest) == 2 and not glob.glob(str(out / "*.tmp"))
    argv[argv.index("--n_epochs") + 1] = "1"
    ranks = torchrun("academicodec_tpu_torch.cli.train_encodec", argv + ["--resume"], tmp_path / "run2")
    assert all("epoch 1 step 4" in o for o in ranks)
    assert _losses(ranks[0], r"^epoch 1 (step|valid)") == _losses(ranks[1], r"^epoch 1 (step|valid)")
    assert "at step 2, epoch 1" in open(out / "logs" / "log.txt").read()
    served = tmp_path / "served"
    compress_cli.main(["--input", data, "--output", str(served), "--resume_path", scan_checkpoint(str(out), "latest"),
                       *TINY_FLAGS, "--target_bw", "4", "--ecdc", "--device", "cpu"])
    assert len(glob.glob(str(served / "*.ecdc"))) == 16


def test_train_hificodec_multihost_two_ranks(corpus, tmp_path):  # noqa: F811 (the fixture)
    out = tmp_path / "ckpt"
    argv = ["--multihost", *hifi_argv(corpus, out, 1)]
    ranks = torchrun("academicodec_tpu_torch.cli.train_hificodec", argv, tmp_path / "run1")
    lines = [_losses(o, r"^(Steps|validation)") for o in ranks]
    assert len(lines[0]) == 2 and lines[0] == lines[1], lines  # 2 files, 1 a rank a step: 1 step and valid
    latest = scan_checkpoint(str(out), "state")
    assert checkpoint_step(latest) == 1
    assert "process 1 of 2" not in open(out / "logs" / "log.txt").read()
    tokens = extract_cli.main(["--config", str(corpus / "config.json"), "--model_path", latest, "--input",
                               str(corpus / "wavs"), "--outputdir", str(tmp_path / "served"), "--sample_rate",
                               "16000", "--device", "cpu"])
    assert sorted(tokens) == ["w0", "w1"]


def test_chip_smoke_parallel_world1_rehearsal():
    """Phase (a) at a tiny width: the Encodec trainer's data-parallel code in a
    gloo group of this process alone against the plain code, bitwise on the
    CPU, with equal launch counts (0: the plain versions run)."""
    cases = chip_smoke.parallel_cases_world1(
        "cpu", encodec=dict(TINY, bins=16, target_bandwidths=(1, 2)), enc_batch=4, enc_seconds=0.4, enc_steps=2,
        hifi_model=HiFiCodecConfig(**TINY_MODEL), hifi_discs=TINY_DISCS, hifi_batch=2, hifi_samples=512,
        hifi_steps=1)
    del cases["hifi"]  # a tiny HiFi-Codec step takes ~2 s here; tests/test_torch_parallel_train.py runs its code
    out = chip_smoke._parallel_world1("cpu", backend="gloo", cases=cases)
    for name, r in out.items():
        assert r["failures"] == [] and r["distance_parallel_vs_plain"] == 0.0 == r["distance_plain_repeat"], name
        assert r["launches_parallel"] == r["launches_plain"] and not any(r["launches_parallel"][0].values())
    assert not torch.distributed.is_initialized()


def test_chip_smoke_parallel_serving_rehearsal():
    """Phase (c) at a tiny width: ``compress_batch`` over ``devices=[cpu]`` and
    ``cli.extract_tokens --data_parallel`` against the plain paths."""
    out = chip_smoke._parallel_serving("cpu", dtype=torch.float32, n_files=2, seconds=0.2, extract_files=2,
                                       extract_seconds=(0.1, 0.2), hifi_overrides=dict(HIFI_TINY, n_codes=64),
                                       n_filters=4, dimension=32)
    assert out["compress_blobs_identical"] and out["extract_tokens_identical"]
    assert np.isfinite(out["compress_parallel_ms"])
