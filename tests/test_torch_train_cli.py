"""The port's training data pipeline, checkpoints and CLI, on the CPU.

``batch_iterator`` yields the JAX package's batches bit for bit (mixtures,
shards, epochs); checkpoints save, rotate, scan and resume; the CLI trains a
tiny model for an epoch on the CPU, writes ``latest_*.pt`` / ``best_*.pt``
and resumes from them (as tests/test_cli_train_e2e.py runs the JAX CLI), and
the port's ``cli.compress`` and ``api.load_codec`` serve its checkpoint.
"""

import glob
import os

import numpy as np
import pytest
import torch

from academicodec_tpu.data import dataset as jdataset
from academicodec_tpu.data.mt64 import epoch_order as jepoch_order

from academicodec_tpu_torch import api
from academicodec_tpu_torch.cli import compress as compress_cli
from academicodec_tpu_torch.cli import train_encodec
from academicodec_tpu_torch.data import dataset
from academicodec_tpu_torch.data.mt64 import MT19937_64, epoch_order
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.train.encodec import EncodecTrainConfig, EncodecTrainer
from academicodec_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_train import TINY, one_torch_thread, seeded_batch  # noqa: F401 (an autouse fixture)

TINY_FLAGS = ["--sr", "16000", "--ratios", "8", "5", "4", "2", "--target_bandwidths", "1", "2", "4",
              "--n_filters", "4", "--dimension", "32", "--bins", "64"]


def _write_tones(directory, n=16, samples=6400, sr=16000):
    os.makedirs(directory, exist_ok=True)
    for i in range(n):
        t = np.arange(samples + 97 * i) / sr
        write_wav(os.path.join(directory, f"tone{i:02d}.wav"),
                  (0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32), sr)


def test_mt64_golden_values_and_epoch_order():
    """std::mt19937_64's golden values (tests/test_loader_equivalence.py) and
    the epoch shuffle equal to the JAX package's."""
    r = MT19937_64(5489)
    assert r.next() == 14514284786278117030
    for _ in range(9998):
        r.next()
    assert r.next() == 9981545732273789042
    for n, seed, epoch in ((13, 7, 0), (13, 7, 1), (100, 6666, 3)):
        np.testing.assert_array_equal(epoch_order(n, seed, epoch), jepoch_order(n, seed, epoch))


@pytest.mark.parametrize("mixture,shard", [(0.0, (0, 1)), (0.3, (0, 1)), (0.3, (1, 3))])
def test_batch_iterator_matches_jax_bit_for_bit(tmp_path, mixture, shard):
    """Crops (files shorter and longer than a segment), p=0.3 mixtures and a
    shard of 3 processes, over two epochs from ``start_epoch`` 2."""
    _write_tones(str(tmp_path), n=11, samples=3000)
    kw = dict(seed=5, epochs=2, start_epoch=2, process_index=shard[0], process_count=shard[1], num_workers=3)
    ours_ds = dataset.WavCropDataset(str(tmp_path), 3200, sample_rate=16000, mixture_prob=mixture, seed=5)
    ref_ds = jdataset.WavCropDataset(str(tmp_path), 3200, sample_rate=16000, mixture_prob=mixture, seed=5)
    ours = list(dataset.batch_iterator(ours_ds, 2, **kw))
    ref = list(jdataset.batch_iterator(ref_ds, 2, **kw))
    assert len(ours) == len(ref) > 1
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dataset.shard_indices(np.arange(10), 2, 3),
                                  jdataset.shard_indices(np.arange(10), 2, 3))


def test_checkpoint_save_scan_rotate_resume(tmp_path):
    trainer = EncodecTrainer(EncodecTrainConfig(**TINY), device="cpu")
    state = trainer.init_state(0)
    state, _ = trainer.train_step(state, seeded_batch())
    d = str(tmp_path)
    assert ckpt.scan_checkpoint(d, "latest") is None
    for step in range(1, 8):
        path = ckpt.save_checkpoint(d, "latest", step, state.state_dict(), meta={"epoch": step})
    assert path.endswith("latest_00000007.pt") and ckpt.checkpoint_step(path) == 7
    kept = sorted(os.path.basename(p) for p in glob.glob(os.path.join(d, "latest_*.pt")))
    assert kept == [f"latest_{s:08d}.pt" for s in range(3, 8)]
    assert not glob.glob(os.path.join(d, "*.tmp"))
    assert ckpt.scan_checkpoint(d, "latest") == path and ckpt.load_checkpoint_meta(path) == {"epoch": 7}
    assert ckpt.load_checkpoint_meta(os.path.join(d, "nothing")) == {}
    # resume: a fresh state takes every tensor back, then steps as the original does
    resumed = trainer.init_state(1)
    resumed.load_state_dict(ckpt.load_checkpoint(path))
    assert resumed.step == state.step == 1 and resumed.generator.quantizer.vq.inited_layers() == \
        state.generator.quantizer.vq.inited_layers()
    for a, b in ((resumed.generator, state.generator), (resumed.discriminators, state.discriminators)):
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(va, vb), k
    x = seeded_batch(1)
    _, m1 = trainer.train_step(state, x)
    _, m2 = trainer.train_step(resumed, x)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k


def test_train_cli_one_epoch_resume_and_serve(tmp_path):
    """One epoch, then ``--resume`` for the next (the step goes on from the
    checkpoint), then the checkpoint serves ``cli.compress`` and ``load_codec``."""
    data = str(tmp_path / "wavs")
    _write_tones(data)
    out = str(tmp_path / "ckpt")
    argv = ["--train_data_path", data, "--valid_data_path", data, "--path", out, *TINY_FLAGS,
            "--batch_size", "8", "--segment_seconds", "0.2", "--n_epochs", "0", "--discriminator_iter_start", "1",
            "--debug_tiny_discs", "--print_freq", "1", "--checkpoint_interval", "1", "--device", "cpu",
            "--packed_conv"]
    train_encodec.main(argv)
    latest = ckpt.scan_checkpoint(out, "latest")
    assert latest and ckpt.scan_checkpoint(out, "best")
    assert ckpt.load_checkpoint_meta(latest) == {"epoch": 1}
    log = open(os.path.join(out, "logs", "log.txt")).read()
    assert "loss_g" in log and "valid" in log
    steps_before = ckpt.checkpoint_step(latest)
    assert steps_before == 2  # 16 files, batch 8

    argv[argv.index("--n_epochs") + 1] = "1"
    train_encodec.main(argv + ["--resume"])
    log = open(os.path.join(out, "logs", "log.txt")).read()
    assert f"at step {steps_before}, epoch 1" in log and "epoch 1 step 3" in log
    latest2 = ckpt.scan_checkpoint(out, "latest")
    assert ckpt.checkpoint_step(latest2) == 4 and ckpt.load_checkpoint_meta(latest2) == {"epoch": 2}

    wav_out = str(tmp_path / "served")
    compress_cli.main(["--input", data, "--output", wav_out, "--resume_path", latest2, *TINY_FLAGS,
                       "--target_bw", "4", "--ecdc", "--device", "cpu"])
    assert len(glob.glob(os.path.join(wav_out, "*.ecdc"))) == 16
    wav, sr = read_wav(os.path.join(wav_out, "tone00.wav"))
    assert sr == 16000 and wav.shape == (6400,) and np.isfinite(wav).all()
    model = api.load_codec("encodec_16k_320d", latest2, device="cpu", n_filters=4, dimension=32, bins=64,
                           target_bandwidths=(1, 2, 4))
    sd = ckpt.load_checkpoint(latest2)["soundstream"]
    assert torch.equal(model.quantizer.vq.embed[0], sd["quantizer.vq.layers.0._codebook.embed"])
    assert all(model.quantizer.vq.inited_layers()[:1])


def test_train_cli_refuses_what_is_not_ported(monkeypatch):
    """``--multihost`` is refused without a torchrun environment (it is ported:
    tests/test_torch_parallel_cli.py runs it under torch.distributed.run)."""
    base = ["--train_data_path", ".", "--valid_data_path", "."]
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit):
        train_encodec.get_args(base + ["--multihost"])
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit):  # a partial environment is refused too
        train_encodec.get_args(base + ["--multihost"])
    for k, v in (("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    assert train_encodec.get_args(base + ["--multihost"]).multihost
    assert train_encodec.get_args(base + ["--native_loader"]).native_loader
    with pytest.raises(SystemExit):
        train_encodec.get_args(base + ["--batch_size", "6", "--accum_steps", "4"])
    args = train_encodec.get_args(base)
    assert args.device == "cuda" and args.seed == 6666 and args.batch_size == 80
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EncodecTrainer(EncodecTrainConfig(**TINY))


def test_native_loader_epoch_gives_the_python_fed_losses(tmp_path):
    """One tiny-width epoch with ``--native_loader`` (the C++ loader, p=0.3
    mixtures of ``--soundstream``) trains on the Python pipeline's batches bit
    for bit and gives its losses at every step."""
    import chip_smoke

    data = str(tmp_path / "wavs")
    _write_tones(data)
    runs = {}
    for name, extra in (("python", []), ("native", ["--native_loader"])):
        with chip_smoke.recorded_steps(EncodecTrainer) as runs[name]:
            train_encodec.main(["--train_data_path", data, "--valid_data_path", data, "--path", str(tmp_path / name),
                                *TINY_FLAGS, "--batch_size", "8", "--segment_seconds", "0.2", "--n_epochs", "0",
                                "--discriminator_iter_start", "1", "--debug_tiny_discs", "--soundstream",
                                "--device", "cpu", *extra])
    assert len(runs["native"]) == len(runs["python"]) == 2
    for a, b in zip(runs["native"], runs["python"]):
        np.testing.assert_array_equal(a["batch"], b["batch"])
        assert a["metrics"] == b["metrics"] and all(np.isfinite(v) for v in a["metrics"].values())
        assert a["inited"] == b["inited"]


def test_train_step_rejects_segments_off_the_hop():
    """A segment that is not a multiple of the hop length would give a longer
    output than input (the decoder rounds up): the step refuses it."""
    trainer = EncodecTrainer(EncodecTrainConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="hop length"):
        trainer.train_step(trainer.init_state(0), seeded_batch(shape=(2, 3000)))


def test_profiling_helpers(tmp_path):
    """``trace`` writes a Chrome trace of the enclosed work (the CLI's
    ``--profile_dir``); ``StepTimer`` skips its warm-up ticks; ``param_count``."""
    from academicodec_tpu_torch.utils.profiling import StepTimer, param_count, trace

    with trace(str(tmp_path / "prof")):
        torch.ones(64).cumsum(0).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with trace(None) as prof:
        assert prof is None
    timer = StepTimer(warmup=2)
    assert [timer.tick() is None for _ in range(3)] == [True, True, False]
    assert timer.steps_per_sec > 0
    assert param_count(torch.nn.Linear(3, 2)) == 8
