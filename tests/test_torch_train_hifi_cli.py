"""``cli/train_hificodec.py`` end to end on the CPU, and its state served.

A tiny config (tests/test_torch_train_hifi.py's model with 64 codes, the
reference discriminators, which the CLI always builds) on 2400-sample
segments (MS-STFT's widest window is 2048): one epoch writing a state every
step, a resume from it, validation, ``--fine_tuning`` on paired mel files.
The newest state is then served by ``cli/extract_tokens.py --model_path``
(tokens equal the state's ``VQVAE.encode``) and ``api.load_codec``, and
tokenizes for ``cli/train_lm.py --family hificodec``, whose LM
``cli/extract_tokens.py --lm`` takes: every blob decodes to the ``.npz``
tokens.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.cli import extract_tokens as extract_cli
from academicodec_tpu_torch.cli import train_hificodec, train_lm
from academicodec_tpu_torch.codec.compress import decompress_tokens
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.lm import load_lm
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.utils.checkpoint import checkpoint_step, load_checkpoint, load_checkpoint_meta, scan_checkpoint
from tests.test_torch_train_hifi import TINY_MODEL, one_torch_thread  # noqa: F401 (autouse)

MODEL = dict(TINY_MODEL, n_codes=64, segment_size=2400)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("hifi_cli")
    rng = np.random.default_rng(3)
    (root / "wavs").mkdir()
    (root / "mels").mkdir()
    for i in range(2):
        write_wav(str(root / "wavs" / f"w{i}.wav"), (rng.standard_normal(3000) * 0.1).astype(np.float32), 16000)
        np.save(root / "mels" / f"w{i}.npy", rng.standard_normal((80, 3000 // 240)).astype(np.float32))
    config = {k: list(v) if isinstance(v, tuple) else v for k, v in MODEL.items()}
    config.update(batch_size=2, seed=5, learning_rate=1e-3)
    with open(root / "config.json", "w") as fh:
        json.dump(config, fh)
    return root


def _argv(root, out, epochs, *extra):
    return ["--config", str(root / "config.json"), "--input_training_file", str(root / "wavs"),
            "--input_validation_file", str(root / "wavs"), "--checkpoint_path", str(out), "--training_epochs",
            str(epochs), "--checkpoint_interval", "1", "--validation_interval", "1", "--stdout_interval", "1",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(corpus):
    """The CLI's checkpoints of one epoch and of a resume; the first epoch's
    steps (batch, metrics) are recorded."""
    import chip_smoke
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainer

    out = corpus / "ckpt"
    with chip_smoke.recorded_steps(HiFiCodecTrainer) as steps:
        train_hificodec.main(_argv(corpus, out, 1))
    first = scan_checkpoint(str(out), "state")
    train_hificodec.main(_argv(corpus, out, 2))
    return out, first, scan_checkpoint(str(out), "state"), steps


def test_one_epoch_then_resume(trained):
    out, first, latest, _steps = trained
    log = open(out / "logs" / "log.txt").read()
    assert checkpoint_step(first) == 1 and load_checkpoint_meta(first) == {"epoch": 0}
    # the resume restarts the epoch its state records, as the JAX CLI does: epochs 0 and 1
    assert checkpoint_step(latest) == 3 and "resumed from" in log and "at step 1, epoch 0" in log
    assert "validation/mel_spec_error" in log and os.path.exists(out / "config.json")
    sd = load_checkpoint(latest)
    assert {"generator", "encoder", "quantizer", "discriminators", "optimizer_g", "optimizer_d"} <= set(sd)
    assert sd["step"] == 3


def test_state_is_served_by_extract_tokens_and_load_codec(trained, corpus, tmp_path):
    _out, _first, latest, _steps = trained
    extract_cli.main(["--config", str(corpus / "config.json"), "--model_path", latest, "--input",
                      str(corpus / "wavs"), "--outputdir", str(tmp_path / "syn"), "--tokens_out",
                      str(tmp_path / "t.npz"), "--sample_rate", "16000", "--device", "cpu"])
    model = VQVAE(HiFiCodecConfig(**MODEL), device="cpu")
    model.load_reference(load_checkpoint(latest))
    wav = read_wav(str(corpus / "wavs" / "w0.wav"))[0]
    want = model.encode(torch.from_numpy(wav[None])).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "t.npz")["w0"], want)
    assert os.path.exists(tmp_path / "syn" / "w0.wav")
    served = load_codec("hificodec_24k_320d", latest, device="cpu", **MODEL)
    assert torch.equal(served.encode(torch.from_numpy(wav[None])), model.encode(torch.from_numpy(wav[None])))


def test_fine_tuning_on_mel_crops(corpus):
    """``--native_loader`` beside ``--fine_tuning`` is ignored with the JAX CLI's
    line: only the Python pipeline yields the paired mels."""
    out = corpus / "ft"
    train_hificodec.main(_argv(corpus, out, 1, "--fine_tuning", "--input_mels_dir", str(corpus / "mels"),
                               "--native_loader"))
    assert checkpoint_step(scan_checkpoint(str(out), "state")) == 1
    assert "--native_loader ignored: --fine_tuning needs paired precomputed mels" in \
        open(out / "logs" / "log.txt").read()


def test_unported_flags_refuse(monkeypatch):
    """``--multihost`` is refused without a torchrun environment (it is ported:
    tests/test_torch_parallel_cli.py runs it under torch.distributed.run)."""
    base = ["--config", "c", "--input_training_file", "a", "--input_validation_file", "b"]
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit):
        train_hificodec.get_args(base + ["--multihost"])
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    assert train_hificodec.get_args(base + ["--multihost"]).multihost
    assert train_hificodec.get_args(base + ["--native_loader"]).native_loader
    with pytest.raises(SystemExit):
        train_hificodec.get_args(["--config", "c", "--input_training_file", "a", "--input_validation_file", "b",
                                  "--fine_tuning"])


def test_native_loader_epoch_gives_the_python_fed_losses(trained, corpus, tmp_path):
    """One epoch with ``--native_loader`` trains on the Python-fed epoch's batch
    (the ``trained`` fixture's) bit for bit and gives its first step's losses."""
    import chip_smoke
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainer

    *_ckpts, python_fed = trained
    with chip_smoke.recorded_steps(HiFiCodecTrainer) as native:
        train_hificodec.main(_argv(corpus, tmp_path / "native", 1, "--native_loader"))
    assert len(native) == len(python_fed) == 1
    a, b = native[0], python_fed[0]
    np.testing.assert_array_equal(a["batch"], b["batch"])
    assert a["metrics"] == b["metrics"] and all(np.isfinite(v) for v in a["metrics"].values())


def test_train_lm_on_the_state_then_extract_tokens_with_the_lm(trained, corpus, tmp_path):
    """``cli.train_lm --family hificodec`` tokenizes with the trainer's state (the
    4 GRVQ streams), and ``cli.extract_tokens --tokens_ecdc --lm`` codes with
    its LM: every blob decodes to the ``.npz`` tokens."""
    _out, _first, latest, _steps = trained
    train_lm.main(["--train_data_path", str(corpus / "wavs"), "--resume_path", latest, "--family", "hificodec",
                   "--hifi_config", str(corpus / "config.json"), "--lm_dim", "16", "--lm_heads", "2",
                   "--lm_layers", "1", "--steps", "2", "--batch_size", "2", "--segment_seconds", "0.15",
                   "--path", str(tmp_path / "lm"), "--device", "cpu"])
    lm, meta = load_lm(str(tmp_path / "lm"), device="cpu")
    assert meta == {"trained_frames": 150, "family": "hificodec"} and lm.n_q == 4 and lm.bins == 64
    extract_cli.main(["--config", str(corpus / "config.json"), "--model_path", latest, "--input",
                      str(corpus / "wavs"), "--outputdir", str(tmp_path / "syn"), "--no_synth", "--tokens_out",
                      str(tmp_path / "t.npz"), "--tokens_ecdc", str(tmp_path / "ecdc"), "--lm",
                      str(tmp_path / "lm"), "--sample_rate", "16000", "--device", "cpu"])
    tokens = np.load(tmp_path / "t.npz")
    for name in ("w0", "w1"):
        blob = (tmp_path / "ecdc" / f"{name}.ecdc").read_bytes()
        np.testing.assert_array_equal(decompress_tokens(blob, lm=lm)[0], tokens[name][0].T)
