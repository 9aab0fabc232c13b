"""The port's data parallelism (``academicodec_tpu_torch/parallel/``) on the CPU.

* The ``parallel`` helpers at world sizes 1 and 2: gloo groups of worker
  processes on a free port, each started with the environment torchrun
  gives a rank (tests/torch_parallel_worker.py; the pattern of
  tests/test_multihost.py), one torch thread each; without a group every
  helper is the identity.
* The quantizer's data-parallel training forward (``ResidualVQ.forward(group=)``):
  a k-means init forward of every layer, then a steady one, each rank on its
  rows of one global batch of latents, against the plain forward on the
  whole batch. The latents are the same bits on both sides, so the k-means
  init on the gathered batch gives the plain codes exactly; the codebooks
  (EMA sums summed over the ranks in another order) are held within JAX's
  limits (tests/test_train.py:285-294: atol 1e-5, rtol 1e-4) and are bitwise
  equal across the ranks.
* Data-parallel serving over two CPU replicas: ``SoundStreamCompressor(devices=)``
  blobs and tokens equal to one device's, and the decoded wavs within 1e-6
  of them (the decoder's SLSTM sums over the batch in an order that depends
  on its size); ``cli.compress`` / ``cli.extract_tokens --data_parallel``
  likewise, their 16-bit wav files within one step; the CLIs' argument
  checks against the JAX CLIs'.
* ``cli.compress --sequence_parallel`` over four time shards on the CPU:
  blobs byte-identical to the port's unsharded CLI and to the JAX CLI's
  with the flag (tests/test_torch_sequence.py holds the sharded modules;
  tests/test_torch_extract.py the extraction CLI).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from academicodec_tpu.cli import compress as jcompress_cli
from academicodec_tpu.cli import extract_tokens as jextract_cli

from academicodec_tpu_torch import parallel
from academicodec_tpu_torch.cli import compress as compress_cli
from academicodec_tpu_torch.cli import extract_tokens as extract_cli
from academicodec_tpu_torch.codec.compress import SoundStreamCompressor
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from tests import torch_parallel_worker as worker
from tests.test_torch_train import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SS_KW = dict(n_filters=4, dimension=32, ratios=(8, 5, 4, 2), sample_rate=16000, target_bandwidths=(1, 2, 4))
PCM_STEP = 1.001 / 2**15  # one step of the 16-bit wav files the CLIs write
HIFI_TINY = dict(upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4), upsample_initial_channel=64,
                 encoder_base_channels=8, n_codes=64)


def run_groups(worlds, tmp_path) -> dict:
    """One gloo group of each size in ``worlds``, all started at once -> each
    group's rank outputs."""
    procs = {}
    for w in worlds:
        port = chip_smoke.free_port()
        for r in range(w):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(w), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), PYTHONPATH=ROOT)
            procs[w, r] = subprocess.Popen([sys.executable, worker.__file__, str(tmp_path / f"w{w}_rank")], env=env,
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        outs = {key: p.communicate(timeout=300)[0] for key, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for key, p in procs.items():
        assert p.returncode == 0, f"world {key[0]} rank {key[1]}:\n{outs[key][-3000:]}"
    return {w: [torch.load(tmp_path / f"w{w}_rank{r}.pt", weights_only=False) for r in range(w)] for w in worlds}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return run_groups((1, 2), tmp_path_factory.mktemp("groups"))


def test_helpers_without_a_group_issue_no_collective():
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(parallel.shard_batch(x, 1, 2), x[2:])
    assert parallel.rank() == 0 and parallel.world_size() == 1
    t = torch.ones(3)
    parallel.replicate([t])
    parallel.all_reduce_sum_([t])
    assert torch.equal(t, torch.ones(3))
    assert parallel.all_gather_rows(x) is x
    assert torch.equal(parallel.microbatches(x, 2), x.reshape(2, 2, 3))
    m = {"a": torch.tensor(1.0)}
    assert parallel.all_reduce_mean_metrics(m) is m
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch(x, 0, 3)
    with pytest.raises(ValueError, match="not divisible by accum_steps"):
        parallel.microbatches(x, 3)


@pytest.mark.parametrize("world", [1, 2])
def test_helpers_across_ranks(groups, world):
    """Each helper's collective, at world 1 (a group of one issues it too) and 2."""
    for r, out in enumerate(groups[world]):
        h = out["helpers"]
        assert out["backend"] == "gloo" and out["device"] == "cpu" and (h["rank"], h["world"]) == (r, world)
        glob = torch.arange(4.0 * world * 3).reshape(4 * world, 3)
        assert torch.equal(h["shard"], glob[4 * r:4 * r + 4])  # rank-major blocks
        t, flag, ints = h["replicated"]
        assert torch.equal(t, torch.ones(3)) and flag.tolist() == [True, False] and ints.tolist() == [1]
        assert torch.equal(h["summed"], torch.full((2, 2), world * (world + 1) / 2))
        mean_rank = (world - 1) / 2
        assert [g.unique().tolist() for g in h["grads"]] == [[mean_rank], [mean_rank + 1]]
        assert torch.equal(h["gathered"], torch.cat([torch.full((2, 3), float(i)) for i in range(world)]))
        x = torch.arange(world * 4 * 5.0).reshape(world * 4, 5)
        want = x.reshape(2, world, 2, 5)[:, r]  # JAX's microbatch i is global rows [i B/2, (i+1) B/2)
        assert torch.equal(h["micro"], want)
        assert {k: float(v) for k, v in h["metrics"].items()} == {"a": mean_rank, "b": 2 * mean_rank}


@pytest.mark.parametrize("world", [1, 2])
def test_quantizer_follows_the_global_batch(groups, world):
    """k-means init on the gathered batch and EMA statistics summed over the
    ranks: every rank's codes are the plain forward's rows, its codebooks the
    plain ones within JAX's limits, and the ranks' codebooks bitwise equal."""
    plain = worker.vq_run(worker.global_latents())
    ranks = [out["vq"] for out in groups[world]]
    per = worker.VQ_SHAPE["B"] // world
    for r, got in enumerate(ranks):
        for c_got, c_want in zip(got["codes"], plain["codes"]):
            assert torch.equal(c_got, c_want[:, r * per:(r + 1) * per])
        for key in ("embed", "embed_avg", "cluster_size"):
            torch.testing.assert_close(got[key], plain[key], atol=1e-5, rtol=1e-4)
            assert torch.equal(got[key], ranks[0][key])
    assert len(torch.unique(plain["codes"][1])) > 8  # the codes spread over the codebooks


def test_init_from_env_needs_torchrun(monkeypatch):
    for k in parallel.mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.init_from_env("cpu")


def test_serving_devices():
    assert parallel.serving_devices("cpu,cpu") == [torch.device("cpu")] * 2
    assert parallel.serving_devices("cpu") == [torch.device("cpu")]
    assert parallel.split_rows(4, 2) == [slice(0, 2), slice(2, 4)]
    with pytest.raises(ValueError, match="divisible by the device count"):
        parallel.split_rows(3, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.serving_devices("cuda")


def _soundstream(wavs):
    model = SoundStream(**SS_KW, device="cpu", seed=5)
    chip_smoke.spread_codebooks(model, chip_smoke.latent_frames(model, torch.from_numpy(np.stack(wavs))))
    return model


def _wavs(n, samples, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(samples) * 0.1).astype(np.float32) for _ in range(n)]


def test_compressor_on_two_replicas_gives_one_device_blobs():
    wavs = _wavs(4, 3200, seed=3)
    model = _soundstream(wavs)
    plain = SoundStreamCompressor(model, target_bw=4)
    dp = SoundStreamCompressor(model, target_bw=4, devices=["cpu", "cpu"])
    assert dp.replicas[0] is model and dp.replicas[1] is not model
    blobs = plain.compress_batch(wavs)
    assert dp.compress_batch(wavs) == blobs
    assert len({b for b in blobs}) == 4
    for (a, sa), (b, sb) in zip(dp.decompress_batch(blobs), plain.decompress_batch(blobs)):
        assert sa == sb
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divisible by the device count"):
        dp.compress_batch(wavs[:3])


def _jax_refuses(get_args, argv, monkeypatch) -> bool:
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    try:
        get_args()
    except SystemExit:
        return True
    return False


def _port_refuses(get_args, argv) -> bool:
    try:
        get_args(argv)
    except SystemExit:
        return True
    return False


COMPRESS_CASES = [
    (["--data_parallel"], True),
    (["--data_parallel", "--sequence_parallel", "--batch_files", "2", "--bucket_seconds", "1"], True),
    (["--sequence_parallel", "--packed_conv"], True),
    (["--data_parallel", "--batch_files", "2"], True),
    (["--data_parallel", "--batch_files", "2", "--bucket_seconds", "1"], False),
    (["--sequence_parallel"], False),
    (["--sequence_parallel", "--batch_files", "2", "--bucket_seconds", "1"], False),
]
EXTRACT_CASES = [
    (["--data_parallel"], True),
    (["--sequence_parallel", "--batch_files", "2", "--bucket_seconds", "1"], True),
    (["--sequence_parallel", "--data_parallel", "--batch_files", "2", "--bucket_seconds", "1"], True),
    (["--sequence_parallel", "--fused_resblock"], True),
    (["--data_parallel", "--batch_files", "2"], True),
    (["--data_parallel", "--batch_files", "4", "--bucket_seconds", "1"], False),
    (["--sequence_parallel"], False),
    (["--sequence_parallel", "--bucket_seconds", "1"], False),
]


def test_cli_argument_checks_match_jax(tmp_path, monkeypatch):
    """``--data_parallel`` / ``--sequence_parallel`` combinations: each CLI refuses
    what the JAX CLI refuses and takes what it takes; a device list needs one
    of the two flags."""
    pth = tmp_path / "m.pth"
    torch.save({}, pth)
    base = ["--input", "in", "--output", "out", "--resume_path", str(pth)]
    for extra, refused in COMPRESS_CASES:
        assert _jax_refuses(jcompress_cli.get_args, base + extra, monkeypatch) is refused, extra
        assert _port_refuses(compress_cli.get_args, base + extra) is refused, extra
    ebase = ["--config", "c.json", "--model_path", str(pth), "--input", "in", "--outputdir", "out"]
    for extra, refused in EXTRACT_CASES:
        assert _jax_refuses(jextract_cli.get_args, ebase + extra, monkeypatch) is refused, extra
        assert _port_refuses(extract_cli.get_args, ebase + extra) is refused, extra
    for get_args, args in ((compress_cli.get_args, base), (extract_cli.get_args, ebase)):
        assert get_args(args + ["--sequence_parallel", "--device", "cpu,cpu,cpu,cpu"]).sequence_parallel
        with pytest.raises(SystemExit):
            get_args(args + ["--device", "cpu,cpu"])
    monkeypatch.setattr(sys, "argv", ["cli"] + base + ["--sequence_parallel"])
    assert jcompress_cli.get_args().sequence_parallel


def test_compress_cli_sequence_parallel_gives_one_device_and_jax_blobs(tmp_path, monkeypatch):
    """Two files, one of a length the four shards cannot split evenly (a
    ragged last shard): ``.ecdc`` blobs byte-identical to the unsharded CLI's
    and to the JAX CLI's with ``--sequence_parallel``, wav files within one
    16-bit step of the unsharded CLI's."""
    wavs = [w[:n] for w, n in zip(_wavs(2, 16000, seed=12), (16000, 9973))]
    model = _soundstream(wavs[:1])
    pth = tmp_path / "m.pth"
    torch.save(model.state_dict(), pth)
    (tmp_path / "in").mkdir()
    for i, w in enumerate(wavs):
        write_wav(str(tmp_path / "in" / f"w{i}.wav"), w, 16000)
    flags = ["--input", str(tmp_path / "in"), "--resume_path", str(pth), *[str(a) for a in _ss_flags()],
             "--target_bw", "4", "--ecdc"]
    compress_cli.main(flags + ["--output", str(tmp_path / "plain"), "--device", "cpu"])
    compress_cli.main(flags + ["--output", str(tmp_path / "sp"), "--device", "cpu,cpu,cpu,cpu", "--sequence_parallel"])
    monkeypatch.setattr(sys, "argv", ["compress"] + flags + ["--output", str(tmp_path / "jax"), "--sequence_parallel"])
    jcompress_cli.main()
    for i in range(2):
        blobs = [(tmp_path / tag / f"w{i}.ecdc").read_bytes() for tag in ("sp", "plain", "jax")]
        assert blobs[0] == blobs[1] == blobs[2]
        np.testing.assert_allclose(read_wav(str(tmp_path / "sp" / f"w{i}.wav"))[0],
                                   read_wav(str(tmp_path / "plain" / f"w{i}.wav"))[0], atol=PCM_STEP, rtol=0)


def test_compress_cli_data_parallel_writes_one_device_blobs(tmp_path):
    wavs = _wavs(4, 3200, seed=9)
    model = _soundstream(wavs)
    pth = tmp_path / "m.pth"
    torch.save(model.state_dict(), pth)
    (tmp_path / "in").mkdir()
    for i, w in enumerate(wavs):
        write_wav(str(tmp_path / "in" / f"w{i}.wav"), w, 16000)
    flags = ["--input", str(tmp_path / "in"), "--resume_path", str(pth), *[str(a) for a in _ss_flags()],
             "--target_bw", "4", "--ecdc", "--bucket_seconds", "0.2", "--batch_files", "2"]
    compress_cli.main(flags + ["--output", str(tmp_path / "plain"), "--device", "cpu"])
    compress_cli.main(flags + ["--output", str(tmp_path / "dp"), "--device", "cpu,cpu", "--data_parallel"])
    for i in range(4):
        assert (tmp_path / "plain" / f"w{i}.ecdc").read_bytes() == (tmp_path / "dp" / f"w{i}.ecdc").read_bytes()
        np.testing.assert_allclose(read_wav(str(tmp_path / "dp" / f"w{i}.wav"))[0],
                                   read_wav(str(tmp_path / "plain" / f"w{i}.wav"))[0], atol=PCM_STEP, rtol=0)


def _ss_flags():
    return ["--sr", SS_KW["sample_rate"], "--ratios", *SS_KW["ratios"], "--target_bandwidths",
            *SS_KW["target_bandwidths"], "--n_filters", SS_KW["n_filters"], "--dimension", SS_KW["dimension"]]


def test_extract_tokens_data_parallel_gives_one_device_tokens(tmp_path):
    """Four files of two lengths in groups of four, over two CPU replicas and
    over one: tokens and synthesized wavs equal."""
    model = VQVAE(HiFiCodecConfig(**HIFI_TINY), device="cpu", seed=2)
    wavs = [w[: n] for w, n in zip(_wavs(4, 2400, seed=4), (2400, 1700, 2400, 900))]
    chip_smoke.spread_codebooks(model, chip_smoke.latent_frames(model, torch.from_numpy(wavs[0][None])))
    torch.save({part: getattr(model, part).state_dict() for part in ("encoder", "generator", "quantizer")},
               tmp_path / "g_00000001")
    import dataclasses

    with open(tmp_path / "config.json", "w") as fh:
        json.dump(dataclasses.asdict(model.config), fh)
    (tmp_path / "in").mkdir()
    for i, w in enumerate(wavs):
        write_wav(str(tmp_path / "in" / f"f{i}.wav"), w, 24000)
    flags = ["--config", str(tmp_path / "config.json"), "--model_path", str(tmp_path / "g_00000001"),
             "--input", str(tmp_path / "in"), "--batch_files", "4", "--bucket_seconds", "0.1"]
    plain = extract_cli.main(flags + ["--outputdir", str(tmp_path / "plain"), "--device", "cpu"])
    dp = extract_cli.main(flags + ["--outputdir", str(tmp_path / "dp"), "--device", "cpu,cpu", "--data_parallel"])
    assert sorted(plain) == sorted(dp) == [f"f{i}" for i in range(4)]
    for k in plain:
        np.testing.assert_array_equal(plain[k], dp[k])
        np.testing.assert_allclose(read_wav(str(tmp_path / "dp" / f"{k}.wav"))[0],
                                   read_wav(str(tmp_path / "plain" / f"{k}.wav"))[0], atol=PCM_STEP, rtol=0)
    assert len(np.unique(np.concatenate([v.ravel() for v in plain.values()]))) > 8
