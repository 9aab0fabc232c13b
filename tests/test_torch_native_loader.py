"""The port's native wav-crop loader (``native/wavloader.cpp`` through
``data/native_loader.py``), on the CPU.

Its batches must be bit-identical to the JAX package's Python pipeline
(``academicodec_tpu.data.dataset.batch_iterator``; the JAX package's own
tests tie that pipeline to its native loader) and to the port's own
``batch_iterator``: with and without mixtures, sharded two ways, and from
``start_epoch`` 3. Also its noise-fallback counter and warning, the eager
sample-rate guard, a truncated ``fmt `` chunk read as corrupt, and two
processes that build the library at once (it is built to a temporary name
and renamed, so neither loads a half-written file). Whether a compiler is
present is decided in a fixture, never at collection.
"""

import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

from academicodec_tpu.data import dataset as jdataset

from academicodec_tpu_torch.data import dataset
from academicodec_tpu_torch.data.native_loader import NativeWavLoader, native_batch_iterator
from academicodec_tpu_torch.data.wavio import write_wav

REPO = __file__.rsplit("/tests/", 1)[0]
SR = 16000


@pytest.fixture(scope="module")
def compiler():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler to build native/wavloader.cpp")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, compiler):
    """Files longer (cropped) and shorter (zero-padded) than the segment."""
    root = tmp_path_factory.mktemp("native_corpus")
    rng = np.random.default_rng(0)
    for i, t in enumerate([700, 150, 1200, 200, 901, 350, 644, 1000, 480]):
        w = (rng.standard_normal(t) * 0.1 + 0.02 * (i + 1)).astype(np.float32)
        write_wav(str(root / f"c{i}.wav"), w * 0.5, SR)
    return str(root)


@pytest.mark.parametrize("mixture,shard,start_epoch", [
    (0.0, (0, 1), 0), (0.5, (0, 1), 0), (0.5, (1, 2), 0), (0.0, (0, 2), 3),
])
def test_native_batches_equal_the_python_pipelines(corpus, mixture, shard, start_epoch):
    seed, seg, bs = 11, 256, 2
    kw = dict(seed=seed, epochs=2, start_epoch=start_epoch, process_index=shard[0], process_count=shard[1])
    jds = jdataset.WavCropDataset(corpus, seg, sample_rate=SR, mixture_prob=mixture, seed=seed)
    ds = dataset.WavCropDataset(corpus, seg, sample_rate=SR, mixture_prob=mixture, seed=seed)
    want = list(jdataset.batch_iterator(jds, bs, num_workers=2, **kw))
    ours = list(dataset.batch_iterator(ds, bs, num_workers=2, **kw))
    nat = list(native_batch_iterator(ds.files, seg, bs, sample_rate=SR, mixture_prob=mixture, num_workers=3, **kw))
    assert len(nat) == len(want) == len(ours) == 2 * ((-(-len(ds.files) // shard[1])) // bs)
    for a, b, c in zip(nat, want, ours):
        assert a.dtype == np.float32 and a.shape == (bs, seg)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_fallback_counter_and_its_one_warning(tmp_path, compiler, recwarn):
    write_wav(str(tmp_path / "ok.wav"), np.full(400, 0.25, np.float32), SR)
    (tmp_path / "bad.wav").write_bytes(b"not a riff")
    loader = NativeWavLoader([str(tmp_path / "ok.wav"), str(tmp_path / "bad.wav")], 400, 2, seed=0)
    loader.next()
    first = loader.fallbacks
    loader.next()
    assert first >= 1 and loader.fallbacks >= 2
    assert len([w for w in recwarn if "substituted noise" in str(w.message)]) == 1
    loader.close()
    assert loader.fallbacks == 0  # a closed loader reads no handle
    clean = NativeWavLoader([str(tmp_path / "ok.wav")] * 2, 400, 2, seed=1)
    clean.next()
    assert clean.fallbacks == 0
    clean.close()


def test_wrong_sample_rate_is_refused_eagerly(corpus):
    files = dataset.list_audio_files(corpus)
    with pytest.raises(ValueError, match="does not resample"):
        NativeWavLoader(files, 256, 2, sample_rate=24000)
    with pytest.raises(ValueError, match="empty file list"):
        NativeWavLoader([], 256, 2)
    with pytest.raises(ValueError, match="wavloader_create failed"):
        NativeWavLoader(files[:1], 256, 2)  # fewer files than a batch


def test_truncated_fmt_chunk_is_corrupt(tmp_path, compiler):
    """A 14-byte WAVEFORMAT ``fmt `` chunk (no bits field) is read as corrupt:
    the noise fallback, not samples decoded from uninitialised memory."""
    p = tmp_path / "oldfmt.wav"
    fmt = struct.pack("<HHIIH", 1, 1, SR, 32000, 2)
    data = b"\x00\x00" * 64
    riff = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data
    p.write_bytes(b"RIFF" + struct.pack("<I", len(riff)) + riff)
    loader = NativeWavLoader([str(p)], 128, 1, seed=0)
    with pytest.warns(UserWarning, match="substituted noise"):
        row = loader.next()[0]
    assert row.std() > 0.01 and loader.fallbacks >= 1  # the prefetch ring may have read ahead
    loader.close()


_BUILD_ONE = """
import sys
from pathlib import Path
import academicodec_tpu_torch.native.build as b
b.BUILD_DIR = Path(sys.argv[1])
lib = b.get_wavloader_lib()
print(b.library_path(b.WAVLOADER_SRC).name, bool(lib.wavloader_create))
"""


def test_two_processes_building_at_once_both_load(tmp_path, compiler):
    """Both compile into an empty build directory at the same time; each
    renames its own temporary file onto the library's name, so both load it
    and no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = {o.split()[0] for o, _e in outs}
    assert len(names) == 1 and all(o.split()[1] == "True" for o, _e in outs)
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(names)


def test_a_build_that_fails_raises(tmp_path, monkeypatch):
    """No compiler: the loader raises, nothing switches to the Python pipeline."""
    import academicodec_tpu_torch.native.build as build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        NativeWavLoader(["x.wav"], 256, 1)
    from academicodec_tpu_torch.data.native_loader import native_loader_available

    assert native_loader_available() is False

