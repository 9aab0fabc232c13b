"""The command: it fails without a card, loads nothing of JAX, and finds every cell's parts by name."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench.tests.common import ENCODEC, HIFI, ROOT, TINY, TOKENIZE, python

RUN = [sys.executable, "portbench/run.py"]


@pytest.mark.parametrize("argv", [
    ["--workload", ENCODEC, "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
    ["--workload", TOKENIZE, "--seed", "1", "--seconds", "1", "--trace", "1"],
])
def test_no_card_no_result(argv):
    """Without a CUDA device the run exits non-zero and prints nothing on stdout."""
    out = subprocess.run(RUN + argv, cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ holds no program: the run fails."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(RUN + ["--workload", ENCODEC, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


CHECK_MODULES = """
import json, sys, torch
torch.set_num_threads(1)
from portbench import harness
from portbench.tests.common import TINY
for w, o in TINY.items():
    for trace in (False, True):
        assert harness.run(w, 7, 0.05, trace, "cpu", overrides=o) is not None
loaded = sorted(sys.modules)
print(json.dumps({"forbidden": harness.forbidden_modules(), "port": "academicodec_tpu_torch" in loaded,
                  "tops": sorted({n.split('.')[0] for n in loaded})}))
"""


def test_the_command_loads_no_jax():
    """Every cell's whole run path, in a fresh process: no module whose top-level
    name is jax, jaxlib, flax or academicodec_tpu (compared whole: the port's
    academicodec_tpu_torch is not one)."""
    out = python(CHECK_MODULES)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == [] and got["port"]
    assert not {"jax", "jaxlib", "flax", "academicodec_tpu"} & set(got["tops"])


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, json\n"
            "import portbench.reference.soundstream, portbench.reference.hificodec, portbench.compare\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = python(code)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout))
    assert not {"academicodec_tpu_torch", "academicodec_tpu", "jax", "flax"} & tops
    # and no source line under reference/ names the packages
    for src in (ROOT / "portbench" / "reference").glob("*.py"):
        text = src.read_text()
        assert "import academicodec" not in text and "from academicodec" not in text


NEW_CELL = """
import json, sys, torch
torch.set_num_threads(1)
from portbench import harness
r = harness.run("hificodec_24k_320d.tokenize_tiny_added", 5, 0.05, True, "cpu",
                overrides={"config": %s})
e2e = harness.run("hificodec_24k_320d.tokenize_tiny_added", 5, 0.05, False, "cpu",
                  overrides={"config": %s})
print(json.dumps(e2e))
print(json.dumps(r))
"""


def test_a_cell_is_added_as_files_and_entries(tmp_path):
    """A throwaway traffic mix, metric and cell in a copy: new files and new
    entries of BENCHMARK.json only, no existing file edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    tiny = TINY[TOKENIZE]
    (tmp_path / "portbench" / "traffic" / "tokenize_tiny.json").write_text(json.dumps(
        {**json.loads((ROOT / "portbench" / "traffic" / "tokenize_f32_ragged.json").read_text()), **tiny["traffic"],
         "batch": 2, "clip_seconds": [0.25, 0.5]}))
    (tmp_path / "portbench" / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.calls))\n")
    (tmp_path / "portbench" / "limits" / "hificodec_24k_320d.tokenize_tiny_added.json").write_text(
        json.dumps({"code_gap": 1e-6}))
    new = "hificodec_24k_320d.tokenize_tiny_added"
    bench["workloads"].append({"name": new, "config": "hificodec_24k_320d", "traffic": "tokenize_tiny", "chips": 1,
                               "why": "a throwaway cell"})
    next(m for m in bench["end_to_end"] if m["name"] == "audio_s_per_s.tokenize")["workloads"].append(new)
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "audio_s_per_s.tokenize",
                               "workloads": [new]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = python(NEW_CELL % (json.dumps(tiny["config"]), json.dumps(tiny["config"])), cwd=tmp_path,
                 path=(tmp_path, ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    e2e, r = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert set(e2e["metrics"]) == {"audio_s_per_s.tokenize", "setup_s"}  # no card: no memory peak
    assert r["correct"] and r["metrics"]["calls_in_window"]["value"] >= 1
    assert r["checks"]["code_gap"]["limit"] == 1e-6


def test_cells_are_correct_at_tiny_widths_and_report_their_metrics():
    from portbench import harness

    for w in (ENCODEC, HIFI):
        r = harness.run(w, 11, 0.05, False, "cpu", overrides=TINY[w])
        assert r["correct"], r["checks"]
        assert set(r["metrics"]) >= {"audio_s_per_s.roundtrip", "setup_s"}
        assert list(r)[-1] == "checks"
