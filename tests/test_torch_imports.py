"""Import hygiene: the port (``parallel/`` and ``probes/`` included) and chip_smoke.py load no JAX and nothing of the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
before = set(sys.modules)
import academicodec_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
serving = ["academicodec_tpu_torch." + n for n in ("streaming", "codec.compress", "cli.compress", "data.wavio",
                                                   "cli.extract_tokens", "utils.fold", "data.dataset", "nn.norm",
                                                   "ops.int8", "nn.transformer", "models.lm", "codec.ac",
                                                   "codec.lm_compress", "ops.stft", "losses.gan", "losses.mel",
                                                   "nn.discriminators", "train.state", "train.encodec",
                                                   "data.mt64", "utils.checkpoint", "utils.logging",
                                                   "utils.profiling", "cli.train_encodec", "train.hificodec",
                                                   "train.lm", "cli.train_hificodec", "cli.train_lm",
                                                   "eval.stoi", "eval.pesq", "eval.metrics", "cli.evaluate",
                                                   "cli.wavlst", "utils.plotting", "data.native_loader",
                                                   "native.build", "parallel", "parallel.mesh",
                                                   "parallel.sequence", "ops.cuda.chain", "probes",
                                                   "probes.int8_chain")]
for name in serving + names:
    importlib.import_module(name)
import chip_smoke
banned = ("jax", "jaxlib", "flax", "academicodec_tpu")
loaded = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in banned)
print(len(names), loaded)
sys.exit(1 if loaded or len(names) < 73 or not set(serving) <= set(names) else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    """``academicodec_tpu_torch`` shares a prefix with ``academicodec_tpu``:
    the check compares whole top-level names, so only the latter trips it."""
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
