"""Training checkpoints as ``torch.save`` files, with keep-last-N rotation and scan.

``<prefix>_<step:08d>.pt`` holds a whole training state as tensors and plain
containers (``torch.load(..., weights_only=True)`` reads it), with sidecar
metadata in ``<path>.meta.json`` (the epoch to resume at). The generator's
part is a reference-layout SoundStream state dict under ``soundstream``, so
``api.load_codec`` and ``cli/compress.py --resume_path`` take a training
checkpoint as they take a reference ``latest.pth``.

The port's counterpart of academicodec_tpu/utils/checkpoint.py, which
writes orbax directories; the names, rotation and metadata are the same.
Under data parallelism only rank 0 writes (``utils/logging.is_primary``);
every rank holds the same state, and every rank loads the same file on
resume.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Optional

import torch

from academicodec_tpu_torch.utils.logging import is_primary

SUFFIX = ".pt"


def save_checkpoint(directory: str, prefix: str, step: int, state: Dict[str, Any], num_ckpt_keep: int = 5,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state`` (a state dict) to ``directory/<prefix>_<step:08d>.pt`` and
    keep the newest ``num_ckpt_keep`` of that prefix. The file is written under
    a temporary name and renamed, so a reader never sees half of it. On a rank
    other than 0 nothing is written and the path is returned."""
    path = os.path.join(directory, f"{prefix}_{step:08d}{SUFFIX}")
    if not is_primary():
        return path
    os.makedirs(directory, exist_ok=True)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    if meta is not None:
        with open(path + ".meta.json", "w") as fh:
            json.dump(meta, fh)
    for old in _list(directory, prefix)[:-num_ckpt_keep]:
        os.remove(old)
        if os.path.exists(old + ".meta.json"):
            os.remove(old + ".meta.json")
    return path


def _list(directory: str, prefix: str):
    return sorted(glob.glob(os.path.join(directory, f"{prefix}_" + "?" * 8 + SUFFIX)))


def scan_checkpoint(directory: str, prefix: str) -> Optional[str]:
    """The newest ``<prefix>_<step>.pt`` in ``directory``, or None (reference utils.py:215-220)."""
    ckpts = _list(directory, prefix)
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's state dict, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint_meta(path: str) -> Dict[str, Any]:
    """The sidecar metadata of ``save_checkpoint(meta=...)``; ``{}`` without it."""
    try:
        with open(path + ".meta.json") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def checkpoint_step(path: str) -> int:
    m = re.search(r"_(\d{8})" + re.escape(SUFFIX) + "$", path)
    return int(m.group(1)) if m else -1
