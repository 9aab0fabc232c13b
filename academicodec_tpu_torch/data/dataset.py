"""Audio file lists (the port's copy of academicodec_tpu/data/dataset.py:40-50).

Only :func:`list_audio_files` is ported so far; the training datasets follow
with the trainers.
"""

from __future__ import annotations

import glob
import os
from typing import List


def list_audio_files(source: str) -> List[str]:
    """``source`` is a directory (globbed for ``*.wav``, recursively) or a
    filelist with one path per line."""
    if os.path.isdir(source):
        files = sorted(
            glob.glob(os.path.join(source, "*.wav"))
            + glob.glob(os.path.join(source, "**", "*.wav"), recursive=True)
        )
        return sorted(set(files))
    with open(source) as fh:
        return [line.strip() for line in fh if line.strip()]
