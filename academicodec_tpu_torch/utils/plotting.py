"""Spectrogram plotting for validation logging (reference utils.py:169-178);
the port's copy of ``academicodec_tpu/utils/plotting.py``.

Matplotlib is optional and imported only when a plot is drawn, so a host
without it (the card's machine has none) still imports this module.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_spectrogram(spectrogram: np.ndarray):
    """``[n_mels, frames]`` -> matplotlib Figure (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(np.asarray(spectrogram), aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    fig.canvas.draw()
    plt.close(fig)
    return fig


def save_spectrogram_png(spectrogram: np.ndarray, path: str) -> Optional[str]:
    """Render a mel spectrogram to a PNG; the path, or None without matplotlib."""
    try:
        fig = plot_spectrogram(spectrogram)
    except ImportError:
        return None
    fig.savefig(path)
    return path
