"""Training logger: a timestamped text log, and TensorBoard when it imports.

The port's counterpart of academicodec_tpu/utils/logging.py (reference
academicodec/utils.py:94-166). TensorBoard goes through
``torch.utils.tensorboard``; where that does not import (it needs the
``tensorboard`` package), the log says so and training goes on. Under data
parallelism only rank 0 writes (JAX :18-59): the other ranks' ``Logger``
creates no file and prints nothing unless asked.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import torch.distributed as dist


def is_primary() -> bool:
    """Rank 0 of the default process group, or a process without one
    (JAX ``jax.process_index() == 0``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


class Logger:
    def __init__(self, save_dir: str, tensorboard: bool = False, args: Any = None):
        self.save_dir = save_dir
        self.is_primary = is_primary()
        self.tb_writer = None
        if not self.is_primary:
            return
        log_dir = os.path.join(save_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, "log.txt"), "a")
        if args is not None:
            cfg_dir = os.path.join(save_dir, "configs")
            os.makedirs(cfg_dir, exist_ok=True)
            with open(os.path.join(cfg_dir, "args.json"), "w") as f:
                json.dump(args if isinstance(args, dict) else vars(args), f, indent=2, default=str)
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self.log_info("tensorboard requested but torch.utils.tensorboard does not import")
            else:
                self.tb_writer = SummaryWriter(log_dir=log_dir)

    def log_info(self, info: str, check_primary: bool = True) -> None:
        """Print and log on rank 0; ``check_primary=False`` prints on every rank."""
        if self.is_primary or not check_primary:
            print(info)
        if self.is_primary:
            self._fh.write(f"{time.strftime('%Y-%m-%d-%H-%M')}: {info}\n")
            self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.tb_writer is not None:
            self.tb_writer.add_scalar(tag, value, step)

    def close(self) -> None:
        if not self.is_primary:
            return
        self._fh.close()
        if self.tb_writer is not None:
            self.tb_writer.close()
