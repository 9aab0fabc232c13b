"""Training logger: a timestamped text log, and TensorBoard when it imports.

The port's counterpart of academicodec_tpu/utils/logging.py (reference
academicodec/utils.py:94-166). TensorBoard goes through
``torch.utils.tensorboard``; where that does not import (it needs the
``tensorboard`` package), the log says so and training goes on.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class Logger:
    def __init__(self, save_dir: str, tensorboard: bool = False, args: Any = None):
        self.save_dir = save_dir
        self.tb_writer = None
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

    def log_info(self, info: str) -> None:
        print(info)
        self._fh.write(f"{time.strftime('%Y-%m-%d-%H-%M')}: {info}\n")
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.tb_writer is not None:
            self.tb_writer.add_scalar(tag, value, step)

    def close(self) -> None:
        self._fh.close()
        if self.tb_writer is not None:
            self.tb_writer.close()
