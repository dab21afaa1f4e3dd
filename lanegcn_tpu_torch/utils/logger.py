"""Tee logger: stdout + append-to-file (reference utils.py:37-48), the
port's copy of lanegcn_tpu/utils/logger.py."""

from __future__ import annotations

import os
import sys


class TeeLogger:
    """`sys.stdout = TeeLogger(path)` mirrors prints into save_dir/log."""

    def __init__(self, log_path: str):
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        self.terminal = sys.stdout
        self.log = open(log_path, "a")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()

    def close(self):
        self.log.close()
