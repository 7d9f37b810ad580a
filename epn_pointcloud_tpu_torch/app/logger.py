"""Logger (counterpart of ``epn_pointcloud_tpu/app/logger.py`` ``Logger``):
python logging to stdout and an optional file, '#ts# [Scope] msg' format."""

from __future__ import annotations

import logging
import sys


class Logger:
    _counter = 0

    def __init__(self, log_file=None, log_level=logging.DEBUG):
        Logger._counter += 1
        self.logger = logging.getLogger(f'epn_torch_{Logger._counter}')
        self.logger.setLevel(log_level)
        self.logger.handlers.clear()
        fmt = logging.Formatter('#%(asctime)s# %(message)s',
                                '%y-%m-%d %H:%M:%S')
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(fmt)
        self.logger.addHandler(console)
        if log_file is not None:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)
        self.logger.propagate = False

    def log(self, scope, msg):
        self.logger.info(f'[{scope}] {msg}')

    def close(self):
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
