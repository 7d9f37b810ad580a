"""Logger, Summary and Timer (counterpart of
``epn_pointcloud_tpu/app/logger.py``): python logging to stdout and an
optional file in the '#ts# [Scope] msg' format, EMA scalar channels, and
named wall-clock checkpoints. A quiet Logger (the ranks other than 0 of a
data-parallel run) writes nothing."""

from __future__ import annotations

import logging
import sys
import time

import torch


class Logger:
    _counter = 0

    def __init__(self, log_file=None, log_level=logging.DEBUG,
                 quiet: bool = False):
        Logger._counter += 1
        self.logger = logging.getLogger(f'epn_torch_{Logger._counter}')
        self.logger.setLevel(log_level)
        self.logger.handlers.clear()
        self.logger.propagate = False
        if quiet:
            self.logger.addHandler(logging.NullHandler())
            return
        fmt = logging.Formatter('#%(asctime)s# %(message)s',
                                '%y-%m-%d %H:%M:%S')
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(fmt)
        self.logger.addHandler(console)
        if log_file is not None:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    def log(self, scope, msg):
        self.logger.info(f'[{scope}] {msg}')

    def close(self):
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)


class Summary:
    """EMA scalar channels, momentum 0.9.

    ``update_async`` takes scalars that may be device tensors and keeps
    them unread: a ``.item()`` a step would wait on the device every step.
    The pending values are read in one transfer, in submission order, at
    the next ``get``/``get_item``; the EMA equals eager updates."""

    def __init__(self, momentum: float = 0.9):
        self.items = []
        self.running_stats = {}
        self.counters = {}
        self.momentum = momentum
        self._pending = []

    def register(self, keys):
        for k in keys:
            self.items.append(k)
            self.running_stats[k] = 0.0
            self.counters[k] = 0

    def update_async(self, stats):
        """Queue a per-step stats dict of host or device scalars."""
        self._pending.append(stats)
        if len(self._pending) > 512:
            self._flush()

    def _flush(self):
        pending, self._pending = self._pending, []
        slots = [(i, k) for i, st in enumerate(pending) for k, v in st.items()
                 if isinstance(v, torch.Tensor)]
        if slots:
            vals = torch.stack([pending[i][k].detach().reshape(()).float()
                                for i, k in slots]).cpu().tolist()
            for (i, k), v in zip(slots, vals):
                pending[i][k] = v
        for stats in pending:
            self._apply(stats)

    def _apply(self, stats):
        for k, v in stats.items():
            x = float(v)
            if self.counters[k] == 0:
                self.running_stats[k] = x
            else:
                self.running_stats[k] = (self.momentum * self.running_stats[k]
                                         + (1 - self.momentum) * x)
            self.counters[k] += 1

    def update(self, stats):
        # no flush: each channel's EMA depends only on its own value order
        self._apply(stats)

    def get_item(self, k):
        self._flush()
        return self.running_stats[k]

    def get(self):
        self._flush()
        return '\t'.join(f'{k}: {self.get_item(k):.4f}' for k in self.items)


class Timer:
    """Named wall-clock checkpoints."""

    def __init__(self):
        self._checkpoints = {}

    def set_point(self, pid='default'):
        self._checkpoints[pid] = time.time()

    def reset_point(self, pid='default'):
        now = time.time()
        dt = now - self._checkpoints[pid]
        self._checkpoints[pid] = now
        return dt
