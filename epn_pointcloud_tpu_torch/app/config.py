"""Hierarchical config surface (copy of ``epn_pointcloud_tpu/app/config.py``:
the reference's groups, flags and defaults). --steps-per-dispatch is
parsed so that a value above 1 is refused rather than ignored, and so is
--mesh-anchor (anchor-axis tensor parallelism, not ported yet; data
parallelism needs no flag: torchrun's process count is the data axis);
--compute-dtype (fp32 or bf16) sets the precision of training and serving
alike."""

from __future__ import annotations

import argparse
from types import SimpleNamespace


class HierarchyArgumentParser:
    """Independent subparsers each parse the full argv with parse_known_args;
    the groups in `flatten_args` merge into the top-level namespace, the
    others become nested namespaces (ref: parse_config.py:7-29)."""

    def __init__(self, flatten_args=('experiment', 'train', 'eval', 'test')):
        self.flatten_args = list(flatten_args)
        self.parser = argparse.ArgumentParser()
        self.sub = self.parser.add_subparsers()
        self.parser_list = {}

    def add_parser(self, name):
        args = self.sub.add_parser(name)
        self.parser_list[name] = args
        return args

    def parse_args(self, argv=None):
        opt_all, _ = self.parser.parse_known_args(argv)
        for name, parser in self.parser_list.items():
            opt, _ = parser.parse_known_args(argv)
            if name in self.flatten_args:
                for key, value in vars(opt).items():
                    setattr(opt_all, key, value)
            else:
                setattr(opt_all, name, opt)
        return opt_all


def dump_args(opt):
    """Namespace tree -> plain dict (ref: parse_config.py:32-39)."""
    args = {}
    for k, v in vars(opt).items():
        if isinstance(v, (argparse.Namespace, SimpleNamespace)):
            args[k] = dict(vars(v))
        else:
            args[k] = v
    return args


def build_parser() -> HierarchyArgumentParser:
    """The full option surface (ref: SPConvNets/options.py:8-106)."""
    parser = HierarchyArgumentParser()

    exp = parser.add_parser('experiment')
    exp.add_argument('--experiment-id', type=str, default='playground')
    exp.add_argument('-d', '--dataset-path', type=str, required=True)
    exp.add_argument('--dataset', type=str, default='kpts')
    exp.add_argument('--model-dir', type=str, default='trained_models/models')
    exp.add_argument('-s', '--seed', type=int, default=2913)
    exp.add_argument('--run-mode', type=str, default='train')
    # the run's device (not in the reference options surface): this rank's
    # CUDA device unless named ('cpu' runs the kernels' plain versions; under
    # torchrun the ranks then meet over gloo)
    exp.add_argument('--device', type=str, default=None)

    net = parser.add_parser('model')
    net.add_argument('-m', '--model', type=str, default='inv_so3net_pn')
    net.add_argument('--input-num', type=int, default=1024)
    net.add_argument('--output-num', type=int, default=32)
    net.add_argument('--search-radius', type=float, default=0.4)
    net.add_argument('--normalize-input', action='store_true')
    net.add_argument('--dropout-rate', type=float, default=0.)
    net.add_argument('--init-method', type=str, default='xavier')
    net.add_argument('-k', '--kpconv', action='store_true')
    net.add_argument('--kanchor', type=int, default=60)
    net.add_argument('--normals', action='store_true')
    net.add_argument('-u', '--flag', type=str, default='max')
    net.add_argument('--representation', type=str, default='quat')

    train = parser.add_parser('train')
    train.add_argument('-e', '--num-epochs', type=int, default=None)
    train.add_argument('-i', '--num-iterations', type=int, default=1000000)
    train.add_argument('-b', '--batch-size', type=int, default=8)
    train.add_argument('--npt', type=int, default=24)
    train.add_argument('-t', '--num-thread', default=8, type=int)
    train.add_argument('--no-augmentation', action='store_true')
    train.add_argument('-r', '--resume-path', type=str, default=None)
    train.add_argument('--save-freq', type=int, default=5000)
    train.add_argument('-lf', '--log-freq', type=int, default=100)
    train.add_argument('--eval-freq', type=int, default=5000)
    train.add_argument('--debug-mode', type=str, default=None)
    train.add_argument('--steps-per-dispatch', type=int, default=1)
    # ranks along the anchor axis (anchor-axis tensor parallelism; refused
    # above 1 by parallel.make_mesh until it is ported)
    train.add_argument('--mesh-anchor', type=int, default=1)
    # compute precision of the conv path (not in the reference options
    # surface): fp32 is the parity mode, bf16 the production mode
    train.add_argument('--compute-dtype', type=str, default='fp32',
                       choices=['fp32', 'bf16'])

    lr = parser.add_parser('train_lr')
    lr.add_argument('-lr', '--init-lr', type=float, default=1e-3)
    lr.add_argument('-lrt', '--lr-type', type=str, default='exp_decay')
    lr.add_argument('--decay-rate', type=float, default=0.5)
    lr.add_argument('--decay-step', type=int, default=10000)

    loss = parser.add_parser('train_loss')
    loss.add_argument('--loss-type', type=str, default='soft')
    loss.add_argument('--attention-loss-type', type=str, default='no_reg')
    loss.add_argument('--margin', type=float, default=1.0)
    loss.add_argument('--temperature', type=float, default=3)
    loss.add_argument('--attention-margin', type=float, default=1.0)
    loss.add_argument('--attention-pretrain-step', type=int, default=3000)
    loss.add_argument('--equi-alpha', type=float, default=0.0)

    parser.add_parser('eval')
    parser.add_parser('test')
    return parser


def parse_args(argv=None):
    opt = build_parser().parse_args(argv)
    opt.mode = opt.run_mode  # ref: options.py:109
    return opt

