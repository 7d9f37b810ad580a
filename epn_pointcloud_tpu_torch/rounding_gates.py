"""The bf16 train steps' kernel-vs-plain gradient gates of ``chip_smoke.py``
([bf16-train]: cls_so3net_pn at b=12, [inv-bf16-train]: inv_so3net_pn at
b=16 a leg) read twice on the card: with the op layer's plain path as it is
(the bf16 inter forward's plain version keeps the anchor weights and F in
fp32), and with that plain version swapped for ``inter_conv_mma_plain``
(both rounded to bf16, where the tensor-core kernel and the TPU kernel
round them). Prints each gate's line and whether it holds.

  python -m epn_pointcloud_tpu_torch.rounding_gates

It imports ``chip_smoke`` from the repository root. Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import os
import shutil
import sys

import torch

from .ops.kernels import build
from .ops.kernels import inter_conv as ic

ROOT = os.path.dirname(build.BUILD_DIR)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('rounding_gates: needs a CUDA device')
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from .app.trainer import set_fp32_parity
    set_fp32_parity()
    dev = torch.device('cuda')
    cs.phase_build()
    legs = cs.inv_batches(cs.inv_tree(), dev, 1)[0]
    plain = ic.inter_conv_plain

    def rounded(*args):
        # the float64 reference steps stay unrounded
        fn = ic.inter_conv_mma_plain if args[2].dtype == torch.bfloat16 \
            else plain
        return fn(*args)
    try:
        for name, fn in (('plain version as it is', plain),
                         ('plain version at the kernel rounding points',
                          rounded)):
            ic.inter_conv_plain = fn
            for tag, phase in (
                    ('[bf16-train]',
                     lambda: cs.phase_bf16_train_step(dev, reps=1)),
                    ('[inv-bf16-train]',
                     lambda: cs.phase_inv_bf16_train(dev, legs, reps=1))):
                try:
                    phase()
                    print(f'{name}: {tag} gate holds', flush=True)
                except AssertionError as e:
                    print(f'{name}: {tag} gate fails: {e}', flush=True)
                torch.cuda.empty_cache()
    finally:
        ic.inter_conv_plain = plain
        shutil.rmtree(cs.INV_DIR, ignore_errors=True)


if __name__ == '__main__':
    main()
