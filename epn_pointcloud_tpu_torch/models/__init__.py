"""Model construction: ``build_model_from(opt)`` dispatches on
``opt.model.model``: ``cls_so3net_pn`` (ModelNet40 classification),
``inv_so3net_pn`` (3DMatch descriptors) or ``reg_so3net`` (ModelNet
rotation alignment). Given ``outfile_path``, the builder writes its
block-parameter tree there as JSON (the trainers' params.json)."""

from . import cls_so3net_pn, inv_so3net_pn, reg_so3net
from .cls_so3net_pn import ClsSO3ConvModel  # noqa: F401
from .inv_so3net_pn import InvSO3ConvModel  # noqa: F401
from .reg_so3net import RegSO3ConvModel  # noqa: F401

BUILDERS = {'cls_so3net_pn': cls_so3net_pn.build_model,
            'inv_so3net_pn': inv_so3net_pn.build_model,
            'reg_so3net': reg_so3net.build_model}


def build_model_from(opt, seed=0, outfile_path=None):
    if opt.model.model not in BUILDERS:
        raise KeyError(f'model {opt.model.model!r} is not ported '
                       f'({", ".join(BUILDERS)})')
    return BUILDERS[opt.model.model](opt, seed=seed, to_file=outfile_path)
