"""Model construction: ``build_model_from(opt)``. Only ``cls_so3net_pn`` is
ported so far."""

from . import cls_so3net_pn
from .cls_so3net_pn import ClsSO3ConvModel  # noqa: F401


def build_model_from(opt, seed=0):
    if opt.model.model != 'cls_so3net_pn':
        raise KeyError(f'model {opt.model.model!r} is not ported '
                       f'(cls_so3net_pn only)')
    return cls_so3net_pn.build_model(opt, seed=seed)
