"""Evaluation protocols (counterpart of ``epn_pointcloud_tpu/eval``): the
3DMatch feature-match recall."""

from . import evaluation_3dmatch  # noqa: F401
from .evaluation_3dmatch import (  # noqa: F401
    TAU_RANGE, evaluate_fragment_pair, evaluate_scene, read_gt_log)
