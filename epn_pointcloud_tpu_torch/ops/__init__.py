from . import icosahedron, kernel_points, kernels, sampling, so3conv  # noqa: F401
from .so3conv import SphericalPointCloud  # noqa: F401
