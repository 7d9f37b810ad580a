from . import blocks, heads, layers  # noqa: F401
