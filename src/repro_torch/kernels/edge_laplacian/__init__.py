"""L(g) and the per-edge quadratic form (``csrc/edge_laplacian.cu``)."""
from . import ops  # noqa: F401
