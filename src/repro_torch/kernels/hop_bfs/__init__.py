"""One matmul-BFS hop over a batch of restarts (``csrc/hop_bfs.cu``)."""
from . import ops  # noqa: F401
