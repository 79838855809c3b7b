"""The Mamba-2 SSD intra-chunk dual form (``csrc/ssd_scan.cu``)."""
from . import ops  # noqa: F401
