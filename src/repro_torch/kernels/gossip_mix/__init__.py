"""Eq. 1 gossip mixing of stacked worker parameters (``csrc/gossip_mix.cu``)."""
from . import ops  # noqa: F401
