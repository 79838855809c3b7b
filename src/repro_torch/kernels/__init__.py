"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``edge_laplacian`` (L(g) and the per-edge quadratic form of the ADMM
constraint operator; in one launch each, A_op's dense blocks from L(g),
AT_op's x-part and the CG matvec A·Aᵀλ),
``hop_bfs`` (one matmul-BFS hop of the SA warm start), ``gossip_mix``
(Eq. 1 neighbour mixing of DSGD gossip, batched over workers and for one
worker), ``decode_attention`` (one-token GQA attention over a KV cache, and its
rank form over a slice of a sequence-sharded cache)
and ``ssd_scan`` (the Mamba-2 SSD intra-chunk dual form). Sources live in ``repro_torch/csrc``; :mod:`.build` compiles
them at first use.
"""
from __future__ import annotations

from .decode_attention import ops as _dec_ops
from .edge_laplacian import ops as _el_ops
from .gossip_mix import ops as _gossip_ops
from .hop_bfs import ops as _hop_ops
from .ssd_scan import ops as _ssd_ops

__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts"]

#: Every kernel wrapper of the port, by kernel name.
WRAPPERS = {
    "edge_laplacian": _el_ops.edge_laplacian,
    "edge_laplacian_blocks": _el_ops.edge_laplacian_blocks,
    "edge_quadform": _el_ops.edge_quadform,
    "edge_adjoint": _el_ops.edge_adjoint,
    "edge_schur_matvec": _el_ops.edge_schur_matvec,
    "hop_step": _hop_ops.hop_step,
    "gossip_mix_batched": _gossip_ops.gossip_mix_batched,
    "gossip_mix": _gossip_ops.gossip_mix,
    "decode_attention": _dec_ops.decode_attention,
    "decode_attention_partial": _dec_ops.decode_attention_partial,
    "ssd_intra_chunk": _ssd_ops.ssd_intra_chunk,
}


def launch_counts() -> dict[str, int]:
    """Kernel name → launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
