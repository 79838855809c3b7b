"""The port's ``ssd_intra_chunk`` routes, on the CPU: the launch plans and
the tensor-core route's arithmetic.

No card here, so the kernels themselves run only in ``test_torch_cuda.py``;
these tests hold what the kernels are built from:

- ``kernel_plan`` and ``kernel_blocks`` (pure Python, decoded as the
  kernels decode their block index): every causal (t, s ≤ t) pair of every
  head and column of P in exactly one y block, every (head, p, n) of the
  chunk state in exactly one state block, within a block's 227 KB of shared
  memory, at mamba2-780m's shape, the reduced shape, a ragged Q 50 / P 30 /
  N 18 and a 70-token tail;
- ``bf16_terms``: the three bfloat16 terms of a float32 value add back to it
  exactly, from 1e-30 to 1e30;
- a plain-torch emulation of the bfloat16 route (G from bf16 operands in
  float32, M below the diagonal from the factored decay, M and w ⊙ x split
  into three bf16 terms, every product accumulated in float32) within a
  quarter of ``ssd_intra_chunk_bound`` of the plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ops as tssd  # noqa: E402

SHAPES = [(256, 48, 64, 128),      # mamba2-780m
          (32, 8, 32, 16),         # the reduced config
          (50, 5, 30, 18),         # ragged against every tile
          (70, 4, 64, 128)]        # a 70-token tail: one full row tile and 6 rows
SMEM_MAX = 232_448


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "cuda_core"),
                                         (torch.float16, "cuda_core")])
@pytest.mark.parametrize("Q,H,P,N", SHAPES)
def test_kernel_plan_covers_every_pair_once(dtype, route, Q, H, P, N):
    plan = tssd.kernel_plan(Q, H, P, N, dtype)
    assert plan["route"] == route
    assert plan["smem_bytes"] <= SMEM_MAX
    if route == "tensor_core":
        assert plan["terms"] == 3 and plan["blocks_per_sm"] >= 2
    blocks = tssd.kernel_blocks(plan, Q, H, P, N)
    thp = np.zeros((Q, H, P), dtype=np.int64)
    ts = np.zeros((Q, Q), dtype=np.int64)          # (t, s) of the blocks holding h 0, p 0
    hpn = np.zeros((H, P, N), dtype=np.int64)
    for b in blocks:
        (h0, h1), (p0, p1) = b["h"], b["p"]
        if b["kind"] == "y":
            (t0, t1), (s0, s1) = b["t"], b["s"]
            assert s0 == 0 and s1 >= t1                # every s ≤ t of its rows
            thp[t0:t1, h0:h1, p0:p1] += 1
            if h0 == 0 and p0 == 0:
                for t in range(t0, t1):
                    ts[t, :t + 1] += 1
        else:
            hpn[h0:h1, p0:p1, b["n"][0]:b["n"][1]] += 1
    assert (thp == 1).all()
    assert np.array_equal(ts, np.tril(np.ones((Q, Q), dtype=np.int64)))
    assert (hpn == 1).all()


def test_tensor_core_plan_at_the_main_shape():
    plan = tssd.kernel_plan(256, 48, 64, 128, torch.bfloat16)
    assert (plan["n_tiles"], plan["n_hg"], plan["n_pc"], plan["n_nch"]) == (4, 24, 1, 1)
    assert plan["n_state"] == 24 and plan["n_y"] == 96
    assert plan["stages"] == 2 and plan["threads"] == 256
    assert plan["smem_bytes"] == 110_080 and plan["blocks_per_sm"] == 2


def test_bf16_terms_add_back_exactly():
    rng = np.random.default_rng(0)
    mag = 10.0 ** rng.uniform(-30, 30, 20_000)
    v = torch.from_numpy((rng.choice([-1.0, 1.0], mag.size) * mag).astype(np.float32))
    v = torch.cat([v, torch.tensor([0.0, 1.0, -1.0, 3.0, 1e-30, 1e30, 16777215.0,
                                    float(np.nextafter(np.float32(1), np.float32(2)))])])
    hi, mid, lo = tssd.bf16_terms(v)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = hi.double() + mid.double() + lo.double()
    assert torch.equal(back, v.double())
    # two terms leave up to 2⁻¹⁶ of |v|: not float32's 2⁻²⁴
    assert float(((hi.double() + mid.double() - v.double()).abs() / v.double().abs()
                  .clamp_min(1e-300)).max()) > 2.0 ** -24


def _emulated(x, dt, la, Bm, Cm, tile=64):
    """The bfloat16 route's arithmetic in plain torch: G = C·Bᵀ from the
    bf16 operands in float32; M = G ⊙ exp(la_t − la_s) ⊙ dt_s on the
    diagonal tiles and (G·exp(la_t − la_r))·(exp(la_r − la_s)·dt_s) below
    them (r the s tile's last row); M and w ⊙ x (w = exp(la_{Q−1} − la)·dt)
    split into three bf16 terms; every product summed in float32."""
    Q = x.shape[2]
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    G = torch.einsum("bctn,bcsn->bcts", Cf, Bf)[:, :, None]         # (B, nc, 1, Q, Q)
    t = torch.arange(Q)
    r = ((t // tile) * tile + tile - 1).clamp(max=Q - 1)            # per s: its tile's last row
    laT, dtT = la.permute(0, 1, 3, 2), dt.permute(0, 1, 3, 2)       # (B, nc, H, Q)
    direct = (G * torch.exp(laT[..., :, None] - laT[..., None, :])) * dtT[..., None, :]
    e_t = torch.exp(laT[..., :, None] - laT[..., r][..., None, :])  # exp(la_t − la_r(s))
    f_s = torch.exp(laT[..., r] - laT) * dtT                        # exp(la_r − la_s)·dt_s
    below = (t[:, None] // tile) > (t[None, :] // tile)             # below the diagonal tiles
    M = torch.where(below, (G * e_t) * f_s[..., None, :], direct)
    M = torch.where(t[:, None] >= t[None, :], M, 0.0)
    y = sum(torch.einsum("bchts,bcshp->bcthp", term.float(), xf) for term in
            reversed(tssd.bf16_terms(M)))
    w = torch.exp(la[:, :, -1:, :] - la) * dt                        # (B, nc, Q, H)
    wx = xf * w[..., None]
    st = sum(torch.einsum("bcshp,bcsn->bchpn", term.float(), Bf) for term in
             reversed(tssd.bf16_terms(wx)))
    return y, st


@pytest.mark.parametrize("Bsz,nc,Q,H,P,N", [(2, 2, 32, 8, 32, 16), (1, 1, 256, 4, 64, 128)])
def test_bf16_route_arithmetic_within_a_quarter_of_the_bound(Bsz, nc, Q, H, P, N):
    rng = np.random.default_rng(Q + H)
    x = torch.from_numpy(rng.standard_normal((Bsz, nc, Q, H, P)).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((Bsz, nc, Q, N)).astype(np.float32))
    Cm = torch.from_numpy(rng.standard_normal((Bsz, nc, Q, N)).astype(np.float32))
    x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((Bsz, nc, Q, H)).astype(np.float32)))
    A = -torch.from_numpy((rng.random(H) + 0.05).astype(np.float32))
    la = torch.cumsum(A * dt, dim=2)
    args = (x, dt, la, Bm, Cm)
    y, st = _emulated(*args)
    wy, wst = tssd.ssd_intra_chunk_plain(*args)
    by, bst = tssd.ssd_intra_chunk_bound(*args)
    share = max(float(((y - wy).abs() / by).max()), float(((st - wst).abs() / bst).max()))
    assert share <= 0.25, f"the emulated route uses {share:.3f} of the bound"


def test_timeline_stamps_find_their_places_in_the_source():
    """The on-card timeline tool stamps a copy of csrc/ssd_scan.cu at fixed
    lines; each must still be there, once."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import timeline

    src = (build.CSRC / "ssd_scan.cu").read_text()
    for anchor, _ in timeline._AT:
        assert src.count(anchor) == 1, anchor
