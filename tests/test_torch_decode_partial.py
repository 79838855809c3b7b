"""The rank form of ``decode_attention`` and its merge
(``repro_torch.kernels.decode_attention.ops``: ``decode_attention_partial``,
its plain version, ``merge_partials``) against the JAX package's
``repro.kernels.decode_attention.ref.decode_attention`` on the whole cache,
in this process on the CPU.

A KV cache of C = 26 slots is split along its sequence into 1, 2, 3 or 4
slices (``np.array_split``: uneven where C does not divide), the rank
form's plain version runs on each slice, and ``merge_partials`` (``group``
None: the slices stacked on a leading axis, reduced in this process, the
same arithmetic as its all-reduces over ranks) combines them. Cases: GQA
groups 1, 3 and 7; softcap 0 and 50; masks where some slices hold no valid
key (a linear cache part filled, the upper half empty, a window) and where
none does (the answer is then the mean over all C values, as ``ref.py``'s
softmax of an all −1e30 row).

Tolerance: float32, 1e-6 absolute (the values are O(1); the slices' sums
and the merge add in another order than the whole softmax).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.decode_attention import ref as jref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tdec  # noqa: E402

B, C, HKV, HD = 2, 26, 2, 16
ATOL = 1e-6
MASKS = {
    "linear": np.arange(C) <= 17,                    # a 4-way split's last slice is empty
    "upper_empty": np.arange(C) <= 9,                # the upper half holds nothing yet
    "window": (np.arange(C) > 5) & (np.arange(C) <= 20),
    "none": np.zeros(C, bool),                       # no slice holds a valid key
}


def _inputs(group: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * group, HD)).astype(np.float32)
    k = rng.standard_normal((B, C, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, C, HKV, HD)).astype(np.float32)
    return q, k, v


def _merged(q, k, v, valid, slices: int, cap: float) -> np.ndarray:
    outs, lses, keys = [], [], []
    for idx in np.array_split(np.arange(C), slices):
        out, lse = tdec.decode_attention_partial_plain(
            torch.from_numpy(q), torch.from_numpy(k[:, idx]), torch.from_numpy(v[:, idx]),
            torch.from_numpy(valid[idx]), attn_softcap=cap)
        assert out.dtype == torch.float32 and lse.shape == (B, q.shape[1])
        outs.append(out)
        lses.append(lse)
        keys.append(len(idx))
    return tdec.merge_partials(torch.stack(outs), torch.stack(lses), keys=keys).numpy()


@pytest.mark.parametrize("slices", [1, 2, 3, 4])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("group", [1, 3, 7])
def test_merged_slices_are_ref_on_the_whole_cache(group, cap, mask, slices):
    q, k, v = _inputs(group, seed=group * 100 + slices)
    valid = MASKS[mask]
    want = np.asarray(jref.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(valid), attn_softcap=cap))
    got = _merged(q, k, v, valid, slices, cap)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ATOL, np.abs(got - want).max()


def test_an_empty_slice_drops_out_and_none_valid_gives_the_mean():
    """A slice with no valid key gets lse −1e30 (its weight e^(−1e30 − M) is
    0); where no slice holds one, the slices weigh by their slots and the
    result is the mean of all C values, even over uneven slices."""
    q, k, v = _inputs(3, seed=7)
    none = np.zeros(C, bool)
    idx = np.array_split(np.arange(C), 3)
    _, lse = tdec.decode_attention_partial_plain(
        torch.from_numpy(q), torch.from_numpy(k[:, idx[2]]), torch.from_numpy(v[:, idx[2]]),
        torch.from_numpy(none[idx[2]]))
    assert bool((lse == -1e30).all())
    mean = v.mean(axis=1)                                     # (B, Hkv, hd)
    want = np.repeat(mean, 3, axis=1)                         # each kv head's 3 query heads
    got = _merged(q, k, v, none, 3, 0.0)
    assert np.abs(got - want).max() <= ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_rank_form_on_the_cpu_is_its_plain_version(dtype):
    """On CPU tensors the wrapper takes its plain version (no launch): the
    float32 output and lse bitwise, whatever q's dtype; the whole-cache form
    is the rank form cast once."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(3, seed=11))
    valid = torch.from_numpy(MASKS["linear"])
    before = tdec.decode_attention_partial.launches
    out, lse = tdec.decode_attention_partial(q, k, v, valid, attn_softcap=50.0)
    plain = tdec.decode_attention_partial_plain(q, k, v, valid, attn_softcap=50.0)
    assert tdec.decode_attention_partial.launches == before
    assert out.dtype == torch.float32 and torch.equal(out, plain[0])
    assert torch.equal(lse, plain[1])
    whole = tdec.decode_attention(q, k, v, valid, attn_softcap=50.0)
    assert torch.equal(whole, out.to(dtype))


def test_the_rank_form_checks_its_shapes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, seed=3))
    with pytest.raises(ValueError, match="valid must be"):
        tdec.decode_attention_partial(q, k, v, torch.ones(C - 1, dtype=torch.bool))
    with pytest.raises(TypeError, match="decode_attention_partial takes"):
        tdec.decode_attention_partial(q, k.double(), v, torch.ones(C, dtype=torch.bool))
