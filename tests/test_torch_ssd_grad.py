"""``ssd_intra_chunk`` as a ``torch.autograd.Function``, on the CPU.

The Function's forward is the kernel on a CUDA tensor and the plain
version on the CPU; its backward, ``ssd_intra_chunk_backward``, is torch
ops that recompute the mask from the saved inputs. Here it is held against
``torch.autograd`` through ``ssd_intra_chunk_plain`` on the same inputs and
cotangents (numpy, from a seed):

- float64: every gradient within 1e-10 of the largest magnitude of that
  gradient (the two sum in other orders; float64 rounding is ~1e-16);
- float32: within 1e-5 of the largest magnitude (sums of up to Q·P
  products in other orders; measured below 3e-7 at these shapes);
- ``gradcheck`` (finite differences, float64) at a tiny shape;
- its ``vmap`` rule: ``vmap(grad)`` over three workers equals a loop over
  them, bit for bit, with one forward call for all three;
- only the five inputs are saved (no (B, nc, Q, Q, H) mask), and the
  gradients stay finite where a chunk's log-decay spans more than float32's
  exp range, where the JAX package's einsum route returns NaN.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import engine as _jax_engine  # noqa: E402,F401 — turns on x64
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

# (B, nc, Q, H, P, N): one chunk, a ragged head count, the reduced mamba2
SHAPES = [(1, 1, 8, 2, 4, 3), (2, 3, 16, 3, 8, 5), (2, 2, 32, 8, 32, 16)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(shape, dtype, seed=0, decay=1.0, lead=()):
    """x, dt (post-softplus), la = cumsum(A·dt) over each chunk, B, C and
    the two cotangents, from numpy."""
    Bsz, nc, Q, H, P, N = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (Bsz, nc, Q, H, P))
    dt = np.log1p(np.exp(rng.standard_normal(lead + (Bsz, nc, Q, H))))
    A = -(rng.random(H) + 0.05) * decay
    la = np.cumsum(A * dt, axis=-2)
    Bm = rng.standard_normal(lead + (Bsz, nc, Q, N))
    Cm = rng.standard_normal(lead + (Bsz, nc, Q, N))
    gy = rng.standard_normal(lead + (Bsz, nc, Q, H, P))
    gst = rng.standard_normal(lead + (Bsz, nc, H, P, N))
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return [t(a) for a in (x, dt, la, Bm, Cm)], t(gy), t(gst)


def _grads(fn, args, gy, gst):
    args = [a.detach().requires_grad_() for a in args]
    y, st = fn(*args)
    return torch.autograd.grad((y * gy).sum() + (st * gst).sum(), args)


def _assert_close(got, want, rel):
    for name, g, w in zip(("x", "dt", "la", "B", "C"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= rel * scale, (name, float((g - w).abs().max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_autograd_through_the_plain_version_float64(shape):
    args, gy, gst = _inputs(shape, torch.float64)
    got = _grads(ops.ssd_intra_chunk, args, gy, gst)
    want = _grads(ops.ssd_intra_chunk_plain, args, gy, gst)
    _assert_close(got, want, 1e-10)
    direct = ops.ssd_intra_chunk_backward(*args, gy, gst)
    assert all(torch.equal(a, b) for a, b in zip(got, direct))


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_backward_float32_within_its_bound(shape):
    args, gy, gst = _inputs(shape, torch.float32, seed=1)
    got = _grads(ops.ssd_intra_chunk, args, gy, gst)
    want = _grads(ops.ssd_intra_chunk_plain, args, gy, gst)
    _assert_close(got, want, 1e-5)


def test_backward_casts_to_the_input_dtypes():
    """bfloat16 x, B and C get bfloat16 gradients (autograd's rule), dt and
    la float32; the values are the float32 gradients rounded once."""
    args, gy, gst = _inputs(SHAPES[1], torch.float32, seed=2)
    args = [a.bfloat16() if i in (0, 3, 4) else a for i, a in enumerate(args)]
    got = _grads(ops.ssd_intra_chunk, args, gy, gst)
    assert [g.dtype for g in got] == [a.dtype for a in args]
    wide = ops.ssd_intra_chunk_backward(*[a.float() for a in args], gy, gst)
    assert all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, wide))


def test_gradcheck_at_a_tiny_shape():
    args, _, _ = _inputs((1, 2, 4, 2, 3, 2), torch.float64, seed=3)
    assert torch.autograd.gradcheck(ops.ssd_intra_chunk,
                                    tuple(a.requires_grad_() for a in args))


@pytest.mark.parametrize("b_batched", [True, False])
def test_vmap_grad_equals_a_worker_loop(b_batched, monkeypatch):
    """``vmap(grad)`` over three workers (B shared by all workers, or each
    worker's own) equals the loop over workers bit for bit, and the forward
    runs once, on the workers folded into the batch axis."""
    n = 3
    args, gy, gst = _inputs(SHAPES[1], torch.float32, seed=4, lead=(n,))
    if not b_batched:
        args[3] = args[3][0]
    calls = []
    launch = ops._launch

    def counting(*a):
        calls.append(tuple(a[0].shape))
        return launch(*a)

    monkeypatch.setattr(ops, "_launch", counting)

    def loss(x, dt, la, Bm, Cm, gy, gst):
        y, st = ops.ssd_intra_chunk(x, dt, la, Bm, Cm)
        return (y * gy).sum() + (st * gst).sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2, 3, 4))
    in_dims = (0, 0, 0, 0 if b_batched else None, 0, 0, 0)
    batched = torch.func.vmap(grad, in_dims=in_dims)(*args, gy, gst)
    assert calls == [(n * SHAPES[1][0],) + SHAPES[1][1:-1]]
    for i in range(n):
        one = grad(*[a if d is None else a[i] for a, d in zip(args + [gy, gst], in_dims)])
        assert all(torch.equal(b[i], o) for b, o in zip(batched, one)), i


def test_only_the_inputs_are_saved():
    args, _, _ = _inputs(SHAPES[2], torch.float32)
    args = [a.requires_grad_() for a in args]
    y, _ = ops.ssd_intra_chunk(*args)
    saved = y.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [tuple(a.shape) for a in args]


def test_float64_only_on_the_cpu_and_all_five():
    args, _, _ = _inputs(SHAPES[0], torch.float64)
    y, st = ops.ssd_intra_chunk(*args)
    assert y.dtype == st.dtype == torch.float64
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_intra_chunk(*args[:3], args[3].float(), args[4])


def test_gradients_finite_where_the_decay_overflows():
    """A chunk of 64 steps whose log-decay spans ~150 (e^150 is past
    float32's range): the gradients through the port's SSD scan are finite,
    and the Function's match float64 autograd through the plain version
    (whose exponent is masked before ``exp``), where the JAX package's
    einsum route returns NaN (the masked half's exp overflows to inf, and
    the ``where``'s zero gradient times inf is NaN)."""
    Q, H, P, N = 64, 2, 4, 3
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, Q, H, P)).astype(np.float32)
    dt = np.full((1, Q, H), 2.4, np.float32)
    A = np.array([-1.0, -0.5], np.float32)
    Bm = rng.standard_normal((1, Q, N)).astype(np.float32)
    Cm = rng.standard_normal((1, Q, N)).astype(np.float32)

    def jloss(dt):
        y, h = jssm.ssd_chunk_scan(jnp.asarray(x), dt, jnp.asarray(A), jnp.asarray(Bm),
                                   jnp.asarray(Cm), Q, use_kernel=False)
        return jnp.sum(y) + jnp.sum(h)

    assert bool(jnp.isnan(jax.grad(jloss)(jnp.asarray(dt))).any())
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    dtt = t[1].requires_grad_()
    y, h = tssm.ssd_chunk_scan(t[0], dtt, t[2], t[3], t[4], Q, use_kernel=True)
    assert bool(torch.isfinite(torch.autograd.grad(y.sum() + h.sum(), dtt)[0]).all())

    la = np.cumsum(A * dt, axis=1)[:, None]                       # (1, 1, Q, H)
    assert float(la.max() - la.min()) > 100
    chunked = [x[:, None], dt[:, None], la, Bm[:, None], Cm[:, None]]
    gy = rng.standard_normal((1, 1, Q, H, P))
    gst = rng.standard_normal((1, 1, H, P, N))
    args32 = [torch.from_numpy(np.ascontiguousarray(a)) for a in chunked]
    got = _grads(ops.ssd_intra_chunk, args32, torch.from_numpy(gy).float(),
                 torch.from_numpy(gst).float())
    want = _grads(ops.ssd_intra_chunk_plain, [a.double() for a in args32],
                  torch.from_numpy(gy), torch.from_numpy(gst))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _assert_close([g.double() for g in got], want, 1e-5)
