"""LayerNorm2d (``ops/layernorm2d.py``): the plain route on the CPU against
the expression ``LayerNorm2d.forward`` ran before the kernel pair existed,
the argument checks, the split ``plan`` at the encoder's shapes, and,
marked ``gpu``, the CUDA kernel pair against the plain version on the card
(skipped without one)."""
import math

import pytest
import torch
import torch.nn.functional as F

from nafp_tpu_torch.models import nnfp
from nafp_tpu_torch.ops import layernorm2d as L

# (C, F, T) after each of the 16 norms of the full-width encoder (1-s
# segments, 256 mels, 32 frames; portbench.reference.arch.convs)
FULL_SHAPES = [(128, 256, 16), (128, 128, 16), (128, 128, 8), (128, 64, 8),
               (256, 64, 4), (256, 32, 4), (256, 32, 2), (256, 16, 2),
               (512, 16, 2), (512, 8, 2), (512, 8, 1), (512, 4, 1),
               (1024, 4, 1), (1024, 2, 1), (1024, 2, 1), (1024, 1, 1)]
H100_SMS = 132


def old_expression(x, gamma, beta, eps):
    """``LayerNorm2d.forward`` before the kernel pair, verbatim."""
    x = F.elu(x)
    xf = x.float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def _inputs(shape, dtype, seed=0, device="cpu",
            fmt=torch.contiguous_format):
    """x and dy in ``fmt`` (the encoder's activations are channels last),
    gamma and beta contiguous."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    gamma = 1 + 0.3 * torch.randn(shape[1:], generator=g)
    beta = 0.2 * torch.randn(shape[1:], generator=g)
    dy = torch.randn(shape, generator=g).to(dtype)
    x, dy = (t.contiguous(memory_format=fmt) for t in (x, dy))
    return [t.to(device) for t in (x, gamma, beta, dy)]


def _grads(fn, x, gamma, beta, dy):
    x, gamma, beta = (t.detach().clone().requires_grad_(True)
                      for t in (x, gamma, beta))
    y = fn(x, gamma, beta, 1e-3)
    y.backward(dy)
    return y.detach(), x.grad, gamma.grad, beta.grad


FORMATS = [torch.contiguous_format, torch.channels_last]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 8, 16, 5), (2, 16, 8, 4)])
def test_plain_route_is_the_old_expression(dtype, shape, fmt):
    """On the CPU the module and the wrapper run today's arithmetic: the
    output and the gradients of x, gamma and beta equal the old
    expression's bit for bit, in either layout of x."""
    x, gamma, beta, dy = _inputs(shape, dtype, fmt=fmt)
    want = _grads(old_expression, x, gamma, beta, dy)
    got = _grads(L.layer_norm2d, x, gamma, beta, dy)
    mod = nnfp.LayerNorm2d(shape[1:])
    with torch.no_grad():
        mod.gamma.copy_(gamma)
        mod.beta.copy_(beta)
    xm = x.clone().requires_grad_(True)
    ym = mod(xm)
    ym.backward(dy)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(ym.detach(), want[0])
    assert torch.equal(xm.grad, want[1])
    assert torch.equal(mod.gamma.grad, want[2])
    assert torch.equal(mod.beta.grad, want[3])


def test_no_launch_on_the_cpu():
    L.reset_launches()
    x, gamma, beta, dy = _inputs((2, 4, 8, 4), torch.bfloat16)
    _grads(L.layer_norm2d, x, gamma, beta, dy)
    model = nnfp.FingerPrinter((256, 32), emb_sz=16,
                               front_hidden_ch=(8, 8, 16, 16, 16, 16, 32, 32),
                               dtype=torch.bfloat16)
    model(torch.randn(2, 256, 32, 1)).sum().backward()
    assert L.LAUNCHES == {"layer_norm2d": 0, "layer_norm2d_backward": 0}


def test_argument_checks():
    x, gamma, beta, _ = _inputs((2, 4, 8, 4), torch.bfloat16)
    with pytest.raises(TypeError, match="x: dtype"):
        L.layer_norm2d(x.half(), gamma, beta)
    with pytest.raises(TypeError, match="gamma: dtype"):
        L.layer_norm2d(x, gamma.double(), beta)
    with pytest.raises(TypeError, match="beta: dtype"):
        L.layer_norm2d(x, gamma, beta.bfloat16())
    g_t, b_t = (t.transpose(1, 2).contiguous() for t in (gamma, beta))
    with pytest.raises(ValueError, match="x: must be contiguous"):
        L.layer_norm2d(x.transpose(2, 3), g_t, b_t)
    with pytest.raises(ValueError, match="x: must be contiguous"):
        L.layer_norm2d(x[:, :, ::2], gamma[:, ::2].contiguous(),
                       beta[:, ::2].contiguous())
    with pytest.raises(ValueError, match=r"gamma: shape \(4, 4, 8\)"):
        L.layer_norm2d(x, gamma.permute(0, 2, 1).contiguous(), beta)
    with pytest.raises(ValueError, match=r"beta: shape \(8, 4\)"):
        L.layer_norm2d(x, gamma, beta[0])
    with pytest.raises(ValueError, match=r"x: shape \(2, 4, 32\)"):
        L.layer_norm2d(x.reshape(2, 4, 32), gamma, beta)
    with pytest.raises(ValueError, match="gamma: must be contiguous"):
        L.layer_norm2d(x, gamma.permute(0, 2, 1).contiguous()
                       .permute(0, 2, 1), beta)


@pytest.mark.parametrize("rows", [4, 125, 640])
@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_plan_at_the_encoder_shapes(rows, elem_bytes):
    """At every norm of the encoder: 16-byte loads; the forward cuts a
    sample into items of 256·vec·2; the backward reduce's position chunks of 32·vec·2 cover the
    sample once and its batch chunks the batch, its dgamma/dbeta partials
    (16 bytes a position and batch chunk) stay under a tenth of the
    activation's bytes when there is more than one chunk, and it asks for at
    least a wave of CTAs (two per SM) wherever that scratch rule allows."""
    for shape in FULL_SHAPES:
        n = math.prod(shape)
        p = L.plan(rows, n, elem_bytes, True, H100_SMS)
        vec = 16 // elem_bytes
        assert p.vec == vec
        assert p.chunks == -(-n // (512 * vec))
        assert (p.cols - 1) * 64 * vec < n <= p.cols * 64 * vec
        assert (p.n_bc - 1) * p.rows_per_chunk < rows <= (
            p.n_bc * p.rows_per_chunk)
        if p.n_bc > 1:
            assert 16 * p.n_bc * n <= 0.1 * rows * n * elem_bytes
        max_bc = max(1, int(0.1 * rows * elem_bytes) // 16)
        if p.n_bc < min(rows, max_bc):
            assert p.cols * p.n_bc >= 2 * H100_SMS


def test_plan_at_the_first_layer_of_640():
    """The train step's largest norm, 524,288 bf16 elements a sample at
    batch 640: items of 4,096 (128 a sample, 81,920 in all), the backward
    reduce in 1,024 position chunks x 3 batch chunks of 214 samples (3,072
    CTAs; 25 MB of partials against 671 MB of activation)."""
    assert L.plan(640, 524_288, 2, True, H100_SMS) == L.Plan(
        vec=8, chunks=128, cols=1024, rows_per_chunk=214, n_bc=3)


@pytest.mark.parametrize("n,aligned", [(4100, True), (4096, False)])
def test_plan_takes_one_element_a_load_otherwise(n, aligned):
    """A sample whose length is no multiple of 8 (bf16) or a pointer off
    16 bytes runs the same kernels one element a thread."""
    p = L.plan(16, n, 2, aligned, H100_SMS)
    assert p.vec == 1 and p.chunks == -(-n // 512) and p.cols == -(-n // 64)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("cut", ["t", "f", "none"])
def test_dy_read_through_its_strides(fmt, cut):
    """The backward reads dy as autograd hands it over, a slice of the next
    convolution's padded gradient, through its strides in x's memory order,
    dims merged where dy is dense across them; a layout without whole
    16-byte vectors along the innermost dim (or an expanded gradient) is
    copied first."""
    x = torch.empty((4, 16, 8, 6), dtype=torch.bfloat16).contiguous(
        memory_format=fmt)
    ch = L._channels(x)
    pad_f, pad_t = (1, 0) if cut == "f" else (0, 2) if cut == "t" else (0, 0)
    padded = torch.zeros((4, 16, 8 + pad_f, 6 + pad_t),
                         dtype=torch.bfloat16).contiguous(memory_format=fmt)
    dy = padded[:, :, :8, pad_t // 2:pad_t // 2 + 6]
    layout = L._dy_layout(dy, ch)
    n2, n3, *st = layout
    for b, p in enumerate((0, 5, 77, 767)):   # memory positions of x
        i1, i2, i3 = p // (n2 * n3), p // n3 % n2, p % n3
        off = b * st[0] + i1 * st[1] + i2 * st[2] + i3 * st[3]
        q = p
        if ch:                                # (F, T, C) order
            idx = (b, q % 16, q // (6 * 16), q // 16 % 6)
        else:
            idx = (b, q // 48, q // 6 % 8, q % 6)
        assert dy[idx].data_ptr() - dy.data_ptr() == 2 * off
    assert L._dy_loadable(dy, layout, 1)
    # channels last: 16 channels innermost, whole 16-byte vectors; NCHW:
    # rows of 6 where the slice cuts T, channels 54 elements apart where it
    # cuts F: vectors off 16 bytes
    assert L._dy_loadable(dy, layout, 8) == (bool(ch) or cut == "none")
    if cut == "none":
        assert layout[:2] == (1, 768) and layout[5] == 1
    ones = torch.ones(()).bfloat16().expand(4, 16, 8, 6)
    assert not L._dy_loadable(ones, L._dy_layout(ones, ch), 8)


def test_dy_of_the_last_norm():
    """The encoder's last norm, (C, 1, 1): x counts as contiguous in
    (C, F, T) order whatever the strides of its size-1 dims, and dy comes
    back from the flatten with strides of 1024 there: one dense dim."""
    dy = torch.zeros((4, 1024), dtype=torch.bfloat16).view(4, 1, 1, 1024)
    dy = dy.permute(0, 3, 1, 2)
    assert dy.stride() == (1024, 1, 1024, 1024) and dy.is_contiguous()
    layout = L._dy_layout(dy, L._channels(dy))
    assert layout == (1, 1024, 1024, 0, 0, 1)
    assert L._dy_loadable(dy, layout, 8)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at |v| (normal range): 2^(exponent - 7)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def ulp_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in bf16 ulps of the larger of |got|, |want|
    and 1e-3 of the largest |want|: where a value is that small, the last
    bits of the f32 statistics (summed in another order) can move it by more
    than its own ulp, so its error is counted in ulps of that floor."""
    got, want = got.double(), want.double()
    scale = torch.maximum(torch.maximum(got.abs(), want.abs()),
                          1e-3 * want.abs().max())
    return float(((got - want).abs() / bf16_ulp(scale)).max())


def param_gap(got: torch.Tensor, terms: torch.Tensor) -> float:
    """|got - Σ terms| over Σ|terms|, the sum over the batch in f64: an f32
    sum's rounding error scales with the sum of the absolute terms, not
    with the sum, which cancels to near 0 at some positions."""
    want = terms.sum(0)
    return float(((got.double() - want).abs()
                  / terms.abs().sum(0).clamp_min(1e-30)).max())


def f64_reference(x, gamma, dy):
    """x̂, and the per-position terms of dgamma and dbeta, in f64 from the
    rounded ELU (the function's v)."""
    v = F.elu(x).double()
    dims = tuple(range(1, x.dim()))
    mean = v.mean(dims, keepdim=True)
    var = (v - mean).square().mean(dims, keepdim=True)
    xh = (v - mean) / torch.sqrt(var + 1e-3)
    return dy.double() * xh, dy.double()


# y: 1 ulp (the f32 statistics differ in their last bits); dx: 2 ulps (dx
# is rounded twice, after the f32 gradient and after ELU's derivative, and
# its f32 sums come in another order); dgamma, dbeta: 1e-4 of Σ|terms| (an
# f32 sum over up to 640 samples)
Y_ULPS, DX_ULPS, PARAM_RTOL = 1.0, 2.0, 1e-4


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu():
    """The kernel pair against the plain version on the card, forward and
    backward, in bf16 at the 16 full-width shapes at batch 4 (x contiguous
    and channels last) and at the first layer at batch 640 (channels last,
    as in training, dy also as autograd hands it over there: a slice of the
    next convolution's padded gradient); two runs equal bit for bit, and
    the inference route (no gradient) the same output; one launch a
    forward and one a backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda", 0)
    last = torch.channels_last
    cases = [(4, s, f, False) for s in FULL_SHAPES for f in FORMATS] + [
        (640, FULL_SHAPES[0], last, False), (640, FULL_SHAPES[0], last, True)]
    for rows, shape, fmt, padded in cases:
        x, gamma, beta, dy = _inputs((rows, *shape), torch.bfloat16,
                                     seed=rows, device=dev, fmt=fmt)
        if padded:
            buf = torch.zeros((rows, shape[0], shape[1], shape[2] + 1),
                              dtype=dy.dtype, device=dev).contiguous(
                                  memory_format=fmt)
            buf[..., :shape[2]] = dy
            dy = buf[..., :shape[2]]
        L.reset_launches()
        got = _grads(L.layer_norm2d, x, gamma, beta, dy)
        again = _grads(L.layer_norm2d, x, gamma, beta, dy)
        torch.cuda.synchronize()
        assert L.LAUNCHES == {"layer_norm2d": 2, "layer_norm2d_backward": 2}
        want = _grads(L.layer_norm2d_plain, x, gamma, beta, dy)
        tag = f"B {rows} x {shape}, {fmt}, padded dy {padded}"
        assert ulp_gap(got[0], want[0]) <= Y_ULPS, tag
        assert ulp_gap(got[1], want[1]) <= DX_ULPS, tag
        g_terms, b_terms = f64_reference(x, gamma, dy)
        assert param_gap(got[2], g_terms) <= PARAM_RTOL, tag
        assert param_gap(got[3], b_terms) <= PARAM_RTOL, tag
        for a, b in zip(got, again):
            assert torch.equal(a, b), tag
        with torch.no_grad():             # inference: the forward alone
            assert torch.equal(L.layer_norm2d(x, gamma, beta), got[0]), tag
        assert L.LAUNCHES == {"layer_norm2d": 3, "layer_norm2d_backward": 2}
        del g_terms, b_terms


def every_bf16_up_to_16(dev):
    """x of one sample holding every bf16 value from -16 to 16 (signed
    zeros, subnormals), -100, the most negative finite value and -inf,
    padded with zeros to a multiple of 64 elements."""
    pos = torch.arange(0, 0x4181, dtype=torch.int16).view(torch.bfloat16)
    extra = torch.tensor([-100.0, -3.3895e38, float("-inf")],
                         dtype=torch.bfloat16)
    x = torch.cat([pos, -pos, extra])
    x = torch.cat([x, x.new_zeros(-len(x) % 64)])
    return x.view(1, 1, 1, -1).to(dev)


@pytest.mark.gpu
def test_elu_is_f_elu_at_every_bf16_on_gpu():
    """The kernels' bf16 ELU (a table of expm1f between 2^-12 and 6.25 in
    magnitude; x or -1 outside) equals F.elu's rounding bit for bit: with
    one sample and dy = 1 the backward returns dgamma = xhat as the kernels
    computed it, (v - mean)·rstd, which the plain arithmetic reproduces
    from F.elu's v and the kernels' own mean and rstd. A NaN makes its
    sample NaN, as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda", 0)
    x = every_bf16_up_to_16(dev)
    gamma = torch.ones(x.shape[1:], device=dev)
    _, mean, rstd, g_mem = L._forward(x, gamma, torch.zeros_like(gamma),
                                      1e-3)
    _, dgamma, _ = L._backward(torch.ones_like(x), x, g_mem, mean, rstd)
    want = (F.elu(x).float() - mean) * rstd
    assert torch.equal(dgamma.view(-1), want.view(-1))
    x[0, 0, 0, 7] = float("nan")
    assert L.layer_norm2d(x, gamma, torch.zeros_like(gamma)).isnan().all()
