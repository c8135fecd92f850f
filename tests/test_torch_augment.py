"""Port parity: time-domain augmentation (nafp_tpu_torch.ops.tdaug) and
SpecAugment (nafp_tpu_torch.ops.specaug) against the JAX package's, on the
CPU. The random draws are taken from the JAX key exactly as the JAX
function splits it (``jax.random`` and ``nafp_tpu.ops.specaug._hole_ranges``
called here) and injected into the port, so both compute on the same
SNRs, amplitudes, holes and gates."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafp_tpu.ops import specaug as JS
from nafp_tpu.ops import tdaug as JT
from nafp_tpu_torch.ops import specaug as PS
from nafp_tpu_torch.ops import tdaug as PT

# f32 on both sides: RMS sums and FFTs in other orders (pocketfft vs
# PyTorch's FFT); outputs are max-normalised to |x| <= 1.
WAVE_ATOL = 1e-5
FFT_ATOL = 2e-5
# SpecAugment copies or fills: exact, but the 'min' filler is the batch
# mean of ~49k log-mel values in [-80, 0], summed in another order (and,
# through a chain, of earlier fills), and the random filler is scaled in
# another order: within 1.25e-5 of the 80 dB range (measured 4.8e-4)
SPEC_ATOL = 1e-3
KEY = jax.random.PRNGKey(11)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_bg_draws(key, b, snr_range=(0.0, 10.0), amp_range=(0.1, 1.0)):
    """(snr, amp) as JT.bg_mix_batch draws them from ``key``."""
    k_snr, k_amp = jax.random.split(key)
    snr = jax.random.uniform(k_snr, (b, 1), minval=min(snr_range),
                             maxval=max(snr_range))
    amp = 10.0 ** jax.random.uniform(k_amp, (b, 1),
                                     minval=math.log10(amp_range[0]),
                                     maxval=math.log10(amp_range[1]))
    return dict(snr=_t(snr), amp=_t(amp))


def _waves(rng, b, t):
    return rng.standard_normal((b, t)).astype(np.float32)


@pytest.mark.parametrize("snr_range", [(0.0, 10.0), (5.0, 5.0)])
def test_bg_mix_matches_jax(snr_range):
    rng = np.random.default_rng(1)
    x, bg = _waves(rng, 6, 8000), _waves(rng, 6, 8000)
    x[1] = 0.0                                # zero-energy fallbacks
    bg[2] = 0.0
    want = np.asarray(JT.bg_mix_batch(jnp.asarray(x), jnp.asarray(bg), KEY,
                                      snr_range))
    got = PT.bg_mix_batch(_t(x), _t(bg), snr_range=snr_range,
                          **_jax_bg_draws(KEY, 6, snr_range)).numpy()
    np.testing.assert_allclose(got, want, atol=WAVE_ATOL, rtol=0)
    # the fallback rows are amp * max_normalize(x + bg)
    d = _jax_bg_draws(KEY, 6, snr_range)
    for i, src in ((1, bg[1]), (2, x[2])):
        np.testing.assert_allclose(
            got[i], d["amp"][i].item() * src / np.abs(src).max(), atol=1e-6)


@pytest.mark.parametrize("t,ir_len", [(8000, 600), (8000, 800), (500, 600)])
def test_ir_aug_matches_jax(t, ir_len):
    """800 taps: cut to 600; T 500 < 600: the FFT length is the IR's."""
    rng = np.random.default_rng(t + ir_len)
    x = _waves(rng, 3, t)
    ir = _waves(rng, 3, ir_len) * np.exp(-np.arange(ir_len) / 80.0)[None]
    ir[:, 650:] += 5.0 * (ir_len > 650)      # past the cut: must not matter
    want = np.asarray(JT.ir_aug_batch(jnp.asarray(x), jnp.asarray(ir)))
    got = PT.ir_aug_batch(_t(x), _t(ir)).numpy()
    np.testing.assert_allclose(got, want, atol=FFT_ATOL, rtol=0)
    if ir_len > 600:
        np.testing.assert_array_equal(
            got, PT.ir_aug_batch(_t(x), _t(ir[:, :600])).numpy())


@pytest.mark.parametrize("use_bg,use_ir,use_speech", [
    (True, True, False), (True, True, True), (False, True, True),
    (True, False, False), (False, False, False)])
def test_augment_replicas_matches_jax(use_bg, use_ir, use_speech):
    rng = np.random.default_rng(3)
    xp, bg, sp = (_waves(rng, 4, 8000) for _ in range(3))
    ir = _waves(rng, 4, 600) * np.exp(-np.arange(600) / 50.0)[None]
    want = np.asarray(JT.augment_replicas(
        jnp.asarray(xp), jnp.asarray(bg), jnp.asarray(ir), KEY, (0.0, 10.0),
        use_bg=use_bg, use_ir=use_ir, speech=jnp.asarray(sp),
        use_speech=use_speech))
    got = PT.augment_replicas(_t(xp), _t(bg), _t(ir), None, (0.0, 10.0),
                              use_bg=use_bg, use_ir=use_ir, speech=_t(sp),
                              use_speech=use_speech,
                              **_jax_bg_draws(KEY, 4)).numpy()
    np.testing.assert_allclose(got, want, atol=FFT_ATOL, rtol=0)


def _jax_spec_draws(key, chain, probs, n_holes, uniform_mask, shape):
    """Per-layer draws as JS.spec_augment splits ``key``."""
    bsz, h, w, _ = shape
    b = 1 if uniform_mask else bsz
    out = []
    for i, k in enumerate(jax.random.split(key, len(chain))):
        k_holes, k_act, k_fill, k_sample = jax.random.split(k, 4)
        n = n_holes if chain[i] == "cutout" else 1
        ranges = JS._hole_ranges(k_holes, chain[i], b, n, h, w)
        if uniform_mask:
            act = jax.random.uniform(k_sample, (bsz, 1, 1, 1)) < probs[i]
        else:
            act = jax.random.uniform(k_act, (b, n)) < probs[i]
        out.append(dict(ranges=tuple(_t(r).long() for r in ranges),
                        act=_t(act),
                        fill=_t(jax.random.uniform(k_fill, shape))))
    return out


@pytest.mark.parametrize("chain,probs,hole_fill,uniform_mask", [
    (("cutout", "horizontal"), (1.0, 1.0), "zeros", True),
    (("cutout", "horizontal"), (1.0, 1.0), "min", True),
    (("cutout", "vertical", "horizontal"), (0.5, 0.7, 0.6), "min", True),
    (("cutout", "horizontal"), (0.0, 0.0), "zeros", True),
    (("cutout", "vertical"), (0.6, 0.6), "zeros", False),
    (("cutout",), (1.0,), "random", True),
    (("cutout",), (1.0,), (-2.0, -1.0), True),
])
def test_spec_augment_matches_jax(chain, probs, hole_fill, uniform_mask):
    rng = np.random.default_rng(5)
    x = rng.uniform(-80, 0, (6, 256, 32, 1)).astype(np.float32)
    kw = dict(chain=chain, probs=probs, n_holes=2, hole_fill=hole_fill,
              uniform_mask=uniform_mask)
    want = np.asarray(JS.spec_augment(jnp.asarray(x), KEY, **kw))
    draws = _jax_spec_draws(KEY, chain, probs, 2, uniform_mask, x.shape)
    got = PS.spec_augment(_t(x), None, draws=draws, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=SPEC_ATOL, rtol=0)
    if probs[0] == 0.0:
        np.testing.assert_array_equal(got, x)       # probability 0: identity
    elif uniform_mask and hole_fill == "zeros":
        holes = got == 0
        gate = draws[0]["act"][:, 0, 0, 0].numpy()
        # one mask for the whole batch: every gated sample has the same holes
        gated = holes[gate]
        assert gated.any() and (gated == gated[:1]).all()


def test_spec_augment_draws_from_the_generator():
    """Without injected draws the generator decides, reproducibly."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -80, 0, (4, 256, 32, 1)).astype(np.float32))
    a, b = (PS.spec_augment(x, torch.Generator().manual_seed(9), n_holes=2)
            for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, x)
    c = PT.augment_replicas(x[:, :10, 0, 0] * 0 + 1, x[:, 10:20, 0, 0], None,
                            torch.Generator().manual_seed(1))
    assert c.shape == (4, 10) and torch.isfinite(c).all()
