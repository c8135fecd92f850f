"""Port parity: the log-mel frontend of nafp_tpu_torch against the JAX
package's, on the same seeded waveforms (both on the CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafp_tpu.configuration import load_config
from nafp_tpu.ops import melspec as jmel
from nafp_tpu_torch.ops import melspec as tmel

# Tolerance on log10-mel values in [-80, 0]: both sides compute in f32 with
# different summation orders (XLA vs PyTorch matmuls); measured differences
# are ~2e-6, the log compression can amplify them near the +offset floor.
ATOL = 2e-4


def _cfg(feat="melspec"):
    cfg = load_config("default")
    cfg["MODEL"]["FEAT"] = feat
    return cfg


def _waves(n=4, zero_rows=()):
    x = np.random.default_rng(0).standard_normal((n, 8000)).astype(
        np.float32) * 0.3
    x[list(zero_rows)] = 0.0
    return x


def test_constants_identical():
    j, t = jmel.MelSpecConfig(), tmel.MelSpecConfig()
    assert j._asdict() == t._asdict()
    np.testing.assert_array_equal(jmel.dft_basis(1024), tmel.dft_basis(1024))
    np.testing.assert_array_equal(
        jmel.mel_filterbank(8000, 1024, 256, 300.0, 4000.0),
        tmel.mel_filterbank(8000, 1024, 256, 300.0, 4000.0))


@pytest.mark.parametrize("variant,feat,zero_rows", [
    ("default", "melspec", ()),
    ("lite", "melspec", ()),
    ("default", "melspec_maxnorm", ()),
    ("default", "melspec", (1, 3)),     # zero rows, as a padded last batch
])
def test_matches_jax(variant, feat, zero_rows):
    x = _waves(zero_rows=zero_rows)
    jf, jcfg = jmel.get_melspec_fn(_cfg(feat), variant)
    tf, tcfg = tmel.get_melspec_fn(_cfg(feat), variant)
    assert jcfg._asdict() == tcfg._asdict()
    want = np.asarray(jf(jnp.asarray(x)))
    got = tf(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 256, 32, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_batch_max_is_global():
    """The max is subtracted over the whole batch: a row's features
    change with its batch-mates, as in the JAX package."""
    x = _waves()
    cfg = tmel.MelSpecConfig()
    alone = tmel.melspectrogram(torch.from_numpy(x[:1]), cfg).numpy()
    batched = tmel.melspectrogram(torch.from_numpy(x), cfg).numpy()[:1]
    want = np.asarray(jmel.melspectrogram(jnp.asarray(x), jmel.MelSpecConfig()))
    np.testing.assert_allclose(batched, want[:1], atol=ATOL, rtol=0)
    assert np.abs(alone - batched).max() > 1e-3


def test_rejects_wrong_length():
    with pytest.raises(ValueError, match="waveform length"):
        tmel.melspectrogram(torch.zeros(2, 7999), tmel.MelSpecConfig())
