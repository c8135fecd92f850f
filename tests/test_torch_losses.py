"""Port parity: NT-Xent (nafp_tpu_torch.losses.ntxent) against the JAX
package's ``ntxent_loss``, loss and gradients, on the CPU in f32, and the
local-rows form: four shards with their offsets sum to the one-replica
loss."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafp_tpu.losses.ntxent import ntxent_loss as jax_ntxent
from nafp_tpu_torch.losses.ntxent import LARGE_NUM, ntxent_loss

# f32 on both sides, sums in other orders; tau 0.05 scales the similarity
# rounding by 20 in logit space: loss and logits within 1e-5 relative,
# gradients within 1e-4 of their largest entry.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,tau", [(16, 32, 0.05), (5, 8, 0.1),
                                     (60, 128, 0.05)])
def test_ntxent_loss_and_grads_match_jax(n, d, tau):
    rng = np.random.default_rng(n)
    ha, hb = _unit_rows(rng, n, d), _unit_rows(rng, n, d)
    (want, want_sim), want_g = jax.value_and_grad(
        lambda a, b: jax_ntxent(a, b, tau=tau), argnums=(0, 1),
        has_aux=True)(jnp.asarray(ha), jnp.asarray(hb))
    ta = torch.from_numpy(ha).requires_grad_()
    tb = torch.from_numpy(hb).requires_grad_()
    got, sim = ntxent_loss(ta, tb, tau=tau)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert sim.shape == (n, 2 * n)
    # the masked diagonal stays masked; the rest agrees
    s, w = sim.detach().numpy(), np.asarray(want_sim)
    np.testing.assert_allclose(s[s > -LARGE_NUM / 2], w[w > -LARGE_NUM / 2],
                               rtol=LOSS_RTOL, atol=1e-4)
    for t, g in zip((ta, tb), want_g):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g,
                                   atol=GRAD_RTOL * np.abs(g).max())


def test_four_local_shards_sum_to_the_one_replica_loss():
    rng = np.random.default_rng(7)
    n, d, r = 32, 16, 4
    ha = torch.from_numpy(_unit_rows(rng, n, d))
    hb = torch.from_numpy(_unit_rows(rng, n, d))
    single, sim = ntxent_loss(ha, hb, tau=0.05)
    nl = n // r
    shards = [ntxent_loss(ha[i * nl:(i + 1) * nl], hb[i * nl:(i + 1) * nl],
                          tau=0.05, gathered=(ha, hb), offset=i * nl)
              for i in range(r)]
    np.testing.assert_allclose(float(sum(s[0] for s in shards)),
                               float(single), rtol=LOSS_RTOL)
    np.testing.assert_allclose(torch.cat([s[1] for s in shards]).numpy(),
                               sim.numpy(), rtol=1e-6)
    # and that is the JAX package's loss of the whole batch
    want, _ = jax.jit(functools.partial(jax_ntxent, tau=0.05))(
        jnp.asarray(ha.numpy()), jnp.asarray(hb.numpy()))
    np.testing.assert_allclose(float(single), float(want), rtol=LOSS_RTOL)
