"""Port parity: LAMB and Adam (nafp_tpu_torch.optim) against the JAX
package's optimizers over 3 steps with identical gradients on a Flax-shaped
parameter tree (conv kernel, layer-norm volume, DivEnc weights, a zero
leaf), and the learning-rate schedules at several steps, on the CPU; and
LAMB with the port's model on the card (its kernel pair) against the JAX
package on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafp_tpu.optim import schedules as J
from nafp_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from nafp_tpu_torch.models.nnfp import FingerPrinter
from nafp_tpu_torch.optim import lamb as L
from nafp_tpu_torch.optim import schedules as P

SMALL_CH = (8, 8, 16, 16, 32, 32, 64, 64)
# f32 on both sides; the updates' sums and divisions run in other orders,
# and Adam's update divides by sqrt(v) + 1e-7, which amplifies rounding:
# parameters within 1e-6 relative to each leaf's scale after 3 steps.
PARAM_RTOL = 1e-6
# The JAX schedules evaluate in f32: within 1e-6 relative, or 1e-6 of the
# initial rate where the cosine nears its floor.
SCHED_RTOL = 1e-6


def _cfg(optimizer, schedule="cos", lr=1e-3):
    from nafp_tpu_torch.configuration import load_config
    cfg = load_config("default")
    cfg["TRAIN"].update(OPTIMIZER=optimizer, LR=lr, LR_SCHEDULE=schedule)
    return cfg


@pytest.mark.parametrize("optimizer", ["Adam", "LAMB"])
@pytest.mark.parametrize("schedule", ["cos", "cos-restart"])
def test_optimizer_matches_jax(optimizer, schedule):
    _against_jax(optimizer, schedule, torch.device("cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["cos", "cos-restart"])
def test_lamb_on_the_card_matches_jax(schedule):
    """The port's parameters, gradients and moments on the card, so that
    ``Lamb.step`` updates the 68 leaves by ``csrc/lamb.cu``'s kernel pair,
    one launch of each a step, held against the JAX package's LAMB on the
    CPU within the same PARAM_RTOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    L.reset_launches()
    _against_jax("LAMB", schedule, torch.device("cuda", 0))
    assert L.LAUNCHES == {"lamb_moments": 3, "lamb_apply": 3}


def _against_jax(optimizer, schedule, device):
    cfg = _cfg(optimizer, schedule)
    model = FingerPrinter((256, 32), emb_sz=16, front_hidden_ch=SMALL_CH,
                          seed=5)
    rng = np.random.default_rng(3)
    with torch.no_grad():   # a zero leaf: its trust ratio is 1
        model.conv_layers[2].conv_1x3.bias.zero_()
        for name, p in model.named_parameters():
            if name != "conv_layers.2.conv_1x3.bias":
                p.add_(torch.from_numpy(0.1 * rng.standard_normal(
                    p.shape).astype(np.float32)))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    torch_to_flax(model.state_dict()))
    model.to(device)
    total = 20
    jopt = J.build_optimizer(cfg, total)
    jstate = jopt.init(params)
    jupdate = jax.jit(jopt.update)
    topt, sched = P.build_optimizer(cfg, model, total)
    names = [n for n, _ in model.named_parameters()]
    for step in range(3):
        grads = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32)) for n, p in model.named_parameters()}
        grads["conv_layers.2.conv_1x3.bias"].zero_()
        jgrads = jax.tree_util.tree_map(jnp.asarray,
                                        torch_to_flax(grads, "layer_norm2d"))
        updates, jstate = jupdate(jgrads, jstate, params)
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
        for g in topt.param_groups:
            g["lr"] = sched(step)
        for n, p in model.named_parameters():
            p.grad = grads[n].to(device)
        topt.step()
        want = flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
        got = {n: t.cpu() for n, t in model.state_dict().items()}
        for n in names:
            w = want[n].numpy()
            np.testing.assert_allclose(
                got[n].numpy(), w, rtol=0,
                atol=PARAM_RTOL * max(np.abs(w).max(), 1e-3),
                err_msg=f"{optimizer} {schedule} step {step + 1}: {n}")
    zero = got["conv_layers.2.conv_1x3.bias"].numpy()
    assert np.isfinite(zero).all()


def test_lamb_exclusion_patterns_match_flax_paths():
    model = FingerPrinter((256, 32), emb_sz=16, front_hidden_ch=SMALL_CH)
    groups = P.lamb_groups(model, exclude_from_weight_decay=("['bias']",
                                                             "LayerNorm2d"))
    by_wd = {g.get("weight_decay", 1e-6): len(g["params"]) for g in groups}
    n_bias = sum(1 for n, _ in model.named_parameters()
                 if n.endswith(".bias") or n.endswith(".b1")
                 or n.endswith(".b2"))
    n_norm = sum(1 for n, _ in model.named_parameters()
                 if ".norm_" in n)
    # conv biases (16) and LayerNorm2d gamma/beta (32) excluded; DivEnc's
    # b1/b2 are Flax leaves 'b1'/'b2', not 'bias'
    assert by_wd[0.0] == (n_bias - 2) + n_norm
    assert P.flax_keystr("conv_layers.0.norm_2.gamma", "layer_norm2d") == \
        "['params']['conv_layer_0']['LayerNorm2d_1']['gamma']"


@pytest.mark.parametrize("kind,total", [("cos", 1000), ("cos-restart", 1000),
                                        ("None", 1000), ("cos", 7)])
def test_schedules_match_jax(kind, total):
    cfg = _cfg("Adam", kind, lr=3e-4)
    js, ps = J.build_lr_schedule(cfg, total), P.build_lr_schedule(cfg, total)
    for step in (0, 1, 5, 99, 100, 101, 250, 299, 300, 301, 700, 999, 1000,
                 2000):
        np.testing.assert_allclose(ps(step), float(js(jnp.asarray(step))),
                                   rtol=SCHED_RTOL, atol=SCHED_RTOL * 3e-4,
                                   err_msg=f"{kind} step {step}")
