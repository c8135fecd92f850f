"""LAMB's kernel pair (``csrc/lamb.cu`` through ``optim/lamb.py``): the CPU
route against the per-leaf loop it was before the kernel pair existed, bit
for bit; the host side of the card's route (which leaves go, with which
flags, into which launches, and the leaf table at ``640_lamb``'s 68
leaves); a torch mirror of the kernels' two-pass arithmetic against the
per-leaf loop; and, marked ``gpu``, the kernel pair against the plain
version on the card (skipped without one)."""
import pytest
import torch

from nafp_tpu_torch.configuration import load_config
from nafp_tpu_torch.optim import lamb as L
from nafp_tpu_torch.optim.schedules import build_optimizer
from nafp_tpu_torch.train.trainer import build_fp

# the mirror's and the kernels' f32 operations round as the loop's, but
# the loop's adds may fuse into FMAs and the norms sum in other orders:
# parameters and moments within 1e-6 of each leaf's largest |value| after
# 3 steps; the parameters' change within 1e-4 of its norm (f64), since each
# side rounds p + change to f32: half an ulp of a LayerNorm scale near 1 is
# ~6e-8 against a change of ~1e-3 an element at lr 1e-3
PARAM_RTOL = 1e-6
CHANGE_RTOL = 1e-4


class OldLamb(torch.optim.Optimizer):
    """``Lamb.step`` before the kernel pair existed, verbatim."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=1e-6, layer_adaptation=True):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      layer_adaptation=layer_adaptation))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt()
                                                + eps)
                if wd:
                    update.add_(p, alpha=wd)
                if group["layer_adaptation"]:
                    w_norm = torch.linalg.vector_norm(p)
                    u_norm = torch.linalg.vector_norm(update)
                    ratio = torch.where(
                        (w_norm > 0) & (u_norm > 0),
                        w_norm / torch.where(u_norm > 0, u_norm, 1.0), 1.0)
                    p.add_(-lr * ratio * update)
                else:
                    p.add_(update, alpha=-lr)


# leaves: sizes that are not multiples of 4 or span several chunks, a zero
# leaf (its trust ratio is 1), a leaf without a gradient
SHAPES = [(3, 5, 7), (2 * L.CHUNK + 3,), (L.CHUNK,), (64, 2), (9,), (130,),
          (33,)]
ZERO, NO_GRAD = 4, 5


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    ps = [torch.nn.Parameter(torch.randn(s, generator=g)) for s in SHAPES]
    with torch.no_grad():
        ps[ZERO].zero_()
    return ps


def _groups(ps):
    """Three groups as ``schedules.lamb_groups`` builds them: the default,
    one without weight decay, one without decay or layer adaptation."""
    return [dict(params=ps[:3]),
            dict(params=ps[3:5], weight_decay=0.0),
            dict(params=ps[5:], weight_decay=0.0, layer_adaptation=False)]


def _grads(step, seed=1):
    g = torch.Generator().manual_seed(seed + step)
    return [None if i == NO_GRAD else torch.randn(s, generator=g)
            for i, s in enumerate(SHAPES)]


def _run(opt_cls, steps=3, lr=1e-2, **kw):
    ps = _params()
    opt = opt_cls(_groups(ps), lr=lr, **kw)
    for step in range(steps):
        for p, g in zip(ps, _grads(step)):
            p.grad = g
        opt.step()
    return ps, opt


def test_cpu_route_is_the_old_loop_bit_for_bit():
    got, opt = _run(L.Lamb)
    want, old = _run(OldLamb)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
        sa, sb = opt.state[a], old.state[b]
        assert sa.keys() == sb.keys(), i
        if sa:
            assert sa["step"] == sb["step"] == 3
            assert torch.equal(sa["exp_avg"], sb["exp_avg"])
            assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    assert not opt.state[got[NO_GRAD]]


def mirror_update(leaves):
    """The kernel pair's arithmetic in torch on the CPU, launch by launch
    of ``launch_plan`` over ``leaf_table``'s chunks: pass 1 writes m and v
    of every chunk and its partial sums of p·p and u·u, pass 2 sums each
    leaf's partials in a fixed order, forms the trust ratio and writes p
    from u recomputed out of p, m and v. Returns the leaves updated."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)   # noqa: E731
    plan = L.launch_plan(leaves)
    for launch in plan:
        _, sizes, chunk0, wd, adapt = L.leaf_table(launch)
        first = launch[0]
        (b1, b2), t = first.betas, first.step
        b1_, b2_, c1, c2 = f32(b1), f32(b2), f32(1 - b1), f32(1 - b2)
        bc1, bc2, eps = f32(1 - b1 ** t), f32(1 - b2 ** t), f32(first.eps)

        def update(p, m, v, i):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return u + f32(wd[i]) * p if wd[i] else u

        def chunks(i, leaf):
            flat = [x.view(-1) for x in leaf[:4]]
            for c in range(int(chunk0[i]), int(chunk0[i + 1])):
                lo = (c - int(chunk0[i])) * L.CHUNK
                yield c, [x[lo:lo + L.CHUNK] for x in flat]

        partials = torch.empty(int(chunk0[-1]), 2)
        for i, leaf in enumerate(launch):
            for c, (p, g, m, v) in chunks(i, leaf):
                m.copy_(m * b1_ + c1 * g)
                v.copy_(v * b2_ + (c2 * g) * g)
                u = update(p, m, v, i)
                partials[c] = torch.stack([(p * p).sum(), (u * u).sum()])
        for i, leaf in enumerate(launch):
            ratio = f32(1.0)
            if adapt[i]:
                wn, un = partials[chunk0[i]:chunk0[i + 1]].sum(0).sqrt()
                if wn > 0 and un > 0:
                    ratio = wn / un
            scale = f32(-first.lr) * ratio
            for _, (p, _, m, v) in chunks(i, leaf):
                p.copy_(p + scale * update(p, m, v, i))
    return sum(len(launch) for launch in plan)


@pytest.fixture
def card_route(monkeypatch):
    """``Lamb.step``'s card route on CPU tensors: the device check says
    CUDA and ``fused_update`` is the mirror; the leaves each call was
    handed are recorded."""
    calls = []

    def fused(leaves):
        calls.append(list(leaves))
        return mirror_update(leaves)
    monkeypatch.setattr(L.kernels, "all_on_cpu", lambda *ts: False)
    monkeypatch.setattr(L, "fused_update", fused)
    return calls


def _gap(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _change_gap(a, b, p0):
    """|(a - p0) - (b - p0)| over |b - p0|, in f64."""
    a, b, p0 = (x.detach().double() for x in (a, b, p0))
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b - p0))


def test_mirror_of_the_kernel_pair_matches_the_loop(card_route):
    """The two-pass arithmetic through ``Lamb.step``'s card route against
    the per-leaf loop over 3 steps: a zero-norm leaf, a group without
    weight decay, one without layer adaptation, leaves over several chunks
    and of sizes not a multiple of 4."""
    got, opt = _run(L.Lamb)
    want, old = _run(OldLamb)
    p0 = _params()
    assert len(card_route) == 3
    for i, (a, b) in enumerate(zip(got, want)):
        if i == NO_GRAD:
            assert torch.equal(a, p0[i]) and not opt.state[a]
            continue
        assert _gap(a, b) <= PARAM_RTOL, i
        assert _change_gap(a, b, p0[i]) <= CHANGE_RTOL, i
        for k in ("exp_avg", "exp_avg_sq"):
            assert _gap(opt.state[a][k], old.state[b][k]) <= PARAM_RTOL, i
        assert opt.state[a]["step"] == 3
    assert got[ZERO].abs().max() > 0      # moved by its gradient, ratio 1


def test_card_route_hands_over_the_leaves_with_their_flags(card_route):
    """Leaves without a gradient stay out; every leaf carries its group's
    weight decay and adaptation flag and the step its update makes; the
    steps are counted once the leaves are handed over."""
    ps = _params()
    opt = L.Lamb(_groups(ps), lr=0.5, betas=(0.8, 0.99), eps=1e-5)
    for step in range(2):
        for p, g in zip(ps, _grads(step)):
            p.grad = g
        opt.step()
    leaves = card_route[1]
    assert [leaf.p for leaf in leaves] == [p for i, p in enumerate(ps)
                                           if i != NO_GRAD]
    assert [(leaf.wd, leaf.adapt) for leaf in leaves] == [
        (1e-6, True)] * 3 + [(0.0, True)] * 2 + [(0.0, False)]
    assert {(leaf.lr, leaf.betas, leaf.eps, leaf.step)
            for leaf in leaves} == {(0.5, (0.8, 0.99), 1e-5, 2)}
    for leaf in leaves:
        assert leaf.g is leaf.p.grad
        assert leaf.m is opt.state[leaf.p]["exp_avg"]
        assert leaf.v is opt.state[leaf.p]["exp_avg_sq"]
        assert opt.state[leaf.p]["step"] == 2
    # one launch for the three groups: they share lr, betas, eps and step
    assert len(L.launch_plan(leaves)) == 1


def _leaf(p, lr=1e-4, step=1, wd=1e-6, adapt=True):
    return L.Leaf(p, p, p, p, lr, (0.9, 0.999), 1e-6, wd, adapt, step)


@pytest.fixture(scope="module")
def lamb640():
    """``640_lamb``'s model on the CPU and its optimizer's groups."""
    cfg = load_config("640_lamb")
    _, _, model, _ = build_fp(cfg)
    opt, _ = build_optimizer(cfg, model, 100)
    return model, opt


def test_leaf_table_at_640_lamb(lamb640):
    """68 f32 leaves, 16,939,008 parameters, one group: one launch (two
    kernels a step) of 4,156 CTAs; the table holds each leaf's addresses,
    size, chunk offsets, weight decay and adaptation flag."""
    model, opt = lamb640
    (group,) = opt.param_groups
    leaves = [_leaf(p, wd=group["weight_decay"],
                    adapt=group["layer_adaptation"]) for p in group["params"]]
    assert len(leaves) == 68
    plan = L.launch_plan(leaves)
    assert [len(launch) for launch in plan] == [68]
    ptrs, sizes, chunk0, wd, adapt = L.leaf_table(plan[0])
    assert ptrs.tolist() == [p.data_ptr() for _ in range(4)
                             for p in group["params"]]
    assert sizes.tolist() == [p.numel() for p in group["params"]]
    assert int(sizes.sum()) == 16_939_008
    assert chunk0[0] == 0 and int(chunk0[-1]) == 4156
    assert (chunk0[1:] - chunk0[:-1]).tolist() == [
        -(-int(n) // L.CHUNK) for n in sizes]
    assert wd.tolist() == [pytest.approx(1e-6)] * 68 and adapt.all()
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_launch_plan_splits_many_leaves_and_distinct_scalars():
    """A run of leaves sharing their scalars goes in launches of at most
    MAX_LEAVES, in order; another lr or step starts another run; leaves of
    no elements launch nothing; each launch's chunk offsets start at 0."""
    ps = [torch.zeros(5 + i) for i in range(200)]
    leaves = [_leaf(p) for p in ps]
    plan = L.launch_plan(leaves)
    assert [len(launch) for launch in plan] == [80, 80, 40]
    assert [leaf.p for launch in plan for leaf in launch] == ps
    for launch in plan:
        _, sizes, chunk0, _, _ = L.leaf_table(launch)
        assert chunk0[0] == 0 and (chunk0[1:] - chunk0[:-1] == 1).all()
    mixed = ([_leaf(p) for p in ps[:3]] + [_leaf(ps[3], step=2)]
             + [_leaf(ps[4], lr=1e-3)] + [_leaf(p, wd=0.0, adapt=False)
                                          for p in ps[5:7]]
             + [_leaf(torch.zeros(0))])
    plan = L.launch_plan(mixed)
    assert [[leaf.p for leaf in launch] for launch in plan] == [
        ps[:3] + ps[5:7], [ps[3]], [ps[4]]]
    assert L.leaf_table(plan[0])[4].tolist() == [1, 1, 1, 0, 0]


def test_card_route_raises_for_what_the_kernels_do_not_take():
    p = torch.zeros(8)
    for bad in (_leaf(p)._replace(g=torch.zeros(8, dtype=torch.float64)),
                _leaf(p)._replace(m=torch.zeros(16)[::2]),
                _leaf(p)._replace(v=torch.zeros(9))):
        with pytest.raises(ValueError, match="contiguous f32"):
            L.fused_update([bad])


def test_mixed_devices_raise():
    ps = [torch.nn.Parameter(torch.zeros(4, device=d))
          for d in ("cpu", "meta")]
    for p in ps:
        p.grad = torch.zeros_like(p)
    with pytest.raises(ValueError, match="mixed devices"):
        L.Lamb(ps).step()


@pytest.mark.gpu
def test_kernel_pair_matches_plain_on_gpu(lamb640):
    """The kernel pair against the plain version on the card over 3 steps
    at ``640_lamb``'s 68 leaves (gradients and weights from a seed, a wd-0
    group, a group without adaptation and a zero leaf among them): within
    PARAM_RTOL / CHANGE_RTOL; two runs equal bit for bit; two launches a
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda", 0)
    model, _ = lamb640
    gen = torch.Generator().manual_seed(3)
    p0 = [p.detach().to(dev) for p in model.parameters()]
    with torch.no_grad():
        p0[1].zero_()
    grads = [[0.01 * torch.randn(p.shape, generator=gen).to(dev)
              for p in p0] for _ in range(3)]

    def groups(ps):
        return [dict(params=ps[:60]), dict(params=ps[60:64], weight_decay=0.0),
                dict(params=ps[64:], weight_decay=0.0,
                     layer_adaptation=False)]

    def fused():
        ps = [torch.nn.Parameter(p.clone()) for p in p0]
        opt = L.Lamb(groups(ps), lr=1e-3)
        for step in range(3):
            for p, g in zip(ps, grads[step]):
                p.grad = g
            opt.step()
        torch.cuda.synchronize()
        return ps, opt

    L.reset_launches()
    got, opt = fused()
    assert L.LAUNCHES == {"lamb_moments": 3, "lamb_apply": 3}
    again, opt2 = fused()
    ps = [p.clone() for p in p0]
    states = [{"step": 0, "exp_avg": torch.zeros_like(p),
               "exp_avg_sq": torch.zeros_like(p)} for p in ps]
    for step in range(3):
        for group in groups(list(range(len(ps)))):
            full = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                        weight_decay=1e-6, layer_adaptation=True)
            full.update({k: v for k, v in group.items() if k != "params"})
            for i in group["params"]:
                L.plain_update(ps[i], grads[step][i], states[i], full)
    for i, (a, b) in enumerate(zip(got, ps)):
        sa = opt.state[a]
        assert torch.equal(a, again[i]), i
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], opt2.state[again[i]][k]), i
            assert _gap(sa[k], states[i][k]) <= PARAM_RTOL, (i, k)
        assert _gap(a, b) <= PARAM_RTOL, i
        assert _change_gap(a, b, p0[i]) <= CHANGE_RTOL, i
