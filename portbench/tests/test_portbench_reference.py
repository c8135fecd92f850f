"""The plain reference on tiny cases worked out by hand."""
import math

import numpy as np
import pytest
import torch

from portbench import audio
from portbench.reference import encoder, search, train


def test_topk_gap_by_hand():
    db = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.6, 0.8], [-1.0, 0.0]])
    q = torch.tensor([[1.0, 0.0]])
    # true scores 1, 0, 0.6, -1: the best two are rows 0 and 2
    assert search.topk_gap(q, db, np.array([[0, 2]])) == 0.0
    assert search.topk_gap(q, db, np.array([[2, 0]])) == 0.0
    # row 1 in place of row 2: the second best is 0.6 - 0 short
    assert search.topk_gap(q, db, np.array([[0, 1]])) == pytest.approx(0.6)
    assert search.topk_gap(q, db, np.array([[0, 0]])) == math.inf
    assert search.topk_gap(q, db, np.array([[0, -1]])) == math.inf


def test_rerank_by_hand():
    recon = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0],
                          [0.0, 1.0]])
    q_seq = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])        # one clip, sl 2
    n_seg = torch.tensor([2])
    # segment 0 hit rows 2 and 1, segment 1 hit rows 3 and 4: starts 2, 1,
    # 2 (a duplicate) and 3
    hits = np.array([[[2, 1], [3, 4]]])
    scores, starts = search.rerank(q_seq, n_seg, hits, recon)
    got = {}
    for st, sc in zip(starts[0].tolist(), scores[0].tolist()):
        got[st] = max(sc, got.get(st, -math.inf))   # a duplicate is -inf
    # start 1: (q0·r1 + q1·r2)/2 = 0; start 2: (1 + 1)/2 = 1;
    # start 3: (0 + 1)/2 = 0.5
    assert got[1] == 0.0 and got[2] == 1.0 and got[3] == 0.5
    best = np.array([[2, 3, 1]])
    assert search.rerank_gap(q_seq, n_seg, hits, recon, best) == 0.0
    swapped = np.array([[3, 2, 1]])
    assert search.rerank_gap(q_seq, n_seg, hits, recon,
                             swapped) == pytest.approx(0.5)
    missing = np.array([[2, 3, -999999]])
    assert search.rerank_gap(q_seq, n_seg, hits, recon, missing) == math.inf


def test_ntxent_by_hand():
    a = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    b = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    # row 0 of the anchors: logits [1, 0 | -, 0] / tau; the label is 1/tau
    tau = 0.5
    row = math.log(math.exp(2) + 2 * math.exp(0)) - 2
    assert float(train.ntxent(a, b, tau)) == pytest.approx(2 * row * 2 / 2)


def test_cosine_lr_by_hand():
    opt = {"lr": 0.1, "alpha": 0.0, "total_steps": 10, "betas": [0.9, 0.999],
           "eps": 0.0, "weight_decay": 0.0}
    assert train.cosine_lr(opt, 0) == pytest.approx(0.1)
    assert train.cosine_lr(opt, 5) == pytest.approx(0.05)
    assert train.cosine_lr(opt, 10) == pytest.approx(0.0)


def test_bg_mix_by_hand():
    x = torch.tensor([[1.0, -1.0, 1.0, -1.0]])
    n = torch.tensor([[2.0, 2.0, -2.0, -2.0]])
    snr, amp = torch.tensor([[0.0]]), torch.tensor([[0.5]])
    # both RMS-normalised to ±1, summed: (2, 0, 0, -2), max 2, times 0.5
    assert audio.bg_mix(x, n, snr, amp).tolist() == [[0.5, 0.0, 0.0, -0.5]]
    silent = torch.zeros_like(n)
    assert audio.bg_mix(x, silent, snr, amp).tolist() == [
        [0.5, -0.5, 0.5, -0.5]]


def test_mel_filterbank_and_dft_by_hand():
    basis = encoder.dft_basis(4)
    # periodic Hann of 4: (0, 0.5, 1, 0.5); the DC column sums the window
    assert basis[:, 0].tolist() == pytest.approx([0.0, 0.5, 1.0, 0.5])
    assert basis[:, 2].tolist() == pytest.approx([0.0, -0.5, 1.0, -0.5])
    fb = encoder.mel_filterbank(8000, 1024, 256, 300.0, 4000.0)
    assert fb.shape == (513, 256) and (fb >= 0).all()
    # each Slaney triangle has area 1 over its width in Hz: the peak is
    # 2 / (hi - lo)
    assert fb.max() > 0
