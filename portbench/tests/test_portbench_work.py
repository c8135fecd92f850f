"""Work counts from shapes against counts made by hand."""
import json
import math
import os

import pytest

from portbench import registry, work
from portbench.reference import arch

FULL = json.load(open(os.path.join(registry.HERE, "configs",
                                   "nnfp-icassp-l2.json")))["model"]

# two ConvLayers on a 4-mel x 1-s input: a hand-countable model
SMALL = dict(FULL, N_MELS=4, STFT_WIN=8, STFT_HOP=4, FS=16, DUR=1.0,
             EMB_SZ=2, FRONT_HIDDEN_CH=[2, 4],
             FRONT_STRIDES=[[[1, 2], [2, 1]], [[1, 2], [2, 1]]],
             FC_UNIT_DIM=[3, 1])


def test_small_shapes_by_hand():
    # 16 samples padded by 4 + 4 = 24, frames of 8 at hop 4: 5 frames
    assert arch.n_frames(SMALL) == 5
    # log-mel: 5 frames x (8 x 2·5 DFT + 5 x 4 mel) MACs, 2 FLOPs each
    assert work.logmel_flops(SMALL) == 2 * 5 * (8 * 10 + 5 * 4)
    convs = arch.convs(SMALL)
    # (4, 5) -1x3 s(1,2)-> (4, 3) -3x1 s(2,1)-> (2, 3)
    #        -1x3 s(1,2)-> (2, 2) -3x1 s(2,1)-> (1, 2)
    assert [c.out_hw for c in convs] == [(4, 3), (2, 3), (2, 2), (1, 2)]
    macs = (2 * 4 * 3 * 1 * 3 + 2 * 2 * 3 * 2 * 3
            + 4 * 2 * 2 * 2 * 3 + 4 * 1 * 2 * 4 * 3)
    # DivEnc: flat 4·1·2 = 8, q 2 slices of 4 -> 3 -> 1
    macs += 2 * 4 * 3 + 2 * 3 * 1
    assert work.encoder_flops(SMALL) == 2 * macs
    assert work.segment_flops(SMALL) == 2 * macs + 2 * 5 * 100
    assert work.train_segment_flops(SMALL) == 3 * 2 * macs + 2 * 5 * 100


def test_full_width_model():
    shapes = arch.param_shapes(FULL)
    assert sum(math.prod(s) for s in shapes.values()) == 16_939_008
    assert work.encoder_flops(FULL) / 1e9 == pytest.approx(0.607, abs=5e-4)
    assert work.logmel_flops(FULL) / 1e9 == pytest.approx(0.076, abs=5e-4)


def test_topk_least_time_by_hand():
    # 2·4·10·2 = 160 FLOPs at 80 FLOP/s: 2 s; bytes 4·(8 + 20) + 8·4·3 =
    # 208 at 104 B/s: 2 s; the larger of the two
    assert work.topk_f32_least_seconds(4, 10, 2, 3, 80.0, 104.0) == 2.0
    assert work.topk_f32_least_seconds(4, 10, 2, 3, 160.0, 52.0) == 4.0
    assert work.search_flops(3, 10, 2) == 120.0
    # 2 clips x (2·5) candidates x 2 rows x 2·d
    assert work.rerank_flops(2, 2, 5, 4) == 2 * 4 * 2 * 10 * 2
