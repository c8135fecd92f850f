"""Segment catalogs and dataset selection.

``build_seg_list`` reproduces the reference's ``get_fns_seg_list``
(``model/utils/audio_utils.py:140-218``): per file, segments at hop
intervals, each entry ``(filename, seg_idx, offset_min, offset_max)`` where
the offsets bound how far a random start may move (0 at the first segment,
residual frames at the last).

``Dataset`` mirrors the reference's selection logic and directory layout
(``model/dataset.py:10-323``): train '10k_icassp' -> ``train-10k-30s/``,
val ``val-query-db-500-30s/``, dummy-db ``test-dummy-db-100k-full/`` capped
by TEST_DUMMY_DB, query/db pairs from ``test-query-db-500-30s/`` (icassp
mode) or live-synthesized from the val db (unseen_syn).
"""
from __future__ import annotations

import glob
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from nafp_tpu_torch.data.audio_io import wav_info
from nafp_tpu_torch.data.loader import SegmentLoader

SegEntry = Tuple[str, int, int, int]  # (filename, seg_idx, off_min, off_max)


def build_seg_list(fns: List[str], segment_mode: str, fs: int,
                   duration: float, hop: Optional[float] = None,
                   rng: Optional[np.random.Generator] = None) -> List[SegEntry]:
    if hop is None:
        hop = duration
    n_seg = int(fs * duration)
    n_hop = int(fs * hop)
    out: List[SegEntry] = []
    for filename in fns:
        n_frames, file_fs = wav_info(filename)
        if file_fs != fs:
            raise ValueError(f"{filename}: sample rate {file_fs} != {fs}")
        if n_frames > n_seg:
            n_segs = int((n_frames - n_seg + n_hop) // n_hop)
        else:
            n_segs = 1
        residual = max(0, n_frames - ((n_segs - 1) * n_hop + n_seg))

        if segment_mode == "all":
            for seg_idx in range(n_segs):
                off_min = 0 if seg_idx == 0 else -n_hop
                off_max = residual if seg_idx == n_segs - 1 else n_hop
                out.append((filename, seg_idx, off_min, off_max))
        elif segment_mode == "random_oneshot":
            seg_idx = int((rng or np.random.default_rng()).integers(0, n_segs))
            off_min = 0 if seg_idx == 0 else n_hop
            off_max = residual if seg_idx == n_segs - 1 else n_hop
            out.append((filename, seg_idx, off_min, off_max))
        elif segment_mode == "first":
            out.append((filename, 0, 0, 0))
        else:
            raise NotImplementedError(segment_mode)
    return out


def _glob_wavs(root: str, pattern: str) -> List[str]:
    return sorted(glob.glob(root + pattern, recursive=True))


class Dataset:
    """Dataset selection facade (reference ``model/dataset.py:10-323``)."""

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg
        d = cfg["DIR"]
        self.source_root_dir = d["SOURCE_ROOT_DIR"]
        self.bg_root_dir = d.get("BG_ROOT_DIR", "")
        self.ir_root_dir = d.get("IR_ROOT_DIR", "")
        self.speech_root_dir = d.get("SPEECH_ROOT_DIR", "")

        sel = cfg["DATA_SEL"]
        self.datasel_train = sel["TRAIN"]
        self.datasel_test_dummy_db = str(sel["TEST_DUMMY_DB"])
        self.datasel_test_query_db = sel["TEST_QUERY_DB"]

        b = cfg["BSZ"]
        self.tr_batch_sz, self.tr_n_anchor = b["TR_BATCH_SZ"], b["TR_N_ANCHOR"]
        self.val_batch_sz, self.val_n_anchor = b["VAL_BATCH_SZ"], b["VAL_N_ANCHOR"]
        self.ts_batch_sz = b["TS_BATCH_SZ"]

        m = cfg["MODEL"]
        self.dur, self.hop, self.fs = float(m["DUR"]), float(m["HOP"]), int(m["FS"])
        self.song_cache_bytes = int(
            float(cfg.get("DEVICE", {}).get("SONG_CACHE_GB", 0) or 0) * 2**30)

        a = cfg["TD_AUG"]
        self.tr_snr, self.val_snr, self.ts_snr = a["TR_SNR"], a["VAL_SNR"], a["TS_SNR"]
        self.tr_use_bg, self.val_use_bg, self.ts_use_bg = \
            a["TR_BG_AUG"], a["VAL_BG_AUG"], a["TS_BG_AUG"]
        self.tr_use_ir, self.val_use_ir, self.ts_use_ir = \
            a["TR_IR_AUG"], a["VAL_IR_AUG"], a["TS_IR_AUG"]
        self.tr_use_speech = a.get("TR_SPEECH_AUG", False)
        self.val_use_speech = a.get("VAL_SPEECH_AUG", False)
        self.ts_use_speech = a.get("TS_SPEECH_AUG", False)

        # Augmentation source file lists (dataset.py:86-126). Validation
        # reuses the train ('tr/') splits, test uses 'ts/'.
        self.tr_bg_fps = _glob_wavs(self.bg_root_dir, "tr/**/*.wav") \
            if self.tr_use_bg else []
        self.ts_bg_fps = _glob_wavs(self.bg_root_dir, "ts/**/*.wav") \
            if self.ts_use_bg else []
        self.val_bg_fps = self.tr_bg_fps if self.val_use_bg else []
        self.tr_ir_fps = _glob_wavs(self.ir_root_dir, "tr/**/*.wav") \
            if self.tr_use_ir else []
        self.ts_ir_fps = _glob_wavs(self.ir_root_dir, "ts/**/*.wav") \
            if self.ts_use_ir else []
        self.val_ir_fps = self.tr_ir_fps if self.val_use_ir else []
        # Speech splits: train/ test/ dev/ (reference dataset.py:115-125).
        self.tr_speech_fps = _glob_wavs(self.speech_root_dir,
                                        "train/**/*.wav") \
            if self.tr_use_speech else []
        self.ts_speech_fps = _glob_wavs(self.speech_root_dir,
                                        "test/**/*.wav") \
            if self.ts_use_speech else []
        self.val_speech_fps = _glob_wavs(self.speech_root_dir,
                                         "dev/**/*.wav") \
            if self.val_use_speech else []

    # ------------------------------------------------------------------
    def get_train_ds(self, reduce_items_p: int = 0) -> SegmentLoader:
        raise NotImplementedError(
            "the training slice (ROADMAP.md items 6-8): the train loader "
            "needs the process-shard helper of the multi-host mesh, not "
            "ported yet")

    def get_val_ds(self, max_song: int = 500) -> SegmentLoader:
        raise NotImplementedError(
            "the training slice (ROADMAP.md items 6-8): the validation "
            "loader is not ported yet")

    def get_test_dummy_db_ds(self) -> SegmentLoader:
        fps = _glob_wavs(self.source_root_dir,
                         "test-dummy-db-100k-full/**/*.wav")
        if self.datasel_test_dummy_db in ("10k_full", "10k_30s"):
            fps = fps[:10000]
        elif self.datasel_test_dummy_db == "100k_full_icassp":
            pass
        elif self.datasel_test_dummy_db.isnumeric():
            fps = fps[:int(self.datasel_test_dummy_db)]
        else:
            raise NotImplementedError(self.datasel_test_dummy_db)
        return self._plain_db_loader(fps)

    def get_test_query_db_ds(self) -> Tuple[SegmentLoader, SegmentLoader]:
        if self.datasel_test_query_db == "unseen_icassp":
            q = _glob_wavs(self.source_root_dir,
                           "test-query-db-500-30s/query/**/*.wav")
            db = _glob_wavs(self.source_root_dir,
                            "test-query-db-500-30s/db/**/*.wav")
            return self._plain_db_loader(q), self._plain_db_loader(db)
        if self.datasel_test_query_db == "unseen_syn":
            raise NotImplementedError(
                "the training slice (ROADMAP.md item 7): 'unseen_syn' query "
                "synthesis needs the time-domain augmentation "
                "(ops/tdaug.augment_replicas), not ported yet")
        raise NotImplementedError(self.datasel_test_query_db)

    def get_custom_db_ds(self, source_root_dir: str) -> SegmentLoader:
        fps = _glob_wavs(source_root_dir.rstrip("/") + "/", "**/*.wav")
        return self._plain_db_loader(fps)

    def _plain_db_loader(self, fps: List[str]) -> SegmentLoader:
        # n_anchor = bsz: no replicas, no augmentation (dataset.py:204-214).
        return SegmentLoader(
            fns_event_list=fps, bsz=self.ts_batch_sz,
            n_anchor=self.ts_batch_sz, duration=self.dur, hop=self.hop,
            fs=self.fs, shuffle=False, random_offset_anchor=False,
            drop_the_last_non_full_batch=False)
