"""The port's CUDA kernels as far as the CPU can check them: every C entry
point's parameters against the ctypes ``argtypes`` its Python caller sets
(a missing or misplaced ``c_void_p`` silently truncates a pointer on the
card), the build's staleness rule, and the chunk plans of the scan
wrappers with the SM count injected."""
import ctypes
import os
import re
import time

import numpy as np
import pytest

from nafp_tpu_torch import kernels
from nafp_tpu_torch.extras import bench_sq8_kernel as B
from nafp_tpu_torch.ops import layernorm2d as L
from nafp_tpu_torch.optim import lamb
from nafp_tpu_torch.search import topk as T

# the argtypes each Python caller sets for a C entry point; the occupancy
# queries are called through chip_smoke.py's ``occupancy``, which passes
# ints and one int pointer
WRAPPER_ARGTYPES = {
    "nafp_topk_f32": T._ARGTYPES["topk_f32"],
    "nafp_topk_sq8": T._ARGTYPES["topk_sq8"],
    "nafp_topk_masked": T._ARGTYPES["topk_masked"],
    "nafp_bench_variant": B._VARIANT_ARGTYPES,
    "nafp_bench_dotonly": B._DOTONLY_ARGTYPES,
    "nafp_layernorm2d_fwd": L._ARGTYPES["_fwd"],
    "nafp_layernorm2d_bwd": L._ARGTYPES["_bwd"],
    "nafp_lamb_step": lamb._ARGTYPES,
}
_EXTERN = re.compile(r'extern "C" int (nafp_\w+)\(([^)]*)\)', re.S)


def _entry_points():
    """{name: [parameter declarations]} of every ``extern "C" int nafp_*``
    in csrc/*.cu."""
    found = {}
    for fname in sorted(os.listdir(kernels.CSRC)):
        if fname.endswith(".cu"):
            with open(os.path.join(kernels.CSRC, fname)) as f:
                for name, params in _EXTERN.findall(f.read()):
                    found[name] = [p.strip() for p in params.split(",")]
    return found


ENTRY_POINTS = _entry_points()


def _kind(decl: str) -> str:
    """'pointer', 'int' or 'float' for one C parameter declaration."""
    if "*" in decl:
        return "pointer"
    for kind in ("int", "float"):
        if re.fullmatch(rf"(const\s+)?{kind}\s+\w+", decl):
            return kind
    raise AssertionError(f"unexpected C parameter {decl!r}")


def _ctypes_kind(t) -> str:
    if t is ctypes.c_void_p or (isinstance(t, type)
                                and issubclass(t, ctypes._Pointer)):
        return "pointer"
    if t is ctypes.c_int:
        return "int"
    if t is ctypes.c_float:
        return "float"
    raise AssertionError(f"unexpected argtype {t!r}")


def test_every_entry_point_is_known():
    assert len(ENTRY_POINTS) == 13
    for name in ENTRY_POINTS:
        assert name in WRAPPER_ARGTYPES or name.endswith("_occupancy"), name
    assert set(WRAPPER_ARGTYPES) <= set(ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_argtypes_match_c_signature(name):
    c_kinds = [_kind(p) for p in ENTRY_POINTS[name]]
    if name in WRAPPER_ARGTYPES:
        py_kinds = [_ctypes_kind(t) for t in WRAPPER_ARGTYPES[name]]
    else:   # occupancy queries: ints, then the int* they fill
        py_kinds = ["int"] * (len(c_kinds) - 1) + ["pointer"]
    assert c_kinds == py_kinds, (name, ENTRY_POINTS[name])


def test_every_header_makes_a_library_stale(tmp_path, monkeypatch):
    """A library is rebuilt when its source or any csrc/ header is newer,
    including a header added later."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    t0 = time.time() - 100
    for f in ("k.cu", "a.cuh", "b.cuh"):
        (csrc / f).write_text("//\n")
        os.utime(csrc / f, (t0, t0))
    assert kernels._stale("k")                    # never built
    so = build / "libk.so"
    so.write_bytes(b"")
    os.utime(so, (t0 + 10, t0 + 10))
    assert kernels._sources("k") == [str(csrc / n)
                                     for n in ("k.cu", "a.cuh", "b.cuh")]
    assert not kernels._stale("k")
    for f in ("b.cuh", "c.cuh"):                  # edited, then a new one
        (csrc / f).write_text("//\n")
        os.utime(csrc / f, (t0 + 20, t0 + 20))
        assert kernels._stale("k")
        os.utime(so, (t0 + 30, t0 + 30))
        assert not kernels._stale("k")
        t0 += 20


PLANS = [
    # bq, n, sms
    (512, 635_904, 132),     # B3 at the protocol's IVF-PQ store
    (1024, 620_544, 132),    # B2's main shape
    (1, 2048, 132),          # one query: more chunks than rows allow
    (9, 0, 132),             # an empty chunk
    (300, 16_384, 114),      # another card
]


@pytest.mark.parametrize("bq,n,sms", PLANS)
@pytest.mark.parametrize("ctas", [1, 2])
def test_chunk_plan(bq, n, sms, ctas):
    """Chunks are whole 64-row tiles that cover N exactly once, and the
    grid asks for at most ``ctas`` CTAs per SM (one chunk at least): the
    resident counts of B1 (1) and of B3 and the sq8 scan (2)."""
    chunk_rows, n_chunks = T._plan_chunks(bq, n, sms, ctas)
    qblocks = -(-bq // T.QB)
    assert chunk_rows % T.RB == 0 and chunk_rows > 0
    assert (n_chunks - 1) * chunk_rows < max(n, 1) <= n_chunks * chunk_rows
    assert n_chunks * qblocks <= ctas * sms or n_chunks == 1


def test_b1_plan_at_the_protocol_shape():
    """B1 at Bq 512 over the protocol's 619,500 rows on 132 SMs, one CTA
    per SM of 64 queries (d 128): 8 query blocks x 16 chunks of 605 tiles
    = 128 CTAs, one wave (the FMA scan asked for 4 per SM: 528 CTAs, two
    waves of 264)."""
    chunk_rows, n_chunks = T._plan_chunks(512, 619_500, 132, 1, 64)
    assert (chunk_rows, n_chunks) == (38_720, 16)
    assert n_chunks * -(-512 // 64) <= 132


# B1's query blocks in the protocol (1-segment blocks of 128, then 384 and
# 512), one query, a block past one CTA's queries, and the 2,097,152-row
# chunk of the --gt device pass; 64 queries a CTA at d <= 128, 32 above
B1_PLANS = [(bq, n, qb) for bq in (1, 63, 65, 128, 384, 512)
            for n in (30, 5_000, 619_500, 2_097_152) for qb in (64, 32)]


@pytest.mark.parametrize("bq,n,qb", B1_PLANS)
def test_b1_plan_covers_rows_once_in_one_wave(bq, n, qb):
    """B1's work items, (chunk, query block): their rows are whole 64-row
    tiles of one chunk, the chunks cover N once, and at most one wave of
    one CTA per SM is asked for (one chunk at least)."""
    sms = 132
    chunk_rows, n_chunks = T._plan_chunks(bq, n, sms, 1, qb)
    qblocks = -(-bq // qb)
    assert chunk_rows % T.RB == 0
    covered = np.zeros(n, np.int32)
    for c in range(n_chunks):
        covered[c * chunk_rows:min(n, (c + 1) * chunk_rows)] += 1
    assert (covered == 1).all()
    assert n_chunks * qblocks <= sms or n_chunks == 1
    # with tiles to spare, rounding chunks to whole tiles leaves the wave
    # at least 7/8 full
    if -(-n // T.RB) >= 16 * (sms // qblocks):
        assert n_chunks * qblocks >= sms * 7 // 8


def test_b1_plan_by_block_size():
    """The protocol's three block sizes fill 132 SMs: 2 x 66, 6 x 22 and
    8 x 16 CTAs at d 128; at d 256 (32 queries a CTA) 16 x 8 at Bq 512."""
    for bq, chunks in ((128, 66), (384, 22), (512, 16)):
        assert T._plan_chunks(bq, 619_500, 132, 1, 64)[1] == chunks
    assert T._plan_chunks(512, 619_500, 132, 1, 32)[1] == 8


def test_occupancy_reads_at_most_its_slots(monkeypatch):
    """An occupancy query writes into a buffer of OCCUPANCY_SLOTS ints
    whatever n_out the caller asks for (B1's writes 7): asking for fewer
    cannot let the kernel write past the buffer."""
    seen = {}

    def fake(*args):
        info = args[-1]
        seen["len"] = len(info)
        for i in range(7):
            info[i] = i + 1
        return 0

    class Lib:
        nafp_fake_occupancy = staticmethod(fake)

    monkeypatch.setattr(kernels, "load", lambda name: Lib)
    assert kernels.occupancy("fake", 128, 20) == [1, 2, 3]
    assert kernels.occupancy("fake", 128, 20, n_out=4) == [1, 2, 3, 4]
    assert seen["len"] == kernels.OCCUPANCY_SLOTS >= 7


def test_b3_plan_at_the_protocol_shape():
    """B3 at Bq 512 over the 635,904-row store on 132 SMs: 8 query blocks x
    33 chunks = 264 CTAs, one wave of two per SM."""
    assert T._plan_chunks(512, 635_904, 132, T.MASKED_CTAS_PER_SM) == (
        19_328, 33)


@pytest.mark.parametrize("bq,n", [
    (1024, 620_544),          # B2's main shape (-i sq8)
    (512, 8_388_608),         # the sq8 kernel bench's shape
    (512, 635_904),           # B3 at the protocol's IVF-PQ store
    (300, 16_384),            # a query block short of full
])
@pytest.mark.parametrize("resident", [1, 2])
def test_sq8_plan_fills_at_most_one_wave(bq, n, resident):
    """B2/B4a's sq8 scan on 132 SMs, planned for the CTAs an SM holds:
    chunks of whole 64-row tiles cover N once, and the grid fits one wave,
    filling at least 15/16 of it (rounding the chunk count up gave B2's
    shape 272 CTAs at two per SM: a second wave of 8)."""
    sms, qblocks = 132, -(-bq // T.QB)
    chunk_rows, n_chunks = T._plan_chunks(bq, n, sms, resident)
    assert chunk_rows % T.RB == 0
    assert (n_chunks - 1) * chunk_rows < n <= n_chunks * chunk_rows
    assert n_chunks * qblocks <= resident * sms
    assert n_chunks * qblocks >= resident * sms * 15 // 16
    assert T._plan_chunks(1024, 620_544, 132, T.MASKED_CTAS_PER_SM)[1] == 16


def test_sq8_plan_of_few_rows_and_many_queries():
    """One chunk at least: a single tile, or more query blocks than a wave
    holds (the grid then takes more than one wave)."""
    assert T._plan_chunks(8, 30, 132, 2) == (64, 1)
    assert T._plan_chunks(64 * 300, 4096, 132, 2) == (4096, 1)
    assert T._plan_chunks(1, 0, 132, 1) == (64, 1)
