"""The nibble-lane arithmetic of the ``select_packets`` and ``fused_flush``
CUDA kernels, checked exhaustively on the CPU.

The kernels (``serf_tpu_torch/ops/csrc/round_kernels.cu``, section
"nibble lanes") cannot run here.  Below is a line-for-line transliteration
of every helper of that section — the same names, the same constants, the
same order of operations — on uint32 words held in int64 tensors (each
result masked to 32 bits where the device word would wrap).  It is held
against the per-fact definitions of ``serf_tpu_torch.models.
dissemination`` (``nibble_age_pred_words``, ``clamp_nibbles``,
``learn_pairs_words``, ``flush_learn_bytes``, ``flush_learn_nibbles``,
``cache_words``), which the other tests hold against the reference, over
every stamp byte 0..255 at every byte position, every stamp quarter and
cohort wrap (next rounds 0..63), every transmit limit 0..16 and some
outside that range, and every overlay/fresh bit pair, for both stamp
flavors.  A test also pins that every helper of the section has its
twin here, so the two cannot drift apart unnoticed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from serf_tpu_torch.bits import unpack_bits
from serf_tpu_torch.models import dissemination as dis

SOURCE = (Path(__file__).resolve().parents[1] / "serf_tpu_torch" / "ops"
          / "csrc" / "round_kernels.cu")

M32 = 0xFFFFFFFF
K_ONES = 0x01010101
K_LOW = 0x0F0F0F0F
K_TOP = 0x80808080
K_AGE_PIN_Q = dis.AGE_PIN_Q

ROUNDS = range(64)                  # every quarter, phase and cohort wrap
LIMITS = list(range(17)) + [-1, 17, 100]


# -- the transliteration (round_kernels.cu, "nibble lanes") -----------------

def quarter(round_):
    return (round_ >> dis.STAMP_SHIFT) & 0xF


def prmt(a, b, sel: int):
    out = 0
    for n in range(4):
        s = (sel >> (4 * n)) & 0xF
        k = s & 7
        x = ((a if k < 4 else b) >> (8 * (k & 3))) & 0xFF
        if s & 8:
            x = torch.where((x & 0x80) != 0, 0xFF, 0) if torch.is_tensor(
                x) else (0xFF if x & 0x80 else 0)
        out = out | (x << (8 * n))
    return out


def quarter_lanes(rq):
    return (rq * K_ONES) | 0x10101010


def age_lanes(nibs, rq16):
    return ((rq16 - nibs) & M32) & K_LOW


def young_lanes(nibs, rq16, lim):
    return ~((age_lanes(nibs, rq16) + lim) & M32) & K_TOP


def lane_masks(x):
    return prmt(x, 0, 0xBA98)


def pick(m, b, a):
    return (b & m) | (a & ~m & M32)


def clamp_lanes(keep, nibs, rq16, pin):
    return pick(lane_masks((age_lanes(nibs, rq16)
                            + (0x7F - K_AGE_PIN_Q) * K_ONES) & M32),
                pin, keep)


def pair_masks(word, b: int):
    r = prmt(word, 0, b * 0x1111)
    lo = lane_masks((r & 0x40100401) + 0x7F7F7F7F)
    hi = lane_masks((r & 0x80200802) + 0x7F7F7F7F)
    return lo, hi


def quad_masks(word, g: int):
    r = prmt(word, 0, (g >> 1) * 0x1111)
    return lane_masks((r & (0x80402010 if g & 1 else 0x08040201))
                      + 0x7F7F7F7F)


def weave_pairs(lo, hi):
    return (((lo >> 1) | hi) * 0x00041041) & M32


def weave_quads(a, b):
    return (((a >> 4) | b) * 0x00204081) & M32


def top_bytes(p0, p1, p2, p3):
    return prmt(prmt(p0, p1, 0x0073), prmt(p2, p3, 0x0073), 0x5410)


def young_packed(q, rq16, lim):
    p = [weave_pairs(young_lanes(q[i] & K_LOW, rq16, lim),
                     young_lanes((q[i] >> 4) & K_LOW, rq16, lim))
         for i in range(4)]
    return top_bytes(*p)


def young_unpacked(q, rq16, lim):
    p = [weave_quads(young_lanes(q[2 * i] & K_LOW, rq16, lim),
                     young_lanes(q[2 * i + 1] & K_LOW, rq16, lim))
         for i in range(4)]
    return top_bytes(*p)


def flush_lanes(next_round: int, lim: int) -> dict:
    rq = quarter(next_round)
    return dict(rq16=quarter_lanes(rq), rq=rq * K_ONES,
                rq_prev=quarter(next_round - 1) * K_ONES,
                pin=((rq - K_AGE_PIN_Q) & 0xF) * K_ONES, lim=lim)


def flush_packed(q, fresh, overlay, l, with_cache: bool):
    o, p = [], []
    for i in range(4):
        lo, hi = q[i] & K_LOW, (q[i] >> 4) & K_LOW
        lo = clamp_lanes(lo, lo, l["rq16"], l["pin"])
        hi = clamp_lanes(hi, hi, l["rq16"], l["pin"])
        m_lo, m_hi = pair_masks(overlay, i)
        lo = pick(m_lo, l["rq_prev"], lo)
        hi = pick(m_hi, l["rq_prev"], hi)
        m_lo, m_hi = pair_masks(fresh, i)
        lo = pick(m_lo, l["rq"], lo)
        hi = pick(m_hi, l["rq"], hi)
        o.append(lo | (hi << 4))
        if with_cache:
            p.append(weave_pairs(young_lanes(lo, l["rq16"], l["lim"]),
                                 young_lanes(hi, l["rq16"], l["lim"])))
    return o, (top_bytes(*p) if with_cache else 0)


def flush_unpacked(q, fresh, overlay, l, with_cache: bool):
    o, y = [], []
    for g in range(8):
        s = clamp_lanes(q[g], q[g] & K_LOW, l["rq16"], l["pin"])
        s = pick(quad_masks(overlay, g), l["rq_prev"], s)
        s = pick(quad_masks(fresh, g), l["rq"], s)
        o.append(s)
        if with_cache:
            y.append(young_lanes(s & K_LOW, l["rq16"], l["lim"]))
    ok = (top_bytes(weave_quads(y[0], y[1]), weave_quads(y[2], y[3]),
                    weave_quads(y[4], y[5]), weave_quads(y[6], y[7]))
          if with_cache else 0)
    return o, ok


def limit_lanes(limit_q: int) -> int:
    lq = 0 if limit_q < 0 else (16 if limit_q > 16 else limit_q)
    return (0x80 - lq) * 0x01010101


# -- inputs ------------------------------------------------------------------

K = 32                                   # one fact word per row

#: limit_lanes of every limit, as a column: the lane helpers broadcast it
#: against a row of words, one result row per limit
LIMIT_LANES = torch.tensor([limit_lanes(lq) for lq in LIMITS],
                           dtype=torch.int64).reshape(-1, 1)


def _stamp_rows(packed: bool) -> torch.Tensor:
    """u8 rows of one word's stamp bytes, every byte value at every
    position: row r holds byte (r + j) % 256 at position j."""
    cols = K // 2 if packed else K
    r = np.arange(256)[:, None] + np.arange(cols)[None, :]
    return torch.from_numpy((r % 256).astype(np.uint8))


def _bit_patterns(packed: bool):
    """(overlay, fresh) int32 word pairs, one per row set: every overlay/
    fresh pair on every fact — for the packed flavor independently on a
    byte's low and high nibble — and a few random words."""
    pairs = []
    if packed:
        for c in range(16):
            word = [(0x55555555 if c >> s & 1 else 0)
                    | (0xAAAAAAAA if c >> (s + 2) & 1 else 0)
                    for s in (0, 1)]
            pairs.append(tuple(word))
    else:
        pairs = [(o, f) for o in (0, M32) for f in (0, M32)]
    rng = np.random.default_rng(3)
    pairs += [tuple(int(x) for x in rng.integers(0, 2**32, 2))
              for _ in range(4)]
    return pairs


def _planes(packed: bool):
    """Stamp bytes u8[R, C] and overlay/fresh int32[R, 1] for every row
    set of :func:`_bit_patterns`."""
    rows = _stamp_rows(packed)
    pairs = _bit_patterns(packed)
    stamp = rows.repeat(len(pairs), 1)
    ov, fr = (torch.from_numpy(np.repeat(
        np.array([p[i] for p in pairs], dtype=np.uint32), rows.shape[0])
        .view(np.int32)).reshape(-1, 1) for i in (0, 1))
    return stamp, ov, fr


def _groups(stamp: torch.Tensor):
    """The stamp rows as 32-bit little-endian words (the kernel's view of
    its 16-byte chunks): a list of int64[R] columns."""
    w = stamp.contiguous().view(torch.int32).to(torch.int64) & M32
    return [w[:, i] for i in range(w.shape[1])]


def _bytes(groups) -> torch.Tensor:
    w = torch.stack(groups, dim=1).to(torch.int32)
    return w.contiguous().view(torch.uint8)


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.reshape(-1).to(torch.int64) & M32


# -- tests --------------------------------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
def test_select_lanes_match_per_fact_age_predicate(packed):
    """young_packed / young_unpacked (select_packets) == the per-fact
    ``q-age < limit_q`` bits for every byte, quarter and limit."""
    stamp = _stamp_rows(packed)
    q = _groups(stamp)
    ones = torch.full((stamp.shape[0], 1), -1, dtype=torch.int32)
    young = young_packed if packed else young_unpacked
    for rnd in ROUNDS:
        got = young(q, quarter_lanes(quarter(rnd)), LIMIT_LANES)
        for i, limit_q in enumerate(LIMITS):
            if packed:
                want = dis.nibble_age_pred_words(stamp & 0xF, stamp >> 4,
                                                 rnd, limit_q)
            else:
                want = dis.cache_words(ones, stamp, None, None, rnd,
                                       limit_q, packed=False)
            assert torch.equal(got[i], _u32(want)), (rnd, limit_q)


@pytest.mark.parametrize("packed", [True, False])
def test_lane_masks_match_per_fact_bits(packed):
    """pair_masks / quad_masks spread a fact word's bits onto the lanes
    of the facts' stamp bytes: 0xFF where the fact's bit is set."""
    rng = np.random.default_rng(5)
    words = torch.from_numpy(np.concatenate([
        np.array([0, M32, 0x55555555, 0xAAAAAAAA], dtype=np.uint64),
        rng.integers(0, 2**32, 4096, dtype=np.uint64)]).astype(
            np.uint32).view(np.int32)).reshape(-1, 1)
    u = _u32(words)
    if packed:
        lo_bits, hi_bits = dis.learn_pairs_words(words, K)   # [R, 16]
        for b in range(4):
            lo, hi = pair_masks(u, b)
            for j in range(4):
                for m, bits in ((lo, lo_bits), (hi, hi_bits)):
                    want = torch.where(bits[:, 4 * b + j], 0xFF, 0)
                    assert torch.equal((m >> (8 * j)) & 0xFF, want)
    else:
        bits = unpack_bits(words, K)                         # [R, 32]
        for g in range(8):
            m = quad_masks(u, g)
            for j in range(4):
                want = torch.where(bits[:, 4 * g + j], 0xFF, 0)
                assert torch.equal((m >> (8 * j)) & 0xFF, want)


@pytest.mark.parametrize("packed", [True, False])
def test_clamp_lanes_match_clamp_nibbles(packed):
    """clamp_lanes == dissemination.clamp_nibbles on every byte at every
    quarter (an unpacked byte keeps its high bits where it is young)."""
    stamp = _stamp_rows(packed)
    q = _groups(stamp)
    for rnd in ROUNDS:
        l = flush_lanes(rnd, 0)
        if packed:
            got = []
            for g in q:
                lo, hi = g & K_LOW, (g >> 4) & K_LOW
                got.append(clamp_lanes(lo, lo, l["rq16"], l["pin"])
                           | (clamp_lanes(hi, hi, l["rq16"], l["pin"]) << 4))
            want = (dis.clamp_nibbles(stamp & 0xF, rnd)
                    | (dis.clamp_nibbles(stamp >> 4, rnd) << 4))
        else:
            got = [clamp_lanes(g, g & K_LOW, l["rq16"], l["pin"]) for g in q]
            want = dis.clamp_nibbles(stamp, rnd)
        assert torch.equal(_bytes(got), want), rnd


@pytest.mark.parametrize("packed", [True, False])
def test_flush_lanes_match_flush_learn(packed):
    """flush_packed / flush_unpacked (fused_flush) write the stamps of
    flush_learn_bytes / flush_learn_nibbles: clamp, overlay -> cohort
    quarter, fresh -> flush quarter (fresh wins), every bit pair."""
    stamp, ov, fr = _planes(packed)
    q = _groups(stamp)
    flush = flush_packed if packed else flush_unpacked
    for rnd in ROUNDS:
        got, _ = flush(q, _u32(fr), _u32(ov), flush_lanes(rnd, 0), False)
        if packed:
            want = dis.flush_learn_bytes(stamp, fr, ov, rnd, K)[0]
        else:
            want = dis.flush_learn_nibbles(stamp, fr, ov, rnd, K)
        assert torch.equal(_bytes(got), want), rnd


@pytest.mark.parametrize("packed", [True, False])
def test_flush_cache_matches_cache_words(packed):
    """The flush's cache bits, taken from the final lanes in registers,
    == cache_words on the reference's flushed stamps, every limit."""
    stamp, ov, fr = _planes(packed)
    q = _groups(stamp)
    ones = torch.full_like(ov, -1)
    flush = flush_packed if packed else flush_unpacked
    for rnd in ROUNDS:
        if packed:
            ref, lo, hi = dis.flush_learn_bytes(stamp, fr, ov, rnd, K)
        else:
            ref = dis.flush_learn_nibbles(stamp, fr, ov, rnd, K)
            lo = hi = None
        _, got = flush(q, _u32(fr), _u32(ov), flush_lanes(rnd, LIMIT_LANES),
                       True)
        for i, limit_q in enumerate(LIMITS):
            want = dis.cache_words(ones, ref, lo, hi, rnd, limit_q, packed)
            assert torch.equal(got[i], _u32(want)), (rnd, limit_q)


def test_limit_lanes_clamps_to_the_age_range():
    """limit_lanes: 0x80 - limit in every lane, a limit outside 0..16
    clamped (an age is 0..15, so it selects what its clamp selects)."""
    assert limit_lanes(7) == 0x79797979
    assert limit_lanes(0) == 0x80808080
    assert limit_lanes(16) == 0x70707070
    assert limit_lanes(-5) == limit_lanes(0)
    assert limit_lanes(2**31 - 1) == limit_lanes(16)


def test_every_lane_helper_has_its_twin_here():
    """Each function of the .cu's nibble-lane section (and limit_lanes)
    is transliterated above under its own name, and the source names this
    test."""
    src = SOURCE.read_text()
    section = src[src.index("// -- nibble lanes"):src.index("// -- kernels")]
    names = set(re.findall(r"(?:uint32_t|uint4|void|FlushLanes)\s+"
                           r"(\w+)\(", section))
    names.discard("make_uint4")
    assert names >= {"prmt", "young_lanes", "clamp_lanes", "pair_masks",
                     "quad_masks", "flush_packed", "flush_unpacked"}
    missing = sorted(n for n in names | {"limit_lanes"}
                     if not callable(globals().get(n)))
    assert not missing, missing
    assert "tests/test_torch_swar.py" in section
    # and every constant of the section appears in the transliteration
    mine = Path(__file__).read_text()
    mine = mine[mine.index("M32 ="):mine.index("# -- inputs")]
    consts = {int(c, 16) for c in re.findall(r"0x([0-9A-Fa-f]+)u", section)}
    ours = {int(c, 16) for c in re.findall(r"0x([0-9A-Fa-f]+)", mine)}
    assert consts <= ours, sorted(hex(c) for c in consts - ours)
