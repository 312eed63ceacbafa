"""The erasure kernels' piece schedule and split-table multiply, emulated on
the CPU.

``csrc/erasure_pieces.cuh`` (the body of parity_xor and gf256_mac) runs on
a plan's pieces (``kernels/parity_xor/ops.py::build_pieces``): one CTA per
tile of a piece, term batches of ``K_MAX_TERMS``, 16-byte accesses where
the piece's streams are congruent modulo 16 bytes and 4-byte ones at the
ragged ends, and the GF(256) product of a word by three PRMT lookups in
split tables. This file emulates that schedule and that arithmetic in
numpy, from the same piece tables the kernel reads, and holds the result
bit for bit against the plain versions (``parity_xor_ref``,
``gf256_mac_plan_ref``) and the reference's Pallas kernels in interpret
mode:

- the word multiply, exhaustively: all 256 coefficients times all 256 byte
  values in every byte lane, against the port's ``tables.py``;
- the pieces of random plans against a per-word walk of their terms;
- the plans of ``encode_plan``, ``reconstruct_plan``, ``rs_encode_plan``
  (with the syndromes in batches of rows with ``out_shift``) and
  ``rs_decode_plan`` (src and src2 terms) on the quickstart layout, a
  small RS(4, 2) layout and a layout with tail-packed blocks;
- seeded random plans with unaligned offsets and pointers, partial
  overlaps, zero-term rows, pieces of more than ``K_MAX_TERMS`` terms and
  M = 1 to 8 outputs, whole and in row ranges with ``out_shift``;
- the dense forms against ``gf256_mac_pallas`` and ``parity_xor_pallas``
  (interpret mode), on seeded numpy inputs drawn once for both packages.

The same cases run the CUDA kernel on the card in
``tests/test_torch_rs_gpu.py`` and ``tests/test_torch_fabric_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gf256_mac.kernel import gf256_mac_pallas
from repro.kernels.parity_xor.kernel import parity_xor_pallas
from repro_torch.core.arena import pack_arena
from repro_torch.core.blocks import partition_pytree
from repro_torch.fabric import CheckpointFabric, FabricConfig
from repro_torch.kernels.gf256_mac import ops as gops
from repro_torch.kernels.gf256_mac.ref import gf256_mac_plan_ref
from repro_torch.kernels.gf256_mac.tables import gf_mul, gf_scale_words_np
from repro_torch.kernels.parity_xor import ops as pops
from repro_torch.kernels.parity_xor.ref import parity_xor_ref

K_MAX_TERMS = 32      # erasure_pieces.cuh: kMaxTerms
RS_FABRIC = dict(n_devices=8, devices_per_host=1, hosts_per_rack=4,
                 rs_parity=2)


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def prmt(x, y, s):
    """PTX prmt.b32 in its default mode: byte n of the result
    is byte ``s[4n:4n+3] & 7`` of ``{y, x}``, or its sign replicated where
    bit 3 of the selector nibble is set."""
    x = np.asarray(x, np.uint64) & 0xFFFFFFFF
    y = np.asarray(y, np.uint64) & 0xFFFFFFFF
    s = np.asarray(s, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for n in range(4):
        sel = (s >> np.uint64(4 * n)) & np.uint64(0xF)
        byte = (both >> (np.uint64(8) * (sel & np.uint64(7)))) & np.uint64(0xFF)
        sign = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        byte = np.where(sel & np.uint64(8), sign, byte)
        out |= byte << np.uint64(8 * n)
    return out


def gf_tables(c):
    """erasure_pieces.cuh::gf_tables: five words of c's products, c * e for
    e < 8, c * (e << 3) for e < 8, c * (e << 6) for e < 4, a byte each,
    built from c * x^i. ``c``: array of coefficients; returns (..., 5)."""
    c = np.asarray(c, np.uint64)
    p = []
    for _ in range(8):
        p.append(c)
        c = ((c << np.uint64(1)) ^ np.where(c & np.uint64(0x80),
                                            np.uint64(0x11D), np.uint64(0)))
    words = []
    for w in range(5):
        g = 0 if w < 2 else (3 if w < 4 else 6)
        e0 = 4 * (w & 1) if w < 4 else 0
        word = np.zeros_like(p[0])
        for k in range(4):
            e = e0 + k
            v = np.zeros_like(p[0])
            for b in range(3):
                if (e >> b) & 1 and g + b < 8:
                    v ^= p[g + b]
            word |= v << np.uint64(8 * k)
        words.append(word)
    return np.stack(words, axis=-1)


def gf_mul_word(t, w):
    """erasure_pieces.cuh::gf_mul_word: the four bytes of ``w`` times the
    coefficient of tables ``t`` (..., 5), broadcast."""
    w = np.asarray(w, np.uint64) & 0xFFFFFFFF
    v = prmt(w, 0, 0x3120)
    a0 = v & np.uint64(0x07070707)
    a1 = (v >> np.uint64(3)) & np.uint64(0x07070707)
    a2 = (v >> np.uint64(6)) & np.uint64(0x03030303)
    sh = np.uint64(12)
    return (prmt(t[..., 0], t[..., 1], a0 + (a0 >> sh))
            ^ prmt(t[..., 2], t[..., 3], a1 + (a1 >> sh))
            ^ prmt(t[..., 4], 0, a2 + (a2 >> sh)))


TABLES = gf_tables(np.arange(256))     # (256, 5), by coefficient


def test_split_table_multiply_exhaustive():
    """Every coefficient times every byte value, in every byte lane."""
    i = np.arange(256, dtype=np.uint64)
    words = (i | ((i + 85) % 256) << np.uint64(8)
             | ((i + 170) % 256) << np.uint64(16)
             | ((i + 255) % 256) << np.uint64(24))
    c = np.arange(256)
    got = gf_mul_word(gf_tables(c)[:, None, :], words[None, :])
    want = np.stack([gf_scale_words_np(words.astype(np.uint32).view(np.int32),
                                       int(k)) for k in c])
    np.testing.assert_array_equal(got.astype(np.uint32).view(np.int32), want)
    # byte by byte against gf_mul, lane 0
    np.testing.assert_array_equal(
        (got & np.uint64(0xFF)).astype(np.int64),
        gf_mul(c[:, None], i[None, :].astype(np.int64)))


# ---------------------------------------------------------------------------
# the kernel's schedule
# ---------------------------------------------------------------------------

def emulate(out, src, src2, base, pc, m, ostr, bstr, sel, coef, t0, t1,
            out_shift=0, addr=None, mul=True):
    """erasure_pieces_kernel over tiles ``[t0, t1)`` of the pieces ``pc``,
    in numpy, with the kernel's range split: per tile and term batch, a
    16-byte range where every stream is congruent to the output modulo 16
    bytes, 4-byte words at its ends or everywhere otherwise. ``addr``: the
    buffers' word addresses modulo 4 (their pointers' alignment). Returns
    how often each output word was seeded (1 for every word a row
    covers)."""
    addr = {**dict(out=0, src=0, src2=0, base=0), **(addr or {})}
    bufs = {"src": src, "src2": src2}
    seeded = np.zeros(out.size, np.int64)
    ostr, bstr = (ostr, bstr) if m > 1 else (0, 0)
    for tile in range(t0, t1):
        p = int(pc.tile_piece[tile])
        lo = int(pc.tile_lo[tile])
        hi = min(lo + pc.tile_words, int(pc.length[p]))
        e0, e1 = int(pc.term_ptr[p]), int(pc.term_ptr[p + 1])
        o = int(pc.out[p]) - out_shift
        b = int(pc.base[p])
        oa = addr["out"] + o
        mis = (ostr | bstr) & 3 != 0
        if b >= 0:
            mis |= (addr["base"] + b - oa) % 4 != 0
        head = (-oa) % 4
        eb = e0
        while True:
            batch = range(eb, min(e1, eb + K_MAX_TERMS))
            names = ["src2" if mul and sel[e] else "src" for e in batch]
            vec = not mis and all((addr[n] + int(pc.term_src[e]) - oa) % 4 == 0
                                  for n, e in zip(names, batch))
            if vec:
                vlo = min(lo + ((head - lo) & 3), hi)
                nv = (hi - vlo) >> 2
                ranges = [(lo, vlo - lo, 1), (vlo, nv, 4),
                          (vlo + 4 * nv, hi - vlo - 4 * nv, 1)]
            else:
                ranges = [(lo, hi - lo, 1)]
            for w0, n, width in ranges:
                if n <= 0:
                    continue
                words = np.arange(w0, w0 + n * width)
                if width == 4:      # every 16-byte access aligned
                    assert (oa + w0) % 4 == 0
                    assert all((addr[nm] + int(pc.term_src[e]) + w0) % 4 == 0
                               for nm, e in zip(names, batch))
                for q in range(m):
                    at = o + q * ostr + words
                    assert at.min() >= 0
                    if eb != e0:
                        acc = out[at].astype(np.uint64)
                    else:
                        seeded[at] += 1
                        acc = (base[b + q * bstr + words].astype(np.uint64)
                               if b >= 0 else np.zeros(words.size, np.uint64))
                    for nm, e in zip(names, batch):
                        s = bufs[nm][int(pc.term_src[e]) + words] \
                            .astype(np.uint64)
                        c = int(coef[e * m + q]) if mul else 1
                        if c == 1:
                            acc ^= s
                        elif c > 1:
                            acc ^= gf_mul_word(TABLES[c], s)
                    out[at] = acc.astype(np.uint32)
            eb += K_MAX_TERMS
            if eb >= e1:
                break
    return seeded


def _u32(t):
    return t.numpy().view(np.uint32).copy()


def run_gf(plan, src, src2, base, out_words, row0=0, n_rows=None,
           out_shift=0, addr=None, tile_words=pops.TILE_WORDS):
    """The emulated kernel and the plain version on rows ``[row0, row0 +
    n_rows)`` of a GFPlan; both outputs start filled with 7."""
    n_rows = plan.n_rows - row0 if n_rows is None else n_rows
    pc = pops.build_pieces(plan, tile_words)
    sel = plan.term_sel[pc.term]
    coef = plan.term_coef.reshape(-1, plan.m)[pc.term].reshape(-1)
    got = np.full(out_words, 7, np.uint32)
    t0, t1 = pc.tiles(row0, n_rows)
    seeded = emulate(got, _u32(src), None if src2 is None else _u32(src2),
                     None if base is None else _u32(base), pc, plan.m,
                     plan.out_stride, plan.base_stride, sel, coef, t0, t1,
                     out_shift, addr)
    want = gf256_mac_plan_ref(torch.full((out_words,), 7, dtype=torch.int32),
                              src, src2, base, plan.on("cpu"), row0, n_rows,
                              out_shift)
    return got.view(np.int32), want.numpy(), seeded


def run_xor(plan, src, base, addr=None, tile_words=pops.TILE_WORDS):
    pc = pops.build_pieces(plan, tile_words)
    got = np.full(plan.out_words, 7, np.uint32)
    seeded = emulate(got, _u32(src), None, None if base is None else _u32(base),
                     pc, 1, 0, 0, None, None, 0, int(pc.piece_tile[-1]),
                     addr=addr, mul=False)
    want = parity_xor_ref(torch.full((plan.out_words,), 7, dtype=torch.int32),
                          src, base, plan.on("cpu"))
    return got.view(np.int32), want.numpy(), seeded


def _covered(plan_rows, seeded, m=1, stride=0, shift=0):
    """Every word of the rows was seeded exactly once, nothing else."""
    want = np.zeros_like(seeded)
    for o, n in plan_rows:
        for q in range(m):
            want[o - shift + q * stride:o - shift + q * stride + n] += 1
    assert want.max() <= 1, "the plan's outputs overlap"
    np.testing.assert_array_equal(seeded, want)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_pieces_split_rows_exactly(seed):
    """Each word of a row lies in one piece, whose entries are the terms
    that cover it, read at the word's own source offset."""
    rng = np.random.default_rng(seed)
    row_len = rng.integers(0, 60, 12)
    rows, terms = [], []
    for r, n in enumerate(row_len):
        rows.append((int(row_len[:r].sum()), int(n),
                     -1 if r % 3 else int(rng.integers(0, 50))))
        ts = []
        for _ in range(int(rng.integers(0, 6))):
            a = int(rng.integers(0, n + 1))
            ts.append((a, int(rng.integers(0, 500)),
                       int(rng.integers(a, n + 1)) - a))
        terms.append(ts)
    plan = pops._plan(rows, terms)
    pc = pops.build_pieces(plan, tile_words=5)
    for r, (o, n, b) in enumerate(rows):
        seen = []
        for p in range(pc.row_piece[r], pc.row_piece[r + 1]):
            start = int(pc.out[p]) - o
            ent = range(pc.term_ptr[p], pc.term_ptr[p + 1])
            for w in range(start, start + int(pc.length[p])):
                seen.append(w)
                cover = sorted((plan.term_src[k] + w - plan.term_dst[k])
                               for k in range(plan.term_ptr[r],
                                              plan.term_ptr[r + 1])
                               if plan.term_dst[k] <= w
                               < plan.term_dst[k] + plan.term_len[k])
                assert sorted(pc.term_src[e] + w - start for e in ent) == cover
                assert (pc.base[p] + w - start if pc.base[p] >= 0 else -1) \
                    == (b + w if b >= 0 else -1)
            tiles = range(pc.piece_tile[p], pc.piece_tile[p + 1])
            assert [int(pc.tile_lo[t]) for t in tiles] == \
                list(range(0, int(pc.length[p]), 5))
            assert all(pc.tile_piece[t] == p for t in tiles)
        assert seen == list(range(n))


def test_pieces_refuse_a_term_outside_its_row():
    with pytest.raises(ValueError):
        pops.build_pieces(pops._plan([(0, 4, -1)], [[(2, 0, 3)]]))


# ---------------------------------------------------------------------------
# the codec's plans
# ---------------------------------------------------------------------------

def _layout_tree(kind):
    rng = np.random.default_rng(5)
    if kind == "quickstart":          # make_model("mlr", n=600, dim=64, ...)
        shapes = {"w": (64, 5), "b": (5,)}
    elif kind == "tail":
        shapes = {"big": (40, 300), "w": (50, 6), "b": (5,), "c": (3, 7),
                  "s": ()}
    else:
        shapes = {"big": (40, 300), "w": (96, 12), "v": (24, 80),
                  "b": (13,)}
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in shapes.items()}


def _fabric(kind, rs: bool):
    tree = _layout_tree(kind)
    part = partition_pytree(tree, 8)
    cfg = FabricConfig(**RS_FABRIC) if rs else FabricConfig()
    fab = CheckpointFabric(part, cfg)
    return tree, part, fab.arena_layout, fab.parity


LAYOUTS = ["quickstart", "tail", "rs42"]


@pytest.mark.parametrize("tile_words", [pops.TILE_WORDS, 22])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_schedule_on_parity_xor_plans(kind, tile_words):
    tree, part, lay, codec = _fabric(kind, rs=False)
    x = pack_arena(tree, lay)
    enc = pops.encode_plan(lay, codec.layout, codec.members)
    got, want, seeded = run_xor(enc, x, None, tile_words=tile_words)
    np.testing.assert_array_equal(got, want)
    _covered(zip(enc.row_out, enc.row_len), seeded)
    par = torch.from_numpy(want.copy())
    lost = np.zeros((part.total_blocks,), bool)
    for j, row in enumerate(codec.members):
        lost[row[row >= 0][j % int((row >= 0).sum())]] = True
    keep = codec.valid & ~lost[np.where(codec.valid, codec.members, 0)]
    rec, blocks = pops.reconstruct_plan(lay, codec.layout, codec.group_of,
                                        codec.members, np.nonzero(lost)[0],
                                        keep)
    got, want, seeded = run_xor(rec, x, par, tile_words=tile_words)
    np.testing.assert_array_equal(got, want)
    _covered(zip(rec.row_out, rec.row_len), seeded)
    ab = lay.ab_arrays()
    words = np.concatenate([x.numpy()[ab["offset"][a]:ab["offset"][a]
                                      + ab["payload"][a]] for a in blocks])
    np.testing.assert_array_equal(got, words)


@pytest.mark.parametrize("tile_words", [pops.TILE_WORDS, 22])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_schedule_on_gf256_mac_plans(kind, tile_words):
    """The RS(4, 2) encode, its syndromes in batches of two groups with
    out_shift, and a decode of up to two erasures a group from the arena
    (src) and the stored rows (src2)."""
    tree, part, lay, codec = _fabric(kind, rs=True)
    x = pack_arena(tree, lay)
    enc, syn = codec.gf_plans(lay)
    m, fe = codec.n_parity, codec.layout.frame_elems
    n_out = codec.n_groups * m * fe
    got, want, seeded = run_gf(enc, x, None, None, n_out,
                               tile_words=tile_words)
    np.testing.assert_array_equal(got, want)
    _covered(zip(enc.row_out, enc.row_len), seeded, m, enc.out_stride)
    rows = torch.from_numpy(want.copy())
    bad = x.clone()
    bad[lay.blocks[len(lay.blocks) // 2].offset] ^= 1 << 9
    per = m * fe
    for g0 in range(0, codec.n_groups, 2):
        nb = min(2, codec.n_groups - g0)
        got, want, seeded = run_gf(syn, bad, None, rows, 2 * per, g0, nb,
                                   g0 * per, tile_words=tile_words)
        np.testing.assert_array_equal(got, want)
        _covered(zip(syn.row_out[g0:g0 + nb], syn.row_len[g0:g0 + nb]),
                 seeded, m, syn.out_stride, g0 * per)
    codec.parity = rows.view(codec.n_groups, m, fe)
    codec.encoded_step = 0
    lost = np.zeros((part.total_blocks,), bool)
    for row in codec.members:
        ids = row[row >= 0]
        lost[ids[:min(m, ids.size)]] = True
    dec, blocks = codec.decode_plan(lay, lost, ~lost)
    assert set(dec.term_sel.tolist()) == {0, 1}
    n_dec = int(dec.row_len.astype(np.int64).sum())
    got, want, seeded = run_gf(dec, x, rows, None, n_dec,
                               tile_words=tile_words)
    np.testing.assert_array_equal(got, want)
    _covered(zip(dec.row_out, dec.row_len), seeded)
    ab = lay.ab_arrays()
    words = np.concatenate([x.numpy()[ab["offset"][a]:ab["offset"][a]
                                      + ab["payload"][a]] for a in blocks])
    np.testing.assert_array_equal(got, words)


# ---------------------------------------------------------------------------
# random plans
# ---------------------------------------------------------------------------

def random_gf_plan(rng, m, n_rows=40, src_words=3000, src2_words=700):
    """Rows of ragged lengths at unaligned offsets, some based, some
    without terms; terms at unaligned columns and source offsets that
    overlap in part, from both sources, one row with more than
    K_MAX_TERMS terms over one piece; coefficients 0, 1 and random."""
    rows, terms, out = [], [], int(rng.integers(0, 4))
    for r in range(n_rows):
        n = int(rng.integers(1, 90))
        rows.append((out, n, -1 if r % 4 == 1 else int(rng.integers(0, 200))))
        out += n + int(rng.integers(0, 3))
        k = 0 if r % 7 == 3 else (K_MAX_TERMS + 5 if r == 5
                                  else int(rng.integers(1, 7)))
        ts = []
        for _ in range(k):
            a = 0 if r == 5 else int(rng.integers(0, n))
            ln = n if r == 5 else int(rng.integers(1, n - a + 1))
            s2 = int(rng.integers(0, 4) == 0)
            lim = (src2_words if s2 else src_words) - ln
            c = rng.integers(0, 256, m)
            c[rng.random(m) < 0.2] = 1
            c[rng.random(m) < 0.1] = 0
            ts.append((a, int(rng.integers(0, lim)), ln, s2, c))
        terms.append(ts)
    # a row's outputs lie apart from every other row's (unaligned strides)
    ostr = out + int(rng.integers(0, 4)) if m > 1 else 0
    bstr = 1000 + int(rng.integers(0, 3)) if m > 1 else 0
    plan = gops._plan(m, ostr, bstr, rows, terms)
    out_words = out + (m - 1) * ostr + 100
    return plan, out_words


@pytest.mark.parametrize("m", range(1, 9))
def test_schedule_on_random_plans(m):
    rng = np.random.default_rng(100 + m)
    plan, out_words = random_gf_plan(rng, m)
    src = torch.from_numpy(rng.integers(-2**31, 2**31, 3000).astype(np.int32))
    src2 = torch.from_numpy(rng.integers(-2**31, 2**31, 700).astype(np.int32))
    base = torch.from_numpy(rng.integers(-2**31, 2**31, 200 + 7 * 400 * 4 + 90)
                            .astype(np.int32))
    for addr in (None, dict(out=1, src=1, src2=1, base=1),
                 dict(out=3, src=0, src2=2, base=1)):
        for tile_words in (pops.TILE_WORDS, 13):
            got, want, seeded = run_gf(plan, src, src2, base, out_words,
                                       addr=addr, tile_words=tile_words)
            np.testing.assert_array_equal(got, want)
            _covered(zip(plan.row_out, plan.row_len), seeded, m,
                     plan.out_stride)
    # a row range with out_shift, as the syndrome batches run it
    shift = int(plan.row_out[10])
    lim = plan.limits(10, 20)
    got, want, _ = run_gf(plan, src, src2, base, lim["out_hi"] - shift, 10,
                          20, shift, tile_words=13)
    np.testing.assert_array_equal(got, want)


def test_schedule_on_random_parity_plans():
    rng = np.random.default_rng(7)
    rows, terms, out = [], [], 1
    for r in range(60):
        n = int(rng.integers(1, 70))
        rows.append((out, n, -1 if r % 2 else int(rng.integers(0, 300))))
        out += n
        ts = []
        for _ in range(0 if r % 9 == 4 else int(rng.integers(1, 5))):
            a = int(rng.integers(0, n))
            ln = int(rng.integers(1, n - a + 1))
            ts.append((a, int(rng.integers(0, 2000 - ln)), ln))
        terms.append(ts)
    plan = pops._plan(rows, terms)
    src = torch.from_numpy(rng.integers(-2**31, 2**31, 2000).astype(np.int32))
    base = torch.from_numpy(rng.integers(-2**31, 2**31, 400).astype(np.int32))
    for addr in (None, dict(out=2, src=2, base=2), dict(out=1, src=3)):
        got, want, seeded = run_xor(plan, src, base, addr, tile_words=11)
        np.testing.assert_array_equal(got, want)
        _covered(zip(plan.row_out, plan.row_len), seeded)


# ---------------------------------------------------------------------------
# the dense forms against the reference's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

DENSE = [(5, 4, 70, 1), (3, 1, 4097, 2), (7, 3, 1, 3), (2, 6, 901, 4)]


@pytest.mark.parametrize("n,g,e,m", DENSE)
def test_dense_gf256_mac_schedule_matches_pallas(n, g, e, m):
    rng = np.random.default_rng(n * 1000 + e)
    frames = rng.integers(-2**31, 2**31, (n, g, e)).astype(np.int32)
    base = rng.integers(-2**31, 2**31, (n, e)).astype(np.int32)
    coef = rng.integers(0, 256, (m, n, g)).astype(np.int32)
    coef[:, 0, 0] = np.array([0, 1, 2, 255])[:m]
    plan = gops._dense_plan(n, g, e, coef.transpose(1, 2, 0), based=True)
    got, _, _ = run_gf(plan, torch.from_numpy(frames.reshape(-1)), None,
                       torch.from_numpy(np.repeat(base[:, None], m, 1)
                                        .reshape(-1)), n * m * e,
                       tile_words=512)
    got = got.reshape(n, m, e)
    for q in range(m):
        want = gf256_mac_pallas(jnp.asarray(frames), jnp.asarray(base),
                                jnp.asarray(coef[q]), interpret=True)
        np.testing.assert_array_equal(got[:, q], np.asarray(want))


@pytest.mark.parametrize("n,g,e", [(5, 4, 70), (3, 1, 4097), (7, 3, 1)])
def test_dense_parity_xor_schedule_matches_pallas(n, g, e):
    rng = np.random.default_rng(n + e)
    frames = rng.integers(-2**31, 2**31, (n, g, e)).astype(np.int32)
    base = rng.integers(-2**31, 2**31, (n, e)).astype(np.int32)
    keep = rng.random((n, g)) < 0.7
    plan = pops._plan([(j * e, e, j * e) for j in range(n)],
                      [[(0, (j * g + i) * e, e) for i in range(g)
                        if keep[j, i]] for j in range(n)])
    got, want, _ = run_xor(plan, torch.from_numpy(frames.reshape(-1)),
                           torch.from_numpy(base.reshape(-1)), tile_words=512)
    np.testing.assert_array_equal(got, want)
    ref = parity_xor_pallas(jnp.asarray(frames), jnp.asarray(base),
                            jnp.asarray(keep), interpret=True)
    np.testing.assert_array_equal(got.reshape(n, e), np.asarray(ref))
