"""k-step FM-index construction (host side).

Builds the same logical index as the reference's gfmiBaseLine binaries
(reference src/genFMindex.c:457-543) but accelerator-first:

* The k BWT levels are derived **directly from the suffix array** with
  vectorized gathers — BWT_i[j] = T[(SA[j] - 1 - i) mod N] — instead of the
  reference's serial LF-mapping walk over the whole text
  (reference src/genFMindex.c:327-400, one dependent memory access per text
  position). The dollar position of level i is the rank of suffix i:
  BWT_i[j] = '$'  iff  SA[j] == i.

* The index is a structure-of-arrays pytree of uint32 arrays (not an
  array-of-structs entry table): `occ[nentries+1, 4^k]` counters and
  `bitmaps[nentries+1, k, 2, d/32]` bit-planes. SoA is what XLA
  wants; the reference's interleaved AoS entry (src/genFMindex.c:42-45) was a
  cache-line artifact and is kept only as an on-disk packing
  (tpufm/index/formats.py).

* One extra sentinel row is appended: occ[nentries] = Cb + total counts and
  bitmaps[nentries] = 0. It makes the initial R = bwtsize lookup in-bounds
  and *correct* even when bwtsize % d == 0 — a case where the reference
  searcher reads out of bounds (reference src/fmIndexCPUBaseline.c:209
  computes indexCounterR = bwtsize/d == nentries).

Counter semantics match reference src/genFMindex.c:184-260 exactly:
  entry.cnt[c] = Cb[c] + Occ(c, entry_start), where Occ excludes every
  position that is a '$' in ANY of the k levels (checkPositionBWT,
  src/genFMindex.c:115-121), and Cb[c] = sum of total counts of all k-mers
  < c, incremented once per level i for every c >= (dollar k-mer of level i
  with levels below i cleared) (src/genFMindex.c:237-250).
Bitmap packing matches src/genFMindex.c:402-455: per entry, per level, two
bit-planes (plane 0 = low code bit, plane 1 = high code bit) of d/32 words,
MSB-first within each 32-base window; '$' is encoded as 'A'
(src/genFMindex.c:505-509).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpufm.config import IndexConfig
from tpufm.index.suffix_array import suffix_array
from tpufm.utils.encoding import encode_bases


@dataclasses.dataclass
class KStepFMIndex:
    """Logical (layout-independent) k-step FM-index.

    occ:      uint32 [nentries + 1, 4^k] — Cb-accumulated Occ counters per
              block; row nentries is the end-of-text sentinel.
    bitmaps:  uint32 [nentries + 1, k, 2, d/32] — 2-bit-plane BWT bitmaps;
              plane 0 holds the low code bit, plane 1 the high code bit;
              row nentries is zero.
    dollar_pos:  uint32 [k] — BWT position of '$' per level.
    dollar_base: uint32 [k] — k-mer code at dollar_pos (with '$' read as 'A').
    """

    config: IndexConfig
    bwtsize: int
    occ: np.ndarray
    bitmaps: np.ndarray
    dollar_pos: np.ndarray
    dollar_base: np.ndarray

    @property
    def nentries(self) -> int:
        """Number of real entries (excluding the sentinel row)."""
        return self.occ.shape[0] - 1

    @property
    def dollar_block(self) -> np.ndarray:
        return self.dollar_pos // np.uint32(self.config.d)

    def astuple(self):
        return (self.occ, self.bitmaps, self.dollar_pos, self.dollar_base)


def pack_bitplane_words(bits: np.ndarray) -> np.ndarray:
    """Pack a [..., 32] array of 0/1 bits into uint32 words, MSB-first.

    Bit for in-window offset p lands at bit (31 - p), matching
    reference src/genFMindex.c:402-424 (substring2bitmap).
    """
    if bits.shape[-1] != 32:
        raise ValueError("last axis must be 32")
    by = np.packbits(bits.astype(np.uint8), axis=-1)  # [..., 4], MSB-first
    by = by.astype(np.uint32)
    return (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]


def normalize_reference(reference) -> np.ndarray:
    """str/bytes ACGT text or uint8 array -> 2-bit codes (shared by every
    builder entry point so SA and index always see the same encoding)."""
    if isinstance(reference, (str, bytes, bytearray)):
        return encode_bases(reference)
    codes = np.asarray(reference, dtype=np.uint8)
    if codes.size and codes.max() > 3:
        codes = encode_bases(codes)
    return codes


def build_index(
    reference,
    config: IndexConfig = IndexConfig(),
    sa_method: str = "auto",
    sa: np.ndarray | None = None,
) -> KStepFMIndex:
    """Build a k-step FM-index from a DNA reference.

    reference: str/bytes of ACGT, or a uint8 array of 2-bit codes.
    sa: optional precomputed suffix array of codes + sentinel (int64
    [n+1], sa[0] == n) — lets callers build several indexes / locate
    tables from one suffix sort.
    """
    codes = normalize_reference(reference)

    k, d = config.k, config.d
    n = int(codes.shape[0])
    bwtsize = n + 1
    ncounters = config.num_counters
    nb = config.words_per_plane
    nentries = config.num_entries(bwtsize)

    if sa is None:
        sa = suffix_array(codes, method=sa_method)  # int64 [bwtsize]
    elif sa.shape[0] != bwtsize:
        raise ValueError(f"sa has {sa.shape[0]} entries, expected {bwtsize}")

    # T with '$' -> 'A' (code 0): the bitmap/counter alphabet never sees '$'.
    t_codes = np.empty(bwtsize, dtype=np.uint8)
    t_codes[:n] = codes
    t_codes[n] = 0

    # dollar_pos[i] = rank of suffix i  (BWT_i[j] == '$' iff SA[j] == i).
    dollar_pos = np.empty(k, dtype=np.int64)
    small = np.flatnonzero(sa < k)
    dollar_pos[sa[small]] = small
    if np.unique(dollar_pos).size != k:
        raise AssertionError("internal: dollar positions not unique")

    # Level codes per BWT position, '$' read as 'A'. Computed (like the
    # per-block counts below) in d-aligned chunks: at 3 Gbase the one-shot
    # vectorized formulation materializes ~100 GB of int64 temporaries
    # (block ids, fused k-mers, flattened bincount keys) and OOMs a 128 GB
    # host; chunking bounds the peak at SA + levels + counters (~55 GB).
    chunk = max(d, (1 << 27) // d * d)
    levels = np.empty((k, bwtsize), dtype=np.uint8)
    for start in range(0, bwtsize, chunk):
        sl = sa[start : start + chunk]
        for i in range(k):
            prev = sl - (1 + i)
            prev[prev < 0] += bwtsize  # mod N without a division
            levels[i, start : start + chunk] = t_codes[prev]
    del sa

    dollar_base = np.zeros(k, dtype=np.uint32)
    for i in range(k):
        dollar_base |= levels[i, dollar_pos].astype(np.uint32) << np.uint32(2 * i)

    # --- Per-block Occ counts, dollar-exclusive -------------------------
    counts = np.zeros((nentries, ncounters), dtype=np.int64)
    for start in range(0, bwtsize, chunk):
        stop = min(start + chunk, bwtsize)
        km = np.zeros(stop - start, dtype=np.int64)
        for i in range(k):
            km |= levels[i, start:stop].astype(np.int64) << (2 * i)
        rel_block = (np.arange(start, stop, dtype=np.int64) - start) // d
        km += rel_block * ncounters
        # Valid positions: not a '$' in any level (reference checkPositionBWT).
        for dp in dollar_pos:
            if start <= dp < stop:
                km[dp - start] = -1
        km = km[km >= 0]
        b0 = start // d
        nb_chunk = -(-(stop - start) // d)
        counts[b0 : b0 + nb_chunk] += np.bincount(
            km, minlength=nb_chunk * ncounters
        ).reshape(nb_chunk, ncounters)
    totals = counts.sum(axis=0)

    # Exclusive prefix over blocks, plus the end-of-text sentinel row.
    occ = np.zeros((nentries + 1, ncounters), dtype=np.int64)
    np.cumsum(counts, axis=0, out=occ[1:])

    # --- Cb accumulation (reference src/genFMindex.c:237-250) -----------
    acc = np.zeros(ncounters, dtype=np.int64)
    acc[1:] = np.cumsum(totals)[:-1]
    for i in range(k):
        masked = int(dollar_base[i]) & ~((1 << (2 * i)) - 1)
        acc[masked:] += 1
    occ += acc

    occ_u32 = occ.astype(np.uint32)

    # --- Bitmaps (chunked like the counts pass) --------------------------
    bitmaps = np.zeros((nentries + 1, k, 2, nb), dtype=np.uint32)
    for start in range(0, bwtsize, chunk):
        stop = min(start + chunk, bwtsize)
        seg = levels[:, start:stop]
        seg_pad = -(stop - start) % d
        if seg_pad:
            seg = np.concatenate(
                [seg, np.zeros((k, seg_pad), dtype=np.uint8)], axis=1
            )
        b0, nb_chunk = start // d, seg.shape[1] // d
        for plane in range(2):
            bits = (seg >> plane) & 1  # [k, chunk]
            words = pack_bitplane_words(bits.reshape(k, nb_chunk, nb, 32))
            bitmaps[b0 : b0 + nb_chunk, :, plane, :] = words.transpose(1, 0, 2)

    return KStepFMIndex(
        config=config,
        bwtsize=bwtsize,
        occ=occ_u32,
        bitmaps=bitmaps,
        dollar_pos=dollar_pos.astype(np.uint32),
        dollar_base=dollar_base,
    )


def derive_tail(index: KStepFMIndex) -> KStepFMIndex:
    """Derive the k=1 (any-length tail) index from ANY k-step index — no
    text, no suffix array, no rebuild.

    The level-0 bitplanes store BWT0 verbatim ('$' as 'A', see build_index
    above), so one linear counting pass over them reproduces the k=1
    Occ/Cb tables byte-identically to building k=1 from the text
    (tests/test_tail.py::test_derive_tail_byte_identical), and the k=1
    bitmaps are the level-0 slice itself. The level-0 '$' reads as 'A', so
    dollar_base is always [0] — matching the from-text build, where
    BWT0[dollar_pos[0]] is the sentinel.

    This makes any-read-length search available on every existing index:
    the CLI derives the tail on the fly when no `.tail.npz` sibling exists.
    """
    cfg = index.config
    if cfg.k == 1:
        return index
    d = cfg.d
    E = index.nentries
    bwtsize = index.bwtsize
    dp0 = int(index.dollar_pos[0])

    shifts = np.arange(31, -1, -1, dtype=np.uint32)
    counts = np.zeros((E, 4), dtype=np.int64)
    chunk = max(1, (1 << 27) // d)  # blocks per pass (bounds temporaries)
    for b0 in range(0, E, chunk):
        b1 = min(b0 + chunk, E)
        w = np.asarray(index.bitmaps[b0:b1, 0])  # [B, 2, nb]
        bits = ((w[..., None] >> shifts) & np.uint32(1)).astype(np.uint8)
        chars = (
            bits[:, 0].reshape(b1 - b0, d)
            | (bits[:, 1].reshape(b1 - b0, d) << 1)
        )
        gpos = np.arange(b0 * d, b1 * d, dtype=np.int64).reshape(b1 - b0, d)
        valid = gpos < bwtsize  # trailing pad bits of the last block
        if b0 * d <= dp0 < b1 * d:
            valid[dp0 // d - b0, dp0 % d] = False  # dollar-exclusive
        key = (
            chars.astype(np.int64)
            + np.arange(b1 - b0, dtype=np.int64)[:, None] * 4
        )[valid]
        counts[b0:b1] += np.bincount(key, minlength=(b1 - b0) * 4).reshape(
            -1, 4
        )

    totals = counts.sum(axis=0)
    occ = np.zeros((E + 1, 4), dtype=np.int64)
    np.cumsum(counts, axis=0, out=occ[1:])
    acc = np.zeros(4, dtype=np.int64)
    acc[1:] = np.cumsum(totals)[:-1]
    c0 = int(index.dollar_base[0]) & 3  # level-0 char at dp0 — always 'A'
    acc[c0:] += 1
    occ += acc

    return KStepFMIndex(
        config=IndexConfig(k=1, d=d),
        bwtsize=bwtsize,
        occ=occ.astype(np.uint32),
        bitmaps=np.ascontiguousarray(index.bitmaps[:, :1]),
        dollar_pos=np.asarray([dp0], dtype=np.uint32),
        dollar_base=np.asarray([c0], dtype=np.uint32),
    )


def derive_bwts(codes: np.ndarray, k: int, sa: np.ndarray | None = None):
    """Return the k BWT level strings (bytes, with '$') and dollar positions —
    the debugging view the reference dumps under INDEX_DGB=1
    (reference src/genFMindex.c:523-535). Not used by the search path."""
    from tpufm.index.suffix_array import suffix_array
    from tpufm.utils.encoding import decode_bases

    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    bwtsize = n + 1
    if sa is None:
        sa = suffix_array(codes)
    dollar_pos = np.empty(k, dtype=np.int64)
    small = np.flatnonzero(sa < k)
    dollar_pos[sa[small]] = small

    t_codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    bwts = []
    for i in range(k):
        prev = sa - (1 + i)
        prev[prev < 0] += bwtsize
        s = bytearray(decode_bases(t_codes[prev]))
        s[dollar_pos[i]] = ord("$")
        bwts.append(bytes(s))
    return bwts, dollar_pos


def total_kmer_counts_bitmap(index: KStepFMIndex) -> np.ndarray:
    """Bitmap-inclusive total count of each k-mer over all real blocks:
    '$' positions count as their 'A'-encoded k-mer and padding positions as
    k-mer 0. int64 [4^k]. Used to reconstruct end-of-text counters when
    loading foreign .fmi images."""
    from tpufm.bitops import match_words, popcount_rows

    cfg = index.config
    bm = index.bitmaps[: index.nentries]
    out = np.empty(cfg.num_counters, dtype=np.int64)
    for c in range(cfg.num_counters):
        out[c] = popcount_rows(match_words(bm, np.uint32(c), cfg.k)).sum()
    return out


def count_kmer_in_block(
    index: KStepFMIndex, block: int, code: int, prefix_len: int
) -> int:
    """Popcount-match of k-mer `code` in the first `prefix_len` positions of
    `block`'s bitmaps ('$' counted as its dollar_base k-mer, padding as 'A').

    Host-side mirror of the searcher's per-block popcount
    (reference src/fmIndexCPUBaseline.c:230-250) and of countEntry
    (reference src/transformIndexAlternateCounters.c:91-127).
    """
    cfg = index.config
    nb = cfg.words_per_plane
    total = 0
    shift = prefix_len
    for w in range(nb):
        cov = min(max(shift, 0), 32)
        mask = np.uint32(0) if cov == 0 else np.uint32(0xFFFFFFFF) << np.uint32(32 - cov)
        m = np.uint32(mask)
        for i in range(cfg.k):
            b0 = (code >> (2 * i)) & 1
            b1 = (code >> (2 * i + 1)) & 1
            p0 = index.bitmaps[block, i, 0, w]
            p1 = index.bitmaps[block, i, 1, w]
            sel0 = p0 if b0 else np.uint32(~p0)
            sel1 = p1 if b1 else np.uint32(~p1)
            m &= sel0 & sel1
        total += int(np.bitwise_count(m))
        shift -= 32
    return total
