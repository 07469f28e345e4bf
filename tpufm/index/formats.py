"""On-disk index formats.

1. Reference-compatible `.fmi` binary images, byte-exact vs the reference
   writers, for all four tags (SURVEY.md section 2):
     tag 100  baseline        (reference src/genFMindex.c:155-181)
     tag 101  interleaved     (reference src/transformIndexBitmaps.c:96-123)
     tag 200  alt-counters    (reference src/transformIndexAlternateCounters.c:163-189)
     tag 201  interleaved+AC  (reference src/transformIndexAlternateCounters.c:191-217)
   Header: uint32 {tag, steps, bwtsize, ncounters, nentries, chunk},
   then dollarPositionBWT[k], dollarBaseBWT[k], then the entry table.
   Entry layouts: tags 100/101 put bitmaps first then 4^k counters
   (genFMindex.c:42-45); tags 200/201 put the 4^k/2 slim counters first then
   bitmaps (transformIndexAlternateCounters.c:48-51). All little-endian.

2. A native `.tpufm.npz` format holding the SoA arrays directly (the
   persistence layer for device runs; the reference's index files ARE its
   checkpointing story, SURVEY.md section 5).
"""

from __future__ import annotations

import numpy as np

from tpufm.config import IndexConfig, Layout
from tpufm.index.builder import (
    KStepFMIndex,
    count_kmer_in_block,
    total_kmer_counts_bitmap,
)
from tpufm.index.layouts import (
    AltCountersIndex,
    interleave_bitmap_words,
    deinterleave_bitmap_words,
    make_alt_counters,
)

_U32 = np.dtype("<u4")


def _flat_bitmaps(index: KStepFMIndex, interleaved: bool) -> np.ndarray:
    """[nentries, bitmap_words] in the requested on-disk word order."""
    bm = index.bitmaps[: index.nentries]
    if interleaved:
        bm = interleave_bitmap_words(bm)
    return bm.reshape(index.nentries, -1)


def _header(index: KStepFMIndex, tag: int, ncounters: int, nentries: int) -> np.ndarray:
    cfg = index.config
    head = [tag, cfg.k, index.bwtsize, ncounters, nentries, cfg.d]
    head += [int(x) for x in index.dollar_pos]
    head += [int(x) for x in index.dollar_base]
    return np.asarray(head, dtype=_U32)


def write_fmi(path, index: KStepFMIndex, layout: Layout | None = None) -> None:
    """Write a reference-compatible .fmi image in the given layout."""
    layout = layout or index.config.layout
    cfg = index.config
    interleaved = layout in (Layout.INTERLEAVED, Layout.INTERLEAVED_ALT_COUNTERS)

    if layout.has_slim_counters:
        # Byte-exact vs the reference tfmiAC writer, including its
        # bitmap-inclusive appended-entry arithmetic (see make_alt_counters).
        ac = make_alt_counters(index, reference_semantics=True)
        n_file = index.nentries + 1
        S = cfg.num_slim_counters
        entries = np.zeros((n_file, S + cfg.bitmap_words), dtype=_U32)
        entries[:, :S] = ac.occ_slim[:n_file]
        # Bitmaps: real rows, then one all-zero appended row (reference
        # transformIndexCPU/GPU corner case :452-458).
        bm = _flat_bitmaps(index, interleaved)
        entries[: index.nentries, S:] = bm
        head = _header(index, layout.fmi_tag, S, n_file)
    else:
        entries = np.concatenate(
            [_flat_bitmaps(index, interleaved), index.occ[: index.nentries]],
            axis=1,
        ).astype(_U32)
        head = _header(index, layout.fmi_tag, cfg.num_counters, index.nentries)

    with open(path, "wb") as fp:
        head.tofile(fp)
        entries.tofile(fp)


def _reconstruct_sentinel(index_rows, bitmaps, dollar_pos, dollar_base, cfg, bwtsize):
    """Rebuild the end-of-text sentinel occ row (Cb + dollar-exclusive totals)
    from the stored last entry plus a bitmap recount of the final block."""
    nentries = index_rows.shape[0]
    m = bwtsize % cfg.d
    prefix = m if m else cfg.d
    last_block = (bwtsize - 1) // cfg.d
    tmp = KStepFMIndex(
        config=cfg,
        bwtsize=bwtsize,
        occ=np.zeros((1, cfg.num_counters), dtype=np.uint32),
        bitmaps=bitmaps,
        dollar_pos=dollar_pos,
        dollar_base=dollar_base,
    )
    sentinel = index_rows[last_block].astype(np.int64).copy()
    for c in range(cfg.num_counters):
        bm_count = count_kmer_in_block(tmp, last_block, c, prefix)
        dollars = int(
            np.sum((dollar_pos // cfg.d == last_block) & (dollar_base == c))
        )
        sentinel[c] += bm_count - dollars
    return sentinel.astype(np.uint32)


def read_fmi(path) -> tuple[KStepFMIndex, Layout]:
    """Read any reference .fmi image back into the logical SoA index."""
    with open(path, "rb") as fp:
        head = np.fromfile(fp, dtype=_U32, count=6)
        tag, k, bwtsize, ncounters, nentries_file, d = (int(x) for x in head)
        layout = Layout.from_fmi_tag(tag)
        dollar_pos = np.fromfile(fp, dtype=_U32, count=k)
        dollar_base = np.fromfile(fp, dtype=_U32, count=k)
        cfg = IndexConfig(k=k, d=d, layout=layout)
        interleaved = layout in (Layout.INTERLEAVED, Layout.INTERLEAVED_ALT_COUNTERS)
        nb = cfg.words_per_plane

        if layout.has_slim_counters:
            S = cfg.num_slim_counters
            if ncounters != S:
                raise ValueError(f"tag {tag} with {ncounters} counters, expected {S}")
            words = S + cfg.bitmap_words
            entries = np.fromfile(fp, dtype=_U32, count=nentries_file * words)
            entries = entries.reshape(nentries_file, words)
            nentries = nentries_file - 1  # appended end-of-text entry
            occ_slim_rows = entries[:, :S]
            bm = entries[:nentries, S:]
        else:
            if ncounters != cfg.num_counters:
                raise ValueError(
                    f"tag {tag} with {ncounters} counters, expected {cfg.num_counters}"
                )
            words = cfg.bitmap_words + cfg.num_counters
            entries = np.fromfile(fp, dtype=_U32, count=nentries_file * words)
            entries = entries.reshape(nentries_file, words)
            nentries = nentries_file
            bm = entries[:, : cfg.bitmap_words]
            occ_rows = entries[:, cfg.bitmap_words :]

    bitmaps = np.zeros((nentries + 1, k, 2, nb), dtype=np.uint32)
    if interleaved:
        bitmaps[:nentries] = deinterleave_bitmap_words(
            bm.reshape(nentries, nb, k, 2)
        )
    else:
        bitmaps[:nentries] = bm.reshape(nentries, k, 2, nb)

    if layout.has_slim_counters:
        occ = np.zeros((nentries + 1, cfg.num_counters), dtype=np.uint32)
        index = KStepFMIndex(
            config=cfg,
            bwtsize=bwtsize,
            occ=occ,
            bitmaps=bitmaps,
            dollar_pos=dollar_pos,
            dollar_base=dollar_base,
        )
        S = cfg.num_slim_counters
        occ_slim = np.zeros((nentries + 2, S), dtype=np.uint32)
        occ_slim[:nentries_file] = occ_slim_rows
        m = bwtsize % d
        half = S if nentries % 2 else 0
        if m:
            # Correct the appended end-of-text row to dollar-exclusive
            # semantics (the on-disk reference value counts a '$' in the last
            # block as its 'A' k-mer; see make_alt_counters).
            in_last = dollar_pos // d == (nentries - 1)
            for cc in range(S):
                occ_slim[nentries, cc] -= np.uint32(
                    np.sum(in_last & (dollar_base == half + cc))
                )
        else:
            # bwtsize % d == 0: the on-disk appended row is garbage (the
            # reference's countEntry recounts a block past the table) and the
            # initial R = bwtsize lookup needs a safety row. Reconstruct the
            # true end-of-text counters from the bitmaps + '$' metadata.
            totals_bm = total_kmer_counts_bitmap(index)
            totals = totals_bm - np.bincount(
                dollar_base, minlength=cfg.num_counters
            )
            cb = np.zeros(cfg.num_counters, dtype=np.int64)
            cb[1:] = np.cumsum(totals)[:-1]
            for i in range(k):
                masked = int(dollar_base[i]) & ~((1 << (2 * i)) - 1)
                cb[masked:] += 1
            end_true = (cb + totals).astype(np.uint32)
            occ_slim[nentries] = end_true[half : half + S]
            half2 = S - half
            safety = end_true[half2 : half2 + S].copy()
            if half2 == 0:
                safety[0] += np.uint32(d)
            occ_slim[nentries + 1] = safety
        _reconstruct_full_occ(index, occ_slim)
        return AltCountersIndex(base=index, occ_slim=occ_slim), layout

    occ = np.zeros((nentries + 1, cfg.num_counters), dtype=np.uint32)
    occ[:nentries] = occ_rows
    index = KStepFMIndex(
        config=cfg,
        bwtsize=bwtsize,
        occ=occ,
        bitmaps=bitmaps,
        dollar_pos=dollar_pos,
        dollar_base=dollar_base,
    )
    occ[nentries] = _reconstruct_sentinel(
        occ_rows, bitmaps, dollar_pos, dollar_base, cfg, bwtsize
    )
    return index, layout


def save_npz(path, index: KStepFMIndex) -> None:
    """Native SoA persistence (checkpoint of the built index)."""
    np.savez_compressed(
        path,
        version=np.int32(1),
        k=np.int32(index.config.k),
        d=np.int32(index.config.d),
        layout=np.bytes_(index.config.layout.value.encode()),
        bwtsize=np.int64(index.bwtsize),
        occ=index.occ,
        bitmaps=index.bitmaps,
        dollar_pos=index.dollar_pos,
        dollar_base=index.dollar_base,
    )


def load_npz(path) -> KStepFMIndex:
    z = np.load(path)
    cfg = IndexConfig(
        k=int(z["k"]), d=int(z["d"]), layout=Layout(bytes(z["layout"]).decode())
    )
    return KStepFMIndex(
        config=cfg,
        bwtsize=int(z["bwtsize"]),
        occ=z["occ"],
        bitmaps=z["bitmaps"],
        dollar_pos=z["dollar_pos"],
        dollar_base=z["dollar_base"],
    )


def _reconstruct_full_occ(index: KStepFMIndex, occ_slim: np.ndarray) -> None:
    """Fill index.occ (in place) from the slim alternate-counters rows so a
    tag-200/201 image loads back into a COMPLETE logical index.

    Stored halves copy straight across (even entries hold counters [0, S),
    odd entries [S, 2S)). The complementary half of entry e equals the NEXT
    row's stored values minus this block's dollar-exclusive k-mer counts
    (occ[e+1, c] = occ[e, c] + count_excl(e, c)); the counts come from a
    bitmap popcount per k-mer, with '$'s and last-block padding (which read
    as 'A' k-mers) subtracted. The sentinel row's complementary half comes
    from the safety row (minus its deliberate +d on k-mer 0, see
    tpufm.index.layouts.AltCountersIndex).
    """
    from tpufm.bitops import match_words, popcount_rows

    cfg = index.config
    S = cfg.num_slim_counters
    E = index.nentries
    occ = index.occ
    even = np.arange(E) % 2 == 0

    # Stored halves.
    occ[:E][even, :S] = occ_slim[:E][even]
    occ[:E][~even, S:] = occ_slim[:E][~even]
    half_E = S if E % 2 else 0
    occ[E, half_E : half_E + S] = occ_slim[E]

    # Dollar-exclusive per-block counts for every k-mer (bitmap popcount,
    # minus '$'s, minus the padding-'A's of the final block).
    bm = index.bitmaps[:E]
    counts = np.empty((E, cfg.num_counters), dtype=np.int64)
    for c in range(cfg.num_counters):
        counts[:, c] = popcount_rows(match_words(bm, np.uint32(c), cfg.k))
    dblock = np.asarray(index.dollar_block, np.int64)
    for i in range(cfg.k):
        counts[dblock[i], int(index.dollar_base[i])] -= 1
    pad = E * cfg.d - index.bwtsize
    if pad:
        counts[E - 1, 0] -= pad

    # Complementary halves: next row's stored values minus this block's
    # counts over those columns.
    nxt = occ_slim[1 : E + 1].astype(np.int64)
    comp_lo = ~even  # odd entries store the high half -> low is complementary
    occ[:E][even, S:] = (nxt[even] - counts[even][:, S:]).astype(np.uint32)
    occ[:E][comp_lo, :S] = (nxt[comp_lo] - counts[comp_lo][:, :S]).astype(np.uint32)

    # Sentinel complementary half: last real entry plus its block's counts
    # (occ[E] = occ[E-1] + count_excl(E-1) — valid for every column, and the
    # in-file safety row is only populated in the bwtsize % d == 0 case).
    half2 = S - half_E
    occ[E, half2 : half2 + S] = (
        occ[E - 1, half2 : half2 + S].astype(np.int64)
        + counts[E - 1, half2 : half2 + S]
    ).astype(np.uint32)
