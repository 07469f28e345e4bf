"""Index layout transforms.

The reference ships two post-build transforms as separate binaries; here they
are first-class packings of the same logical arrays:

* bitmap interleave (reference src/transformIndexBitmaps.c:269-295, tag 101):
  regroups bitmap words from per-(step, plane) order to per-window order so
  one aligned 16-byte vector holds all 2k planes of a 32-base window. For the
  SoA arrays this is a pure transpose (see interleave_bitmap_words); engines
  consume the logical [k, 2, nb] axes either way, so the transform only
  matters for byte-exact .fmi file export.

* alternate counters (reference src/transformIndexAlternateCounters.c:
  434-479, tags 200/201): halves counter storage. Entry e stores counters
  [0, 4^k/2) when e is even and [4^k/2, 4^k) when e is odd; one entry is
  appended holding the end-of-text counts so odd lookups can read the *next*
  entry and count backwards (complemented mask, subtracted popcount).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpufm.index.builder import KStepFMIndex, count_kmer_in_block


@dataclasses.dataclass
class AltCountersIndex:
    """Alternate-counters view over a logical index.

    occ_slim: uint32 [nentries + 2, 4^k / 2]
      rows 0..nentries-1: the stored counter half of each real entry;
      row nentries:       the appended end-of-text entry (reference
                          transformIndexCPU corner case, :467-478);
      row nentries + 1:   tpufm safety row — reached only when
                          bwtsize % d == 0 and the initial R = bwtsize lookup
                          needs the complementary half (the reference reads
                          out of bounds there); holds the mathematically
                          correct end-of-text counts so tpufm stays exact.
    Bitmaps and '$' metadata are shared with the base index.
    """

    base: KStepFMIndex
    occ_slim: np.ndarray

    @property
    def config(self):
        return self.base.config

    @property
    def bwtsize(self) -> int:
        return self.base.bwtsize


def interleave_bitmap_words(bitmaps: np.ndarray) -> np.ndarray:
    """[..., k, 2, nb] -> [..., nb, k, 2] word order (tag 101/201 packing).

    Flattening the result reproduces the reference's interleaved word order
    new[(2k)*w + 2s + p] = old[(2*nb)*s + nb*p + w]
    (src/transformIndexBitmaps.c:277-279).
    """
    return np.moveaxis(bitmaps, -1, -3)


def deinterleave_bitmap_words(bitmaps_il: np.ndarray) -> np.ndarray:
    """Inverse of interleave_bitmap_words: [..., nb, k, 2] -> [..., k, 2, nb]."""
    return np.moveaxis(bitmaps_il, -3, -1)


def make_alt_counters(
    index: KStepFMIndex, reference_semantics: bool = False
) -> AltCountersIndex:
    """Derive the alternate-counters table.

    reference_semantics=False (default, used by tpufm engines): the appended
    end-of-text entry is dollar-exclusive — occ sentinel + padding-'A' counts
    — which makes AC search bit-identical to baseline search everywhere.

    reference_semantics=True (used for byte-exact .fmi export): replicate the
    reference transform arithmetic exactly (src/transformIndexAlternateCounters.c:
    467-478): appended = previous entry + countEntry() bitmap recount of the
    final block. Because countEntry counts a '$' in the last block as its
    'A'-encoded k-mer while the searcher's backward dollar correction only
    compensates for interval <= dollarPos, the *reference AC searcher
    diverges from the reference baseline searcher by +1* for intervals past
    the '$' when the '$' lies in the last block and the k-mer equals
    dollar_base. tpufm treats baseline as the oracle (BASELINE.md) and does
    not replicate that bug in its engines.
    """
    cfg = index.config
    C, S, d = cfg.num_counters, cfg.num_slim_counters, cfg.d
    n_old = index.nentries
    bwtsize = index.bwtsize

    occ_slim = np.zeros((n_old + 2, S), dtype=np.uint32)

    # Rows 0..n_old-1: per-entry counter half by parity (reference :460-465).
    parity = (np.arange(n_old) % 2).astype(bool)
    occ_slim[:n_old] = np.where(
        parity[:, None], index.occ[:n_old, S : 2 * S], index.occ[:n_old, :S]
    )

    m = bwtsize % d
    half = S if n_old % 2 else 0
    if reference_semantics:
        # Appended row n_old (reference :467-478): previous entry's counters
        # plus a bitmap-inclusive recount of the final block, padding
        # positions (which read as 'A' k-mers) folded into counter 0.
        last_cnt = np.zeros(C, dtype=np.uint32)
        last_cnt[0] = d - m  # reference :470 (mod() of a positive value)
        for c in range(C):
            last_cnt[c] += count_kmer_in_block(index, bwtsize // d, c, m)
        occ_slim[n_old] = (
            index.occ[n_old - 1, half : half + S] + last_cnt[half : half + S]
        )
    else:
        # Exact appended row: true end-of-text counters (the occ sentinel,
        # dollar-exclusive) plus the padding-'A' count for k-mer 0 so the
        # backward (complemented-mask) popcount cancels exactly.
        appended = index.occ[n_old, half : half + S].astype(np.uint32).copy()
        if m and half == 0:
            appended[0] += np.uint32(d - m)
        occ_slim[n_old] = appended

    # Safety row n_old + 1: only reachable when bwtsize % d == 0 (initial
    # R = bwtsize with the complementary counter half). The backward count
    # there runs over the all-ones complement of an all-zero bitmap row, so
    # the correct value is the true end-of-text counters (sentinel occ row)
    # plus d for k-mer 0 to cancel the phantom 'A' matches.
    half2 = S if (n_old + 1) % 2 else 0
    safety = index.occ[n_old, half2 : half2 + S].astype(np.uint32).copy()
    if half2 == 0:
        safety[0] += np.uint32(d)
    occ_slim[n_old + 1] = safety

    return AltCountersIndex(base=index, occ_slim=occ_slim)
