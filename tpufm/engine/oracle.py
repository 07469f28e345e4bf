"""NumPy oracle engine — the bit-exactness reference for every device engine.

Vectorized (over the query batch) port of the semantics of the reference's
CPU baseline searcher (reference src/fmIndexCPUBaseline.c:157-292) and of the
alternate-counters searcher (reference src/fmIndexCPUBaseline-AltCounters.c:
145-310). Every device engine in tpufm must produce identical SA intervals.

Backward search: per k-base step, both interval ends (L, R) perform one
rank/Occ lookup — entry.cnt[kmer] + popcount of kmer matches in the entry's
bitmap prefix, minus the per-level '$' corrections — and the new interval is
(LF(L), LF(R)). A pattern occurs R - L times.
"""

from __future__ import annotations

import numpy as np

from tpufm.bitops import boundary_masks, match_words
from tpufm.index.builder import KStepFMIndex
from tpufm.index.layouts import AltCountersIndex

_U32 = np.uint32


def lf_step_oracle(
    index: KStepFMIndex, interval: np.ndarray, code: np.ndarray
) -> np.ndarray:
    """One k-step LF mapping for a batch of interval ends.

    interval: uint32 [...]; code: uint32 [...] (fused k-mer).
    Returns the new interval ends, bit-exact vs the reference hot loop
    (src/fmIndexCPUBaseline.c:200-287).
    """
    cfg = index.config
    d, k, nb = cfg.d, cfg.k, cfg.words_per_plane

    interval = np.asarray(interval, dtype=_U32)
    code = np.asarray(code, dtype=_U32)
    block = (interval // _U32(d)).astype(np.int64)

    cnt = index.occ[block, code.astype(np.int64)]

    masks = boundary_masks(interval % _U32(d), nb)
    matched = match_words(index.bitmaps[block], code, k) & masks
    count = np.bitwise_count(matched).astype(np.int64).sum(axis=-1)

    # '$' corrections (src/fmIndexCPUBaseline.c:252-256): the bitmaps encode
    # '$' as 'A', so if this block holds level i's '$', the k-mer equals its
    # dollar_base, and the interval lies past the '$', one phantom match was
    # counted.
    dollar_block = index.dollar_block
    for i in range(k):
        hit = (
            (block == int(dollar_block[i]))
            & (code == index.dollar_base[i])
            & (interval > index.dollar_pos[i])
        )
        count -= hit

    return (cnt + count.astype(_U32)).astype(_U32)


def lf_step_oracle_ac(
    index: AltCountersIndex, interval: np.ndarray, code: np.ndarray
) -> np.ndarray:
    """One k-step LF mapping against the alternate-counters layout.

    Faithful to reference src/fmIndexCPUBaseline-AltCounters.c:190-303:
    each entry stores only half of the 4^k counters (even entries the low
    half, odd entries the high half). When the needed counter lives in the
    *next* entry (idxEntry = 1), the boundary mask is complemented, the
    popcount runs over the block suffix, the '$' correction condition is
    inverted, and the new interval is counter MINUS popcount.
    """
    base = index.base
    cfg = base.config
    d, k, nb, S = cfg.d, cfg.k, cfg.words_per_plane, cfg.num_slim_counters

    interval = np.asarray(interval, dtype=_U32)
    code = np.asarray(code, dtype=_U32)
    block = (interval // _U32(d)).astype(np.int64)

    # idxEntry: the counter half stored in this entry alternates with parity
    # (reference :218-225).
    odd = (block % 2).astype(bool)
    high = code >= _U32(S)
    idx_entry = np.where(odd ^ high, 1, 0).astype(np.int64)

    cnt = index.occ_slim[block + idx_entry, (code & _U32(S - 1)).astype(np.int64)]

    masks = boundary_masks(interval % _U32(d), nb)
    masks = np.where(idx_entry[..., None] == 1, ~masks, masks)
    matched = match_words(base.bitmaps[block], code, k) & masks
    count = np.bitwise_count(matched).astype(np.int64).sum(axis=-1)

    # Inverted '$' corrections (reference :254-263).
    dollar_block = base.dollar_block
    for i in range(k):
        at_block = (block == int(dollar_block[i])) & (code == base.dollar_base[i])
        fwd = at_block & (idx_entry == 0) & (interval > base.dollar_pos[i])
        bwd = at_block & (idx_entry == 1) & (interval <= base.dollar_pos[i])
        count -= fwd | bwd

    count = count.astype(_U32)
    return np.where(idx_entry == 1, cnt - count, cnt + count).astype(_U32)


def fuse_query_kmers(queries: np.ndarray, k: int) -> np.ndarray:
    """Precompute per-round fused k-mer codes for a query batch.

    queries: uint8 [B, L] 2-bit codes, L % k == 0.
    Returns uint32 [rounds, B]; round r covers query positions
    [L - (r+1)*k, L - r*k), level i = position (L - 1 - r*k - i), matching the
    reference's right-to-left fuse (src/fmIndexCPUBaseline.c:200-225).
    """
    B, L = queries.shape
    if L % k != 0:
        raise ValueError(f"query length {L} not divisible by k={k}")
    rounds = L // k
    # rounds-major view: chunk r covers base positions, level i is offset k-1-i
    chunks = queries.reshape(B, rounds, k)[:, ::-1, :]  # [B, rounds, k], r-th round
    codes = np.zeros((rounds, B), dtype=_U32)
    for i in range(k):
        codes |= chunks[:, :, k - 1 - i].T.astype(_U32) << _U32(2 * i)
    return codes


def search_oracle(index, queries: np.ndarray, tail_index=None) -> np.ndarray:
    """Full backward search of a query batch. Returns uint32 [B, 2] (L, R).

    index: KStepFMIndex or AltCountersIndex.
    queries: uint8 [B, L] 2-bit codes.
    tail_index: optional k=1 KStepFMIndex over the same text — accepts any
    query length by finishing the L mod k leftover leading characters with
    single-step rounds (ground truth for the engines' tail extension).
    """
    if isinstance(index, AltCountersIndex):
        base, step = index.base, lf_step_oracle_ac
    else:
        base, step = index, lf_step_oracle

    k = base.config.k
    queries = np.asarray(queries, dtype=np.uint8)
    rem = queries.shape[1] % k
    if rem and tail_index is None:
        raise ValueError(
            f"query length {queries.shape[1]} not divisible by k={k}; "
            "pass tail_index (k=1) to search any length"
        )
    head, body = queries[:, :rem], queries[:, rem:]
    codes = fuse_query_kmers(body, k)
    B = queries.shape[0]

    lo = np.zeros(B, dtype=_U32)
    hi = np.full(B, base.bwtsize, dtype=_U32)
    for r in range(codes.shape[0]):
        lo = step(index, lo, codes[r])
        hi = step(index, hi, codes[r])
    if rem:
        tcodes = fuse_query_kmers(head, 1)  # [rem, B], right-to-left
        for r in range(rem):
            lo = lf_step_oracle(tail_index, lo, tcodes[r])
            hi = lf_step_oracle(tail_index, hi, tcodes[r])
    return np.stack([lo, hi], axis=1)
