"""Pigeonhole seed-and-extend: approximate matching at Hamming distance m >= 2.

The <=1-mismatch path (engine/xla.py make_count_mismatch_fn) expands every
read into its 3L+1 single-substitution variants and lets them ride the
batched scan. At m substitutions that expansion is C(L,m)*3^m lanes per read
(m=2, L=120: ~64K) — hopeless. CPU/GPU FM-index aligners switch to branchy
backtracking with pruning; batched over wide lanes that is divergence with
data-dependent shapes. The batched formulation is the classic pigeonhole filter recast as three
dense batched passes inside ONE jit:

  1. SEED — any occurrence with <= m substitutions contains at least one of
     m+1 disjoint read chunks EXACTLY (pigeonhole). Each read contributes
     m+1 fixed-offset seeds of length Ls = floor(L/(m+1)) rounded down to a
     multiple of k; the seeds ride the ordinary k-step scan
     (engine/xla.py make_search_fn — the reference's hot loop,
     src/fmIndexCPUBaseline.c:200-257) as m+1 extra batch lanes per read.
  2. LOCATE — each seed interval expands to its first `seed_hits` BWT rows,
     which walk the sampled-SA locate (make_locate_fn) to text positions;
     candidate occurrence start = seed position - seed offset. Candidates
     are sorted per read and neighbor-deduplicated in-register (two seeds
     of the same occurrence yield the same start).
  3. VERIFY — every candidate gathers its L-base window from the 2-bit
     packed text and compares against the read with XOR + popcount:
     mismatched base <=> either bit of its 2-bit code differs, so
     dist = popcount((x | x>>1) & 0x5555...) over ceil(L/16) words — a
     branch-free Hamming distance, one gather + a handful of word ops per
     candidate.

Sensitivity is exact UNLESS a seed interval is wider than `seed_hits`
(repeat-region seeds can exceed any cap); such reads are flagged `overflow`
so callers know their hit list may be incomplete — the seed-frequency-cap
contract of production read aligners, but reported per read instead of
silently dropped. (The reference suite has no approximate matching at all.)

Constraint: text length n must satisfy n + L < 2^32 (all position math is
uint32, matching the index's own 32-bit row space).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpufm.engine.xla import make_locate_fn, make_search_fn

_U32 = jnp.uint32
_SENTINEL = 0xFFFFFFFF
_MISMASK = 0x55555555  # low bit of every 2-bit base field


def pack_text_words(codes: np.ndarray) -> np.ndarray:
    """2-bit codes uint8 [n] -> uint32 [ceil(n/16) + 1], 16 bases per word,
    base j at bits (31 - 2*(j%16)) .. (30 - 2*(j%16)) — MSB-first, the same
    orientation as the index bit-planes. One zero guard word at the end so
    an aligned window gather (W+1 words from any valid occurrence start)
    never reads out of bounds."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    nw = -(-n // 16) + 1
    padded = np.zeros(nw * 16, dtype=np.uint8)
    padded[:n] = codes
    sh = (2 * (15 - np.arange(16))).astype(np.uint32)
    return np.bitwise_or.reduce(
        padded.reshape(nw, 16).astype(np.uint32) << sh, axis=1
    )


def pack_query_words(queries):
    """uint8 [..., L] -> uint32 [..., ceil(L/16)] with the pack_text_words
    bit layout (device twin; trailing partial word zero-padded low)."""
    L = queries.shape[-1]
    W = -(-L // 16)
    pad = [(0, 0)] * (queries.ndim - 1) + [(0, W * 16 - L)]
    q = jnp.pad(queries, pad).astype(_U32)
    sh = (2 * (15 - jnp.arange(16, dtype=_U32)))
    return jnp.sum(
        q.reshape(queries.shape[:-1] + (W, 16)) << sh, axis=-1, dtype=_U32
    )


def _window_mask(L: int) -> np.ndarray:
    """Per-word keep-mask for an L-base window: full words, then the top
    2*(L%16) bits of the last."""
    W = -(-L // 16)
    mask = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    if L % 16:
        mask[-1] = np.uint32(0xFFFFFFFF) << np.uint32(32 - 2 * (L % 16))
    return mask


def hamming_to_text(text_words, pos, qwords, L: int):
    """Hamming distance between the L-base text window starting at `pos`
    and the packed query words.

    text_words: uint32 [nw] (pack_text_words). pos: uint32 [...] valid
    window starts (callers clamp masked lanes into range). qwords:
    uint32 [..., W] (pack_query_words). Returns int32 [...]."""
    W = qwords.shape[-1]
    wi = (pos // _U32(16)).astype(jnp.int32)
    sh = (2 * (pos % _U32(16))).astype(_U32)[..., None]
    idx = wi[..., None] + jnp.arange(W + 1, dtype=jnp.int32)
    tw = text_words[idx]  # [..., W+1]
    lo, hi = tw[..., :W], tw[..., 1:]
    # sh == 0 lanes take `lo` directly; the & 31 keeps the dead branch's
    # shift amount defined on every backend
    aligned = jnp.where(
        sh == 0, lo, (lo << sh) | (hi >> ((_U32(32) - sh) & _U32(31)))
    )
    x = aligned ^ qwords
    mism = (x | (x >> _U32(1))) & _U32(_MISMASK)
    mism = mism & jnp.asarray(_window_mask(L))
    return jnp.sum(
        jax.lax.population_count(mism).astype(jnp.int32), axis=-1
    )


def seed_positions(
    tables, loc_tables, bwtsize, queries, *,
    k: int, d: int, lut_m: int, S: int, seed_hits: int, locate, what: str,
    walk_budget: int | None = None,
):
    """Shared SEED + LOCATE front end (trace-time helper for the Hamming
    and edit engines): slice S disjoint fixed-offset seeds per read, run
    them through the ordinary k-step scan, expand each interval to its
    first seed_hits BWT rows, and walk those through the sampled SA.

    The walk is the cost center: every lane pays ~sample_rate/2 LF(1)
    gathers whether or not it is inside its seed's interval, and on real
    read sets most of the [B, S, seed_hits] lanes are padding (unique
    seeds have width ~1). So the valid lanes are COMPACTED into a
    `walk_budget`-lane array first (cumsum slot + scatter), walked, and
    scattered back — and when a wave's valid lanes exceed the budget, a
    lax.cond falls back to the bit-exact full-width walk (the same
    fast-path/fallback shape as the a2a sharded routing). Results are
    identical on either branch; only throughput differs. walk_budget
    defaults to 1/8 of the full lane count (min 4096).

    Returns (pos uint32 [B, S, seed_hits] seed text positions,
    seedok bool [B, S, seed_hits] lanes inside their interval,
    overflow bool [B] some interval exceeded seed_hits,
    offs list[int] seed offsets)."""
    B, L = queries.shape
    Ls = (L // S) // k * k
    if Ls < k:
        raise ValueError(
            f"read length {L} too short for {what} at k={k}: "
            f"needs {S} disjoint seeds of >= {k} bases"
        )
    # the seed scan reuses the prefix LUT when the seed is long enough
    # (Ls and lut_m are both k-multiples, so divisibility is automatic)
    slut = lut_m if (lut_m and Ls >= lut_m) else 0
    search = make_search_fn(k, d, False, layout="fused", lut_m=slut)

    offs = [i * Ls for i in range(S)]
    seeds = jnp.stack([queries[:, o : o + Ls] for o in offs], axis=1)
    iv = search(tables, bwtsize, seeds.reshape(B * S, Ls)).reshape(B, S, 2)

    lo = iv[..., 0]
    width = iv[..., 1] - lo
    overflow = jnp.any(width > _U32(seed_hits), axis=1)
    w = jnp.minimum(width, _U32(seed_hits))
    cols = jnp.arange(seed_hits, dtype=_U32)[None, None, :]
    seedok = cols < w[..., None]  # [B, S, seed_hits]
    rows = jnp.where(seedok, lo[..., None] + cols, _U32(0))

    from tpufm.engine.xla import locate_compacted

    pos = locate_compacted(locate, loc_tables, rows, seedok, walk_budget)
    return pos, seedok, overflow, offs


def compact_hits(cand, accept, max_hits: int):
    """Scatter the accepted candidates' first max_hits values (already in
    per-read ascending order) into a sentinel-padded [B, max_hits] array;
    also returns the full per-read accept counts."""
    B = cand.shape[0]
    counts = jnp.sum(accept, axis=1, dtype=_U32)
    slot = jnp.cumsum(accept.astype(jnp.int32), axis=1) - 1
    slot = jnp.where(accept & (slot < max_hits), slot, max_hits)
    out = jnp.full((B, max_hits + 1), _U32(_SENTINEL)).at[
        jnp.arange(B, dtype=jnp.int32)[:, None], slot
    ].set(jnp.where(accept, cand, _U32(_SENTINEL)))
    return out[:, :max_hits], counts


def pack_hits3(h):
    """Device (pos [B, mh], counts [B], overflow [B]) -> one host uint32
    [B, mh + 2] block (stream_waves collector for the seed/edit engines)."""
    return np.concatenate(
        [
            np.asarray(jax.device_get(h[0])),
            np.asarray(jax.device_get(h[1]))[:, None],
            np.asarray(jax.device_get(h[2]))[:, None].astype(np.uint32),
        ],
        axis=1,
    )


def unpack_hits3(out, max_hits: int):
    """Inverse of pack_hits3 on the concatenated host rows."""
    return (
        np.ascontiguousarray(out[:, :max_hits]),
        np.ascontiguousarray(out[:, max_hits]),
        out[:, max_hits + 1].astype(bool),
    )


def make_seed_extend_fn(
    k: int,
    d: int,
    lut_m: int,
    loc_d: int,
    sample_rate: int,
    mismatches: int,
    seed_hits: int,
    max_hits: int,
    walk_budget: int | None = None,
    verify_budget: int | None = None,
):
    """Build the jittable seed-and-extend pass:

    (search_tables, locate_tables, text_words, bwtsize, queries uint8 [B, L])
      -> (positions uint32 [B, max_hits]  — ascending, 0xFFFFFFFF padded,
          counts    uint32 [B]            — distinct positions at dist <= m,
          overflow  bool   [B])           — True: some seed interval was
                                            wider than seed_hits, so counts
                                            and positions are lower bounds.

    The read length L is static at trace time (from queries.shape), so one
    factory serves every length; seed geometry is derived per trace."""
    m = mismatches
    S = m + 1
    locate = make_locate_fn(loc_d, sample_rate)
    mh = max_hits

    def fn(tables, loc_tables, text_words, bwtsize, queries):
        B, L = queries.shape
        pos, seedok, overflow, offs = seed_positions(
            tables, loc_tables, bwtsize, queries,
            k=k, d=d, lut_m=lut_m, S=S, seed_hits=seed_hits, locate=locate,
            what=f"{m} mismatches", walk_budget=walk_budget,
        )

        # candidate start = seed text position - seed offset, if in range
        offv = jnp.asarray(offs, dtype=_U32)[None, :, None]
        n_text = bwtsize - _U32(1)
        ok = seedok & (pos >= offv) & (pos + (_U32(L) - offv) <= n_text)
        cand = jnp.where(ok, pos - offv, _U32(_SENTINEL))

        # sort + neighbor-dedup (sentinels collect at the high end)
        C = S * seed_hits
        cand = jnp.sort(cand.reshape(B, C), axis=1)
        uniq = (cand != _U32(_SENTINEL)) & jnp.concatenate(
            [
                jnp.ones((B, 1), dtype=bool),
                cand[:, 1:] != cand[:, :-1],
            ],
            axis=1,
        )

        # verify every unique candidate against the packed text; like the
        # walk, the [B, C] grid is mostly padding (each lane costs a
        # (W+1)-word window gather), so unique candidates are compacted
        # first, with the usual bit-exact cond fallback over the budget
        qwords = pack_query_words(queries)  # [B, W]
        N = B * C
        R = verify_budget if verify_budget is not None else max(4096, N // 8)
        if R <= 0 or R >= N:
            p = jnp.where(uniq, cand, _U32(0))
            dist = hamming_to_text(text_words, p, qwords[:, None, :], L)
        else:
            from tpufm.engine.xla import compact_slots, scatter_back

            uflat = uniq.reshape(-1)
            pflat = jnp.where(uflat, cand.reshape(-1), _U32(0))
            slot, total, tgt = compact_slots(uflat, R)

            def compact_verify(_):
                cp = jnp.zeros(R + 1, _U32).at[tgt].set(pflat)
                ridx = jax.lax.broadcasted_iota(
                    jnp.int32, (B, C), 0
                ).reshape(-1)
                crd = jnp.zeros(R + 1, jnp.int32).at[tgt].set(ridx)
                d = hamming_to_text(
                    text_words, cp[:R], qwords[crd[:R]], L
                )
                return scatter_back(
                    uflat, slot, R, d, jnp.int32(L + 1)
                ).reshape(B, C)

            def full_verify(_):
                p = jnp.where(uniq, cand, _U32(0))
                return hamming_to_text(text_words, p, qwords[:, None, :], L)

            dist = jax.lax.cond(total <= R, compact_verify, full_verify, None)
        accept = uniq & (dist <= m)
        out, counts = compact_hits(cand, accept, mh)
        return out, counts, overflow

    return fn


def seed_extend_oracle(codes, queries, mismatches: int):
    """Naive sliding-window ground truth: (counts int64 [B], positions —
    list of ascending int arrays, one per read). Test-scale only."""
    codes = np.asarray(codes, dtype=np.uint8)
    queries = np.asarray(queries, dtype=np.uint8)
    L = queries.shape[1]
    wins = np.lib.stride_tricks.sliding_window_view(codes, L)
    counts, positions = [], []
    for q in queries:
        dist = (wins != q[None, :]).sum(axis=1)
        hit = np.flatnonzero(dist <= mismatches)
        counts.append(hit.size)
        positions.append(hit.astype(np.uint32))
    return np.asarray(counts, dtype=np.int64), positions


class SeedExtendEngine:
    """Device-resident approximate matching at Hamming distance m >= 1.

    Wraps the single-jit seed/locate/verify pass (make_seed_extend_fn) with
    the flagship search tables, the sampled-SA locate tables, and the 2-bit
    packed text. `text` is the reference's 2-bit codes (or a prepacked
    pack_text_words array)."""

    #: reads per wave — each read carries (m+1) search lanes and
    #: (m+1)*seed_hits locate/verify lanes
    WAVE = 1 << 16

    def __init__(
        self,
        index,
        loc,
        text,
        mismatches: int,
        seed_hits: int = 32,
        max_hits: int = 4,
        lut_m: int = 0,
        device=None,
        walk_budget: int | None = None,
        verify_budget: int | None = None,
    ):
        from tpufm.engine.xla import XLAEngine, build_locate_tables

        if mismatches < 1:
            raise ValueError("SeedExtendEngine is for mismatches >= 1")
        put = functools.partial(jax.device_put, device=device)
        xla = XLAEngine(index, device=device, layout="fused", lut_m=lut_m)
        self.config = xla.config
        self.bwtsize = xla.bwtsize
        self.tables = xla.tables
        self.loc_tables, loc_d, sr = build_locate_tables(loc, put)
        text = np.asarray(text)
        if text.dtype != np.uint32:
            text = pack_text_words(text)
        self.text_words = put(text)
        self.mismatches = mismatches
        self.seed_hits = seed_hits
        self.max_hits = max_hits
        self._fn = jax.jit(
            make_seed_extend_fn(
                self.config.k, self.config.d, lut_m, loc_d, sr,
                mismatches, seed_hits, max_hits, walk_budget, verify_budget,
            )
        )

    def _run(self, queries, wave):
        from tpufm.utils.waves import stream_waves

        queries = np.asarray(queries, dtype=np.uint8)
        mh = self.max_hits
        if queries.shape[0] == 0:
            return (
                np.zeros((0, mh), np.uint32),
                np.zeros(0, np.uint32),
                np.zeros(0, bool),
            )
        out = stream_waves(
            queries,
            wave or self.WAVE,
            lambda q: self._fn(
                self.tables, self.loc_tables, self.text_words,
                _U32(self.bwtsize), jnp.asarray(q),
            ),
            pack_hits3,
            depth=2,
            pad_mode="cycle",
        )
        return unpack_hits3(out, mh)

    def locate_approx(self, queries, wave: int | None = None):
        """reads uint8 [B, L] -> (positions uint32 [B, max_hits] ascending,
        0xFFFFFFFF padded; counts uint32 [B]; overflow bool [B])."""
        return self._run(queries, wave)

    def count_approx(self, queries, wave: int | None = None):
        """reads uint8 [B, L] -> (counts uint32 [B], overflow bool [B]):
        distinct text positions within Hamming distance `mismatches` —
        exact where overflow is False, a lower bound where True."""
        _, counts, overflow = self._run(queries, wave)
        return counts, overflow
