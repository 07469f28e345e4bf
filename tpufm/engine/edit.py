"""Edit-distance (indel-aware) approximate matching: pigeonhole seeds +
a batched multi-word Myers bit-vector verifier.

The Hamming path (engine/seed.py) verifies candidates with one XOR+popcount
per window — exact, but substitutions only. Real reads carry indels, and
the CPU/GPU answer (banded DP with early exit, or backtracking FM search)
is branchy and data-dependent — the opposite of what wide batched lanes
want. The batched formulation keeps the three dense passes of the seed engine and swaps
the verifier for Myers's 1999 bit-parallel algorithm, whose inner loop is
~15 word-ops of AND/OR/XOR/ADD/SHIFT per text character — branch-free,
identical across lanes, and batched over every candidate at once:

  1. SEED — an occurrence with <= E edits contains at least one of E+1
     disjoint read chunks EXACTLY (pigeonhole holds under indels: each edit
     touches at most one chunk). Seeds ride the ordinary k-step scan.
  2. LOCATE — seed hits walk the sampled SA; candidate anchor
     a = seed position - seed offset is exact only up to the net indel
     shift before the chunk, so the true occurrence start lies in
     [a-E, a+E].
  3. VERIFY — per candidate, a start-anchored free-end edit distance for
     EVERY start in [a-E, a+E] in one pass: scanning the L+3E-char window
     REVERSED with the REVERSED read, the semi-global Myers score after
     step t is min_e edit(read, text[s:e]) for s = window_end - t (free
     start in the reversed stream == free end in the original). The scan
     keeps the running (best distance, leftmost start at that distance);
     bit-vectors are W = ceil(L/32) uint32 words with explicit ripple
     carries, so any read length works.

Output contract: up to max_hits DISTINCT alignment start sites per read —
each the leftmost minimal-distance start of its candidate window, verified
<= E edits — plus the per-read site count and the seed_hits overflow flag
(same lower-bound contract as engine/seed.py). Under edits an exact
"number of occurrences" is ill-defined (overlapping alignments shift into
each other), so the contract is the production-aligner one: a sound,
deduplicated site list whose completeness is bounded only by the seed cap.

(The reference suite has no approximate matching at all; this file extends
tpufm's own engine/seed.py. Bit-twiddling follows G. Myers, JACM 46(3),
1999, and H. Hyyro's multi-word formulation — public algorithms,
re-derived here for batched JAX.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpufm.engine.seed import (
    compact_hits,
    pack_hits3,
    pack_text_words,
    seed_positions,
    unpack_hits3,
)
from tpufm.engine.xla import make_locate_fn

_U32 = jnp.uint32
_SENTINEL = 0xFFFFFFFF


def build_peq(queries, W: int):
    """uint8 [..., L] reads -> Myers match masks uint32 [..., 4, W]:
    bit i of word i//32 of plane c is set iff read[i] == c (LSB = read[0]).
    Pad bits past L stay 0 (required: score is read at bit L-1)."""
    L = queries.shape[-1]
    pad = [(0, 0)] * (queries.ndim - 1) + [(0, W * 32 - L)]
    q = jnp.pad(queries, pad, constant_values=255)
    q = q.reshape(queries.shape[:-1] + (W, 32))
    sh = jnp.arange(32, dtype=_U32)
    planes = [
        jnp.sum(
            jnp.where(q == c, _U32(1) << sh, _U32(0)), axis=-1, dtype=_U32
        )
        for c in range(4)
    ]
    return jnp.stack(planes, axis=-2)  # [..., 4, W]


def _addc(a, b):
    """Multi-word add: lists of W uint32 arrays, LSW first, ripple carry."""
    out, carry = [], None
    for aw, bw in zip(a, b):
        s = aw + bw
        c1 = (s < aw).astype(_U32)
        if carry is not None:
            s2 = s + carry
            c1 = c1 | (s2 < s).astype(_U32)
            s = s2
        out.append(s)
        carry = c1
    return out


def _shl1(x):
    """Multi-word shift-left-by-1 (carry across words, 0 shifted in)."""
    out = [x[0] << _U32(1)]
    for w in range(1, len(x)):
        out.append((x[w] << _U32(1)) | (x[w - 1] >> _U32(31)))
    return out


def make_myers_verify_fn(L: int, edits: int, chars: str = "inline"):
    """Build the jittable batched verifier.

    (text_words uint32 [nw], n_text, peq uint32 [..., 1|C, 4, W] — built
     from the REVERSED read (the scan consumes the window back-to-front,
     so the pattern must be reversed too; build_peq(read[..., ::-1], W)) —
     broadcast over the candidate axis, lo/hi uint32 [..., C]
     allowed start range (lo doubles as the window start, clamped >= 0),
     valid bool [..., C])
      -> (dist int32 [..., C]  — min start-anchored edit distance over
          [lo, hi], L+1 where none found,
          start uint32 [..., C] — leftmost start achieving it).

    One lax.scan of TL = L + 3*edits steps. chars picks where the window
    characters are unpacked from the gathered words:
      "inline" (default) — in-register inside each step (WG one-hot
        selects per step, zero extra memory);
      "pre" — one vectorized unpack before the scan into a uint8
        [TL, ...] xs array the scan slices (shorter step critical path,
        TL bytes/candidate of extra HBM traffic). Bit-identical; which is
        faster on the GPU is not measured."""
    E = edits
    TL = L + 3 * E
    W = -(-L // 32)
    WG = TL // 16 + 2  # words covering any 16-alignment of the window
    msw, msb = (L - 1) // 32, _U32((L - 1) % 32)
    if chars not in ("inline", "pre"):
        raise ValueError(f"chars must be 'inline' or 'pre', got {chars!r}")

    def fn(text_words, n_text, peq, lo, hi, valid):
        ws = lo
        nw = text_words.shape[0]
        base = (ws // _U32(16)).astype(jnp.int32)
        widx = jnp.minimum(
            base[..., None] + jnp.arange(WG, dtype=jnp.int32), nw - 1
        )
        words = text_words[widx]  # [..., C, WG]
        woff = ws % _U32(16)

        shape = ws.shape
        zeros = jnp.zeros(shape, _U32)

        cpre = None
        if chars == "pre":
            jj = jnp.arange(TL, dtype=_U32)          # offset within window
            rel = woff[..., None] + jj               # [..., TL]
            wsel = (rel // _U32(16)).astype(jnp.int32)
            sh = _U32(2) * (_U32(15) - rel % _U32(16))
            w32 = jnp.zeros(shape + (TL,), _U32)
            for w in range(WG):
                w32 = jnp.where(wsel == w, words[..., w, None], w32)
            c = (w32 >> sh) & _U32(3)
            inb = (ws[..., None] + jj) < n_text
            c = jnp.where(inb, c, _U32(4)).astype(jnp.uint8)
            # scan consumes steps t = 0.. with j = TL-1-t: reverse so
            # xs[t] is the char for that step
            cpre = jnp.moveaxis(c[..., ::-1], -1, 0)  # [TL, ...]

        vp0 = []
        for w in range(W):
            bits = min(32, L - 32 * w)
            vp0.append(
                jnp.full(shape, (1 << bits) - 1 if bits < 32 else 0xFFFFFFFF,
                         _U32)
            )
        init = (
            vp0,
            [zeros] * W,
            jnp.full(shape, L, jnp.int32),          # score
            jnp.full(shape, L + 1, jnp.int32),      # best dist
            jnp.full(shape, _SENTINEL, _U32),       # best start
        )

        def step(carry, xt):
            vp, vn, score, best, bstart = carry
            if chars == "pre":
                t, cu8 = xt
                c = cu8.astype(_U32)                 # 4 = out of bounds
                inb = True
            else:
                t = xt
                j0 = _U32(TL - 1) - t                # window char this step
                rel = woff + j0
                wsel = (rel // _U32(16)).astype(jnp.int32)
                sh = _U32(2) * (_U32(15) - rel % _U32(16))
                w32 = zeros
                for w in range(WG):
                    w32 = jnp.where(wsel == w, words[..., w], w32)
                c = (w32 >> sh) & _U32(3)
                inb = (ws + j0) < n_text
            j = _U32(TL - 1) - t
            s = ws + j                               # candidate start
            eq = []
            for w in range(W):
                e = zeros
                for cc in range(4):
                    e = e | jnp.where((c == cc) & inb, peq[..., cc, w], zeros)
                eq.append(e)
            x = [eq[w] | vn[w] for w in range(W)]
            xvp = [x[w] & vp[w] for w in range(W)]
            add = _addc(vp, xvp)
            d0 = [(add[w] ^ vp[w]) | x[w] for w in range(W)]
            hn = [vp[w] & d0[w] for w in range(W)]
            hp = [vn[w] | ~(vp[w] | d0[w]) for w in range(W)]
            score = (
                score
                + ((hp[msw] >> msb) & _U32(1)).astype(jnp.int32)
                - ((hn[msw] >> msb) & _U32(1)).astype(jnp.int32)
            )
            xs = _shl1(hp)
            vn = [xs[w] & d0[w] for w in range(W)]
            hns = _shl1(hn)
            vp = [hns[w] | ~(xs[w] | d0[w]) for w in range(W)]
            upd = valid & (s >= lo) & (s <= hi) & (score <= best)
            best = jnp.where(upd, score, best)
            bstart = jnp.where(upd, s, bstart)
            return (vp, vn, score, best, bstart), None

        ts = jnp.arange(TL, dtype=_U32)
        xs = (ts, cpre) if chars == "pre" else ts
        (_, _, _, best, bstart), _ = jax.lax.scan(step, init, xs)
        return best, bstart

    return fn


def make_edit_extend_fn(
    k: int,
    d: int,
    lut_m: int,
    loc_d: int,
    sample_rate: int,
    edits: int,
    seed_hits: int,
    max_hits: int,
    chars: str = "inline",
    walk_budget: int | None = None,
    verify_budget: int | None = None,
):
    """Build the jittable seed/locate/Myers-verify pass:

    (search_tables, locate_tables, text_words, bwtsize, queries uint8 [B, L])
      -> (starts uint32 [B, max_hits] — ascending distinct verified
          alignment start sites, 0xFFFFFFFF padded,
          counts uint32 [B]          — distinct sites found,
          overflow bool [B])         — a seed interval exceeded seed_hits;
                                       the site list is a lower bound.

    Like the sampled-SA walk, the Myers scan is lane-count bound: the
    full [B, (E+1)*seed_hits] candidate grid pays (L+3E) x ~30W word-ops
    per lane whether or not the lane is a real candidate, and on
    unique-seed reads ~97% are padding. Valid candidates are therefore
    compacted into a `verify_budget`-lane array (with their per-read peq
    rows gathered alongside), verified, and scattered back; a lax.cond
    falls back to the bit-exact full-grid scan when a wave's candidates
    exceed the budget. Defaults to 1/8 of the grid (min 4096); 0
    disables. Running under shard_map (the mesh engines) keeps it
    shard-local."""
    E = edits
    S = E + 1
    if chars not in ("inline", "pre"):
        raise ValueError(f"chars must be 'inline' or 'pre', got {chars!r}")
    locate = make_locate_fn(loc_d, sample_rate)
    mh = max_hits

    def fn(tables, loc_tables, text_words, bwtsize, queries):
        B, L = queries.shape
        pos, seedok, overflow, offs = seed_positions(
            tables, loc_tables, bwtsize, queries,
            k=k, d=d, lut_m=lut_m, S=S, seed_hits=seed_hits, locate=locate,
            what=f"{E} edits", walk_budget=walk_budget,
        )
        verify = make_myers_verify_fn(L, E, chars)

        # anchor a = seed position - seed offset; the true start lies in
        # [a-E, a+E]. All in uint32 via b = a + E (>= 0 whenever valid):
        # int32 would silently wrap past 2^31 bases and drop every
        # candidate in the upper half of a 3 Gbase genome.
        n_text = bwtsize - _U32(1)                 # text length n
        offv = jnp.asarray(offs, dtype=_U32)[None, :, None]
        b = pos + _U32(E) - offv                   # = a + E
        valid = (
            seedok
            & (pos + _U32(E) >= offv)              # a >= -E (no wrap below)
            & (b <= (n_text - _U32(1)) + _U32(2 * E))  # a - E <= n - 1
        )
        lo = jnp.maximum(b, _U32(2 * E)) - _U32(2 * E)   # max(a - E, 0)
        hi = jnp.minimum(b, n_text - _U32(1))            # min(a + E, n - 1)
        C = S * seed_hits
        lo = jnp.where(valid, lo, _U32(0)).reshape(B, C)
        hi = jnp.where(valid, hi, _U32(0)).reshape(B, C)
        valid = valid.reshape(B, C)

        # reversed read: the verifier scans each window back-to-front
        W = -(-L // 32)
        peq_rd = build_peq(queries[:, ::-1], W)  # [B, 4, W]

        N = B * C
        R = verify_budget if verify_budget is not None else max(4096, N // 8)
        if R <= 0 or R >= N:
            dist, start = verify(
                text_words, n_text, peq_rd[:, None, :, :], lo, hi, valid
            )
        else:
            from tpufm.engine.xla import compact_slots, scatter_back

            vflat = valid.reshape(-1)
            lof, hif = lo.reshape(-1), hi.reshape(-1)
            slot, total, tgt = compact_slots(vflat, R)

            def compact_verify(_):
                clo = jnp.zeros(R + 1, _U32).at[tgt].set(lof)
                chi = jnp.zeros(R + 1, _U32).at[tgt].set(hif)
                ridx = jax.lax.broadcasted_iota(
                    jnp.int32, (B, C), 0
                ).reshape(-1)
                crd = jnp.zeros(R + 1, jnp.int32).at[tgt].set(ridx)
                cpeq = peq_rd[crd[:R]]  # [R, 4, W]
                d, s = verify(
                    text_words, n_text, cpeq, clo[:R], chi[:R],
                    jnp.ones(R, bool),
                )
                return (
                    scatter_back(
                        vflat, slot, R, d, jnp.int32(L + 1)
                    ).reshape(B, C),
                    scatter_back(
                        vflat, slot, R, s, _U32(_SENTINEL)
                    ).reshape(B, C),
                )

            def full_verify(_):
                return verify(
                    text_words, n_text, peq_rd[:, None, :, :], lo, hi, valid
                )

            dist, start = jax.lax.cond(
                total <= R, compact_verify, full_verify, None
            )
        accept = valid & (dist <= E)
        cand = jnp.where(accept, start, _U32(_SENTINEL))

        # distinct sites: sort + neighbor-dedup, compact first max_hits
        cand = jnp.sort(cand, axis=1)
        uniq = (cand != _U32(_SENTINEL)) & jnp.concatenate(
            [jnp.ones((B, 1), dtype=bool), cand[:, 1:] != cand[:, :-1]],
            axis=1,
        )
        out, counts = compact_hits(cand, uniq, mh)
        return out, counts, overflow

    return fn


def edit_extend_oracle(codes, queries, edits: int):
    """Ground truth (test-scale): for each read, dist[s] = the
    start-anchored free-end edit distance min_e edit(read, codes[s:e]) at
    every text start s, via the reversed semi-global DP (column-vectorized
    numpy). Returns a [B, n] int array."""
    codes = np.asarray(codes, dtype=np.uint8)
    queries = np.asarray(queries, dtype=np.uint8)
    B, L = queries.shape
    n = codes.shape[0]
    R = queries[:, ::-1]
    T = codes[::-1]
    ar = np.arange(L + 1)
    col = np.broadcast_to(ar, (B, L + 1)).copy()
    dist = np.full((B, n), L, dtype=np.int64)
    for j in range(1, n + 1):
        sub = (R != T[j - 1]).astype(np.int64)
        t = np.minimum(col[:, :-1] + sub, col[:, 1:] + 1)
        c = np.concatenate([np.zeros((B, 1), np.int64), t], axis=1)
        col = np.minimum.accumulate(c - ar, axis=1) + ar
        dist[:, n - j] = col[:, L]
    return dist


class EditExtendEngine:
    """Device-resident edit-distance (indel-aware) matching at distance
    E >= 1. Same table set as SeedExtendEngine (search index + sampled-SA
    locate tables + 2-bit packed text); the verifier is the batched
    multi-word Myers scan."""

    #: reads per wave — each read carries (E+1) search lanes and
    #: (E+1)*seed_hits Myers scan lanes of W words each
    WAVE = 1 << 13

    def __init__(
        self,
        index,
        loc,
        text,
        edits: int,
        seed_hits: int = 32,
        max_hits: int = 4,
        lut_m: int = 0,
        device=None,
        chars: str = "inline",
        walk_budget: int | None = None,
        verify_budget: int | None = None,
    ):
        from tpufm.engine.xla import XLAEngine, build_locate_tables

        if edits < 1:
            raise ValueError("EditExtendEngine is for edits >= 1")
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
        self.edits = edits
        self.seed_hits = seed_hits
        self.max_hits = max_hits
        self._fn = jax.jit(
            make_edit_extend_fn(
                self.config.k, self.config.d, lut_m, loc_d, sr,
                edits, seed_hits, max_hits, chars, walk_budget,
                verify_budget,
            )
        )

    def locate_edits(self, queries, wave: int | None = None):
        """reads uint8 [B, L] -> (starts uint32 [B, max_hits] ascending
        distinct verified alignment start sites, 0xFFFFFFFF padded;
        counts uint32 [B]; overflow bool [B])."""
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
