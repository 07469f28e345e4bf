"""XLA gather-based search engine.

The whole query batch advances one fused k-step LF round at a time: per
round, both interval ends of every read do one gather from the Occ/bitmap
tables plus a vectorized mask/popcount — the batch dimension is the parallel
axis (the batched form of the reference's one-thread-per-interval GPU
mapping, src/fmIndexGPU-Task-1Step.cu:111-183). The per-read dependent chain
of length len/k lives in a lax.scan.

This engine is pure jnp (XLA gathers) and runs identically on the GPU and
the CPU. Bit-exact vs tpufm.engine.oracle, which is bit-exact vs the
reference CPU baseline.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from tpufm.index.builder import KStepFMIndex
from tpufm.index.layouts import AltCountersIndex

_U32 = jnp.uint32


def _boundary_masks(shift, nb: int):
    """uint32 [..., nb] prefix masks; window w keeps clip(shift-32w, 0, 32)
    top bits (see tpufm.engine.oracle.boundary_masks)."""
    cov = jnp.clip(
        shift.astype(jnp.int32)[..., None] - 32 * jnp.arange(nb, dtype=jnp.int32),
        0,
        32,
    )
    amount = jnp.where(cov > 0, 32 - jnp.minimum(cov, 32), 0).astype(_U32)
    full = _U32(0xFFFFFFFF)
    m = jnp.left_shift(full, amount)
    return jnp.where(cov > 0, m, _U32(0))


def _match_words(rows, code, k: int):
    """rows uint32 [..., k, 2, nb], code uint32 [...] -> uint32 [..., nb]."""
    code = code[..., None]
    out = jnp.full(rows.shape[:-3] + rows.shape[-1:], _U32(0xFFFFFFFF), dtype=_U32)
    for i in range(k):
        b0 = (code >> _U32(2 * i)) & _U32(1)
        b1 = (code >> _U32(2 * i + 1)) & _U32(1)
        p0 = rows[..., i, 0, :]
        p1 = rows[..., i, 1, :]
        out &= jnp.where(b0 != 0, p0, ~p0) & jnp.where(b1 != 0, p1, ~p1)
    return out


def _pick_counter(counters, code, k: int):
    """In-register counter select from a gathered fused row.

    counters uint32 [..., 4^k]; code uint32 broadcastable to
    counters.shape[:-1]. Binary-tree select: 2k levels of halving
    where()s driven by one code bit each — O(4^k) total lane-selects but
    every level is a full-width elementwise select with no iota compares
    or lane sums, and no second dependent gather (a take_along_axis pick
    lowers to one).
    """
    c = counters
    code = jnp.broadcast_to(code, counters.shape[:-1])
    bits = (4**k).bit_length() - 1
    for bit in reversed(range(bits)):
        half = c.shape[-1] // 2
        hi = ((code >> _U32(bit)) & _U32(1)) != 0
        c = jnp.where(hi[..., None], c[..., half:], c[..., :half])
    return c[..., 0]


def lf_step_fused(tables: dict, cfg: tuple, interval, code):
    """Fused-row k-step LF for both interval ends at once.

    Bitmaps and all 4^k counters live in ONE row per entry, so each
    interval end does exactly one gather per round (the split layout does
    two); the counter is then selected in-register from the gathered row.
    Both ends are stacked into a single gather of 2B indices.

    tables: {'entries': uint32 [E+1, 2k*nb + 4^k] (bitmap words then
             counters, the same word order as the reference tag-100 entry,
             src/genFMindex.c:42-45), 'dollar_pos'/'dollar_base'/
             'dollar_block': uint32 [k]}
    cfg: (k, d, nb) static; interval: uint32 [B, 2]; code: uint32 [B].
    """
    k, d, nb = cfg
    bmw = 2 * k * nb
    block = interval // _U32(d)
    rows = tables["entries"][block]  # [B, 2, W] — the only HBM gather
    bm_rows = rows[..., :bmw].reshape(rows.shape[:-1] + (k, 2, nb))
    # Slice exactly 4^k counters: rows may carry pad_words padding.
    cnt = _pick_counter(rows[..., bmw : bmw + 4**k], code[:, None], k)

    masks = _boundary_masks(interval % _U32(d), nb)
    matched = _match_words(bm_rows, code[:, None], k) & masks
    count = jnp.sum(jax.lax.population_count(matched), axis=-1)

    dpos, dbase, dblock = (
        tables["dollar_pos"],
        tables["dollar_base"],
        tables["dollar_block"],
    )
    hit = (
        (block[..., None] == dblock)
        & (code[:, None, None] == dbase)
        & (interval[..., None] > dpos)
    )
    count -= jnp.sum(hit.astype(_U32), axis=-1)
    return cnt + count


def lf_step_paired(tables: dict, cfg: tuple, interval, code):
    """Paired-row k-step LF: ONE gather per READ instead of one per END.

    Backward-search interval widths are monotone non-increasing, and with a
    prefix-LUT start they are typically << d from round 0 — so hi's block
    is lo's block or the next one. tables['entries_paired'][i] carries rows
    i and i+1 of the fused table side by side ([E+1, 2W]); the round
    gathers the pair at lo's block and selects hi's row in-register,
    halving gather issues.

    Lanes where hi_block - lo_block > 1 (wide intervals — repeat-rich
    patterns) get garbage hi values; the second return is their validity
    mask, and the engine re-searches invalid lanes on the standard path
    (XLAEngine.search, repair wave) — bit-exactness is unconditional.

    Kept as a tested design point, not the default engine; its speed
    against lf_step_fused on the GPU is not measured.
    """
    k, d, nb = cfg
    W = 2 * k * nb + 4**k
    bmw = 2 * k * nb
    block = interval // _U32(d)  # [B, 2]
    start = block[:, 0]
    prow = tables["entries_paired"][start]  # [B, 2W] — one gather per read
    delta = block[:, 1] - start
    hi_row = jnp.where((delta == _U32(1))[:, None], prow[:, W : 2 * W], prow[:, :W])
    rows = jnp.stack([prow[:, :W], hi_row], axis=1)  # [B, 2, W]

    bm_rows = rows[..., :bmw].reshape(rows.shape[:-1] + (k, 2, nb))
    cnt = _pick_counter(rows[..., bmw:], code[:, None], k)
    masks = _boundary_masks(interval % _U32(d), nb)
    matched = _match_words(bm_rows, code[:, None], k) & masks
    count = jnp.sum(jax.lax.population_count(matched), axis=-1)

    dpos, dbase, dblock = (
        tables["dollar_pos"],
        tables["dollar_base"],
        tables["dollar_block"],
    )
    hit = (
        (block[..., None] == dblock)
        & (code[:, None, None] == dbase)
        & (interval[..., None] > dpos)
    )
    count -= jnp.sum(hit.astype(_U32), axis=-1)
    return cnt + count, delta <= _U32(1)


def lf_step_split(tables: dict, cfg: tuple, interval, code):
    """Split-table k-step LF for both interval ends at once.

    Two gathers per round (the narrow bitmap rows + a flat 1-word counter
    pick), both ends stacked — the high-k counterpoint to lf_step_fused:
    a fused row carries all 4^k counters (1 KB at k=4/d=128), while the
    split bitmap row is just 2k*nb words (128 B), so when the gather issue
    rate is width-insensitive the fused row wins, and when width starts to
    bite the split row wins.

    tables: {'occ': [E+1, 4^k], 'bitmaps': [E+1, k, 2, nb], dollar_*}
    cfg: (k, d, nb) static; interval: uint32 [B, 2]; code: uint32 [B].
    """
    k, d, nb = cfg
    block = interval // _U32(d)
    cnt = tables["occ"][block, code[:, None]]  # flat gather, [B, 2]
    rows = tables["bitmaps"][block]            # row gather, [B, 2, k, 2, nb]

    masks = _boundary_masks(interval % _U32(d), nb)
    matched = _match_words(rows, code[:, None], k) & masks
    count = jnp.sum(jax.lax.population_count(matched), axis=-1)

    dpos, dbase, dblock = (
        tables["dollar_pos"],
        tables["dollar_base"],
        tables["dollar_block"],
    )
    hit = (
        (block[..., None] == dblock)
        & (code[:, None, None] == dbase)
        & (interval[..., None] > dpos)
    )
    count -= jnp.sum(hit.astype(_U32), axis=-1)
    return cnt + count


def lf_step_ac(tables: dict, cfg: tuple, interval, code):
    """Alternate-counters k-step LF (see tpufm.engine.oracle.lf_step_oracle_ac).

    tables adds 'occ_slim': [E+2, 4^k/2]; cfg: (k, d, nb, S).
    """
    k, d, nb, S = cfg
    block = interval // _U32(d)
    odd = (block & _U32(1)) != 0
    high = code >= _U32(S)
    idx_entry = jnp.where(odd ^ high, _U32(1), _U32(0))

    cnt = tables["occ_slim"][block + idx_entry, code & _U32(S - 1)]
    rows = tables["bitmaps"][block]

    masks = _boundary_masks(interval % _U32(d), nb)
    masks = jnp.where((idx_entry == 1)[..., None], ~masks, masks)
    matched = _match_words(rows, code, k) & masks
    count = jnp.sum(jax.lax.population_count(matched), axis=-1)

    dpos, dbase, dblock = (
        tables["dollar_pos"],
        tables["dollar_base"],
        tables["dollar_block"],
    )
    at = (block[..., None] == dblock) & (code[..., None] == dbase)
    fwd = at & (idx_entry == 0)[..., None] & (interval[..., None] > dpos)
    bwd = at & (idx_entry == 1)[..., None] & (interval[..., None] <= dpos)
    count -= jnp.sum((fwd | bwd).astype(_U32), axis=-1)

    return jnp.where(idx_entry == 1, cnt - count, cnt + count)


def fuse_prefix_codes(queries, m: int):
    """uint8 [B, L] -> uint32 [B] big-endian base-4 code of the LAST m
    characters (the suffix processed first by backward search)."""
    tail = queries[:, queries.shape[1] - m:].astype(_U32)
    code = jnp.zeros(queries.shape[0], dtype=_U32)
    for j in range(m):
        code = (code << _U32(2)) | tail[:, j]
    return code


def decode_prefix_codes(codes, m: int):
    """Inverse of fuse_prefix_codes: uint32 [B] -> uint8 [B, m] queries."""
    cols = []
    for j in range(m):
        cols.append(((codes >> _U32(2 * (m - 1 - j))) & _U32(3)).astype(jnp.uint8))
    return jnp.stack(cols, axis=1)


def fuse_round_codes(queries, k: int):
    """uint8 [B, L] -> uint32 [rounds, B] fused k-mer codes per round
    (level i = offset k-1-i inside each k-chunk, rounds run right-to-left)."""
    B, L = queries.shape
    if L % k != 0:
        raise ValueError(f"query length {L} not divisible by k={k}")
    rounds = L // k
    chunks = queries.reshape(B, rounds, k)[:, ::-1, :].astype(_U32)
    code = jnp.zeros((B, rounds), dtype=_U32)
    for i in range(k):
        code |= chunks[:, :, k - 1 - i] << _U32(2 * i)
    return code.T


def _tail_scan(tables: dict, tail_d: int, iv, head):
    """Finish a backward search with head.shape[1] single-character LF
    rounds on the auxiliary 1-step table (tables['tail_*']).

    This is the any-read-length extension: a k-step index can only step k
    characters at a time, so the reference's fixed-k builds reject query
    lengths not divisible by k outright (the round loop assumes it,
    src/fmIndexCPUBaseline.c:200-228 — real 151 bp Illumina reads cannot
    run at k=3 there at all). Here the r = L mod k leftover LEADING
    characters (backward search processes them last) take r extra
    one-gather rounds on a tiny k=1 fused table.
    """
    tt = {
        "entries": tables["tail_entries"],
        "dollar_pos": tables["tail_dollar_pos"],
        "dollar_base": tables["tail_dollar_base"],
        "dollar_block": tables["tail_dollar_block"],
    }
    cfg1 = (1, tail_d, tail_d // 32)
    codes = head[:, ::-1].astype(_U32).T  # [r, B], right-to-left

    def body(iv, code):
        return lf_step_fused(tt, cfg1, iv, code), None

    iv, _ = jax.lax.scan(body, iv, codes)
    return iv


#: pad byte for right-aligned variable-length batches (outside the 0-3
#: code alphabet, so per-read lengths are derivable in-program)
VARLEN_PAD = 0xFF


def make_search_varlen_fn(
    k: int,
    d: int,
    lut_m: int = 0,
    tail_d: int | None = None,
):
    """Jittable VARIABLE-length batch search (fused layout).

    queries: uint8 [B, Lp] reads RIGHT-ALIGNED (left-padded with
    VARLEN_PAD = 0xFF); each read's length is derived in-program as its
    non-pad count. One fixed program serves every mix of lengths <= Lp —
    the static-shape answer to shape-polymorphic read sets (real FASTQ runs mix
    lengths after adapter trimming): no per-length recompiles, no
    bucketing. Because reads are right-aligned, backward search (which
    consumes characters from the END, reference
    src/fmIndexCPUBaseline.c:200) sees every read's real suffix in the
    same columns: k-step round j is all-real for read i iff
    (j+1)*k <= len_i - lut_m, so each round's interval update is simply
    masked per read; the leftover (len_i - lut_m) mod k leading characters
    finish as up to k-1 masked single-step rounds on the k=1 tail table
    (same table the fixed-length any-length extension uses, _tail_scan).

    With lut_m > 0 every read must be at least lut_m long (the LUT
    consumes the rightmost lut_m columns of every lane at once).
    """
    if k > 1 and tail_d is None:
        raise ValueError(
            "variable-length search needs a k=1 tail table (tail_d)"
        )
    nb = d // 32
    cfg = (k, d, nb)

    def search(tables, bwtsize, queries):
        B, Lraw = queries.shape
        # left-pad so the k-step rounds tile the non-LUT columns exactly
        pad = (-(Lraw - lut_m)) % k
        q = jnp.pad(queries, ((0, 0), (pad, 0)), constant_values=VARLEN_PAD)
        Lp = Lraw + pad
        lengths = jnp.sum((q != VARLEN_PAD).astype(jnp.int32), axis=1)
        qc = jnp.where(q == VARLEN_PAD, 0, q).astype(jnp.uint8)
        if lut_m:
            iv = tables["lut"][fuse_prefix_codes(qc, lut_m)]
        else:
            iv = jnp.stack(
                [jnp.zeros(B, dtype=_U32), jnp.full(B, bwtsize, dtype=_U32)],
                axis=1,
            )
        M = lengths - lut_m  # characters left after the LUT start
        W = Lp - lut_m
        if W:
            codes = fuse_round_codes(qc[:, :W], k)

            def body(iv, xj):
                code, j = xj
                iv2 = lf_step_fused(tables, cfg, iv, code)
                keep = (j + 1) * k <= M
                return jnp.where(keep[:, None], iv2, iv), None

            iv, _ = jax.lax.scan(
                body, iv, (codes, jnp.arange(W // k, dtype=jnp.int32))
            )
        if k > 1:
            tt = {
                "entries": tables["tail_entries"],
                "dollar_pos": tables["tail_dollar_pos"],
                "dollar_base": tables["tail_dollar_base"],
                "dollar_block": tables["tail_dollar_block"],
            }
            cfg1 = (1, tail_d, tail_d // 32)
            rem = M % k
            for t in range(k - 1):
                col = Lp - lengths + rem - 1 - t
                ch = jnp.take_along_axis(
                    qc, jnp.clip(col, 0, Lp - 1)[:, None], axis=1
                )[:, 0].astype(_U32)
                iv2 = lf_step_fused(tt, cfg1, iv, ch)
                iv = jnp.where((t < rem)[:, None], iv2, iv)
        return iv

    return search


def make_search_fn(
    k: int,
    d: int,
    alt_counters: bool = False,
    layout: str = "fused",
    lut_m: int = 0,
    tail_d: int | None = None,
):
    """Build the jittable batch search: (tables, bwtsize, queries) -> [B, 2].

    layout="fused" (default): single-table single-gather rounds via
    lf_step_fused. layout="split": separate occ/bitmap gathers with both
    ends stacked (lf_step_split) — the better trade once 4^k counters
    dominate the fused row width; also the only layout for the alternate-counters tables (per-end walk).

    lut_m > 0 (fused or split): tables must hold 'lut' uint32 [4^lut_m, 2] — the
    precomputed SA interval of every lut_m-mer. The first lut_m characters of
    the backward search collapse into ONE gather instead of lut_m/k k-step
    rounds (a round-eliminator the reference's fixed-k design cannot express;
    cf. its per-round entry fetch, src/fmIndexCPUBaseline.c:200-228).

    tail_d is not None: tables additionally hold a k=1 fused table under
    'tail_entries'/'tail_dollar_*' (sample distance tail_d), and query
    lengths with L mod k != 0 are accepted — the r leftover leading
    characters run as r single-step rounds after the k-step scan
    (_tail_scan). Without it, such lengths raise (the reference's
    behavior).
    """
    nb = d // 32
    if layout not in ("fused", "split", "paired"):
        raise ValueError(f"unknown layout {layout!r}")

    if layout == "paired":
        if alt_counters:
            raise ValueError("paired layout supports baseline counters only")
        if not lut_m:
            raise ValueError(
                "paired layout requires a prefix LUT (lut_m > 0): without "
                "one every search starts at the full [0, bwtsize) interval "
                "and the first rounds would all take the repair path"
            )
        cfg_p = (k, d, nb)

        def search_paired(tables, bwtsize, queries):
            L = queries.shape[1]
            r = (L - lut_m) % k
            if r and tail_d is None:
                raise ValueError(
                    f"query length {L} minus lut_m {lut_m} not divisible by "
                    f"k={k}; supply a tail_index (k=1) to search any length"
                )
            head, queries = queries[:, :r], queries[:, r:]
            L -= r
            iv0 = tables["lut"][fuse_prefix_codes(queries, lut_m)]
            ok0 = jnp.ones(queries.shape[0], dtype=bool)
            iv = iv0
            if L > lut_m:
                codes = fuse_round_codes(queries[:, : L - lut_m], k)

                def body(carry, code):
                    iv, ok = carry
                    iv2, ok2 = lf_step_paired(tables, cfg_p, iv, code)
                    return (iv2, ok & ok2), None

                (iv, ok0), _ = jax.lax.scan(body, (iv0, ok0), codes)
            if r:
                # the tail rounds use the standard fused step — no validity
                # caveat, ok is untouched
                iv = _tail_scan(tables, tail_d, iv, head)
            return iv, ok0

        return search_paired

    if alt_counters:
        # AC keeps the per-end split walk: its counter may live in the NEXT
        # entry, so neither row fusion nor end stacking applies cleanly.
        if layout != "split":
            raise ValueError(
                "alt-counters uses the split layout (its counter may live in "
                "the next entry, so rows cannot be fused)"
            )
        if lut_m:
            raise ValueError("lut_m is not supported with alt-counters")
        cfg_ac = (k, d, nb, (4**k) // 2)

        def search_ac(tables, bwtsize, queries):
            if queries.shape[1] % k:
                raise ValueError(
                    f"alt-counters requires query length divisible by k={k} "
                    "(the any-length tail extension is fused/split-layout only)"
                )
            codes = fuse_round_codes(queries, k)
            B = queries.shape[0]
            lo0 = jnp.zeros(B, dtype=_U32)
            hi0 = jnp.full(B, bwtsize, dtype=_U32)

            def body(carry, code):
                lo, hi = carry
                return (
                    lf_step_ac(tables, cfg_ac, lo, code),
                    lf_step_ac(tables, cfg_ac, hi, code),
                ), None

            (lo, hi), _ = jax.lax.scan(body, (lo0, hi0), codes)
            return jnp.stack([lo, hi], axis=1)

        return search_ac

    cfg = (k, d, nb)
    if layout == "fused":
        def step(tables, iv, code):
            return lf_step_fused(tables, cfg, iv, code)
    else:
        def step(tables, iv, code):
            return lf_step_split(tables, cfg, iv, code)

    def search(tables, bwtsize, queries):
        B, L = queries.shape
        r = (L - lut_m) % k if lut_m else L % k
        if r and tail_d is None:
            raise ValueError(
                f"query length {L} leaves {r} leftover character(s) at k={k}"
                + (f" (after the {lut_m}-mer LUT)" if lut_m else "")
                + "; supply a tail_index (k=1) to search any length"
            )
        head, queries = queries[:, :r], queries[:, r:]
        L -= r
        if lut_m:
            if L < lut_m:
                raise ValueError(f"query length {L + r} shorter than lut_m={lut_m}")
            iv0 = tables["lut"][fuse_prefix_codes(queries, lut_m)]
            codes = fuse_round_codes(queries[:, : L - lut_m], k) if L > lut_m else None
        else:
            iv0 = jnp.stack(
                [jnp.zeros(B, dtype=_U32), jnp.full(B, bwtsize, dtype=_U32)],
                axis=1,
            )
            codes = fuse_round_codes(queries, k) if L else None

        iv = iv0
        if codes is not None:
            def body(iv, code):
                return step(tables, iv, code), None

            iv, _ = jax.lax.scan(body, iv0, codes)
        if r:
            iv = _tail_scan(tables, tail_d, iv, head)
        return iv

    return search


class XLAEngine:
    """Host-facing engine wrapper: owns device-resident tables + a jitted
    search specialized on (k, d, layout) — the trace-time equivalent of the
    reference's compile-time -DK_STEPS/-DNUM_CHUNK sweep."""

    def __init__(
        self,
        index: KStepFMIndex | AltCountersIndex,
        device=None,
        layout: str | None = None,
        pad_words: int | None = None,
        lut_m: int = 0,
        lut_cache: str | None = None,
        tail_index: KStepFMIndex | None = None,
    ):
        """tail_index: a k=1 index over the SAME text (any d) enabling
        queries of ANY length — the r = L mod k leftover characters run as
        r single-step rounds on its (tiny) fused table. Build one with
        IndexConfig(k=1) or `tpufm build --tail`.

        pad_words: pad each fused entry row to this many uint32 words
        (e.g. 128 = 512 B rows), trading extra gathered bytes for an
        aligned row; whether that pays on the GPU is not measured.

        lut_m: precompute a 4^lut_m x 2 interval LUT on device (one batched
        backward-search of every lut_m-mer, built with this same engine) and
        start every query lut_m characters in — eliminating lut_m/k rounds.
        """
        if isinstance(index, AltCountersIndex):
            base = index.base
            self.alt_counters = True
            layout = layout or "split"
        else:
            base = index
            self.alt_counters = False
            layout = layout or "fused"
        if lut_m and self.alt_counters:
            raise ValueError("lut_m is not supported with alt-counters")
        if lut_m and lut_m % base.config.k:
            raise ValueError(f"lut_m={lut_m} must be a multiple of k={base.config.k}")
        self.layout = layout
        self.lut_m = lut_m
        self.config = base.config
        self.bwtsize = base.bwtsize

        put = functools.partial(jax.device_put, device=device)
        tables: dict[str, Any] = {
            "dollar_pos": put(base.dollar_pos),
            "dollar_base": put(base.dollar_base),
            "dollar_block": put(np.asarray(base.dollar_block, dtype=np.uint32)),
        }
        if layout == "fused":
            tables["entries"] = put(build_fused_entries(base, pad_words))
        elif layout == "paired":
            # The paired table [E+1, 2W] (row i = fused rows i||i+1) serves
            # the hot path; the standard fused table stays resident for the
            # LUT build and the wide-interval repair wave.
            fused = build_fused_entries(base, None)
            tables["entries"] = put(fused)
            tables["entries_paired"] = put(build_paired_entries(fused))
            del fused
        else:
            tables["bitmaps"] = put(base.bitmaps)
            if self.alt_counters:
                tables["occ_slim"] = put(index.occ_slim)
            else:
                tables["occ"] = put(base.occ)
        self.tail_d = None
        if tail_index is not None:
            if self.alt_counters:
                raise ValueError("tail_index is not supported with alt-counters")
            if tail_index.config.k != 1:
                raise ValueError(
                    f"tail_index must be a k=1 index, got k={tail_index.config.k}"
                )
            if tail_index.bwtsize != base.bwtsize:
                raise ValueError(
                    f"tail_index bwtsize {tail_index.bwtsize} != index "
                    f"bwtsize {base.bwtsize} (different texts?)"
                )
            tables["tail_entries"] = put(build_fused_entries(tail_index))
            tables["tail_dollar_pos"] = put(tail_index.dollar_pos)
            tables["tail_dollar_base"] = put(tail_index.dollar_base)
            tables["tail_dollar_block"] = put(
                np.asarray(tail_index.dollar_block, dtype=np.uint32)
            )
            self.tail_d = tail_index.config.d
        self.tables = tables

        if lut_m:
            tables["lut"] = lut_with_cache(
                tables, base, lut_m, lut_cache, put,
                # the paired engine keeps the standard fused table for the
                # repair path — the LUT is built with it
                layout="fused" if layout == "paired" else layout,
            )

        self._search = jax.jit(
            make_search_fn(
                self.config.k,
                self.config.d,
                self.alt_counters,
                layout=layout,
                lut_m=lut_m,
                tail_d=self.tail_d,
            )
        )

    def _build_prefix_lut(self, m: int):
        return build_prefix_lut(
            self.tables, self.bwtsize, self.config.k, self.config.d, m,
            layout=self.layout,
        )

    #: reads per device wave: per-round transients stay ~700 MB at the
    #: k=3 d=192 row width; the best wave on the GPU is not measured
    WAVE = 1 << 20

    def search(self, queries, wave: int | None = None) -> np.ndarray:
        """queries: uint8 [B, L] 2-bit codes. Returns uint32 [B, 2].

        Batches larger than `wave` are processed in device-sized waves (the
        batched analog of the reference streaming 10M reads through a fixed
        thread pool, common/searchQueries.c:84-95) — each wave is one jit
        call, so arbitrarily large read sets run in constant device memory.

        layout="paired": reads whose interval ever spans more than two
        blocks (wide repeats) are re-searched on the standard fused path in
        fixed-size repair waves; `last_repair_fraction` records how many.
        """
        from tpufm.utils.waves import stream_waves

        wave = wave or self.WAVE
        queries = np.asarray(queries, dtype=np.uint8)
        if self.layout == "paired":
            def dispatch(q):
                return self._search(self.tables, _U32(self.bwtsize), jnp.asarray(q))

            def fetch(h):
                iv, ok = h
                # ride the ok bit alongside so wave-tail trimming stays
                # aligned with the query order
                return np.concatenate(
                    [
                        np.asarray(jax.device_get(iv)),
                        np.asarray(jax.device_get(ok)).astype(np.uint32)[:, None],
                    ],
                    axis=1,
                )

            out3 = stream_waves(queries, wave, dispatch, fetch, depth=3)
            iv = np.ascontiguousarray(out3[:, :2])
            bad = np.flatnonzero(out3[:, 2] == 0)
            self.last_repair_fraction = bad.size / max(1, queries.shape[0])
            if bad.size:
                iv[bad] = self._repair(queries[bad])
            return iv
        # Pipelined waves (depth 3): dispatches are async, so keeping several
        # in flight overlaps host->device query staging and device->host
        # result drain with the previous waves' compute.
        return stream_waves(
            queries,
            wave,
            lambda q: self._search(
                self.tables, _U32(self.bwtsize), jnp.asarray(q)
            ),
            lambda h: np.asarray(jax.device_get(h)),
            depth=3,
        )

    def search_varlen(self, queries, wave: int | None = None) -> np.ndarray:
        """Variable-length batch search: queries uint8 [B, Lmax]
        RIGHT-ALIGNED with pad byte VARLEN_PAD (0xFF) on the left — the
        shape load_queries_varlen produces. Returns uint32 [B, 2], each
        read searched at its own true length (bit-exact vs a per-read
        fixed-length search). Requires the baseline fused tables and,
        for k > 1, a tail_index (the k=1 table finishes each read's
        length-mod-k leftover rounds)."""
        if self.layout != "fused":
            raise ValueError(
                "variable-length search rides the baseline fused layout "
                "(alt-counters/split/paired are fixed-length engines)"
            )
        if self.config.k > 1 and self.tail_d is None:
            raise ValueError(
                "variable-length search needs a tail_index (k=1) — every "
                "length mix has reads with L mod k != 0"
            )
        queries = np.asarray(queries, dtype=np.uint8)
        lengths = (queries != VARLEN_PAD).sum(axis=1)
        if (lengths == 0).any():
            raise ValueError("empty read in variable-length batch")
        if self.lut_m and int(lengths.min()) < self.lut_m:
            raise ValueError(
                f"shortest read ({int(lengths.min())}) is below "
                f"lut_m={self.lut_m}; rebuild the engine with a smaller LUT"
            )
        if not hasattr(self, "_search_varlen"):
            self._search_varlen = jax.jit(
                make_search_varlen_fn(
                    self.config.k,
                    self.config.d,
                    lut_m=self.lut_m,
                    tail_d=self.tail_d,
                )
            )
        from tpufm.utils.waves import stream_waves

        return stream_waves(
            queries,
            wave or self.WAVE,
            lambda q: self._search_varlen(
                self.tables, _U32(self.bwtsize), jnp.asarray(q)
            ),
            # zero-padded tail-wave rows read as full-length all-A reads
            # and are trimmed by stream_waves like every fixed-length path
            lambda h: np.asarray(jax.device_get(h)),
            depth=3,
        )

    #: repair-wave shape (fixed so the standard-path program compiles once)
    REPAIR_WAVE = 1 << 16

    def _repair(self, queries_bad: np.ndarray) -> np.ndarray:
        """Re-search wide-interval reads on the standard fused path.

        The batch is padded to a power-of-two wave (capped at REPAIR_WAVE)
        by cycling its own reads, so only a handful of program shapes ever
        compile regardless of how many reads need repair."""
        from tpufm.utils.waves import stream_waves

        if not hasattr(self, "_repair_search"):
            self._repair_search = jax.jit(
                make_search_fn(
                    self.config.k, self.config.d, False,
                    layout="fused", lut_m=self.lut_m, tail_d=self.tail_d,
                )
            )
        n = queries_bad.shape[0]
        wave = min(self.REPAIR_WAVE, 1 << (n - 1).bit_length() if n > 1 else 1)
        pad = -n % wave
        if pad:
            reps = -(-(n + pad) // n)
            queries_bad = np.concatenate([queries_bad] * reps)[: n + pad]
        out = stream_waves(
            queries_bad,
            wave,
            lambda q: self._repair_search(
                self.tables, _U32(self.bwtsize), jnp.asarray(q)
            ),
            lambda h: np.asarray(jax.device_get(h)),
        )
        return out[:n]

    def search_device(self, queries):
        """Device-to-device search (no host transfer), for benchmarking."""
        return self._search(self.tables, _U32(self.bwtsize), queries)

    def search_device_waved(self, queries, wave: int | None = None):
        """Device-resident search of a batch larger than one wave: a
        lax.map over [n_waves, wave, L] keeps per-round gather transients at
        wave size (one 10M-read pass = ten 1M-read waves inside one jit,
        no host round-trips). B must be a multiple of `wave`."""
        wave = wave or self.WAVE
        B, L = queries.shape
        if B % wave:
            raise ValueError(f"batch {B} not a multiple of wave {wave}")
        if not hasattr(self, "_search_waved"):
            fn = make_search_fn(
                self.config.k,
                self.config.d,
                self.alt_counters,
                layout=self.layout,
                lut_m=self.lut_m,
                tail_d=self.tail_d,
            )

            def waved(tables, bwtsize, q3):
                return jax.lax.map(lambda w: fn(tables, bwtsize, w), q3)

            self._search_waved = jax.jit(waved)
        out = self._search_waved(
            self.tables, _U32(self.bwtsize), queries.reshape(B // wave, wave, L)
        )
        return out.reshape(B, 2)

    def count(self, queries, mismatches: int = 0, wave: int | None = None):
        """Occurrence count per read, uint32 [B].

        mismatches=0: R - L of the exact search. mismatches=1: exact count
        of occurrences within Hamming distance 1 — every read's 3L+1
        single-substitution variants are generated ON DEVICE and ride the
        same batched scan (make_count_mismatch_fn); full sensitivity, no
        candidate caps, cost (3L+1)x absorbed by the batch axis."""
        from tpufm.utils.waves import stream_waves

        queries = np.asarray(queries, dtype=np.uint8)
        if mismatches == 0:
            iv = self.search(queries, wave=wave)
            return (iv[:, 1] - iv[:, 0]).astype(np.uint32)
        if mismatches != 1:
            raise NotImplementedError(
                f"mismatches={mismatches}: only 0 and 1 are supported (the "
                "variant fan-out grows as (3L)^e — distance 2 at L=120 is "
                "~65K variants/read; use a seed-and-verify pipeline instead)"
            )
        if self.alt_counters or self.layout != "fused":
            raise ValueError("count(mismatches=1) requires the fused layout")
        L = queries.shape[1]
        if not hasattr(self, "_count_mm"):
            self._count_mm = jax.jit(
                make_count_mismatch_fn(
                    self.config.k, self.config.d, self.lut_m, self.tail_d
                )
            )
        # each read fans out to 3L+1 device lanes — shrink the wave so the
        # device batch stays at WAVE lanes
        wave = wave or max(1, self.WAVE // (3 * L + 1))
        return stream_waves(
            queries,
            wave,
            lambda q: self._count_mm(
                self.tables, _U32(self.bwtsize), jnp.asarray(q)
            ),
            lambda h: np.asarray(jax.device_get(h)),
            depth=2,
        )


def build_prefix_lut(tables, bwtsize, k: int, d: int, m: int, layout="fused"):
    """uint32 [4^m, 2] (host array): the SA interval of every m-mer,
    computed on device with the engine's own tables (bit-exact by
    construction), assembled on host wave-by-wave — a device-side
    concatenate would transiently double the LUT's footprint, which at
    m=15 (8.6 GB) is the difference between fitting HBM and OOM."""
    fn = jax.jit(make_search_fn(k, d, False, layout=layout))
    n = 4**m
    wave = min(n, 1 << 20)
    out = np.empty((n, 2), dtype=np.uint32)
    for start in range(0, n, wave):
        codes = jnp.arange(start, start + wave, dtype=_U32)
        part = fn(tables, _U32(bwtsize), decode_prefix_codes(codes, m))
        out[start : start + wave] = np.asarray(jax.device_get(part))
    return out


def _variants1(queries):
    """uint8 [W, L] -> uint8 [W, 3L+1, L]: each read plus its 3L single-base
    substitutions (offsets 1..3 added mod 4 at every position).

    All 3L+1 patterns of a read are pairwise distinct strings, so their SA
    intervals are disjoint and interval widths sum to the exact
    Hamming-distance<=1 occurrence count."""
    W, L = queries.shape
    q = queries.astype(jnp.uint8)
    base = q[:, None, None, :]  # [W, 1, 1, L]
    col = jax.lax.broadcasted_iota(jnp.int32, (1, L, 1, L), 3)
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, L, 1, L), 1)
    off = jax.lax.broadcasted_iota(jnp.uint8, (1, 1, 3, 1), 2) + jnp.uint8(1)
    sub = (base + off) & jnp.uint8(3)
    v = jnp.where(col == pos, sub, jnp.broadcast_to(base, (W, L, 3, L)))
    return jnp.concatenate([q[:, None, :], v.reshape(W, 3 * L, L)], axis=1)


def make_count_mismatch_fn(
    k: int, d: int, lut_m: int = 0, tail_d: int | None = None
):
    """Jittable Hamming-distance<=1 counting: (tables, bwtsize, queries
    [W, L]) -> counts uint32 [W].

    Batched formulation of approximate matching: instead of the branchy
    backtracking FM-search, every read expands to its 3L+1
    single-substitution variants ON DEVICE and they ride the ordinary
    batched scan as 3L+1 extra batch lanes — no divergence, full
    sensitivity, no candidate caps. The cost is an honest (3L+1)x the
    exact-search work, which the batch axis absorbs at the same
    rows-per-second. (The reference suite has no approximate matching at
    all.)"""
    search = make_search_fn(k, d, False, layout="fused", lut_m=lut_m,
                            tail_d=tail_d)

    def count(tables, bwtsize, queries):
        W, L = queries.shape
        v = _variants1(queries).reshape(W * (3 * L + 1), L)
        iv = search(tables, bwtsize, v).reshape(W, 3 * L + 1, 2)
        return jnp.sum(iv[..., 1] - iv[..., 0], axis=-1)

    return count


def make_locate_fn(d: int, sample_rate: int):
    """Jittable batched locate: (tables, rows uint32 [N]) -> SA values [N].

    Per iteration (at most `sample_rate`), every lane gathers its block's
    fused locate row (mark bits + mark rank + LF1 entry) and either resolves
    against the sample table or takes one single-step LF hop. Lanes finish
    independently; finished lanes idle (masked) until the fixed trip count
    ends — the batched formulation of the classic sampled-SA walk.
    """
    nb = d // 32
    bmw = 2 * nb  # k=1 bitmap words

    def _onehot_pick(mat, idx):
        """mat [N, W], idx [N] -> mat[i, idx[i]] via one-hot sum — an
        in-register select. A take_along_axis here lowers to ANOTHER device
        gather, and dependent gathers serialize."""
        col = jax.lax.broadcasted_iota(jnp.int32, mat.shape, 1)
        return jnp.sum(
            jnp.where(col == idx.astype(jnp.int32)[:, None], mat, _U32(0)),
            axis=1,
        )

    def locate(tables, rows):
        # ONE fused row per block: LF1 bitmaps | LF1 counters | mark words |
        # mark rank — a single gather per walk iteration (two separate
        # gathers would serialize).
        fused_t = tables["locate_rows"]  # [E+1, 2*nb + 4 + nb + 1]
        samples = tables["samples"]      # [n_sampled]
        dpos = tables["dollar_pos"]    # [1]
        dbase = tables["dollar_base"]  # [1]
        dblock = tables["dollar_block"]

        N = rows.shape[0]
        p0 = rows.astype(_U32)
        out0 = jnp.full(N, _U32(0xFFFFFFFF))
        done0 = jnp.zeros(N, dtype=bool)
        steps0 = jnp.zeros(N, dtype=_U32)

        def body(_, carry):
            p, steps, out, done = carry
            block = p // _U32(d)
            off = p % _U32(d)
            widx = off // _U32(32)
            frow = fused_t[block]                     # [N, 3*nb + 5]
            ent = frow[:, : bmw + 4]
            mark_words = frow[:, bmw + 4 : bmw + 4 + nb]
            mark_rank = frow[:, bmw + 4 + nb]
            word = _onehot_pick(mark_words, widx)
            marked = ((word >> (_U32(31) - (off % _U32(32)))) & _U32(1)) != 0
            pre = jnp.sum(
                jax.lax.population_count(mark_words & _boundary_masks(off, nb)),
                axis=-1,
            )
            rank = jnp.minimum(mark_rank + pre, _U32(samples.shape[0] - 1))
            newly = marked & ~done
            # Record the sample RANK (resolved against the samples table once
            # after the loop — one fewer gather per iteration).
            out = jnp.where(newly, rank, out)
            done = done | marked

            # single-step LF hop (masked out for finished lanes)
            sh = _U32(31) - (off % _U32(32))
            w0 = _onehot_pick(ent[:, :nb], widx)
            w1 = _onehot_pick(ent[:, nb:bmw], widx)
            c = ((w0 >> sh) & _U32(1)) | (((w1 >> sh) & _U32(1)) << _U32(1))
            cnt = _onehot_pick(ent[:, bmw:], c)
            bm = ent[:, :bmw].reshape(N, 1, 2, nb)
            matched = _match_words(bm, c, 1) & _boundary_masks(off, nb)
            count = jnp.sum(jax.lax.population_count(matched), axis=-1)
            hit = (
                (block[:, None] == dblock)
                & (c[:, None] == dbase)
                & (p[:, None] > dpos)
            )
            count -= jnp.sum(hit.astype(_U32), axis=-1)
            p_next = cnt + count
            p = jnp.where(done, p, p_next)
            steps = jnp.where(done, steps, steps + _U32(1))
            return p, steps, out, done

        _, steps, out, done = jax.lax.fori_loop(
            0, sample_rate, body, (p0, steps0, out0, done0)
        )
        # steps froze at mark time (the walk stops advancing it once done);
        # unreachable/unmarked lanes (cannot happen for valid rows) keep the
        # 0xFFFFFFFF sentinel.
        resolved = samples[jnp.minimum(out, _U32(samples.shape[0] - 1))] + steps
        return jnp.where(done, resolved, _U32(0xFFFFFFFF))

    return locate


class LocateEngine:
    """Device-resident sampled-SA locate (a tpufm extension; the reference
    has no locate).

    Resolves BWT rows (or whole search intervals) to text positions using the
    tables built by tpufm.index.locate.build_locate."""

    def __init__(self, loc, device=None):
        put = functools.partial(jax.device_put, device=device)
        self.tables, self.d, self.sample_rate = build_locate_tables(loc, put)
        self._locate = jax.jit(make_locate_fn(self.d, self.sample_rate))

    #: rows per device wave — the same 1M-wave lesson as the search engine;
    #: arbitrarily large hit sets stream in constant device memory
    WAVE = 1 << 21

    def locate_rows(self, rows, wave: int | None = None) -> np.ndarray:
        """BWT rows uint32 [N] -> SA values uint32 [N]. Batches beyond
        `wave` stream in fixed-shape padded waves, pipelined 2 deep."""
        from tpufm.utils.waves import stream_waves

        return stream_waves(
            np.asarray(rows, dtype=np.uint32),
            wave or self.WAVE,
            lambda r: self._locate(self.tables, jnp.asarray(r)),
            lambda h: np.asarray(jax.device_get(h)),
            depth=2,
        )

    def locate_hits(self, intervals, max_hits: int) -> np.ndarray:
        """uint32 [B, 2] search intervals -> uint32 [B, max_hits] text
        positions, padded with 0xFFFFFFFF past each interval's count.
        Only the lanes inside their interval walk (host-side compaction —
        typical reads fill 1-2 of max_hits lanes)."""
        from tpufm.index.locate import locate_hits_compacted

        return locate_hits_compacted(self.locate_rows, intervals, max_hits)


def compact_slots(vflat, R: int):
    """Shared compaction primitives: per-lane target slots for packing the
    valid lanes of a flat [N] mask into an [R+1] array whose parking slot
    R absorbs invalid/overflow lanes (sliced off before use). Returns
    (slot int32 [N] — each lane's compact index, total int32 scalar,
    tgt int32 [N] — scatter target with invalid lanes parked at R)."""
    slot = jnp.cumsum(vflat.astype(jnp.int32)) - 1
    total = jnp.sum(vflat, dtype=jnp.int32)
    tgt = jnp.where(vflat, jnp.minimum(slot, R), R)
    return slot, total, tgt


def scatter_back(vflat, slot, R: int, values, fill):
    """Inverse of the compaction: values [R] (one per compact slot) plus a
    fill for invalid lanes -> flat [N] in original lane order."""
    padded = jnp.concatenate([values, jnp.full((1,), fill, values.dtype)])
    return jnp.where(vflat, padded[jnp.minimum(slot, R)], fill)


def locate_compacted(locate, loc_tables, rows, valid, walk_budget=None):
    """Sampled-SA walk over only the `valid` lanes of `rows` (any shape).

    Every walk lane costs ~sample_rate/2 LF(1) gathers whether or not it
    is real, and position consumers routinely carry mostly-padding lane
    grids (interval width < max_hits, seed caps). The valid lanes are
    compacted into a walk_budget-lane array (cumsum slot + scatter),
    walked, and scattered back; a lax.cond falls back to the bit-exact
    full-width walk when the wave's valid lanes exceed the budget (the
    a2a fast-path/fallback shape — results identical on either branch).
    walk_budget defaults to 1/8 of the lane count (min 4096); 0 (or any
    value >= the lane count) disables compaction. GSPMD-SHARDED programs
    must pass 0: the cumsum/scatter runs over the GLOBAL flattened lane
    axis, so under a batch-sharded jit XLA would have to insert
    collectives and replicate the compacted walk, breaking the
    shard-local walk design — the mesh engines therefore keep the
    full-width per-shard walk and compact on the host instead. Returns
    positions in rows' shape, 0 where invalid (callers mask)."""
    shape = rows.shape
    flat_rows = rows.reshape(-1)
    vflat = valid.reshape(-1)
    N = flat_rows.shape[0]
    R = walk_budget if walk_budget is not None else max(4096, N // 8)
    if R <= 0 or R >= N:
        return locate(loc_tables, flat_rows).reshape(shape)
    slot, total, tgt = compact_slots(vflat, R)

    def compact_walk(_):
        comp = jnp.zeros(R + 1, _U32).at[tgt].set(
            jnp.where(vflat, flat_rows, _U32(0))
        )
        return scatter_back(
            vflat, slot, R, locate(loc_tables, comp[:R]), _U32(0)
        )

    def full_walk(_):
        return locate(loc_tables, flat_rows)

    pos = jax.lax.cond(total <= R, compact_walk, full_walk, None)
    return pos.reshape(shape)


def make_search_locate_fn(
    k: int, d: int, lut_m: int, loc_d: int, sample_rate: int, max_hits: int,
    walk_budget: int | None = None,
):
    """Jittable fused search+locate: (search_tables, locate_tables, bwtsize,
    queries [B, L]) -> (intervals [B, 2], positions [B, max_hits], padded
    with 0xFFFFFFFF past each interval's count). Shared by the single-chip
    SearchLocateEngine and the mesh DataParallelSearchLocate.

    Any query length is accepted at no table cost: the locate walk's fused
    rows ARE a k=1 LF table (lf1 bitmaps | occ | mark words — lf_step_fused
    ignores the trailing mark columns like row padding), so the r = L mod k
    leftover characters run their single-step tail rounds (_tail_scan)
    against locate_rows directly."""
    search = make_search_fn(k, d, False, layout="fused", lut_m=lut_m,
                            tail_d=loc_d)
    locate = make_locate_fn(loc_d, sample_rate)
    mh = max_hits

    def fused(tables, loc_tables, bwtsize, queries):
        tables = dict(
            tables,
            tail_entries=loc_tables["locate_rows"],
            tail_dollar_pos=loc_tables["dollar_pos"],
            tail_dollar_base=loc_tables["dollar_base"],
            tail_dollar_block=loc_tables["dollar_block"],
        )
        iv = search(tables, bwtsize, queries)  # [B, 2] uint32
        lo = iv[:, 0]
        width = jnp.minimum(iv[:, 1] - lo, _U32(mh))
        cols = jnp.arange(mh, dtype=_U32)[None, :]
        valid = cols < width[:, None]
        rows = jnp.where(valid, lo[:, None] + cols, _U32(0))
        pos = locate_compacted(locate, loc_tables, rows, valid, walk_budget)
        return iv, jnp.where(valid, pos, _U32(0xFFFFFFFF))

    return fused


def make_mismatch_locate_fn(
    k: int, d: int, lut_m: int, loc_d: int, sample_rate: int, max_hits: int,
    walk_budget: int | None = None,
):
    """Jittable Hamming<=1 locate: (search_tables, locate_tables, bwtsize,
    queries [W, L]) -> positions uint32 [W, max_hits] (0xFFFFFFFF padded).

    One device pass: the 3L+1 single-substitution variants ride the batched
    scan (_variants1 — variant patterns are pairwise distinct, so no
    position can be reported twice), the variant intervals expand to BWT
    rows, a cumsum/scatter compaction keeps the first max_hits candidate
    rows per READ, and only those walk the sampled-SA locate — the walk
    cost stays W*max_hits lanes, not W*(3L+1)*max_hits."""
    search = make_search_fn(k, d, False, layout="fused", lut_m=lut_m,
                            tail_d=loc_d)
    locate = make_locate_fn(loc_d, sample_rate)
    mh = max_hits

    def fn(tables, loc_tables, bwtsize, queries):
        tables = dict(
            tables,
            tail_entries=loc_tables["locate_rows"],
            tail_dollar_pos=loc_tables["dollar_pos"],
            tail_dollar_base=loc_tables["dollar_base"],
            tail_dollar_block=loc_tables["dollar_block"],
        )
        W, L = queries.shape
        V = 3 * L + 1
        iv = search(
            tables, bwtsize, _variants1(queries).reshape(W * V, L)
        ).reshape(W, V, 2)
        lo = iv[..., 0]
        width = jnp.minimum(iv[..., 1] - lo, _U32(mh))
        cols = jnp.arange(mh, dtype=_U32)[None, None, :]
        valid = cols < width[..., None]                      # [W, V, mh]
        rows = jnp.where(valid, lo[..., None] + cols, _U32(0))
        rows = rows.reshape(W, V * mh)
        validf = valid.reshape(W, V * mh)
        # compact: kept candidates go to columns 0..mh-1, overflow and
        # invalid lanes land in the discarded pad column mh
        slot = jnp.cumsum(validf.astype(jnp.int32), axis=1) - 1
        slot = jnp.where(validf & (slot < mh), slot, mh)
        crows = jnp.zeros((W, mh + 1), _U32).at[
            jnp.arange(W, dtype=jnp.int32)[:, None], slot
        ].set(rows)
        nkept = jnp.minimum(jnp.sum(validf, axis=1), mh)
        keep = jnp.arange(mh, dtype=jnp.int32)[None, :] < nkept[:, None]
        pos = locate_compacted(locate, loc_tables, crows[:, :mh], keep, walk_budget)
        return jnp.where(keep, pos, _U32(0xFFFFFFFF))

    return fn


class SearchLocateEngine:
    """Fused search+locate: ONE device pass from reads to text positions.

    The two-pass flow (XLAEngine.search -> host -> LocateEngine.locate_hits)
    transfers every interval to the host and re-dispatches the hit rows; the
    fused program keeps the whole flow device-resident — the search scan's
    output intervals expand to their first max_hits BWT rows in-register and
    feed the sampled-SA walk inside the same jit (the reference has no
    locate at all).

    Bit-exact vs the two-pass path by construction (same search scan, same
    walk, same expand semantics as tpufm.index.locate.expand_intervals).
    """

    #: reads per fused wave: each read carries max_hits walk lanes, so the
    #: walk's working set is WAVE * max_hits rows
    WAVE = 1 << 18

    def __init__(self, index, loc, max_hits: int = 4, lut_m: int = 0,
                 device=None):
        put = functools.partial(jax.device_put, device=device)
        # Reuse the standard engine's table construction (fused entries +
        # LUT build/cache) so the search half is byte-for-byte the flagship.
        xla = XLAEngine(index, device=device, layout="fused", lut_m=lut_m)
        self.config = xla.config
        self.bwtsize = xla.bwtsize
        self.max_hits = max_hits
        self.tables = xla.tables
        self.loc_tables, loc_d, sample_rate = build_locate_tables(loc, put)
        self.lut_m, self.loc_d, self.sample_rate = lut_m, loc_d, sample_rate
        self._fused = jax.jit(
            make_search_locate_fn(
                self.config.k, self.config.d, lut_m, loc_d, sample_rate, max_hits
            )
        )

    def search_locate(self, queries, wave: int | None = None):
        """reads uint8 [B, L] -> (intervals uint32 [B, 2], positions uint32
        [B, max_hits] padded with 0xFFFFFFFF past each interval's count).

        Streams through tpufm.utils.waves (2 dispatches in flight); the two
        outputs ride one pipeline as a [wave, 2 + max_hits] block."""
        from tpufm.utils.waves import stream_waves

        queries = np.asarray(queries, dtype=np.uint8)
        if queries.shape[0] == 0:
            return (
                np.zeros((0, 2), np.uint32),
                np.zeros((0, self.max_hits), np.uint32),
            )
        out = stream_waves(
            queries,
            wave or self.WAVE,
            lambda q: self._fused(
                self.tables, self.loc_tables, _U32(self.bwtsize), jnp.asarray(q)
            ),
            lambda h: np.concatenate(
                [np.asarray(jax.device_get(h[0])),
                 np.asarray(jax.device_get(h[1]))], axis=1
            ),
            depth=2,
            pad_mode="cycle",
        )
        return np.ascontiguousarray(out[:, :2]), np.ascontiguousarray(out[:, 2:])

    def locate_mismatch(self, queries, wave: int | None = None) -> np.ndarray:
        """Positions of occurrences within Hamming distance 1: uint8 [B, L]
        -> uint32 [B, max_hits], 0xFFFFFFFF padded, at most max_hits hits
        per read in (variant, SA) enumeration order. One device pass per
        wave (make_mismatch_locate_fn); each read fans out to 3L+1 search
        lanes, so waves shrink accordingly."""
        from tpufm.utils.waves import stream_waves

        queries = np.asarray(queries, dtype=np.uint8)
        if queries.shape[0] == 0:
            return np.zeros((0, self.max_hits), np.uint32)
        L = queries.shape[1]
        if not hasattr(self, "_mm_locate"):
            self._mm_locate = jax.jit(
                make_mismatch_locate_fn(
                    self.config.k, self.config.d, self.lut_m, self.loc_d,
                    self.sample_rate, self.max_hits,
                )
            )
        wave = wave or max(1, (1 << 20) // (3 * L + 1))
        return stream_waves(
            queries,
            wave,
            lambda q: self._mm_locate(
                self.tables, self.loc_tables, _U32(self.bwtsize), jnp.asarray(q)
            ),
            lambda h: np.asarray(jax.device_get(h)),
            depth=2,
            pad_mode="cycle",
        )


def build_locate_tables(loc, put):
    """Device table pytree for the sampled-SA locate walk, shared by the
    single-chip LocateEngine and the mesh DataParallelLocate. `put` places
    each array (device / sharding of the caller's choice). Returns
    (tables, d, sample_rate)."""
    from tpufm.index.locate import LocateIndex

    assert isinstance(loc, LocateIndex)
    lf1 = loc.lf1
    if lf1.config.k != 1:
        raise ValueError(
            f"LocateIndex.lf1 must be a k=1 index (got k={lf1.config.k}); "
            "the locate walk takes single-character LF steps"
        )
    rows = lf1.occ.shape[0]
    # Device-built tables (builder_device.build_locate_device,
    # return_host=False) fuse in place — no host round trip (the same
    # pattern as build_fused_entries).
    xp = jnp if isinstance(lf1.occ, jax.Array) else np
    tables = {
        "locate_rows": put(
            xp.concatenate(
                [
                    lf1.bitmaps.reshape(rows, -1),
                    lf1.occ,
                    xp.asarray(loc.mark_words),
                    xp.asarray(loc.mark_rank)[:, None],
                ],
                axis=1,
            ).astype(xp.uint32)
        ),
        "samples": put(loc.samples),
        "dollar_pos": put(lf1.dollar_pos),
        "dollar_base": put(lf1.dollar_base),
        "dollar_block": put(np.asarray(lf1.dollar_block, np.uint32)),
    }
    return tables, lf1.config.d, loc.sample_rate


def build_paired_entries(entries):
    """[E+1, W] fused table -> [E+1, 2W] paired table: row i carries fused
    rows i and i+1 side by side (the last row's second half is zeros — only
    selectable for hi_block = E+1, which cannot occur since hi <= bwtsize).
    Works on host (numpy) and device (jnp) tables alike."""
    xp = jnp if isinstance(entries, jax.Array) else np
    tail = xp.concatenate(
        [entries[-1:], xp.zeros((1, entries.shape[1]), xp.uint32)], axis=1
    )
    return xp.concatenate(
        [xp.concatenate([entries[:-1], entries[1:]], axis=1), tail]
    )


def build_fused_entries(base: KStepFMIndex, pad_words: int | None = None):
    """Fused entry table: [E+1, 2k*nb + 4^k (+pad)] uint32 — the on-device
    layout shared by every fused-layout engine. Works on host (numpy) and
    device (jnp) tables alike; a device-built index (builder_device.py,
    return_host=False) is fused in place with no host round trip."""
    xp = jnp if isinstance(base.occ, jax.Array) else np
    rows = base.occ.shape[0]
    entries = xp.concatenate([base.bitmaps.reshape(rows, -1), base.occ], axis=1)
    if pad_words and pad_words > entries.shape[1]:
        entries = xp.concatenate(
            [entries, xp.zeros((rows, pad_words - entries.shape[1]), xp.uint32)],
            axis=1,
        )
    return entries


#: largest prefix LUT the npz cache will persist (m<=12 qualifies; the
#: 8.6 GB m=15 LUT is rebuilt on device instead)
LUT_CACHE_MAX_BYTES = 512 * 1024 * 1024


def lut_with_cache(tables, base: KStepFMIndex, lut_m: int, lut_cache, put,
                   layout: str = "fused"):
    """Load the prefix LUT from a validated cache file or build it on device.

    The cache carries a fingerprint of the index (k/d/m/bwtsize, dollar
    positions, occ sentinel row, CRC of strided occ rows): a stale cache
    from a different index rebuilds instead of silently corrupting results.
    `put` places the loaded array (device / sharding of the caller's choice).
    """
    import zlib

    cfg = base.config
    stride = max(1, base.occ.shape[0] // 4096)
    # np.asarray first: device-built tables (builder_device return_host=False)
    # are jnp arrays, where .astype(uint64) silently truncates to uint32.
    fp = np.concatenate(
        [
            np.asarray(
                [
                    cfg.k,
                    cfg.d,
                    lut_m,
                    base.bwtsize,
                    zlib.crc32(np.ascontiguousarray(np.asarray(base.occ[::stride]))),
                ],
                np.uint64,
            ),
            np.asarray(base.dollar_pos).astype(np.uint64),
            np.asarray(base.occ[-1]).astype(np.uint64),
        ]
    )
    if lut_cache is not None:
        import os

        if not lut_cache.endswith(".npz"):
            lut_cache += ".npz"  # np.savez appends it; keep load/save paired
        if os.path.exists(lut_cache):
            z = np.load(lut_cache)
            if "fingerprint" in z and np.array_equal(z["fingerprint"], fp):
                return put(z["lut"])
    lut = build_prefix_lut(tables, base.bwtsize, cfg.k, cfg.d, lut_m, layout)
    # only persist LUTs of sane size (m=12 is 134 MB; m=15 would write
    # an 8.6 GB npz — cheaper to rebuild on device than to read back)
    if lut_cache is not None and lut.nbytes <= LUT_CACHE_MAX_BYTES:
        np.savez(lut_cache, lut=lut, fingerprint=fp)
    return put(lut)
