"""Paired-end read mapping: joint placement of (R1, R2) under an
insert-size constraint.

Production short-read data comes in FR pairs: the two mates bracket one
DNA fragment, R1 on one strand and R2 on the other, fragment length
(outer distance) inside a library-specific window. A proper pair on the
PLUS strand places R1 forward at p1 and the reverse complement of R2 at
p2 with imin <= p2 + L2 - p1 <= imax; the MINUS strand is the mirror
(rc(R1) at q1, R2 forward at q2, imin <= q1 + L1 - q2 <= imax).

The batched formulation keeps everything dense: both mates' both strands ride
ONE position-engine batch (4B reads — exactly the `--rc` trick twice),
and pairing is a [H1 x H2] outer comparison per read pair per strand —
a few hundred elementwise ops — followed by the usual in-register cumsum/scatter
compaction to max_pairs. No candidate lists, no sorting by chromosome,
no data-dependent shapes.

The pairing stage is position-source-agnostic: any engine that yields
[B, H] uint32 position rows (exact locate, fused search+locate, the
Hamming seed engine, the Myers edit engine) composes with make_pair_fn.
(The reference suite has no pairing — it has no locate at all,
SURVEY.md section 0.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_SENTINEL = 0xFFFFFFFF


def make_pair_fn(L1: int, L2: int, imin: int, imax: int, max_pairs: int):
    """Build the jittable pairing pass:

    (pos1f, pos2r, pos1r, pos2f) — each uint32 [B, H] position rows
    (0xFFFFFFFF padded) for R1 forward, rc(R2), rc(R1), R2 forward —
      -> (pairs uint32 [B, max_pairs, 2] — (leftmost mate start,
          rightmost mate start), 0xFFFFFFFF padded,
          strand uint8 [B, max_pairs] — 0 = R1 on plus, 1 = R1 on minus,
          2 = padding,
          counts uint32 [B] — proper pairs found, may exceed max_pairs).

    Fragment length is measured outer-to-outer: plus strand
    p2 + L2 - p1, minus strand q1 + L1 - q2, both required in
    [imin, imax] (and non-negative: mates may overlap but not cross)."""
    P = max_pairs

    def strand_pairs(left, right, Llast):
        # left [B, H1] fragment-left starts, right [B, H2] fragment-right
        # starts; proper iff max(imin, Llast) <= right + Llast - left
        # <= imax (mates may overlap but not cross). uint32 wraparound is
        # safe: a crossing pair (right + Llast < left) wraps to >= 2^31,
        # far above any sane imax — jnp.int64 would silently downcast to
        # int32 and break past 2^31 bases instead.
        lv = left != _U32(_SENTINEL)
        rv = right != _U32(_SENTINEL)
        frag = (
            right.astype(_U32)[:, None, :]
            + _U32(Llast)
            - left.astype(_U32)[:, :, None]
        )
        ok = (
            lv[:, :, None]
            & rv[:, None, :]
            & (frag >= _U32(max(imin, Llast)))
            & (frag <= _U32(imax))
        )
        return ok  # [B, H1, H2]

    def fn(pos1f, pos2r, pos1r, pos2f):
        B = pos1f.shape[0]
        ok_p = strand_pairs(pos1f, pos2r, L2)  # R1 left, rc(R2) right
        ok_m = strand_pairs(pos2f, pos1r, L1)  # R2 left, rc(R1) right

        def flat(ok, left, right):
            b, h1, h2 = ok.shape
            lf = jnp.broadcast_to(left[:, :, None], ok.shape).reshape(b, -1)
            rf = jnp.broadcast_to(right[:, None, :], ok.shape).reshape(b, -1)
            return ok.reshape(b, -1), lf, rf

        okp, lp, rp = flat(ok_p, pos1f, pos2r)
        okm, lm, rm = flat(ok_m, pos2f, pos1r)
        ok = jnp.concatenate([okp, okm], axis=1)             # [B, C]
        lft = jnp.concatenate([lp, lm], axis=1)
        rgt = jnp.concatenate([rp, rm], axis=1)
        st = jnp.concatenate(
            [jnp.zeros_like(okp, jnp.uint8), jnp.ones_like(okm, jnp.uint8)],
            axis=1,
        )
        counts = jnp.sum(ok, axis=1, dtype=_U32)

        slot = jnp.cumsum(ok.astype(jnp.int32), axis=1) - 1
        slot = jnp.where(ok & (slot < P), slot, P)
        rows = jnp.arange(B, dtype=jnp.int32)[:, None]
        pairs = jnp.full((B, P + 1, 2), _U32(_SENTINEL))
        pairs = pairs.at[rows, slot, 0].set(jnp.where(ok, lft, _U32(_SENTINEL)))
        pairs = pairs.at[rows, slot, 1].set(jnp.where(ok, rgt, _U32(_SENTINEL)))
        strand = jnp.full((B, P + 1), jnp.uint8(2)).at[rows, slot].set(
            jnp.where(ok, st, jnp.uint8(2))
        )
        return pairs[:, :P], strand[:, :P], counts

    return fn


def pair_oracle(codes, r1, r2, imin: int, imax: int):
    """Naive ground truth (test-scale): all proper FR pairs per read pair
    as a list of (left, right, strand) triples, strand 0 = R1 on plus."""
    from tpufm.utils.encoding import reverse_complement

    codes = np.asarray(codes, np.uint8)
    r1 = np.asarray(r1, np.uint8)
    r2 = np.asarray(r2, np.uint8)
    L1, L2 = r1.shape[1], r2.shape[1]

    def occ(read):
        L = read.shape[0]
        wins = np.lib.stride_tricks.sliding_window_view(codes, L)
        return np.flatnonzero((wins == read[None]).all(axis=1))

    out = []
    for a, b in zip(r1, r2):
        triples = []
        for p1 in occ(a):                      # R1 plus
            for p2 in occ(reverse_complement(b[None])[0]):
                f = p2 + L2 - p1
                if L2 <= f and imin <= f <= imax:
                    triples.append((int(p1), int(p2), 0))
        for q2 in occ(b):                      # R1 minus
            for q1 in occ(reverse_complement(a[None])[0]):
                f = q1 + L1 - q2
                if L1 <= f and imin <= f <= imax:
                    triples.append((int(q2), int(q1), 1))
        out.append(triples)
    return out


class PairedEndEngine:
    """Paired-end placement on top of the fused search+locate engine.

    Runs [R1; rc(R2); rc(R1); R2] as one 4B-read batch through
    SearchLocateEngine (or its mesh twin when `mesh` is given) and pairs
    the four position sets on device. The join is position-source
    agnostic: with mismatches > 0 each mate's positions come from the
    Hamming engines instead (m=1: the variant-expansion locate; m>=2:
    the pigeonhole seed engine, which needs `text`), and with edits > 0
    from the Myers edit engine — pairing then tolerates per-mate
    substitutions or indels. The insert window is orders of magnitude
    wider than the <= E fragment-length slack indels introduce, so the
    same FR join applies; mate overflow follows the seed-cap
    lower-bound contract."""

    def __init__(self, index, loc, imin: int, imax: int,
                 max_hits: int = 8, max_pairs: int = 4, lut_m: int = 0,
                 mesh=None, mismatches: int = 0, seed_hits: int = 32,
                 text=None, edits: int = 0):
        if imin > imax:
            raise ValueError(f"insert range empty: [{imin}, {imax}]")
        if mismatches and edits:
            raise ValueError("mismatches and edits are different distance "
                             "models; pass one")
        if (mismatches >= 2 or edits) and text is None:
            raise ValueError(
                "mismatches >= 2 / edits pairing needs the reference text "
                "(2-bit codes) for the verify pass"
            )
        self.mismatches = mismatches
        self.edits = edits
        self.seed_hits = seed_hits
        self._mesh = mesh
        self._text = text
        if mesh is not None:
            from tpufm.parallel import DataParallelSearchLocate

            self._eng = DataParallelSearchLocate(
                index, loc, mesh, max_hits=max_hits, lut_m=lut_m
            )
        elif edits:
            from tpufm.engine.edit import EditExtendEngine

            self._eng = EditExtendEngine(
                index, loc, text, edits=edits, seed_hits=seed_hits,
                max_hits=max_hits, lut_m=lut_m,
            )
        elif mismatches >= 2:
            from tpufm.engine.seed import SeedExtendEngine

            self._eng = SeedExtendEngine(
                index, loc, text, mismatches=mismatches,
                seed_hits=seed_hits, max_hits=max_hits, lut_m=lut_m,
            )
        else:
            from tpufm.engine.xla import SearchLocateEngine

            self._eng = SearchLocateEngine(
                index, loc, max_hits=max_hits, lut_m=lut_m
            )
        self.imin, self.imax = imin, imax
        self.max_hits = max_hits
        self.max_pairs = max_pairs
        self._pair_cache = {}

    def _positions(self, batch, wave):
        """uint8 [N, L] -> (positions uint32 [N, max_hits], overflow bool
        [N]) from the configured source."""
        m = self.mismatches
        if self.edits:
            if self._mesh is not None:
                pos, cnt, ovf = self._eng.locate_edits(
                    batch, self._text, self.edits,
                    seed_hits=self.seed_hits, wave=wave,
                )
            else:
                pos, cnt, ovf = self._eng.locate_edits(batch, wave=wave)
            # counts past max_hits mean the position row was truncated:
            # that too makes the join's view incomplete (same contract as
            # the exact source's interval-width check)
            return pos, ovf | (cnt > np.uint32(self.max_hits))
        if m >= 2:
            if self._mesh is not None:
                pos, cnt, ovf = self._eng.locate_approx(
                    batch, self._text, m, seed_hits=self.seed_hits,
                    wave=wave,
                )
            else:
                pos, cnt, ovf = self._eng.locate_approx(batch, wave=wave)
            return pos, ovf | (cnt > np.uint32(self.max_hits))
        if m == 1:
            pos = self._eng.locate_mismatch(batch, wave=wave)
            # this source has no explicit truncation signal: a FULL row
            # (max_hits real positions) may have been cut, so flag it
            # conservatively (lower-bound contract; a read with exactly
            # max_hits sites is flagged too)
            return pos, (pos != np.uint32(0xFFFFFFFF)).all(axis=1)
        iv, pos = self._eng.search_locate(batch, wave=wave)
        return pos, (iv[:, 1] - iv[:, 0]) > np.uint32(self.max_hits)

    def pair(self, r1, r2, wave: int | None = None):
        """R1 uint8 [B, L1], R2 uint8 [B, L2] -> (pairs uint32
        [B, max_pairs, 2] (left, right) starts, strand uint8 [B, max_pairs]
        (0 = R1 plus / 1 = R1 minus / 2 = pad), counts uint32 [B],
        overflow bool [B] — some mate's occurrence interval exceeded
        max_hits, so the join saw only its first max_hits SA-order
        positions and pairs/counts are lower bounds for that read pair
        (the same repeat-cap contract as the seed/edit engines)."""
        from tpufm.utils.encoding import reverse_complement

        r1 = np.asarray(r1, np.uint8)
        r2 = np.asarray(r2, np.uint8)
        if r1.shape[0] != r2.shape[0]:
            raise ValueError("R1/R2 batches differ in length")
        B = r1.shape[0]
        L1, L2 = r1.shape[1], r2.shape[1]
        if B == 0:
            return (
                np.zeros((0, self.max_pairs, 2), np.uint32),
                np.zeros((0, self.max_pairs), np.uint8),
                np.zeros(0, np.uint32),
                np.zeros(0, bool),
            )
        key = (L1, L2)
        if key not in self._pair_cache:
            if len(self._pair_cache) > 8:
                self._pair_cache.clear()
            self._pair_cache[key] = jax.jit(make_pair_fn(
                L1, L2, self.imin, self.imax, self.max_pairs
            ))
        pf = self._pair_cache[key]

        if L1 == L2:
            # both mates, both strands: ONE 4B-read engine batch
            pos, ovf = self._positions(
                np.concatenate([
                    r1, reverse_complement(r2),
                    reverse_complement(r1), r2,
                ]),
                wave,
            )
            p1f, p2r, p1r, p2f = (
                pos[:B], pos[B : 2 * B], pos[2 * B : 3 * B], pos[3 * B :]
            )
            overflow = ovf.reshape(4, B).any(axis=0)
        else:
            p1, o1 = self._positions(
                np.concatenate([r1, reverse_complement(r1)]), wave
            )
            p2, o2 = self._positions(
                np.concatenate([reverse_complement(r2), r2]), wave
            )
            p1f, p1r = p1[:B], p1[B:]
            p2r, p2f = p2[:B], p2[B:]
            overflow = (
                o1[:B] | o1[B:] | o2[:B] | o2[B:]
            )
        pairs, strand, counts = pf(
            jnp.asarray(p1f), jnp.asarray(p2r),
            jnp.asarray(p1r), jnp.asarray(p2f),
        )
        return (
            np.asarray(jax.device_get(pairs)),
            np.asarray(jax.device_get(strand)),
            np.asarray(jax.device_get(counts)),
            overflow,
        )
