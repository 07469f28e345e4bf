"""Multi-chip search engines.

DataParallelEngine — index tables replicated per chip, query batch sharded
along the batch axis of a 1-D mesh; the jitted program is pure SPMD data
parallelism and the per-read (lo, hi) results are merged with one all-gather
at the end (8 bytes per read over the device links). This is the scaling mode for indexes
that fit in HBM (human genome @ k=2, d=64 is ~3.2 GB).

ShardedIndexEngine — for indexes exceeding a chip's HBM: the entry table is
sharded along the block axis; every LF round, each chip all-gathers the
(block, code, interval) requests of all chips (12 B per interval end),
answers the ones whose entry lives in its shard, and a psum combines the
partial answers. Collectives ride the device links (NVLink, all to all,
on a GPU host); compute stays the same mask/popcount. (The reference has no counterpart — its cluster scripts run
independent processes; SURVEY.md section 5 'distributed communication
backend: none'.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpufm.engine.xla import (
    _boundary_masks,
    _match_words,
    fuse_round_codes,
    make_search_fn,
)
from tpufm.index.builder import KStepFMIndex
from tpufm.index.layouts import AltCountersIndex

_U32 = jnp.uint32


def put_global(x, sharding):
    """Place a host array with `sharding` — multi-process safe.

    Single process: plain device_put. Multi-process (jax.distributed): every
    process holds the same full host array and contributes its addressable
    shards via make_array_from_callback — the standard SPMD bring-up for
    replicated tables and batch-sharded queries on multi-host slices."""
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


class DataParallelEngine:
    """Replicated-index, batch-sharded search over a 1-D device mesh.

    lut_m > 0 additionally replicates a 4^lut_m x 2 prefix LUT (built once,
    on device) so every chip starts its query shard lut_m characters in —
    same round elimination as the single-chip engine."""

    def __init__(
        self,
        index: KStepFMIndex | AltCountersIndex,
        mesh: Mesh,
        lut_m: int = 0,
        lut_cache: str | None = None,
        pad_words: int | None = None,
        tail_index=None,
    ):
        if isinstance(index, AltCountersIndex):
            base, self.alt_counters = index.base, True
        else:
            base, self.alt_counters = index, False
        if lut_m and (self.alt_counters or lut_m % base.config.k):
            raise ValueError("lut_m requires the fused layout and lut_m % k == 0")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.config = base.config
        self.bwtsize = base.bwtsize

        replicated = NamedSharding(mesh, P())
        put = functools.partial(put_global, sharding=replicated)
        tables = {
            "dollar_pos": put(base.dollar_pos),
            "dollar_base": put(base.dollar_base),
            "dollar_block": put(np.asarray(base.dollar_block, dtype=np.uint32)),
        }
        layout = "split" if self.alt_counters else "fused"
        if layout == "fused":
            from tpufm.engine.xla import build_fused_entries

            tables["entries"] = put(build_fused_entries(base, pad_words))
        else:
            tables["bitmaps"] = put(base.bitmaps)
            tables["occ_slim"] = put(index.occ_slim)
        tail_d = None
        if tail_index is not None:
            # any-read-length extension, replicated like the main table
            # (validation mirrors XLAEngine's)
            from tpufm.engine.xla import build_fused_entries

            if self.alt_counters:
                raise ValueError("tail_index is not supported with alt-counters")
            if tail_index.config.k != 1 or tail_index.bwtsize != base.bwtsize:
                raise ValueError(
                    "tail_index must be a k=1 index over the same text"
                )
            tables["tail_entries"] = put(build_fused_entries(tail_index))
            tables["tail_dollar_pos"] = put(tail_index.dollar_pos)
            tables["tail_dollar_base"] = put(tail_index.dollar_base)
            tables["tail_dollar_block"] = put(
                np.asarray(tail_index.dollar_block, dtype=np.uint32)
            )
            tail_d = tail_index.config.d
        self.tables = tables

        if lut_m:
            from tpufm.engine.xla import lut_with_cache

            tables["lut"] = lut_with_cache(tables, base, lut_m, lut_cache, put)

        self.lut_m, self._tail_d = lut_m, tail_d
        self.batch_sharding = NamedSharding(mesh, P(self.axis, None))
        search = make_search_fn(
            self.config.k,
            self.config.d,
            self.alt_counters,
            layout=layout,
            lut_m=lut_m,
            tail_d=tail_d,
        )
        # Results replicated on exit: the all-gather merge of the per-chip
        # (lo, hi) shards.
        self._search = jax.jit(
            search, out_shardings=NamedSharding(mesh, P())
        )

    def shard_queries(self, queries) -> jax.Array:
        """Place a [B, L] uint8 batch sharded along the mesh's batch axis.
        B must divide evenly by the mesh size (pad the tail batch)."""
        n = self.mesh.devices.size
        if queries.shape[0] % n:
            raise ValueError(
                f"batch {queries.shape[0]} not divisible by mesh size {n}; pad it"
            )
        return put_global(np.asarray(queries, np.uint8), self.batch_sharding)

    def search(self, queries) -> np.ndarray:
        """uint8 [B, L] -> uint32 [B, 2]. A batch not divisible by the mesh
        size is padded by cycling its own reads and the answers trimmed."""
        from tpufm.utils.waves import pad_cycle

        queries = np.asarray(queries, np.uint8)
        B = queries.shape[0]
        pad = -B % self.mesh.devices.size
        if pad:
            queries = pad_cycle(queries, pad)
        out = self._search(self.tables, _U32(self.bwtsize), self.shard_queries(queries))
        return np.asarray(jax.device_get(out))[:B]

    def search_device(self, queries_sharded):
        return self._search(self.tables, _U32(self.bwtsize), queries_sharded)

    def search_varlen(self, queries) -> np.ndarray:
        """Variable-length twin of search(): a RIGHT-ALIGNED 0xFF-padded
        mixed-length batch (the XLAEngine.search_varlen contract),
        batch-sharded over the mesh. Each chip runs the same masked-round
        program on its query shard; results all-gather like search()."""
        from tpufm.engine.xla import VARLEN_PAD, make_search_varlen_fn
        from tpufm.utils.waves import pad_cycle

        if self.alt_counters:
            raise ValueError(
                "variable-length search rides the baseline fused layout"
            )
        if self.config.k > 1 and self._tail_d is None:
            raise ValueError(
                "variable-length search needs a tail_index (k=1) — every "
                "length mix has reads with L mod k != 0"
            )
        queries = np.asarray(queries, np.uint8)
        lengths = (queries != VARLEN_PAD).sum(axis=1)
        if (lengths == 0).any():
            raise ValueError("empty read in variable-length batch")
        if self.lut_m and int(lengths.min()) < self.lut_m:
            raise ValueError(
                f"shortest read ({int(lengths.min())}) is below "
                f"lut_m={self.lut_m}"
            )
        if not hasattr(self, "_search_vl"):
            self._search_vl = jax.jit(
                make_search_varlen_fn(
                    self.config.k,
                    self.config.d,
                    lut_m=self.lut_m,
                    tail_d=self._tail_d,
                ),
                out_shardings=NamedSharding(self.mesh, P()),
            )
        B = queries.shape[0]
        pad = -B % self.mesh.devices.size
        if pad:
            queries = pad_cycle(queries, pad)
        out = self._search_vl(
            self.tables, _U32(self.bwtsize), self.shard_queries(queries)
        )
        return np.asarray(jax.device_get(out))[:B]

    def count(self, queries, mismatches: int = 0) -> np.ndarray:
        """Occurrence counts per read over the mesh, uint32 [B] — the
        batch-sharded twin of XLAEngine.count. mismatches=1 fans each chip's
        query shard out to its 3L+1 on-device variants
        (make_count_mismatch_fn); waves sized so every chip carries the
        single-chip lane optimum."""
        queries = np.asarray(queries, dtype=np.uint8)
        if mismatches == 0:
            iv = self.search(queries)
            return (iv[:, 1] - iv[:, 0]).astype(np.uint32)
        if mismatches != 1:
            raise NotImplementedError("mismatches must be 0 or 1")
        if self.alt_counters:
            raise ValueError("count(mismatches=1) requires the fused layout")
        from tpufm.engine.xla import make_count_mismatch_fn
        from tpufm.utils.waves import pad_cycle, stream_waves

        n = self.mesh.devices.size
        B, L = queries.shape
        if not hasattr(self, "_count_mm"):
            self._count_mm = jax.jit(
                make_count_mismatch_fn(
                    self.config.k, self.config.d, self.lut_m, self._tail_d
                ),
                out_shardings=NamedSharding(self.mesh, P()),
            )
        # pre-pad to a mesh multiple: stream_waves pads tail WAVES, but a
        # single sub-wave batch would reach shard_queries undivided
        pad = -B % n
        if pad:
            queries = pad_cycle(queries, pad)
        wave = max(1, (1 << 20) // (3 * L + 1)) * n
        return stream_waves(
            queries,
            wave,
            lambda q: self._count_mm(
                self.tables, _U32(self.bwtsize), self.shard_queries(q)
            ),
            lambda h: np.asarray(jax.device_get(h)),
            depth=2,
            pad_mode="cycle",
        )[:B]


def _answer_owned(
    occ_shard, bitmaps_shard, dollar, cfg, my_shard, g_block, g_code, g_interval
):
    """Answer the LF lookups whose entry lives in this chip's shard; zero for
    the rest. Shared by both sharded routings so they cannot diverge."""
    k, d, nb, e_local = cfg
    dpos, dbase, dblock = dollar

    owner = g_block // _U32(e_local)
    local_idx = jnp.where(owner == my_shard, g_block - my_shard * _U32(e_local), 0)

    cnt = occ_shard[local_idx, g_code]
    rows = bitmaps_shard[local_idx]
    masks = _boundary_masks(g_interval % _U32(d), nb)
    matched = _match_words(rows, g_code, k) & masks
    count = jnp.sum(jax.lax.population_count(matched), axis=-1)

    hit = (
        (g_block[..., None] == dblock)
        & (g_code[..., None] == dbase)
        & (g_interval[..., None] > dpos)
    )
    count -= jnp.sum(hit.astype(_U32), axis=-1)
    return jnp.where(owner == my_shard, cnt + count, _U32(0))


def _sharded_lf_step(occ_shard, bitmaps_shard, dollar, cfg, axis, interval, code):
    """One LF round with the entry table sharded along the block axis.

    occ_shard: [E_local, 4^k]; bitmaps_shard: [E_local, k, 2, nb] — this
    chip's contiguous slice of entries. interval/code: [B_local] (this chip's
    query shard). Requests are all-gathered, answered by the owning shard,
    and psum-combined.
    """
    d = cfg[1]
    block = interval // _U32(d)
    # All-gather this round's requests from every chip: [D, B_local, 3]
    req = jnp.stack([block, code, interval], axis=-1)
    all_req = jax.lax.all_gather(req, axis)  # [D, B_local, 3]
    D, Bl, _ = all_req.shape
    flat = all_req.reshape(D * Bl, 3)

    my_shard = jax.lax.axis_index(axis).astype(_U32)
    answer = _answer_owned(
        occ_shard, bitmaps_shard, dollar, cfg, my_shard,
        flat[:, 0], flat[:, 1], flat[:, 2],
    )
    combined = jax.lax.psum(answer.reshape(D, Bl), axis)  # [D, B_local]
    return combined[jax.lax.axis_index(axis)]


def _sharded_lf_step_ring(occ_shard, bitmaps_shard, dollar, cfg, axis, interval, code):
    """One LF round with double-buffered ring routing.

    The local request block is split into two half-blocks that circulate the
    ring phase-shifted by one tick: on every tick one half is being ANSWERED
    by its resident chip while the other half is IN TRANSIT (ppermute). The
    two operations have no data dependency inside a tick, so XLA's
    latency-hiding scheduler can run the collective concurrently with the
    rank compute — the 'double-buffered against compute' design point of
    SURVEY.md section 7 (total bytes unchanged vs the naive ring: D hops of
    B_local x 16 B; per-chip peak memory stays O(B_local))."""
    d = cfg[1]
    n_dev = jax.lax.axis_size(axis)
    my_shard = jax.lax.axis_index(axis).astype(_U32)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    block = interval // _U32(d)

    def answer_owned(g_block, g_code, g_interval):
        return _answer_owned(
            occ_shard, bitmaps_shard, dollar, cfg, my_shard,
            g_block, g_code, g_interval,
        )

    B = interval.shape[0]
    half = (B + 1) // 2
    pad = 2 * half - B
    req = jnp.stack([block, code, interval], axis=-1)  # [B, 3]
    if pad:
        req = jnp.concatenate([req, jnp.zeros((pad, 3), _U32)])
    ans = jnp.zeros(2 * half, _U32)

    def compute(req2, ans2, h):
        """Answer half h in place."""
        r = jax.lax.dynamic_slice_in_dim(req2, h * half, half)
        a = jax.lax.dynamic_slice_in_dim(ans2, h * half, half)
        a = a + answer_owned(r[:, 0], r[:, 1], r[:, 2])
        return jax.lax.dynamic_update_slice_in_dim(ans2, a, h * half, 0)

    def transit(req2, ans2, h):
        """ppermute half h one hop."""
        r = jax.lax.dynamic_slice_in_dim(req2, h * half, half)
        a = jax.lax.dynamic_slice_in_dim(ans2, h * half, half)
        r = jax.lax.ppermute(r, axis, perm)
        a = jax.lax.ppermute(a, axis, perm)
        return (
            jax.lax.dynamic_update_slice_in_dim(req2, r, h * half, 0),
            jax.lax.dynamic_update_slice_in_dim(ans2, a, h * half, 0),
        )

    if n_dev == 1:  # degenerate ring: answer everything at home
        ans = compute(req, ans, 0)
        ans = compute(req, ans, 1)
        return ans[:B]

    # Schedule (both halves start at home chip c; D = n_dev):
    #   tick 0:      compute H0@c
    #   tick 1:      transit H0 -> c+1   || compute H1@c
    #   tick 2s:     transit H1 -> c+s   || compute H0@c+s
    #   tick 2s+1:   transit H0 -> c+s+1 || compute H1@c+s
    #   ... H0 finishes at tick 2(D-1), H1's last compute is the epilogue.
    # Every tick's transit and compute touch DIFFERENT halves — no data
    # dependency, so the collective overlaps the rank compute.
    ans = compute(req, ans, 0)
    req, ans = transit(req, ans, 0)
    ans = compute(req, ans, 1)

    def tickn(t, carry):
        req2, ans2 = carry
        phase = jax.lax.rem(t, 2)

        def even(args):  # transit half 1, compute half 0 (arrived last tick)
            r2, a2 = transit(*args, 1)
            return r2, compute(r2, a2, 0)

        def odd(args):  # transit half 0, compute half 1
            r2, a2 = transit(*args, 0)
            return r2, compute(r2, a2, 1)

        return jax.lax.cond(phase == 0, even, odd, (req2, ans2))

    req, ans = jax.lax.fori_loop(2, 2 * n_dev - 1, tickn, (req, ans))
    # Epilogue: H0 (answered by all D chips, at c+D-1) rides home while H1
    # takes its final answer at c+D-1; then H1 rides home.
    req, ans = transit(req, ans, 0)
    ans = compute(req, ans, 1)
    req, ans = transit(req, ans, 1)
    return ans[:B]


def _sharded_lf_step_a2a(
    occ_shard, bitmaps_shard, dollar, cfg, axis, interval, code, slack=2.0
):
    """One LF round with ragged-bucket all-to-all routing.

    allgather/ring make every chip ANSWER all D x B_local requests (masked)
    — capacity scaling only. Here each chip sorts its requests by owner
    shard and sends each owner just its own bucket (fixed capacity
    C = slack * B_local / D per destination, all_to_all both ways), cutting
    per-chip answered rows from D*B_local to ~slack*B_local — a D/slack x
    compute reduction. Early LF rounds are block-skewed (everyone starts
    near the same entries), so a bucket can overflow; a replicated-predicate
    `lax.cond` then falls back to the full all-gather step for that round —
    bit-exactness is unconditional, the fast path is probabilistic (with a
    prefix LUT the start blocks spread immediately and measured overflow is
    rare after round 1)."""
    k, d, nb, e_local = cfg
    n_dev = jax.lax.axis_size(axis)
    if n_dev == 1:
        return (
            _sharded_lf_step(
                occ_shard, bitmaps_shard, dollar, cfg, axis, interval, code
            ),
            jnp.asarray(False),
        )
    B = interval.shape[0]
    C = max(1, int(-(-B * slack // n_dev)))

    block = interval // _U32(d)
    owner = jnp.minimum(block // _U32(e_local), _U32(n_dev - 1))

    # Sort requests by owner (stable keeps in-bucket order deterministic).
    perm = jnp.argsort(owner, stable=True).astype(jnp.int32)
    req_sorted = jnp.stack(
        [block[perm], code[perm], interval[perm]], axis=-1
    )  # [B, 3]
    owner_sorted = owner[perm]

    cnt = jnp.zeros(n_dev, _U32).at[owner].add(_U32(1))  # [D] histogram
    off = jnp.concatenate(
        [jnp.zeros(1, _U32), jnp.cumsum(cnt, dtype=_U32)[:-1]]
    )
    overflow = jax.lax.pmax(jnp.max(cnt), axis) > _U32(C)

    def bucketed(_):
        # Send buffer: destination d' gets rows [off[d'], off[d']+C) of the
        # sorted stream (rows beyond cnt[d'] are duplicates of the next
        # segment — the receiver masks them by ownership, and the
        # write-back order makes their answer slots be overwritten).
        pad_rows = jnp.zeros((C, 3), _U32)
        rs = jnp.concatenate([req_sorted, pad_rows])
        send = jnp.stack(
            [
                jax.lax.dynamic_slice_in_dim(rs, off[d2], C)
                for d2 in range(n_dev)
            ]
        )  # [D, C, 3]
        recv = jax.lax.all_to_all(
            send, axis, split_axis=0, concat_axis=0, tiled=True
        )  # [D, C, 3] — recv[s] = chip s's bucket for me

        flat = recv.reshape(n_dev * C, 3)
        my_shard = jax.lax.axis_index(axis).astype(_U32)
        ans = _answer_owned(
            occ_shard, bitmaps_shard, dollar, cfg, my_shard,
            flat[:, 0], flat[:, 1], flat[:, 2],
        ).reshape(n_dev, C)
        ans_back = jax.lax.all_to_all(
            ans, axis, split_axis=0, concat_axis=0, tiled=True
        )  # [D, C] — ans_back[d'] = owner d''s answers for my bucket

        # Write back segments in destination order: segment d'+1's write
        # starts at off[d'+1] = off[d'] + cnt[d'], overwriting segment d''s
        # duplicate-row garbage. C trailing slots absorb the last segment's.
        out_sorted = jnp.zeros(B + C, _U32)
        for d2 in range(n_dev):
            out_sorted = jax.lax.dynamic_update_slice_in_dim(
                out_sorted, ans_back[d2], off[d2], 0
            )
        return jnp.zeros(B, _U32).at[perm].set(out_sorted[:B])

    def fallback(_):
        return _sharded_lf_step(
            occ_shard, bitmaps_shard, dollar, cfg, axis, interval, code
        )

    # Returns the per-round overflow flag too, so callers can report how
    # often the fallback fires (the fast path is the common case once a
    # prefix LUT spreads the start blocks).
    return jax.lax.cond(overflow, fallback, bucketed, None), overflow


class ShardedIndexEngine:
    """Entry-table-sharded search for indexes larger than one chip's HBM.

    routing="allgather" (default): every chip all-gathers all requests,
    answers its own, psum combines. routing="ring": the double-buffered
    ring — requests ppermute around the mesh with the collective overlapping
    the rank compute, O(B_local) peak memory per chip.

    lut_m > 0 replicates a 4^lut_m x 2 prefix LUT (built with this engine's
    OWN sharded search, so it is bit-exact by construction) and starts every
    query lut_m characters in — the same round elimination as the
    single-chip engine, which matters MORE here (each eliminated round is a
    full collective circulation).

    Batches larger than `wave` stream through the mesh in device-sized
    waves with pipelined dispatch (constant device memory for 10M-read
    inputs; see docs/DISTRIBUTED.md for the traffic model)."""

    #: per-chip rows per wave; total wave = WAVE_PER_CHIP * n_dev
    WAVE_PER_CHIP = 1 << 17

    def __init__(
        self,
        index: KStepFMIndex,
        mesh: Mesh,
        routing: str = "allgather",
        lut_m: int = 0,
        tail_index=None,
    ):
        if isinstance(index, AltCountersIndex):
            raise NotImplementedError(
                "sharded-index mode uses the baseline counter layout "
                "(a deliberate decision — docs/DISTRIBUTED.md 'Why sharded "
                "mode is baseline-layout only'); rebuild with layout="
                "'baseline' for identical results"
            )
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.config = index.config
        self.bwtsize = index.bwtsize
        self.lut_m = lut_m
        n_dev = mesh.devices.size
        k = self.config.k
        if lut_m and lut_m % k:
            raise ValueError(f"lut_m={lut_m} must be a multiple of k={k}")

        # Pad entry rows so every shard holds the same count; the sentinel
        # row rides along inside the padded region.
        total = index.occ.shape[0]
        e_local = -(-total // n_dev)
        pad = e_local * n_dev - total
        self.e_local = e_local

        shard_rows = NamedSharding(mesh, P(self.axis))
        repl = NamedSharding(mesh, P())
        if isinstance(index.occ, jax.Array):
            # Device-resident tables (build_index_sharded return_host=False):
            # re-pad with a GSPMD relayout — the tables never touch the host.
            self.occ, self.bitmaps = jax.jit(
                lambda o, b: (
                    jnp.pad(o, ((0, pad), (0, 0))),
                    jnp.pad(b, ((0, pad), (0, 0), (0, 0), (0, 0))),
                ),
                out_shardings=(shard_rows, shard_rows),
            )(index.occ, index.bitmaps)
        else:
            occ = np.pad(index.occ, ((0, pad), (0, 0)))
            bitmaps = np.pad(index.bitmaps, ((0, pad), (0, 0), (0, 0), (0, 0)))
            self.occ = put_global(occ, shard_rows)
            self.bitmaps = put_global(bitmaps, shard_rows)
        self.dollar = (
            put_global(np.asarray(jax.device_get(index.dollar_pos)), repl),
            put_global(np.asarray(jax.device_get(index.dollar_base)), repl),
            put_global(np.asarray(jax.device_get(index.dollar_block), np.uint32), repl),
        )

        # Any-length tail: the main table is sharded (that is the point of
        # this engine), but the k=1 tail is ~2/(2k + 4^k/nb) of its size
        # (e.g. ~1/6 at k=3 d=192) and its <=k-1 rounds per query do not
        # justify a collective circulation — REPLICATE it and run the tail
        # rounds chip-locally on each query shard.
        self.tail_d = None
        if tail_index is not None:
            from tpufm.engine.xla import build_fused_entries

            if tail_index.config.k != 1 or tail_index.bwtsize != index.bwtsize:
                raise ValueError(
                    "tail_index must be a k=1 index over the same text"
                )
            self.tail = (
                put_global(
                    np.asarray(jax.device_get(build_fused_entries(tail_index))),
                    repl,
                ),
                put_global(np.asarray(jax.device_get(tail_index.dollar_pos)), repl),
                put_global(np.asarray(jax.device_get(tail_index.dollar_base)), repl),
                put_global(
                    np.asarray(jax.device_get(tail_index.dollar_block), np.uint32),
                    repl,
                ),
            )
            self.tail_d = tail_index.config.d
        else:
            z = put_global(np.zeros(1, np.uint32), repl)
            self.tail = (put_global(np.zeros((1, 1), np.uint32), repl), z, z, z)
        tail_d = self.tail_d

        if routing not in ("allgather", "ring", "a2a"):
            raise ValueError(f"unknown routing {routing!r}")
        self.routing = routing
        step = {
            "allgather": _sharded_lf_step,
            "ring": _sharded_lf_step_ring,
            "a2a": _sharded_lf_step_a2a,
        }[routing]
        d = self.config.d
        cfg = (k, d, self.config.words_per_plane, e_local)
        axis = self.axis

        def make_search(with_lut: bool):
            def search_local(occ_shard, bitmaps_shard, dollar, lut, tail,
                             bwtsize, queries):
                B, L = queries.shape
                r = (L - lut_m) % k if with_lut else L % k
                if r and tail_d is None:
                    raise ValueError(
                        f"query length {L} leaves {r} leftover character(s) "
                        f"at k={k}; supply a tail_index (k=1) to search any "
                        "length"
                    )
                head, queries = queries[:, :r], queries[:, r:]
                L -= r
                if with_lut:
                    from tpufm.engine.xla import fuse_prefix_codes

                    # iv0 inherits device-varying-ness from the query shard;
                    # no pvary needed (varying -> varying pcast rejects).
                    iv0 = lut[fuse_prefix_codes(queries, lut_m)]
                    lo0, hi0 = iv0[:, 0], iv0[:, 1]
                    codes = (
                        fuse_round_codes(queries[:, : L - lut_m], k)
                        if L > lut_m
                        else jnp.zeros((0, B), _U32)
                    )
                else:
                    codes = fuse_round_codes(queries, k)
                    # The carry is device-varying inside shard_map; mark it so.
                    lo0 = jax.lax.pcast(jnp.zeros(B, dtype=_U32), axis, to="varying")
                    hi0 = jax.lax.pcast(jnp.full(B, bwtsize, dtype=_U32), axis, to="varying")

                def body(carry, code):
                    # Stack both interval ends into ONE request block per
                    # round: half the collective launches (one all_gather+
                    # psum or one ring circulation instead of two) for the
                    # same payload.
                    lo, hi = carry
                    iv = jnp.concatenate([lo, hi])
                    code2 = jnp.concatenate([code, code])
                    out = step(
                        occ_shard, bitmaps_shard, dollar, cfg, axis, iv, code2
                    )
                    iv, ov = out if isinstance(out, tuple) else (out, False)
                    return (iv[:B], iv[B:]), jnp.asarray(ov)

                (lo, hi), ov = jax.lax.scan(body, (lo0, hi0), codes)
                iv = jnp.stack([lo, hi], axis=1)
                if r:
                    # tail rounds are chip-local: replicated k=1 table,
                    # this chip's query shard — no collective needed
                    from tpufm.engine.xla import _tail_scan

                    iv = _tail_scan(
                        {
                            "tail_entries": tail[0],
                            "tail_dollar_pos": tail[1],
                            "tail_dollar_base": tail[2],
                            "tail_dollar_block": tail[3],
                        },
                        tail_d,
                        iv,
                        head,
                    )
                return iv, ov

            # Results leave the jit REPLICATED (an 8 B/read all-gather):
            # device_get on a P(axis)-sharded output would span
            # non-addressable devices under multi-process jax.distributed.
            return jax.jit(
                jax.shard_map(
                    search_local,
                    mesh=mesh,
                    in_specs=(
                        P(axis),
                        P(axis),
                        (P(), P(), P()),
                        P(),
                        (P(), P(), P(), P()),
                        P(),
                        P(axis, None),
                    ),
                    out_specs=(P(axis, None), P()),
                ),
                out_shardings=(
                    NamedSharding(mesh, P()),
                    NamedSharding(mesh, P()),
                ),
            )

        self.lut = put_global(np.zeros((1, 2), np.uint32), repl)  # placeholder
        self._search_nolut = make_search(False)
        self._search = make_search(True) if lut_m else self._search_nolut
        if lut_m:
            self.lut = put_global(self._build_lut(lut_m), repl)

    def _build_lut(self, m: int) -> np.ndarray:
        """SA interval of every m-mer, computed with THIS sharded engine
        (wave-chunked over the 4^m codes, LUT-less program). Wave size is
        rounded up to a mesh multiple and the last chunk is padded (4^m may
        not divide by the device count); pad rows are trimmed."""
        from tpufm.engine.xla import decode_prefix_codes

        D = self.mesh.devices.size
        n = 4**m
        wave = -(-min(n, self.WAVE_PER_CHIP * D) // D) * D
        parts = []
        for start in range(0, n, wave):
            codes = np.arange(start, min(start + wave, n), dtype=np.uint32)
            pad = wave - codes.shape[0]
            if pad:
                codes = np.concatenate([codes, np.zeros(pad, np.uint32)])
            q = np.asarray(decode_prefix_codes(jnp.asarray(codes), m))
            out = self._run_wave(q, self._search_nolut)
            parts.append(out[: wave - pad] if pad else out)
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def place_queries(self, queries) -> jax.Array:
        """Place a [B, L] uint8 batch sharded along the mesh's batch axis
        (B must be a mesh multiple)."""
        return put_global(
            np.asarray(queries, np.uint8),
            NamedSharding(self.mesh, P(self.axis, None)),
        )

    def search_device(self, queries_sharded, program=None):
        """Device-resident dispatch: (intervals, overflow_flags) handles,
        no host sync — the benchmarking entry point."""
        return (program or self._search)(
            self.occ, self.bitmaps, self.dollar, self.lut, self.tail,
            _U32(self.bwtsize), queries_sharded,
        )

    def _dispatch_wave(self, queries: np.ndarray, program=None):
        """Async dispatch: returns device handles (no host sync)."""
        return self.search_device(self.place_queries(queries), program)

    def _run_wave(self, queries: np.ndarray, program=None) -> np.ndarray:
        out, overflow = self._dispatch_wave(queries, program)
        #: bool [rounds] — which rounds hit the a2a overflow fallback (all
        #: False for the other routings); diagnostic for capacity tuning
        self.last_overflow_rounds = np.asarray(jax.device_get(overflow))
        return np.asarray(jax.device_get(out))

    def search(self, queries, wave: int | None = None) -> np.ndarray:
        """uint8 [B, L] -> uint32 [B, 2]. A batch not divisible by the mesh
        size is padded by cycling its own reads (trimmed from the answers);
        batches beyond `wave` (default WAVE_PER_CHIP * n_dev) stream in
        padded fixed-shape waves (pipelined 2 deep) so device memory stays
        constant. last_overflow_rounds ORs the a2a fallback flags over
        every wave of the call."""
        from tpufm.utils.waves import pad_cycle, stream_waves

        n = self.mesh.devices.size
        queries = np.asarray(queries, dtype=np.uint8)
        B = queries.shape[0]
        trim = -B % n
        if trim:
            queries = np.concatenate([queries, queries[:trim]])
        wave = wave or self.WAVE_PER_CHIP * n
        wave -= wave % n
        if wave <= 0:
            raise ValueError(f"wave must be >= mesh size {n}")

        overflow = []

        def fetch(handle):
            out, ov = handle
            overflow.append(np.asarray(jax.device_get(ov)))
            return np.asarray(jax.device_get(out))

        # Tail padding cycles the wave's own reads ("cycle") so the padded
        # wave's bucket-skew statistics match real traffic (all-zero pad
        # reads would concentrate in one bucket and force a spurious a2a
        # fallback on the tail wave).
        out = stream_waves(
            queries, wave, self._dispatch_wave, fetch, depth=2,
            pad_mode="cycle",
        )
        if overflow:
            self.last_overflow_rounds = np.logical_or.reduce(overflow)
        return out[:B] if trim else out
