"""Multi-chip locate — sampled-SA position resolution scaled over a mesh.

DataParallelLocate replicates the locate tables per chip (they are small
next to the search index: the k=1 LF rows + mark words + samples for a
3 Gbase genome at s=32 are ~2.3 GB, and shrink linearly with sample_rate)
and shards the BWT-row batch along the mesh's batch axis — the same SPMD
shape as DataParallelEngine, so locate throughput scales like search
throughput. The per-row walk is independent, so the only collective is the
all-gather of the resolved positions (4 B/row) at the exit sharding.

The reference has no locate at all (it reports interval counts only,
SURVEY.md section 0); tpufm made locate first-class (tpufm/index/locate.py),
so it scales first-class too.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpufm.engine.xla import build_locate_tables, make_locate_fn
from tpufm.parallel.search import put_global


def _smap(fn, **kw):
    """shard_map with varying-axis checking off: the engine fns mix
    replicated inputs (tables, bwtsize) into per-shard carries, which the
    VMA checker rejects even though the computation is shard-local (same
    pattern as index/builder_sharded.py)."""
    return jax.shard_map(fn, check_vma=False, **kw)


class DataParallelLocate:
    """Replicated-table, row-sharded locate over a 1-D device mesh."""

    #: rows per chip per wave (total wave = WAVE_PER_CHIP * n_dev) — the
    #: same constant-device-memory streaming as the single-chip engine
    WAVE_PER_CHIP = 1 << 18

    def __init__(self, loc, mesh: Mesh):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        repl = NamedSharding(mesh, P())
        put = functools.partial(put_global, sharding=repl)
        self.tables, self.d, self.sample_rate = build_locate_tables(loc, put)
        self.rows_sharding = NamedSharding(mesh, P(self.axis))
        self._locate = jax.jit(
            make_locate_fn(self.d, self.sample_rate), out_shardings=repl
        )

    def place_rows(self, rows) -> jax.Array:
        """Place a uint32 [N] row batch sharded along the mesh's batch axis
        (N must be a mesh multiple)."""
        return put_global(np.asarray(rows, np.uint32), self.rows_sharding)

    def locate_device(self, rows_sharded):
        """Device-resident dispatch (no host sync) — benchmarking entry."""
        return self._locate(self.tables, rows_sharded)

    def locate_rows(self, rows, wave: int | None = None) -> np.ndarray:
        """BWT rows uint32 [N] -> SA values uint32 [N]. N is padded to a
        mesh multiple (row 0 is always valid) and trimmed; batches beyond
        `wave` stream in fixed-shape waves, pipelined 2 deep."""
        from tpufm.utils.waves import pad_cycle, stream_waves

        n = self.mesh.devices.size
        rows = np.asarray(rows, dtype=np.uint32)
        N = rows.shape[0]
        pad = -N % n
        if pad:
            rows = np.concatenate([rows, np.zeros(pad, np.uint32)])
        wave = wave or self.WAVE_PER_CHIP * n
        wave -= wave % n
        out = stream_waves(
            rows,
            max(wave, n),
            lambda r: self._locate(
                self.tables, put_global(r, self.rows_sharding)
            ),
            lambda h: np.asarray(jax.device_get(h)),
            depth=2,
        )
        return out[:N]

    def locate_hits(self, intervals, max_hits: int) -> np.ndarray:
        """uint32 [B, 2] search intervals -> uint32 [B, max_hits] text
        positions, padded with 0xFFFFFFFF past each interval's count.
        Only the lanes inside their interval walk (host-side compaction —
        typical reads fill 1-2 of max_hits lanes)."""
        from tpufm.index.locate import locate_hits_compacted

        return locate_hits_compacted(self.locate_rows, intervals, max_hits)


class DataParallelSearchLocate:
    """Fused search+locate, batch-sharded over a 1-D mesh.

    The single-jit reads->intervals->positions program
    (tpufm.engine.xla.make_search_locate_fn) with both table sets
    replicated and the query batch sharded: each chip searches and walks
    its own shard; the only collective is the all-gather of the replicated
    (intervals, positions) outputs."""

    #: reads per chip per wave — each read carries max_hits walk lanes
    WAVE_PER_CHIP = 1 << 15

    def __init__(self, index, loc, mesh: Mesh, max_hits: int = 4,
                 lut_m: int = 0, lut_cache: str | None = None):
        from tpufm.engine.xla import (
            build_fused_entries,
            make_search_locate_fn,
        )

        self._lut_m = lut_m

        if lut_m and lut_m % index.config.k:
            raise ValueError(
                f"lut_m={lut_m} must be a multiple of k={index.config.k}"
            )
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.config = index.config
        self.bwtsize = index.bwtsize
        self.max_hits = max_hits

        repl = NamedSharding(mesh, P())
        put = functools.partial(put_global, sharding=repl)
        tables = {
            "entries": put(build_fused_entries(index)),
            "dollar_pos": put(index.dollar_pos),
            "dollar_base": put(index.dollar_base),
            "dollar_block": put(np.asarray(index.dollar_block, np.uint32)),
        }
        if lut_m:
            from tpufm.engine.xla import lut_with_cache

            tables["lut"] = lut_with_cache(tables, index, lut_m, lut_cache, put)
        self.tables = tables
        self.loc_tables, loc_d, sample_rate = build_locate_tables(loc, put)
        self._loc_d, self._sample_rate = loc_d, sample_rate
        self.batch_sharding = NamedSharding(mesh, P(self.axis, None))
        # shard_map makes the program per-shard (MANUAL partitioning), so
        # the walk compaction inside (engine/xla.py locate_compacted) is
        # shard-LOCAL — each chip compacts and walks only its own reads'
        # valid lanes; under plain GSPMD the global cumsum/scatter would
        # instead force collectives and a replicated walk.
        ax = self.axis
        self._fused = jax.jit(
            _smap(
                make_search_locate_fn(
                    index.config.k, index.config.d, lut_m, loc_d,
                    sample_rate, max_hits,
                ),
                mesh=mesh,
                in_specs=(P(), P(), P(), P(ax, None)),
                out_specs=(P(ax, None), P(ax, None)),
            ),
            out_shardings=(repl, repl),
        )

    def search_locate(self, queries, wave: int | None = None):
        """reads uint8 [B, L] -> (intervals uint32 [B, 2], positions uint32
        [B, max_hits]). Tail batches pad by cycling their own reads."""
        import jax.numpy as jnp
        from tpufm.utils.waves import pad_cycle, stream_waves

        queries = np.asarray(queries, np.uint8)
        B = queries.shape[0]
        if B == 0:
            return (
                np.zeros((0, 2), np.uint32),
                np.zeros((0, self.max_hits), np.uint32),
            )
        n = self.mesh.devices.size
        wave = wave or self.WAVE_PER_CHIP * n
        wave = max(n, wave - wave % n)
        # Pre-pad to a mesh multiple (stream_waves pads tail waves, but a
        # single sub-wave batch would reach put_global undivided).
        pad = -B % n
        if pad:
            queries = pad_cycle(queries, pad)

        def dispatch(q):
            qd = put_global(q, self.batch_sharding)
            return self._fused(
                self.tables, self.loc_tables, jnp.uint32(self.bwtsize), qd
            )

        out = stream_waves(
            queries,
            wave,
            dispatch,
            lambda h: np.concatenate(
                [np.asarray(jax.device_get(h[0])),
                 np.asarray(jax.device_get(h[1]))], axis=1
            ),
            depth=2,
            pad_mode="cycle",
        )
        out = out[:B]
        return np.ascontiguousarray(out[:, :2]), np.ascontiguousarray(out[:, 2:])

    def _approx_run(self, queries, text, key, wave_default, factory,
                    wave: int | None):
        """Shared driver for locate_approx / locate_edits: cache the jitted
        pass together with ITS OWN replicated packed text under `key` plus
        a FULL CRC32 of `text` (a localized edit between calls must not
        silently verify against stale device words; the CRC costs ~0.3 s/GB
        once per call, amortized over the batch), then shard the batch and
        stream fixed-shape waves."""
        import zlib

        import jax.numpy as jnp

        from tpufm.engine.seed import (
            pack_hits3,
            pack_text_words,
            unpack_hits3,
        )
        from tpufm.utils.waves import pad_cycle, stream_waves

        text = np.asarray(text)
        key = key + (
            text.shape, text.dtype.str,
            zlib.crc32(memoryview(np.ascontiguousarray(text))),
        )
        cache = getattr(self, "_approx_cache", None)
        if cache is None:
            cache = self._approx_cache = {}
        entry = cache.get(key)
        if entry is None:
            if len(cache) >= 4:
                cache.clear()
            words = text if text.dtype == np.uint32 else pack_text_words(text)
            # shard_map: per-shard program, so the seed engines' walk
            # compaction stays shard-local (see _fused)
            ax = self.axis
            entry = cache[key] = (
                jax.jit(
                    _smap(
                        factory(),
                        mesh=self.mesh,
                        in_specs=(P(), P(), P(), P(), P(ax, None)),
                        out_specs=(P(ax, None), P(ax), P(ax)),
                    ),
                    out_shardings=NamedSharding(self.mesh, P()),
                ),
                put_global(words, NamedSharding(self.mesh, P())),
            )
        fn, text_words = entry

        queries = np.asarray(queries, np.uint8)
        B = queries.shape[0]
        mh = self.max_hits
        if B == 0:
            return (
                np.zeros((0, mh), np.uint32),
                np.zeros(0, np.uint32),
                np.zeros(0, bool),
            )
        n = self.mesh.devices.size
        queries = pad_cycle(queries, -B % n)
        wave = wave or wave_default * n
        wave = max(n, wave - wave % n)
        out = stream_waves(
            queries,
            wave,
            lambda q: fn(
                self.tables, self.loc_tables, text_words,
                jnp.uint32(self.bwtsize), put_global(q, self.batch_sharding),
            ),
            pack_hits3,
            depth=2,
            pad_mode="cycle",
        )[:B]
        return unpack_hits3(out, mh)

    def locate_approx(self, queries, text, mismatches: int,
                      seed_hits: int = 32, wave: int | None = None):
        """Seed-and-extend positions at Hamming distance <= mismatches
        (engine/seed.py) over the mesh: the packed text joins the replicated
        table set and the query batch shards — each chip seeds, walks, and
        verifies its own reads. Returns (positions uint32 [B, max_hits],
        counts uint32 [B], overflow bool [B])."""
        from tpufm.engine.seed import SeedExtendEngine, make_seed_extend_fn

        return self._approx_run(
            queries, text, ("hamming", mismatches, seed_hits),
            SeedExtendEngine.WAVE,
            lambda: make_seed_extend_fn(
                self.config.k, self.config.d, self._lut_m, self._loc_d,
                self._sample_rate, mismatches, seed_hits, self.max_hits,
            ),
            wave,
        )

    def locate_edits(self, queries, text, edits: int,
                     seed_hits: int = 32, wave: int | None = None):
        """Edit-distance (indel-aware) alignment sites over the mesh: the
        batch-sharded twin of EditExtendEngine.locate_edits (engine/edit.py
        — pigeonhole seeds + batched Myers verify), with the packed text
        replicated alongside the tables. Returns (starts uint32
        [B, max_hits], counts uint32 [B], overflow bool [B])."""
        from tpufm.engine.edit import EditExtendEngine, make_edit_extend_fn

        return self._approx_run(
            queries, text, ("edits", edits, seed_hits),
            EditExtendEngine.WAVE,
            lambda: make_edit_extend_fn(
                self.config.k, self.config.d, self._lut_m, self._loc_d,
                self._sample_rate, edits, seed_hits, self.max_hits,
            ),
            wave,
        )

    def locate_mismatch(self, queries, wave: int | None = None) -> np.ndarray:
        """Positions of Hamming<=1 hits over the mesh: uint8 [B, L] ->
        uint32 [B, max_hits] (0xFFFFFFFF padded) — the batch-sharded twin of
        SearchLocateEngine.locate_mismatch (same single-jit variant fan-out
        + in-register compaction, each chip handling its query shard)."""
        import jax.numpy as jnp
        from tpufm.utils.waves import pad_cycle, stream_waves

        queries = np.asarray(queries, np.uint8)
        B = queries.shape[0]
        if B == 0:
            return np.zeros((0, self.max_hits), np.uint32)
        L = queries.shape[1]
        if not hasattr(self, "_mm"):
            from tpufm.engine.xla import make_mismatch_locate_fn

            self._mm = jax.jit(
                _smap(
                    make_mismatch_locate_fn(
                        self.config.k, self.config.d, self._lut_m,
                        self._loc_d, self._sample_rate, self.max_hits,
                    ),
                    mesh=self.mesh,
                    in_specs=(P(), P(), P(), P(self.axis, None)),
                    out_specs=P(self.axis, None),
                ),
                out_shardings=NamedSharding(self.mesh, P()),
            )
        n = self.mesh.devices.size
        pad = -B % n
        if pad:
            queries = pad_cycle(queries, pad)
        wave = max(1, (1 << 20) // (3 * L + 1)) * n
        return stream_waves(
            queries,
            wave,
            lambda q: self._mm(
                self.tables, self.loc_tables, jnp.uint32(self.bwtsize),
                put_global(q, self.batch_sharding),
            ),
            lambda h: np.asarray(jax.device_get(h)),
            depth=2,
            pad_mode="cycle",
        )[:B]
