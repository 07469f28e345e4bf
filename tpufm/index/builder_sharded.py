"""k-step FM-index construction sharded over a device mesh.

build_index_device (single device) holds the full suffix-sort working set
plus all k BWT levels and both output tables in one device's memory, which
caps the text it can build (check_device_build_fits).
This pipeline shards every O(n) stage along a 1-D mesh:

  suffix array — distributed prefix doubling (tpufm/index/sa_sharded.py)
  BWT levels   — per-shard gathers from the replicated 2-bit text
                 (1 byte/base, the only replicated O(n) array)
  bitmaps      — per-shard bit-plane packing of d-aligned blocks
  Occ counts   — per-shard popcount-match per k-mer (the searcher's own
                 rank primitive, as in builder_device.py)

The shard boundary is d-aligned (shard length is a multiple of d), so
blocks never straddle devices and the packing/count stages need no
neighbor communication at all; the only collectives are the suffix sort's
and one [k]-scalar psum for the dollar positions. Host finalization
(corrections, exclusive prefix, Cb) is O(E * 4^k) and reuses the exact
semantics of builder_device.py:151-192 (reference src/genFMindex.c:237-250).

Output is bit-identical to tpufm.index.builder.build_index (asserted by
tests/test_builder_sharded.py), which is itself byte-exact vs the
reference gfmiBaseLine binaries.
"""

from __future__ import annotations

import numpy as np

from tpufm.config import IndexConfig
from tpufm.index.builder import KStepFMIndex, normalize_reference

_cache: dict = {}


def _table_program(mesh, axis: str, k: int, d: int, m: int, big: int):
    """shard_map program: (order_l [m] u32 padded, codes [n] u8 replicated)
    -> (occ_rows [E_pad, C] u32 FINAL exclusive-prefix+Cb rows (zeros past
    row E), final_row [C] u32 replicated (the sentinel row E),
    bitmaps [E_pad, k, 2, nb] u32, dollar_pos [k] u32, dollar_base [k] u32).

    The whole finalization (dollar-base read-back, '$'/tail-pad
    corrections, two-level exclusive prefix, Cb accumulation — reference
    src/genFMindex.c:237-250 semantics) runs in-shard: nothing but tiny
    replicated scalars ever needs the host, so return_host=False hands the
    tables straight to a sharded engine."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    u32 = jnp.uint32
    lax = jax.lax
    C = 4**k
    nb = d // 32
    eloc = m // d
    E = -(-big // d)
    nsh = mesh.devices.size

    def fn(order_l, codes):
        myid = lax.axis_index(axis).astype(u32)
        gpos = myid * u32(m) + lax.iota(u32, m)
        real = gpos < u32(big)
        t = jnp.concatenate([codes, jnp.zeros(1, jnp.uint8)])  # '$' as 'A'

        # dollar_pos[i] = global SA rank of suffix i (one psum of k scalars)
        dollar_pos = lax.psum(
            jnp.sum(
                jnp.where(
                    (order_l[:, None] == jnp.arange(k, dtype=u32)[None, :])
                    & real[:, None],
                    gpos[:, None],
                    u32(0),
                ),
                axis=0,
            ),
            axis,
        )

        # BWT levels: lv_i[j] = T[(SA[j] - 1 - i) mod big], 0 past the text.
        # Branch instead of (order + big-1-i) % big: that sum reaches ~2*big
        # and would wrap uint32 for texts past 2^31 bases — exactly the
        # >single-chip scale this builder exists for.
        levels = []
        for i in range(k):
            back = u32(1 + i)
            prev = jnp.where(
                order_l >= back, order_l - back, order_l + (u32(big) - back)
            )
            # index with uint32 (int32 would overflow past 2^31 bases)
            lv = t[jnp.where(real, prev, u32(0))]
            levels.append(jnp.where(real, lv, jnp.uint8(0)))

        # Bit-plane packing, MSB-first 32-base windows
        # (reference src/genFMindex.c:402-424)
        bitmaps = jnp.zeros((eloc, k, 2, nb), u32)
        for i in range(k):
            win = levels[i].reshape(eloc, nb, 32)
            for plane in range(2):
                bits = ((win >> plane) & 1).astype(u32)
                w = jnp.zeros((eloc, nb), u32)
                for j in range(32):
                    w |= bits[:, :, j] << u32(31 - j)
                bitmaps = bitmaps.at[:, i, plane, :].set(w)

        # Per-block counts from the packed planes (popcount-match per k-mer)
        counts = []
        for c in range(C):
            msk = jnp.full((eloc, nb), u32(0xFFFFFFFF))
            for i in range(k):
                p0 = bitmaps[:, i, 0, :]
                p1 = bitmaps[:, i, 1, :]
                msk &= (p0 if (c >> (2 * i)) & 1 else ~p0) & (
                    p1 if (c >> (2 * i + 1)) & 1 else ~p1
                )
            counts.append(
                jnp.sum(
                    lax.population_count(msk).astype(jnp.int32), axis=1
                ).astype(u32)
            )
        occ_counts = jnp.stack(counts, axis=1)  # [eloc, C]

        # ---- On-device finalization -------------------------------------
        start_blk = myid * u32(eloc)
        blkid = start_blk + lax.iota(u32, eloc)

        # dollar_base[i]: the fused k-mer at dollar_pos[i], read back from
        # the packed planes by whichever shard owns that block (psum merge).
        dollar_base = jnp.zeros(k, u32)
        for i_ in range(k):
            dp = dollar_pos[i_]
            g = dp // u32(d)
            off = dp % u32(d)
            w = (off // u32(32)).astype(jnp.int32)
            b = u32(31) - (off % u32(32))
            mine = (g >= start_blk) & (g < start_blk + u32(eloc))
            lb = jnp.where(mine, g - start_blk, u32(0)).astype(jnp.int32)
            code = u32(0)
            for lvl in range(k):
                p0 = bitmaps[lb, lvl, 0, w]
                p1 = bitmaps[lb, lvl, 1, w]
                bit = ((p0 >> b) & u32(1)) | (((p1 >> b) & u32(1)) << u32(1))
                code |= bit << u32(2 * lvl)
            dollar_base = dollar_base.at[i_].set(
                lax.psum(jnp.where(mine, code, u32(0)), axis)
            )

        # Pad blocks (global id >= E) contribute nothing.
        occ_counts = jnp.where((blkid < u32(E))[:, None], occ_counts, u32(0))
        # '$' positions were counted as their 'A'-encoded k-mer; the
        # in-block tail pad (E*d - big zeros) was counted as k-mer 0.
        for i_ in range(k):
            g = dollar_pos[i_] // u32(d)
            mine = (g >= start_blk) & (g < start_blk + u32(eloc))
            lb = jnp.where(mine, g - start_blk, u32(eloc)).astype(jnp.int32)
            occ_counts = occ_counts.at[
                lb, dollar_base[i_].astype(jnp.int32)
            ].add(u32(0xFFFFFFFF), mode="drop")
        pad = E * d - big
        if pad:
            g_last = (E - 1) // eloc  # owning shard of block E-1
            lb = jnp.where(
                myid == u32(g_last), u32((E - 1) % eloc), u32(eloc)
            ).astype(jnp.int32)
            occ_counts = occ_counts.at[lb, 0].add(
                u32(-pad & 0xFFFFFFFF), mode="drop"
            )

        # Two-level exclusive prefix over blocks + Cb accumulation.
        inc = jnp.cumsum(occ_counts, axis=0, dtype=u32)  # [eloc, C]
        tots = lax.all_gather(inc[-1], axis)  # [nsh, C]
        offset = jnp.sum(
            jnp.where((jnp.arange(nsh, dtype=u32) < myid)[:, None], tots, u32(0)),
            axis=0,
        )
        totals = jnp.sum(tots, axis=0)  # [C] replicated
        acc = jnp.concatenate(
            [jnp.zeros(1, u32), jnp.cumsum(totals, dtype=u32)[:-1]]
        )
        for i_ in range(k):
            masked = dollar_base[i_] & ~u32((1 << (2 * i_)) - 1)
            acc = acc + (jnp.arange(C, dtype=u32) >= masked).astype(u32)
        occ_rows = offset[None] + (inc - occ_counts) + acc[None]
        occ_rows = jnp.where((blkid < u32(E))[:, None], occ_rows, u32(0))
        final_row = totals + acc

        return occ_rows, final_row, bitmaps, dollar_pos, dollar_base

    spec = P(axis)
    kw = dict(
        mesh=mesh, in_specs=(spec, P()), out_specs=(spec, P(), spec, P(), P())
    )
    return jax.jit(jax.shard_map(fn, check_vma=False, **kw))


def build_index_sharded(
    reference,
    config: IndexConfig = IndexConfig(),
    mesh=None,
    axis: str = "data",
    sa_dev=None,
    return_host: bool = True,
) -> KStepFMIndex:
    """Build a k-step FM-index with every O(n) stage sharded over `mesh`.

    Same result as tpufm.index.builder.build_index (bit-identical). The
    per-chip working set is ~(sort arrays + k levels + table shards)/P plus
    the replicated 1-byte text, so an N-chip mesh builds an ~N-times-larger
    text than build_index_device. sa_dev: optional global device suffix
    array (uint32 [n+1], e.g. from suffix_array_sharded_arr) to share one
    sort across builds.

    return_host=False keeps occ/bitmaps as GLOBAL SHARDED device arrays —
    the tables never touch the host, so an index larger than any single
    memory (host or chip) can go straight into ShardedIndexEngine.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpufm.index.sa_sharded import _replicated_get, suffix_array_sharded_arr
    from tpufm.parallel.search import put_global

    if mesh is None:
        from tpufm.parallel.mesh import make_mesh

        mesh = make_mesh()

    codes = normalize_reference(reference)
    k, d = config.k, config.d
    n = int(codes.shape[0])
    big = n + 1
    C = config.num_counters
    nb = config.words_per_plane
    E = config.num_entries(big)
    nsh = mesh.devices.size
    m = d * (-(-big // (nsh * d)))  # d-aligned shard length
    e_pad = nsh * (m // d)

    codes_dev = put_global(codes, NamedSharding(mesh, P()))
    order = (
        suffix_array_sharded_arr(codes, mesh, axis)
        if sa_dev is None
        else sa_dev
    )
    if order.shape[0] != big:
        raise ValueError(f"sa_dev has {order.shape[0]} entries, expected {big}")

    # Re-lay the SA onto the d-aligned table sharding (pads read as 0).
    # Inside a jit with explicit out_shardings, so the move is a GSPMD
    # collective — multi-process safe (no local->global device_put).
    op = jax.jit(
        lambda o: jnp.pad(o.astype(jnp.uint32), (0, nsh * m - big)),
        out_shardings=NamedSharding(mesh, P(axis)),
    )(order)

    key = (id(mesh), axis, k, d, m, big)
    if key not in _cache:
        from tpufm.index.sa_sharded import _cache_put

        _cache_put(_cache, key, _table_program(mesh, axis, k, d, m, big))
    occ_rows_g, final_row_d, bitmaps_g, dollar_pos_d, dollar_base_d = _cache[
        key
    ](op, codes_dev)

    dollar_pos = np.asarray(jax.device_get(dollar_pos_d), np.uint32)
    dollar_base = np.asarray(jax.device_get(dollar_base_d), np.uint32)

    if return_host:
        occ = np.zeros((E + 1, C), np.uint32)
        occ[:E] = np.asarray(_replicated_get(occ_rows_g, mesh), np.uint32)[:E]
        occ[E] = np.asarray(jax.device_get(final_row_d), np.uint32)
        bm = np.asarray(_replicated_get(bitmaps_g, mesh), np.uint32)[:E]
        bitmaps = np.concatenate([bm, np.zeros((1, k, 2, nb), np.uint32)])
    else:
        # Assemble the global sharded tables on device (one GSPMD relayout
        # each) — the tables never exist on the host. Rows are padded from
        # E+1 up to a mesh multiple so the row axis shards evenly; the pad
        # rows are zero and unreachable (block indexes never exceed E), and
        # ShardedIndexEngine's own padding becomes a no-op.
        shard_rows = NamedSharding(mesh, P(axis))
        rows_pad = nsh * (-(-(E + 1) // nsh))
        occ = jax.jit(
            lambda o, fr: jnp.concatenate(
                [o[:E], fr[None], jnp.zeros((rows_pad - E - 1, C), jnp.uint32)]
            ),
            out_shardings=shard_rows,
        )(occ_rows_g, final_row_d)
        bitmaps = jax.jit(
            lambda b: jnp.concatenate(
                [b[:E], jnp.zeros((rows_pad - E, k, 2, nb), jnp.uint32)]
            ),
            out_shardings=shard_rows,
        )(bitmaps_g)

    return KStepFMIndex(
        config=config,
        bwtsize=big,
        occ=occ,
        bitmaps=bitmaps,
        dollar_pos=dollar_pos,
        dollar_base=dollar_base,
    )


_locate_cache: dict = {}


def _locate_program(mesh, axis: str, d: int, m: int, big: int, s: int):
    """shard_map program for the sharded locate tables: order_l [m] u32
    (padded) -> (mark_words [E_pad, nb] u32, per_block [E_pad] u32,
    samples_sorted [nsh*m] u32 — SA values of marked positions compacted to
    the front in BWT-position order)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpufm.index.sa_sharded import make_global_sort

    u32 = jnp.uint32
    lax = jax.lax
    nb = d // 32
    eloc = m // d
    nsh = mesh.devices.size
    global_sort = make_global_sort(axis, nsh, m)

    def fn(order_l):
        myid = lax.axis_index(axis).astype(u32)
        gpos = myid * u32(m) + lax.iota(u32, m)
        real = gpos < u32(big)
        marked = real & ((order_l % u32(s)) == 0)

        # mark bitmaps: MSB-first 32-position windows, d-aligned blocks
        mbits = marked.astype(u32).reshape(eloc, nb, 32)
        words = jnp.zeros((eloc, nb), u32)
        for j in range(32):
            words |= mbits[:, :, j] << u32(31 - j)
        per_block = jnp.sum(
            lax.population_count(words).astype(jnp.int32), axis=1
        ).astype(u32)

        # samples: compact marked SA values to the front in p order via the
        # same merge network the suffix sort uses (pads key 0xFFFFFFFF)
        key = jnp.where(marked, gpos, u32(0xFFFFFFFF))
        _, samples = global_sort((key, order_l), num_keys=1)
        return words, per_block, samples

    spec = P(axis)
    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec, spec)
        )
    )


def build_locate_sharded(
    reference,
    sample_rate: int = 32,
    d: int = 128,
    mesh=None,
    axis: str = "data",
    sa_dev=None,
):
    """Build locate tables with every O(n) stage sharded over `mesh` —
    bit-identical to tpufm.index.locate.build_locate. One sharded suffix
    sort is shared between the k=1 LF index and the mark/sample tables."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpufm.index.locate import LocateIndex
    from tpufm.index.sa_sharded import _replicated_get, suffix_array_sharded_arr

    if mesh is None:
        from tpufm.parallel.mesh import make_mesh

        mesh = make_mesh()

    codes = normalize_reference(reference)
    n = int(codes.shape[0])
    big = n + 1
    nsh = mesh.devices.size
    m = d * (-(-big // (nsh * d)))
    nb = d // 32
    E = -(-big // d)

    order = (
        suffix_array_sharded_arr(codes, mesh, axis)
        if sa_dev is None
        else sa_dev
    )
    lf1 = build_index_sharded(
        codes, IndexConfig(k=1, d=d), mesh, axis, sa_dev=order
    )

    op = jax.jit(
        lambda o: jnp.pad(o.astype(jnp.uint32), (0, nsh * m - big)),
        out_shardings=NamedSharding(mesh, P(axis)),
    )(order)

    key = (id(mesh), axis, d, m, big, sample_rate)
    if key not in _locate_cache:
        from tpufm.index.sa_sharded import _cache_put

        _cache_put(
            _locate_cache, key, _locate_program(mesh, axis, d, m, big, sample_rate)
        )
    words_g, per_block_g, samples_g = _locate_cache[key](op)

    n_sampled = -(-big // sample_rate)  # multiples of sample_rate in [0, big)
    mark_words = np.zeros((E + 1, nb), np.uint32)
    mark_words[:E] = np.asarray(_replicated_get(words_g, mesh), np.uint32)[:E]
    per_block = np.asarray(_replicated_get(per_block_g, mesh), np.int64)[:E]
    mark_rank = np.zeros(E + 1, np.uint32)
    mark_rank[1:] = np.cumsum(per_block).astype(np.uint32)
    samples = np.asarray(_replicated_get(samples_g, mesh), np.uint32)[:n_sampled]

    return LocateIndex(
        lf1=lf1,
        sample_rate=sample_rate,
        mark_words=mark_words,
        mark_rank=mark_rank,
        samples=samples,
    )
