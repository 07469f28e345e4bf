"""k-step FM-index construction ON the accelerator.

The reference builds its index entirely on the host (a 10 h SLURM envelope
at 1.5 Gbase, reference scripts/slurm_genindexes.sh:27, with only the suffix
sort OpenMP-parallel); tpufm's host builder (tpufm/index/builder.py) already
cuts that to minutes. This module moves the whole pipeline onto the device:

  suffix array     — parallel prefix doubling (tpufm/index/sa_device.py)
  k BWT levels     — k device gathers  BWT_i[j] = T[(SA[j] - 1 - i) mod N]
  bitmaps          — vectorized bit-plane packing (32-way shift-or)
  Occ counters     — derived FROM the packed bitmaps by popcount-match per
                     k-mer (the searcher's own rank primitive), then
                     corrected for the k '$' positions and the tail padding —
                     no 250M-element scatter, no km array
  Cb accumulation  — on host (4^k scalars)

Output is bit-identical to tpufm.index.builder.build_index (asserted by
tests/test_builder_device.py across k/d/edge cases), which is itself
byte-exact vs the reference gfmiBaseLine binaries.

With `return_host=False` the occ/bitmap tables stay on the device and can
feed an engine directly — reference-scale index construction with no
host round-trip at all.
"""

from __future__ import annotations

import numpy as np

from tpufm.config import IndexConfig
from tpufm.index.builder import KStepFMIndex, normalize_reference
from tpufm.index.sa_device import check_device_build_fits, suffix_array_device_arr


def _build_tables(k: int, d: int):
    """Jitted (per shape) device pipeline: (codes [n] u8, order [n+1] u32)
    -> (occ_counts [E, 4^k] u32 WITHOUT corrections, bitmaps [E+1, k, 2, nb]
    u32, dollar_pos [k] u32)."""
    import jax
    import jax.numpy as jnp

    u32 = jnp.uint32
    C = 4**k
    nb = d // 32

    @jax.jit
    def tables(codes, order):
        n = codes.shape[0]
        big = n + 1
        E = -(-big // d)
        t = jnp.concatenate([codes, jnp.zeros(1, jnp.uint8)])  # '$' read as 'A'

        # dollar_pos[i] = rank of suffix i (position of '$' in BWT level i).
        (small_j,) = jnp.nonzero(order < u32(k), size=k)
        dollar_pos = jnp.zeros(k, u32).at[order[small_j]].set(
            small_j.astype(u32)
        )

        # BWT levels via SA gathers; pad to E*d positions with 'A' (code 0),
        # matching the host builder's zero padding.
        pad = E * d - big
        levels = []
        for i in range(k):
            prev = (order + u32(big - 1 - i)) % u32(big)
            lv = t[prev]
            levels.append(jnp.concatenate([lv, jnp.zeros(pad, jnp.uint8)]))

        # Bit-plane packing, MSB-first within each 32-base window
        # (reference src/genFMindex.c:402-424). Sentinel row E is zero.
        bitmaps = jnp.zeros((E + 1, k, 2, nb), u32)
        for i in range(k):
            win = levels[i].reshape(E, nb, 32)
            for plane in range(2):
                bits = ((win >> plane) & 1).astype(u32)
                w = jnp.zeros((E, nb), u32)
                for j in range(32):
                    w |= bits[:, :, j] << u32(31 - j)
                bitmaps = bitmaps.at[:E, i, plane, :].set(w)

        # Per-block counts FROM the bitmaps: counts[e, c] = popcount-match of
        # k-mer c over block e (the searcher's rank primitive, full window).
        bm = bitmaps[:E]  # [E, k, 2, nb]
        counts = []
        for c in range(C):
            m = jnp.full((E, nb), u32(0xFFFFFFFF))
            for i in range(k):
                p0 = bm[:, i, 0, :]
                p1 = bm[:, i, 1, :]
                m &= (p0 if (c >> (2 * i)) & 1 else ~p0) & (
                    p1 if (c >> (2 * i + 1)) & 1 else ~p1
                )
            counts.append(
                jnp.sum(
                    jax.lax.population_count(m).astype(jnp.int32), axis=1
                ).astype(u32)
            )
        occ_counts = jnp.stack(counts, axis=1)  # [E, C]
        return occ_counts, bitmaps, dollar_pos

    return tables


_cache: dict = {}


def build_index_device(
    reference,
    config: IndexConfig = IndexConfig(),
    return_host: bool = True,
    device=None,
    sa_dev=None,
    codes_dev=None,
) -> KStepFMIndex:
    """Build a k-step FM-index entirely on the accelerator.

    Same result as tpufm.index.builder.build_index (bit-identical), built
    with device-parallel primitives. return_host=False leaves occ/bitmaps as
    device arrays inside the returned KStepFMIndex (feed them straight to an
    engine — no device->host->device round trip). sa_dev / codes_dev:
    optional precomputed device suffix array (uint32 [n+1]) and device text
    (uint8 [n]) so several indexes / locate tables share one suffix sort
    and ONE text upload.
    """
    import jax
    import jax.numpy as jnp

    codes = normalize_reference(reference)
    k, d = config.k, config.d
    n = int(codes.shape[0])
    check_device_build_fits(n, device)
    big = n + 1
    C = config.num_counters
    E = config.num_entries(big)

    if codes_dev is None:
        codes_dev = jax.device_put(jnp.asarray(codes, jnp.uint8), device)
    cd = codes_dev
    order = suffix_array_device_arr(cd) if sa_dev is None else sa_dev
    if order.shape[0] != big:
        raise ValueError(f"sa_dev has {order.shape[0]} entries, expected {big}")

    key = (k, d)
    if key not in _cache:
        _cache[key] = _build_tables(k, d)
    occ_counts, bitmaps, dollar_pos_d = _cache[key](cd, order)

    # Corrections + Cb on host (k + 4^k scalars; reference
    # src/genFMindex.c:237-250 semantics via tpufm/index/builder.py).
    dollar_pos = np.asarray(jax.device_get(dollar_pos_d), np.uint32)
    # dollar_base[m] = fused k-mer at dollar_pos[m] with '$' read as 'A' —
    # read straight out of the packed bitmaps (k tiny row fetches).
    dollar_base = np.zeros(k, np.uint32)
    bm_host_rows = np.asarray(
        jax.device_get(bitmaps[(dollar_pos // np.uint32(d)).astype(np.int32)])
    )  # [k, k, 2, nb] rows containing each dollar position
    for m in range(k):
        off = int(dollar_pos[m]) % d
        w, b = off // 32, 31 - (off % 32)
        code = 0
        for i in range(k):
            b0 = (int(bm_host_rows[m, i, 0, w]) >> b) & 1
            b1 = (int(bm_host_rows[m, i, 1, w]) >> b) & 1
            code |= (b0 | (b1 << 1)) << (2 * i)
        dollar_base[m] = code

    # counts corrections: each '$' position was counted as its 'A'-encoded
    # k-mer; the tail padding (E*d - big positions) was counted as k-mer 0.
    # Applied as k+1 point scatters ON device (an [E, C] host correction
    # array would re-upload ~334 MB at genome scale).
    for m in range(k):
        occ_counts = occ_counts.at[
            int(dollar_pos[m]) // d, int(dollar_base[m])
        ].add(np.uint32(0xFFFFFFFF))  # -1 in uint32
    pad = E * d - big
    if pad:
        occ_counts = occ_counts.at[E - 1, 0].add(np.uint32(-pad & 0xFFFFFFFF))

    # occ = exclusive per-block prefix + sentinel row, then Cb.
    occ = jnp.concatenate(
        [jnp.zeros((1, C), jnp.uint32), jnp.cumsum(occ_counts, axis=0, dtype=jnp.uint32)]
    )
    totals = np.asarray(jax.device_get(occ[-1]), np.int64)
    acc = np.zeros(C, np.int64)
    acc[1:] = np.cumsum(totals)[:-1]
    for i in range(k):
        masked = int(dollar_base[i]) & ~((1 << (2 * i)) - 1)
        acc[masked:] += 1
    occ = occ + jnp.asarray(acc.astype(np.uint32))

    if return_host:
        occ = np.asarray(jax.device_get(occ))
        bitmaps = np.asarray(jax.device_get(bitmaps))
    return KStepFMIndex(
        config=config,
        bwtsize=big,
        occ=occ,
        bitmaps=bitmaps,
        dollar_pos=dollar_pos,
        dollar_base=dollar_base,
    )


def _pack_bits_words(bits_u32):
    """[E, nb, 32] 0/1 uint32 -> [E, nb] words, MSB-first (the same packing
    _build_tables uses for the BWT bit-planes)."""
    import jax.numpy as jnp

    w = jnp.zeros(bits_u32.shape[:2], jnp.uint32)
    for j in range(32):
        w |= bits_u32[:, :, j] << jnp.uint32(31 - j)
    return w


def _locate_tables(d: int, sample_rate: int, n_sampled: int):
    """Jitted (per shape) mark/sample table pipeline: order [big] u32 ->
    (samples [n_sampled], mark_words [E+1, nb], mark_rank [E+1])."""
    import jax
    import jax.numpy as jnp

    nb = d // 32

    @jax.jit
    def tables(order):
        big = order.shape[0]
        E = -(-big // d)
        marked = (order % jnp.uint32(sample_rate)) == 0  # [big] bool
        (sample_pos,) = jnp.nonzero(marked, size=n_sampled)  # ascending p
        samples = order[sample_pos]

        # Pack mark bits per block (MSB-first 32-base windows, zero-padded
        # tail + zero sentinel row — the host builder's packing).
        pad = E * d - big
        mbits = jnp.concatenate(
            [marked.astype(jnp.uint32), jnp.zeros(pad, jnp.uint32)]
        ).reshape(E, nb, 32)
        words = _pack_bits_words(mbits)
        mark_words = jnp.concatenate([words, jnp.zeros((1, nb), jnp.uint32)])

        per_block = jnp.sum(
            jax.lax.population_count(words).astype(jnp.int32), axis=1
        ).astype(jnp.uint32)
        mark_rank = jnp.concatenate(
            [jnp.zeros(1, jnp.uint32), jnp.cumsum(per_block, dtype=jnp.uint32)]
        )
        return samples, mark_words, mark_rank

    return tables


_locate_cache: dict = {}


def build_locate_device(
    reference,
    sample_rate: int = 32,
    d: int = 128,
    return_host: bool = True,
    device=None,
    sa_dev=None,
):
    """Build locate tables (sampled SA + mark bitmaps + k=1 LF index) on the
    accelerator — bit-identical to tpufm.index.locate.build_locate, sharing
    ONE device suffix sort with the k=1 index build (pass sa_dev to share
    it with further index builds too)."""
    import jax
    import jax.numpy as jnp

    from tpufm.index.locate import LocateIndex

    codes = normalize_reference(reference)
    n = int(codes.shape[0])
    big = n + 1
    # ONE text upload + one suffix sort shared with the k=1 index build.
    cd = jax.device_put(jnp.asarray(codes, jnp.uint8), device)
    order = suffix_array_device_arr(cd) if sa_dev is None else sa_dev

    lf1 = build_index_device(
        codes, IndexConfig(k=1, d=d), return_host=return_host,
        device=device, sa_dev=order, codes_dev=cd,
    )
    E = lf1.occ.shape[0] - 1
    nb = d // 32

    n_sampled = -(-big // sample_rate)  # count of multiples of s in [0, big)
    key = (d, sample_rate, n_sampled)
    if key not in _locate_cache:
        _locate_cache[key] = _locate_tables(d, sample_rate, n_sampled)
    samples, mark_words, mark_rank = _locate_cache[key](order)

    if return_host:
        import numpy as _np

        samples = _np.asarray(jax.device_get(samples))
        mark_words = _np.asarray(jax.device_get(mark_words))
        mark_rank = _np.asarray(jax.device_get(mark_rank))
    return LocateIndex(
        lf1=lf1,
        sample_rate=sample_rate,
        mark_words=mark_words,
        mark_rank=mark_rank,
        samples=samples,
    )
