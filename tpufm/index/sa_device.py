"""Suffix array construction ON the accelerator: parallel prefix doubling.

The reference parallelizes its suffix sort with OpenMP threads inside
divsufsort (reference resources/divsufsort.c:95-123). Here it runs on the
device instead: Manber-Myers prefix doubling where every round is a
device-wide stable sort of (rank[i], rank[i+h]) key pairs plus a vectorized
rank recompression — O(n log n) work, every step fully parallel, no host
round-trips except a 1-scalar early-exit check per round.

Each round sorts the pairs with lex_sort: stable single-key sorts (by
rank[i+h], then by rank[i]) in the least-significant-key-first order of a
radix sort. A single-key sort of a key and one payload is what XLA hands
to a radix sort on the GPU, where a two-key sort takes the generic
comparison sort.

The initial rank covers 10 symbols at once (2-bit codes + sentinel packed
3 bits each into a uint32), so a random DNA text needs only 2-4 doubling
rounds after the first sort (h: 10 -> 20 -> 40 -> ...); repetitive texts
degrade gracefully to ceil(log2(n/10)) rounds.

Memory: about DEVICE_BUILD_BYTES_PER_BASE bytes per base at the peak of a
round; texts that would not fit the device's allocator limit are refused
up front (check_device_build_fits). The host SA-IS path
(tpufm/index/suffix_array.py) has no size limit.

The produced SA is bit-identical to the host paths by construction (the
suffix array of a text with a unique sentinel is unique); tests cross-check
against native SA-IS and the NumPy doubling oracle.
"""

from __future__ import annotations

import logging
import time

import numpy as np

log = logging.getLogger(__name__)

#: peak device bytes per base of a doubling round: rank, the shifted rank,
#: the index and the sorts' outputs and scratch, all uint32 of n+1.
#: Measured 41.1 B/base at 750 Mbase on an H100; the bound keeps a margin
DEVICE_BUILD_BYTES_PER_BASE = 48


def device_build_fits(n: int, device=None) -> bool:
    """Whether an n-base device build fits the device's allocator limit;
    a device that reports no limit always fits."""
    from tpufm.config import device_bytes_limit

    limit = device_bytes_limit(device)
    return limit is None or n * DEVICE_BUILD_BYTES_PER_BASE <= limit


def check_device_build_fits(n: int, device=None) -> None:
    """Raise ValueError when an n-base device build would not fit."""
    from tpufm.config import device_bytes_limit

    if not device_build_fits(n, device):
        limit = device_bytes_limit(device)
        raise ValueError(
            f"text of {n} bases needs ~{n * DEVICE_BUILD_BYTES_PER_BASE} "
            f"device bytes to build, over the device's limit of {limit}; "
            "use the host path (method='native') or a mesh build"
        )


_PACK = 10  # symbols per initial uint32 key (3 bits each)


def lex_sort(operands, num_keys: int):
    """lax.sort(operands, num_keys) over 1-D uint32 arrays, as stable
    single-key sorts of one key and an index, least-significant key
    first; ties beyond the keys keep their input order. Every sort is
    the key-and-one-payload shape that XLA hands to a radix sort on the
    GPU."""
    import jax
    import jax.numpy as jnp

    if len(operands) == 2 and num_keys == 1:
        return tuple(jax.lax.sort(tuple(operands), num_keys=1, is_stable=True))
    perm = None
    for key in reversed(operands[:num_keys]):
        if perm is None:
            key, perm = key, jnp.arange(key.shape[0], dtype=jnp.uint32)
        else:
            key = key[perm]
        first, perm = jax.lax.sort((key, perm), num_keys=1, is_stable=True)
    # the last pass sorted the primary key itself: no gather for it
    return (first,) + tuple(a[perm] for a in operands[1:])


def _build_steps():
    import jax
    import jax.numpy as jnp

    u32 = jnp.uint32

    @jax.jit
    def initial(codes):
        """codes uint8 [n] -> (rank [n+1] u32 over _PACK-symbol prefixes,
        order [n+1] u32, distinct bool)."""
        n = codes.shape[0]
        big = n + 1
        t = jnp.concatenate(
            [codes.astype(u32) + 1, jnp.zeros(_PACK, u32)]
        )  # sentinel + pad, symbols in 3 bits
        key = jnp.zeros(big, u32)
        for j in range(_PACK):
            key = (key << u32(3)) | jax.lax.dynamic_slice(t, (j,), (big,))
        idx = jnp.arange(big, dtype=u32)
        skey, order = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
        changed = jnp.concatenate(
            [jnp.zeros(1, u32), (skey[1:] != skey[:-1]).astype(u32)]
        )
        rank_sorted = jnp.cumsum(changed, dtype=u32)
        rank = jnp.zeros(big, u32).at[order].set(rank_sorted, unique_indices=True)
        distinct = rank_sorted[-1] == u32(big - 1)
        return rank, order, distinct

    @jax.jit
    def step(rank, h):
        """One doubling round: rank over h-prefixes -> rank over 2h-prefixes."""
        big = rank.shape[0]
        second = jnp.where(
            jnp.arange(big, dtype=u32) + h < u32(big),
            jnp.roll(rank, -h.astype(jnp.int32)),
            u32(0xFFFFFFFF),  # past-end: strictly larger than any rank+1
        )
        # shift ranks +1 so past-end can instead be 0 (smaller than all):
        # the reference point: suffixes shorter than h+h sort FIRST among
        # equal first-h ranks, because their extension is the sentinel.
        second = jnp.where(second == u32(0xFFFFFFFF), u32(0), second + u32(1))
        idx = jnp.arange(big, dtype=u32)
        r1, r2, order = lex_sort((rank, second, idx), num_keys=2)
        changed = jnp.concatenate(
            [
                jnp.zeros(1, u32),
                ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(u32),
            ]
        )
        rank_sorted = jnp.cumsum(changed, dtype=u32)
        new_rank = jnp.zeros(big, u32).at[order].set(
            rank_sorted, unique_indices=True
        )
        distinct = rank_sorted[-1] == u32(big - 1)
        return new_rank, order, distinct

    return initial, step


_steps = None


def suffix_array_device_arr(codes_dev):
    """Device-resident SA: uint8 device array [n] -> uint32 device array
    [n+1] (stays on device — the device builder consumes it in place).

    Symbols must be in [0, 6]: the initial rank packs symbol+1 into 3 bits
    (callers with host arrays get this validated in suffix_array_device;
    the device builder's normalize_reference guarantees 2-bit codes)."""
    global _steps
    import jax
    import jax.numpy as jnp

    n = codes_dev.shape[0]
    check_device_build_fits(n, next(iter(codes_dev.devices())))
    if n == 0:
        return jnp.zeros(1, jnp.uint32)
    if _steps is None:
        _steps = _build_steps()
    initial, step = _steps

    t0 = time.perf_counter()
    rank, order, distinct = initial(codes_dev)
    h = _PACK
    # Host-driven loop with a 1-scalar early-exit fetch per round: random
    # DNA finishes in 2-4 rounds; ceil(log2(n/_PACK)) bounds the worst case
    # (once 2h >= n+1 every prefix contains the sentinel, so ranks must be
    # distinct and the loop exits). The fetch also ends each round's timing.
    while not bool(jax.device_get(distinct)) and h < n + 1:
        log.info("sa round h=%d n=%d: %.6f s", h, n, time.perf_counter() - t0)
        t0 = time.perf_counter()
        rank, order, distinct = step(rank, jnp.uint32(h))
        h *= 2
    log.info("sa round h=%d n=%d: %.6f s", h, n, time.perf_counter() - t0)
    return order


def suffix_array_device(codes: np.ndarray, device=None) -> np.ndarray:
    """Suffix array of codes + sentinel, built on the accelerator.

    Same contract as tpufm.index.suffix_array.suffix_array: returns int64
    [n+1] with result[0] == n.
    """
    import jax
    import jax.numpy as jnp

    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.shape[0] == 0:
        return np.zeros(1, dtype=np.int64)
    if int(codes.max()) > 6:
        # the initial rank packs symbol+1 into 3 bits; larger alphabets
        # would silently corrupt adjacent symbols' key bits
        raise ValueError(
            "device suffix array supports symbols in [0, 6] "
            f"(got max {int(codes.max())}); use method='native'/'doubling'"
        )
    cd = jax.device_put(jnp.asarray(codes), device)
    order = suffix_array_device_arr(cd)
    return np.asarray(jax.device_get(order), dtype=np.int64)
