"""Suffix array construction sharded over a device mesh.

The single-device path (tpufm/index/sa_device.py) holds
DEVICE_BUILD_BYTES_PER_BASE bytes/base of sort working set, which caps the
text one device can build. This module shards every prefix-doubling array
along a 1-D mesh so the working set splits across devices: N devices
build an N-times-larger text (the reference's analog is OpenMP threads
inside one node's divsufsort, resources/divsufsort.c:95-123 — it has no
multi-node build).

Formulation (all inside shard_map over axis "data"):

- **Global sort** = local sort per shard (sa_device.lex_sort: radix-sortable
  single-key passes) + `P` unrolled rounds of odd-even block
  transposition: each round pairs neighboring shards, exchanges them with
  `ppermute` (device-link traffic only), merge-splits (sort of the 2m
  concat, keep low/high half). With sorted blocks this sorts any
  input in P rounds (0-1 principle on the block odd-even network).
- **Rank assignment** = global adjacent-difference (1-element boundary
  ppermute) + global cumsum (local cumsum + all_gather of shard totals).
- Each doubling round: shift the rank array left by h (shard-granular
  ppermute + static slice), sort (rank, second, idx) triples, assign new
  ranks, then sort back by idx to restore index-order layout.

Every key tuple includes the position index, so orders are total and no
stable-sort guarantees are needed across the merge network. Pad lanes
carry rank 0xFFFFFFFF and sort behind all real elements.

The produced SA is bit-identical to the host/native/single-device paths
(the suffix array of a sentinel-terminated text is unique); tests
cross-check on an 8-device CPU mesh.
"""

from __future__ import annotations

import numpy as np

_PACK = 10  # symbols per initial key, 3 bits each (matches sa_device.py)

#: compiled-program cache, bounded: one entry per (mesh, shard-geometry);
#: a long-lived process building many differently-sized references would
#: otherwise accumulate jitted programs (and pin their Mesh) forever
_CACHE_MAX = 4
_cache: dict = {}


def _cache_put(cache: dict, key, value):
    cache[key] = value
    while len(cache) > _CACHE_MAX:
        cache.pop(next(iter(cache)))


def make_global_sort(axis: str, nsh: int, m: int):
    """Shard-level global sort over a 1-D mesh axis: local lex_sort plus
    nsh rounds of odd-even block transposition (ppermute shard exchange +
    merge-split). Takes/returns tuples of [m] per-shard arrays; the first
    num_keys arrays are the (unique-total-order) sort keys, the rest ride
    as payload. Reused by the sharded suffix sort and the sharded locate
    sample compaction."""
    import jax
    import jax.numpy as jnp

    from tpufm.index.sa_device import lex_sort

    lax = jax.lax

    def transpose_round(parity, arrs, num_keys):
        pairs = []
        lo = parity
        while lo + 1 < nsh:
            pairs.append((lo, lo + 1))
            lo += 2
        if not pairs:
            return arrs
        perm = []
        partner = list(range(nsh))
        for a, b in pairs:
            perm += [(a, b), (b, a)]
            partner[a], partner[b] = b, a
        # unpaired shards self-send so every device receives data
        for i in range(nsh):
            if partner[i] == i:
                perm.append((i, i))
        myid = lax.axis_index(axis)
        part = jnp.asarray(partner, dtype=jnp.int32)[myid]
        recv = [lax.ppermute(x, axis, perm) for x in arrs]
        both = [jnp.concatenate([x, r]) for x, r in zip(arrs, recv)]
        merged = lex_sort(both, num_keys)
        am_low = myid.astype(jnp.int32) < part
        self_paired = myid.astype(jnp.int32) == part
        out = []
        for x, mg in zip(arrs, merged):
            half = jnp.where(am_low, mg[:m], mg[m:])
            out.append(jnp.where(self_paired, x, half))
        return tuple(out)

    def global_sort(arrs, num_keys):
        arrs = lex_sort(arrs, num_keys)
        for r in range(nsh):
            arrs = transpose_round(r % 2, arrs, num_keys)
        return arrs

    return global_sort


def _programs(mesh, axis: str, m: int, big: int):
    """Build (initial, step(h)) jitted programs for one (mesh, m, big)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    u32 = jnp.uint32
    lax = jax.lax
    nsh = mesh.devices.size
    spec = P(axis)
    shd = NamedSharding(mesh, spec)

    def gidx():
        return lax.axis_index(axis).astype(u32) * u32(m) + lax.iota(u32, m)

    global_sort = make_global_sort(axis, nsh, m)

    def boundary_prev(xs):
        """For each array, the previous global element of each shard's
        first lane (device 0 receives zeros)."""
        perm = [(i, i + 1) for i in range(nsh - 1)]
        return [lax.ppermute(x[m - 1 : m], axis, perm) for x in xs]

    def global_rank_from_sorted(keys, idx):
        """keys: sorted key arrays; -> (rank_sorted u32 [m], distinct bool).

        rank_sorted is the 0-based global rank of each sorted element;
        distinct counts only real lanes (idx < big)."""
        prevs = boundary_prev(list(keys))
        changed = jnp.zeros(m, dtype=u32)
        for kx, pv in zip(keys, prevs):
            pk = jnp.concatenate([pv, kx[: m - 1]])
            changed = changed | (kx != pk).astype(u32)
        myid = lax.axis_index(axis).astype(u32)
        first_global = (myid == u32(0)) & (lax.iota(u32, m) == u32(0))
        changed = jnp.where(first_global, u32(0), changed)
        loc = jnp.cumsum(changed, dtype=u32)
        totals = lax.all_gather(loc[m - 1], axis)  # [nsh]
        offset = jnp.sum(
            jnp.where(jnp.arange(nsh, dtype=u32) < myid, totals, u32(0))
        )
        real = idx < u32(big)
        ndistinct = lax.psum(jnp.sum(jnp.where(real, changed, u32(0))), axis) + u32(1)
        return loc + offset, ndistinct == u32(big)

    def restore_index_order(idx, rank_sorted):
        """Sort (idx, rank) by idx: device p ends with global rows
        [p*m, (p+1)*m) — pads (idx >= big) return to the tail."""
        i2, r2 = global_sort((idx, rank_sorted), num_keys=1)
        myid = lax.axis_index(axis)
        r2 = jnp.where(gidx() < u32(big), r2, u32(0xFFFFFFFF))
        return i2, r2

    def initial_fn(c3):
        """c3 u32 [m]: symbol+1 per lane, 0 at the sentinel and pads.
        -> (rank [m] index-order, sa_candidate [m], distinct)."""
        # neighbor prefix so every lane can read its next _PACK-1 symbols —
        # send only the _PACK boundary lanes, not the whole shard
        perm = [(i + 1, i) for i in range(nsh - 1)]
        nxt = lax.ppermute(c3[:_PACK], axis, perm)
        ext = jnp.concatenate([c3, nxt])
        key = jnp.zeros(m, u32)
        for j in range(_PACK):
            key = (key << u32(3)) | lax.dynamic_slice(ext, (j,), (m,))
        myid = lax.axis_index(axis)
        idx = gidx()
        key = jnp.where(idx < u32(big), key, u32(0xFFFFFFFF))
        skey, sidx = global_sort((key, idx), num_keys=2)
        rank_sorted, distinct = global_rank_from_sorted((skey,), sidx)
        _, rank = restore_index_order(sidx, rank_sorted)
        return rank, sidx, distinct

    def step_fn(rank, h: int):
        """One doubling round at static shift h (index-order rank in/out)."""
        myid = lax.axis_index(axis)
        idx = gidx()
        # second[i] = rank[i+h] + 1 (0 past the text): shard-granular shift
        y = jnp.where(idx < u32(big), rank + u32(1), u32(0))
        q, r = divmod(h, m)
        permA = [(i, i - q) for i in range(q, nsh)]
        recvA = lax.ppermute(y, axis, permA) if q < nsh else jnp.zeros(m, u32)
        if r:
            permB = [(i, i - q - 1) for i in range(q + 1, nsh)]
            recvB = (
                lax.ppermute(y, axis, permB) if q + 1 < nsh else jnp.zeros(m, u32)
            )
            second = jnp.concatenate([recvA[r:], recvB[:r]])
        else:
            second = recvA
        r1, r2, sidx = global_sort((rank, second, idx), num_keys=3)
        rank_sorted, distinct = global_rank_from_sorted((r1, r2), sidx)
        _, new_rank = restore_index_order(sidx, rank_sorted)
        return new_rank, sidx, distinct

    def wrap(f, n_in):
        return jax.jit(
            jax.shard_map(
                f,
                mesh=mesh,
                in_specs=(spec,) * n_in,
                out_specs=(spec, spec, P()),
            )
        )

    initial = wrap(initial_fn, 1)
    steps: dict = {}

    def step_for(h: int):
        if h not in steps:
            steps[h] = wrap(lambda rank, _h=h: step_fn(rank, _h), 1)
        return steps[h]

    return initial, step_for, shd


def suffix_array_sharded_arr(codes, mesh, axis: str = "data"):
    """Sharded SA: uint8 host/device array [n] -> uint32 global array
    [n+1] sharded over `mesh` holding the suffix array of codes + sentinel.

    Multi-process safe: inputs are placed with put_global and every
    collective runs inside shard_map, so the same call works on a
    jax.distributed multi-host mesh."""
    import jax
    import numpy as np_

    from tpufm.parallel.search import put_global

    codes = np_.asarray(jax.device_get(codes), np_.uint8)
    n = int(codes.shape[0])
    big = n + 1
    nsh = mesh.devices.size
    m = -(-big // nsh)
    m = max(m, _PACK)  # neighbor-prefix fetch reads _PACK lanes
    key = (id(mesh), axis, m, big)
    if key not in _cache:
        _cache_put(_cache, key, _programs(mesh, axis, m, big))
    initial, step_for, shd = _cache[key]

    # symbol+1 lanes, 0 sentinel, 0 pads — laid out over the mesh
    c3 = np_.zeros(nsh * m, np_.uint32)
    c3[:n] = codes.astype(np_.uint32) + 1
    c3 = put_global(c3, shd)

    rank, order, distinct = initial(c3)
    h = _PACK
    while not bool(jax.device_get(distinct)) and h < big:
        rank, order, distinct = step_for(h)(rank)
        h *= 2
    return order[:big]


def suffix_array_sharded(
    codes: np.ndarray, mesh=None, axis: str = "data"
) -> np.ndarray:
    """Sharded-build suffix array (host in/out).

    Same contract as tpufm.index.suffix_array.suffix_array: int64 [n+1]
    with result[0] == n. mesh defaults to all local devices."""
    if mesh is None:
        from tpufm.parallel.mesh import make_mesh

        mesh = make_mesh()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.shape[0] == 0:
        return np.zeros(1, dtype=np.int64)
    if int(codes.max()) > 6:
        raise ValueError(
            "sharded suffix array supports symbols in [0, 6] "
            f"(got max {int(codes.max())}); use method='native'"
        )
    order = suffix_array_sharded_arr(codes, mesh, axis)
    return np.asarray(_replicated_get(order, mesh), dtype=np.int64)


def _replicated_get(x, mesh):
    """device_get that works on multi-process meshes: sharded global arrays
    span non-addressable devices there, so replicate through a jit first."""
    import jax

    if jax.process_count() > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        x = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(x)
    return jax.device_get(x)
