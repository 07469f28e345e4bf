"""Multi-device tests on the 8-device virtual CPU mesh: data-parallel
(replicated index) and sharded-index (collective lookup routing) engines must
be bit-exact vs the oracle."""

import jax
import numpy as np
import pytest

from tpufm.config import IndexConfig
from tpufm.engine.oracle import search_oracle
from tpufm.index.builder import build_index
from tpufm.index.layouts import make_alt_counters
from tpufm.parallel import make_mesh, DataParallelEngine, ShardedIndexEngine


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def _mk(rng, k, d, n=4096):
    cfg = IndexConfig(k=k, d=d)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    return codes, build_index(codes, cfg, sa_method="doubling")


@pytest.mark.parametrize("k,d", [(1, 64), (2, 64)])
def test_data_parallel_matches_oracle(rng, mesh, k, d):
    codes, index = _mk(rng, k, d)
    engine = DataParallelEngine(index, mesh)
    qlen = 12 * k
    starts = rng.integers(0, len(codes) - qlen, size=56)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    queries = np.concatenate(
        [queries, rng.integers(0, 4, size=(8, qlen), dtype=np.uint8)]
    )  # 64 = 8 devices x 8
    np.testing.assert_array_equal(
        engine.search(queries), search_oracle(index, queries)
    )


def test_data_parallel_ac(rng, mesh):
    codes, index = _mk(rng, 2, 64)
    ac = make_alt_counters(index)
    engine = DataParallelEngine(ac, mesh)
    starts = rng.integers(0, len(codes) - 24, size=64)
    queries = np.stack([codes[s : s + 24] for s in starts])
    np.testing.assert_array_equal(
        engine.search(queries), search_oracle(index, queries)
    )


def test_data_parallel_pads_ragged_batch(rng, mesh):
    # A batch not divisible by the mesh size is padded by cycling and the
    # answers trimmed — the CLI contract (shard_queries itself still raises).
    codes, index = _mk(rng, 2, 64, n=512)
    engine = DataParallelEngine(index, mesh)
    qlen = 24
    starts = rng.integers(0, len(codes) - qlen, size=30)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    from tpufm.engine.oracle import search_oracle

    out = engine.search(queries)
    assert out.shape == (30, 2)
    np.testing.assert_array_equal(out, search_oracle(index, queries))
    with pytest.raises(ValueError, match="not divisible"):
        engine.shard_queries(np.zeros((30, 8), np.uint8))


@pytest.mark.parametrize("routing", ["allgather", "ring", "a2a"])
@pytest.mark.parametrize("k,d", [(1, 32), (2, 64)])
def test_sharded_index_matches_oracle(rng, mesh, k, d, routing):
    codes, index = _mk(rng, k, d, n=8192)
    engine = ShardedIndexEngine(index, mesh, routing=routing)
    qlen = 12 * k
    starts = rng.integers(0, len(codes) - qlen, size=56)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    queries = np.concatenate(
        [queries, rng.integers(0, 4, size=(8, qlen), dtype=np.uint8)]
    )
    np.testing.assert_array_equal(
        engine.search(queries), search_oracle(index, queries)
    )


@pytest.mark.parametrize("routing", ["allgather", "ring", "a2a"])
def test_sharded_index_small_table(rng, mesh, routing):
    # Fewer entries than devices: padding must keep lookups correct.
    codes, index = _mk(rng, 2, 64, n=200)  # 4 entries on 8 devices
    engine = ShardedIndexEngine(index, mesh, routing=routing)
    starts = rng.integers(0, len(codes) - 8, size=32)
    queries = np.stack([codes[s : s + 8] for s in starts])
    np.testing.assert_array_equal(
        engine.search(queries), search_oracle(index, queries)
    )


def test_data_parallel_with_lut(rng):
    import numpy as np
    from tpufm.config import IndexConfig
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.builder import build_index
    from tpufm.parallel import make_mesh, DataParallelEngine

    codes = rng.integers(0, 4, size=800, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=32), sa_method="doubling")
    mesh = make_mesh(4)
    eng = DataParallelEngine(index, mesh, lut_m=4)
    starts = rng.integers(0, 800 - 24, size=64)
    queries = np.stack([codes[s : s + 24] for s in starts])
    np.testing.assert_array_equal(eng.search(queries), search_oracle(index, queries))


def test_multichip_bench_smoke():
    from tpufm.bench import run_bench_multichip

    rec = run_bench_multichip(
        refsize=50_000, num_queries=512, query_len=24, k=2, d=64,
        iterations=1, lut_m=4, n_devices=4,
    )
    assert rec["detail"]["bit_exact_vs_oracle"]
    assert rec["detail"]["devices"] == 4


@pytest.mark.parametrize("routing", ["allgather", "ring", "a2a"])
def test_sharded_index_with_lut_and_waves(rng, mesh, routing):
    # The upgraded design point: prefix LUT (built with the sharded engine
    # itself) + wave streaming with a tail wave needing padding.
    codes, index = _mk(rng, 2, 64, n=8192)
    engine = ShardedIndexEngine(index, mesh, routing=routing, lut_m=4)
    qlen = 24
    starts = rng.integers(0, len(codes) - qlen, size=150)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    queries = np.concatenate(
        [queries, rng.integers(0, 4, size=(10, qlen), dtype=np.uint8)]
    )  # 160 reads, streamed as 3 waves of 64 (tail padded)
    np.testing.assert_array_equal(
        engine.search(queries, wave=64), search_oracle(index, queries)
    )


def test_sharded_ring_odd_local_batch(rng, mesh):
    # Odd per-chip batch exercises the half-block padding in the
    # double-buffered ring.
    codes, index = _mk(rng, 2, 64, n=4096)
    engine = ShardedIndexEngine(index, mesh, routing="ring")
    starts = rng.integers(0, len(codes) - 8, size=24)  # 3 rows/chip -> halves pad
    queries = np.stack([codes[s : s + 8] for s in starts])
    np.testing.assert_array_equal(
        engine.search(queries), search_oracle(index, queries)
    )


@pytest.mark.skipif(
    "not config.getoption('--scale', default=False) and "
    "not __import__('os').environ.get('TPUFM_SCALE_TESTS')",
    reason="set TPUFM_SCALE_TESTS=1 (several minutes: 100 Mbase build)",
)
def test_sharded_index_at_scale(rng, mesh):
    """Sharded mode at its design point — a
    >=100 Mbase index sharded over the 8-device mesh (per-device shard ~41MB
    = a real fraction of the table), prefix LUT, wave streaming, both
    routings, verified against the oracle on sampled reads."""
    import json
    import time

    n = 100_000_000
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    cfg = IndexConfig(k=3, d=128)
    t0 = time.time()
    index = build_index(codes, cfg)
    build_s = time.time() - t0

    qlen, B = 120, 4096
    starts = rng.integers(0, n - qlen, size=B - 64)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    queries = np.concatenate(
        [queries, rng.integers(0, 4, size=(64, qlen), dtype=np.uint8)]
    )
    expect = search_oracle(index, queries)

    rec = {"refsize": n, "k": 3, "d": 128, "entries": index.nentries,
           "devices": 8, "build_s": round(build_s, 1), "routings": {}}
    for routing in ("allgather", "ring", "a2a"):
        eng = ShardedIndexEngine(index, mesh, routing=routing, lut_m=6)
        t0 = time.time()
        out = eng.search(queries, wave=1024)  # 4 waves stream through
        dt = time.time() - t0
        np.testing.assert_array_equal(out, expect)
        rec["routings"][routing] = {
            "seconds": round(dt, 2), "bit_exact": True,
            "shard_rows": eng.e_local,
            "shard_mb": round(eng.e_local * (cfg.bitmap_words + 64) * 4 / 2**20, 1),
        }
    print(json.dumps(rec))


def test_sharded_a2a_overflow_fallback(rng, mesh):
    # Identical queries concentrate every request in one bucket: the a2a
    # fast path must detect overflow and fall back, staying bit-exact.
    codes, index = _mk(rng, 2, 64, n=4096)
    engine = ShardedIndexEngine(index, mesh, routing="a2a")
    q = np.repeat(codes[100:124][None, :], 64, axis=0)
    np.testing.assert_array_equal(
        engine.search(q), search_oracle(index, q)
    )


def test_sharded_wave_too_small_raises(rng, mesh):
    codes, index = _mk(rng, 2, 64, n=512)
    engine = ShardedIndexEngine(index, mesh)
    with pytest.raises(ValueError, match="wave must be"):
        engine.search(np.zeros((64, 8), np.uint8), wave=4)


def test_sharded_tiny_lut_on_large_mesh(rng, mesh):
    # 4^1 = 4 LUT codes on an 8-device mesh: the LUT build must pad its
    # wave to a mesh multiple and trim, not crash at sharding.
    codes, index = _mk(rng, 1, 32, n=2048)
    engine = ShardedIndexEngine(index, mesh, routing="a2a", lut_m=1)
    starts = rng.integers(0, len(codes) - 8, size=32)
    q = np.stack([codes[s : s + 8] for s in starts])
    np.testing.assert_array_equal(engine.search(q), search_oracle(index, q))


def test_data_parallel_search_locate(rng):
    # Fused search+locate over the mesh == single-chip fused engine,
    # including a batch not divisible by the mesh and an absent pattern.
    from tpufm.engine.xla import SearchLocateEngine
    from tpufm.index.locate import build_locate
    from tpufm.index.suffix_array import suffix_array
    from tpufm.parallel import DataParallelSearchLocate, make_mesh

    codes = rng.integers(0, 4, size=6000, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=16, d=64, sa=sa)

    qlen = 8
    starts = rng.integers(0, 6000 - qlen, size=43)
    queries = np.stack([codes[st : st + qlen] for st in starts])
    queries[-1] = np.array([0, 1, 2, 3] * 2, dtype=np.uint8)

    mesh = make_mesh(8)
    dp = DataParallelSearchLocate(index, loc, mesh, max_hits=8, lut_m=2)
    iv_m, pos_m = dp.search_locate(queries, wave=16)

    ref = SearchLocateEngine(index, loc, max_hits=8, lut_m=2)
    iv_s, pos_s = ref.search_locate(queries)
    np.testing.assert_array_equal(iv_m, iv_s)
    np.testing.assert_array_equal(pos_m, pos_s)


@pytest.mark.parametrize("routing", ["allgather", "ring", "a2a"])
def test_collective_traffic_model(rng, mesh, routing):
    """The compiled sharded-search program carries exactly the collective
    shapes the DISTRIBUTED.md byte model predicts (12 B/end requests,
    4 B answers, 8 B/read exit merge)."""
    from tpufm.parallel import assert_collective_model

    codes, index = _mk(rng, 2, 64, n=40000)
    from tpufm.io.genreads import generate_reads

    q = generate_reads(codes, 24, 512, seed=1)
    eng = ShardedIndexEngine(index, mesh, routing=routing)
    r = assert_collective_model(eng, eng.place_queries(q))
    model = r["model"]
    D, B = 8, 2 * (512 // 8)
    if routing == "allgather":
        assert model["sent"] == 16 * B * (D - 1)
        assert model["answered_rows"] == D * B
    elif routing == "ring":
        assert model["sent"] == 16 * B * D
    else:
        assert model["sent"] == 16 * (2 * B // D) * D
        assert model["answered_rows"] == 2 * B


def test_collective_traffic_model_a2a_ragged_batch(rng, mesh):
    """D not dividing 2B: the implementation rounds bucket capacity UP
    (ceil), and the model must match — a 520-read batch on 8 devices
    compiles u32[1,33,3] buckets, not u32[1,32,3]."""
    from tpufm.parallel import assert_collective_model

    codes, index = _mk(rng, 2, 64, n=40000)
    from tpufm.io.genreads import generate_reads

    q = generate_reads(codes, 24, 520, seed=1)
    eng = ShardedIndexEngine(index, mesh, routing="a2a")
    assert_collective_model(eng, eng.place_queries(q))


def test_collective_model_mesh1_no_collectives(rng):
    """XLA elides every collective on a 1-device mesh; the contract check
    must accept that instead of demanding ops that cannot exist."""
    from tpufm.parallel import assert_collective_model

    codes, index = _mk(rng, 2, 64)
    from tpufm.io.genreads import generate_reads

    q = generate_reads(codes, 24, 64, seed=1)
    m1 = make_mesh(1)
    for eng in (DataParallelEngine(index, m1),
                ShardedIndexEngine(index, m1, routing="a2a")):
        assert_collective_model(
            eng,
            eng.shard_queries(q) if hasattr(eng, "shard_queries")
            else eng.place_queries(q),
        )


def test_collective_traffic_model_dp(rng, mesh):
    """Data-parallel search must have NO collectives beyond the result
    merge — zero communication during the LF rounds."""
    from tpufm.parallel import assert_collective_model

    codes, index = _mk(rng, 2, 64)
    from tpufm.io.genreads import generate_reads

    q = generate_reads(codes, 24, 512, seed=1)
    dp = DataParallelEngine(index, mesh)
    assert_collective_model(dp, dp.shard_queries(q))


def test_collective_model_detects_missing_op():
    """The HLO-shape checker actually fails when an expected collective is
    absent (guard against the assertion degenerating into a no-op)."""
    from tpufm.parallel.traffic import _collective_shapes

    fake = """
      %all_gather.1 = u32[8,128,3]{2,1,0} all-gather(%x), channel_id=1
      %psum.2 = u32[8,128]{1,0} all-reduce(%y), channel_id=2
      %nothing = u32[4]{0} add(%a, %b)
    """
    shapes = _collective_shapes(fake)
    assert ("all-gather", "u32[8,128,3]") in shapes
    assert ("all-reduce", "u32[8,128]") in shapes
    assert len(shapes) == 2
