"""XLA engine vs NumPy oracle: bit-exact SA intervals on the CPU backend."""

import numpy as np
import pytest

from tpufm.config import IndexConfig
from tpufm.engine.oracle import search_oracle
from tpufm.engine.xla import XLAEngine
from tpufm.index.builder import build_index
from tpufm.index.layouts import make_alt_counters


def _mk(rng, k, d, n):
    cfg = IndexConfig(k=k, d=d)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    index = build_index(codes, cfg, sa_method="doubling")
    return codes, index


@pytest.mark.parametrize("layout", ["fused", "split"])
@pytest.mark.parametrize("k,d", [(1, 32), (1, 64), (2, 64), (3, 32), (4, 32)])
def test_xla_matches_oracle(rng, k, d, layout):
    codes, index = _mk(rng, k, d, 777)
    engine = XLAEngine(index, layout=layout)
    qlen = 4 * k
    starts = rng.integers(0, len(codes) - qlen, size=64)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    misses = rng.integers(0, 4, size=(16, qlen), dtype=np.uint8)
    queries = np.concatenate([queries, misses])
    np.testing.assert_array_equal(engine.search(queries), search_oracle(index, queries))


@pytest.mark.parametrize("k,d", [(1, 32), (2, 64)])
def test_xla_ac_matches_oracle(rng, k, d):
    codes, index = _mk(rng, k, d, 500)
    ac = make_alt_counters(index)
    engine = XLAEngine(ac)
    assert engine.alt_counters
    qlen = 4 * k
    starts = rng.integers(0, len(codes) - qlen, size=48)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    np.testing.assert_array_equal(engine.search(queries), search_oracle(index, queries))


def test_xla_long_queries(rng):
    # 120 bp reads (the reference's standard workload length).
    codes, index = _mk(rng, 2, 64, 5000)
    engine = XLAEngine(index)
    starts = rng.integers(0, len(codes) - 120, size=32)
    queries = np.stack([codes[s : s + 120] for s in starts])
    got = engine.search(queries)
    np.testing.assert_array_equal(got, search_oracle(index, queries))
    # every sampled read must occur at least once
    assert (got[:, 1] > got[:, 0]).all()


@pytest.mark.parametrize("k,lut_m", [(2, 4), (3, 6), (1, 3)])
def test_xla_prefix_lut_matches_oracle(rng, k, lut_m):
    # LUT start: the first lut_m characters collapse into one table lookup.
    codes, index = _mk(rng, k, 32, 900)
    engine = XLAEngine(index, lut_m=lut_m)
    qlen = lut_m + 4 * k
    starts = rng.integers(0, len(codes) - qlen, size=48)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    misses = rng.integers(0, 4, size=(16, qlen), dtype=np.uint8)
    queries = np.concatenate([queries, misses])
    np.testing.assert_array_equal(engine.search(queries), search_oracle(index, queries))


def test_xla_lut_only_queries(rng):
    # queries exactly lut_m long: the whole search is the LUT gather.
    codes, index = _mk(rng, 2, 32, 600)
    engine = XLAEngine(index, lut_m=4)
    starts = rng.integers(0, len(codes) - 4, size=32)
    queries = np.stack([codes[s : s + 4] for s in starts])
    np.testing.assert_array_equal(engine.search(queries), search_oracle(index, queries))


def test_xla_pad_words_matches_oracle(rng):
    codes, index = _mk(rng, 2, 64, 777)
    plain = XLAEngine(index)
    padded = XLAEngine(index, pad_words=128)
    assert padded.tables["entries"].shape[1] == 128
    starts = rng.integers(0, len(codes) - 40, size=48)
    queries = np.stack([codes[s : s + 40] for s in starts])
    np.testing.assert_array_equal(padded.search(queries), plain.search(queries))
    np.testing.assert_array_equal(padded.search(queries), search_oracle(index, queries))


def test_xla_wave_chunking(rng):
    # large batches processed in fixed-size device waves, incl. ragged tail
    codes, index = _mk(rng, 2, 32, 600)
    engine = XLAEngine(index)
    starts = rng.integers(0, len(codes) - 24, size=100)
    queries = np.stack([codes[s : s + 24] for s in starts])
    whole = engine.search(queries)
    waved = engine.search(queries, wave=32)  # 3 full waves + tail of 4
    np.testing.assert_array_equal(whole, waved)


def test_xla_lut_cache_roundtrip(rng, tmp_path):
    codes, index = _mk(rng, 2, 32, 700)
    cache = str(tmp_path / "lut.npz")
    a = XLAEngine(index, lut_m=4, lut_cache=cache)
    import os

    assert os.path.exists(cache)
    b = XLAEngine(index, lut_m=4, lut_cache=cache)  # loads, not rebuilds
    starts = rng.integers(0, len(codes) - 24, size=32)
    queries = np.stack([codes[s : s + 24] for s in starts])
    np.testing.assert_array_equal(a.search(queries), b.search(queries))
    np.testing.assert_array_equal(a.search(queries), search_oracle(index, queries))


def test_xla_lut_cache_size_gated(rng, tmp_path, monkeypatch):
    """LUTs past the persistence ceiling are rebuilt instead of cached
    (an m=15 serving LUT would write an 8.6 GB npz); the engine is still
    bit-exact without the cache file."""
    import os

    from tpufm.engine import xla as xla_mod

    codes, index = _mk(rng, 2, 32, 700)
    cache = str(tmp_path / "big.npz")
    monkeypatch.setattr(xla_mod, "LUT_CACHE_MAX_BYTES", 0)
    eng = XLAEngine(index, lut_m=4, lut_cache=cache)
    assert not os.path.exists(cache)
    starts = rng.integers(0, len(codes) - 24, size=32)
    queries = np.stack([codes[s : s + 24] for s in starts])
    np.testing.assert_array_equal(eng.search(queries),
                                  search_oracle(index, queries))


def test_xla_search_device_waved(rng):
    import jax.numpy as jnp

    codes, index = _mk(rng, 2, 32, 600)
    engine = XLAEngine(index)
    starts = rng.integers(0, len(codes) - 24, size=96)
    queries = np.stack([codes[s : s + 24] for s in starts])
    out = engine.search_device_waved(jnp.asarray(queries), wave=32)
    np.testing.assert_array_equal(np.asarray(out), search_oracle(index, queries))


def test_xla_lut_cache_invalidated_on_index_change(rng, tmp_path):
    # a stale LUT cache from a DIFFERENT index must be rejected, not loaded
    cache = str(tmp_path / "lut.npz")
    codes1, index1 = _mk(rng, 2, 32, 700)
    XLAEngine(index1, lut_m=4, lut_cache=cache)  # writes cache for index1
    codes2, index2 = _mk(rng, 2, 32, 900)        # different reference
    eng2 = XLAEngine(index2, lut_m=4, lut_cache=cache)
    starts = rng.integers(0, len(codes2) - 24, size=32)
    queries = np.stack([codes2[s : s + 24] for s in starts])
    np.testing.assert_array_equal(eng2.search(queries), search_oracle(index2, queries))


def test_xla_lut_cache_path_without_npz_suffix(rng, tmp_path):
    # np.savez appends .npz — the load path must match or the cache never hits
    import os

    codes, index = _mk(rng, 2, 32, 500)
    cache = str(tmp_path / "mylut")  # no .npz
    XLAEngine(index, lut_m=4, lut_cache=cache)
    assert os.path.exists(cache + ".npz")
    # second construction must LOAD (mtime unchanged)
    m0 = os.path.getmtime(cache + ".npz")
    XLAEngine(index, lut_m=4, lut_cache=cache)
    assert os.path.getmtime(cache + ".npz") == m0


@pytest.mark.parametrize("k,d", [(4, 96), (5, 32)])
@pytest.mark.parametrize("layout", ["fused", "split"])
def test_xla_high_k_with_lut(rng, k, d, layout):
    """High-k configs (the gathers/read reducer) with a prefix LUT, both
    layouts — split now supports lut_m and stacks both interval ends."""
    codes, index = _mk(rng, k, d, 3000)
    lut_m = 2 * k  # multiple of k
    engine = XLAEngine(index, layout=layout, lut_m=lut_m)
    qlen = 4 * k
    starts = rng.integers(0, len(codes) - qlen, size=48)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    misses = rng.integers(0, 4, size=(16, qlen), dtype=np.uint8)
    queries = np.concatenate([queries, misses])
    np.testing.assert_array_equal(engine.search(queries), search_oracle(index, queries))


@pytest.mark.parametrize("k,d", [(2, 32), (3, 32), (2, 64)])
def test_xla_paired_matches_oracle(rng, k, d):
    """Paired-row layout (one gather per read) must be bit-exact, including
    reads the LUT cannot narrow — a repetitive text forces wide intervals
    so the standard-path repair wave must fire."""
    # Half random, half a single repeated motif: motif reads keep interval
    # width >> d through many rounds.
    motif = np.tile(rng.integers(0, 4, size=6, dtype=np.uint8), 700)
    codes = np.concatenate([rng.integers(0, 4, size=2800, dtype=np.uint8), motif])
    index = build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling")
    lut_m = 2 * k
    engine = XLAEngine(index, layout="paired", lut_m=lut_m)
    qlen = 4 * k
    starts = rng.integers(0, len(codes) - qlen, size=48)
    queries = np.stack([codes[s : s + qlen] for s in starts])
    motif_reads = np.stack(
        [motif[s : s + qlen] for s in rng.integers(0, 600, size=16)]
    )
    misses = rng.integers(0, 4, size=(16, qlen), dtype=np.uint8)
    queries = np.concatenate([queries, motif_reads, misses])
    out = engine.search(queries)
    np.testing.assert_array_equal(out, search_oracle(index, queries))
    assert engine.last_repair_fraction > 0  # the repair path actually ran


def test_xla_paired_no_repair_on_random_text(rng):
    codes, index = _mk(rng, 3, 32, 5000)
    engine = XLAEngine(index, layout="paired", lut_m=6)
    queries = np.stack(
        [codes[s : s + 12] for s in rng.integers(0, len(codes) - 12, size=64)]
    )
    np.testing.assert_array_equal(
        engine.search(queries), search_oracle(index, queries)
    )
    assert engine.last_repair_fraction == 0.0


def test_xla_paired_requires_lut():
    with pytest.raises(ValueError, match="prefix LUT"):
        from tpufm.engine.xla import make_search_fn

        make_search_fn(2, 64, False, layout="paired", lut_m=0)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_pick_counter_matches_take_along_axis(rng, k):
    """_pick_counter (binary-tree select) must select exactly counters[..., code] for every k — the
    2k halving levels walk code's bits high-to-low at every k; pin that
    down directly rather than only through the engine parity tests."""
    import jax.numpy as jnp

    from tpufm.engine.xla import _pick_counter

    n = 4**k
    counters = rng.integers(0, 2**32, size=(17, 2, n), dtype=np.uint32)
    code = rng.integers(0, n, size=(17,), dtype=np.uint32)
    got = _pick_counter(jnp.asarray(counters), jnp.asarray(code)[:, None], k)
    want = np.take_along_axis(
        counters, code[:, None, None].astype(np.int64), axis=-1
    )[..., 0]
    np.testing.assert_array_equal(np.asarray(got), want)
