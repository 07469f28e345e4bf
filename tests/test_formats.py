"""Roundtrip tests for the .fmi formats (tags 100/101/200/201) and the
native .npz persistence: write -> read -> identical search results."""

import numpy as np
import pytest

from tpufm.config import IndexConfig, Layout
from tpufm.engine.oracle import search_oracle
from tpufm.index.builder import build_index
from tpufm.index.formats import write_fmi, read_fmi, save_npz, load_npz
from tpufm.index.layouts import (
    make_alt_counters,
    interleave_bitmap_words,
    deinterleave_bitmap_words,
)


@pytest.mark.parametrize("layout", list(Layout))
@pytest.mark.parametrize("k,d", [(1, 64), (2, 64), (2, 32), (3, 32)])
def test_fmi_roundtrip(tmp_path, rng, layout, k, d):
    cfg = IndexConfig(k=k, d=d, layout=layout)
    codes = rng.integers(0, 4, size=333, dtype=np.uint8)
    index = build_index(codes, cfg, sa_method="doubling")
    path = tmp_path / "idx.fmi"
    write_fmi(path, index, layout)
    loaded, got_layout = read_fmi(path)
    assert got_layout == layout

    queries = np.stack([codes[s : s + 2 * k] for s in range(0, 40, 3)])
    expected = search_oracle(index, queries)
    np.testing.assert_array_equal(search_oracle(loaded, queries), expected)


def test_fmi_roundtrip_divisible(tmp_path, rng):
    # bwtsize % d == 0 exercises the end-of-text reconstruction paths.
    for layout in (Layout.BASELINE, Layout.ALT_COUNTERS):
        cfg = IndexConfig(k=2, d=32, layout=layout)
        codes = rng.integers(0, 4, size=95, dtype=np.uint8)  # bwtsize=96=3*32
        index = build_index(codes, cfg, sa_method="doubling")
        path = tmp_path / f"idx-{layout.value}.fmi"
        write_fmi(path, index, layout)
        loaded, _ = read_fmi(path)
        queries = np.stack([codes[s : s + 4] for s in range(0, 30, 3)])
        np.testing.assert_array_equal(
            search_oracle(loaded, queries), search_oracle(index, queries)
        )


def test_npz_roundtrip(tmp_path, rng):
    cfg = IndexConfig(k=2, d=64)
    codes = rng.integers(0, 4, size=500, dtype=np.uint8)
    index = build_index(codes, cfg, sa_method="doubling")
    path = tmp_path / "idx.npz"
    save_npz(path, index)
    loaded = load_npz(path)
    np.testing.assert_array_equal(loaded.occ, index.occ)
    np.testing.assert_array_equal(loaded.bitmaps, index.bitmaps)
    np.testing.assert_array_equal(loaded.dollar_pos, index.dollar_pos)
    assert loaded.bwtsize == index.bwtsize
    assert loaded.config == cfg


def test_interleave_is_involution(rng):
    cfg = IndexConfig(k=2, d=64)
    codes = rng.integers(0, 4, size=300, dtype=np.uint8)
    index = build_index(codes, cfg, sa_method="doubling")
    il = interleave_bitmap_words(index.bitmaps)
    np.testing.assert_array_equal(deinterleave_bitmap_words(il), index.bitmaps)
    # word-order spot check: flat interleaved word (2k)*w + 2s + p == old [s, p, w]
    k, nb = cfg.k, cfg.words_per_plane
    flat = il[0].reshape(-1)
    for w in range(nb):
        for s in range(k):
            for p in range(2):
                assert flat[(2 * k) * w + 2 * s + p] == index.bitmaps[0, s, p, w]


def test_fmi_header_fields(tmp_path, rng):
    cfg = IndexConfig(k=2, d=64)
    codes = rng.integers(0, 4, size=200, dtype=np.uint8)
    index = build_index(codes, cfg, sa_method="doubling")
    path = tmp_path / "idx.fmi"
    write_fmi(path, index, Layout.BASELINE)
    raw = np.fromfile(path, dtype="<u4")
    # tag, steps, bwtsize, ncounters, nentries, chunk, dollarPos[k], dollarBase[k]
    assert raw[0] == 100
    assert raw[1] == 2
    assert raw[2] == 201
    assert raw[3] == 16
    assert raw[4] == index.nentries
    assert raw[5] == 64
    np.testing.assert_array_equal(raw[6:8], index.dollar_pos)
    np.testing.assert_array_equal(raw[8:10], index.dollar_base)
    # entry 0: 8 bitmap words then 16 counters
    entry0 = raw[10 : 10 + 24]
    np.testing.assert_array_equal(entry0[:8], index.bitmaps[0].reshape(-1))
    np.testing.assert_array_equal(entry0[8:], index.occ[0])


def test_recommend_config():
    from tpufm.config import recommend_config, search_bytes

    # no reported limit: no capacity-driven choice at any size
    for refsize in (10_000_000, 750_000_000, 3_200_000_000):
        assert recommend_config(refsize) == {"k": 3, "d": 192, "lut_m": 12}
    assert recommend_config(10_000_000, serving=True)["lut_m"] == 12
    # d=320 only when the d=192 table does not fit the device
    limit = search_bytes(1_000_000_000, 3, 192, 12)
    assert recommend_config(1_000_000_000, bytes_limit=limit)["d"] == 192
    assert recommend_config(1_000_000_001 + 192 * 4, bytes_limit=limit)["d"] == 320
    # k must divide the query length
    assert recommend_config(10_000_000, query_len=8)["k"] == 2
    assert recommend_config(10_000_000, query_len=100)["lut_m"] == 12
    # serving=True opts into lut15 when it fits and divides the length
    big = 60 << 30
    assert recommend_config(10_000_000, serving=True, bytes_limit=big)["lut_m"] == 15
    assert recommend_config(750_000_000, serving=True, bytes_limit=big)["lut_m"] == 15
    # capacity bound: no lut15 co-residency when table + LUT overflow
    small = search_bytes(750_000_000, 3, 192, 12)
    assert recommend_config(750_000_000, serving=True, bytes_limit=small)["lut_m"] == 12
    # k=2 cannot use a 15-mer LUT (15 % 2 != 0)
    assert recommend_config(
        10_000_000, query_len=100, serving=True, bytes_limit=big
    )["lut_m"] == 12


def test_encoding_matches_reference_bit_tricks():
    # reference src/genFMindex.c:71-84 maps EVERY byte via bit tricks;
    # parity must hold on non-ACGT input too (e.g. 'N' -> 2)
    from tpufm.utils.encoding import encode_bases

    def ref_base2index(base):
        flg2 = base & 0x02
        flg3 = flg2 ^ 0x02
        bit1 = base & 0x04
        bit0 = flg3 if bit1 else flg2
        return (bit1 | bit0) >> 1

    got = encode_bases(bytes(range(256)))
    expect = [ref_base2index(b) for b in range(256)]
    assert got.tolist() == expect
    assert encode_bases(b"ACGTacgtN").tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 2]


def test_search_stats_math():
    from tpufm.utils.profiling import search_stats

    s = search_stats(
        seconds_per_pass=2.0, num_reads=1000, read_len=120, k=3,
        entry_bytes=352, hbm_bw=1e9,
    )
    assert s["reads_per_s"] == 500
    assert s["rounds_per_s"] == 500 * 40
    assert s["gathers_per_s"] == 1000 * 40  # 2 ends x 40 rounds x 500 reads/s
    assert abs(s["fraction_of_hbm_sol"] - 1000 * 40 * 352 / 1e9) < 1e-12


@pytest.mark.parametrize("n", [777, 895])  # 895: bwtsize % 64 == 0 corner
def test_ac_image_reconstructs_full_occ(tmp_path, rng, n):
    # loading a tag-200 image must yield a COMPLETE base index (full occ),
    # not a zeros-occ husk that silently corrupts any baseline-engine use
    from tpufm.engine.xla import XLAEngine

    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    built = build_index(codes, IndexConfig(k=2, d=64), sa_method="doubling")
    path = tmp_path / f"recon_{n}.fmi.ac"
    write_fmi(path, built, Layout.ALT_COUNTERS)
    loaded, _ = read_fmi(path)
    np.testing.assert_array_equal(loaded.base.occ, built.occ)
    starts = rng.integers(0, n - 16, size=32)
    queries = np.stack([codes[s : s + 16] for s in starts])
    np.testing.assert_array_equal(
        XLAEngine(loaded.base).search(queries), search_oracle(built, queries)
    )
