"""locate() extension: sampled-SA position resolution (beyond the reference,
which only reports interval counts)."""

import numpy as np
import pytest

from tpufm.config import IndexConfig
from tpufm.engine.oracle import search_oracle
from tpufm.index.builder import build_index
from tpufm.index.locate import build_locate, locate_oracle, locate_hits
from tpufm.index.suffix_array import suffix_array


def naive_positions(text: np.ndarray, pattern: np.ndarray):
    t, p = text.tobytes(), pattern.tobytes()
    out, start = [], 0
    while True:
        i = t.find(p, start)
        if i < 0:
            return sorted(out)
        out.append(i)
        start = i + 1


@pytest.mark.parametrize("s,d", [(4, 32), (32, 64), (7, 32)])
def test_locate_oracle_resolves_every_row(rng, s, d):
    codes = rng.integers(0, 4, size=1200, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    loc = build_locate(codes, sample_rate=s, d=d, sa=sa)
    rows = np.arange(len(codes) + 1, dtype=np.uint32)
    got = locate_oracle(loc, rows)
    np.testing.assert_array_equal(got, sa.astype(np.uint32))


def test_locate_hits_match_naive(rng):
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=16, d=64, sa=sa)

    qlen = 6
    starts = rng.integers(0, 3000 - qlen, size=24)
    queries = np.stack([codes[st : st + qlen] for st in starts])
    iv = search_oracle(index, queries)
    pos = locate_hits(loc, iv, max_hits=32)
    for q, (lo, hi), row in zip(queries, iv, pos):
        expect = naive_positions(codes, q)[:32]
        got = sorted(int(x) for x in row if x != 0xFFFFFFFF)
        assert got == expect, (q.tolist(), lo, hi)


def test_locate_engine_matches_oracle(rng):
    from tpufm.engine.xla import LocateEngine

    codes = rng.integers(0, 4, size=2000, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    loc = build_locate(codes, sample_rate=8, d=32, sa=sa)
    eng = LocateEngine(loc)
    rows = np.arange(len(codes) + 1, dtype=np.uint32)
    np.testing.assert_array_equal(eng.locate_rows(rows), sa.astype(np.uint32))

    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    qlen = 8
    starts = rng.integers(0, 2000 - qlen, size=16)
    queries = np.stack([codes[st : st + qlen] for st in starts])
    iv = search_oracle(index, queries)
    np.testing.assert_array_equal(
        eng.locate_hits(iv, max_hits=16), locate_hits(loc, iv, max_hits=16)
    )


def test_build_locate_accepts_text_input(rng):
    # str/bytes/ASCII inputs must be normalized exactly like build_index
    codes = rng.integers(0, 4, size=400, dtype=np.uint8)
    text = bytes(b"ACGT"[c] for c in codes)
    loc_txt = build_locate(text, sample_rate=8, d=32, sa_method="doubling")
    loc_codes = build_locate(codes, sample_rate=8, d=32, sa_method="doubling")
    np.testing.assert_array_equal(loc_txt.samples, loc_codes.samples)


def test_locate_engine_rejects_non_k1():
    from tpufm.engine.xla import LocateEngine
    from tpufm.index.locate import LocateIndex

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=300, dtype=np.uint8)
    k2 = build_index(codes, IndexConfig(k=2, d=32), sa_method="doubling")
    bogus = LocateIndex(lf1=k2, sample_rate=8,
                        mark_words=np.zeros((1, 1), np.uint32),
                        mark_rank=np.zeros(1, np.uint32),
                        samples=np.zeros(1, np.uint32))
    with pytest.raises(ValueError, match="k=1"):
        LocateEngine(bogus)


def test_locate_rows_wave_streaming(rng):
    # Batches beyond one wave must stream in padded fixed-shape waves and
    # agree with the single-shot path.
    from tpufm.engine.xla import LocateEngine
    from tpufm.index.locate import build_locate

    codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
    loc = build_locate(codes, sample_rate=8, d=32)
    eng = LocateEngine(loc)
    rows = rng.integers(0, 5001, size=300, dtype=np.uint32)
    np.testing.assert_array_equal(
        eng.locate_rows(rows, wave=128), eng.locate_rows(rows)
    )


def test_data_parallel_locate_matches_oracle(rng):
    """Replicated-table, row-sharded locate over the 8-device virtual mesh
    (locate must scale like search)."""
    import jax

    from tpufm.parallel import make_mesh, DataParallelLocate

    codes = rng.integers(0, 4, size=30000, dtype=np.uint8)
    loc = build_locate(codes, sample_rate=16, d=64)
    mesh = make_mesh(len(jax.devices()))
    eng = DataParallelLocate(loc, mesh)

    # Row count NOT divisible by the mesh size: pad-and-trim path.
    rows = rng.integers(0, 30001, size=1003, dtype=np.uint32)
    np.testing.assert_array_equal(eng.locate_rows(rows), locate_oracle(loc, rows))

    # Wave streaming (several waves) stays exact.
    np.testing.assert_array_equal(
        eng.locate_rows(rows, wave=256), locate_oracle(loc, rows)
    )

    # locate_hits parity with the single-chip engine.
    from tpufm.engine.xla import XLAEngine
    from tpufm.index.builder import build_index
    from tpufm.config import IndexConfig
    from tpufm.io.genreads import generate_reads

    index = build_index(codes, IndexConfig(k=2, d=64))
    queries = generate_reads(codes, 24, 40, seed=5)
    iv = XLAEngine(index).search(queries)
    from tpufm.engine.xla import LocateEngine

    np.testing.assert_array_equal(
        eng.locate_hits(iv, max_hits=8), LocateEngine(loc).locate_hits(iv, 8)
    )


def test_bench_locate_record():
    from tpufm.bench import run_bench_locate

    rec = run_bench_locate(
        refsize=20000, d=64, sample_rate=8, num_rows=2048, iterations=1
    )
    assert rec["unit"] == "positions/s"
    assert rec["detail"]["bit_exact_vs_oracle"]
    assert rec["detail"]["devices"] == 8


def test_search_locate_fused_matches_two_pass(rng):
    # The fused single-jit engine must equal search + locate_hits exactly,
    # including absent patterns (empty intervals) and wave-boundary padding.
    from tpufm.engine.xla import SearchLocateEngine, XLAEngine, LocateEngine

    codes = rng.integers(0, 4, size=6000, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=16, d=64, sa=sa)

    qlen = 8
    starts = rng.integers(0, 6000 - qlen, size=37)
    queries = np.stack([codes[st : st + qlen] for st in starts])
    queries[-1] = np.array([0, 1, 2, 3] * 2, dtype=np.uint8)  # likely absent

    fused = SearchLocateEngine(index, loc, max_hits=8)
    iv_f, pos_f = fused.search_locate(queries, wave=16)  # non-divisible wave

    iv = np.asarray(XLAEngine(index).search(queries))
    pos = LocateEngine(loc).locate_hits(iv, max_hits=8)
    np.testing.assert_array_equal(iv_f, iv)
    np.testing.assert_array_equal(pos_f, pos)


def test_search_locate_fused_with_lut(rng):
    from tpufm.engine.xla import SearchLocateEngine, XLAEngine, LocateEngine

    codes = rng.integers(0, 4, size=6000, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=16, d=64, sa=sa)

    qlen = 12
    starts = rng.integers(0, 6000 - qlen, size=16)
    queries = np.stack([codes[st : st + qlen] for st in starts])

    fused = SearchLocateEngine(index, loc, max_hits=4, lut_m=4)
    iv_f, pos_f = fused.search_locate(queries)
    iv = np.asarray(XLAEngine(index).search(queries))
    np.testing.assert_array_equal(iv_f, iv)
    np.testing.assert_array_equal(
        pos_f, LocateEngine(loc).locate_hits(iv, max_hits=4)
    )


def test_search_locate_fused_empty_batch(rng):
    from tpufm.engine.xla import SearchLocateEngine

    codes = rng.integers(0, 4, size=2000, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=16, d=64, sa=sa)
    iv, pos = SearchLocateEngine(index, loc, max_hits=4).search_locate(
        np.zeros((0, 8), np.uint8)
    )
    assert iv.shape == (0, 2) and pos.shape == (0, 4)


@pytest.mark.parametrize("max_hits,s", [(1, 1), (64, 4)])
def test_search_locate_fused_edges(rng, max_hits, s):
    # max_hits=1 truncation, max_hits far beyond interval widths, and
    # sample_rate=1 (every row marked, walk exits immediately).
    from tpufm.engine.xla import SearchLocateEngine, XLAEngine, LocateEngine

    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=1, d=32), sa=sa)
    loc = build_locate(codes, sample_rate=s, d=32, sa=sa)

    qlen = 4  # short patterns -> wide intervals
    starts = rng.integers(0, 3000 - qlen, size=21)
    queries = np.stack([codes[st : st + qlen] for st in starts])

    fused = SearchLocateEngine(index, loc, max_hits=max_hits)
    iv_f, pos_f = fused.search_locate(queries)
    iv = np.asarray(XLAEngine(index).search(queries))
    pos = LocateEngine(loc).locate_hits(iv, max_hits=max_hits)
    np.testing.assert_array_equal(iv_f, iv)
    np.testing.assert_array_equal(pos_f, pos)


def test_cli_locate_lut_matches_no_lut(tmp_path, rng, monkeypatch):
    """locate --lut M: every mode's output is identical with and without
    the prefix LUT (round elimination is an optimization, not semantics)."""
    from tpufm import cli
    from tpufm.io.fasta import write_reference
    from tpufm.utils.encoding import decode_bases

    monkeypatch.chdir(tmp_path)
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    write_reference("g.fa", decode_bases(codes))
    cli.main(["genreads", "g.fa", "3000", "24", "12", "--seed", "6"])
    qry = "Q-12_B-24_R-3000.qry"
    for extra in ([], ["--fused"], ["--mismatches", "1"],
                  ["--mismatches", "2"], ["--edits", "1"], ["--sam"]):
        base = ["locate", "g.fa", "3000", qry, "24", "12",
                "--k", "2", "--d", "64", "--sample-rate", "8", *extra]
        cli.main([*base, "--output", "a.out"])
        cli.main([*base, "--lut", "4", "--output", "b.out"])
        assert open("a.out").read() == open("b.out").read(), extra
