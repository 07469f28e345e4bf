"""End-to-end CLI flow on the CPU backend: build -> transform -> genreads ->
search -> diff, mirroring the reference binaries' argv shapes
(reference common/generateIndex.c:30-55, common/searchQueries.c:36-41,
src/transformIndex*.c mains, resources/genreads.py)."""

import numpy as np
import pytest

from tpufm import cli
from tpufm.io.fasta import write_reference
from tpufm.io.results import load_results
from tpufm.utils.encoding import decode_bases


@pytest.fixture
def ref(tmp_path, rng):
    n = 4000
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    path = tmp_path / "ref.fa"
    write_reference(path, decode_bases(codes))
    return path, n, codes


def test_cli_full_flow(tmp_path, ref, monkeypatch, capsys):
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)

    cli.main(["build", str(path), str(n), "--k", "2", "--d", "64"])
    fmi = tmp_path / f"ref.fa.{n}.64fmi2steps.fmi"
    assert fmi.exists()

    cli.main(["transform", str(fmi)])
    assert (tmp_path / (fmi.name + ".interleaving")).exists()
    assert (tmp_path / (fmi.name + ".ac")).exists()
    assert (tmp_path / (fmi.name + ".interleaving.ac")).exists()

    cli.main(["genreads", str(path), str(n), "24", "64", "--seed", "3"])
    qry = tmp_path / f"Q-64_B-24_R-{n}.qry"
    assert qry.exists()

    cli.main(["search", str(fmi), str(qry), "24", "64", "--iterations", "1"])
    res = load_results(str(fmi) + ".res.gpu")
    assert res.shape == (64, 2)
    assert (res[:, 1] > res[:, 0]).all()  # sampled reads all hit

    # AC engine on the .ac image must agree
    cli.main([
        "search", str(fmi) + ".ac", str(qry), "24", "64",
        "--iterations", "1", "--engine", "xla-ac",
        "--output", str(tmp_path / "ac.res"),
    ])
    cli.main(["diff", str(fmi) + ".res.gpu", str(tmp_path / "ac.res")])
    assert "IDENTICAL" in capsys.readouterr().out

    # LUT engine must agree too
    cli.main([
        "search", str(fmi), str(qry), "24", "64",
        "--iterations", "1", "--lut", "4",
        "--output", str(tmp_path / "lut.res"),
    ])
    cli.main(["diff", str(fmi) + ".res.gpu", str(tmp_path / "lut.res")])
    assert "IDENTICAL" in capsys.readouterr().out


def test_cli_diff_detects_mismatch(tmp_path):
    from tpufm.io.results import write_results

    a = np.array([[0, 5], [3, 9]], np.uint32)
    b = np.array([[0, 5], [3, 8]], np.uint32)
    write_results(tmp_path / "a.res", a)
    write_results(tmp_path / "b.res", b)
    with pytest.raises(SystemExit, match="DIFFER"):
        cli.main(["diff", str(tmp_path / "a.res"), str(tmp_path / "b.res")])


def test_cli_build_auto(tmp_path, ref, monkeypatch):
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["build", str(path), str(n), "--auto",
              "--output", str(tmp_path / "auto.fmi")])
    from tpufm.index.formats import read_fmi

    index, _ = read_fmi(tmp_path / "auto.fmi")
    assert index.config.k == 3 and index.config.d == 192


def test_cli_dumpentry_and_sweep(tmp_path, ref, monkeypatch, capsys):
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["build", str(path), str(n), "--k", "1", "--d", "32"])
    fmi = tmp_path / f"ref.fa.{n}.32fmi1steps.fmi"
    cli.main(["dumpentry", str(fmi), "0", "--num", "2"])
    out = capsys.readouterr().out
    assert "entry 0:" in out and "entry 1:" in out and "bwt0 plane1" in out

    cli.main(["sweep", "--refsizes", "20000", "--ks", "2", "--ds", "64",
              "--numqueries", "256", "--length", "24", "--iterations", "1",
              "--output", str(tmp_path / "sweep.jsonl")])
    import json as _json

    rec = _json.loads((tmp_path / "sweep.jsonl").read_text().splitlines()[0])
    assert rec["bit_exact"] and rec["k"] == 2


def test_sweep_engine_dispatch():
    """Unknown engine names must raise (round-1 bug: they silently became
    XLAEngine rows); every layout and lut_m row must dispatch for real."""
    import pytest

    from tpufm.sweep import run_sweep

    for unknown in ("palas", "pallas"):
        with pytest.raises(ValueError, match="unknown engine"):
            run_sweep(refsizes=(4096,), ks=(2,), ds=(32,), engines=(unknown,),
                      num_queries=32, query_len=12, iterations=1)

    recs = run_sweep(
        refsizes=(4096,), ks=(2,), ds=(32,),
        engines=("xla", "xla-paired", "xla-split"), lut_ms=(0, 4),
        num_queries=64, query_len=12, iterations=1,
    )
    by = {(r["engine"], r["lut_m"]) for r in recs}
    # xla-paired needs a LUT: its lut_m=0 row does not exist
    assert by == {("xla", 0), ("xla", 4), ("xla-paired", 4),
                  ("xla-split", 0), ("xla-split", 4)}
    assert all(r["bit_exact"] for r in recs)


def test_cli_locate(tmp_path, ref, monkeypatch):
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["genreads", str(path), str(n), "16", "24", "--seed", "9"])
    qry = f"Q-24_B-16_R-{n}.qry"
    cli.main(["locate", str(path), str(n), qry, "16", "24",
              "--k", "2", "--d", "32", "--sample-rate", "8", "--max-hits", "8"])
    lines = (tmp_path / (qry + ".pos")).read_text().splitlines()
    assert len(lines) == 24
    # every sampled read must report its own sampling position
    from tpufm.io.fasta import load_queries

    reads = load_queries(qry, 16, 24)
    text = codes.tobytes()
    for read, line in zip(reads, lines):
        hits = [int(x) for x in line.split()]
        assert hits, "sampled read must occur"
        for h in hits:
            assert text[h : h + 16] == read.tobytes()


def test_cli_locate_on_device(tmp_path, ref, monkeypatch):
    # --on-device builds search + locate tables on the accelerator from one
    # shared suffix sort; output must match the host-built run exactly.
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["genreads", str(path), str(n), "16", "24", "--seed", "9"])
    qry = f"Q-24_B-16_R-{n}.qry"
    common = [str(path), str(n), qry, "16", "24", "--k", "2", "--d", "32",
              "--sample-rate", "8", "--max-hits", "8"]
    cli.main(["locate", *common, "--output", str(tmp_path / "h.pos")])
    cli.main(["locate", *common, "--on-device",
              "--output", str(tmp_path / "d.pos")])
    assert (tmp_path / "h.pos").read_text() == (tmp_path / "d.pos").read_text()


def test_cli_search_mesh_and_sharded(tmp_path, ref, monkeypatch, capsys):
    """The multi-chip engines behind the reference-style CLI surface:
    --mesh N (data-parallel) and --sharded --routing {allgather,ring,a2a}
    must all produce the single-chip result bit-exactly — including a query
    count NOT divisible by the mesh size (tail padding)."""
    import jax

    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    n_dev = len(jax.devices())
    assert n_dev == 8  # conftest forces the 8-device virtual mesh

    cli.main(["build", str(path), str(n), "--k", "2", "--d", "64"])
    fmi = tmp_path / f"ref.fa.{n}.64fmi2steps.fmi"
    nq = 100  # deliberately not a multiple of 8
    cli.main(["genreads", str(path), str(n), "24", str(nq), "--seed", "5"])
    qry = f"Q-{nq}_B-24_R-{n}.qry"

    cli.main(["search", str(fmi), qry, "24", str(nq), "--iterations", "1",
              "--output", "single.res"])

    cli.main(["search", str(fmi), qry, "24", str(nq), "--iterations", "1",
              "--mesh", str(n_dev), "--lut", "4",
              "--output", "dp.res"])
    cli.main(["diff", "single.res", "dp.res"])
    assert "IDENTICAL" in capsys.readouterr().out

    for routing in ("allgather", "ring", "a2a"):
        cli.main(["search", str(fmi), qry, "24", str(nq), "--iterations", "1",
                  "--mesh", str(n_dev), "--sharded", "--routing", routing,
                  "--lut", "4", "--output", f"sh_{routing}.res"])
        cli.main(["diff", "single.res", f"sh_{routing}.res"])
        assert "IDENTICAL" in capsys.readouterr().out

    # --sharded rejects the AC layout with a clear message (deliberate:
    # baseline IS the memory-optimal sharded layout, docs/DISTRIBUTED.md)
    with pytest.raises(SystemExit, match="baseline layout"):
        cli.main(["search", str(fmi), qry, "24", str(nq), "--sharded",
                  "--engine", "xla-ac"])


def test_cli_bench_sharded():
    """tpufm bench --sharded: the weak-scaling record on the virtual mesh."""
    from tpufm.bench import run_bench_sharded

    rec = run_bench_sharded(
        refsize=40000, k=2, d=64, num_queries=512, query_len=24,
        iterations=1, lut_m=4, routing="a2a",
    )
    assert rec["detail"]["bit_exact_vs_oracle"]
    assert rec["detail"]["devices"] == 8
    assert 0.0 <= rec["detail"]["overflow_round_fraction"] <= 1.0
    assert rec["unit"] == "reads/s"


def test_cli_locate_mesh(tmp_path, ref, monkeypatch):
    # `tpufm locate --mesh N` (data-parallel search + locate) must match the
    # single-chip output exactly.
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["genreads", str(path), str(n), "16", "24", "--seed", "9"])
    qry = f"Q-24_B-16_R-{n}.qry"
    common = [str(path), str(n), qry, "16", "24", "--k", "2", "--d", "32",
              "--sample-rate", "8", "--max-hits", "8"]
    cli.main(["locate", *common, "--output", str(tmp_path / "h.pos")])
    cli.main(["locate", *common, "--mesh", "8",
              "--output", str(tmp_path / "m.pos")])
    assert (tmp_path / "h.pos").read_text() == (tmp_path / "m.pos").read_text()


def test_cli_build_sharded_mesh(tmp_path, ref, monkeypatch):
    # --on-device --mesh N: every build stage sharded over the 8-device CPU
    # mesh; output byte-identical to the host build.
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["build", str(path), str(n), "--k", "2", "--d", "64",
              "--on-device", "--mesh", "8", "--output", "sh.fmi"])
    cli.main(["build", str(path), str(n), "--k", "2", "--d", "64",
              "--output", "host.fmi"])
    assert (tmp_path / "sh.fmi").read_bytes() == (tmp_path / "host.fmi").read_bytes()


def test_cli_locate_fused(tmp_path, ref, monkeypatch):
    # --fused must write exactly the same positions file as the two-pass path
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["genreads", str(path), str(n), "12", "32", "--seed", "2",
              "--output", "q.qry"])
    common = [str(path), str(n), "q.qry", "12", "32",
              "--k", "2", "--d", "64", "--sample-rate", "8"]
    cli.main(["locate", *common, "--output", "two.pos"])
    cli.main(["locate", *common, "--fused", "--output", "one.pos"])
    assert (tmp_path / "one.pos").read_text() == (tmp_path / "two.pos").read_text()


def test_cli_locate_fused_mesh(tmp_path, ref, monkeypatch):
    # --fused --mesh N equals the two-pass mesh path byte-for-byte
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["genreads", str(path), str(n), "12", "32", "--seed", "3",
              "--output", "q.qry"])
    common = [str(path), str(n), "q.qry", "12", "32",
              "--k", "2", "--d", "64", "--sample-rate", "8"]
    cli.main(["locate", *common, "--mesh", "8", "--output", "mesh2.pos"])
    cli.main(["locate", *common, "--mesh", "8", "--fused",
              "--output", "mesh1.pos"])
    assert (tmp_path / "mesh1.pos").read_text() == (tmp_path / "mesh2.pos").read_text()


def test_cli_locate_on_device_mesh(tmp_path, ref, monkeypatch):
    # --on-device --mesh N: sharded build of both table sets, positions
    # byte-identical to the host-built two-pass path
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["genreads", str(path), str(n), "12", "32", "--seed", "4",
              "--output", "q.qry"])
    common = [str(path), str(n), "q.qry", "12", "32",
              "--k", "2", "--d", "64", "--sample-rate", "8"]
    cli.main(["locate", *common, "--output", "host.pos"])
    cli.main(["locate", *common, "--on-device", "--mesh", "8",
              "--output", "meshbuild.pos"])
    assert (tmp_path / "meshbuild.pos").read_text() == (tmp_path / "host.pos").read_text()


def test_cli_bench_search_locate_fused():
    """tpufm bench --locate --fused: the one-pass record, verified vs the
    host oracles."""
    from tpufm.bench import run_bench_search_locate

    rec = run_bench_search_locate(
        refsize=40000, k=2, d=64, sample_rate=8, num_queries=512,
        query_len=24, iterations=1, lut_m=4, max_hits=4,
    )
    assert rec["detail"]["bit_exact_vs_oracle"]
    assert rec["unit"] == "reads/s"
    assert rec["detail"]["max_hits"] == 4


def test_cli_any_length_search(tmp_path, ref, monkeypatch):
    """build --tail + odd-length reads: the k=1 tail sibling is auto-loaded
    and the result matches the k=1 oracle (any-length extension — the
    reference rejects L % k != 0)."""
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.formats import load_npz
    from tpufm.io.fasta import load_queries
    from tpufm.io.results import load_results

    path, n, codes = ref
    monkeypatch.chdir(tmp_path)

    cli.main(["build", str(path), str(n), "--k", "3", "--d", "64", "--tail"])
    fmi = tmp_path / f"ref.fa.{n}.64fmi3steps.fmi"
    assert fmi.exists() and (tmp_path / (fmi.name + ".tail.npz")).exists()

    cli.main(["genreads", str(path), str(n), "25", "48", "--seed", "5",
              "--output", "odd.qry"])  # 25 % 3 == 1
    cli.main(["search", str(fmi), "odd.qry", "25", "48", "--iterations", "1"])
    res = load_results(str(fmi) + ".res.gpu")
    tail = load_npz(str(fmi) + ".tail.npz")
    qs = load_queries(tmp_path / "odd.qry", 25, 48)
    np.testing.assert_array_equal(res, search_oracle(tail, qs))
    assert (res[:, 1] > res[:, 0]).all()

    # the mesh and sharded engines take the same tail sibling
    cli.main(["search", str(fmi), "odd.qry", "25", "48", "--iterations", "1",
              "--mesh", "8", "--output", "mesh.res"])
    np.testing.assert_array_equal(load_results("mesh.res"), res)
    cli.main(["search", str(fmi), "odd.qry", "25", "48", "--iterations", "1",
              "--mesh", "8", "--sharded", "--routing", "a2a",
              "--output", "sh.res"])
    np.testing.assert_array_equal(load_results("sh.res"), res)


def test_cli_odd_length_without_tail_derives(tmp_path, ref, monkeypatch):
    """No .tail.npz sibling: the k=1 tail derives from the index itself
    (its level-0 bitplanes ARE BWT0) — any length works on ANY index."""
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.builder import build_index as _bi
    from tpufm.io.fasta import load_queries
    from tpufm.io.results import load_results
    from tpufm.config import IndexConfig as _IC

    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["build", str(path), str(n), "--k", "3", "--d", "64"])
    fmi = tmp_path / f"ref.fa.{n}.64fmi3steps.fmi"
    cli.main(["genreads", str(path), str(n), "25", "16", "--seed", "5",
              "--output", "odd.qry"])
    cli.main(["search", str(fmi), "odd.qry", "25", "16", "--iterations", "1"])
    tail = _bi(codes, _IC(k=1, d=64), sa_method="doubling")
    qs = load_queries("odd.qry", 25, 16)
    np.testing.assert_array_equal(
        load_results(str(fmi) + ".res.gpu"), search_oracle(tail, qs)
    )


def test_cli_locate_any_length(tmp_path, ref, monkeypatch):
    """tpufm locate with an odd read length: the locate tables' own k=1 LF
    index serves as the tail, two-pass and fused paths agree."""
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["genreads", str(path), str(n), "13", "32", "--seed", "6",
              "--output", "q.qry"])  # 13 % 2 == 1
    common = [str(path), str(n), "q.qry", "13", "32",
              "--k", "2", "--d", "64", "--sample-rate", "8"]
    cli.main(["locate", *common, "--output", "two.pos"])
    cli.main(["locate", *common, "--fused", "--output", "fused.pos"])
    cli.main(["locate", *common, "--mesh", "8", "--output", "mesh.pos"])
    two = (tmp_path / "two.pos").read_text()
    assert two == (tmp_path / "fused.pos").read_text()
    assert two == (tmp_path / "mesh.pos").read_text()
    # every line resolves at least one genuine position
    assert all(line.strip() for line in two.splitlines())


def test_cli_bench_mismatch():
    """tpufm bench --mismatches 1: verified Hamming<=1 counting record."""
    from tpufm.bench import run_bench_mismatch

    rec = run_bench_mismatch(
        refsize=40000, k=2, d=64, num_queries=256, query_len=24,
        iterations=1, lut_m=4,
    )
    assert rec["detail"]["bit_exact_vs_naive"]
    assert rec["unit"] == "reads/s"
    lanes = rec["detail"]["variant_lanes_per_s"]
    assert abs(lanes - rec["detail"]["reads_per_s"] * 73) <= 73  # rounding
    # every planted-error read recovers its origin
    assert rec["detail"]["recovered"] == 256


def test_cli_bench_seed():
    """tpufm bench --mismatches 2: verified seed-and-extend locate record."""
    from tpufm.bench import run_bench_seed

    rec = run_bench_seed(
        refsize=40000, k=2, d=64, sample_rate=8, num_queries=256,
        query_len=30, iterations=1, lut_m=4, mismatches=2, seed_hits=64,
    )
    assert rec["detail"]["bit_exact_vs_naive"]
    assert rec["unit"] == "reads/s"
    # every read carries two planted errors; the seed pass recovers them all
    assert rec["detail"]["recovered"] == 256


def test_cli_bench_paired():
    """tpufm bench --paired: truth-verified pairing record."""
    from tpufm.bench import run_bench_paired

    rec = run_bench_paired(
        refsize=30000, k=2, d=64, sample_rate=8, num_pairs=64,
        query_len=20, insert_min=60, insert_max=200, iterations=1,
    )
    assert rec["unit"] == "pairs/s"
    assert rec["detail"]["truth_pairs_recovered"] == 64
    assert rec["detail"]["bit_exact_vs_oracle"]


def test_cli_bench_edit():
    """tpufm bench --edits 1: DP-oracle-verified indel alignment record."""
    from tpufm.bench import run_bench_edit

    rec = run_bench_edit(
        refsize=30000, k=2, d=64, sample_rate=8, num_queries=128,
        query_len=30, iterations=1, edits=1, seed_hits=64,
    )
    assert rec["detail"]["sound_vs_dp_oracle"]
    assert rec["detail"]["origin_recovered_sample"]
    assert rec["unit"] == "reads/s"


def test_cli_align_single_end(tmp_path, ref, monkeypatch):
    """tpufm align: one-command FASTA/FASTQ -> SAM with auto-sniffed sizes
    and auto (k, d, LUT); odd read length exercises the k=1 tail rounds."""
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["genreads", str(path), str(n), "25", "24", "--seed", "11"])
    qry = f"Q-24_B-25_R-{n}.qry"
    cli.main(["align", str(path), qry, "-o", str(tmp_path / "out.sam")])
    lines = (tmp_path / "out.sam").read_text().splitlines()
    header = [l for l in lines if l.startswith("@")]
    body = [l for l in lines if not l.startswith("@")]
    assert any(l.startswith("@SQ") for l in header)
    assert len(body) == 24  # one primary record per read (all sampled hits)
    text = codes.tobytes()
    from tpufm.io.fasta import load_queries

    reads = load_queries(qry, 25, 24)
    for read, line in zip(reads, body):
        f = line.split("\t")
        flag, pos, cigar, seq = int(f[1]), int(f[3]), f[5], f[9]
        assert cigar == "25M" and not flag & 4
        if not flag & 16:  # sampled plus-strand read: POS is 1-based
            assert text[pos - 1 : pos + 24] == read.tobytes()
            assert seq == decode_bases(read).decode()


def test_cli_align_paired_and_store(tmp_path, ref, monkeypatch):
    """tpufm align -2: paired SAM; --store/--from-store reuse is identical."""
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    cli.main(["genreads", str(path), str(n), "24", "16", "--seed", "13",
              "--paired", "--insert-min", "60", "--insert-max", "200"])
    r1, r2 = f"Q-16_B-24_R-{n}_1.qry", f"Q-16_B-24_R-{n}_2.qry"
    cli.main(["align", str(path), r1, "-2", r2,
              "--insert-min", "60", "--insert-max", "200",
              "--store", str(tmp_path / "st"),
              "-o", str(tmp_path / "p.sam")])
    body = [l for l in (tmp_path / "p.sam").read_text().splitlines()
            if not l.startswith("@")]
    assert body, "paired records written"
    assert all(int(l.split("\t")[1]) & 1 for l in body)  # FLAG paired bit
    # proper pairs for every generated pair (insert window matches genreads)
    assert sum(1 for l in body if int(l.split("\t")[1]) & 2) >= 2 * 16
    cli.main(["align", str(path), r1, "-2", r2,
              "--insert-min", "60", "--insert-max", "200",
              "--from-store", str(tmp_path / "st"),
              "-o", str(tmp_path / "p2.sam")])
    assert (tmp_path / "p.sam").read_text() == (tmp_path / "p2.sam").read_text()


def test_cli_align_mixed_lengths(tmp_path, ref, monkeypatch):
    """tpufm align on a mixed-length read set: the variable-length path
    (search_varlen + locate walk), per-read-length SAM records."""
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    rng2 = np.random.default_rng(17)
    text = codes.tobytes()
    lengths = [20, 33, 25, 41, 20, 28]
    reads, qry = [], tmp_path / "mixed.fa"
    with open(qry, "w") as fp:
        for i, L in enumerate(lengths):
            s = int(rng2.integers(0, n - L))
            reads.append((s, codes[s : s + L]))
            fp.write(f">m{i}\n{decode_bases(reads[-1][1]).decode()}\n")
    cli.main(["align", str(path), str(qry), "-o", str(tmp_path / "m.sam")])
    body = [l for l in (tmp_path / "m.sam").read_text().splitlines()
            if not l.startswith("@")]
    assert len(body) >= 6
    primaries = [l for l in body if not int(l.split("\t")[1]) & 0x100]
    assert len(primaries) == 6
    for (s, read), line in zip(reads, primaries):
        f = line.split("\t")
        L = len(read)
        assert f[5] == f"{L}M" and not int(f[1]) & 4
        if not int(f[1]) & 16:
            assert text[int(f[3]) - 1 : int(f[3]) - 1 + L] == read.tobytes()
            assert f[9] == decode_bases(read).decode()


def test_cli_align_mixed_mismatches(tmp_path, ref, monkeypatch):
    """Mixed-length --mismatches 1: per-length grouping — every read
    gets one substitution planted and must map back to its origin with
    NM:i:1, records in input order."""
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    rng2 = np.random.default_rng(31)
    lengths = [24, 36, 24, 30, 36, 24]
    reads, qry = [], tmp_path / "mixm.fa"
    with open(qry, "w") as fp:
        for i, L in enumerate(lengths):
            s = int(rng2.integers(0, n - L))
            r = codes[s : s + L].copy()
            j = int(rng2.integers(0, L))
            r[j] = (r[j] + 1 + int(rng2.integers(0, 3))) % 4
            reads.append((s, r))
            fp.write(f">mm{i}\n{decode_bases(r).decode()}\n")
    cli.main(["align", str(path), str(qry), "--mismatches", "1",
              "-o", str(tmp_path / "mm.sam")])
    body = [l for l in (tmp_path / "mm.sam").read_text().splitlines()
            if not l.startswith("@")]
    qnames = []
    for l in body:
        if l.split("\t")[0] not in qnames:
            qnames.append(l.split("\t")[0])
    assert qnames == [f"mm{i}" for i in range(6)]  # input order kept
    for i, (s, r) in enumerate(reads):
        recs = [l.split("\t") for l in body if l.split("\t")[0] == f"mm{i}"]
        assert any(
            int(f[3]) - 1 == s and not int(f[1]) & 0x10 for f in recs
        ), f"read {i}: origin {s} not reported"
        for f in recs:
            assert not int(f[1]) & 4
            assert int(f[-1].split(":")[-1]) <= 1  # NM:i at most 1


def test_cli_align_mixed_edits(tmp_path, ref, monkeypatch):
    """Mixed-length --edits 1: one planted deletion per read; the origin
    window must be recovered with a real M/D CIGAR."""
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    rng2 = np.random.default_rng(37)
    reads, qry = [], tmp_path / "mixe.fa"
    with open(qry, "w") as fp:
        for i, L in enumerate((36, 45, 36)):
            s = int(rng2.integers(0, n - L - 2))
            window = codes[s : s + L + 1]
            j = int(rng2.integers(4, L - 4))
            r = np.concatenate([window[:j], window[j + 1 :]])[:L]
            reads.append((s, r))
            fp.write(f">me{i}\n{decode_bases(r).decode()}\n")
    cli.main(["align", str(path), str(qry), "--edits", "1",
              "-o", str(tmp_path / "me.sam")])
    body = [l for l in (tmp_path / "me.sam").read_text().splitlines()
            if not l.startswith("@")]
    for i, (s, r) in enumerate(reads):
        recs = [l.split("\t") for l in body if l.split("\t")[0] == f"me{i}"]
        assert recs and any(not int(f[1]) & 4 for f in recs)
        assert any(abs(int(f[3]) - 1 - s) <= 2 for f in recs), \
            f"read {i}: no site near origin {s}"


def test_cli_align_mixed_mesh(tmp_path, ref, monkeypatch):
    """Mixed-length align over the 8-device virtual mesh is byte-identical
    to the single-chip SAM."""
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    rng2 = np.random.default_rng(23)
    qry = tmp_path / "mix3.fa"
    with open(qry, "w") as fp:
        for i, L in enumerate((20, 33, 25, 41, 20, 28, 37, 22, 30)):
            s = int(rng2.integers(0, n - L))
            fp.write(f">q{i}\n{decode_bases(codes[s : s + L]).decode()}\n")
    cli.main(["align", str(path), str(qry), "-o", str(tmp_path / "s.sam")])
    cli.main(["align", str(path), str(qry), "--mesh", "8",
              "-o", str(tmp_path / "m.sam")])
    assert (tmp_path / "s.sam").read_text() == (tmp_path / "m.sam").read_text()


def test_cli_align_mixed_mismatches_mesh(tmp_path, ref, monkeypatch):
    """Mixed-length --mismatches over the 8-device mesh is byte-identical
    to the single-chip SAM (the per-length groups reuse ONE
    DataParallelSearchLocate)."""
    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    rng2 = np.random.default_rng(41)
    qry = tmp_path / "mixmm.fa"
    with open(qry, "w") as fp:
        for i, L in enumerate((24, 36, 24, 30, 36, 24, 30, 24)):
            s = int(rng2.integers(0, n - L))
            r = codes[s : s + L].copy()
            j = int(rng2.integers(0, L))
            r[j] = (r[j] + 1) % 4
            fp.write(f">g{i}\n{decode_bases(r).decode()}\n")
    cli.main(["align", str(path), str(qry), "--mismatches", "1",
              "-o", str(tmp_path / "s.sam")])
    cli.main(["align", str(path), str(qry), "--mismatches", "1",
              "--mesh", "8", "-o", str(tmp_path / "m.sam")])
    assert (tmp_path / "s.sam").read_text() == (tmp_path / "m.sam").read_text()


def test_cli_align_mixed_paired(tmp_path, ref, monkeypatch):
    """Mixed-length PAIRED align: pairs with two (L1, L2) combos group
    per combo and merge back in input order; every planted pair comes
    back properly paired at its origin."""
    from tpufm.io.genreads import generate_read_pairs

    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    a1, a2, (als, ars, am) = generate_read_pairs(
        codes, 24, 3, 60, 200, seed=3, return_truth=True)
    b1, b2, (bls, brs, bm) = generate_read_pairs(
        codes, 30, 3, 60, 200, seed=4, return_truth=True)
    # interleave the two length sets so grouping must reorder
    order = [("a", 0), ("b", 0), ("a", 1), ("b", 1), ("b", 2), ("a", 2)]
    truth = []
    with open("m1.fa", "w") as f1, open("m2.fa", "w") as f2:
        for t, (which, j) in enumerate(order):
            r1 = (a1 if which == "a" else b1)[j]
            r2 = (a2 if which == "a" else b2)[j]
            ls = (als if which == "a" else bls)[j]
            f1.write(f">p{t}\n{decode_bases(r1).decode()}\n")
            f2.write(f">p{t}\n{decode_bases(r2).decode()}\n")
            truth.append((int(ls), len(r1)))
    cli.main(["align", str(path), "m1.fa", "-2", "m2.fa",
              "--insert-min", "60", "--insert-max", "200",
              "-o", str(tmp_path / "mp.sam")])
    body = [l.split("\t") for l in (tmp_path / "mp.sam").read_text()
            .splitlines() if not l.startswith("@")]
    qnames = []
    for f in body:
        if f[0] not in qnames:
            qnames.append(f[0])
    assert qnames == [f"p{t}" for t in range(6)]  # input order kept
    text = codes.tobytes()
    for t, (ls, L) in enumerate(truth):
        recs = [f for f in body if f[0] == f"p{t}"]
        assert recs and all(int(f[1]) & 1 for f in recs)
        # the leftmost mate of some reported pair sits at the planted start
        assert any(int(f[3]) - 1 == ls and not int(f[1]) & 0x100
                   for f in recs), (t, ls, recs)
        for f in recs:
            if not int(f[1]) & 4 and "M" == f[5][-1] and f[5][:-1].isdigit():
                Lr = int(f[5][:-1])
                if not int(f[1]) & 0x10:
                    # plus-strand record: SEQ must match the reference
                    seq = f[9]
                    p = int(f[3]) - 1
                    assert decode_bases(
                        np.frombuffer(text[p : p + Lr], np.uint8)
                    ).decode() == seq


def test_cli_align_paired_unequal_mates_mismatches(
    tmp_path, ref, monkeypatch
):
    """Unequal mate lengths + --mismatches: the per-(L1, L2) grouping
    plus the strand-partitioned SAM NM re-evaluation place every planted
    pair with per-mate NM — the former 'equal mate lengths' rejection,
    removed."""
    from tpufm.utils.encoding import reverse_complement

    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    rng2 = np.random.default_rng(11)
    L1, L2 = 24, 30
    truth = []
    with open("u1.fa", "w") as f1, open("u2.fa", "w") as f2:
        for t in range(4):
            l = int(rng2.integers(0, n - 400))
            frag = int(rng2.integers(150, 200))
            r = l + frag - L2
            r1 = codes[l : l + L1].copy()
            r1[5] = (r1[5] + 1) % 4  # one substitution in R1
            r2 = reverse_complement(codes[r : r + L2][None])[0]
            f1.write(f">q{t}\n{decode_bases(r1).decode()}\n")
            f2.write(f">q{t}\n{decode_bases(r2).decode()}\n")
            truth.append((l, r, frag))
    cli.main(["align", str(path), "u1.fa", "-2", "u2.fa",
              "--mismatches", "1", "--insert-min", "120",
              "--insert-max", "260", "-o", str(tmp_path / "u.sam")])
    body = [l_.split("\t") for l_ in (tmp_path / "u.sam").read_text()
            .splitlines() if not l_.startswith("@")]
    for t, (l, r, frag) in enumerate(truth):
        recs = [f for f in body
                if f[0] == f"q{t}" and not int(f[1]) & 0x100]
        first = next(f for f in recs if int(f[1]) & 0x40)
        second = next(f for f in recs if int(f[1]) & 0x80)
        assert int(first[1]) == 0x63 and int(first[3]) - 1 == l
        assert first[5] == f"{L1}M" and "NM:i:1" in first[11:]
        assert int(second[1]) == 0x93 and int(second[3]) - 1 == r
        assert second[5] == f"{L2}M" and "NM:i:0" in second[11:]
        assert int(first[8]) == frag == -int(second[8])


def test_cli_align_paired_unequal_mates_edits(tmp_path, ref, monkeypatch):
    """Unequal mate lengths + --edits: strand-partitioned re-alignment
    yields a real deletion CIGAR on the indel-carrying mate while the
    other mate (different length) stays <L>M, TLEN from actual spans."""
    from tpufm.utils.encoding import reverse_complement

    path, n, codes = ref
    monkeypatch.chdir(tmp_path)
    L1, L2 = 24, 30
    l, r = 700, 960
    # R1 carries one deletion (consumes L1+1 reference bases)
    r1 = np.concatenate([codes[l : l + 9],
                         codes[l + 10 : l + L1 + 1]]).astype(np.uint8)
    r2 = reverse_complement(codes[r : r + L2][None])[0]
    (tmp_path / "e1.fa").write_text(f">e0\n{decode_bases(r1).decode()}\n")
    (tmp_path / "e2.fa").write_text(f">e0\n{decode_bases(r2).decode()}\n")
    cli.main(["align", str(path), "e1.fa", "-2", "e2.fa",
              "--edits", "1", "--insert-min", "200",
              "--insert-max", "400", "-o", str(tmp_path / "e.sam")])
    body = [l_.split("\t") for l_ in (tmp_path / "e.sam").read_text()
            .splitlines() if not l_.startswith("@")]
    first = next(f for f in body if int(f[1]) & 0x40)
    second = next(f for f in body if int(f[1]) & 0x80)
    assert int(first[1]) == 0x63 and int(first[3]) - 1 == l
    assert "D" in first[5] and "NM:i:1" in first[11:]
    assert int(second[1]) == 0x93 and int(second[3]) - 1 == r
    assert second[5] == f"{L2}M" and "NM:i:0" in second[11:]
    assert int(first[8]) == r + L2 - l == -int(second[8])
