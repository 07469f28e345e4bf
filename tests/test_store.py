"""The mmap-able `.tpufm` store must round-trip every index kind exactly and
drive search/locate with no rebuild (genome-scale persistence)."""

import numpy as np
import pytest

from tpufm.config import IndexConfig
from tpufm.engine.oracle import search_oracle
from tpufm.engine.xla import XLAEngine
from tpufm.index.builder import build_index
from tpufm.index.layouts import make_alt_counters
from tpufm.index.locate import build_locate
from tpufm.index.store import save_store, load_store
from tpufm.io.genreads import generate_reads


def test_store_kstep_roundtrip(tmp_path, rng):
    codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=64))
    root = save_store(tmp_path / "idx", index)
    assert root.name == "idx.tpufm"
    loaded = load_store(root)
    np.testing.assert_array_equal(loaded.occ, index.occ)
    np.testing.assert_array_equal(loaded.bitmaps, index.bitmaps)
    np.testing.assert_array_equal(loaded.dollar_pos, index.dollar_pos)
    assert loaded.bwtsize == index.bwtsize
    assert loaded.config == index.config
    # mmap mode: arrays are memory-mapped, not materialized
    assert isinstance(loaded.occ, np.memmap)
    # engine runs straight off the mmap
    reads = generate_reads(codes, 24, 32, seed=1)
    np.testing.assert_array_equal(
        XLAEngine(loaded).search(reads), search_oracle(index, reads)
    )


def test_store_alt_counters_roundtrip(tmp_path, rng):
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    ac = make_alt_counters(build_index(codes, IndexConfig(k=2, d=32)))
    loaded = load_store(save_store(tmp_path / "ac", ac))
    np.testing.assert_array_equal(loaded.occ_slim, ac.occ_slim)
    np.testing.assert_array_equal(loaded.base.occ, ac.base.occ)
    reads = generate_reads(codes, 24, 32, seed=2)
    np.testing.assert_array_equal(
        XLAEngine(loaded).search(reads), search_oracle(ac.base, reads)
    )


def test_store_locate_roundtrip(tmp_path, rng):
    from tpufm.engine.xla import LocateEngine

    codes = rng.integers(0, 4, size=4000, dtype=np.uint8)
    loc = build_locate(codes, sample_rate=8, d=32)
    loaded = load_store(save_store(tmp_path / "loc", loc))
    assert loaded.sample_rate == loc.sample_rate
    np.testing.assert_array_equal(loaded.samples, loc.samples)
    # locate engine off the store resolves rows identically
    rows = rng.integers(0, 4001, size=64, dtype=np.uint32)
    np.testing.assert_array_equal(
        LocateEngine(loaded).locate_rows(rows), LocateEngine(loc).locate_rows(rows)
    )


def test_store_rejects_future_format(tmp_path, rng):
    import json

    codes = rng.integers(0, 4, size=1000, dtype=np.uint8)
    root = save_store(tmp_path / "f", build_index(codes, IndexConfig(k=1, d=32)))
    meta = json.loads((root / "meta.json").read_text())
    meta["format"] = 99
    (root / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="newer than supported"):
        load_store(root)


def test_cli_store_flow(tmp_path, rng, monkeypatch):
    """build --output store -> search from store; locate --store /
    --from-store (no rebuild)."""
    from tpufm import cli
    from tpufm.io.fasta import write_reference
    from tpufm.utils.encoding import decode_bases

    monkeypatch.chdir(tmp_path)
    n = 3000
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    write_reference(tmp_path / "ref.fa", decode_bases(codes))

    cli.main(["build", str(tmp_path / "ref.fa"), str(n),
              "--k", "2", "--d", "32", "--output", str(tmp_path / "idx.tpufm")])
    cli.main(["genreads", str(tmp_path / "ref.fa"), str(n), "24", "32"])
    qry = f"Q-32_B-24_R-{n}.qry"
    cli.main(["search", str(tmp_path / "idx.tpufm"), qry, "24", "32",
              "--iterations", "1"])
    from tpufm.io.results import load_results

    res = load_results(str(tmp_path / "idx.tpufm.res.gpu"))
    index = build_index(codes, IndexConfig(k=2, d=32))
    from tpufm.io.fasta import load_queries

    np.testing.assert_array_equal(
        res, search_oracle(index, load_queries(qry, 24, 32))
    )

    # locate: build once with --store, then run again --from-store
    cli.main(["locate", str(tmp_path / "ref.fa"), str(n), qry, "24", "32",
              "--k", "2", "--d", "32", "--sample-rate", "8", "--max-hits", "4",
              "--store", str(tmp_path / "pre"),
              "--output", str(tmp_path / "a.pos")])
    cli.main(["locate", "-", "0", qry, "24", "32",
              "--from-store", str(tmp_path / "pre"), "--max-hits", "4",
              "--output", str(tmp_path / "b.pos")])
    assert (tmp_path / "a.pos").read_text() == (tmp_path / "b.pos").read_text()


def test_store_sharded_roundtrip(tmp_path, rng):
    """Per-shard store: save from a device-resident sharded build with no
    whole-table host copy, reload onto an equal mesh, search bit-exact —
    and the shard files reassemble byte-identical to the host build."""
    import jax

    from tpufm.index.builder_sharded import build_index_sharded
    from tpufm.index.store import load_store_sharded, save_store_sharded
    from tpufm.parallel import ShardedIndexEngine
    from tpufm.parallel.mesh import make_mesh

    mesh8 = make_mesh(8)
    codes = rng.integers(0, 4, size=9000, dtype=np.uint8)
    cfg = IndexConfig(k=2, d=64)
    dev = build_index_sharded(codes, cfg, mesh8, return_host=False)
    root = save_store_sharded(tmp_path / "sh", dev)
    assert sorted(p.name for p in root.glob("occ.shard*.npy")) == [
        f"occ.shard{i:04d}.npy" for i in range(8)
    ]

    loaded = load_store_sharded(root, mesh8)
    assert isinstance(loaded.occ, jax.Array)
    assert not loaded.occ.is_fully_replicated

    host = build_index(codes, cfg)
    E1 = host.occ.shape[0]
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(loaded.occ))[:E1], host.occ
    )
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(loaded.bitmaps))[:E1], host.bitmaps
    )
    np.testing.assert_array_equal(
        np.asarray(loaded.dollar_pos, np.uint32),
        np.asarray(host.dollar_pos, np.uint32),
    )

    starts = rng.integers(0, 9000 - 24, size=64)
    q = np.stack([codes[i : i + 24] for i in starts])
    got = ShardedIndexEngine(loaded, mesh8).search(q)
    np.testing.assert_array_equal(got, search_oracle(host, q))

    # wrong-size mesh and wrong loader are told apart explicitly
    with pytest.raises(ValueError, match="equal-size mesh"):
        load_store_sharded(root, make_mesh(4))
    with pytest.raises(ValueError, match="load_store_sharded"):
        load_store(root)
    with pytest.raises(TypeError, match="save_store"):
        save_store_sharded(tmp_path / "host", host)


def test_cli_store_sharded_flow(tmp_path, rng, monkeypatch):
    """build --on-device --mesh --store-sharded -> search --sharded, end
    to end, matching the plain single-chip search."""
    from tpufm import cli
    from tpufm.io.fasta import write_reference
    from tpufm.io.results import load_results
    from tpufm.utils.encoding import decode_bases

    monkeypatch.chdir(tmp_path)
    n = 6000
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    write_reference("ref.fa", decode_bases(codes))
    cli.main(["build", "ref.fa", str(n), "--k", "2", "--d", "64",
              "--on-device", "--mesh", "8", "--store-sharded",
              "--output", "sh.tpufm"])
    cli.main(["genreads", "ref.fa", str(n), "24", "32", "--seed", "3"])
    qry = f"Q-32_B-24_R-{n}.qry"
    cli.main(["search", "sh.tpufm", qry, "24", "32", "--iterations", "1",
              "--sharded", "--output", "sh.res"])
    # plain host build + single-chip search is the ground truth
    cli.main(["build", "ref.fa", str(n), "--k", "2", "--d", "64",
              "--output", "host.npz"])
    cli.main(["search", "host.npz", qry, "24", "32", "--iterations", "1",
              "--output", "host.res"])
    np.testing.assert_array_equal(load_results("sh.res"),
                                  load_results("host.res"))


def test_store_sharded_roundtrip_one_device(tmp_path, rng):
    """A 1-device mesh is trivially 'fully replicated' yet a valid
    single-shard store: save/load/search must work (the driver dryrun
    supports n_devices=1, and 1-device shards carry full-slice indices
    whose .start is None)."""
    import jax

    from tpufm.index.builder_sharded import build_index_sharded
    from tpufm.index.store import load_store_sharded, save_store_sharded
    from tpufm.parallel import ShardedIndexEngine
    from tpufm.parallel.mesh import make_mesh

    mesh1 = make_mesh(1)
    codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
    cfg = IndexConfig(k=2, d=64)
    dev = build_index_sharded(codes, cfg, mesh1, return_host=False)
    root = save_store_sharded(tmp_path / "sh1", dev)
    assert [p.name for p in root.glob("occ.shard*.npy")] == ["occ.shard0000.npy"]
    loaded = load_store_sharded(root, mesh1)
    host = build_index(codes, cfg)
    E1 = host.occ.shape[0]
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(loaded.occ))[:E1], host.occ
    )
    starts = rng.integers(0, 5000 - 24, size=32)
    q = np.stack([codes[i : i + 24] for i in starts])
    np.testing.assert_array_equal(
        ShardedIndexEngine(loaded, mesh1).search(q), search_oracle(host, q)
    )
