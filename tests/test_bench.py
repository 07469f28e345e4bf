"""Bench-harness plumbing tests (CPU backend, tiny sizes): the record
schema, the two-layer verification (oracle sample + full-batch CPU twin),
gather-traffic accounting, and the genome-record cache round trip. Rates
measured here are meaningless — only correctness of the harness is under
test (the real records run on the GPU via bench.py)."""

import json
from pathlib import Path

import numpy as np
import pytest

from tpufm.bench import (
    gather_traffic_bytes,
    hbm_peak_bytes_per_s,
    run_bench,
    run_bench_genome,
)


def test_run_bench_record_schema_and_verification():
    r = run_bench(refsize=200_000, k=2, d=64, num_queries=2048, query_len=24,
                  iterations=1, lut_m=4, compare_reference=False,
                  full_verify=True)
    d = r["detail"]
    assert d["bit_exact_vs_oracle"] and d["bit_exact_vs_oracle_sample"]
    assert d["bit_exact_vs_cpu_engine_full"] is True
    assert d["verified_reads"] == 2048  # full batch
    assert d["verified_reads_oracle"] == 2048
    # traffic accounting: (24-4)/2 rounds x 2 ends x row bytes + 8 B LUT
    row_words = 2 * 2 * (64 // 32) + 16
    assert d["gathered_bytes_per_pass"] == 2048 * (10 * 2 * 4 * row_words + 8)
    # CPU run: no device metric and no reference binaries -> nulls, and
    # the record names the device it ran on
    assert d["achieved_hbm_gbps"] is None
    assert d["fraction_of_sol"] is None and d["speed_of_light_steps_per_s"] is None
    assert r["vs_baseline"] is None
    assert (d["platform"], d["device_kind"], d["device_count"]) == ("cpu", "cpu", 8)
    json.dumps(r)  # records must be JSON-serializable


def test_run_bench_variant_engines_full_verify():
    # paired returns (iv, ok) from search_device; split has no fused table
    for engine, lut in (("xla-paired", 4), ("xla-split", 0)):
        r = run_bench(refsize=200_000, k=2, d=64, num_queries=2048,
                      query_len=24, iterations=1, engine=engine, lut_m=lut,
                      compare_reference=False, full_verify=True)
        d = r["detail"]
        assert d["bit_exact_vs_oracle"], engine
        assert d["verified_reads"] == 2048, engine
    assert (
        gather_traffic_bytes(object(), 10, 24) is None
    )  # non-fused engines report no traffic


def test_run_bench_genome_cache_roundtrip(tmp_path):
    kw = dict(refsize=300_000, num_queries=1024, query_len=120,
              iterations=1, compare_reference=False, full_verify=True,
              cache_dir=tmp_path)
    g1 = run_bench_genome(**kw)
    assert g1["detail"]["index_cached"] is False
    assert g1["detail"]["bit_exact_vs_oracle"]
    assert g1["detail"]["verified_reads"] == 1024
    g2 = run_bench_genome(**kw)
    assert g2["detail"]["index_cached"] is True
    assert g2["detail"]["build_seconds"] == 0.0
    assert g2["detail"]["bit_exact_vs_oracle"]
    # same index from the store: identical logical record
    assert g1["detail"]["gathered_bytes_per_pass"] == \
        g2["detail"]["gathered_bytes_per_pass"]


def test_run_bench_genome_k_follows_recommendation(tmp_path):
    """query lengths not divisible by 3 must pick recommend_config's k
    (not crash on a hardcoded k=3), and an explicit lut_m=0 must be
    honored (the LUT-free path, not silently replaced by the default)."""
    g = run_bench_genome(refsize=300_000, num_queries=512, query_len=100,
                         iterations=1, compare_reference=False,
                         full_verify=False, cache_dir=tmp_path)
    assert "k=2" in g["metric"] or "k=4" in g["metric"]  # 100 % 3 != 0
    assert g["detail"]["bit_exact_vs_oracle"]
    g0 = run_bench_genome(refsize=300_000, num_queries=512, query_len=120,
                          iterations=1, lut_m=0, compare_reference=False,
                          full_verify=False, cache_dir=tmp_path)
    assert g0["detail"]["lut_m"] == 0
    assert g0["detail"]["bit_exact_vs_oracle"]


class _Dev:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


@pytest.mark.parametrize(
    "platform,kind,want",
    [
        ("gpu", "NVIDIA H100 80GB HBM3", 3.35e12),
        ("cpu", "cpu", None),
        ("gpu", "NVIDIA Unknown 1GB", ValueError),
    ],
)
def test_hbm_peak_table(platform, kind, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="no published HBM peak"):
            hbm_peak_bytes_per_s(_Dev(platform, kind))
    else:
        assert hbm_peak_bytes_per_s(_Dev(platform, kind)) == want


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    import jax

    from tpufm.utils.compile_cache import DEFAULT_CACHE_DIR, enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(DEFAULT_CACHE_DIR)
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert DEFAULT_CACHE_DIR.name == ".jaxcache"
    assert DEFAULT_CACHE_DIR.parent == Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "argv",
    [
        ["search", "i.fmi", "q.qry", "12", "4", "--engine", "pallas"],
        ["bench", "--engine", "pallas"],
        ["sweep", "--engines", "pallas"],
    ],
)
def test_pallas_engine_rejected(argv, capsys):
    from tpufm import cli

    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert "invalid choice: 'pallas'" in capsys.readouterr().err
