#!/usr/bin/env python
"""One-card smoke run of the tpufm main path on a GPU.

Drives the command-line interface in-process (tpufm.cli.main, the code
behind the `tpufm` command) over a 750 Mbase reference of seeded uniform
DNA, the smallest reference of the reference suite's protocol:

  phase 0  env      platform, device kind and count, JAX version, card
  phase 1  build    `tpufm build --auto --on-device` at full size; at
                    10 Mbase the device build must equal the host build
  phase 2  search   1,048,576 x 120 bp reads; a seeded 65,536-read sample
                    and 8,192 reads absent from the text bit-exact against
                    search_oracle
  phase 3  locate   fused on-device locate of 65,536 reads (each planted
                    origin among its positions); 100,000 2 x 150 bp FR
                    pairs placed to BAM, sorted and counted, every pair
                    proper at its planted positions and strands
  phase 4  approx   `--mismatches 2` and `--edits 1` on 16,384 reads with
                    planted errors; origins recovered, every reported site
                    checked against the text

Every result is an integer, so every comparison is exact. Each phase
prints one JSON line (wall and compile seconds, the device's peak bytes
so far in the process, the counts it verified); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
A failed check raises and the run ends with "ok": false and exit code 1.
Without a GPU the script exits with code 2 and prints no result.

--mesh 4 runs only the four-card path: data-parallel search and the
sharded-index search under each routing, each bit-identical to the
one-card search and each holding its share of the index on every card,
and the 4-way sharded build byte-identical to the one-card device build.

    python chip_smoke.py [--refsize N] [--mesh 4]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


class SmokeFailure(AssertionError):
    """A phase's result did not match its reference."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Sizes of one run. The defaults are the full run."""

    refsize: int = 750_000_000
    parity_refsize: int = 10_000_000
    reads: int = 1 << 20
    read_len: int = 120
    oracle_sample: int = 1 << 16
    absent: int = 8192
    locate_reads: int = 1 << 16
    pairs: int = 100_000
    pair_len: int = 150
    insert_min: int = 300
    insert_max: int = 500
    approx_reads: int = 16_384
    lut: int = 12
    seed: int = 0


@dataclasses.dataclass
class Smoke:
    """State shared by the phases of one run."""

    plan: Plan
    work: Path
    codes: np.ndarray | None = None
    config: dict | None = None

    @property
    def ref(self) -> Path:
        return self.work / "ref.fa"

    @property
    def index(self) -> Path:
        return self.work / "idx.tpufm"

    @property
    def store(self) -> Path:
        return self.work / "pre"


def cli(*argv) -> str:
    """Run `tpufm <argv>` in-process; its output goes to stderr and is
    returned."""
    from tpufm import cli as tpufm_cli

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            sys.stderr.write(s)
            return buf.write(s)

    with contextlib.redirect_stdout(Tee()):
        tpufm_cli.main([str(a) for a in argv])
    return buf.getvalue()


def write_fasta(path: Path, codes: np.ndarray) -> None:
    from tpufm.io.fasta import write_reference
    from tpufm.utils.encoding import decode_bases

    write_reference(path, decode_bases(codes))


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them (a child
    process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------- phases


def phase_env(s: Smoke) -> dict:
    import jax

    devs = jax.devices()
    smi = card_info()
    print(smi)
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "jax": jax.__version__,
        "nvidia_smi": smi,
    }


def _load(path):
    from tpufm.index.store import load_store

    return load_store(path)


#: the arrays two builds of one text must agree on, byte for byte
INDEX_ARRAYS = ("occ", "bitmaps", "dollar_pos", "dollar_base")


def _same_index(a, b) -> list[str]:
    """Names of the index arrays in which a and b differ."""
    return [
        name for name in INDEX_ARRAYS
        if not np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name)))
    ] + ([] if a.bwtsize == b.bwtsize else ["bwtsize"])


def _make_reference(s: Smoke) -> None:
    """Build the native host library and write the seeded reference."""
    subprocess.run(["make", "-s", "-C", str(ROOT / "native")], check=True)
    rng = np.random.default_rng(s.plan.seed)
    s.codes = rng.integers(0, 4, size=s.plan.refsize, dtype=np.uint8)
    write_fasta(s.ref, s.codes)


class _RoundLog(logging.Handler):
    """Collects the device suffix sort's per-round timings."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.rounds: list[str] = []

    def emit(self, record):
        self.rounds.append(record.getMessage())


def phase_build(s: Smoke) -> dict:
    p = s.plan
    _make_reference(s)

    # device build == host build, array for array, at the parity size
    small = s.work / "parity.fa"
    write_fasta(small, s.codes[: p.parity_refsize])
    dev_small, host_small = s.work / "parity_dev.tpufm", s.work / "parity_host.tpufm"
    cli("build", small, p.parity_refsize, "--auto", "--on-device",
        "--output", dev_small)
    cli("build", small, p.parity_refsize, "--auto", "--output", host_small)
    diff = _same_index(_load(dev_small), _load(host_small))
    check(not diff, f"device build differs from host build in {diff}")

    sa_log = _RoundLog()
    logger = logging.getLogger("tpufm.index.sa_device")
    logger.addHandler(sa_log)
    logger.setLevel(logging.INFO)
    try:
        out = cli("build", s.ref, p.refsize, "--auto", "--on-device",
                  "--output", s.index)
    finally:
        logger.removeHandler(sa_log)
    index = _load(s.index)
    k, d = index.config.k, index.config.d
    s.config = {"k": k, "d": d}
    check(index.bwtsize == p.refsize + 1, "bwtsize != refsize + 1")
    return {
        "parity_bases": p.parity_refsize,
        "parity_arrays_equal": len(INDEX_ARRAYS),
        "k": k,
        "d": d,
        "bwtsize": index.bwtsize,
        "entries": index.nentries,
        "build_line": next(l for l in out.splitlines() if l.startswith("built")),
        "sa_rounds": sa_log.rounds,
    }


def _time_line(out: str) -> float:
    return float(next(l for l in out.splitlines()
                      if l.startswith("TIME:")).split()[-1])


def phase_search(s: Smoke) -> dict:
    from tpufm.engine.oracle import search_oracle
    from tpufm.io.genreads import generate_reads, write_reads_fasta
    from tpufm.io.results import load_results

    p = s.plan
    reads_q, reads_res = s.work / "reads.qry", s.work / "reads.res"
    cli("genreads", s.ref, p.refsize, p.read_len, p.reads,
        "--seed", p.seed + 1, "--output", reads_q)
    out = cli("search", s.index, reads_q, p.read_len, p.reads,
              "--lut", p.lut, "--iterations", 1, "--output", reads_res)
    res = load_results(reads_res)
    check(res.shape == (p.reads, 2), f"result shape {res.shape}")

    rng = np.random.default_rng(p.seed + 2)
    absent = rng.integers(0, 4, size=(p.absent, p.read_len), dtype=np.uint8)
    absent_q, absent_res = s.work / "absent.qry", s.work / "absent.res"
    write_reads_fasta(absent_q, absent)
    cli("search", s.index, absent_q, p.read_len, p.absent,
        "--lut", p.lut, "--iterations", 1, "--output", absent_res)
    res_absent = load_results(absent_res)

    index = _load(s.index)
    reads = generate_reads(s.codes, p.read_len, p.reads, seed=p.seed + 1)
    sample = np.sort(rng.choice(p.reads, p.oracle_sample, replace=False))
    want = search_oracle(index, reads[sample])
    check(np.array_equal(res[sample], want), "search differs from the oracle")
    check(bool((want[:, 1] > want[:, 0]).all()), "a text read has R <= L")
    want_absent = search_oracle(index, absent)
    check(np.array_equal(res_absent, want_absent),
          "absent-read search differs from the oracle")
    check(bool((want_absent[:, 1] == want_absent[:, 0]).all()),
          "a random read occurs in the text")
    return {
        "reads": p.reads,
        "search_seconds_per_pass": _time_line(out),
        "oracle_checked": p.oracle_sample,
        "absent_checked": p.absent,
    }


def _read_pos(path: Path) -> list[np.ndarray]:
    with open(path) as fp:
        return [np.array(l.split(), dtype=np.int64) for l in fp]


def phase_locate(s: Smoke) -> dict:
    from tpufm.io.bam import read_bam
    from tpufm.io.genreads import generate_read_pairs, generate_reads

    p = s.plan
    k, d = s.config["k"], s.config["d"]
    loc_q, loc_pos = s.work / "loc.qry", s.work / "loc.pos"
    cli("genreads", s.ref, p.refsize, p.read_len, p.locate_reads,
        "--seed", p.seed + 3, "--output", loc_q)
    cli("locate", s.ref, p.refsize, loc_q, p.read_len, p.locate_reads,
        "--k", k, "--d", d, "--fused", "--on-device", "--lut", p.lut,
        "--store", s.store, "--output", loc_pos)
    _, starts = generate_reads(s.codes, p.read_len, p.locate_reads,
                               seed=p.seed + 3, return_starts=True)
    pos = _read_pos(loc_pos)
    check(len(pos) == p.locate_reads, f"{len(pos)} position lines")
    missed = sum(int(o not in set(row.tolist())) for o, row in zip(starts, pos))
    check(missed == 0, f"{missed} planted origins not located")

    base = s.work / "pairs"
    cli("genreads", s.ref, p.refsize, p.pair_len, p.pairs, "--paired",
        "--insert-min", p.insert_min, "--insert-max", p.insert_max,
        "--seed", p.seed + 4, "--output", base)
    bam, sorted_bam = s.work / "pairs.bam", s.work / "pairs.sorted.bam"
    cli("locate", s.ref, p.refsize, f"{base}_1.qry", p.pair_len, p.pairs,
        "--from-store", s.store, "--paired", f"{base}_2.qry",
        "--insert-min", p.insert_min, "--insert-max", p.insert_max,
        "--lut", p.lut, "--bam", "--output", bam)
    cli("sort", bam, "--output", sorted_bam)
    stats = cli("flagstat", sorted_bam)
    proper = int(next(l for l in stats.splitlines()
                      if l.endswith("properly paired")).split()[0])
    check(proper == 2 * p.pairs, f"flagstat: {proper} properly paired")

    _, _, (left, right, minus) = generate_read_pairs(
        s.codes, p.pair_len, p.pairs, p.insert_min, p.insert_max,
        seed=p.seed + 4, return_truth=True,
    )
    _, records = read_bam(str(sorted_bam))
    primary = [r for r in records if not int(r[1]) & 0x900]
    check(len(primary) == 2 * p.pairs, f"{len(primary)} primary records")
    placed = 0
    for r in primary:
        i, flag, pos0 = int(r[0][3:]), int(r[1]), int(r[3]) - 1
        read1 = bool(flag & 0x40)
        # R1 is the fragment head on plus for even pairs, its rc'd tail
        # on minus for odd ones; R2 is the other end
        on_minus = read1 == bool(minus[i])
        want = right[i] if on_minus else left[i]
        check(flag & 0x3 == 0x3, f"pair {i} not properly paired")
        check(bool(flag & 0x10) == on_minus, f"pair {i} on the wrong strand")
        check(pos0 == want, f"pair {i} at {pos0}, planted at {want}")
        placed += 1
    return {
        "located_reads": p.locate_reads,
        "origins_found": p.locate_reads - missed,
        "pairs": p.pairs,
        "properly_paired_records": proper,
        "records_at_planted_position_and_strand": placed,
    }


def _plant_substitutions(rng, reads, m):
    """Exactly m substitutions per read, at distinct positions."""
    reads = reads.copy()
    n, length = reads.shape
    pos = np.argsort(rng.random((n, length)), axis=1)[:, :m]
    off = rng.integers(1, 4, size=(n, m)).astype(np.uint8)
    rows = np.arange(n)[:, None]
    reads[rows, pos] = (reads[rows, pos] + off) & 3
    return reads


def _plant_edits(rng, codes, origins, length, edits):
    """Reads of `length` taken from codes at origins after `edits` random
    substitutions, deletions or insertions."""
    reads = np.empty((origins.size, length), np.uint8)
    for i, s0 in enumerate(origins):
        w = list(codes[s0 : s0 + length + edits])
        for _ in range(edits):
            op = rng.integers(0, 3)
            q = int(rng.integers(0, len(w) - 1))
            if op == 0:
                w[q] = (w[q] + int(rng.integers(1, 4))) & 3
            elif op == 1:
                del w[q]
            else:
                w.insert(q, int(rng.integers(0, 4)))
        reads[i] = w[:length]
    return reads


def _site_edit_distance(codes, reads, sites, read_idx, edits):
    """Start-anchored, free-end edit distance of reads[read_idx[j]] against
    the text from sites[j] on (min over ends of edit(read, codes[s:e])),
    one vectorized DP over all (read, site) pairs."""
    length = reads.shape[1]
    width = length + edits
    cols = sites[:, None] + np.arange(width)[None, :]
    text = np.where(cols < codes.size, codes[np.minimum(cols, codes.size - 1)], 4)
    q = reads[read_idx]
    ar = np.arange(width + 1)
    prev = np.broadcast_to(ar, (sites.size, width + 1)).copy()
    for i in range(1, length + 1):
        sub = (text != q[:, i - 1 : i]).astype(np.int64)
        t = np.minimum(prev[:, :-1] + sub, prev[:, 1:] + 1)
        c = np.concatenate([np.full((sites.size, 1), i), t], axis=1)
        prev = np.minimum.accumulate(c - ar, axis=1) + ar
    return prev.min(axis=1)


def phase_approx(s: Smoke) -> dict:
    from tpufm.io.genreads import generate_reads, write_reads_fasta

    p = s.plan
    rng = np.random.default_rng(p.seed + 5)
    exact, origins = generate_reads(s.codes, p.read_len, p.approx_reads,
                                    seed=p.seed + 6, return_starts=True)
    mm = _plant_substitutions(rng, exact, 2)
    mm_q, mm_pos = s.work / "mm.qry", s.work / "mm.pos"
    write_reads_fasta(mm_q, mm, origins)
    cli("locate", s.ref, p.refsize, mm_q, p.read_len, p.approx_reads,
        "--from-store", s.store, "--mismatches", 2, "--lut", p.lut,
        "--output", mm_pos)
    rows = _read_pos(mm_pos)
    check(len(rows) == p.approx_reads, f"{len(rows)} mismatch lines")
    missed = sum(int(o not in set(r.tolist())) for o, r in zip(origins, rows))
    check(missed == 0, f"{missed} mismatch origins not recovered")
    sites = np.concatenate(rows)
    owner = np.repeat(np.arange(len(rows)), [r.size for r in rows])
    win = s.codes[sites[:, None] + np.arange(p.read_len)[None, :]]
    ham = (win != mm[owner]).sum(axis=1)
    check(bool((ham <= 2).all()), f"{int((ham > 2).sum())} sites over 2 mismatches")

    edits = 1
    e_origins = rng.integers(0, p.refsize - p.read_len - edits,
                             size=p.approx_reads)
    ed = _plant_edits(rng, s.codes, e_origins, p.read_len, edits)
    ed_q, ed_pos = s.work / "ed.qry", s.work / "ed.pos"
    write_reads_fasta(ed_q, ed, e_origins)
    cli("locate", s.ref, p.refsize, ed_q, p.read_len, p.approx_reads,
        "--from-store", s.store, "--edits", edits, "--lut", p.lut,
        "--output", ed_pos)
    erows = _read_pos(ed_pos)
    check(len(erows) == p.approx_reads, f"{len(erows)} edit lines")
    far = sum(
        int(r.size == 0 or np.abs(r - o).min() > 2 * edits)
        for o, r in zip(e_origins, erows)
    )
    check(far == 0, f"{far} edit origins not recovered within 2E")
    esites = np.concatenate(erows)
    eowner = np.repeat(np.arange(len(erows)), [r.size for r in erows])
    dist = _site_edit_distance(s.codes, ed, esites, eowner, edits)
    check(bool((dist <= edits).all()),
          f"{int((dist > edits).sum())} sites over {edits} edit(s)")
    return {
        "mismatch_reads": p.approx_reads,
        "mismatch_origins_found": p.approx_reads - missed,
        "mismatch_sites_checked": int(sites.size),
        "edit_reads": p.approx_reads,
        "edit_origins_within_2E": p.approx_reads - far,
        "edit_sites_checked": int(esites.size),
    }


def _in_use(devs) -> list[int] | None:
    stats = [dev.memory_stats() for dev in devs]
    if not all(stats):
        return None  # the CPU reports no memory stats
    return [int(st["bytes_in_use"]) for st in stats]


@contextlib.contextmanager
def _held_engines():
    """Keep every search engine the CLI makes alive until the block ends,
    so the device bytes its tables hold can be read after the command has
    returned."""
    from tpufm import cli as tpufm_cli

    made, make = [], tpufm_cli._make_engine

    def keep(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    tpufm_cli._make_engine = keep
    try:
        yield made
    finally:
        tpufm_cli._make_engine = make
        made.clear()
        gc.collect()


def phase_mesh(s: Smoke, n: int = 4) -> dict:
    """The four-card path and what it is compared with, nothing else.

    Placement is read from the device allocators, so a search or build
    that lands everything on device 0 fails: the sharded build runs first,
    while no other work has touched the cards, and each card's peak must
    cover its shard of the suffix sort; each search engine is held after
    its command and each card must hold its share of the entry table
    (a quarter for the sharded engine, all of it for data parallelism)."""
    import jax

    from tpufm.io.results import load_results

    p = s.plan
    devs = jax.devices()[:n]
    check(len(devs) == n, f"--mesh {n} needs {n} devices")
    _make_reference(s)
    one, sharded = s.work / "one.tpufm", s.work / "mesh.tpufm"
    cli("build", s.ref, p.refsize, "--auto", "--on-device", "--mesh", n,
        "--output", sharded)
    build_peaks = [_peak(dev) for dev in devs]
    if build_peaks[0] is not None:
        rank_shard = 4 * (p.refsize + 1) // n  # one u32 array's shard
        check(min(build_peaks) >= rank_shard,
              f"sharded build peaks {build_peaks} below one shard ({rank_shard} B)")
    cli("build", s.ref, p.refsize, "--auto", "--on-device", "--output", one)
    diff = _same_index(_load(sharded), _load(one))
    check(not diff, f"{n}-way sharded build differs from one card in {diff}")

    reads_q = s.work / "reads.qry"
    cli("genreads", s.ref, p.refsize, p.read_len, p.reads,
        "--seed", p.seed + 1, "--output", reads_q)
    common = (reads_q, p.read_len, p.reads, "--lut", p.lut, "--iterations", 1)
    cli("search", one, *common, "--output", s.work / "one.res")
    want = load_results(s.work / "one.res")
    check(bool((want[:, 1] > want[:, 0]).all()), "a text read has R <= L")
    index = _load(one)
    table = index.occ.nbytes + index.bitmaps.nbytes
    runs = {"dp": ("--mesh", n)}
    for routing in ("allgather", "ring", "a2a"):
        runs[f"sharded_{routing}"] = ("--mesh", n, "--sharded",
                                      "--routing", routing)
    times, held = {}, {}
    for name, flags in runs.items():
        before = _in_use(devs)
        with _held_engines() as engines:
            out = cli("search", one, *common, *flags,
                      "--output", s.work / f"{name}.res")
            check(len(engines) == 1, f"{name}: {len(engines)} engines")
            after = _in_use(devs)
        got = load_results(s.work / f"{name}.res")
        check(np.array_equal(got, want), f"{name} search differs from one card")
        times[name] = _time_line(out)
        held[name] = after and [a - b for a, b in zip(after, before)]
        if held[name] is not None:
            need = table if name == "dp" else table // n
            check(min(held[name]) >= need,
                  f"{name}: per-device table bytes {held[name]} below {need}")
    return {
        "devices": n,
        "sharded_build_arrays_equal": len(INDEX_ARRAYS),
        "sharded_build_peak_bytes": build_peaks,
        "reads": p.reads,
        "bit_identical_to_one_card": sorted(runs),
        "search_seconds_per_pass": times,
        "table_bytes": table,
        "per_device_table_bytes": held,
        "per_device_peak_bytes": [_peak(dev) for dev in devs],
    }


PHASES = {
    "env": phase_env,
    "build": phase_build,
    "search": phase_search,
    "locate": phase_locate,
    "approx": phase_approx,
}


# ---------------------------------------------------------------- runner


def _peak(dev) -> int | None:
    stats = dev.memory_stats()
    return int(stats["peak_bytes_in_use"]) if stats else None


def run_phase(name: str, fn, s: Smoke) -> dict:
    """Run one phase and print its JSON line: wall seconds, compile
    seconds (trace, lowering and backend compile), the device's peak
    bytes so far, and what the phase verified."""
    import jax
    from jax import monitoring

    compile_s = [0.0]

    def on_event(event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            compile_s[0] += duration

    monitoring.register_event_duration_secs_listener(on_event)
    t0 = time.perf_counter()
    try:
        counts = fn(s)
    finally:
        monitoring.unregister_event_duration_listener(on_event)
    line = {
        "phase": name,
        "wall_seconds": time.perf_counter() - t0,
        "compile_seconds": compile_s[0],
        "peak_bytes_in_use": _peak(jax.devices()[0]),
        **counts,
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refsize", type=int, default=Plan.refsize)
    ap.add_argument("--mesh", type=int, default=0, choices=[0, 4],
                    help="run only the four-card path")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    from tpufm.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    plan = Plan(refsize=args.refsize,
                parity_refsize=min(Plan.parity_refsize, args.refsize))
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    ok = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        s = Smoke(plan=plan, work=Path(tmp))
        try:
            run_phase("env", phase_env, s)
            if args.mesh:
                run_phase("mesh", lambda s: phase_mesh(s, args.mesh), s)
            else:
                for name, fn in list(PHASES.items())[1:]:
                    run_phase(name, fn, s)
            ok = True
        finally:
            print(json.dumps({"ok": ok, "device": device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
