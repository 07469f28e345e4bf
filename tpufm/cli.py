"""tpufm command-line interface.

Mirrors the reference suite's binaries (SURVEY.md section 3 entry points):
  tpufm build <ref.fa> <refsize> [--k --d]         ~ gfmiBaseLine_<d>bases_<k>step
  tpufm transform <index.fmi> [--layouts ...]      ~ tfmiBMP / tfmiAC
  tpufm search <index> <reads.qry> <len> <n>       ~ fmIndexSearchCPU/GPU_*
  tpufm genreads <ref.fa> <refsize> <len> <n>      ~ resources/genreads.py
  tpufm bench ...                                  ~ the TIME: protocol + JSON record

What the reference fixed at compile time (-DK_STEPS/-DNUM_CHUNK, makefile:140-207)
are flags here, resolved at jit-specialization time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from tpufm.config import IndexConfig, Layout
from tpufm.index.builder import build_index
from tpufm.index.formats import write_fmi, read_fmi, save_npz, load_npz
from tpufm.io.fasta import read_reference, write_reference, load_queries
from tpufm.io.genreads import generate_reads, write_reads_fasta
from tpufm.io.results import write_results
from tpufm.utils.encoding import decode_bases


def _load_any_index(path: str):
    if path.endswith(".tpufm"):
        from tpufm.index.store import load_store

        index = load_store(path)
    elif path.endswith(".npz"):
        index = load_npz(path)
    else:
        index, _ = read_fmi(path)
    from tpufm.index.builder import KStepFMIndex
    from tpufm.index.layouts import AltCountersIndex

    if not isinstance(index, (KStepFMIndex, AltCountersIndex)):
        # e.g. a PREFIX.locate.tpufm store passed to `tpufm search`
        sys.exit(
            f"{path} holds a {type(index).__name__}, not a search index; "
            "expected a k-step FM-index store (use `tpufm locate "
            "--from-store PREFIX` for locate stores)"
        )
    return index


def cmd_build(args):
    codes = read_reference(args.reference, args.refsize)
    if args.auto:
        from tpufm.config import device_bytes_limit, recommend_config

        rec = recommend_config(args.refsize, bytes_limit=device_bytes_limit())
        args.k, args.d = rec["k"], rec["d"]
        print(f"auto config: k={args.k} d={args.d} (recommend lut_m={rec['lut_m']})")
    cfg = IndexConfig(k=args.k, d=args.d)
    t0 = time.perf_counter()
    if args.mesh and not args.on_device:
        sys.exit("build --mesh requires --on-device (the sharded build runs "
                 "on the accelerator mesh; the host build has no mesh mode)")
    if args.store_sharded and not (args.mesh and args.on_device):
        sys.exit("--store-sharded persists the device-resident sharded "
                 "tables; it requires --on-device --mesh N")
    if args.store_sharded and not (args.output or "").endswith(".tpufm"):
        # validate BEFORE the (potentially hours-long) build, not after
        sys.exit("--store-sharded writes a .tpufm store; pass "
                 "--output <name>.tpufm")
    # --tail: the k=1 sibling shares ONE suffix sort with the main build on
    # every path (host sa=, device/sharded sa_dev=); at k=1 the main index
    # IS the tail, no second build at all.
    want_tail = args.tail and args.k != 1
    tail = None
    if args.on_device and args.mesh:
        from tpufm.index.builder_sharded import build_index_sharded
        from tpufm.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh)
        order = None
        if want_tail:
            from tpufm.index.sa_sharded import suffix_array_sharded_arr

            order = suffix_array_sharded_arr(codes, mesh)
        index = build_index_sharded(
            codes, cfg, mesh, sa_dev=order,
            return_host=not args.store_sharded,
        )
        if want_tail:
            tail = build_index_sharded(
                codes, IndexConfig(k=1, d=args.d), mesh, sa_dev=order
            )
    elif args.on_device:
        from tpufm.index.builder_device import build_index_device

        order = None
        if want_tail:
            import jax
            import jax.numpy as jnp

            from tpufm.index.sa_device import suffix_array_device_arr

            order = suffix_array_device_arr(jax.device_put(jnp.asarray(codes)))
        index = build_index_device(codes, cfg, sa_dev=order)
        if want_tail:
            tail = build_index_device(
                codes, IndexConfig(k=1, d=args.d), sa_dev=order
            )
    else:
        sa = None
        if want_tail:
            from tpufm.index.suffix_array import suffix_array

            sa = suffix_array(codes, method=args.sa)
        index = build_index(codes, cfg, sa_method=args.sa, sa=sa)
        if want_tail:
            tail = build_index(codes, IndexConfig(k=1, d=args.d),
                               sa_method=args.sa, sa=sa)
    if args.tail and args.k == 1:
        tail = index
    print(f"built k={args.k} d={args.d} bwtsize={index.bwtsize} "
          f"entries={index.nentries} in {time.perf_counter() - t0:.1f}s"
          f"{' (on device)' if args.on_device else ''}")
    # Reference-compatible name: <ref>.<size>.<d>fmi<k>steps.fmi
    # (reference src/genFMindex.c:162)
    out = args.output or f"{args.reference}.{args.refsize}.{args.d}fmi{args.k}steps.fmi"
    if args.store_sharded:
        # The tables never touched the host (return_host=False above;
        # the optional k=1 TAIL still goes through the host — it is
        # ~7-8x smaller than the main table, <=1.5 GB at the formats'
        # 4 Gbase uint32 cap, so it never drives peak memory).
        from tpufm.index.store import save_store_sharded

        save_store_sharded(out, index)
    elif out.endswith(".tpufm"):
        from tpufm.index.store import save_store

        save_store(out, index)
    elif out.endswith(".npz"):
        save_npz(out, index)
    else:
        write_fmi(out, index, Layout.BASELINE)
    print(f"wrote {out}")
    if tail is not None:
        # sibling k=1 index: `tpufm search` auto-loads it to accept ANY
        # query length (the reference rejects L % k != 0 outright)
        save_npz(f"{out}.tail.npz", tail)
        print(f"wrote {out}.tail.npz (k=1 any-length tail index)")
    if args.save_ref:
        # normalized re-emitted FASTA (reference common/common.c:119-130)
        write_reference(f"{args.reference}.{args.refsize}.fa", decode_bases(codes))


def cmd_transform(args):
    index, layout = read_fmi(args.index)
    if layout != Layout.BASELINE:
        sys.exit("transform expects a tag-100 baseline .fmi")
    for name in args.layouts:
        target = Layout(name)
        suffix = {
            Layout.INTERLEAVED: ".interleaving",
            Layout.ALT_COUNTERS: ".ac",
            Layout.INTERLEAVED_ALT_COUNTERS: ".interleaving.ac",
        }[target]
        out = args.index + suffix
        write_fmi(out, index, target)
        print(f"wrote {out}")


def cmd_genreads(args):
    codes = read_reference(args.reference, args.refsize)
    if args.paired:
        from tpufm.io.genreads import generate_read_pairs

        r1, r2, (ls, rs, minus) = generate_read_pairs(
            codes, args.length, args.num, args.insert_min, args.insert_max,
            seed=args.seed, return_truth=True,
        )
        base = args.output or f"Q-{args.num}_B-{args.length}_R-{args.refsize}"
        if base.endswith(".qry"):
            base = base[:-4]
        write_reads_fasta(base + "_1.qry", r1, np.where(minus, rs, ls))
        write_reads_fasta(base + "_2.qry", r2, np.where(minus, ls, rs))
        print(
            f"wrote {base}_1.qry + {base}_2.qry ({args.num} FR pairs x "
            f"{args.length} bp, insert [{args.insert_min}, "
            f"{args.insert_max}])"
        )
        return
    reads, starts = generate_reads(
        codes, args.length, args.num, seed=args.seed, return_starts=True
    )
    out = args.output or f"Q-{args.num}_B-{args.length}_R-{args.refsize}.qry"
    write_reads_fasta(out, reads, starts)
    print(f"wrote {out} ({args.num} reads x {args.length} bp)")


def _maybe_tail(args, index):
    """Load the k=1 tail index when the query length needs one (any-length
    support); exits with guidance when it is needed but absent."""
    import os

    k = (index.base if hasattr(index, "base") else index).config.k
    if args.qrysize % k == 0:
        return None
    if hasattr(index, "base"):  # AltCountersIndex
        sys.exit(
            f"query length {args.qrysize} is not divisible by k={k} and "
            "the alt-counters layout cannot take k=1 tail rounds; use the "
            "baseline index (any-length) or pad reads to a multiple of k"
        )
    tpath = getattr(args, "tail", None) or f"{args.index}.tail.npz"
    if os.path.exists(tpath):
        return load_npz(tpath)
    # No precomputed sibling: the k=1 tail is fully derivable from the
    # index itself (level-0 bitplanes ARE BWT0) — any length just works.
    from tpufm.index.builder import derive_tail

    print(
        f"note: query length {args.qrysize} % k={k} != 0 — deriving the "
        f"k=1 tail from the index (`tpufm build --tail` precomputes it)"
    )
    return derive_tail(index)


def _rc_expand(queries):
    """Append every read's reverse complement: both strands ride ONE engine
    pass (same program, 2B batch lanes). Results split back with
    _emit_strands — minus-strand output lands in the `.rc` sibling."""
    from tpufm.utils.encoding import reverse_complement

    return np.concatenate([queries, reverse_complement(queries)])


def _emit_strands(out, rows, B, write_one):
    """write rows[:B] to `out`; when the batch was rc-doubled (_rc_expand),
    rows[B:] to `out`.rc — the one convention shared by search/count/locate."""
    write_one(out, rows[:B])
    print(f"wrote {out}")
    if rows.shape[0] > B:
        write_one(f"{out}.rc", rows[B:])
        print(f"wrote {out}.rc (minus strand)")


def _make_dp_search_locate(args, index, loc):
    """DataParallelSearchLocate for --mesh runs, or None. Length-
    independent (only the jitted programs specialize per shape), so the
    mixed-length align loop builds it ONCE and reuses it across its
    per-length groups — constructing it re-replicates the tables to
    every device."""
    if args.mesh is None:
        return None
    from tpufm.parallel import DataParallelSearchLocate, make_mesh

    return DataParallelSearchLocate(
        index, loc, make_mesh(args.mesh or None),
        max_hits=args.max_hits, lut_m=args.lut,
    )


def _single_end_positions(args, index, loc, codes, queries, dp=None):
    """Both-strand hit positions for one fixed-length read batch: the
    engine dispatch shared by `locate --sam` and the per-length groups of
    a mixed-length `align` run. Returns (pos uint32 [2B, max_hits] —
    forward strand rows first, then reverse complements — and the
    seed-overflow flags or None)."""
    from tpufm.utils.encoding import reverse_complement

    q2 = np.concatenate([queries, reverse_complement(queries)])
    if dp is None:
        dp = _make_dp_search_locate(args, index, loc)
    s_overflow = None
    if args.mismatches >= 2:
        if dp is not None:
            pos, _, s_overflow = dp.locate_approx(
                q2, codes, args.mismatches, seed_hits=args.seed_hits
            )
        else:
            from tpufm.engine.seed import SeedExtendEngine

            pos, _, s_overflow = SeedExtendEngine(
                index, loc, codes, mismatches=args.mismatches,
                seed_hits=args.seed_hits, max_hits=args.max_hits,
                lut_m=args.lut,
            ).locate_approx(q2)
    elif args.edits:
        if dp is not None:
            pos, _, s_overflow = dp.locate_edits(
                q2, codes, args.edits, seed_hits=args.seed_hits
            )
        else:
            from tpufm.engine.edit import EditExtendEngine

            pos, _, s_overflow = EditExtendEngine(
                index, loc, codes, edits=args.edits,
                seed_hits=args.seed_hits, max_hits=args.max_hits,
                lut_m=args.lut,
            ).locate_edits(q2)
    elif args.mismatches:
        if dp is not None:
            pos = dp.locate_mismatch(q2)
        else:
            from tpufm.engine.xla import SearchLocateEngine

            pos = SearchLocateEngine(
                index, loc, max_hits=args.max_hits, lut_m=args.lut
            ).locate_mismatch(q2)
    elif dp is not None:
        _, pos = dp.search_locate(q2)
    else:
        from tpufm.engine.xla import SearchLocateEngine

        _, pos = SearchLocateEngine(
            index, loc, max_hits=args.max_hits, lut_m=args.lut
        ).search_locate(q2)
    return pos, s_overflow


def _sharded_store_meta(path: str):
    """meta.json of a per-shard .tpufm store, or None."""
    if not path.endswith(".tpufm"):
        return None
    import json
    import os

    try:
        with open(os.path.join(path, "meta.json")) as fp:
            meta = json.load(fp)
    except (OSError, ValueError):
        return None
    return meta if meta.get("kind") == "kstep_sharded" else None


def cmd_search(args):
    if _sharded_store_meta(args.index):
        # Per-shard store: reassembled straight onto the mesh, no
        # whole-table host copy (index/store.py save_store_sharded).
        if not getattr(args, "sharded", False):
            sys.exit(f"{args.index} is a per-shard store; search it with "
                     "--sharded [--mesh N]")
        from tpufm.index.store import load_store_sharded
        from tpufm.parallel import make_mesh

        index = load_store_sharded(
            args.index, make_mesh(getattr(args, "mesh", None) or None)
        )
    else:
        index = _load_any_index(args.index)
    queries = load_queries(args.queries, args.qrysize, args.numqueries)
    tail = _maybe_tail(args, index)
    engine = _make_engine(index, args, tail_index=tail)
    out = args.output or f"{args.index}.res.gpu"

    B = queries.shape[0]
    if getattr(args, "rc", False):
        queries = _rc_expand(queries)

    def _emit(res):
        _emit_strands(out, res, B, write_results)

    if args.resume:
        # Checkpointed stream: each completed wave persists; a killed run
        # re-invoked with the same arguments continues where it stopped.
        from tpufm.io.stream import search_resumable

        stats: dict = {}
        res = search_resumable(engine, queries, out, stats=stats)
        # TIME: reports pure search seconds — checkpoint fsync I/O excluded
        # (it is resume overhead, not part of the reference protocol's pass).
        print(f"TIME: \t {stats['search_s']}")
        _emit(res)
        return

    iters = args.iterations
    res = engine.search(queries)  # warm-up + compile
    t0 = time.perf_counter()
    for _ in range(iters):
        res = engine.search(queries)
    dt = (time.perf_counter() - t0) / iters
    # Same one-number protocol as the reference (common/searchQueries.c:117-118).
    print(f"TIME: \t {dt}")

    _emit(res)


def _make_engine(index, args, tail_index=None):
    from tpufm.engine.xla import XLAEngine
    from tpufm.index.layouts import make_alt_counters
    from tpufm.index.builder import KStepFMIndex

    engine = getattr(args, "engine", "xla")
    lut_m = getattr(args, "lut", 0)
    mesh_n = getattr(args, "mesh", None)
    sharded = getattr(args, "sharded", False)
    if tail_index is not None and engine == "xla-ac":
        sys.exit(
            "any-length queries (tail index) are supported by --engine "
            "xla/xla-paired (single-chip, --mesh N, or --sharded); pad "
            "reads to a multiple of k for xla-ac"
        )

    if mesh_n is not None or sharded:
        # Multi-chip engines behind the same CLI surface the reference's
        # searcher binaries had (common/searchQueries.c:34-132): --mesh N
        # shards the batch data-parallel over N chips (index replicated);
        # --sharded shards the ENTRY TABLE over the mesh for >HBM indexes,
        # with --routing picking the collective plan.
        from tpufm.parallel import (
            make_mesh,
            DataParallelEngine,
            ShardedIndexEngine,
        )

        mesh = make_mesh(mesh_n or None)  # 0 = all local devices
        if sharded:
            if engine == "xla-ac":
                # Deliberate: the baseline counter layout IS the
                # memory-optimal sharded layout (docs/DISTRIBUTED.md).
                sys.exit("--sharded uses the baseline layout; drop --engine xla-ac")
            return ShardedIndexEngine(
                index,
                mesh,
                routing=getattr(args, "routing", "allgather"),
                lut_m=lut_m,
                tail_index=tail_index,
            )
        if engine == "xla-ac" and isinstance(index, KStepFMIndex):
            index = make_alt_counters(index)
        return DataParallelEngine(
            index,
            mesh,
            lut_m=lut_m,
            lut_cache=f"{args.index}.lut{lut_m}.npz" if lut_m else None,
            pad_words=getattr(args, "pad_words", None),
            tail_index=tail_index,
        )

    if engine == "xla-ac" and isinstance(index, KStepFMIndex):
        index = make_alt_counters(index)
    if engine == "xla-paired":
        if not lut_m:
            sys.exit("--engine xla-paired requires --lut M (e.g. --lut 12)")
        return XLAEngine(
            index, layout="paired", lut_m=lut_m,
            lut_cache=f"{args.index}.lut{lut_m}.npz",
            tail_index=tail_index,
        )
    return XLAEngine(
        index,
        lut_m=lut_m,
        # cache the device-built LUT next to the index: subsequent searches
        # load it instead of re-running the 4^m m-mer batch search
        lut_cache=f"{args.index}.lut{lut_m}.npz" if lut_m else None,
        pad_words=getattr(args, "pad_words", None),
        tail_index=tail_index,
    )


def cmd_count(args):
    """Occurrence counts per read — exact (R - L) or within Hamming
    distance 1 (`--mismatches 1`: on-device 3L+1 variant expansion, full
    sensitivity; tpufm extension, the reference has no approximate
    matching). One integer per line."""
    from tpufm.engine.xla import XLAEngine
    from tpufm.index.builder import KStepFMIndex

    index = _load_any_index(args.index)
    if not isinstance(index, KStepFMIndex):
        sys.exit("count needs a baseline-layout index (not alt-counters)")
    queries = load_queries(args.queries, args.qrysize, args.numqueries)
    tail = _maybe_tail(args, index)
    B = queries.shape[0]
    if args.rc:
        queries = _rc_expand(queries)
    lut_cache = f"{args.index}.lut{args.lut}.npz" if args.lut else None
    if args.mesh is not None:
        from tpufm.parallel import DataParallelEngine, make_mesh

        engine = DataParallelEngine(
            index, make_mesh(args.mesh or None),
            lut_m=args.lut, lut_cache=lut_cache, tail_index=tail,
        )
    else:
        engine = XLAEngine(
            index, lut_m=args.lut, lut_cache=lut_cache, tail_index=tail
        )

    cnt = engine.count(queries, mismatches=args.mismatches)  # warm + compile
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        cnt = engine.count(queries, mismatches=args.mismatches)
    print(f"TIME: \t {(time.perf_counter() - t0) / args.iterations}")

    out = args.output or f"{args.queries}.cnt"
    _emit_strands(out, cnt, B, lambda p, a: np.savetxt(p, a, fmt="%d"))


def cmd_bench(args):
    if args.mismatches < 0 or args.edits < 0:
        sys.exit("--mismatches/--edits must be >= 0")
    if getattr(args, "genome", False):
        from tpufm.bench import run_bench_genome

        # None defaults resolve per mode: the genome record defaults to
        # 250 Mbase and recommend_config's lut; an EXPLICIT --refsize or
        # --lut (including --lut 0, the LUT-free HBM path) is honored.
        print(json.dumps(run_bench_genome(
            refsize=args.refsize if args.refsize is not None else 250_000_000,
            num_queries=args.numqueries,
            query_len=args.length,
            iterations=args.iterations,
            seed=args.seed,
            lut_m=args.lut,
        )))
        return
    args.refsize = args.refsize if args.refsize is not None else 10_000_000
    args.lut = args.lut if args.lut is not None else 0
    if args.edits and args.mismatches:
        sys.exit("--edits (indel-aware) and --mismatches (substitutions "
                 "only) are different distance models; pass one")
    if getattr(args, "paired_bench", False):
        if (args.edits or args.mismatches or args.locate or args.sharded
                or args.multichip):
            sys.exit("--paired is its own bench mode; drop "
                     "--edits/--mismatches/--locate/--sharded/--multichip")
        from tpufm.bench import run_bench_paired

        record = run_bench_paired(
            refsize=args.refsize,
            k=args.k,
            d=args.d,
            sample_rate=args.sample_rate,
            num_pairs=args.numqueries,
            query_len=args.length,
            insert_min=args.insert_min,
            insert_max=args.insert_max,
            iterations=args.iterations,
            seed=args.seed,
            lut_m=args.lut,
            max_hits=args.max_hits,
        )
        print(json.dumps(record))
        return
    if (args.edits or args.mismatches >= 2) and (
        args.locate or args.sharded or args.multichip
    ):
        sys.exit("bench --edits/--mismatches>=2 are single-chip records; "
                 "drop --locate/--sharded/--multichip")
    if args.edits:
        from tpufm.bench import run_bench_edit

        record = run_bench_edit(
            refsize=args.refsize,
            k=args.k,
            d=args.d,
            sample_rate=args.sample_rate,
            num_queries=args.numqueries,
            query_len=args.length,
            iterations=args.iterations,
            seed=args.seed,
            lut_m=args.lut,
            edits=args.edits,
            seed_hits=args.seed_hits,
            max_hits=args.max_hits,
        )
        print(json.dumps(record))
        return
    if args.mismatches >= 2:
        from tpufm.bench import run_bench_seed

        record = run_bench_seed(
            refsize=args.refsize,
            k=args.k,
            d=args.d,
            sample_rate=args.sample_rate,
            num_queries=args.numqueries,
            query_len=args.length,
            iterations=args.iterations,
            seed=args.seed,
            lut_m=args.lut,
            mismatches=args.mismatches,
            seed_hits=args.seed_hits,
            max_hits=args.max_hits,
        )
        print(json.dumps(record))
        return
    if args.mismatches:
        from tpufm.bench import run_bench_mismatch

        record = run_bench_mismatch(
            refsize=args.refsize,
            k=args.k,
            d=args.d,
            num_queries=args.numqueries,
            query_len=args.length,
            iterations=args.iterations,
            seed=args.seed,
            lut_m=args.lut,
        )
        print(json.dumps(record))
        return
    if args.locate and args.fused:
        from tpufm.bench import run_bench_search_locate

        record = run_bench_search_locate(
            refsize=args.refsize,
            k=args.k,
            d=args.d,
            sample_rate=args.sample_rate,
            num_queries=args.numqueries,
            query_len=args.length,
            iterations=args.iterations,
            seed=args.seed,
            lut_m=args.lut,
            max_hits=args.max_hits,
        )
    elif args.locate:
        from tpufm.bench import run_bench_locate

        record = run_bench_locate(
            refsize=args.refsize,
            d=args.d,
            sample_rate=args.sample_rate,
            num_rows=args.numqueries,
            iterations=args.iterations,
            seed=args.seed,
            n_devices=(args.mesh or None) if args.multichip or args.mesh else 1,
        )
    elif args.sharded:
        from tpufm.bench import run_bench_sharded

        record = run_bench_sharded(
            refsize=args.refsize,
            k=args.k,
            d=args.d,
            num_queries=args.numqueries,
            query_len=args.length,
            iterations=args.iterations,
            seed=args.seed,
            lut_m=args.lut,
            routing=args.routing,
        )
    elif args.multichip:
        from tpufm.bench import run_bench_multichip

        record = run_bench_multichip(
            refsize=args.refsize,
            k=args.k,
            d=args.d,
            num_queries=args.numqueries,
            query_len=args.length,
            iterations=args.iterations,
            seed=args.seed,
            lut_m=args.lut,
        )
    else:
        from tpufm.bench import run_bench

        record = run_bench(
            refsize=args.refsize,
            k=args.k,
            d=args.d,
            num_queries=args.numqueries,
            query_len=args.length,
            iterations=args.iterations,
            seed=args.seed,
            engine=args.engine,
            lut_m=args.lut,
        )
    print(json.dumps(record))


def cmd_sweep(args):
    """The experiment matrix (reference scripts/sge_searchcpu*.sh) in one
    process; JSON-lines records."""
    from tpufm.sweep import run_sweep

    records = run_sweep(
        refsizes=tuple(args.refsizes),
        ks=tuple(args.ks),
        ds=tuple(args.ds),
        engines=tuple(args.engines),
        lut_ms=tuple(args.luts),
        num_queries=args.numqueries,
        query_len=args.length,
        iterations=args.iterations,
        out_path=args.output,
    )
    bad = [r for r in records if r.get("bit_exact") is False]
    if bad:
        sys.exit(
            f"SWEEP FAILED: {len(bad)}/{len(records)} rows not bit-exact "
            f"vs oracle (first: {bad[0]})"
        )


def cmd_dumpentry(args):
    """Print one entry's counters + bitmap words — the transforms' argv-gated
    checksum/debug mode (reference src/transformIndexBitmaps.c:197-267,
    src/transformIndexAlternateCounters.c:301-385)."""
    from tpufm.index.layouts import AltCountersIndex

    index = _load_any_index(args.index)
    if isinstance(index, AltCountersIndex):
        occ, base = index.occ_slim, index.base
        label = "counters (slim half)"
    else:
        occ, base = index.occ, index
        label = "counters"
    for e in range(args.entry, min(args.entry + args.num, base.nentries + 1)):
        print(f"entry {e}:")
        print(f"  {label}:", occ[e].tolist())
        for lvl in range(base.config.k):
            for plane in range(2):
                words = [f"{w:08x}" for w in base.bitmaps[e, lvl, plane]]
                print(f"  bwt{lvl} plane{plane}: {' '.join(words)}")


def cmd_locate(args):
    """Search + resolve text positions (tpufm extension — the reference only
    reports interval counts). Builds index + sampled-SA tables from one
    suffix sort — or, with --from-store PREFIX, loads prebuilt
    PREFIX.search.tpufm + PREFIX.locate.tpufm and runs with NO rebuild.
    --store PREFIX persists both after a build. Writes '<out>: one line per
    query: pos pos ...'."""
    if getattr(args, "bam", False):
        args.sam = True  # --bam is the binary serialization of --sam
    index, loc, codes = _locate_tables(args)
    queries = load_queries(args.queries, args.qrysize, args.numqueries)
    nq = queries.shape[0]
    _locate_body(args, index, loc, codes, queries, nq)


def _locate_tables(args):
    """Acquire (index, locate tables, codes) for cmd_locate/cmd_align:
    prebuilt stores, sharded/on-device build, or a host build — one shared
    suffix sort either way. codes is None in --from-store mode (re-read by
    the branches that need the text). Honors --store persistence."""
    from tpufm.index.locate import build_locate
    from tpufm.index.suffix_array import suffix_array

    codes = None
    if args.from_store:
        from tpufm.index.store import load_store

        index = load_store(f"{args.from_store}.search.tpufm")
        loc = load_store(f"{args.from_store}.locate.tpufm")
    elif args.on_device and args.mesh:
        # sharded build: one mesh suffix sort shared by both table sets
        from tpufm.index.builder_sharded import (
            build_index_sharded,
            build_locate_sharded,
        )
        from tpufm.index.sa_sharded import suffix_array_sharded_arr
        from tpufm.parallel import make_mesh as _mk

        bmesh = _mk(args.mesh)
        codes = read_reference(args.reference, args.refsize)
        order = suffix_array_sharded_arr(codes, bmesh)
        index = build_index_sharded(
            codes, IndexConfig(k=args.k, d=args.d), bmesh, sa_dev=order
        )
        loc = build_locate_sharded(
            codes, sample_rate=args.sample_rate, d=args.d, mesh=bmesh,
            sa_dev=order,
        )
    elif args.on_device:
        # one device suffix sort shared by the search index + locate tables
        import jax
        import jax.numpy as jnp

        from tpufm.index.builder_device import (
            build_index_device,
            build_locate_device,
        )
        from tpufm.index.sa_device import suffix_array_device_arr

        codes = read_reference(args.reference, args.refsize)
        order = suffix_array_device_arr(jax.device_put(jnp.asarray(codes)))
        index = build_index_device(
            codes, IndexConfig(k=args.k, d=args.d), sa_dev=order
        )
        loc = build_locate_device(
            codes, sample_rate=args.sample_rate, d=args.d, sa_dev=order
        )
    else:
        codes = read_reference(args.reference, args.refsize)
        sa = suffix_array(codes)
        index = build_index(codes, IndexConfig(k=args.k, d=args.d), sa=sa)
        loc = build_locate(codes, sample_rate=args.sample_rate, d=args.d, sa=sa)
    if not args.from_store and args.store:
        from tpufm.index.store import save_store

        save_store(f"{args.store}.search.tpufm", index)
        save_store(f"{args.store}.locate.tpufm", loc)
        print(f"stored {args.store}.search.tpufm + {args.store}.locate.tpufm")
    return index, loc, codes


def _locate_body(args, index, loc, codes, queries, nq):
    """The search/locate/SAM dispatch shared by cmd_locate (which builds or
    loads tables via _locate_tables) and cmd_align's fixed-length path."""
    from tpufm.engine.xla import XLAEngine, LocateEngine

    def _contig_map():
        import os

        from tpufm.io.contigs import read_contigs

        if not os.path.exists(args.reference):
            sys.exit(
                "--sam/--contigs need the reference FASTA to map record "
                "boundaries (pass its real path even with --from-store)"
            )
        return read_contigs(args.reference, args.refsize or None)

    if args.mismatches < 0 or args.edits < 0:
        sys.exit("--mismatches/--edits must be >= 0")
    if args.edits and args.mismatches:
        sys.exit("--edits (indel-aware) and --mismatches (substitutions "
                 "only) are different distance models; pass one")
    if args.sam and args.rc:
        sys.exit("--sam reports both strands by definition; drop --rc")
    if args.resume and (args.sam or args.paired or args.mismatches
                        or args.edits):
        sys.exit("locate --resume covers exact position output; drop "
                 "--sam/--paired/--mismatches/--edits")
    if args.sam and not args.paired:
        # Single-end SAM: both strands ride one device batch; FLAG 16
        # marks minus-strand records (io/sam.py). Hamming sites (pure
        # <L>M CIGARs) carry their per-site NM:i.
        from tpufm.io.sam import sam_header, sam_single_records

        cmap = _contig_map()
        if args.from_store and (args.mismatches or args.edits):
            # only the approximate modes need the text itself (NM / seed
            # verify); exact SAM works from the stores alone
            codes = read_reference(args.reference, args.refsize or None)
        pos, s_overflow = _single_end_positions(args, index, loc, codes,
                                                queries)
        from tpufm.io.fasta import (
            load_query_names_packed,
            load_query_quals_packed,
        )

        names = load_query_names_packed(args.queries, nq)
        quals = load_query_quals_packed(args.queries, nq)
        out = args.output or f"{args.queries}." + ("bam" if args.bam
                                                   else "sam")
        text = sam_header(cmap, extra_pg="tpufm locate --sam")
        if args.edits:
            from tpufm.io.sam import sam_edit_records

            text += sam_edit_records(
                names, queries, pos[:nq], pos[nq:], cmap, codes,
                args.edits, quals=quals,
            )
        else:
            text += sam_single_records(
                names, queries, pos[:nq], pos[nq:], cmap,
                codes=codes if args.mismatches else None, quals=quals,
            )
        _write_sam_or_bam(out, text, args.bam)
        if s_overflow is not None and s_overflow.any():
            print(
                f"warning: {int(s_overflow.sum())} read strands hit the "
                f"seed-hits={args.seed_hits} cap; their SAM records are "
                "lower bounds"
            )
        print(f"{nq} reads, both strands")
        print(f"wrote {out}")
        return
    if args.paired:
        # Paired-end FR placement (engine/paired.py): both mates' both
        # strands ride one fused search+locate batch; pairing is an
        # on-device [H x H] insert-window join per read pair.
        if args.rc:
            sys.exit("--paired covers both strands by definition; drop --rc")
        from tpufm.engine.paired import PairedEndEngine

        mesh = None
        if args.mesh is not None:
            from tpufm.parallel import make_mesh

            mesh = make_mesh(args.mesh or None)
        sam_cmap = _contig_map() if args.sam else None
        if args.from_store and (
            args.mismatches >= 2 or args.edits
            or (args.sam and args.mismatches)
        ):
            # the verify pass (m>=2 / edits) and approximate SAM NM:i
            # both need the text itself, not just the stores
            import os

            if not os.path.exists(args.reference):
                sys.exit("--paired approximate matching needs the "
                         "reference FASTA for the verify pass")
            codes = read_reference(args.reference, args.refsize or None)
        r2 = load_queries(args.paired, args.qrysize, args.numqueries)
        pairs, strand, counts, p_overflow = PairedEndEngine(
            index, loc, args.insert_min, args.insert_max,
            max_hits=args.max_hits, max_pairs=args.max_pairs, mesh=mesh,
            lut_m=args.lut, mismatches=args.mismatches, edits=args.edits,
            seed_hits=args.seed_hits,
            text=codes if (args.mismatches >= 2 or args.edits) else None,
        ).pair(queries, r2)
        if p_overflow.any():
            print(
                f"warning: {int(p_overflow.sum())} read pairs have a mate "
                f"in a repeat wider than max-hits={args.max_hits}; their "
                "pair lists are lower bounds"
            )
        if args.sam:
            from tpufm.io.fasta import load_query_names, load_query_quals
            from tpufm.io.sam import sam_header, sam_paired_records

            names = load_query_names(args.queries, nq)
            out = args.output or f"{args.queries}." + ("bam" if args.bam
                                                       else "sam")
            text = sam_header(
                sam_cmap, extra_pg="tpufm locate --paired --sam"
            ) + sam_paired_records(
                names, queries, r2, pairs, strand, sam_cmap,
                codes=(codes if (args.mismatches or args.edits)
                       else None),
                edits=args.edits,
                quals1=load_query_quals(args.queries, nq),
                quals2=load_query_quals(args.paired, nq),
            )
            _write_sam_or_bam(out, text, args.bam)
            print(
                f"{nq} read pairs, {int((counts > 0).sum())} properly "
                f"paired (insert [{args.insert_min}, {args.insert_max}])"
            )
            print(f"wrote {out}")
            return
        cmap = _contig_map() if args.contigs else None
        out = args.output or f"{args.queries}.pairs"
        with open(out, "w") as fp:
            for i in range(nq):
                if cmap is not None:
                    lab = cmap.format(pairs[i].reshape(-1),
                                      query_len=args.qrysize)
                    toks = [
                        f"{lab[2 * j]}:{lab[2 * j + 1]}:"
                        f"{'+' if strand[i, j] == 0 else '-'}"
                        for j in range(pairs.shape[1])
                        if lab[2 * j] is not None
                    ]
                else:
                    toks = [
                        f"{int(pairs[i, j, 0])}:{int(pairs[i, j, 1])}:"
                        f"{'+' if strand[i, j] == 0 else '-'}"
                        for j in range(pairs.shape[1])
                        if pairs[i, j, 0] != 0xFFFFFFFF
                    ]
                fp.write(" ".join(toks) + "\n")
        print(
            f"{nq} read pairs, {int((counts > 0).sum())} properly paired "
            f"(insert [{args.insert_min}, {args.insert_max}])"
        )
        print(f"wrote {out}")
        return
    if args.rc:
        queries = _rc_expand(queries)
    # Any query length: the locate tables' k=1 LF index doubles as the tail
    # index for the r = L mod k leftover characters (fused paths alias it
    # in-place; the two-pass paths hand it to the search engine).
    tail = loc.lf1 if args.qrysize % index.config.k else None

    if args.edits:
        # Edit-distance (indel-aware) sites: pigeonhole seeds + batched
        # Myers bit-vector verify (engine/edit.py). Like --mismatches >= 2
        # the verify pass needs the packed text itself.
        import os

        if args.from_store:
            if not os.path.exists(args.reference):
                sys.exit(
                    "--edits needs the reference FASTA for the verify pass "
                    "(pass its real path even with --from-store)"
                )
            codes = read_reference(args.reference, args.refsize or None)
        if args.mesh is not None:
            from tpufm.parallel import DataParallelSearchLocate, make_mesh

            pos, _counts, overflow = DataParallelSearchLocate(
                index, loc, make_mesh(args.mesh or None),
                max_hits=args.max_hits, lut_m=args.lut,
            ).locate_edits(
                queries, codes, args.edits, seed_hits=args.seed_hits
            )
        else:
            from tpufm.engine.edit import EditExtendEngine

            pos, _counts, overflow = EditExtendEngine(
                index, loc, codes, edits=args.edits,
                seed_hits=args.seed_hits, max_hits=args.max_hits,
                lut_m=args.lut,
            ).locate_edits(queries)
        if overflow.any():
            print(
                f"warning: {int(overflow.sum())} reads hit the "
                f"seed-hits={args.seed_hits} cap; their site lists are "
                "lower bounds"
            )
    elif args.mismatches >= 2:
        # Pigeonhole seed-and-extend (engine/seed.py): m+1 disjoint seeds
        # ride the exact scan, candidates walk the sampled SA, and the
        # verify pass XOR+popcounts against the 2-bit packed text — so the
        # text itself is needed (re-read it in --from-store mode, exactly
        # like --contigs).
        import os

        if args.from_store:
            if not os.path.exists(args.reference):
                sys.exit(
                    "--mismatches >= 2 needs the reference FASTA for the "
                    "verify pass (pass its real path even with --from-store)"
                )
            codes = read_reference(args.reference, args.refsize or None)
        if args.mesh is not None:
            from tpufm.parallel import DataParallelSearchLocate, make_mesh

            pos, _counts, overflow = DataParallelSearchLocate(
                index, loc, make_mesh(args.mesh or None),
                max_hits=args.max_hits, lut_m=args.lut,
            ).locate_approx(
                queries, codes, args.mismatches, seed_hits=args.seed_hits
            )
        else:
            from tpufm.engine.seed import SeedExtendEngine

            pos, _counts, overflow = SeedExtendEngine(
                index, loc, codes, mismatches=args.mismatches,
                seed_hits=args.seed_hits, max_hits=args.max_hits,
                lut_m=args.lut,
            ).locate_approx(queries)
        if overflow.any():
            print(
                f"warning: {int(overflow.sum())} reads hit the "
                f"seed-hits={args.seed_hits} cap; their hit lists are "
                "lower bounds"
            )
    elif args.mismatches:
        # Hamming<=1 positions: variants ride the fused search+locate pass
        # (engine/xla.py make_mismatch_locate_fn), single-chip or mesh.
        if args.mesh is not None:
            from tpufm.parallel import DataParallelSearchLocate, make_mesh

            pos = DataParallelSearchLocate(
                index, loc, make_mesh(args.mesh or None),
                max_hits=args.max_hits, lut_m=args.lut,
            ).locate_mismatch(queries)
        else:
            from tpufm.engine.xla import SearchLocateEngine

            pos = SearchLocateEngine(
                index, loc, max_hits=args.max_hits, lut_m=args.lut
            ).locate_mismatch(queries)
    elif args.resume:
        # Wave-checkpointed exact locate (io/stream.py locate_resumable):
        # a killed genome-scale run re-invoked with the same arguments
        # continues from its last completed wave. Rides the fused engine
        # (single-chip or mesh).
        from tpufm.io.stream import locate_resumable

        if args.mesh is not None:
            from tpufm.parallel import DataParallelSearchLocate, make_mesh

            eng = DataParallelSearchLocate(
                index, loc, make_mesh(args.mesh or None),
                max_hits=args.max_hits, lut_m=args.lut,
            )
        else:
            from tpufm.engine.xla import SearchLocateEngine

            eng = SearchLocateEngine(
                index, loc, max_hits=args.max_hits, lut_m=args.lut
            )
        pos = locate_resumable(
            eng, queries, args.output or f"{args.queries}.pos"
        )
    elif args.mesh is not None:
        # Multi-chip: batch-sharded search + row-sharded locate walk over
        # the same mesh (tables replicated — they are small).
        from tpufm.parallel import (
            make_mesh,
            DataParallelEngine,
            DataParallelLocate,
        )

        mesh = make_mesh(args.mesh or None)
        if args.fused:
            from tpufm.parallel import DataParallelSearchLocate

            intervals, pos = DataParallelSearchLocate(
                index, loc, mesh, max_hits=args.max_hits, lut_m=args.lut
            ).search_locate(queries)
        else:
            intervals = DataParallelEngine(
                index, mesh, tail_index=tail, lut_m=args.lut
            ).search(queries)
            pos = DataParallelLocate(loc, mesh).locate_hits(
                intervals, max_hits=args.max_hits
            )
    elif args.fused:
        # ONE device pass reads -> intervals -> positions (no host
        # round-trip between search and the locate walk)
        from tpufm.engine.xla import SearchLocateEngine

        intervals, pos = SearchLocateEngine(
            index, loc, max_hits=args.max_hits, lut_m=args.lut
        ).search_locate(queries)
    else:
        intervals = XLAEngine(index, tail_index=tail, lut_m=args.lut).search(queries)
        pos = LocateEngine(loc).locate_hits(intervals, max_hits=args.max_hits)

    # chromosome:offset output — positions resolved against the
    # multi-FASTA record map; matches that run past their record's
    # end (concatenation artifacts) are flagged ':spans'
    cmap = _contig_map() if args.contigs else None

    # edit-distance alignments consume up to L+E reference bases, so the
    # :spans boundary label for --edits sites uses the conservative upper
    # bound (flags anything that MIGHT span; SAM output instead computes
    # each alignment's actual ref span)
    span_len = args.qrysize + (args.edits or 0)

    def _write_pos(path, rows):
        with open(path, "w") as fp:
            for row in rows:
                if cmap is not None:
                    labels = cmap.format(row, query_len=span_len)
                    fp.write(" ".join(s for s in labels if s is not None) + "\n")
                else:
                    fp.write(
                        " ".join(str(int(x)) for x in row if x != 0xFFFFFFFF)
                        + "\n"
                    )

    out = args.output or f"{args.queries}.pos"
    print(f"{nq} queries, max {args.max_hits} hits each")
    _emit_strands(out, pos, nq, _write_pos)


def _fasta_num_bases(path) -> int:
    """Total sequence bases in a (gzipped) multi-FASTA — the same count
    read_reference produces with refsize=None."""
    from tpufm.io.fasta import open_maybe_gzip

    total = 0
    with open_maybe_gzip(path) as fp:
        for line in fp:
            if not line.startswith(b">"):
                total += len(line.strip())
    return total


def _sniff_reads(path):
    """(min_length, max_length, read_count) of a FASTA/FASTQ(.gz) read
    file, from the same record contract load_queries uses. min != max
    means a mixed-length set (the variable-length align path)."""
    from tpufm.io.fasta import sniff_reads

    lmin, lmax, count = sniff_reads(path)
    if not count:
        sys.exit(f"{path}: no reads found")
    return lmin, lmax, count


def cmd_align(args):
    """One-command read aligner: reference FASTA + FASTA/FASTQ reads ->
    SAM v1.6. Sugar over `tpufm locate --sam`: sizes are sniffed from the
    files and (k, d, LUT) chosen from the read length and the device's
    memory (recommend_config); any read length works (the locate tables'
    k=1 LF index finishes the L mod k leftover rounds). The reference
    suite stops at (L, R) interval counts (common/searchQueries.c:34-132)
    — this is the production entry point its users would reach for from
    bwa/bowtie."""
    import json as _json
    import os

    from tpufm.config import device_bytes_limit, recommend_config

    qmin, qlen, nreads = _sniff_reads(args.reads)
    mixed = qmin != qlen
    # (mixed + --paired is grouped per (L1, L2) below; no rejection)
    if args.from_store:
        meta_path = os.path.join(f"{args.from_store}.search.tpufm", "meta.json")
        try:
            meta = _json.loads(open(meta_path).read())
        except OSError:
            sys.exit(f"--from-store: cannot read {meta_path}")
        k, d = int(meta["k"]), int(meta["d"])
        refsize = int(meta["bwtsize"]) - 1
    else:
        if not os.path.exists(args.reference):
            sys.exit(f"{args.reference}: no such reference FASTA")
        refsize = _fasta_num_bases(args.reference)
        rec = recommend_config(
            refsize, query_len=qlen, bytes_limit=device_bytes_limit()
        )
        # recommend_config drops to k<3 when k does not divide the read
        # length, but the aligner always has the k=1 tail (loc.lf1), so
        # k=3 applies at ANY length.
        k, d = 3, rec["d"]
    pair_mixed = False
    if args.paired:
        qmin2, qlen2, nreads2 = _sniff_reads(args.paired)
        if nreads2 != nreads:
            sys.exit(
                f"mate files disagree: {args.reads} has {nreads} reads,"
                f" {args.paired} has {nreads2}"
            )
        pair_mixed = mixed or qmin2 != qlen2 or qlen2 != qlen
        qmin = min(qmin, qmin2)  # the LUT must fit the shortest mate
    if args.lut is not None:
        lut = args.lut
    elif qmin >= 24:
        # largest m <= min(12, shortest read) with m % k == 0; for small
        # references scale m down so the 4^m-entry LUT stays smaller than
        # the index itself
        lut = next(
            (
                m
                for m in range(12 - (12 % k), 0, -k)
                if 4 ** m <= refsize and m <= qmin
            ),
            0,
        )
    else:
        lut = 0
    print(
        f"align: {nreads} x "
        + (f"{qmin}-{qlen}" if mixed else f"{qlen}")
        + " bp"
        + (" pairs" if args.paired else " reads")
        + f", reference {refsize} bases, k={k} d={d} lut={lut}"
    )
    ns = argparse.Namespace(
        reference=args.reference,
        refsize=refsize,
        queries=args.reads,
        qrysize=qlen,
        numqueries=nreads,
        k=k,
        d=d,
        sample_rate=args.sample_rate,
        max_hits=args.max_hits,
        fused=True,
        on_device=args.on_device,
        mesh=args.mesh,
        store=args.store,
        from_store=args.from_store,
        rc=False,
        mismatches=args.mismatches,
        edits=args.edits,
        seed_hits=args.seed_hits,
        paired=args.paired,
        insert_min=args.insert_min,
        insert_max=args.insert_max,
        max_pairs=args.max_pairs,
        resume=False,
        lut=lut,
        sam=True,
        bam=args.bam,
        contigs=False,
        output=args.output,
    )
    if args.paired and pair_mixed:
        # Mixed-length PAIRED alignment: per-(L1, L2) grouping — each
        # distinct mate-length combination runs the ordinary fixed-shape
        # paired pipeline over the shared tables, records merged back in
        # input order (same contract as the single-end grouping below).
        from tpufm.engine.paired import PairedEndEngine
        from tpufm.engine.xla import VARLEN_PAD
        from tpufm.io.contigs import read_contigs
        from tpufm.io.fasta import (
            load_queries_varlen,
            load_query_names,
            load_query_quals,
        )
        from tpufm.io.sam import sam_header, sam_paired_records

        need_text = bool(args.mismatches or args.edits)
        index, loc, codes = _locate_tables(ns)
        if need_text and codes is None:
            codes = read_reference(args.reference, refsize or None)
        b1 = load_queries_varlen(args.reads, nreads)
        b2 = load_queries_varlen(args.paired, nreads)
        l1 = (b1 != VARLEN_PAD).sum(axis=1)
        l2 = (b2 != VARLEN_PAD).sum(axis=1)
        names = load_query_names(args.reads, nreads)
        quals1 = load_query_quals(args.reads, nreads)
        quals2 = load_query_quals(args.paired, nreads)
        cmap = read_contigs(args.reference, refsize or None)
        mesh = None
        if args.mesh is not None:
            from tpufm.parallel import make_mesh

            mesh = make_mesh(args.mesh or None)
        blocks = [None] * nreads
        paired_total = 0
        ov_total = 0
        combos = sorted({(int(a), int(b)) for a, b in zip(l1, l2)})
        for L1, L2 in combos:
            sel = np.flatnonzero((l1 == L1) & (l2 == L2))
            r1g = np.ascontiguousarray(b1[sel, b1.shape[1] - L1 :])
            r2g = np.ascontiguousarray(b2[sel, b2.shape[1] - L2 :])
            gnames = [names[i] for i in sel]
            pairs, strand, counts, ov = PairedEndEngine(
                index, loc, args.insert_min, args.insert_max,
                max_hits=args.max_hits, max_pairs=args.max_pairs,
                mesh=mesh, lut_m=lut, mismatches=args.mismatches,
                edits=args.edits, seed_hits=args.seed_hits,
                text=codes if (args.mismatches >= 2 or args.edits)
                else None,
            ).pair(r1g, r2g)
            bl = sam_paired_records(
                gnames, r1g, r2g, pairs, strand, cmap,
                codes=codes if need_text else None, edits=args.edits,
                return_blocks=True,
                quals1=None if quals1 is None
                else [quals1[i] for i in sel],
                quals2=None if quals2 is None
                else [quals2[i] for i in sel],
            )
            for j, i in enumerate(sel):
                blocks[i] = bl[j]
            paired_total += int((counts > 0).sum())
            ov_total += int(np.asarray(ov).sum())
        out = args.output or f"{args.reads}." + ("bam" if args.bam
                                                 else "sam")
        text = sam_header(
            cmap, extra_pg="tpufm align --paired (mixed-length)"
        ) + "\n".join(line for blk in blocks for line in blk) + "\n"
        _write_sam_or_bam(out, text, args.bam)
        if ov_total:
            print(f"warning: {ov_total} read pairs have a mate in a "
                  f"repeat wider than max-hits={args.max_hits}; their "
                  "pair lists are lower bounds")
        print(f"{nreads} mixed-length read pairs "
              f"({len(combos)} length combos), {paired_total} properly "
              f"paired (insert [{args.insert_min}, {args.insert_max}])")
        print(f"wrote {out}")
        return
    if mixed and (args.mismatches or args.edits):
        # Mixed-length approximate alignment: per-length grouping. The
        # seed/edit engines are fixed-L programs (seed spans and Myers
        # word counts are shape constants), so each DISTINCT length runs
        # its own compiled instance over the SHARED tables, and the
        # per-read record blocks merge back in input order. One compile
        # per distinct length (persistent-cached); right for real trimmed
        # sets with a handful of lengths, quadratic-compile-silly for
        # pathological 1-length-per-read inputs.
        from tpufm.engine.xla import VARLEN_PAD
        from tpufm.io.contigs import read_contigs
        from tpufm.io.fasta import (
            load_queries_varlen,
            load_query_names,
            load_query_quals,
        )
        from tpufm.io.sam import (
            sam_edit_records,
            sam_header,
            sam_single_records,
        )

        index, loc, codes = _locate_tables(ns)
        if codes is None:
            codes = read_reference(args.reference, refsize or None)
        batch = load_queries_varlen(args.reads, nreads)
        lengths = (batch != VARLEN_PAD).sum(axis=1)
        names = load_query_names(args.reads, nreads)
        quals = load_query_quals(args.reads, nreads)
        cmap = read_contigs(args.reference, refsize or None)
        blocks = [None] * nreads
        overflow_total = 0
        dp = _make_dp_search_locate(ns, index, loc)  # once, not per length
        for L in sorted({int(x) for x in lengths}):
            sel = np.flatnonzero(lengths == L)
            qL = np.ascontiguousarray(batch[sel, batch.shape[1] - L :])
            gnames = [names[i] for i in sel]
            gquals = None if quals is None else [quals[i] for i in sel]
            pos, ov = _single_end_positions(ns, index, loc, codes, qL,
                                            dp=dp)
            nL = sel.size
            if args.edits:
                b = sam_edit_records(
                    gnames, qL, pos[:nL], pos[nL:], cmap, codes,
                    args.edits, return_blocks=True, quals=gquals,
                )
            else:
                b = sam_single_records(
                    gnames, qL, pos[:nL], pos[nL:], cmap, codes=codes,
                    return_blocks=True, quals=gquals,
                )
            for j, i in enumerate(sel):
                blocks[i] = b[j]
            if ov is not None:
                overflow_total += int(np.asarray(ov).sum())
        out = args.output or f"{args.reads}." + ("bam" if args.bam
                                                 else "sam")
        text = sam_header(
            cmap, extra_pg="tpufm align (mixed-length)"
        ) + "\n".join(line for blk in blocks for line in blk) + "\n"
        _write_sam_or_bam(out, text, args.bam)
        if overflow_total:
            print(f"warning: {overflow_total} read strands hit the "
                  f"seed-hits={args.seed_hits} cap; their SAM records "
                  "are lower bounds")
        print(f"{nreads} mixed-length reads "
              f"({len(set(int(x) for x in lengths))} lengths), "
              "both strands")
        print(f"wrote {out}")
        return
    if mixed:
        # Variable-length exact alignment: one search_varlen program over
        # the right-aligned 0xFF-padded batch (both strands), the ordinary
        # locate walk (length-independent), per-read-length SAM records.
        from tpufm.engine.xla import VARLEN_PAD, LocateEngine, XLAEngine
        from tpufm.io.contigs import read_contigs
        from tpufm.io.fasta import (
            load_queries_varlen,
            load_query_names_packed,
            load_query_quals_packed,
        )
        from tpufm.io.sam import sam_header, sam_single_records
        from tpufm.utils.encoding import reverse_complement_varlen

        index, loc, _ = _locate_tables(ns)
        batch = load_queries_varlen(args.reads, nreads)
        lengths = (batch != VARLEN_PAD).sum(axis=1)
        q2 = np.concatenate([batch, reverse_complement_varlen(batch)])
        tail = loc.lf1 if index.config.k > 1 else None
        if args.mesh is not None:
            from tpufm.parallel import (
                DataParallelEngine,
                DataParallelLocate,
                make_mesh,
            )

            mesh = make_mesh(args.mesh or None)
            iv = DataParallelEngine(
                index, mesh, tail_index=tail, lut_m=lut
            ).search_varlen(q2)
            pos = DataParallelLocate(loc, mesh).locate_hits(
                iv, max_hits=args.max_hits
            )
        else:
            eng = XLAEngine(index, tail_index=tail, lut_m=lut)
            pos = LocateEngine(loc).locate_hits(
                eng.search_varlen(q2), max_hits=args.max_hits
            )
        cmap = read_contigs(args.reference, refsize or None)
        names = load_query_names_packed(args.reads, nreads)
        out = args.output or f"{args.reads}." + ("bam" if args.bam
                                                 else "sam")
        text = sam_header(
            cmap, extra_pg="tpufm align (mixed-length)"
        ) + sam_single_records(
            names, batch, pos[:nreads], pos[nreads:], cmap,
            lengths=lengths,
            quals=load_query_quals_packed(args.reads, nreads),
        )
        _write_sam_or_bam(out, text, args.bam)
        print(f"{nreads} mixed-length reads, both strands")
        print(f"wrote {out}")
        return
    cmd_locate(ns)


def _write_sam_or_bam(path: str, sam_text: str, as_bam: bool) -> None:
    """One alignment-semantics implementation, two serializations: the
    SAM text (io/sam.py, the tested source of truth) is either written
    verbatim or encoded to bgzf BAM (io/bam.py)."""
    if as_bam:
        from tpufm.io.bam import write_bam

        write_bam(path, sam_text)
    else:
        with open(path, "w") as fp:
            fp.write(sam_text)


def _read_sam_or_bam(path: str) -> str:
    """SAM text from either serialization (BAM detected by the bgzf
    magic, not the extension)."""
    with open(path, "rb") as fp:
        magic = fp.read(4)
    if magic == b"\x1f\x8b\x08\x04":
        from tpufm.io.bam import read_bam

        header, records = read_bam(path)
        return header + "".join("\t".join(r) + "\n" for r in records)
    return open(path).read()


def cmd_sort(args):
    """Coordinate-sort alignments and write a query-ready BAM + .bai —
    the `samtools sort && samtools index` step, in one command
    (io/bam_index.py; the reference suite has no placement output at
    all, common/searchQueries.c:100-118)."""
    from tpufm.io.bam_index import write_bam_indexed

    out = args.output or (args.input.rsplit(".", 1)[0] + ".sorted.bam")
    try:
        write_bam_indexed(out, _read_sam_or_bam(args.input))
    except ValueError as e:  # e.g. RNAME without @SQ, QUAL/SEQ mismatch
        sys.exit(f"cannot sort {args.input}: {e}")
    print(f"wrote {out} + {out}.bai")


def cmd_markdup(args):
    """Mark PCR/optical duplicates (samtools-markdup-style): primary
    mapped records sharing a template key — (ref, unclipped 5' pos,
    strand) plus the mate's (ref, pos, strand) for proper pairs — are
    grouped; the highest-QUAL record keeps its flags, the rest gain
    0x400. Output is a sorted, indexed BAM (or SAM with an .sam
    --output). `tpufm stats`/`depth`/`flagstat` then exclude the marked
    records automatically."""
    from tpufm.io.bam_index import markdup, write_bam_indexed

    text = _read_sam_or_bam(args.input)
    header = [l for l in text.splitlines() if l.startswith("@")]
    records = [l.split("\t") for l in text.splitlines()
               if l and not l.startswith("@")]
    marked, n = markdup(records)
    out_text = "\n".join(header + ["\t".join(f) for f in marked]) + "\n"
    out = args.output or (args.input.rsplit(".", 1)[0] + ".markdup.bam")
    if out.endswith(".sam"):
        with open(out, "w") as fp:
            fp.write(out_text)
        print(f"wrote {out} ({n} duplicates marked)")
    else:
        try:
            write_bam_indexed(out, out_text)
        except ValueError as e:
            sys.exit(f"cannot write {out}: {e}")
        print(f"wrote {out} + {out}.bai ({n} duplicates marked)")


def cmd_merge(args):
    """Merge SAM/BAM files into one coordinate-sorted, indexed BAM —
    the scatter-gather companion to per-shard alignment (each shard
    aligns its read slice, merge produces the query-ready whole). All
    inputs must agree on the @SQ contig dictionary (same names, same
    order, same lengths); @PG/@RG lines are deduplicated in first-seen
    order and record order within a coordinate is stable by input."""
    from tpufm.io.bam_index import write_bam_indexed

    sq_ref: list[str] | None = None
    header_out: list[str] = []
    seen_hdr: set[str] = set()
    records: list[str] = []
    for path in args.inputs:
        text = _read_sam_or_bam(path)
        sq = [l for l in text.splitlines() if l.startswith("@SQ")]
        if sq_ref is None:
            sq_ref = sq
        elif sq != sq_ref:
            sys.exit(f"{path}: @SQ dictionary differs from {args.inputs[0]}"
                     " — merge needs identical contigs in identical order")
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("@"):
                # drop @HD: inputs may disagree on SO:, and sort_sam_text
                # emits a single fresh SO:coordinate one
                if line not in seen_hdr and not line.startswith("@HD"):
                    seen_hdr.add(line)
                    header_out.append(line)
            else:
                records.append(line)
    if sq_ref is None or not args.inputs:
        sys.exit("merge needs at least one input")
    text = "\n".join(header_out + records) + "\n"
    try:
        write_bam_indexed(args.output, text)
    except ValueError as e:
        sys.exit(f"cannot merge: {e}")
    print(f"wrote {args.output} + {args.output}.bai "
          f"({len(records)} records from {len(args.inputs)} inputs)")


def cmd_view(args):
    """Print alignments as SAM text; with a REGION ('chr' or
    'chr:beg-end', 1-based inclusive like samtools), use the .bai to
    inflate only the bgzf members holding candidate records."""
    import sys as _sys

    dest = open(args.output, "w") if args.output else _sys.stdout
    if args.region:
        import os

        from tpufm.io.bam_index import IndexedBam, decode_record

        if not os.path.exists(args.input + ".bai"):
            sys.exit(
                f"{args.input}.bai not found — region queries need the "
                "index; create it with `tpufm sort`"
            )
        ib = IndexedBam(args.input)
        contig, beg, end = _parse_region(args.region)
        if contig not in ib.ref_names:
            sys.exit(f"{contig!r} is not a contig of {args.input} "
                     f"(has: {', '.join(ib.ref_names[:8])}"
                     + ("..." if len(ib.ref_names) > 8 else "") + ")")
        if end is None:
            end = ib.ref_lengths[ib.ref_names.index(contig)]
        if not args.no_header:
            dest.write(ib.header_text)
        for rec in ib.query(contig, beg, end):
            dest.write("\t".join(decode_record(rec, ib.ref_names)) + "\n")
    else:
        text = _read_sam_or_bam(args.input)
        if args.no_header:
            text = "".join(l for l in text.splitlines(keepends=True)
                           if not l.startswith("@"))
        dest.write(text)
    if args.output:
        dest.close()


def cmd_flagstat(args):
    """samtools-flagstat-style counters over a SAM/BAM file."""
    from tpufm.io.bam_index import flagstat

    records = [l.split("\t") for l in _read_sam_or_bam(args.input).splitlines()
               if l and not l.startswith("@")]
    c = flagstat(records)
    print(f"{c['total']} in total ({c['secondary']} secondary)")
    print(f"{c['primary']} primary")
    print(f"{c['mapped']} mapped")
    print(f"{c['primary_mapped']} primary mapped")
    print(f"{c['paired']} paired in sequencing")
    print(f"{c['read1']} read1")
    print(f"{c['read2']} read2")
    print(f"{c['proper']} properly paired")


def cmd_idxstats(args):
    """samtools-idxstats-style per-contig counts over a SAM/BAM file:
    one 'name\\tlength\\t#mapped\\t#unmapped' row per @SQ contig plus the
    trailing '*' row for unplaced reads."""
    from tpufm.io.bam_index import idxstats

    text = _read_sam_or_bam(args.input)
    header = "".join(l for l in text.splitlines(keepends=True)
                     if l.startswith("@"))
    records = [l.split("\t") for l in text.splitlines()
               if l and not l.startswith("@")]
    for name, length, n_mapped, n_unmapped in idxstats(header, records):
        print(f"{name}\t{length}\t{n_mapped}\t{n_unmapped}")


def cmd_stats(args):
    """samtools-stats-style summary over a SAM/BAM file: the SN section
    plus RL (read length) and IS (insert size) histograms, in the
    grep-able 'SN\\tname:\\tvalue' line format downstream QC expects."""
    from tpufm.io.bam_index import sam_stats

    records = (l.split("\t")
               for l in _read_sam_or_bam(args.input).splitlines()
               if l and not l.startswith("@"))
    s = sam_stats(records)
    dest = open(args.output, "w") if args.output else sys.stdout
    print("# subset of `samtools stats`: SN + RL + IS sections; filter "
          "like `tpufm stats f.bam | grep ^SN | cut -f 2-`", file=dest)
    for name, value in s["sn"]:
        print(f"SN\t{name}:\t{value}", file=dest)
    for length, count in s["rl"].items():
        print(f"RL\t{length}\t{count}", file=dest)
    for size, count in s["is"].items():
        print(f"IS\t{size}\t{count}", file=dest)
    if args.output:
        dest.close()


def _parse_region(region: str):
    """'chr' or 'chr:beg-end' (1-based inclusive, samtools style) ->
    (contig, beg0, end_or_None) half-open."""
    if ":" not in region:
        return region, 0, None
    contig, span = region.rsplit(":", 1)
    try:
        b, e = span.split("-")
        beg, end = int(b) - 1, int(e)
    except ValueError:
        sys.exit(f"bad region {region!r}; use chr:beg-end "
                 "(1-based inclusive)")
    beg = max(beg, 0)  # samtools clamps a 1-based beg of 0
    if end <= beg:
        sys.exit(f"empty region {region!r} (end < beg)")
    return contig, beg, end


def cmd_bedcov(args):
    """samtools-bedcov-style per-region coverage sums: every original
    BED column echoed back with the region's coverage sum appended.
    Indexed BAMs answer each region from the .bai; SAM/plain BAM run ONE
    full scan, bucketed per contig, shared across all regions."""
    import os

    from tpufm.io.bam_index import (IndexedBam, bedcov, decode_record,
                                    read_bed)

    try:
        rows = read_bed(args.bed)
    except ValueError as e:
        sys.exit(str(e))
    regions = [(c, b, e) for c, b, e, _ in rows]
    with open(args.input, "rb") as fp:
        is_bam = fp.read(4) == b"\x1f\x8b\x08\x04"
    if is_bam and os.path.exists(args.input + ".bai"):
        ib = IndexedBam(args.input)
        names = set(ib.ref_names)
        header = ib.header_text

        def fetch(contig, beg, end):
            return [decode_record(r, ib.ref_names)
                    for r in ib.query(contig, beg, end)]
    else:
        text = _read_sam_or_bam(args.input)
        header = "".join(l for l in text.splitlines(keepends=True)
                         if l.startswith("@"))
        by_contig: dict[str, list] = {}
        for l in text.splitlines():
            if l and not l.startswith("@"):
                f = l.split("\t")
                by_contig.setdefault(f[2], []).append(f)
        names = {f[3:] for l in header.splitlines() if l.startswith("@SQ")
                 for f in l.split("\t") if f.startswith("SN:")}

        def fetch(contig, beg, end):
            # depth() clips the contig's bucket to the region window
            return by_contig.get(contig, [])
    bad = [c for c, _, _ in regions if c not in names]
    if bad:
        sys.exit(f"{bad[0]!r} is not a contig of {args.input}")
    dest = open(args.output, "w") if args.output else sys.stdout
    for (_, _, _, fields), (_c, _b, _e, total) in zip(
        rows, bedcov(header, fetch, regions)
    ):
        dest.write("\t".join(fields) + f"\t{total}\n")
    if args.output:
        dest.close()


def cmd_depth(args):
    """Per-position coverage, samtools-depth semantics (skip unmapped/
    secondary/qcfail/dup; only M/=/X cover). With a REGION and an
    indexed BAM, only the bgzf members holding candidate records are
    inflated; otherwise the whole file is scanned."""
    import os

    from tpufm.io.bam_index import IndexedBam, decode_record, depth

    region = _parse_region(args.region) if args.region else None
    with open(args.input, "rb") as fp:
        is_bam = fp.read(4) == b"\x1f\x8b\x08\x04"
    if region and is_bam and os.path.exists(args.input + ".bai"):
        ib = IndexedBam(args.input)
        contig, beg, end = region
        if contig not in ib.ref_names:
            sys.exit(f"{contig!r} is not a contig of {args.input}")
        if end is None:
            end = ib.ref_lengths[ib.ref_names.index(contig)]
        region = (contig, beg, end)
        header = ib.header_text
        records = [decode_record(r, ib.ref_names)
                   for r in ib.query(contig, beg, end)]
    else:
        text = _read_sam_or_bam(args.input)
        header = "".join(l for l in text.splitlines(keepends=True)
                         if l.startswith("@"))
        records = [l.split("\t") for l in text.splitlines()
                   if l and not l.startswith("@")]
        if region:
            # parse @SQ SN values exactly — a substring match would let
            # any prefix of a real contig name pass (e.g. 'c' vs 'cA')
            sq_names = {f[3:] for l in header.splitlines() if l.startswith("@SQ")
                        for f in l.split("\t") if f.startswith("SN:")}
            if region[0] not in sq_names:
                sys.exit(f"{region[0]!r} is not a contig of {args.input}")
    dest = open(args.output, "w") if args.output else sys.stdout
    for name, pos1, d in depth(header, records, region=region,
                               all_positions=args.all):
        dest.write(f"{name}\t{pos1}\t{d}\n")
    if args.output:
        dest.close()


def cmd_fastq(args):
    """Export reads from SAM/BAM back to FASTQ (sequencer orientation:
    minus-strand records are reverse-complemented; secondary/
    supplementary records are skipped). With -1/-2, paired reads route
    to the two files and unpaired reads to --output/stdout; otherwise
    everything goes to one stream with /1 //2 name suffixes on mates."""
    from tpufm.io.bam_index import fastq_records

    if (args.r1 is None) != (args.r2 is None):
        sys.exit("-1 and -2 must be given together")  # before opening outputs
    records = (l.split("\t") for l in _read_sam_or_bam(args.input).splitlines()
               if l and not l.startswith("@"))
    dest = open(args.output, "w") if args.output else sys.stdout
    f1 = open(args.r1, "w") if args.r1 else None
    f2 = open(args.r2, "w") if args.r2 else None
    n = [0, 0, 0]  # single, read1, read2
    for name, flag, seq, qual in fastq_records(records):
        if f1 is not None and flag & 0x1:
            out, suffix = (f1, "") if flag & 0x40 else (f2, "")
            n[1 if flag & 0x40 else 2] += 1
        else:
            suffix = ("/1" if flag & 0x40 else "/2") if flag & 0x1 else ""
            out = dest
            n[0] += flag & 0x1 == 0
            if flag & 0x1:
                n[1 if flag & 0x40 else 2] += 1
        out.write(f"@{name}{suffix}\n{seq}\n+\n{qual}\n")
    for fp in (f1, f2, dest if args.output else None):
        if fp:
            fp.close()
    print(f"{n[0]} singletons, {n[1]} read1, {n[2]} read2", file=sys.stderr)


def cmd_faidx(args):
    """Index a FASTA (writes <input>.fai, the samtools faidx format);
    with REGIONs, print the requested subsequences as FASTA instead
    (building the .fai on demand)."""
    from tpufm.io.faidx import build_fai, fetch, load_fai

    if not args.regions:
        try:
            rows = build_fai(args.input)
        except ValueError as e:
            sys.exit(str(e))
        print(f"wrote {args.input}.fai ({len(rows)} sequences)")
        return
    import os

    try:
        if not os.path.exists(args.input + ".fai"):
            build_fai(args.input)
        fai = load_fai(args.input)
    except ValueError as e:
        sys.exit(str(e))
    dest = open(args.output, "w") if args.output else sys.stdout
    for region in args.regions:
        contig, beg, end = _parse_region(region)
        try:
            seq = fetch(args.input, contig, beg, end, fai=fai)
        except KeyError as e:
            sys.exit(str(e.args[0]))
        # samtools echoes the region as the header and wraps at 60
        dest.write(f">{region}\n")
        for off in range(0, len(seq), 60):
            dest.write(seq[off : off + 60].decode("latin-1") + "\n")
    if args.output:
        dest.close()


def cmd_diff(args):
    """Compare two .res files — formalizes the reference's manual
    cross-implementation diffing (SURVEY.md section 4)."""
    from tpufm.io.results import load_results

    a = load_results(args.a)
    b = load_results(args.b)
    if a.shape != b.shape:
        sys.exit(f"DIFFER: {a.shape[0]} vs {b.shape[0]} results")
    bad = np.flatnonzero((a != b).any(axis=1))
    if bad.size:
        for i in bad[:10]:
            print(f"  query {i}: {a[i].tolist()} vs {b[i].tolist()}")
        sys.exit(f"DIFFER: {bad.size}/{a.shape[0]} intervals mismatch")
    print(f"IDENTICAL: {a.shape[0]} intervals")


def cmd_dumpbwt(args):
    """Debug dump of the k BWT strings (reference INDEX_DGB=1 path,
    src/genFMindex.c:523-535)."""
    from tpufm.index.builder import derive_bwts

    codes = read_reference(args.reference, args.refsize)
    bwts, dollar_pos = derive_bwts(codes, args.k)
    for i, (s, dp) in enumerate(zip(bwts, dollar_pos)):
        print(f"BWT{i} dollarPosition={dp}")
        print(s.decode())


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpufm")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build a k-step FM-index from FASTA")
    b.add_argument("reference")
    b.add_argument("refsize", type=int)
    b.add_argument("--k", type=int, default=2)
    b.add_argument("--d", type=int, default=64)
    b.add_argument("--auto", action="store_true",
                   help="pick (k, d) from the device's memory (recommend_config)")
    b.add_argument("--output", default=None,
                   help=".fmi (reference format), .npz, or .tpufm "
                        "(mmap-able store — instant genome-scale reload)")
    b.add_argument("--sa", default="auto",
                   choices=["auto", "native", "doubling", "device", "sharded"],
                   help="suffix-sort backend; 'device' sorts on the accelerator, "
                        "'sharded' sorts across every local device's HBM")
    b.add_argument("--on-device", action="store_true",
                   help="build the whole index on the accelerator "
                        "(tpufm/index/builder_device.py)")
    b.add_argument("--mesh", type=int, default=0,
                   help="with --on-device: shard every build stage over N "
                        "devices (tpufm/index/builder_sharded.py) — lifts "
                        "the single-chip ~400 Mbase on-device cap")
    b.add_argument("--store-sharded", action="store_true",
                   help="with --on-device --mesh N: persist per-shard "
                        "files (--output X.tpufm) without ever assembling "
                        "the table on one host; search them with "
                        "`tpufm search X.tpufm ... --sharded`")
    b.add_argument("--save-ref", action="store_true")
    b.add_argument("--tail", action="store_true",
                   help="also build a k=1 tail index (<out>.tail.npz) so "
                        "search accepts ANY query length, not just "
                        "multiples of k")
    b.set_defaults(fn=cmd_build)

    t = sub.add_parser("transform", help="emit alternate index layouts")
    t.add_argument("index")
    t.add_argument(
        "--layouts",
        nargs="+",
        default=["interleaved", "alt_counters", "interleaved_alt_counters"],
    )
    t.set_defaults(fn=cmd_transform)

    g = sub.add_parser("genreads", help="sample a query workload")
    g.add_argument("reference")
    g.add_argument("refsize", type=int)
    g.add_argument("length", type=int)
    g.add_argument("num", type=int)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--output", default=None)
    g.add_argument("--paired", action="store_true",
                    help="sample FR read pairs instead: writes <out>_1.qry "
                         "+ <out>_2.qry (strands alternate per pair)")
    g.add_argument("--insert-min", type=int, default=200,
                    help="--paired: smallest fragment length")
    g.add_argument("--insert-max", type=int, default=600,
                    help="--paired: largest fragment length")
    g.set_defaults(fn=cmd_genreads)

    s = sub.add_parser("search", help="batch backward search")
    s.add_argument("index")
    s.add_argument("queries")
    s.add_argument("qrysize", type=int)
    s.add_argument("numqueries", type=int)
    s.add_argument("--iterations", type=int, default=5)
    s.add_argument("--engine", default="xla",
                   choices=["xla", "xla-ac", "xla-paired"])
    s.add_argument("--lut", type=int, default=0,
                   help="prefix-LUT length m (collapses the first m chars "
                        "of every query into one gather)")
    s.add_argument("--pad-words", type=int, default=None)
    s.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="run data-parallel over an N-device mesh (0 = all "
                        "local devices); index replicated, batch sharded")
    s.add_argument("--sharded", action="store_true",
                   help="shard the entry table over the mesh (indexes "
                        "larger than one chip's HBM); baseline layout only")
    s.add_argument("--routing", default="allgather",
                   choices=["allgather", "ring", "a2a"],
                   help="collective plan for --sharded lookups")
    s.add_argument("--tail", default=None, metavar="PATH",
                   help="k=1 tail index enabling any query length "
                        "(default: <index>.tail.npz when the length needs it)")
    s.add_argument("--rc", action="store_true",
                   help="also search every read's reverse complement in the "
                        "same pass; minus-strand intervals go to <out>.rc")
    s.add_argument("--resume", action="store_true",
                   help="checkpoint each wave; a re-run with the same "
                        "arguments continues after a crash")
    s.add_argument("--output", default=None)
    s.set_defaults(fn=cmd_search)

    cn = sub.add_parser(
        "count", help="occurrence counts per read (exact or <=1 mismatch)"
    )
    cn.add_argument("index")
    cn.add_argument("queries")
    cn.add_argument("qrysize", type=int)
    cn.add_argument("numqueries", type=int)
    cn.add_argument("--mismatches", type=int, default=0, choices=[0, 1],
                    help="1 = count occurrences within Hamming distance 1 "
                         "(on-device 3L+1 variant expansion, full "
                         "sensitivity, ~3L x the exact-search device "
                         "work). For m >= 2 use `tpufm locate "
                         "--mismatches M`, which carries the locate "
                         "tables the seed filter needs")
    cn.add_argument("--lut", type=int, default=0,
                    help="prefix LUT m-mer size (same as search --lut)")
    cn.add_argument("--tail", default=None, metavar="PATH",
                    help="k=1 tail index enabling any query length")
    cn.add_argument("--rc", action="store_true",
                    help="also count the reverse complements; <out>.rc")
    cn.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="data-parallel counting over an N-device mesh "
                         "(0 = all local devices)")
    cn.add_argument("--iterations", type=int, default=1)
    cn.add_argument("--output", default=None)
    cn.set_defaults(fn=cmd_count)

    be = sub.add_parser("bench", help="synthetic benchmark, one JSON line")
    be.add_argument("--refsize", type=int, default=None,
                    help="reference bases (default 10 Mbase; 250 Mbase "
                         "with --genome)")
    be.add_argument("--k", type=int, default=2)
    be.add_argument("--d", type=int, default=64)
    be.add_argument("--numqueries", type=int, default=131072)
    be.add_argument("--length", type=int, default=120)
    be.add_argument("--iterations", type=int, default=5)
    be.add_argument("--seed", type=int, default=0)
    be.add_argument("--engine", default="xla",
                    choices=["xla", "xla-split", "xla-ac", "xla-paired"])
    be.add_argument("--lut", type=int, default=None,
                    help="prefix-LUT m (default: none; with --genome, "
                         "recommend_config's pick — pass 0 for LUT-free)")
    be.add_argument("--mismatches", type=int, default=0,
                    help="1 = benchmark Hamming<=1 counting (3L+1 on-device "
                         "variants/read); >=2 = pigeonhole seed-and-extend "
                         "locate; both verified vs a naive Hamming scan")
    be.add_argument("--edits", type=int, default=0, metavar="E",
                    help="benchmark indel-aware alignment at edit distance "
                         "E (Myers-verified seed-and-extend), DP-oracle "
                         "verified")
    be.add_argument("--seed-hits", type=int, default=32,
                    help="mismatches>=2 / edits: per-seed interval cap")
    be.add_argument("--paired", dest="paired_bench", action="store_true",
                    help="benchmark paired-end FR placement "
                         "(pairs/s, truth-verified; --numqueries = pairs)")
    be.add_argument("--insert-min", type=int, default=250)
    be.add_argument("--insert-max", type=int, default=450)
    be.add_argument("--genome", action="store_true",
                    help="the genome-scale (HBM-regime) record: a real "
                         ">=250 Mbase device-built index (cached under "
                         ".benchcache/genome), reference compared at the same "
                         "size via tpufm's byte-exact .fmi image; k/d/lut "
                         "from recommend_config (--refsize to override "
                         "the 250 Mbase default)")
    be.add_argument("--multichip", action="store_true",
                    help="data-parallel over all local devices")
    be.add_argument("--sharded", action="store_true",
                    help="entry-table-sharded over all local devices")
    be.add_argument("--routing", default="allgather",
                    choices=["allgather", "ring", "a2a"],
                    help="collective plan for --sharded")
    be.add_argument("--locate", action="store_true",
                    help="benchmark the sampled-SA locate walk "
                         "(positions/s; --numqueries = rows)")
    be.add_argument("--fused", action="store_true",
                    help="with --locate: the one-pass search+locate record "
                         "(SearchLocateEngine)")
    be.add_argument("--max-hits", type=int, default=4,
                    help="with --locate --fused: positions per read")
    be.add_argument("--sample-rate", type=int, default=32,
                    help="locate SA sampling rate (with --locate)")
    be.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="device count for --locate (0 = all)")
    be.set_defaults(fn=cmd_bench)

    sw = sub.add_parser("sweep", help="run the (refsize x k x d x engine) matrix")
    sw.add_argument("--refsizes", type=int, nargs="+", default=[1_000_000])
    sw.add_argument("--ks", type=int, nargs="+", default=[1, 2, 3])
    sw.add_argument("--ds", type=int, nargs="+", default=[64, 128])
    sw.add_argument("--engines", nargs="+", default=["xla"],
                    choices=["xla", "xla-split", "xla-ac", "xla-paired"])
    sw.add_argument("--luts", nargs="+", type=int, default=[0],
                    help="prefix-LUT m values to sweep (0 = no LUT)")
    sw.add_argument("--numqueries", type=int, default=65536)
    sw.add_argument("--length", type=int, default=120)
    sw.add_argument("--iterations", type=int, default=3)
    sw.add_argument("--output", default=None)
    sw.set_defaults(fn=cmd_sweep)

    lc = sub.add_parser("locate", help="search + text positions (extension)")
    lc.add_argument("reference")
    lc.add_argument("refsize", type=int)
    lc.add_argument("queries")
    lc.add_argument("qrysize", type=int)
    lc.add_argument("numqueries", type=int)
    lc.add_argument("--k", type=int, default=2)
    lc.add_argument("--d", type=int, default=64)
    lc.add_argument("--sample-rate", type=int, default=32)
    lc.add_argument("--max-hits", type=int, default=16)
    lc.add_argument("--fused", action="store_true",
                    help="single-chip: fuse search + locate into one device "
                         "pass (SearchLocateEngine)")
    lc.add_argument("--on-device", action="store_true",
                    help="build index + locate tables on the accelerator "
                         "(one shared device suffix sort)")
    lc.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="data-parallel search + locate over an N-device "
                         "mesh (0 = all local devices)")
    lc.add_argument("--store", default=None, metavar="PREFIX",
                    help="persist PREFIX.search.tpufm + PREFIX.locate.tpufm")
    lc.add_argument("--from-store", default=None, metavar="PREFIX",
                    help="load prebuilt stores; reference/refsize are "
                         "ignored (pass '-' 0)")
    lc.add_argument("--rc", action="store_true",
                    help="also locate every read's reverse complement in "
                         "the same pass; minus-strand positions go to "
                         "<out>.rc")
    lc.add_argument("--mismatches", type=int, default=0,
                    help="positions of occurrences within this Hamming "
                         "distance: 1 = on-device variant expansion; >=2 = "
                         "pigeonhole seed-and-extend (needs the reference "
                         "FASTA for verification, also with --from-store)")
    lc.add_argument("--edits", type=int, default=0, metavar="E",
                    help="indel-aware: report distinct alignment start "
                         "sites within edit distance E (pigeonhole seeds + "
                         "batched Myers bit-vector verify; needs the "
                         "reference FASTA, also with --from-store)")
    lc.add_argument("--seed-hits", type=int, default=32,
                    help="mismatches>=2 / edits: per-seed interval cap; "
                         "reads whose seeds exceed it are flagged (hit "
                         "list becomes a lower bound)")
    lc.add_argument("--paired", default=None, metavar="R2.qry",
                    help="paired-end FR placement: queries is R1, this is "
                         "R2 (same length/count); writes '<out>': one line "
                         "per pair of left:right:strand tokens")
    lc.add_argument("--insert-min", type=int, default=0,
                    help="--paired: smallest proper fragment length")
    lc.add_argument("--insert-max", type=int, default=1000,
                    help="--paired: largest proper fragment length")
    lc.add_argument("--max-pairs", type=int, default=4,
                    help="--paired: proper pairs reported per read pair")
    lc.add_argument("--resume", action="store_true",
                    help="checkpoint each completed wave next to the "
                         "output; a killed run re-invoked with the same "
                         "arguments continues (exact positions only)")
    lc.add_argument("--lut", type=int, default=0,
                    help="prefix LUT m-mer size for the search scan "
                         "(same as search --lut; seeds reuse it when "
                         "long enough)")
    lc.add_argument("--sam", action="store_true",
                    help="write SAM v1.6 instead of position lines (exact "
                         "or --mismatches M matching — pure <L>M CIGARs "
                         "with NM:i; single-end reports both strands, "
                         "--paired emits proper-pair records; needs the "
                         "reference FASTA for the record map)")
    lc.add_argument("--bam", action="store_true",
                    help="write bgzf-compressed BAM v1 instead of SAM "
                         "text (implies --sam; io/bam.py encodes the "
                         "same records)")
    lc.add_argument("--contigs", action="store_true",
                    help="write chromosome:offset instead of absolute "
                         "positions (multi-FASTA record map from the "
                         "reference file; matches crossing a record "
                         "boundary are flagged ':spans'). Needs the "
                         "reference FASTA, also with --from-store")
    lc.add_argument("--output", default=None)
    lc.set_defaults(fn=cmd_locate)

    al = sub.add_parser(
        "align",
        help="one-command read aligner: reference + FASTA/FASTQ reads -> "
             "SAM v1.6 (auto-sized `locate --sam`)",
    )
    al.add_argument("reference", help="reference FASTA(.gz); needed even "
                                      "with --from-store (SAM record map)")
    al.add_argument("reads", help="FASTA/FASTQ(.gz) reads; length and "
                                  "count are sniffed")
    al.add_argument("-2", "--paired", default=None, metavar="R2",
                    help="mate-2 reads: paired-end FR placement")
    al.add_argument("-o", "--output", default=None,
                    help="SAM path (default <reads>.sam)")
    al.add_argument("--bam", action="store_true",
                    help="write bgzf-compressed BAM v1 instead of SAM "
                         "text (default output <reads>.bam)")
    al.add_argument("--mismatches", type=int, default=0,
                    help="substitutions tolerated per read (1 = variant "
                         "expansion, >=2 = seed-and-extend)")
    al.add_argument("--edits", type=int, default=0, metavar="E",
                    help="indel-aware edit distance per read (Myers "
                         "bit-vector verify)")
    al.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard the batch over an N-device mesh "
                         "(0 = all local devices)")
    al.add_argument("--insert-min", type=int, default=0)
    al.add_argument("--insert-max", type=int, default=1000)
    al.add_argument("--max-pairs", type=int, default=4)
    al.add_argument("--max-hits", type=int, default=16)
    al.add_argument("--seed-hits", type=int, default=32)
    al.add_argument("--sample-rate", type=int, default=32)
    al.add_argument("--lut", type=int, default=None,
                    help="prefix-LUT m (default: largest <=12 multiple "
                         "of k)")
    al.add_argument("--on-device", action="store_true",
                    help="build the tables on the accelerator")
    al.add_argument("--store", default=None, metavar="PREFIX",
                    help="persist the tables for reuse "
                         "(PREFIX.search.tpufm + PREFIX.locate.tpufm)")
    al.add_argument("--from-store", default=None, metavar="PREFIX",
                    help="reuse tables built by a previous --store run "
                         "(skips the suffix sort)")
    al.set_defaults(fn=cmd_align)

    so = sub.add_parser(
        "sort", help="coordinate-sort SAM/BAM -> indexed BAM (+ .bai)"
    )
    so.add_argument("input", help="SAM or BAM (detected by magic)")
    so.add_argument("--output", default=None,
                    help="output BAM (default <input>.sorted.bam)")
    so.set_defaults(fn=cmd_sort)

    vw = sub.add_parser(
        "view", help="print SAM text; REGION uses the .bai index"
    )
    vw.add_argument("input", help="SAM or BAM")
    vw.add_argument("region", nargs="?", default=None,
                    help="'chr' or 'chr:beg-end' (1-based inclusive); "
                         "needs <input>.bai from `tpufm sort`")
    vw.add_argument("--no-header", action="store_true")
    vw.add_argument("--output", default=None)
    vw.set_defaults(fn=cmd_view)

    fs = sub.add_parser("flagstat", help="alignment flag counters")
    fs.add_argument("input", help="SAM or BAM")
    fs.set_defaults(fn=cmd_flagstat)

    ix = sub.add_parser(
        "idxstats", help="per-contig mapped/unmapped counts (SAM or BAM)"
    )
    ix.add_argument("input", help="SAM or BAM")
    ix.set_defaults(fn=cmd_idxstats)

    md = sub.add_parser(
        "markdup", help="mark duplicate templates (samtools markdup)"
    )
    md.add_argument("input", help="SAM or BAM")
    md.add_argument("--output", default=None,
                    help="output path (.sam for SAM; default "
                         "<input>.markdup.bam, sorted + indexed)")
    md.set_defaults(fn=cmd_markdup)

    st = sub.add_parser(
        "stats", help="samtools-stats-style summary (SN + RL + IS sections)"
    )
    st.add_argument("input", help="SAM or BAM")
    st.add_argument("--output", default=None)
    st.set_defaults(fn=cmd_stats)

    bc = sub.add_parser(
        "bedcov", help="per-BED-region coverage sums (samtools bedcov)"
    )
    bc.add_argument("input", help="SAM or BAM")
    bc.add_argument("bed", help="BED3+ file of regions")
    bc.add_argument("--output", default=None)
    bc.set_defaults(fn=cmd_bedcov)

    dp = sub.add_parser(
        "depth", help="per-position coverage (samtools depth semantics)"
    )
    dp.add_argument("input", help="SAM or BAM")
    dp.add_argument("region", nargs="?", default=None,
                    help="'chr' or 'chr:beg-end' (1-based inclusive); "
                         "with <input>.bai, only candidate bgzf members "
                         "are inflated")
    dp.add_argument("-a", "--all", action="store_true",
                    help="also print zero-depth positions")
    dp.add_argument("--output", default=None)
    dp.set_defaults(fn=cmd_depth)

    fq = sub.add_parser(
        "fastq", help="export reads from SAM/BAM back to FASTQ"
    )
    fq.add_argument("input", help="SAM or BAM")
    fq.add_argument("--output", default=None,
                    help="FASTQ for unpaired reads (default stdout)")
    fq.add_argument("-1", dest="r1", default=None, metavar="FQ1",
                    help="route read1 of pairs here (needs -2)")
    fq.add_argument("-2", dest="r2", default=None, metavar="FQ2",
                    help="route read2 of pairs here (needs -1)")
    fq.set_defaults(fn=cmd_fastq)

    fa = sub.add_parser(
        "faidx", help="index a FASTA (.fai) / fetch regions from it"
    )
    fa.add_argument("input", help="plain (uncompressed) FASTA")
    fa.add_argument("regions", nargs="*",
                    help="'chr' or 'chr:beg-end' (1-based inclusive); "
                         "prints FASTA instead of writing the index")
    fa.add_argument("--output", default=None)
    fa.set_defaults(fn=cmd_faidx)

    mg = sub.add_parser(
        "merge", help="merge SAM/BAMs into one sorted, indexed BAM"
    )
    mg.add_argument("output", help="output .bam (a .bai is written too)")
    mg.add_argument("inputs", nargs="+", help="SAM or BAM inputs")
    mg.set_defaults(fn=cmd_merge)

    de = sub.add_parser("dumpentry", help="print entry counters/bitmaps (debug)")
    de.add_argument("index")
    de.add_argument("entry", type=int)
    de.add_argument("--num", type=int, default=1)
    de.set_defaults(fn=cmd_dumpentry)

    df = sub.add_parser("diff", help="compare two .res interval files")
    df.add_argument("a")
    df.add_argument("b")
    df.set_defaults(fn=cmd_diff)

    db = sub.add_parser("dumpbwt", help="print the k BWT strings (debug)")
    db.add_argument("reference")
    db.add_argument("refsize", type=int)
    db.add_argument("--k", type=int, default=2)
    db.set_defaults(fn=cmd_dumpbwt)

    args = p.parse_args(argv)
    from tpufm.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
