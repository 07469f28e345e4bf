"""Collective-traffic model for the distributed engines, asserted against
the compiled HLO.

The reference has no distributed layer to compare against (SURVEY.md §2:
its cluster scripts schedule independent binaries); the cost model below
is tpufm's own contract, documented in docs/DISTRIBUTED.md "Traffic
model" and enforced here: `assert_collective_model` compiles an engine's
search program and checks that every collective op in it has exactly the
shape the model predicts — so a routing regression that silently doubles
bytes-per-round fails the driver dryrun instead of shipping.

Request rows are 12 B per interval end (block, code, interval — three
u32); answers are 4 B. B below is interval ends per chip (2 x the
per-chip read shard), D the mesh size.
"""

from __future__ import annotations

import re


def collective_bytes_model(routing: str, n_devices: int,
                           ends_per_chip: int) -> dict:
    """Per-LF-round collective payload bytes per chip, by routing
    (docs/DISTRIBUTED.md). Returns {"sent": ..., "received": ...,
    "answered_rows": ...} — `sent` counts bytes leaving the chip per
    round (the link budget), `answered_rows` the rank lookups the chip
    must compute (the D-fold compute overhead allgather/ring pay and
    a2a avoids)."""
    D, B = n_devices, ends_per_chip
    if routing == "allgather":
        # all-gather materializes the full [D, B, 3] request set on every
        # chip (each chip contributes its [B, 3] slice to D-1 peers), and
        # the [D, B] answers psum back.
        return {
            "sent": 12 * B * (D - 1) + 4 * B * (D - 1),
            "received": 12 * B * (D - 1) + 4 * B * (D - 1),
            "answered_rows": D * B,
        }
    if routing == "ring":
        # two half-blocks of B/2 requests circulate D hops each (one hop
        # per tick, phase-shifted so answering overlaps transit), plus the
        # accumulated 4 B answers riding every hop.
        return {
            "sent": (12 + 4) * (B // 2) * 2 * D,
            "received": (12 + 4) * (B // 2) * 2 * D,
            "answered_rows": D * B,
        }
    if routing == "a2a":
        # bucketed all-to-all at fixed capacity C = ceil(slack * B / D) per
        # destination (search.py _sharded_lf_step_a2a rounds UP so capacity
        # never truncates): C rows of 12 B out, C answers of 4 B back,
        # to/from each of D peers (self-bucket included in the op's shape).
        C = max(1, -(-2 * B // D))
        return {
            "sent": (12 + 4) * C * D,
            "received": (12 + 4) * C * D,
            "answered_rows": 2 * B,
        }
    raise ValueError(f"unknown routing {routing!r}")


def _collective_shapes(hlo_text: str) -> list[tuple[str, str]]:
    """[(op_kind, 'u32[8,128,3]'), ...] for every collective in the HLO."""
    out = []
    for line in hlo_text.splitlines():
        m = re.search(
            r"=\s*\(?([a-z0-9]+\[[\d,]*\])"  # (first) result shape
            # async lowering splits ops into -start/-done pairs; match the
            # -start (which carries the shapes) as the same logical op
            r".*?\b(all-gather|all-reduce|all-to-all|collective-permute)"
            r"(?:-start)?\(",
            line,
        )
        if m:
            out.append((m.group(2), m.group(1)))
    return out


def assert_collective_model(eng, queries_sharded) -> dict:
    """Compile `eng`'s search program and assert its collective ops carry
    exactly the model's shapes. Returns {"model": ..., "shapes": [...]}
    for the caller to log. Raises AssertionError with both sides on any
    mismatch."""
    import numpy as np

    D = eng.mesh.devices.size
    B_total, _ = queries_sharded.shape
    B = 2 * (B_total // D)  # interval ends per chip
    routing = getattr(eng, "routing", "dp")

    lowered = (
        eng._search.lower(
            eng.occ, eng.bitmaps, eng.dollar, eng.lut, eng.tail,
            np.uint32(eng.bwtsize), queries_sharded,
        )
        if routing != "dp"
        else eng._search.lower(
            eng.tables, np.uint32(eng.bwtsize), queries_sharded
        )
    )
    shapes = _collective_shapes(lowered.compile().as_text())
    got = {f"{kind} {shape}" for kind, shape in shapes}

    if D == 1:
        # a 1-device mesh has no cross-chip traffic and XLA elides every
        # collective (including the exit merge); the contract is that
        # nothing blew up at compile time
        model = (collective_bytes_model(routing, D, B)
                 if routing != "dp" else {"sent": 0, "received": 0})
        return {"model": model, "shapes": shapes}

    def need(kind, shape, why):
        key = f"{kind} {shape}"
        assert key in got, (
            f"routing={routing}: expected collective `{key}` ({why}) "
            f"not found; compiled collectives: {sorted(got)}"
        )

    # the exit merge every engine pays: replicating the [B_total, 2]
    # result is 8 B/read, once per batch (docs/DISTRIBUTED.md mode 1)
    need("all-gather", f"u32[{B_total},2]", "result merge, 8 B/read")

    if routing == "dp":
        assert len(got) == 1, (
            f"data-parallel search must have NO collectives beyond the "
            f"result merge; compiled: {sorted(got)}"
        )
        return {"model": {"sent": 0, "received": 0}, "shapes": shapes}

    model = collective_bytes_model(routing, D, B)
    if routing == "allgather":
        need("all-gather", f"u32[{D},{B},3]",
             f"request circulation, 12*{B}*{D} B materialized/chip/round")
        need("all-reduce", f"u32[{D},{B}]",
             f"answer psum, 4*{B}*{D} B/chip/round")
    elif routing == "ring":
        need("collective-permute", f"u32[{B // 2},3]",
             "half-block request hop, 12 B/end")
        need("collective-permute", f"u32[{B // 2}]",
             "half-block answer hop, 4 B/end")
        # no full-request-set materialization: the model's O(B_local) peak
        assert not any(k == "all-gather" and f"[{D},{B}," in s
                       for k, s in shapes), (
            "ring routing must not materialize the full request set"
        )
    elif routing == "a2a":
        C = max(1, -(-2 * B // D))
        need("all-to-all", f"u32[1,{C},3]",
             f"bucketed requests, capacity C={C} rows x 12 B per peer")
        need("all-to-all", f"u32[1,{C}]", "bucketed answers, 4 B/row")
        # the overflow fallback branch compiles the allgather shapes too
        need("all-gather", f"u32[{D},{B},3]", "overflow-fallback branch")
    return {"model": model, "shapes": shapes}
