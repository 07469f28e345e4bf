"""SAM (v1.6) emission — single-end and paired-end, each covering
exact / Hamming / edit-distance placements (both strands).

Exact and Hamming sites are pure `<L>M` CIGARs (substitutions live under
M) with NM:i the per-site distance; edit-distance sites are re-aligned
on the host (utils/align.edit_alignments) for real M/I/D CIGARs. The
reference suite has no position output at all, let alone SAM; this
exists so tpufm plugs into samtools-style pipelines.

Conventions implemented (SAM spec v1.6):
- POS is 1-based, RNAME/POS resolved through the multi-FASTA record map
  (tpufm.io.contigs.ContigMap); hits crossing a record boundary are
  concatenation artifacts of the indexed text and are DROPPED here (the
  `.pos` format keeps them, flagged `:spans`).
- SEQ is the forward-reference orientation: for a minus-strand alignment
  (FLAG 0x10) the reverse complement of the read as sequenced.
- One primary record per mapped read; further sites repeat as secondary
  (FLAG 0x100) records. QUAL is the read's Phred+33 string when the
  input was FASTQ (reversed on minus-strand records, matching SEQ's
  orientation), '*' otherwise.
- MAPQ is the standard uniqueness heuristic: 60 when the lowest-NM site
  is unique among the reported sites, 0 when tied (multi-mapper).
  Caveat: sites beyond max_hits are not seen, so a read whose best site
  was truncated away can carry MAPQ 60 on a suboptimal site — the
  reported-site contract, stated here rather than hidden behind 255.
  Paired records reuse the same rule over the reported proper pairs.
- Paired FR records carry 0x1|0x2 (paired, proper), 0x40/0x80 (first /
  second of pair), 0x10/0x20 (self / mate reversed), RNEXT '=', PNEXT,
  and signed TLEN (+fragment on the leftmost mate, -fragment on the
  rightmost; under --edits the fragment uses the right mate's ACTUAL
  aligned reference span). Pairs with no proper placement emit the
  standard both-unmapped pair (FLAG 77 / 141).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from tpufm.utils.encoding import decode_bases, reverse_complement

_SENT = np.uint32(0xFFFFFFFF)

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_EMIT_LIB_NAME = "libtpufm_samemit.so"
_emit_lib = None
_emit_tried = False


def _get_emitter():
    """The C record formatter (native/samemit.cpp) via ctypes, built on
    first use like the SA-IS library; None -> Python fallback. The two
    paths are byte-identical (tests/test_sam_native.py differential)."""
    global _emit_lib, _emit_tried
    if _emit_tried:
        return _emit_lib
    _emit_tried = True
    if os.environ.get("TPUFM_DISABLE_NATIVE", "0") == "1":
        return None
    lib_path = _NATIVE_DIR / _EMIT_LIB_NAME
    if not lib_path.exists():
        try:
            subprocess.run(
                ["make", "-s", _EMIT_LIB_NAME], cwd=_NATIVE_DIR,
                check=True, capture_output=True, timeout=300,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        lib.tpufm_sam_emit_single.restype = ctypes.c_int64
        _emit_lib = lib
    except OSError:
        _emit_lib = None
    return _emit_lib


def _concat_offsets(strs):
    """list[str] -> (bytes buffer, int64 [n+1] offsets), utf-8."""
    bufs = [s.encode() for s in strs]
    off = np.zeros(len(bufs) + 1, np.int64)
    np.cumsum([len(b) for b in bufs], out=off[1:])
    return b"".join(bufs), off


def _qual2(quals, i):
    """(forward, reversed) QUAL strings for read i — '*' when no
    qualities exist (FASTA input) or this read's were malformed. QUAL is
    stored in the record's SEQ orientation, so minus-strand (FLAG 0x10)
    records take the reversed string (SAM spec v1.6 section 1.4)."""
    q = None if quals is None else quals[i]
    return (q, q[::-1]) if q else ("*", "*")


def _mapq(nms) -> int:
    """60 when the lowest NM is unique among the reported sites, 0 when
    tied (multi-mapper), 0 when unmapped (caller emits FLAG 4 anyway)."""
    if not nms:
        return 0
    best = min(nms)
    return 60 if sum(1 for v in nms if v == best) == 1 else 0


def sam_header(cmap, extra_pg: str = "") -> str:
    """@HD/@SQ/@PG lines from a ContigMap."""
    lines = ["@HD\tVN:1.6\tSO:unknown"]
    ends = np.append(cmap.starts[1:], cmap.total)
    for name, start, end in zip(cmap.names, cmap.starts, ends):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(end - start)}")
    pg = "@PG\tID:tpufm\tPN:tpufm"
    if extra_pg:
        pg += f"\tCL:{extra_pg}"
    lines.append(pg)
    return "\n".join(lines) + "\n"


def _emit(blocks, return_blocks: bool):
    """blocks: one list of record lines per read. Joined text by default;
    return_blocks=True hands the per-read blocks back so a caller that
    batched reads out of order (per-length grouping of a mixed-length
    set, cli.cmd_align) can re-emit them in input order."""
    if return_blocks:
        return blocks
    return "\n".join(line for b in blocks for line in b) + "\n"


def sam_single_records(
    names, reads, pos_fwd, pos_rc, cmap, codes=None, lengths=None,
    return_blocks: bool = False, quals=None,
):
    """One SAM block per read: primary + secondary records over both
    strands' hits, or one unmapped record. The PRIMARY record is the
    lowest-NM site (ties: forward strand first, then position order) —
    the representative-alignment convention; the rest carry 0x100.

    names: list[str] QNAMEs. reads: uint8 [B, L] as sequenced.
    pos_fwd/pos_rc: uint32 [B, max_hits] sentinel-padded absolute
    positions of the read / its reverse complement. codes: the 2-bit
    reference — when given, NM:i is the per-site Hamming distance
    (Hamming alignments are pure <L>M CIGARs, so this covers
    --mismatches output exactly); when None the sites are exact and
    NM:i:0. lengths: per-read true lengths for a RIGHT-ALIGNED
    0xFF-padded variable-length batch (search_varlen contract) — CIGARs,
    NM windows, and contig span checks all use each read's own length.
    quals: per-read Phred+33 strings as sequenced (io.fasta
    load_query_quals) or None — minus-strand records reverse them."""
    B, Lmax = reads.shape
    Ls = (
        np.full(B, Lmax, dtype=np.int64)
        if lengths is None
        else np.asarray(lengths, dtype=np.int64)
    )
    # Everything array-shaped happens in vectorized passes up front; the
    # per-read loop below touches only Python lists and strings. This is
    # the aligner's host bottleneck: per-read numpy calls cost far more
    # than the device search they follow.
    idx_f, off_f, sp_f = cmap.resolve(pos_fwd, query_len=Ls[:, None])
    idx_r, off_r, sp_r = cmap.resolve(pos_rc, query_len=Ls[:, None])
    # batch ASCII: one decode for all forward suffixes, one for all
    # reverse complements (varlen pad bytes clip to 'T' and are sliced
    # away before use — reads are right-aligned, their rc left-aligned)
    fwd_bytes = decode_bases(np.minimum(reads, 3).reshape(-1))
    rcb = reads[:, ::-1]
    rcb = np.where(rcb <= 3, 3 - rcb, 0).astype(np.uint8)
    rc_bytes = decode_bases(rcb.reshape(-1))
    ok_f = (pos_fwd != _SENT) & (idx_f >= 0) & ~sp_f
    ok_r = (pos_rc != _SENT) & (idx_r >= 0) & ~sp_r
    H = pos_fwd.shape[1]
    nm_f = np.zeros((B, H), np.int64)
    nm_r = np.zeros((B, H), np.int64)
    if codes is not None:
        n = codes.shape[0]
        for L in np.unique(Ls):
            rowsel = Ls == L
            win = np.arange(int(L))
            for ok, pos, nm, mat in (
                (ok_f, pos_fwd, nm_f, reads[:, Lmax - int(L):]),
                (ok_r, pos_rc, nm_r, rcb[:, : int(L)]),
            ):
                si, sj = np.nonzero(ok & rowsel[:, None])
                if not si.size:
                    continue
                w = pos[si, sj].astype(np.int64)[:, None] + win
                nm[si, sj] = (
                    np.where(w < n, codes[np.minimum(w, n - 1)], 255)
                    != mat[si]
                ).sum(1)
    lib = _get_emitter()
    if lib is not None and 2 * H <= 512:  # C site buffer bound
        if hasattr(names, "off"):  # PackedStrs: zero-copy from the loader
            names_buf, names_off = names.buf, names.off
        else:
            names_buf, names_off = _concat_offsets(names)
        if quals is None:
            quals_buf, quals_off = b"", None
        elif hasattr(quals, "off"):
            quals_buf, quals_off = quals.buf, quals.off
        else:
            quals_buf, quals_off = _concat_offsets(
                [q or "" for q in quals]
            )
        cnames_buf, cnames_off = _concat_offsets(list(cmap.names))
        counts = ok_f.sum(axis=1) + ok_r.sum(axis=1)
        name_lens = np.diff(names_off)
        max_cname = int(np.diff(cnames_off).max()) if len(cmap.names) else 0
        qual_lens = np.diff(quals_off) if quals_off is not None else 0
        cap = int(
            (np.maximum(counts, 1)
             * (name_lens + max_cname + Ls + qual_lens + 128)).sum()
        ) + 1
        out_buf = np.empty(cap, np.uint8)
        ends = np.empty(max(B, 1), np.int64)

        def ptr(a, ct):
            return np.ascontiguousarray(a).ctypes.data_as(
                ctypes.POINTER(ct)
            )

        nwritten = lib.tpufm_sam_emit_single(
            ctypes.c_int64(B), ctypes.c_int64(H), ctypes.c_int64(Lmax),
            ptr(Ls, ctypes.c_int64),
            fwd_bytes, rc_bytes,
            names_buf, ptr(names_off, ctypes.c_int64),
            quals_buf,
            ptr(quals_off, ctypes.c_int64) if quals_off is not None
            else None,
            cnames_buf, ptr(cnames_off, ctypes.c_int64),
            ptr(ok_f.astype(np.int8), ctypes.c_int8),
            ptr(nm_f, ctypes.c_int64),
            ptr(idx_f.astype(np.int32), ctypes.c_int32),
            ptr((off_f + 1).astype(np.int64), ctypes.c_int64),
            ptr(ok_r.astype(np.int8), ctypes.c_int8),
            ptr(nm_r, ctypes.c_int64),
            ptr(idx_r.astype(np.int32), ctypes.c_int32),
            ptr((off_r + 1).astype(np.int64), ctypes.c_int64),
            out_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
            ctypes.c_int64(cap),
            ptr(ends, ctypes.c_int64),
        )
        if nwritten >= 0:
            raw = out_buf[:nwritten].tobytes()
            if not return_blocks:
                return raw.decode()
            blocks, prev = [], 0
            for i in range(B):
                e = int(ends[i])
                blocks.append(raw[prev:e].decode().split("\n")[:-1])
                prev = e
            return blocks
        # capacity miss (cannot happen with the sizing above) -> fall
        # through to the Python loop
    fwd_ascii = fwd_bytes.decode()
    rc_ascii = rc_bytes.decode()
    # scalarize once: the assembly loop then never indexes numpy arrays
    ok_f, ok_r = ok_f.tolist(), ok_r.tolist()
    nm_f, nm_r = nm_f.tolist(), nm_r.tolist()
    idx_f, idx_r = idx_f.tolist(), idx_r.tolist()
    p1_f = (off_f + 1).tolist()
    p1_r = (off_r + 1).tolist()
    cnames = cmap.names
    blocks = []
    for i, name in enumerate(names):
        out = []
        blocks.append(out)
        L = int(Ls[i])
        base = i * Lmax
        seq_f = fwd_ascii[base + Lmax - L : base + Lmax]
        seq_r = rc_ascii[base : base + L]
        sites = []  # (nm, order, flag, rname, pos1, seq)
        for ok, nm, idx, p1, flag, seq in (
            (ok_f[i], nm_f[i], idx_f[i], p1_f[i], 0, seq_f),
            (ok_r[i], nm_r[i], idx_r[i], p1_r[i], 16, seq_r),
        ):
            for j in range(H):
                if ok[j]:
                    sites.append(
                        (nm[j], len(sites), flag, cnames[idx[j]],
                         p1[j], seq)
                    )
        sites.sort(key=lambda s: (s[0], s[1]))
        mapq = _mapq([s[0] for s in sites])
        qf, qr = _qual2(quals, i)
        for emitted, (nm, _, flag, rname, pos1, seq) in enumerate(sites):
            f = flag | (0x100 if emitted else 0)
            out.append(
                f"{name}\t{f}\t{rname}\t{pos1}\t{mapq}\t{L}M\t*\t0\t0\t"
                f"{seq}\t{qr if flag & 0x10 else qf}\tNM:i:{nm}"
            )
        if not sites:
            out.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq_f}\t{qf}")
    return _emit(blocks, return_blocks)


def sam_edit_records(names, reads, pos_fwd, pos_rc, cmap, codes,
                     edits: int, return_blocks: bool = False, quals=None):
    """Edit-distance SAM records with REAL CIGARs: every reported site is
    re-aligned on the host (utils/align.edit_alignments — start-anchored
    free-end DP with traceback, batched over the hit list), yielding
    M/I/D CIGARs and NM:i. Primary is the lowest-NM site; span checks use
    each alignment's ACTUAL reference span, so sites near a contig end
    survive when their alignment fits."""
    from tpufm.utils.align import edit_alignments

    L = reads.shape[1]
    rcs = reverse_complement(reads)
    sites = []  # (read i, flag, abs pos)
    for i in range(len(names)):
        for p in pos_fwd[i]:
            if p != _SENT:
                sites.append((i, 0, int(p)))
        for p in pos_rc[i]:
            if p != _SENT:
                sites.append((i, 16, int(p)))
    if sites:
        mats = np.stack([
            (reads if f == 0 else rcs)[i] for i, f, _ in sites
        ])
        pos_arr = np.asarray([p for _, _, p in sites], np.int64)
        # chunk the re-alignment: the DP's pointer tensor is
        # [chunk, L, L+E] int8, so an unchunked genome-scale hit list
        # would exhaust host memory
        cigars, nms, spans = [], [], []
        for lo_i in range(0, len(sites), 1 << 16):
            c_, n_, s_ = edit_alignments(
                codes, mats[lo_i : lo_i + (1 << 16)],
                pos_arr[lo_i : lo_i + (1 << 16)], edits,
            )
            cigars.extend(c_)
            nms.append(n_)
            spans.append(s_)
        nm = np.concatenate(nms)
        ref_span = np.concatenate(spans)
        idx, off, _ = cmap.resolve(pos_arr.astype(np.uint32))
        ends = np.append(cmap.starts[1:], cmap.total)
        clen = ends[np.maximum(idx, 0)] - cmap.starts[np.maximum(idx, 0)]
        ok = (idx >= 0) & (off + ref_span <= clen)
    per_read = {}
    for j, (i, flag, _) in enumerate(sites):
        if not ok[j]:
            continue
        per_read.setdefault(i, []).append(
            (int(nm[j]), len(per_read.get(i, ())), flag,
             cmap.names[idx[j]], int(off[j]) + 1, cigars[j])
        )
    blocks = []
    for i, name in enumerate(names):
        out = []
        blocks.append(out)
        rows = sorted(per_read.get(i, []))
        seq_f = decode_bases(reads[i]).decode()
        seq_r = decode_bases(rcs[i]).decode()
        mapq = _mapq([r[0] for r in rows])
        qf, qr = _qual2(quals, i)
        for emitted, (nm_j, _, flag, rname, pos1, cigar) in enumerate(rows):
            f = flag | (0x100 if emitted else 0)
            seq = seq_r if flag & 0x10 else seq_f
            out.append(
                f"{name}\t{f}\t{rname}\t{pos1}\t{mapq}\t{cigar}\t*\t0\t0\t"
                f"{seq}\t{qr if flag & 0x10 else qf}\tNM:i:{nm_j}"
            )
        if not rows:
            out.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq_f}\t{qf}")
    return _emit(blocks, return_blocks)


def sam_paired_records(names, r1, r2, pairs, strand, cmap, codes=None,
                       edits: int = 0, return_blocks: bool = False,
                       quals1=None, quals2=None):
    """Two SAM records per read pair: the primary proper pair — the
    lowest combined-NM placement (ties: engine order) — with additional
    pairs as secondary record pairs, or the standard both-unmapped pair.

    pairs/strand are PairedEndEngine.pair outputs; `pairs[i, j]` is
    (leftmost mate start, rightmost mate start) and strand 0 means R1 is
    the plus-strand (leftmost) mate.

    codes: the 2-bit reference. When given with edits == 0, NM:i is each
    mate's Hamming distance at its site (Hamming alignments are pure
    <L>M CIGARs, so this covers --paired --mismatches output exactly).
    When edits > 0, both mates are re-aligned on the host
    (utils/align.edit_alignments) for REAL M/I/D CIGARs; span checks and
    TLEN then use each alignment's ACTUAL reference span. When codes is
    None the pairs are exact (NM:i:0)."""
    blocks = []
    B, P = pairs.shape[:2]
    L1, L2 = r1.shape[1], r2.shape[1]
    r1r = reverse_complement(r1)
    r2r = reverse_complement(r2)
    idx_l, off_l, _ = cmap.resolve(pairs[..., 0])
    idx_r, off_r, _ = cmap.resolve(pairs[..., 1])
    cends = np.append(cmap.starts[1:], cmap.total)
    clen_l = (cends - cmap.starts)[np.maximum(idx_l, 0)]
    clen_r = (cends - cmap.starts)[np.maximum(idx_r, 0)]
    valid = (pairs[..., 0] != _SENT) & (idx_l >= 0) & (idx_l == idx_r)
    vi, vj = np.nonzero(valid)
    len_left = np.where(strand == 0, L1, L2)
    len_right = np.where(strand == 0, L2, L1)
    span_l = len_left.astype(np.int64)
    span_r = len_right.astype(np.int64)
    nm_l = np.zeros((B, P), np.int64)
    nm_r = np.zeros((B, P), np.int64)
    cig_l = np.empty((B, P), object)
    cig_r = np.empty((B, P), object)
    # NM/CIGAR re-evaluation partitions the accepted pair sites BY
    # STRAND so the two mates never share a matrix — that is what lets
    # mate lengths differ (strand 0: R1 fwd left / rc(R2) right;
    # strand 1: R2 fwd left / rc(R1) right).
    parts = []
    if codes is not None and len(vi):
        plus = strand[vi, vj] == 0
        parts = [
            # (pair row selector, left-end mate rows, right-end mate rows)
            (plus, r1, r2r),
            (~plus, r2, r1r),
        ]
    if edits:
        # re-align the ACCEPTED pair sites (not the candidate grid) for
        # real M/I/D CIGARs — cost proportional to the pair list;
        # chunked because the DP pointer tensor is [chunk, L, L+E] int8
        from tpufm.utils.align import edit_alignments

        def realign(mat, starts):
            cigs, nms, spans = [], [], []
            for lo in range(0, len(starts), 1 << 16):
                c_, n_, s_ = edit_alignments(
                    codes, mat[lo : lo + (1 << 16)],
                    starts[lo : lo + (1 << 16)], edits,
                )
                cigs.extend(c_)
                nms.append(n_)
                spans.append(s_)
            return cigs, np.concatenate(nms), np.concatenate(spans)

        span_l = np.broadcast_to(span_l, (B, P)).copy()
        span_r = np.broadcast_to(span_r, (B, P)).copy()
        for sel, left_rows, right_rows in parts:
            si, sj = vi[sel], vj[sel]
            if not len(si):
                continue
            for rows, col, nm_a, sp_a, cg_a in (
                (left_rows, 0, nm_l, span_l, cig_l),
                (right_rows, 1, nm_r, span_r, cig_r),
            ):
                cigs, nms, spans = realign(
                    rows[si], pairs[si, sj, col].astype(np.int64)
                )
                nm_a[si, sj] = nms
                sp_a[si, sj] = spans
                for t, c in enumerate(cigs):
                    cg_a[si[t], sj[t]] = c
    elif parts:
        n = codes.shape[0]

        def ham(mat, starts):
            w = starts[:, None] + np.arange(mat.shape[1])
            return (
                np.where(w < n, codes[np.minimum(w, n - 1)], 255) != mat
            ).sum(1)

        for sel, left_rows, right_rows in parts:
            si, sj = vi[sel], vj[sel]
            if not len(si):
                continue
            nm_l[si, sj] = ham(left_rows[si],
                               pairs[si, sj, 0].astype(np.int64))
            nm_r[si, sj] = ham(right_rows[si],
                               pairs[si, sj, 1].astype(np.int64))
    sp_l = off_l + span_l > clen_l
    sp_r = off_r + span_r > clen_r
    for i, name in enumerate(names):
        out = []
        blocks.append(out)
        seq1f = decode_bases(r1[i]).decode()
        seq1r = decode_bases(r1r[i]).decode()
        seq2f = decode_bases(r2[i]).decode()
        seq2r = decode_bases(r2r[i]).decode()
        q1f, q1r = _qual2(quals1, i)
        q2f, q2r = _qual2(quals2, i)
        rows = sorted(
            (int(nm_l[i, j] + nm_r[i, j]), j)
            for j in range(P)
            if valid[i, j] and not sp_l[i, j] and not sp_r[i, j]
        )
        mapq = _mapq([nm for nm, _ in rows])
        for emitted, (_, j) in enumerate(rows):
            rname = cmap.names[idx_l[i, j]]
            lpos1, rpos1 = int(off_l[i, j]) + 1, int(off_r[i, j]) + 1
            frag = int(off_r[i, j]) + int(span_r[i, j]) - int(off_l[i, j])
            c_l = cig_l[i, j] or f"{int(len_left[i, j])}M"
            c_r = cig_r[i, j] or f"{int(len_right[i, j])}M"
            if strand[i, j] == 0:
                # R1 forward at left, rc(R2) at right
                p1, f1, s1, c1, n1, q1 = (
                    lpos1, 0x63, seq1f, c_l, nm_l[i, j], q1f)
                p2, f2, s2, c2, n2, q2 = (
                    rpos1, 0x93, seq2r, c_r, nm_r[i, j], q2r)
            else:
                # R2 forward at left, rc(R1) at right
                p1, f1, s1, c1, n1, q1 = (
                    rpos1, 0x53, seq1r, c_r, nm_r[i, j], q1r)
                p2, f2, s2, c2, n2, q2 = (
                    lpos1, 0xA3, seq2f, c_l, nm_l[i, j], q2f)
            sec = 0x100 if emitted else 0
            t1 = frag if p1 <= p2 else -frag
            out.append(
                f"{name}\t{f1 | sec}\t{rname}\t{p1}\t{mapq}\t{c1}\t=\t"
                f"{p2}\t{t1}\t{s1}\t{q1}\tNM:i:{int(n1)}"
            )
            out.append(
                f"{name}\t{f2 | sec}\t{rname}\t{p2}\t{mapq}\t{c2}\t=\t"
                f"{p1}\t{-t1}\t{s2}\t{q2}\tNM:i:{int(n2)}"
            )
        if not rows:
            out.append(f"{name}\t77\t*\t0\t0\t*\t*\t0\t0\t{seq1f}\t{q1f}")
            out.append(f"{name}\t141\t*\t0\t0\t*\t*\t0\t0\t{seq2f}\t{q2f}")
    return _emit(blocks, return_blocks)
