"""FASTA reference / query I/O, format-compatible with the reference suite.

* read_reference mirrors readRef (reference common/common.c:42-76): skip the
  first '>' header line, concatenate sequence lines up to `refsize` chars.
* write_reference mirrors writeRef (reference common/common.c:88-117):
  header "> <size>", 70-column lines, trailing newline.
* load_queries mirrors loadQueries without warp interleaving (reference
  common/common.c:132-199): every non-header line is one read of exactly
  `query_len` characters. (The reference's GPU-only warp interleaving of
  query words is a CUDA coalescing artifact the XLA engines do not need —
  they take a dense [batch, len] uint8 array.)
"""

from __future__ import annotations


import numpy as np

from tpufm.utils.encoding import encode_bases

_LINE = 70


def open_maybe_gzip(path, mode: str = "rb"):
    """Open a file, transparently decompressing gzip (real references and
    read sets ship as .fa.gz/.fastq.gz). Detection is by the 2-byte gzip
    magic, not the extension, so renamed files still work."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        import gzip

        return gzip.open(path, mode)
    return open(path, mode)


def read_reference(path, refsize: int | None = None) -> np.ndarray:
    """Read a (M)FASTA reference into uint8 2-bit codes of length refsize."""
    chunks = []
    total = 0
    with open_maybe_gzip(path) as fp:
        first = fp.readline()
        if not first.startswith(b">"):
            raise ValueError(f"{path}: not a FASTA file (missing '>' header)")
        for line in fp:
            if line.startswith(b">"):
                continue
            seq = line.strip()
            if not seq:
                continue
            chunks.append(seq)
            total += len(seq)
            if refsize is not None and total >= refsize:
                break
    data = b"".join(chunks)
    if refsize is not None:
        if len(data) < refsize:
            raise ValueError(
                f"{path}: reference has {len(data)} bases, need {refsize}"
            )
        data = data[:refsize]
    return encode_bases(data)


def write_reference(path, seq: bytes | str) -> None:
    """Write a normalized single-record FASTA (70-col, '> <size>' header)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    with open(path, "wb") as fp:
        fp.write(b"> %d" % len(seq))
        for off in range(0, len(seq), _LINE):
            fp.write(b"\n" + seq[off : off + _LINE])
        fp.write(b"\n")


def _seq_extents(data: bytes):
    """Vectorized record scan shared by the batch loaders: one numpy
    pass over the raw file bytes -> (seq start, seq end) int64 arrays,
    one row per read, in file order. Mirrors _seq_lines' iteration
    contract exactly (FASTQ = 4-line records with empty-sequence records
    skipped; FASTA = every non-empty non-header line is one read), and
    tolerates \\r\\n line endings and a missing final newline. Backs
    sniff_reads: read count + length range in one pass with no Python
    per-line work (~0.5 s per million reads vs a full parse)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(arr == 10)
    if len(arr) and (len(nl) == 0 or nl[-1] != len(arr) - 1):
        nl = np.append(nl, len(arr))  # virtual newline at EOF
    if len(nl) == 0:
        z = np.zeros(0, np.int64)
        return z, z
    starts = np.empty(len(nl), np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl.astype(np.int64)
    cr = (ends > starts) & (arr[np.maximum(ends - 1, 0)] == 13)
    ends = ends - cr
    if data[:1] == b"@":  # FASTQ: sequence is line 4i+1
        s, e = starts[1::4], ends[1::4]
        keep = e > s
        return s[keep], e[keep]
    first = arr[np.minimum(starts, len(arr) - 1)]
    is_seq = (ends > starts) & (first != ord(">"))
    return starts[is_seq], ends[is_seq]


def _seq_lines(fp, fastq):
    """Yield one raw sequence per record: FASTQ 4-line records, or every
    non-header line of a (multi-)FASTA — the record iteration shared by
    load_queries / load_queries_varlen (load_query_names mirrors it)."""
    if fastq:
        while True:
            header = fp.readline()
            if not header:
                return
            yield fp.readline().strip()
            fp.readline()  # '+'
            fp.readline()  # quality
    else:
        for line in fp:
            if not line.startswith(b">"):
                yield line.strip()


def load_queries(path, query_len: int, num_queries: int | None = None) -> np.ndarray:
    """Load a query file into uint8 codes [num_queries, query_len].

    Accepts the reference's multi-FASTA `.qry` shape AND 4-line FASTQ
    (detected by the leading '@'; quality lines ignored), both optionally
    gzipped — real read sets ship as .fastq.gz. Hot-path note: the line
    loop + one joined bytes.translate encode measured FASTER than a full
    numpy line-scan/compress pipeline on this host (fewer 100+ MB memory
    passes); the numpy scan survives as sniff_reads/_seq_extents."""
    reads = []
    with open_maybe_gzip(path) as fp:
        fastq = fp.read(1) == b"@"
        fp.seek(0)
        for seq in _seq_lines(fp, fastq):
            if not seq:
                continue
            if len(seq) != query_len:
                raise ValueError(
                    f"{path}: read of length {len(seq)}, expected {query_len}"
                )
            reads.append(seq)
            if num_queries is not None and len(reads) == num_queries:
                break
    if num_queries is not None and len(reads) < num_queries:
        raise ValueError(f"{path}: only {len(reads)} reads, need {num_queries}")
    blob = b"".join(reads)
    return encode_bases(blob).reshape(len(reads), query_len)


def load_queries_varlen(path, num_queries: int | None = None) -> np.ndarray:
    """Load a MIXED-length FASTA/FASTQ(.gz) read set as uint8 codes
    [num_queries, max_len], each read RIGHT-ALIGNED with pad byte 0xFF on
    the left — the variable-length engine contract
    (tpufm.engine.xla.VARLEN_PAD / XLAEngine.search_varlen). Backward
    search consumes characters from the end, so right alignment puts every
    read's real suffix in the same columns.

    The right-alignment is ONE joined translate-encode plus one
    row-major masked scatter (the keep-mask enumerates cells in exactly
    the concatenated reads' order) — ~4x the per-read encode loop it
    replaced (4.5 s -> 1.1 s per million 120 bp reads on this host)."""
    reads = []
    with open_maybe_gzip(path) as fp:
        fastq = fp.read(1) == b"@"
        fp.seek(0)
        for seq in _seq_lines(fp, fastq):
            if not seq:
                continue
            reads.append(seq)
            if num_queries is not None and len(reads) == num_queries:
                break
    if num_queries is not None and len(reads) < num_queries:
        raise ValueError(f"{path}: only {len(reads)} reads, need {num_queries}")
    if not reads:
        raise ValueError(f"{path}: no reads found")
    lens = np.fromiter((len(r) for r in reads), np.int64, len(reads))
    max_len = int(lens.max())
    flat = encode_bases(b"".join(reads))
    out = np.full((len(reads), max_len), 0xFF, dtype=np.uint8)
    keep = np.arange(max_len, dtype=np.int64)[None, :] >= (
        max_len - lens[:, None]
    )
    out[keep] = flat
    return out


def sniff_reads(path):
    """(min_length, max_length, read_count) of a FASTA/FASTQ(.gz) read
    file — same record contract as the loaders, one vectorized pass."""
    with open_maybe_gzip(path) as fp:
        data = fp.read()
    s, e = _seq_extents(data)
    if not len(s):
        return None, 0, 0
    lens = e - s
    return int(lens.min()), int(lens.max()), len(s)


class PackedStrs:
    """Concatenated utf-8 strings + int64 offsets — the zero-copy
    names/quals carrier for the native SAM emitter (io/sam.py passes
    .buf/.off straight to C). Iterates/indexes as str so every Python
    path treats it like the list it replaces; an empty entry decodes to
    '' (falsy, same contract as a None qual)."""

    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes, off):
        self.buf = buf
        self.off = np.ascontiguousarray(off, dtype=np.int64)

    def __len__(self):
        return len(self.off) - 1

    def __getitem__(self, i):
        o = self.off
        return self.buf[o[i] : o[i + 1]].decode()

    def __iter__(self):
        o = self.off.tolist()
        buf = self.buf
        for a, b in zip(o, o[1:]):
            yield buf[a:b].decode()


def _packed_from(strs) -> PackedStrs:
    """list[str] -> PackedStrs (one join + one cumsum). The line-parsing
    itself stays the bytes loop of the list loaders: on this host,
    Python file iteration + bytes ops beat whole-file numpy scans, whose
    fresh 100+ MB temporaries pay first-touch page faults (measured:
    list-loader parse ~1.1 s/M reads vs ~5 s/M for the numpy line-table
    version this replaced)."""
    bufs = [s.encode() for s in strs]
    off = np.zeros(len(bufs) + 1, np.int64)
    np.cumsum([len(b) for b in bufs], out=off[1:])
    return PackedStrs(b"".join(bufs), off)


def load_query_names_packed(path, num_queries: int | None = None):
    """load_query_names, packed: one PackedStrs of QNAMEs (identical
    per-read values) that the native SAM emitter consumes zero-copy
    (io/sam.py passes .buf/.off straight to C, skipping the per-call
    re-concatenation of a million Python strings)."""
    return _packed_from(load_query_names(path, num_queries))


def load_query_quals_packed(path, num_queries: int | None = None):
    """load_query_quals, packed: PackedStrs of Phred+33 strings (empty
    entry = no/malformed quality -> the writers emit '*'), or None for
    FASTA input. Zero-copy into the native SAM emitter like
    load_query_names_packed."""
    quals = load_query_quals(path, num_queries)
    if quals is None:
        return None
    return _packed_from([q or "" for q in quals])


def load_query_quals(path, num_queries: int | None = None):
    """Per-read Phred+33 quality strings from a FASTQ(.gz) query file —
    for the SAM/BAM QUAL column — or None for FASTA/.qry input (no
    qualities exist; the writers then emit '*'). Record iteration mirrors
    load_queries exactly (empty-sequence records skipped), so quals[i]
    always labels reads[i]. A record whose quality length disagrees with
    its sequence length is carried as None (that one read gets '*')."""
    quals: list[str | None] = []
    with open_maybe_gzip(path) as fp:
        if fp.read(1) != b"@":
            return None
        fp.seek(0)
        while True:
            header = fp.readline()
            if not header:
                break
            seq = fp.readline().strip()
            fp.readline()  # '+'
            qual = fp.readline().strip()
            if not seq:
                continue
            quals.append(
                # latin-1: every byte 0-255 round-trips losslessly into
                # the BAM qual encoder (ascii+'replace' injected U+FFFD,
                # which desynced downstream byte-length assumptions)
                qual.decode("latin-1")
                if len(qual) == len(seq)
                else None
            )
            if num_queries is not None and len(quals) == num_queries:
                break
    if num_queries is not None and len(quals) < num_queries:
        quals += [None] * (num_queries - len(quals))
    return quals


def load_query_names(path, num_queries: int | None = None) -> list[str]:
    """Read one name per READ (not per header) from a .qry/FASTA/FASTQ
    query file — for SAM QNAMEs. Iteration mirrors load_queries exactly
    (every non-empty non-header line is a read; FASTQ records with empty
    sequences are skipped), so names[i] always labels reads[i] even for
    multi-line FASTA records, where each line inherits the last header's
    first token. Nameless or undecodable headers fall back to r{i}."""
    def tok(header: bytes, i: int) -> str:
        t = header[1:].split()
        return t[0].decode("ascii", "replace") if t else f"r{i}"

    names = []
    with open_maybe_gzip(path) as fp:
        fastq = fp.read(1) == b"@"
        fp.seek(0)
        if fastq:
            while True:
                header = fp.readline()
                if not header:
                    break
                seq = fp.readline().strip()
                fp.readline()
                fp.readline()
                if not seq:
                    continue  # load_queries skips empty-sequence records
                names.append(tok(header, len(names)))
                if num_queries is not None and len(names) == num_queries:
                    break
        else:
            current = None
            for line in fp:
                if line.startswith(b">"):
                    current = line
                elif line.strip():
                    names.append(
                        tok(current, len(names))
                        if current is not None
                        else f"r{len(names)}"
                    )
                    if num_queries is not None and len(names) == num_queries:
                        break
    if num_queries is not None and len(names) < num_queries:
        names += [f"r{i}" for i in range(len(names), num_queries)]
    return names
