"""The benchmark's one input generator: genomes, reads, strains and gzip
FASTQ files, all from the run's seed and the parameters of the cell's
and the configuration's files.

Every draw comes from its own numpy Generator seeded by (seed, stream,
block), so the same seed gives the same bytes whatever the thread count,
and every seed gives the same sizes.  Codes are 0-3 for A, C, G, T.

Forms of input (a cell's "input" {"form": ...}):

  fastq_gz     the configuration's reads, written as a gzip FASTQ of
               members of `reads_per_member` whole records, with one
               false member candidate inside the deflate data of each
               member at the fractions `false_member_candidates` of the
               file, and nowhere else
  read_arrays  the configuration's `n_arrays` sets of `reads_per_array`
               reads in memory, drawn from the same genome with the
               same error model

Reads carry qualities drawn by the configuration's weights, and their
substitutions come at the rate those qualities state (Phred).
  strains      the configuration's genome and `n_strains - 1` copies of
               it with seeded substitutions, one row per chromosome
"""
from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

LETTERS = np.frombuffer(b"ACGT", np.uint8)
READS_PER_BLOCK = 100_000  # reads drawn (and formatted) by one task
# streams of draws under one seed
GENOME, READS, STRAINS, ARRAYS = 1, 2, 3, 4


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & ((1 << 64) - 1), *stream])


class Input:
    """One input of a cell: the codes the generator made, as flat uint8
    codes with row lengths (what the reference reads), and the FASTQ
    file holding them when the form writes one (what the program
    reads)."""

    def __init__(self, flat: np.ndarray, lengths: np.ndarray, path=None):
        self.flat = flat
        self.lengths = lengths
        self.path = path

    @property
    def n_bases(self) -> int:
        return int(self.flat.size)

    @property
    def n_reads(self) -> int:
        return int(self.lengths.size)


def genome(sizes, seed: int) -> np.ndarray:
    """Seeded codes of the chromosomes' total length, chromosomes end to
    end in the given order."""
    return rng_for(seed, GENOME).integers(0, 4, int(sum(sizes)),
                                          dtype=np.uint8)


def mutate(codes: np.ndarray, rate: float, rng) -> None:
    """Substitute a seeded `rate` share of the codes in place: a binomial
    count of positions, each changed to one of the three other bases."""
    n = rng.binomial(codes.size, rate)
    pos = rng.integers(0, codes.size, n)
    codes[pos] = (codes[pos] + rng.integers(1, 4, n, dtype=np.uint8)) % 4


def strains(base: np.ndarray, sizes, n_strains: int, rate: float,
            seed: int):
    """`base` and n_strains - 1 copies with seeded substitutions at
    `rate`, as (flat codes, row lengths), one row per chromosome."""
    rows = [base]
    for v in range(1, n_strains):
        mut = base.copy()
        mutate(mut, rate, rng_for(seed, STRAINS, v))
        rows.append(mut)
    return np.concatenate(rows), np.tile(np.asarray(sizes, np.int64),
                                         n_strains)


class ReadSampler:
    """Reads of one length from both strands of a genome, at uniform
    starts inside a chromosome, with seeded substitutions."""

    def __init__(self, codes: np.ndarray, sizes, read_length: int,
                 substitution_rate: float):
        self.length = read_length
        self.rate = substitution_rate
        self.forward = sliding_window_view(codes, read_length)
        self.reverse = sliding_window_view(
            (3 - codes[::-1]).copy(), read_length)
        sizes = np.asarray(sizes, np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.n_starts = np.maximum(sizes - read_length + 1, 0)
        self.cum_starts = np.cumsum(self.n_starts)
        self.total = int(codes.size)

    def draw(self, n: int, rng) -> np.ndarray:
        """(n, read_length) uint8 codes."""
        k = rng.integers(0, int(self.cum_starts[-1]), n)
        chrom = np.searchsorted(self.cum_starts, k, side="right")
        start = self.offsets[chrom] + k - (self.cum_starts[chrom]
                                           - self.n_starts[chrom])
        minus = rng.integers(0, 2, n).astype(bool)
        out = self.forward[start]
        out[minus] = self.reverse[self.total - start[minus] - self.length]
        mutate(out.reshape(-1), self.rate, rng)
        return out


def quality_table(weights: dict) -> np.ndarray:
    """Quality characters repeated by their integer weights: a uniform
    draw of an index gives each character its weight's share."""
    return np.concatenate([np.full(w, ord(c), np.uint8)
                           for c, w in weights.items()])


def fastq_records(codes: np.ndarray, first: int, header: str,
                  quals: np.ndarray) -> np.ndarray:
    """(n, width) uint8 FASTQ records of fixed width: `header` with its
    `{}` replaced by the read's 9-digit number, the bases, '+', the
    qualities."""
    n, length = codes.shape
    head = header.encode()
    cut = head.index(b"{}")
    head = head[:cut] + b"0" * 9 + head[cut + 2:]
    width = len(head) + length * 2 + 5
    rec = np.empty((n, width), np.uint8)
    rec[:, : len(head)] = np.frombuffer(head, np.uint8)
    number = np.arange(first, first + n, dtype=np.int64)
    for d in range(9):
        rec[:, cut + 8 - d] = 48 + (number // 10 ** d) % 10
    col = len(head)
    rec[:, col] = 10
    rec[:, col + 1: col + 1 + length] = LETTERS[codes]
    col += 1 + length
    rec[:, col: col + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, col + 3: col + 3 + length] = quals
    rec[:, -1] = 10
    return rec


GZ_MAGIC = b"\x1f\x8b\x08"


def false_candidates(member: bytes) -> int:
    """Places after its first byte where a member holds what a member
    scanner takes for the start of one: the gzip magic followed by a
    flag byte with its three reserved bits clear."""
    n, i = 0, member.find(GZ_MAGIC, 1)
    while i >= 0:
        n += i + 3 >= len(member) or not member[i + 3] & 0xE0
        i = member.find(GZ_MAGIC, i + 1)
    return n


# deflate's fixed Huffman block (RFC 1951, 3.2.5-3.2.6): the base and
# extra bits of each length code (257..285) and distance code (0..29)
LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
            43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0,) * 8 + (1,) * 4 + (2,) * 4 + (3,) * 4 + (4,) * 4 \
    + (5,) * 4 + (0,)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
             257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
             12289, 16385, 24577)
DIST_EXTRA = (0, 0, 0, 0) + tuple(n for n in range(1, 14) for _ in (0, 1))
WINDOW = 32768
# the candidate's 32 bits in stream order: magic, then a flag byte whose
# five low bits are free (None) and whose three reserved bits are clear
CANDIDATE_BITS = tuple(
    (b >> j) & 1 for b in GZ_MAGIC for j in range(8)) + (None,) * 5 \
    + (0, 0, 0)


def _huffman(code: int, n: int) -> list:
    """A Huffman code's bits in stream order: most significant first."""
    return [(code >> (n - 1 - j)) & 1 for j in range(n)]


def _extra(value: int, n: int) -> list:
    """Extra bits in stream order: least significant first."""
    return [(value >> j) & 1 for j in range(n)]


def _literal(byte: int) -> list:
    return (_huffman(0x30 + byte, 8) if byte < 144
            else _huffman(0x190 + byte - 144, 9))


def _length(n: int) -> list:
    """Fixed-code bits of a match of 3..258 bytes."""
    i = max(j for j, base in enumerate(LEN_BASE) if base <= n)
    sym = 257 + i
    code = _huffman(sym - 256, 7) if sym < 280 else \
        _huffman(0xC0 + sym - 280, 8)
    return code + _extra(n - LEN_BASE[i], LEN_EXTRA[i])


LENGTH_BITS = [None] * 3 + [_length(n) for n in range(3, 259)]
DIST_CODE_BITS = [_huffman(code, 5) for code in range(30)]
DIST_CUTS = np.array(DIST_BASE + (WINDOW + 1,))


def _fits(bits: list, at: int, start: int) -> bool:
    """Whether `bits`, placed at stream offset `at`, agree with the
    candidate placed at `start`."""
    for j, bit in enumerate(bits):
        k = at + j - start
        if 0 <= k < 32 and CANDIDATE_BITS[k] is not None \
                and CANDIDATE_BITS[k] != bit:
            return False
    return True


class _Encodings:
    """The ways to encode a text in a fixed-Huffman deflate block whose
    bits hold a false member candidate at a chosen byte boundary: a
    depth-first search over literals and matches (which earlier copy a
    match takes, and how long it is), the choices by which an encoder
    puts such bytes into compressed data at random."""

    LENGTHS = range(3, 258)
    PER_CODE = 4  # distances tried for each length and distance code
    DEPTH = 8     # tokens that may complete the candidate
    NODES = 64    # search steps from one place before the next is tried

    def __init__(self, data: np.ndarray):
        self.data = data
        self._dists = {}

    def dists(self, i: int, n: int) -> np.ndarray:
        """Distances, nearest first, at which the n bytes at i repeat."""
        key = (i, n)
        if key not in self._dists:
            data = self.data
            if n == 1:
                lo = max(0, i - WINDOW)
                d = i - lo - np.flatnonzero(data[lo:i] == data[i])[::-1]
            else:
                d = self.dists(i, n - 1)
                d = d[data[i - d + n - 1] == data[i + n - 1]]
            self._dists[key] = d
        return self._dists[key]

    def matches(self, i: int, end: int, at: int, start: int):
        """Match tokens (length, bits) for the text at `i` whose bits,
        placed at stream offset `at`, agree with the candidate placed at
        `start`."""
        for n in self.LENGTHS:
            if i + n > end:
                break
            dists = self.dists(i, n)
            if dists.size == 0:
                break
            head = LENGTH_BITS[n]
            if not _fits(head, at, start):
                continue
            cuts = np.searchsorted(dists, DIST_CUTS).tolist()
            for code, base in enumerate(DIST_BASE):
                if cuts[code] == cuts[code + 1]:
                    continue
                bits = head + DIST_CODE_BITS[code]
                if not _fits(bits, at, start):
                    continue
                nx, o = DIST_EXTRA[code], at + len(bits)
                mask = want = 0
                for j in range(nx):
                    k = o + j - start
                    if 0 <= k < 32 and CANDIDATE_BITS[k] is not None:
                        mask |= 1 << j
                        want |= CANDIDATE_BITS[k] << j
                sel = dists[cuts[code]:cuts[code + 1]]
                sel = sel[((sel - base) & mask) == want][:self.PER_CODE]
                for d in sel.tolist():
                    yield n, bits + _extra(d - base, nx)

    def search(self, i: int, end: int, bits: list, start: int,
               depth: int):
        """(position, bits) once the candidate at `start` is complete,
        or None."""
        if len(bits) >= start + 32:
            return i, bits
        self.budget -= 1
        if depth == 0 or i >= end or self.budget < 0:
            return None
        lit = _literal(int(self.data[i]))
        options = [(1, lit)] if _fits(lit, len(bits), start) else []
        options += list(self.matches(i, end, len(bits), start))
        for n, b in options:
            found = self.search(i + n, end, bits + b, start, depth - 1)
            if found is not None:
                return found
        return None


def candidate_block(data: np.ndarray, lo: int, stride: int):
    """(bits, hi): the bits of one fixed-Huffman deflate block, not
    final, that encodes data[lo:hi] with literals and matches into the
    text before it, and whose bits hold one false member candidate at a
    byte boundary of the block.  The candidate is sought from each
    place of the line at `lo`, then of the line `stride` bytes on, and
    so on; `hi` is the end of the line that holds it.  The block starts
    at a byte boundary."""
    enc = _Encodings(data)
    bits = [0, 1, 0]  # BFINAL 0, BTYPE 01
    for line in range(lo, len(data), stride):
        for b in data[lo:line].tolist():
            bits += _literal(b)
        hi = int(np.argmax(data[line:] == 10)) + line + 1
        for entry in range(line, hi - 16):
            for skip in (0, 1, 2):
                start = -(-len(bits) // 8) * 8 + 8 * skip
                enc.budget = enc.NODES
                found = enc.search(entry, hi, bits, start, enc.DEPTH)
                if found is not None:
                    i, out = found
                    for b in data[i:hi].tolist():
                        out += _literal(b)
                    return out + [0] * 7, hi  # end of block (symbol 256)
            bits += _literal(int(data[entry]))
        lo = hi - 16
    raise ValueError("no encoding of the text holds a false candidate")


def gzip_member(data: bytes, level: int, plant_at: int = None,
                stride: int = 0) -> bytes:
    """One gzip member of `data` with no false member candidate in its
    compressed bytes: a member that holds one at random (~1 in 2^27
    bytes) is compressed again at the next level.  With `plant_at`, a
    byte offset of `data`, its deflate stream holds exactly one: the
    text from there on to the end of the line where `candidate_block`
    (searching lines `stride` bytes apart) places it is that block,
    between zlib's blocks for the text before and after it."""
    tail = zlib.crc32(data).to_bytes(4, "little") + \
        (len(data) & 0xFFFFFFFF).to_bytes(4, "little")
    head = b"\x1f\x8b\x08\x00" + bytes(4) + b"\x00\x03"
    for lvl in range(level, 10):
        if plant_at is None:
            member = zlib.compress(data, lvl, wbits=31)
        else:
            arr = np.frombuffer(data, np.uint8)
            first = zlib.compressobj(lvl, zlib.DEFLATED, -15)
            body = first.compress(data[:plant_at]) + \
                first.flush(zlib.Z_FULL_FLUSH)
            bits, hi = candidate_block(arr, plant_at, stride)
            # an empty stored block brings the stream to a byte boundary
            bits += [0, 0, 0] + [0] * (-(len(bits) + 3) % 8)
            body += np.packbits(np.array(bits, np.uint8),
                                bitorder="little").tobytes()
            body += b"\x00\x00\xff\xff"
            rest = zlib.compressobj(lvl, zlib.DEFLATED, -15,
                                    zdict=data[max(0, hi - WINDOW):hi])
            body += rest.compress(data[hi:]) + rest.flush()
            member = head + body + tail
        if false_candidates(member) == int(plant_at is not None):
            return member
    raise ValueError("no gzip level gives a member with the false member "
                     "candidates asked for")


def phred_error_rate(weights: dict) -> float:
    """The share of bases called wrong by the qualities' own meaning
    (Phred: a quality q, the character q + 33, is wrong with chance
    10^(-q/10)), over the quality characters and their weights."""
    total = sum(weights.values())
    return sum(w * 10 ** (-(ord(c) - 33) / 10)
               for c, w in weights.items()) / total


def reads_input(config: dict, seed: int, stream: int, n_reads: int,
                path=None) -> Input:
    """`n_reads` reads of the configuration's genome and error model as
    one Input; with `path`, also written there as a gzip FASTQ of
    members of the configuration's `reads_per_member` records."""
    spec, gz = config["reads"], config.get("fastq_gz", {})
    sizes = list(config["genome"]["chromosome_sizes"].values())
    sampler = ReadSampler(genome(sizes, seed), sizes, spec["read_length"],
                          phred_error_rate(spec["quality_weights"]))
    quals = quality_table(spec["quality_weights"])
    codes = np.empty((n_reads, spec["read_length"]), np.uint8)
    per_member = gz.get("reads_per_member", 1000)
    block = READS_PER_BLOCK - READS_PER_BLOCK % per_member
    n_members = -(-n_reads // per_member)
    planted = {min(n_members - 1, int(f * n_members))
               for f in gz.get("false_member_candidates", [])}

    def task(b):
        rng = rng_for(seed, stream, b)
        lo, hi = b * block, min(n_reads, (b + 1) * block)
        codes[lo:hi] = sampler.draw(hi - lo, rng)
        if path is None:
            return b""
        q = quals[rng.integers(0, quals.size, (hi - lo, codes.shape[1]),
                               dtype=np.uint16)]
        rec = fastq_records(codes[lo:hi], lo, spec["header"], q)
        width = rec.shape[1]
        parts = []
        for m in range(0, hi - lo, per_member):
            n = min(per_member, hi - lo - m)
            # a planted candidate is sought from the quality line of the
            # member's middle record on
            at = (n // 2 * width + width - spec["read_length"] - 1
                  if (lo + m) // per_member in planted else None)
            parts.append(gzip_member(rec[m: m + n].tobytes(),
                                     gz.get("level", 1), at, width))
        return b"".join(parts)

    n_blocks = -(-n_reads // block)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        parts = pool.map(task, range(n_blocks))
        if path is None:
            list(parts)
        else:
            with open(path, "wb") as f:
                for part in parts:
                    f.write(part)
                # written back now, in set-up, and not by the kernel's
                # flusher inside the window
                f.flush()
                os.fsync(f.fileno())
    return Input(codes.reshape(-1),
                 np.full(n_reads, spec["read_length"], np.int64), path)


def make_inputs(cell: dict, config: dict, seed: int, workdir: str,
                write_files: bool = True) -> list:
    """The cell's inputs, as a list of Input, by its "input" form, from
    its configuration `config`; `workdir` holds the files written."""
    form = cell["input"]["form"]
    if form == "fastq_gz":
        path = os.path.join(workdir, "reads.fq.gz") if write_files else None
        return [reads_input(config, seed, READS, config["reads"]["n_reads"],
                            path)]
    if form == "read_arrays":
        spec = config["reads"]
        return [reads_input(config, seed, ARRAYS + 16 * a,
                            spec["reads_per_array"])
                for a in range(spec["n_arrays"])]
    if form == "strains":
        sizes = list(config["genome"]["chromosome_sizes"].values())
        s = config["strains"]
        flat, lengths = strains(genome(sizes, seed), sizes, s["n_strains"],
                                s["substitution_rate"], seed)
        return [Input(flat, lengths)]
    raise ValueError(f"unknown input form {form!r}")
