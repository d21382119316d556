#!/usr/bin/env python3
"""End-to-end check of bionumpy_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full size and holds every kernel of them
against its plain PyTorch version: gzip FASTQ -> exact 31-mer (hash,
count) table, on the benchmark's headline job (2048 gzip members, ~446 M
bases, 2.048 M reads, generated from a seed), over host-packed words and
over raw bytes parsed on the card; gzip FASTQ -> exact PWM match
positions, on the motif job's shape (the first 512 members of the same
file, ~111 M bases); gzip FASTQ -> exact minimizer table over the same
file; the user-level k-mer and motif API over the motif job's reads as
one EncodedRaggedArray; bench config 3's minimizer + GC-track job over
97 M seeded bases; bench config 1 (gzip FASTQ -> per-base composition)
over the headline file; codon translation of the motif job's reads; and
the checksum and dense-count k-mer ops at one full batch; and the file
layer (bnp.open) feeding the k-mer, motif, minimizer and translation
calls chunk by chunk, with the VCF and BED readers and writers at bench
config 5's scale; and config 5's interval arithmetic (pileups, the binned
pileup of a BED file, jaccard and forbes, the stream layer) with a
reverse complement into the k-mer count; and the genomic layer: config
5's SBS96 job, genomic pileups whole and streamed, folds that stay on
the card, and the k-mer index and de Bruijn graph on kernel 1.  Phases,
each of which raises on failure:

  1. device    a CUDA card is required; prints nvidia-smi's name and
               power limit
  2. build     the host library (g++) and the two CUDA libraries (nvcc)
               from the sources in the checkout, all compilers at once;
               prints each library's build time and each kernel's
               registers, shared memory and spills (ptxas)
  3. kernels   kmer_keys_kernel, kmer_fullsum_kernel and
               pwm_scores_kernel against their plain versions at one
               full batch (2^25 positions; k=31 and k=15; w=1, 11, 17,
               32 with -inf cells), then timed with CUDA events around
               back-to-back calls (median of 15 timings; ms) and by the
               profiler (each launch's own duration; device_ms), beside
               a library call where one computes the same and beside
               the store floor (fill_ over an output of the same
               bytes); k=15 and w=32 are timed too, and
               kmer_fullsum_kernel also over one 2^22-position checksum
               chunk, beside a read floor (torch.sum over the words),
               with its bounds by bytes and by operations side by side
  4. job       count_kmers_fastq on the card, warm-up + timed run; the
               table must equal a numpy recount, and the kmer_keys
               kernel must have launched once per batch; a profiled run
               gives the device's busy time and idle share
  5. motif     get_motif_matches_fastq on the card over the first 512
               members, warm-up + timed run; the (read, offset) matches
               must equal a numpy recount, and the pwm_scores kernel
               must have launched in match mode once per batch;
               profiled as phase 4
  6. device-parse  count_kmers_fastq(device_parse=True) over the phase 4
               file: warm-up, timed and profiled runs, then one with
               "auto"; each table must equal the recount and phase 4's
               packed table, the stats the packed run's, and kmer_keys
               must have launched once per batch; prints the wall, the
               H2D bytes beside the packed run's, the device's busy time
               and idle share, the peak device memory and the transport
               "auto" kept
  7. user API  the motif job's 512,000 reads (112.5 M bases) as one
               EncodedRaggedArray: count_kmers(s, 31), count_kmers(s, 12)
               and get_kmers(s, 21), each equal to a numpy recount of
               the 16 variants times their copies, with one upload of the
               array for the three; prints each call's time, the peak
               device memory and the kernel launches
  8. checksum  kmer_checksum_streamed (the fullsum kernel) must agree
               with the table's sums; prints its wall and, from one more
               profiled run, the device time of its fullsum launches
  9. minimizers-fastq  count_minimizers_fastq(k=21, window 30) over the
               phase 4 file: warm-up, timed and profiled runs; the table
               must equal a numpy recount of the 64 variants times their
               copies, the stats the file's, and kmer_keys must have
               launched once per batch
 10. motif-encoded  get_motif_matches and get_motif_scores on phase 7's
               array: the matches must equal phase 5's, the first
               variant's scores its float32 recount, and the array must
               still count one upload
 11. minimizers-gc  config 3's job: count_minimizers_with_gc(k=21,
               window 30, cap 2^22, 1000-base bins) over 8 seeded strains
               of sacCer3's shape (136 rows, 97.3 M bases); warm-up, a
               timed run that uploads again and one with n_chunks=4,
               each profiled once more; table and bins must equal a
               numpy recount, each base must be uploaded once a run and
               kmer_keys must have launched; prints the wall, Mbases/s,
               device busy time, idle share and peak device memory
 12. composition  bench config 1 over the phase 4 file, as bench.py
               drives it: _batch_arrays (fused parse), _prefetched,
               _parse_batch, the words to the card, composition_from_packed
               accumulated there in int64; warm-up, timed and profiled
               runs; the totals must equal a numpy bincount of the
               variants times their copies; prints the wall, Mbases/s, the
               host split, busy time, idle share, peak memory and the op's
               time per batch beside its bound by bytes
 13. translate  phase 7's reads cut to whole codons, in the TCAG alphabet:
               translate_dna_to_protein on the card must equal a numpy
               recount of the codon table, row by row; then lut_gather,
               encode_with_validation (no invalid byte, then one planted)
               and composition_counts over the 112.5 M bases against numpy
 14. kmer-ops  at one full batch (2^25 positions), k = 31 and 15:
               kmer_checksum_packed (fullsum kernel), the two pipeline
               checksums (keys kernel) against each other, device="cpu"
               and numpy; kmer_hashes_masked, unique_kmer_stats and
               hash_checksum against a numpy recount; kmer_count_small
               (k = 12) against kmer_count_small_packed; each function's
               kernel launches reset before it and held to its route
 15. open-fastq  the reference's streaming idiom over phase 5's file:
               count_entries, then bnp.open(path).read_chunks() at the
               default min_chunk_size and at 2^26 bytes, each chunk's
               sequences as one DNAEncoding array through count_kmers(s,
               31) and get_motif_matches; the summed counts must equal
               phase 7's, the matches in chunk order phase 10's, each chunk
               must upload once and launch kernels 1 and 3 once; prints
               both walls, Mbases/s, chunks, the host split (read + parse,
               the device calls, the host merge of the tables), a
               profiled run's busy time and idle share, the peak device
               memory and phase 5's wall
 16. open-config3  bench config 3 from a file: phase 11's base genome as
               a gzip multi-line FASTA of sacCer3's 17 names and lengths,
               read with MultiLineFastaBuffer, change_encoding to
               ACGTnEncoding, % 4, the 7 strains, count_minimizers_with_gc;
               names and lengths as written, table and bins phase 11's
 17. open-records  a seeded 8-member sites-only VCF of 773,688 records
               read back as written with the SNVs counted; 2 M BED
               intervals written, read back equal and rewritten
               byte-identical; phase 13's reads as a FASTA translated
               chunk by chunk on the card into a .fa that reads back as
               phase 13's proteins; prints each read's and write's seconds
               and records/s
 18. intervals  bench config 5's interval arithmetic: phase 17's 2 M chr21
               fragments through get_pileup and get_pileup_device (dense,
               binned at 100 and 1000) against a numpy recount, the two
               pileup ops timed beside their bounds; 2 M more on chr22
               into a gzip BED, binned_pileup_bed at 1000 and 100; jaccard
               and forbes against 60,000 seeded peaks, == a numpy
               boolean-mask recount; the stream reductions and groupby
               over the file's chunks; get_reverse_complement of phase 7's
               reads into count_kmers(., 31), phase 7's table with every
               hash reverse-complemented, one upload and one launch
 19. genomic  bench config 5's SBS96 whole job (bt.open(vcf).read(), the
               SNP mask, Genome.get_locations, count_mutation_types_genomic
               through GenomicSequence.from_dict) over a seeded genome of
               chr21 and chr22 and an 8-member VCF of 773,688 records whose
               REFs are its bases, three timed runs and a split, the
               96-vector == bench.py's numpy twin label by label; phase
               18's BED through Genome.read_intervals, whole and streamed,
               get_pileup event for event equal to each other, to
               arithmetics.get_pileup and to a numpy recount;
               Geometry.jaccard == phase 18's; the 60,000 peaks' sequences
               == numpy slicing; one streamed pass with SUM (binned_pileup
               at 100 of the chr21 records), BINCOUNT and MAX folds of
               partials made on the card, each a CUDA tensor equal to
               binned_pileup_bed's bins or numpy; KmerLookup (k = 31) over
               256,000 of phase 7's reads with 100 string queries, each
               query's rows == a numpy recount, kernel 1 launched once for
               the index and once a query; DeBruijnGraph over 1000 reads,
               its contigs equal to the device="cpu" graph's
 20. mesh     the four pipelines' mesh= paths on a mesh of the card and
               on 4 shards of it (one device repeated): count_kmers_fastq
               over phase 4's file (phase 4's table, kernel 1 once a
               shard a batch) and again at a shard cap that overflows
               (the rerun logged, the same table), count_minimizers_fastq
               (phase 9's table), get_motif_matches_fastq over phase 5's
               file (phase 5's matches, kernel 3 in match mode once a
               shard a batch),
               binned_pileup_bed over phase 18's BED (the single-device
               bins); the histogram, sum-and-n and pileup steps over
               phase 18's chr21 fragments and the halo k-mer and
               minimizer steps over a seeded chr21, 4 shards against 1;
               scaling.measure on 1-8 shards; each job's wall beside the
               single-device wall of the same call
 21. simulate  simulate_chip_seq_reads over the seeded chr21 with a w = 11
               motif (kernel 3 over the whole chromosome), the reads equal
               under one seed to those with device="cpu" scores; then
               simulate_sequences -> get_reverse_complement ->
               count_kmers on the card against the CPU
 22. table-passes  a table's passes over two resident blocks of ~0.56 G
               seeded bases each: kernel 1 over every pass's words (a
               slice from the word of the pass's first base, a first row
               end inside that word) against its plain version on the
               same words and ends (k=31 and k=15, two passes) and, at
               k=31, against the whole block's keys at the pass's
               positions; then blocked_table of the minimizers (k=15,
               24-base windows) over both blocks: one kmer_keys launch a
               pass, every window counted once, the keys strictly rising;
               prints the passes, their offsets, the folds and the peak
               device memory

Each phase prints its seconds ("[phase] ...").

It prints a {"torch_ops": [...]} line (the ops the JAX package runs as
XLA, timed beside their bounds), a {"kernels": [...]} line, nvidia-smi's
line, and last
{"ok": true, "device": {...}}.  Without a card it exits non-zero and
prints no result.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

K = 31
MOTIF_WINDOW = 11
MOTIF_MEMBERS = 512           # the motif job: 16 variants x 32 copies
MOTIF_PERCENTILE = 99.75      # threshold keeps ~0.25% of windows
BATCH_POSITIONS = 1 << 25     # one full device batch
N_VARIANTS, COPIES, N_READS = 64, 32, 1000
MUTATION_RATE = 0.01
SEED = 7
TIMING_RUNS = 15
LOOP_MS = 5.0                 # CUDA-event timing: calls enough to fill this
MAX_LOOP_CALLS = 200
MEM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
# peak rate of the integer ALU work: the data sheet lists none, so the
# 67 TFLOP/s non-tensor float32 peak stands in for 32-bit integer ops
INT_OPS_PER_S = 67e12
SENTINEL = (1 << 63) - 1
# config 3: sacCer3's 17 chromosome lengths (UCSC sacCer3.chrom.sizes, in
# chrI..chrXVI, chrM order), seeded bases, 7 strain copies with 0.1%
# substitutions as bench.py makes them; k = 21, 10 k-mers per window
SACCER3_NAMES = tuple(f"chr{r}" for r in (
    "I", "II", "III", "IV", "V", "VI", "VII", "VIII", "IX", "X", "XI", "XII",
    "XIII", "XIV", "XV", "XVI", "M"))
SACCER3_SIZES = (230218, 813184, 316620, 1531933, 576874, 270161, 1090940,
                 562643, 439888, 745751, 666816, 1078177, 924431, 784333,
                 1091291, 948066, 85779)
N_STRAINS = 8
MIN_K, MIN_WINDOW, GC_BIN = 21, 30, 1000


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ---- inputs ---------------------------------------------------------------

def batch_inputs(seed: int):
    """One full batch: seeded random codes in reads of 150-286 bases
    (mean ~218), packed as the pipeline packs them, with the row ends
    padded to a power-of-two bucket as _parse_batch pads them.  Returns
    (words, ends, n, codes, lengths)."""
    from bionumpy_tpu_torch.ops.device import bucket_size
    from bionumpy_tpu_torch.ops.kmers import prepare_packed
    rng = np.random.default_rng(seed)
    lengths = rng.integers(150, 287, BATCH_POSITIONS // 200)
    lengths = lengths[np.cumsum(lengths) <= BATCH_POSITIONS - (1 << 21)]
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    words, ends, n = prepare_packed(codes, lengths, min_bucket=1 << 14)
    rows = bucket_size(len(ends), 4096)
    ends = np.concatenate([ends, np.full(rows - len(ends), ends[-1],
                                         np.int32)])
    return words, ends, n, codes, lengths


def make_job(path: str, n_variants: int, copies: int, n_reads: int,
             seed: int):
    """The headline job's file: one base member of `n_reads` reads,
    `n_variants` variants of it with 1% seeded substitutions, each
    written `copies` times in a row, gzip level 6.  Returns the
    variants' (codes, lengths)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(150, 287, n_reads)
    base = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    alpha = np.frombuffer(b"ACGT", np.uint8)
    variants = []
    with open(path, "wb") as f:
        for v in range(n_variants):
            vrng = np.random.default_rng(1000 + v)
            codes = base.copy()
            pos = np.flatnonzero(vrng.random(len(codes)) < MUTATION_RATE)
            codes[pos] = (codes[pos] + vrng.integers(1, 4, len(pos))) % 4
            seq = alpha[codes].tobytes()
            raw = b"".join(
                b"@v%d.%d\n%s\n+\n%s\n" % (v, i, seq[s:e], b"I" * (e - s))
                for i, (s, e) in enumerate(zip(starts, ends)))
            member = gzip.compress(raw, compresslevel=6, mtime=0)
            for _ in range(copies):
                f.write(member)
            variants.append(codes)
    return variants, lengths


def variant_hashes(codes, lengths, k: int) -> np.ndarray:
    """uint64 hashes of the windows of one variant's reads that lie
    inside their read, in position order (numpy recount)."""
    h = numpy_kmer_hashes(codes, k)
    ends = np.cumsum(lengths)
    dist = np.repeat(ends, lengths) - np.arange(len(codes))
    return h[dist[: len(h)] >= k]


def expected_table(variants, lengths, copies: int, k: int):
    """Exact (hashes uint64, counts int64) of the job by a numpy recount
    of each distinct variant, times its copies."""
    uniq, counts = np.unique(np.concatenate(
        [variant_hashes(codes, lengths, k) for codes in variants]),
        return_counts=True)
    return uniq, counts.astype(np.int64) * copies


def numpy_kmer_hashes(flat: np.ndarray, k: int) -> np.ndarray:
    """uint64 hash sum(code_j << 2j) of the k-mer at every start 0..n-k,
    composed from hashes of power-of-two lengths (one shift-or pass per
    doubling and per set bit of k, not k passes)."""
    powers = {1: flat.astype(np.uint64)}
    p = 1
    while 2 * p <= k:
        h = powers[p]
        powers[2 * p] = h[:-p] | (h[p:] << np.uint64(2 * p))
        p *= 2
    n = len(flat) - k + 1
    out, offset = None, 0
    for p in sorted(powers, reverse=True):
        if k - offset >= p:
            part = powers[p][offset: offset + n] << np.uint64(2 * offset)
            out = part if out is None else out | part
            offset += p
    return out


def numpy_minimizer_windows(flat, lengths, k: int, window: int):
    """uint64 minimizer of every window of `window` bases that fits its
    row, in position order: the least k-mer hash over the window's
    window - k + 1 k-mers (bench.numpy_minimizer_job's semantics, with a
    doubling min in place of its per-row loop)."""
    m = numpy_kmer_hashes(flat, k)
    span, n_kmers = 1, window - k + 1
    while span < n_kmers:
        step = min(span, n_kmers - span)
        m = np.minimum(m[:-step], m[step:])
        span += step
    ends = np.cumsum(lengths)
    dist = np.repeat(ends, lengths) - np.arange(len(flat))
    return m[dist[: len(m)] >= window]


def numpy_minimizer_table(flat, lengths, k: int, window: int):
    """Exact (hashes uint64, counts int64) of the minimizers: the windows'
    values cut into runs of equal neighbours (a minimizer holds for
    ~window/2 windows), then the runs' values counted by their lengths."""
    v = numpy_minimizer_windows(flat, lengths, k, window)
    heads = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))
    run_len = np.diff(np.append(heads, len(v)))
    uniq, inverse = np.unique(v[heads], return_inverse=True)
    counts = np.bincount(inverse, weights=run_len, minlength=len(uniq))
    return uniq, counts.astype(np.int64)


def base_genome(seed: int) -> np.ndarray:
    """Config 3's base genome: seeded codes of sacCer3's total length."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, sum(SACCER3_SIZES)).astype(np.uint8)


def strain_genome(seed: int):
    """Config 3's input: a seeded base genome of sacCer3's chromosome
    lengths and N_STRAINS - 1 copies of it with 0.1% seeded
    substitutions (bench.py's strains), as (flat codes, row lengths)."""
    return strains_of(base_genome(seed), np.array(SACCER3_SIZES, np.int64))


def strains_of(base: np.ndarray, base_lengths: np.ndarray):
    """`base` and N_STRAINS - 1 copies of it with 0.1% seeded
    substitutions, as bench.py's config3 makes them: (flat codes, row
    lengths)."""
    strains = [base]
    for v in range(1, N_STRAINS):
        vrng = np.random.default_rng(2000 + v)
        mut = base.copy()
        pos = np.flatnonzero(vrng.random(len(mut)) < 0.001)
        mut[pos] = (mut[pos] + vrng.integers(1, 4, len(pos))) % 4
        strains.append(mut)
    return np.concatenate(strains), np.tile(base_lengths, N_STRAINS)


# ---- timing ---------------------------------------------------------------

def events_ms(fn, calls: int) -> float:
    """ms by CUDA events around `calls` back-to-back calls of fn."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    """The time of one call of fn in ms: the median of `runs` timings by
    CUDA events, each around enough back-to-back calls to fill about
    LOOP_MS (at most MAX_LOOP_CALLS), divided by their count.  Warm:
    inputs that fit the 50 MB L2 stay there between calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    one = max(events_ms(fn, 1), 1e-3)
    calls = int(min(MAX_LOOP_CALLS, max(1, LOOP_MS // one)))
    return float(np.median([events_ms(fn, calls) / calls
                            for _ in range(runs)]))


def kernel_device_ms(fn, kernel: str, runs: int = TIMING_RUNS) -> float:
    """Mean device time in ms of one launch of `kernel` over `runs` calls
    of fn under the CUDA profiler: the kernel's own duration, without the
    host's launch gaps that CUDA events around a call of a few
    microseconds also hold.  The mean is over the launches the profiler
    recorded, which may miss one at the window's edge.  A window in which
    the profiler recorded none of them (seen once with torch 2.11) is
    taken again, up to three windows."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        for e in prof.key_averages():
            if re.search(rf"\b{kernel}\b", e.key):
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
                n += e.count
        if 0 < n <= runs and us:
            return us / n / 1e3
    raise AssertionError(f"the profiler saw {n} launches of {kernel} in "
                         f"{runs} calls, three windows running")


def pwm_matrix(seed: int, window: int):
    """JASPAR-style PWM of seeded integer counts 0-30 (the port's PWM),
    with zero counts and so -inf cells."""
    from bionumpy_tpu_torch import PWM
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 31, (4, window))
    counts[rng.integers(0, 4, 2), rng.integers(0, window, 2)] = 0
    return PWM.from_dict(dict(zip("ACGT", counts.tolist())))


def numpy_pwm_windows(codes, lengths, matrix32):
    """float32 score of every window of the reads, added in the order
    j = 0..w-1 as the kernel adds them, and whether the window lies
    inside its read."""
    w = matrix32.shape[1]
    s = np.zeros(len(codes), np.float32)
    for j in range(w):
        s[: len(codes) - j] += matrix32[codes[j:], j]
    ends = np.cumsum(lengths)
    return s, np.repeat(ends, lengths) - np.arange(len(codes)) >= w


def numpy_pwm_matches(codes, lengths, matrix32, threshold):
    """(rows, offsets) of the windows inside their read scoring above
    `threshold`."""
    s, inside = numpy_pwm_windows(codes, lengths, matrix32)
    hits = np.flatnonzero((s > threshold) & inside)
    ends = np.cumsum(lengths)
    rows = np.searchsorted(ends, hits, side="right")
    return rows, hits - np.concatenate([[0], ends])[rows]


def bound(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---- phases ---------------------------------------------------------------

def ptxas_report(text: str) -> str:
    """Registers, shared memory and spills of each kernel in nvcc's
    -Xptxas -v output, one short entry per kernel (the template
    instance pwm_scores_kernel<W> with its W)."""
    entries = []
    for block in text.split("Compiling entry function")[1:]:
        name = re.match(r" '\S*?([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", block)
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if not (name and regs and spill):
            continue
        w = f"<{name.group(2)}>" if name.group(2) else ""
        entries.append(f"{name.group(1)}{w} {regs.group(1)} regs "
                       f"{smem.group(1) if smem else 0} B smem spill "
                       f"{spill.group(1)}/{spill.group(2)} B")
    return "; ".join(entries)


def phase_build():
    from bionumpy_tpu_torch import native
    from bionumpy_tpu_torch.ops import _build, kmer_kernels
    from bionumpy_tpu_torch.ops import pwm_kernels

    def timed(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        host = pool.submit(native._load)
        cuda = {"kmers": pool.submit(timed, kmer_kernels.build),
                "pwm": pool.submit(timed, pwm_kernels.build)}
        if host.result() is None:
            raise RuntimeError("the host library did not build")
        seconds = {name: lib.result() for name, lib in cuda.items()}
    log(f"[build] host + 2 CUDA libraries in "
        f"{time.perf_counter() - t0:.1f} s (nvcc kmers "
        f"{seconds['kmers']:.1f} s, pwm {seconds['pwm']:.1f} s)")
    for name in ("kmers", "pwm"):
        log(f"[build] ptxas {name}: "
            f"{ptxas_report(_build.LOGS.get(name, '')) or 'library current'}")


def phase_kernels(dev):
    """Each kernel against its plain version at one full batch, then
    timed.  Returns the rows of the kernels line (launches added by the
    path phases)."""
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    words_np, ends_np, n, _, _ = batch_inputs(SEED)
    words = torch.from_numpy(words_np.view(np.int32)).to(dev)
    ends = torch.from_numpy(ends_np).to(dev)
    n_pos = (words.numel() - 2) * kk.WORD_BASES
    assert n_pos == BATCH_POSITIONS, n_pos
    errs = {"kmer_keys_kernel": 0.0, "kmer_fullsum_kernel": 0.0}
    for k in (K, 15):
        got = kk.kmer_keys(words, ends, k, n)
        ref = kk.kmer_keys_plain(words, ends, k, n)
        n_bad = int((got != ref).sum())
        errs["kmer_keys_kernel"] = max(errs["kmer_keys_kernel"], float(
            (got - ref).abs().max()) if n_bad else 0.0)
        if n_bad:
            raise AssertionError(f"kmer_keys_kernel differs from its plain "
                                 f"version at {n_bad} positions (k={k})")
        n_valid = int((got != SENTINEL).sum())
        s_got = kk.kmer_fullsum(words, k).tolist()
        s_ref = kk.kmer_fullsum_plain(words, k).tolist()
        errs["kmer_fullsum_kernel"] = max(
            errs["kmer_fullsum_kernel"],
            float(max(abs(a - b) for a, b in zip(s_got, s_ref))))
        if s_got != s_ref:
            raise AssertionError(f"kmer_fullsum_kernel {s_got} != plain "
                                 f"{s_ref} (k={k})")
        log(f"[kernels] k={k}: keys equal (tolerance: exact) at {n_pos} "
            f"positions ({n_valid} valid), fullsums equal {s_got}")

    lib = kk.build()
    stream = torch.cuda.current_stream().cuda_stream
    keys = torch.empty(n_pos, dtype=torch.int64, device=dev)
    sums = torch.zeros(2, dtype=torch.int32, device=dev)

    def keys_kernel(k=K):
        lib.kmer_keys_launch(words.data_ptr(), ends.data_ptr(),
                             ends.numel(), n_pos, n, k, keys.data_ptr(),
                             stream)

    def sum_kernel(k=K, n_words=words.numel()):
        lib.kmer_fullsum_launch(words.data_ptr(),
                                (n_words - 2) * kk.WORD_BASES, k,
                                sums.data_ptr(), stream)

    word_bytes = words.numel() * 4
    keys_bytes = word_bytes + ends.numel() * 4 + n_pos * 8
    # ~12 integer ops a position: the window from three words (shifts,
    # or, mask) and one compare with its row end
    keys_bound, keys_by = bound(keys_bytes, n_pos * 12)
    k15_ms = median_ms(lambda: keys_kernel(15))
    log(f"[kernels] kmer_keys_kernel k=15: {k15_ms:.4f} ms (bound "
        f"{keys_bound:.4f} ms by {keys_by})")
    sum_row = fullsum_times(words, sum_kernel)
    rows = []
    for name, line, kernel, plain, n_bytes, floor in (
            ("kmer_keys_kernel", 32, keys_kernel,
             lambda: kk.kmer_keys_plain(words, ends, K, n), keys_bytes,
             # the store floor: fill_ over an output of the keys' bytes
             lambda: keys.fill_(SENTINEL)),
            ("kmer_fullsum_kernel", 63, sum_kernel,
             lambda: kk.kmer_fullsum_plain(words, K), word_bytes + 8,
             None)):
        ms, plain_ms = median_ms(kernel), median_ms(plain)
        floor_ms = median_ms(floor) if floor else None
        bound_ms, bound_by = bound(n_bytes, n_pos * 12)
        row = {
            "name": name, "route": "cuda",
            "source": "bionumpy_tpu_torch/csrc/kmers.cu",
            "replaces": f"bionumpy_tpu/ops/pallas_kmers.py:{line}",
            "tpu_kernel": "_kmer_block_kernel" if line == 32
            else "_fullsum_kernel",
            "launches": None, "max_abs_err": errs[name],
            "ms": ms, "kernel_ms": ms,
            "device_ms": kernel_device_ms(kernel, name),
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "store_floor_ms": floor_ms,
            "positions": n_pos}
        if name == "kmer_fullsum_kernel":
            row.update(sum_row)
        rows.append(row)
        log(f"[kernels] {name}: {row['ms']:.5f} ms (device "
            f"{row['device_ms']:.5f} ms, plain {plain_ms:.3f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}"
            + (f", store floor {floor_ms:.4f} ms)" if floor else ")"))
    rows.append(pwm_kernel_row(dev, words))
    return rows


def fullsum_times(words, sum_kernel) -> dict:
    """kmer_fullsum_kernel at k=15 over the full batch and at k=31 over
    one checksum chunk (2^22 positions), by CUDA events and by the
    profiler, beside a read floor (torch.sum over the same words); its
    bounds by bytes and by operations side by side.  Returns the kernel
    row's extra keys."""
    n_pos = (words.numel() - 2) * 16
    chunk_words = (1 << 22) // 16 + 2
    name = "kmer_fullsum_kernel"
    k15, chunk = (lambda: sum_kernel(15),
                  lambda: sum_kernel(n_words=chunk_words))
    times = {
        "ms_k15": median_ms(k15),
        "device_ms_k15": kernel_device_ms(k15, name),
        "ms_chunk": median_ms(chunk),
        "device_ms_chunk": kernel_device_ms(chunk, name),
        "read_floor_ms": median_ms(lambda: words.sum()),
    }
    n_bytes = words.numel() * 4 + 8
    bytes_ms = n_bytes / MEM_BYTES_PER_S * 1e3
    # the closed form: per word two popcounts, a mask and two adds
    ops_ms = n_pos // 16 * 5 / INT_OPS_PER_S * 1e3
    # summing window by window: ~12 integer ops a position
    window_ops_ms = n_pos * 12 / INT_OPS_PER_S * 1e3
    chunk_bytes_ms = chunk_words * 4 / MEM_BYTES_PER_S * 1e3
    log(f"[kernels] kmer_fullsum_kernel k=15: {times['ms_k15']:.5f} ms "
        f"(device {times['device_ms_k15']:.5f} ms); 2^22 positions: "
        f"{times['ms_chunk']:.5f} ms (device {times['device_ms_chunk']:.5f} "
        f"ms, bound {chunk_bytes_ms:.5f} ms by bytes); read floor "
        f"(torch.sum) {times['read_floor_ms']:.5f} ms.  Bounds: bytes "
        f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms (window by window "
        f"{window_ops_ms:.5f} ms)")
    return {**times, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "window_ops_bound_ms": window_ops_ms,
            "chunk_bound_ms": chunk_bytes_ms}


def pwm_kernel_row(dev, words):
    """pwm_scores_kernel against its plain version, bit for bit, at one
    full batch for w = 1, 11, 17, 32 with -inf cells; then timed at w =
    11 beside the plain version and conv1d over a one-hot encoding (the
    library yardstick, on a finite matrix: one-hot x -inf gives NaN)."""
    import torch.nn.functional as F
    from bionumpy_tpu_torch.ops import pwm_kernels as pk
    n_pos = (words.numel() - 2) * pk.WORD_BASES
    for w in (1, MOTIF_WINDOW, 17, 32):
        matrix = torch.from_numpy(np.ascontiguousarray(
            pwm_matrix(SEED + w, w).matrix, np.float32)).to(dev)
        got = pk.pwm_scores(words, matrix, w)
        ref = pk.pwm_scores_plain(words, matrix, w)
        if not torch.equal(got, ref):
            finite = torch.isfinite(ref)
            n_bad = int((got != ref).sum())
            err = float((got[finite] - ref[finite]).abs().max())
            raise AssertionError(f"pwm_scores_kernel differs from its plain "
                                 f"version at {n_bad} positions (w={w}, "
                                 f"max abs err {err})")
        log(f"[kernels] w={w}: pwm scores equal bit for bit (tolerance: "
            f"exact) at {n_pos} positions "
            f"({int(torch.isneginf(ref).sum())} -inf)")

    lib = pk.build()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(n_pos, dtype=torch.float32, device=dev)

    def pwm_bound(w):
        # bytes: the words and the matrix read once, the scores written
        # once; operations: ~10 integer ops for the window from three
        # words, then per offset a shift, a mask, an index, a load and a
        # float add
        return bound(words.numel() * 4 + 16 * w + n_pos * 4,
                     n_pos * (10 + 5 * w))

    def launcher(w):
        matrix = torch.from_numpy(np.ascontiguousarray(
            pwm_matrix(SEED + w, w).matrix, np.float32)).to(dev)
        return matrix, lambda: lib.pwm_scores_launch(
            words.data_ptr(), n_pos, matrix.data_ptr(), w, out.data_ptr(),
            stream)

    w32_ms = median_ms(launcher(32)[1])
    w32_bound, w32_by = pwm_bound(32)
    log(f"[kernels] pwm_scores_kernel w=32: {w32_ms:.4f} ms (bound "
        f"{w32_bound:.4f} ms by {w32_by})")
    w = MOTIF_WINDOW
    matrix, kernel = launcher(w)
    codes = pk.unpack_codes(words)[: n_pos + w - 1]
    onehot = F.one_hot(codes, 4).T.to(torch.float32).contiguous()[None]
    finite = torch.from_numpy(np.random.default_rng(SEED).normal(
        0, 1, (1, 4, w)).astype(np.float32)).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # full float32, as the kernel
    try:
        library_ms = median_ms(lambda: F.conv1d(onehot, finite))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del onehot, codes
    ms = median_ms(kernel)
    device_ms = kernel_device_ms(kernel, "pwm_scores_kernel")
    plain_ms = median_ms(lambda: pk.pwm_scores_plain(words, matrix, w))
    # the store floor: fill_ over an output of the scores' bytes
    floor_ms = median_ms(lambda: out.fill_(0.0))
    bound_ms, bound_by = pwm_bound(w)
    log(f"[kernels] pwm_scores_kernel w={w}: {ms:.4f} ms (device "
        f"{device_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, conv1d {library_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}, store floor {floor_ms:.4f} ms)")
    return {"name": "pwm_scores_kernel", "route": "cuda",
            "source": "bionumpy_tpu_torch/csrc/pwm.cu",
            "replaces": "bionumpy_tpu/ops/pallas_pwm.py:32",
            "tpu_kernel": "_pwm_block_kernel",
            "launches": None, "max_abs_err": 0.0,
            "ms": ms, "kernel_ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library": "conv1d one-hot",
            "store_floor_ms": floor_ms, "positions": n_pos, "window": w}


def phase_job(dev, workdir: str):
    """The headline job on the card; returns its kernel launches, its
    table and the variants (for the checksum)."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    path = os.path.join(workdir, "job.fq.gz")
    t0 = time.perf_counter()
    variants, lengths = make_job(path, N_VARIANTS, COPIES, N_READS, SEED)
    exp_h, exp_c = expected_table(variants, lengths, COPIES, K)
    log(f"[job] input {os.path.getsize(path) / 1e6:.1f} MB gzip, "
        f"{len(exp_h)} distinct {K}-mers, made in "
        f"{time.perf_counter() - t0:.1f} s")

    def run():
        return bt.count_kmers_fastq(path, K, cap=1 << 21,
                                    device_parse=False, device=dev)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    log(f"[job] warm-up run {time.perf_counter() - t0:.2f} s")
    bt.instrument.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    kk.reset_launches()
    t0 = time.perf_counter()
    counts, stats = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kk.LAUNCHES)
    n_batches = bt.instrument.report()["dispatch"]["calls"]
    if not (np.array_equal(counts.label_codes, exp_h)
            and np.array_equal(counts.counts, exp_c)):
        raise AssertionError("the job's table differs from the recount")
    if stats["n_kmers"] != int(exp_c.sum()) or \
            stats["n_reads"] != N_VARIANTS * COPIES * N_READS:
        raise AssertionError(f"stats {stats} disagree with the recount")
    if launches["kmer_keys_kernel"] < n_batches:
        raise AssertionError(f"kmer_keys_kernel launched "
                             f"{launches['kmer_keys_kernel']} times for "
                             f"{n_batches} batches")
    log(f"[job] exact: {stats['n_reads']} reads, {stats['n_bases']} bases, "
        f"{stats['n_kmers']} k-mers, {len(exp_h)} distinct, "
        f"{n_batches} batches")
    log("[job] " + json.dumps({
        "wall_s": wall, "mkmers_per_s": stats["n_kmers"] / wall / 1e6,
        "n_batches": n_batches, "launches": launches,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "gpu": gpu_line()}))
    log(f"[job] split: {bt.instrument.summary(total=wall)}")
    log("[job] stages: " + json.dumps(bt.instrument.report()))
    stages = bt.instrument.report()
    profile_job(run, "job")
    return launches, counts, stats, stages, variants, lengths


def phase_motif(dev, workdir: str, variants, lengths):
    """The motif job on the card: the first MOTIF_MEMBERS members of the
    headline job's file (cut with the port's member_offsets), a seeded
    JASPAR-style PWM, and a threshold that keeps ~0.25% of windows.
    Returns its kernel launches."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.io.pgzip import member_offsets
    from bionumpy_tpu_torch.ops import pwm_kernels as pk
    with open(os.path.join(workdir, "job.fq.gz"), "rb") as f:
        data = f.read()
    offsets = member_offsets(data)
    if len(offsets) != N_VARIANTS * COPIES:
        raise AssertionError(f"member_offsets found {len(offsets)} member "
                             f"starts, the file has {N_VARIANTS * COPIES}")
    path = os.path.join(workdir, "motif.fq.gz")
    with open(path, "wb") as f:
        f.write(data[: int(offsets[MOTIF_MEMBERS])])
    del data
    pwm = pwm_matrix(SEED, MOTIF_WINDOW)
    matrix32 = pwm.matrix.astype(np.float32)
    scores, inside = numpy_pwm_windows(variants[0], lengths, matrix32)
    threshold = np.float32(np.percentile(scores[inside], MOTIF_PERCENTILE))
    # the recount: each distinct variant once, expanded to its copies
    n_var = MOTIF_MEMBERS // COPIES
    exp_rows, exp_offs = [], []
    for v in range(n_var):
        rows, offs = numpy_pwm_matches(variants[v], lengths, matrix32,
                                       threshold)
        for c in range(COPIES):
            exp_rows.append((v * COPIES + c) * N_READS + rows)
            exp_offs.append(offs)
    exp_rows, exp_offs = np.concatenate(exp_rows), np.concatenate(exp_offs)
    order = np.lexsort((exp_offs, exp_rows))
    exp_rows, exp_offs = exp_rows[order], exp_offs[order]
    log(f"[motif] input {len(offsets[:MOTIF_MEMBERS])} members, "
        f"{os.path.getsize(path) / 1e6:.1f} MB gzip; w={MOTIF_WINDOW}, "
        f"threshold {float(threshold)!r} "
        f"({int(np.isneginf(matrix32).sum())} -inf cells), "
        f"{len(exp_rows)} expected matches")

    def run():
        return bt.get_motif_matches_fastq(path, pwm, threshold, device=dev)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    log(f"[motif] warm-up run {time.perf_counter() - t0:.2f} s")
    bt.instrument.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    pk.reset_launches()
    t0 = time.perf_counter()
    rows, offs, stats = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    n_batches = bt.instrument.report()["dispatch"]["calls"]
    if not (np.array_equal(rows, exp_rows)
            and np.array_equal(offs, exp_offs)):
        raise AssertionError("the motif job's matches differ from the "
                             "recount")
    if stats["n_matches"] != len(exp_rows) or \
            stats["n_reads"] != MOTIF_MEMBERS * N_READS or \
            stats["n_bases"] != MOTIF_MEMBERS * int(lengths.sum()):
        raise AssertionError(f"stats {stats} disagree with the recount")
    if launches["pwm_scores_kernel.match"] < n_batches:
        raise AssertionError(f"pwm_scores_kernel launched "
                             f"{launches['pwm_scores_kernel.match']} times "
                             f"in match mode for {n_batches} batches")
    log(f"[motif] exact: {stats['n_reads']} reads, {stats['n_bases']} "
        f"bases, {stats['n_matches']} matches, {n_batches} batches")
    log("[motif] " + json.dumps({
        "wall_s": wall, "mbases_per_s": stats["n_bases"] / wall / 1e6,
        "n_matches": stats["n_matches"], "n_batches": n_batches,
        "launches": launches,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "gpu": gpu_line()}))
    log(f"[motif] split: {bt.instrument.summary(total=wall)}")
    log("[motif] stages: " + json.dumps(bt.instrument.report()))
    profile_job(run, "motif")
    return launches, (pwm, threshold, rows, offs), wall


def device_times(run):
    """One run under the CUDA profiler: its wall time in us and the device
    time in us of each kernel or copy by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us
    return wall_us, by_name


def profile_job(run, tag: str) -> dict:
    """One more run of the job under the CUDA profiler: the device's busy
    time (the sum of kernel and copy times on the card, one stream)
    against the run's wall time, and the kernels that take it.  Returns
    what it prints (empty when the profiler saw no device time)."""
    wall_us, by_name = device_times(run)
    busy_us = sum(by_name.values())
    if not busy_us:
        log(f"[profile {tag}] the profiler saw no device time: not "
            f"measured")
        return {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ours = ("kmer_keys_kernel", "kmer_fullsum_kernel", "pwm_scores_kernel")
    out = {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / wall_us,
        "top_ms": {name[:80]: us / 1e3 for name, us in top},
        "port_kernels_ms": {kernel: sum(
            us for name, us in by_name.items() if kernel in name) / 1e3
            for kernel in ours}}
    log(f"[profile {tag}] " + json.dumps(out))
    return out


def phase_device_parse(dev, workdir: str, packed, packed_stats,
                       packed_stages):
    """The headline job over the device-parse transport: raw inflated
    bytes to the card, scanned, encoded and packed there (ops/parse.py),
    then counted as in phase 4.  Returns the kmer_keys launches of the
    timed run and of the "auto" run."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    path = os.path.join(workdir, "job.fq.gz")

    def run(mode=True):
        return bt.count_kmers_fastq(path, K, cap=1 << 21, device_parse=mode,
                                    device=dev)

    def check(counts, stats, tag):
        if not (np.array_equal(counts.label_codes, packed.label_codes)
                and np.array_equal(counts.counts, packed.counts)):
            raise AssertionError(f"the {tag} table differs from the "
                                 f"recount and the packed table")
        if stats != packed_stats:
            raise AssertionError(f"{tag} stats {stats} != the recount's "
                                 f"{packed_stats}")

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    log(f"[device-parse] warm-up run {time.perf_counter() - t0:.2f} s")
    bt.instrument.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    kk.reset_launches()
    t0 = time.perf_counter()
    counts, stats = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kk.LAUNCHES)
    stages = bt.instrument.report()
    n_batches = stages["dispatch"]["calls"]
    check(counts, stats, "device-parse")
    if stages.get("pad", {}).get("calls") != n_batches:
        raise AssertionError("a batch took the packed transport")
    if launches["kmer_keys_kernel"] < n_batches:
        raise AssertionError(f"kmer_keys_kernel launched "
                             f"{launches['kmer_keys_kernel']} times for "
                             f"{n_batches} batches")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[device-parse] exact: equal to the recount and the packed table; "
        f"{n_batches} batches")
    log(f"[device-parse] split: {bt.instrument.summary(total=wall)}")
    log("[device-parse] stages: " + json.dumps(stages))
    prof = profile_job(run, "device-parse")

    bt.instrument.reset()
    kk.reset_launches()
    t0 = time.perf_counter()
    counts, stats = run("auto")
    torch.cuda.synchronize()
    auto_wall = time.perf_counter() - t0
    auto_launches = dict(kk.LAUNCHES)
    auto_stages = bt.instrument.report()
    check(counts, stats, "auto")
    raw_batches = auto_stages.get("pad", {}).get("calls", 0)
    kept = "device" if raw_batches > 1 else "packed"
    log("[device-parse] " + json.dumps({
        "wall_s": wall, "mkmers_per_s": stats["n_kmers"] / wall / 1e6,
        "n_batches": n_batches, "launches": launches,
        "h2d_bytes": stages["H2D"]["bytes"],
        "h2d_bytes_packed": packed_stages["H2D"]["bytes"],
        "device_busy_ms": prof.get("device_busy_ms"),
        "device_idle_share": prof.get("device_idle_share"),
        "peak_device_bytes": peak,
        "auto": {"wall_s": auto_wall, "kept": kept,
                 "raw_batches": raw_batches,
                 "n_batches": auto_stages["dispatch"]["calls"],
                 "launches": auto_launches},
        "gpu": gpu_line()}))
    return launches, auto_launches


def phase_user_api(dev, variants, lengths):
    """The user-level k-mer API over the motif job's reads (16 variants x
    32 copies x 1000 reads) held as ONE EncodedRaggedArray: every call
    must equal a numpy recount, and the three calls must upload the
    array once.  Returns the kmer_keys launches of the three calls."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import resident
    n_var = MOTIF_MEMBERS // COPIES
    flat = np.concatenate([variants[v] for v in range(n_var)
                           for _ in range(COPIES)])
    all_lengths = np.tile(lengths, MOTIF_MEMBERS)
    seqs = bt.EncodedRaggedArray(bt.EncodedArray(flat, bt.DNAEncoding),
                                 all_lengths)
    del flat
    log(f"[user-api] {len(seqs)} reads, {int(all_lengths.sum())} bases in "
        f"one EncodedRaggedArray")
    torch.cuda.synchronize()
    resident.reset_transfer_counters()
    kk.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    c31 = timed("count_kmers_31", lambda: bt.count_kmers(seqs, 31,
                                                         device=dev))
    c12 = timed("count_kmers_12", lambda: bt.count_kmers(seqs, 12,
                                                         device=dev))
    g21 = timed("get_kmers_21", lambda: bt.get_kmers(seqs, 21, device=dev))
    launches = dict(kk.LAUNCHES)
    uploads = resident.TRANSFER_COUNT
    peak = torch.cuda.max_memory_allocated(dev)

    own = variants[:n_var]
    exp_h, exp_c = expected_table(own, lengths, COPIES, 31)
    if not (np.array_equal(c31.label_codes, exp_h)
            and np.array_equal(c31.counts, exp_c)):
        raise AssertionError("count_kmers(s, 31) differs from the recount")
    dense = np.zeros(4 ** 12, np.int64)
    for codes in own:
        dense += np.bincount(variant_hashes(codes, lengths, 12).astype(
            np.int64), minlength=4 ** 12) * COPIES
    if not (np.array_equal(c12.counts, dense) and len(c12.alphabet) ==
            4 ** 12 and c12.counts.dtype == np.int64):
        raise AssertionError("count_kmers(s, 12) differs from the recount")
    per_variant = [variant_hashes(codes, lengths, 21).view(np.int64)
                   for codes in own]
    want = np.concatenate([per_variant[v] for v in range(n_var)
                           for _ in range(COPIES)])
    if not (np.array_equal(g21.ravel().raw(), want) and np.array_equal(
            g21.lengths, np.maximum(all_lengths - 20, 0))):
        raise AssertionError("get_kmers(s, 21) differs from the recount")
    if uploads != 1:
        raise AssertionError(f"{uploads} uploads for the three calls")
    if launches["kmer_keys_kernel"] < 3:
        raise AssertionError(f"kmer_keys_kernel launched "
                             f"{launches['kmer_keys_kernel']} times in 3 "
                             f"calls")
    log(f"[user-api] exact: {len(c31.label_codes)} distinct 31-mers, "
        f"{int(c12.counts.sum())} 12-mers, {len(want)} 21-mer windows; "
        f"{uploads} upload of {resident.TRANSFER_BYTES} bytes")
    log("[user-api] " + json.dumps({
        "seconds": times, "launches": launches, "uploads": uploads,
        "peak_device_bytes": peak, "gpu": gpu_line()}))
    return launches, seqs, c31


def phase_motif_encoded(dev, seqs, motif, variants, lengths):
    """The motif scans on phase 7's array (the same 512 members phase 5
    scanned, as one EncodedRaggedArray): get_motif_matches must give
    phase 5's (read, offset) matches, get_motif_scores the first
    variant's float32 window scores (numpy_pwm_windows, the kernel's add
    order) as float64, and the array must still count one upload; the
    two calls once more under the profiler.  Returns the pwm_scores
    launches of the two timed calls and the matches as (rows, offsets)."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import pwm_kernels as pk
    from bionumpy_tpu_torch.ops import resident
    pwm, threshold, exp_rows, exp_offs = motif
    torch.cuda.synchronize()
    pk.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    times = {}
    t0 = time.perf_counter()
    matches = bt.get_motif_matches(seqs, pwm, threshold, device=dev)
    torch.cuda.synchronize()
    times["get_motif_matches"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = bt.get_motif_scores(seqs, pwm, device=dev)
    torch.cuda.synchronize()
    times["get_motif_scores"] = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    rows = np.repeat(np.arange(len(matches)), matches.lengths)
    if not (np.array_equal(rows, exp_rows)
            and np.array_equal(np.asarray(matches.ravel()), exp_offs)):
        raise AssertionError("get_motif_matches differs from phase 5's "
                             "matches")
    w = pwm.window_size
    ref, inside = numpy_pwm_windows(variants[0], lengths,
                                    pwm.matrix.astype(np.float32))
    first = np.asarray(scores[:N_READS].ravel())
    if not (np.array_equal(first, ref[inside].astype(np.float64))
            and first.dtype == np.float64 and np.array_equal(
                scores.lengths, np.maximum(seqs.lengths - w + 1, 0))):
        raise AssertionError("get_motif_scores differs from the recount")
    if resident.TRANSFER_COUNT != 1:
        raise AssertionError(f"{resident.TRANSFER_COUNT} uploads of phase "
                             f"7's array")
    if launches["pwm_scores_kernel"] < 1 or \
            launches["pwm_scores_kernel.match"] < 1:
        raise AssertionError(f"pwm_scores_kernel launched {launches} in 2 "
                             f"calls: one a mode expected")
    prof = profile_job(lambda: (
        bt.get_motif_matches(seqs, pwm, threshold, device=dev),
        bt.get_motif_scores(seqs, pwm, device=dev)), "motif-encoded")
    log(f"[motif-encoded] exact: {len(rows)} matches equal phase 5's, "
        f"{len(first)} window scores of variant 0 bit-equal; still "
        f"{resident.TRANSFER_COUNT} upload")
    log("[motif-encoded] " + json.dumps({
        "seconds": times, "launches": launches,
        "device_busy_ms": prof.get("device_busy_ms"),
        "device_idle_share": prof.get("device_idle_share"),
        "peak_device_bytes": peak, "gpu": gpu_line()}))
    return launches, (rows, np.asarray(matches.ravel()))


def phase_minimizers_fastq(dev, workdir: str, variants, lengths):
    """count_minimizers_fastq over phase 4's file: warm-up, timed and
    profiled runs; the table must equal a numpy recount of the 64
    variants times their copies, the stats the file's, and kmer_keys must
    have launched once per batch.  Returns the timed run's launches and
    table."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    path = os.path.join(workdir, "job.fq.gz")
    t0 = time.perf_counter()
    exp_h, exp_c = numpy_minimizer_table(
        np.concatenate(variants), np.tile(lengths, len(variants)), MIN_K,
        MIN_WINDOW)
    exp_c = exp_c * COPIES
    log(f"[minimizers-fastq] numpy recount {len(exp_h)} distinct in "
        f"{time.perf_counter() - t0:.1f} s")

    def run():
        return bt.count_minimizers_fastq(path, MIN_K, MIN_WINDOW,
                                         device=dev)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    log(f"[minimizers-fastq] warm-up run {time.perf_counter() - t0:.2f} s")
    bt.instrument.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    kk.reset_launches()
    t0 = time.perf_counter()
    counts, stats = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kk.LAUNCHES)
    stages = bt.instrument.report()
    n_batches = stages["dispatch"]["calls"]
    peak = torch.cuda.max_memory_allocated(dev)
    if not (np.array_equal(counts.label_codes, exp_h)
            and np.array_equal(counts.counts, exp_c)):
        raise AssertionError("the minimizer table differs from the recount")
    want_stats = {"n_reads": N_VARIANTS * COPIES * N_READS,
                  "n_bases": N_VARIANTS * COPIES * int(lengths.sum()),
                  "n_windows": int(exp_c.sum())}
    if stats != want_stats:
        raise AssertionError(f"stats {stats} != the file's {want_stats}")
    if launches["kmer_keys_kernel"] != n_batches:
        raise AssertionError(f"kmer_keys_kernel launched "
                             f"{launches['kmer_keys_kernel']} times for "
                             f"{n_batches} batches")
    log(f"[minimizers-fastq] exact: {stats}, {len(exp_h)} distinct, "
        f"{n_batches} batches")
    log(f"[minimizers-fastq] split: {bt.instrument.summary(total=wall)}")
    prof = profile_job(run, "minimizers-fastq")
    log("[minimizers-fastq] " + json.dumps({
        "wall_s": wall, "mbases_per_s": stats["n_bases"] / wall / 1e6,
        "n_batches": n_batches, "launches": launches,
        "device_busy_ms": prof.get("device_busy_ms"),
        "device_idle_share": prof.get("device_idle_share"),
        "peak_device_bytes": peak, "gpu": gpu_line()}))
    return launches, counts


def phase_minimizers_gc(dev):
    """Config 3's job: count_minimizers_with_gc(k=21, window 30, cap 2^22,
    1000-base GC bins) over 8 seeded strains of sacCer3's shape, as one
    EncodedRaggedArray; warm-up, a timed run that uploads again, then
    one with n_chunks=4, each profiled once more.  Table and bins must
    equal a numpy recount; each run must upload each base once and
    launch kmer_keys.  Returns the launches of the timed and the chunked
    run, and the timed run's (table, GC bins)."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import resident
    t0 = time.perf_counter()
    flat, lengths = strain_genome(SEED)
    seqs = bt.EncodedRaggedArray(bt.EncodedArray(flat, bt.DNAEncoding),
                                 lengths)
    n_bases = len(flat)
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp_h, exp_c = numpy_minimizer_table(flat, lengths, MIN_K, MIN_WINDOW)
    exp_gc = np.add.reduceat(((flat == 1) | (flat == 2)).astype(np.int32),
                             np.arange(0, n_bases, GC_BIN))
    recount = time.perf_counter() - t0
    log(f"[minimizers-gc] {len(lengths)} rows, {n_bases} bases (made in "
        f"{made:.1f} s); numpy recount {len(exp_h)} distinct, "
        f"{len(exp_gc)} bins in {recount:.1f} s")

    def run(n_chunks=1):
        resident.invalidate(seqs)  # every run uploads, as bench.py's
        # chunk_cap = cap: a chunk holds two strains, ~2.7 M distinct
        # minimizers, past the default chunk_cap (2^21) that would make
        # the chunks run twice
        return bt.count_minimizers_with_gc(seqs, MIN_K, MIN_WINDOW,
                                           cap=1 << 22, bin_size=GC_BIN,
                                           n_chunks=n_chunks,
                                           chunk_cap=1 << 22, device=dev)

    def check(out, tag):
        table, gc = out
        if not (np.array_equal(table.label_codes, exp_h)
                and np.array_equal(table.counts, exp_c)):
            raise AssertionError(f"the {tag} minimizer table differs from "
                                 f"the recount")
        if not (np.array_equal(gc, exp_gc) and gc.dtype == np.int32):
            raise AssertionError(f"the {tag} GC bins differ from the "
                                 f"recount")

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    log(f"[minimizers-gc] warm-up run {time.perf_counter() - t0:.2f} s")
    out = {}
    for n_chunks in (1, 4):
        resident.reset_transfer_counters()
        kk.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result = run(n_chunks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(result, f"n_chunks={n_chunks}")
        if n_chunks == 1:
            whole = result
        launches = dict(kk.LAUNCHES)
        if launches["kmer_keys_kernel"] < 1:
            raise AssertionError("kmer_keys_kernel never launched")
        if resident.TRANSFER_COUNT != n_chunks:
            raise AssertionError(f"{resident.TRANSFER_COUNT} uploads for "
                                 f"{n_chunks} chunk(s)")
        out[n_chunks] = {
            "wall_s": wall, "mbases_per_s": n_bases / wall / 1e6,
            "launches": launches, "uploads": resident.TRANSFER_COUNT,
            "upload_bytes": resident.TRANSFER_BYTES,
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
        out[n_chunks].update(profile_job(lambda n=n_chunks: run(n),
                                         f"minimizers-gc-{n_chunks}"))
    log(f"[minimizers-gc] exact: {len(exp_h)} distinct minimizers, "
        f"{int(exp_c.sum())} windows, {len(exp_gc)} GC bins, whole and in "
        f"4 chunks")
    log("[minimizers-gc] " + json.dumps({
        "whole": out[1], "chunks_4": out[4], "recount_s": recount,
        "gpu": gpu_line()}))
    return out[1]["launches"], out[4]["launches"], whole


def phase_checksum(dev, counts, variants, lengths):
    """kmer_checksum_streamed over the distinct variants, times the
    copies, must equal the table's sums (mod 2^32); timed on the host
    clock, then once more under the profiler for the device time of its
    fullsum launches."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    flat = np.concatenate(variants)
    all_lengths = np.tile(lengths, len(variants))

    def run():
        return bt.kmer_checksum_streamed(flat, all_lengths, K, device=dev)

    kk.reset_launches()
    t0 = time.perf_counter()
    n, lo, hi = run()
    wall = time.perf_counter() - t0
    launches = dict(kk.LAUNCHES)
    m32 = 0xFFFFFFFF
    h, c = counts.label_codes, counts.counts.astype(np.uint64)
    t_lo = int(np.sum((h & np.uint64(m32)) * c, dtype=np.uint64)) & m32
    t_hi = int(np.sum((h >> np.uint64(32)) * c, dtype=np.uint64)) & m32
    got = (COPIES * n, (COPIES * lo) & m32, (COPIES * hi) & m32)
    want = (int(counts.counts.sum()), t_lo, t_hi)
    if got != want:
        raise AssertionError(f"checksum {got} != table sums {want}")
    if launches["kmer_fullsum_kernel"] < 1:
        raise AssertionError("kmer_fullsum_kernel never launched")
    _, by_name = device_times(run)
    kernel_us = sum(us for name, us in by_name.items()
                    if "kmer_fullsum_kernel" in name)
    log(f"[checksum] equal: {got}")
    log("[checksum] " + json.dumps({
        "wall_s": wall, "bases": int(all_lengths.sum()),
        "launches": launches,
        "fullsum_device_ms": kernel_us / 1e3 if kernel_us else None,
        "device_busy_ms": sum(by_name.values()) / 1e3,
        "gpu": gpu_line()}))
    return launches


def ops_device_ms(fn, runs: int = 5):
    """Device time in ms of one call of fn: the kernels and copies the
    profiler records over `runs` calls, divided by `runs` (None when it
    records none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    return us / runs / 1e3 if us else None


def synced_s(fn):
    """(result, seconds) of one call of fn, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_composition(dev, workdir: str, variants, lengths,
                      target_bases: int = (1 << 25) - (1 << 21)):
    """Bench config 1 over phase 4's file, driven as bench.py's config1
    drives it: entry-aligned batches from _batch_arrays (fused parse),
    prefetched, each batch's packed words to the card and
    composition_from_packed accumulated there in int64, one fetch at the
    end.  Warm-up, timed and profiled runs; the totals must equal a numpy
    bincount of the variants times their copies.  Returns the op's row
    of the torch-ops line."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.instrument import stage
    from bionumpy_tpu_torch.ops.pwm_kernels import unpack_codes
    from bionumpy_tpu_torch.ops.seq import composition_from_packed
    from bionumpy_tpu_torch.pipeline import (_batch_arrays, _parse_batch,
                                             _prefetched)
    path = os.path.join(workdir, "job.fq.gz")
    want = sum(np.bincount(codes, minlength=4) for codes in variants) * \
        COPIES
    first = {}

    def run():
        pool = ThreadPoolExecutor(4)
        acc = torch.zeros(4, dtype=torch.int64, device=dev)
        n_bases = n_reads = n_batches = 0
        try:
            for raw in _prefetched(_batch_arrays(path, target_bases, pool,
                                                 fused_parse=True)):
                words, _, nb, nr = _parse_batch(raw)
                with stage("H2D", n_bytes=words.nbytes):
                    words_d = torch.from_numpy(words.view(np.int32)).to(
                        dev, non_blocking=True)
                with stage("dispatch"):
                    acc += composition_from_packed(words_d, nb)
                if not first:
                    first.update(words=words_d, n_true=nb)
                n_bases += nb
                n_reads += nr
                n_batches += 1
            with stage("D2H"):
                totals = acc.cpu().numpy()
        finally:
            pool.shutdown(wait=False)
        return totals, n_bases, n_reads, n_batches

    _, warm = synced_s(run)
    log(f"[composition] warm-up run {warm:.2f} s")
    bt.instrument.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    (totals, n_bases, n_reads, n_batches), wall = synced_s(run)
    peak = torch.cuda.max_memory_allocated(dev)
    stages = bt.instrument.report()
    if not (np.array_equal(totals, want) and n_bases == int(want.sum())
            and n_reads == N_VARIANTS * COPIES * N_READS):
        raise AssertionError(f"composition {totals.tolist()} over {n_bases} "
                             f"bases != the recount {want.tolist()}")
    log(f"[composition] exact: ACGT {totals.tolist()} over {n_bases} bases, "
        f"{n_reads} reads, {n_batches} batches")
    log(f"[composition] split: {bt.instrument.summary(total=wall)}")
    log("[composition] stages: " + json.dumps(stages))
    prof = profile_job(run, "composition")
    # the op alone on the first batch's words (a full batch)
    words_d, n_true = first["words"], first["n_true"]
    op = lambda: composition_from_packed(words_d, n_true)  # noqa: E731
    plain = lambda: torch.bincount(  # noqa: E731
        unpack_codes(words_d)[:n_true], minlength=4)
    if not torch.equal(op(), plain()):
        raise AssertionError("composition_from_packed differs from the "
                             "bincount of the unpacked codes")
    row = torch_op_row("composition_from_packed", "bionumpy_tpu/ops/seq.py:25",
                       op, plain, words_d.numel() * 4 + 32,
                       per=f"batch of {(words_d.numel() - 2) * 16} positions")
    log("[composition] " + json.dumps({
        "wall_s": wall, "mbases_per_s": n_bases / wall / 1e6,
        "n_batches": n_batches, "device_busy_ms": prof.get("device_busy_ms"),
        "device_idle_share": prof.get("device_idle_share"),
        "peak_device_bytes": peak, "op": row, "gpu": gpu_line()}))
    return row


def torch_op_row(name, replaces, op, plain, n_bytes, per):
    """The timing row of a torch op the JAX package runs as XLA: CUDA-event
    and profiler times of one call, its plain counterpart's, and its bound
    by bytes (each input read once, each output written once)."""
    bound_ms, bound_by = bound(n_bytes, 0)
    row = {"name": name, "replaces": replaces, "route": "torch ops",
           "ms": median_ms(op), "device_ms": ops_device_ms(op),
           "plain_ms": median_ms(plain), "bound_ms": bound_ms,
           "bound_by": bound_by, "per": per}
    log(f"[ops] {name}: {row['ms']:.4f} ms (device {row['device_ms']}, "
        f"plain {row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by}) per {per}")
    return row


TCAG_FROM_ACGT = np.array([2, 1, 3, 0], np.uint8)  # A C G T -> TCAG codes


def phase_translate(dev, variants, lengths):
    """Translation at phase 7's size: the motif job's 512,000 reads, each
    cut to a multiple of 3 bases and held in the TCAG alphabet, through
    translate_dna_to_protein on the card; every row must equal a numpy
    recount of the codon table.  Then lut_gather, encode_with_validation
    (with no invalid byte and with one planted) and composition_counts at
    the full 112.5 M positions against numpy.  Returns the gather's row
    of the torch-ops line, the codon-cut reads and their proteins."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.encodings import DNAEncoding
    from bionumpy_tpu_torch.ops import seq
    from bionumpy_tpu_torch.sequence.translate import DNAToProtein
    n_var = MOTIF_MEMBERS // COPIES
    cut = lengths // 3 * 3
    ends = np.cumsum(lengths)
    keep = np.arange(int(lengths.sum())) - np.repeat(ends - lengths,
                                                     lengths) < \
        np.repeat(cut, lengths)
    own = [TCAG_FROM_ACGT[codes[keep]] for codes in variants[:n_var]]
    table = DNAToProtein.lookup_table
    aminos = [table[c[2::3].astype(np.int64) + 4 * c[1::3] + 16 * c[0::3]]
              for c in own]
    flat = np.concatenate([c for c in own for _ in range(COPIES)])
    want = np.concatenate([a for a in aminos for _ in range(COPIES)])
    row_lengths = np.tile(cut, MOTIF_MEMBERS)
    seqs = bt.EncodedRaggedArray(
        bt.EncodedArray(flat, DNAToProtein.from_encoding), row_lengths)
    log(f"[translate] {len(seqs)} reads, {len(flat)} bases in whole codons, "
        f"{len(want)} amino acids expected")
    times = {}
    torch.cuda.reset_peak_memory_stats(dev)
    proteins, times["translate_dna_to_protein"] = synced_s(
        lambda: bt.translate_dna_to_protein(seqs, device=dev))
    if not (np.array_equal(proteins.lengths, row_lengths // 3) and
            np.array_equal(proteins.ravel().raw(), want)):
        raise AssertionError("translate_dna_to_protein differs from the "
                             "codon-table recount")
    peak = torch.cuda.max_memory_allocated(dev)
    codes_d = torch.from_numpy(flat).to(dev)
    table_d = torch.from_numpy(table.copy()).to(dev)
    gather = lambda: seq.translate_codons(codes_d, table_d)  # noqa: E731
    plain = lambda: table_d[codes_d[2::3].to(torch.int64)  # noqa: E731
                            + 4 * codes_d[1::3] + 16 * codes_d[0::3]]
    row = torch_op_row("translate_codons", "bionumpy_tpu/ops/seq.py:58",
                       gather, plain, len(flat) + 64 + len(want),
                       per=f"{len(want)} codons")
    del codes_d

    # the ASCII of every base: lut_gather, validation, composition
    text = np.frombuffer(b"ACGT", np.uint8)[np.concatenate(
        [variants[v] for v in range(n_var) for _ in range(COPIES)])]
    lut = DNAEncoding.lookup_table.copy()
    lut_d, text_d = (torch.from_numpy(a).to(dev) for a in (lut, text))
    codes, times["lut_gather"] = synced_s(lambda: seq.lut_gather(lut_d,
                                                                 text_d))
    want_codes = lut[text]
    if not np.array_equal(codes.cpu().numpy(), want_codes):
        raise AssertionError("lut_gather differs from numpy")
    planted = len(text) * 2 // 3 + 1
    for where in (None, planted):
        if where is not None:
            text_d[where] = ord("N")
        (got, first), times[f"encode_with_validation_{where}"] = synced_s(
            lambda: seq.encode_with_validation(lut_d, text_d))
        first = int(first)
        if first != (-1 if where is None else where) or \
                int((got == 255).sum()) != (where is not None):
            raise AssertionError(f"encode_with_validation found offset "
                                 f"{first}, planted {where}")
    valid_d = torch.arange(len(text), device=dev) % 7 != 0
    counts, times["composition_counts"] = synced_s(
        lambda: seq.composition_counts(codes, valid_d, 4))
    valid = np.arange(len(text)) % 7 != 0
    if not np.array_equal(counts.cpu().numpy(),
                          np.bincount(want_codes[valid], minlength=4)):
        raise AssertionError("composition_counts differs from numpy")
    log(f"[translate] exact: {len(want)} amino acids in {len(proteins)} "
        f"rows; lut_gather, encode_with_validation (none, and offset "
        f"{planted}) and composition_counts over {len(text)} bytes")
    log("[translate] " + json.dumps({
        "seconds": times, "peak_device_bytes": peak, "gather": row,
        "gpu": gpu_line()}))
    return row, seqs, proteins


def phase_kmer_ops(dev, batch):
    """The checksum and dense-count ops of ops/kmers at one full batch of
    2^25 positions, k = 31 and 15: the three checksums must agree with
    each other and with device="cpu"; kmer_count_small (k = 12) must
    equal kmer_count_small_packed, unique_kmer_stats the runs of a
    sorted numpy recount, hash_checksum numpy's sums and XORs.  The
    kernels' launch counts are reset before each function and must be
    those of its route.  Returns the launches of both kernels."""
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import kmers as tk
    words_np, ends_np, n, codes, lengths = batch
    padded, dist, _ = tk.prepare_codes(codes, lengths)
    host = {"words": torch.from_numpy(words_np.view(np.int32)),
            "ends": torch.from_numpy(ends_np),
            "codes": torch.from_numpy(padded),
            "dist": torch.from_numpy(dist),
            "lengths": torch.from_numpy(lengths.astype(np.int32))}
    card = {name: t.to(dev) for name, t in host.items()}
    total = {"kmer_keys_kernel": 0, "kmer_fullsum_kernel": 0}
    times = {}

    def launched(tag, fn, want):
        kk.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(kk.LAUNCHES)
        if got != {"kmer_keys_kernel": want[0],
                   "kmer_fullsum_kernel": want[1]}:
            raise AssertionError(f"{tag} launched {got}, its route "
                                 f"{want}")
        for name in total:
            total[name] += got[name]
        times[tag] = median_ms(fn, runs=5)
        return out

    m32 = np.uint64(0xFFFFFFFF)
    for k in (K, 15):
        checks = {
            "kmer_checksum_packed": (
                lambda d: tk.kmer_checksum_packed(d["words"], d["ends"], k),
                (0, 1)),
            "kmer_checksum_pipeline_packed": (
                lambda d: tk.kmer_checksum_pipeline_packed(
                    d["words"], d["ends"], k, n), (1, 0)),
            "kmer_checksum_pipeline": (
                lambda d: tk.kmer_checksum_pipeline(
                    d["codes"], d["lengths"], k, n), (1, 0))}
        results = []
        for name, (fn, route) in checks.items():
            got = [int(v) for v in launched(f"{name}_k{k}",
                                            lambda: fn(card), route)]
            want = [int(v) for v in fn(host)]
            if got != want:
                raise AssertionError(f"{name} (k={k}) {got} != cpu {want}")
            results.append(got)
        h = variant_hashes(codes, lengths, k)
        if any(r != results[0] for r in results) or results[0] != [
                len(h), int(np.sum(h & m32, dtype=np.uint64) & m32),
                int(np.sum(h >> np.uint64(32), dtype=np.uint64) & m32)]:
            raise AssertionError(f"the checksums (k={k}) {results} disagree "
                                 f"with each other or numpy")
        lo, hi, valid = launched(
            f"kmer_hashes_masked_k{k}", lambda: tk.kmer_hashes_masked(
                card["codes"], card["dist"], k), (0, 0))
        stats = [int(v) for v in launched(
            f"unique_kmer_stats_k{k}",
            lambda: tk.unique_kmer_stats(lo, hi, valid), (0, 0))]
        sums = [int(v) for v in launched(
            f"hash_checksum_k{k}",
            lambda: tk.hash_checksum(lo, hi, valid), (0, 0))]
        del lo, hi, valid
        s = np.sort(h)
        runs = int(np.count_nonzero(s[1:] != s[:-1])) + (len(s) > 0)
        limbs = (h & m32, h >> np.uint64(32))
        want_sums = [int(np.sum(x, dtype=np.uint64) & m32) for x in limbs] \
            + [int(np.bitwise_xor.reduce(x)) for x in limbs]
        if stats != [runs, len(h)] or sums != want_sums:
            raise AssertionError(f"unique_kmer_stats {stats} / hash_checksum "
                                 f"{sums} (k={k}) != numpy {[runs, len(h)]} "
                                 f"/ {want_sums}")
        log(f"[kmer-ops] k={k}: 3 checksums equal {results[0]} (cpu and "
            f"numpy too); {runs} distinct of {len(h)}; xor {sums[2:]}")
    small = launched("kmer_count_small_k12", lambda: tk.kmer_count_small(
        card["codes"], card["dist"], 12, 4 ** 12), (0, 0))
    if not torch.equal(small, tk.kmer_count_small_packed(
            card["words"], card["ends"], 12, 4 ** 12, n)):
        raise AssertionError("kmer_count_small != kmer_count_small_packed")
    log(f"[kmer-ops] kmer_count_small (k=12) equals kmer_count_small_packed "
        f"({int(small.sum())} 12-mers); launches {total}")
    log("[kmer-ops] " + json.dumps({"ms": times, "launches": total,
                                    "positions": len(dist),
                                    "gpu": gpu_line()}))
    return total


def phase_open_fastq(dev, workdir: str, lengths, c31, matches, motif,
                     motif_wall):
    """The reference's streaming idiom over phase 5's file (512 gzip
    members, 512,000 reads): count_entries, then bnp.open(...).
    read_chunks() at the default min_chunk_size and at 2^26 bytes, each
    chunk's sequences as one DNAEncoding array through count_kmers(s, 31)
    and get_motif_matches.  The summed counts must equal phase 7's, the
    matches in chunk order phase 10's; each chunk must upload once and
    launch kernels 1 and 3 once.  Returns the launches of both runs."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import pwm_kernels as pk
    from bionumpy_tpu_torch.ops import resident
    pwm, threshold = motif[0], motif[1]
    path = os.path.join(workdir, "motif.fq.gz")
    n_reads = MOTIF_MEMBERS * N_READS
    t0 = time.perf_counter()
    n_entries = bt.count_entries(path)
    count_s = time.perf_counter() - t0
    if n_entries != n_reads:
        raise AssertionError(f"count_entries gave {n_entries}, the file "
                             f"holds {n_reads} reads")

    def run(min_chunk_size):
        """(counts, rows, offsets, n_chunks, n_bases, {read_parse_s,
        device_calls_s, merge_s}): the seconds of the host read + parse,
        of the two device calls and of the host merge of the chunk's table
        into the running one."""
        total, rows, offs = 0, [], []
        n_chunks = n_bases = row0 = 0
        split = dict.fromkeys(("read_parse_s", "device_calls_s", "merge_s"),
                              0.0)
        chunks = iter(bt.open(path).read_chunks(min_chunk_size))
        while True:
            t = time.perf_counter()
            chunk = next(chunks, None)
            if chunk is None:
                break
            s = bt.as_encoded_array(chunk.sequence, bt.DNAEncoding)
            t1 = time.perf_counter()
            counts = bt.count_kmers(s, K, device=dev)
            m = bt.get_motif_matches(s, pwm, threshold, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            total = total + counts
            split["read_parse_s"] += t1 - t
            split["device_calls_s"] += t2 - t1
            split["merge_s"] += time.perf_counter() - t2
            rows.append(row0 + np.repeat(np.arange(len(m)), m.lengths))
            offs.append(np.asarray(m.ravel()))
            row0 += len(s)
            n_bases += int(np.sum(s.lengths))
            n_chunks += 1
        return (total, np.concatenate(rows), np.concatenate(offs), n_chunks,
                n_bases, split)

    def check(out, tag):
        total, rows, offs, n_chunks, n_bases = out[:5]
        if not (np.array_equal(total.label_codes, c31.label_codes)
                and np.array_equal(total.counts, c31.counts)):
            raise AssertionError(f"the {tag} chunked 31-mer counts differ "
                                 f"from phase 7's")
        if not (np.array_equal(rows, matches[0])
                and np.array_equal(offs, matches[1])):
            raise AssertionError(f"the {tag} chunked matches differ from "
                                 f"phase 10's")
        if n_bases != MOTIF_MEMBERS * int(lengths.sum()):
            raise AssertionError(f"{tag}: {n_bases} bases read")

    run(OPEN_CHUNK_SIZES["default"])  # warm-up
    torch.cuda.synchronize()
    out = {}
    for tag, size in OPEN_CHUNK_SIZES.items():
        resident.reset_transfer_counters()
        kk.reset_launches()
        pk.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result = run(size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**kk.LAUNCHES, **pk.LAUNCHES}
        check(result, tag)
        n_chunks, n_bases = result[3], result[4]
        if resident.TRANSFER_COUNT != n_chunks:
            raise AssertionError(f"{tag}: {resident.TRANSFER_COUNT} uploads "
                                 f"for {n_chunks} chunks")
        if launches["kmer_keys_kernel"] != n_chunks or \
                launches["pwm_scores_kernel.match"] != n_chunks:
            raise AssertionError(f"{tag}: launches {launches} for "
                                 f"{n_chunks} chunks")
        out[tag] = {
            "min_chunk_size": size, "wall_s": wall,
            "mbases_per_s": n_bases / wall / 1e6, "n_chunks": n_chunks,
            **result[5],
            "launches": launches, "uploads": resident.TRANSFER_COUNT,
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    prof = profile_job(lambda: run(OPEN_CHUNK_SIZES["default"]),
                       "open-fastq")
    log(f"[open-fastq] exact: count_entries {n_entries}; "
        f"{len(c31.label_codes)} distinct 31-mers and {len(matches[0])} "
        f"matches equal phases 7 and 10's, at {out['default']['n_chunks']} "
        f"and {out['large']['n_chunks']} chunks, one upload a chunk")
    log("[open-fastq] " + json.dumps({
        "count_entries_s": count_s, **out,
        "device_busy_ms": prof.get("device_busy_ms"),
        "device_idle_share": prof.get("device_idle_share"),
        "motif_fastq_wall_s": motif_wall, "gpu": gpu_line()}))
    return out["default"]["launches"], out["large"]["launches"]


def write_fasta_gz(path: str, names, codes: np.ndarray, lengths,
                   line: int = 50) -> None:
    """Multi-line FASTA of the ACGT `codes` cut into rows of `lengths`,
    `line` bases a line, as one gzip member (UCSC's .fa.gz layout)."""
    letters = np.frombuffer(b"ACGT", np.uint8)[codes]
    parts, start = [], 0
    for name, n in zip(names, lengths):
        seq = letters[start: start + n]
        start += n
        full = n // line * line
        body = np.hstack([seq[:full].reshape(-1, line),
                          np.full((full // line, 1), 10, np.uint8)])
        parts.append(b">%s\n" % name.encode() + body.tobytes())
        if n > full:
            parts.append(seq[full:].tobytes() + b"\n")
    with open(path, "wb") as f:
        f.write(gzip.compress(b"".join(parts), 6, mtime=0))


def phase_open_config3(dev, workdir: str, want):
    """Bench config 3 as bench.py drives it, from a file: phase 11's base
    genome written as a gzip multi-line FASTA of sacCer3's 17 chromosome
    names and lengths, read with MultiLineFastaBuffer, change_encoding to
    ACGTnEncoding, % 4, the 7 strains made as phase 11 makes them, then
    count_minimizers_with_gc.  The names and lengths must be those
    written, the table and bins phase 11's.  Returns kernel 1's
    launches."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.encodings.alphabet_encoding import ACGTnEncoding
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    path = os.path.join(workdir, "genome.fa.gz")
    base = base_genome(SEED)
    t0 = time.perf_counter()
    write_fasta_gz(path, SACCER3_NAMES, base, SACCER3_SIZES)
    log(f"[open-config3] wrote {len(base)} bases, "
        f"{os.path.getsize(path) / 1e6:.1f} MB gzip, in "
        f"{time.perf_counter() - t0:.1f} s")
    kk.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fa = bt.open(path, buffer_type=bt.MultiLineFastaBuffer).read()
    read_s = time.perf_counter() - t0
    seq = bt.change_encoding(fa.sequence, ACGTnEncoding)
    base_flat = np.asarray(seq.ravel().raw()) % 4
    flat, lengths = strains_of(base_flat, np.asarray(seq.lengths))
    seqs = bt.EncodedRaggedArray(bt.EncodedArray(flat, bt.DNAEncoding),
                                 lengths)
    table, gc = bt.count_minimizers_with_gc(
        seqs, MIN_K, MIN_WINDOW, cap=1 << 22, bin_size=GC_BIN,
        chunk_cap=1 << 22, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kk.LAUNCHES)
    names = [str(n) for n in fa.name.tolist()]
    if names != list(SACCER3_NAMES) or not np.array_equal(
            seq.lengths, SACCER3_SIZES) or not np.array_equal(base_flat,
                                                              base):
        raise AssertionError(f"the FASTA read back as {names} "
                             f"{np.asarray(seq.lengths).tolist()}, not as "
                             f"written")
    want_table, want_gc = want
    if not (np.array_equal(table.label_codes, want_table.label_codes)
            and np.array_equal(table.counts, want_table.counts)
            and np.array_equal(gc, want_gc)):
        raise AssertionError("config 3 from the file differs from phase 11")
    if launches["kmer_keys_kernel"] < 1:
        raise AssertionError("kmer_keys_kernel never launched")
    log(f"[open-config3] exact: 17 names and lengths as written; "
        f"{len(table.label_codes)} distinct minimizers and {len(gc)} GC "
        f"bins equal phase 11's")
    log("[open-config3] " + json.dumps({
        "read_s": read_s, "wall_s": wall,
        "mbases_per_s": len(flat) / wall / 1e6, "n_bases": len(flat),
        "launches": launches,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "gpu": gpu_line()}))
    return launches


VCF_MEMBERS, VCF_RECORDS, VCF_SNVS = 8, 96_711, 83_663  # 773,688; 669,304
CHR21, CHR22 = 46_709_983, 50_818_468
BED_INTERVALS = 2_000_000
# phase 15's two min_chunk_size values: read_chunks' default and 2^26
OPEN_CHUNK_SIZES = {"default": 5_000_000, "large": 1 << 26}


def seeded_vcf_body(seed: int, genome=None):
    """One member's sites-only records on chr21 and chr22 in bench config
    5's shape (VCF_SNVS SNVs among VCF_RECORDS, the rest 1-5 base
    insertions and deletions), sorted by position.  With `genome` (codes
    of chr21 and chr22), each record's REF starts with the genome's base
    at its position, so every SNV's REF is the genome's base.  Returns
    (text, chromosomes, 1-based positions, refs, alts)."""
    rng = np.random.default_rng(seed)
    n = VCF_RECORDS
    on21 = np.arange(n) < n * CHR21 // (CHR21 + CHR22)
    pos = np.where(on21, rng.integers(1, CHR21 - 8, n),
                   rng.integers(1, CHR22 - 8, n))
    order = np.lexsort((pos, ~on21))
    on21, pos = on21[order], pos[order]
    kind = rng.permutation(np.repeat([0, 1, 2], [
        VCF_SNVS, (n - VCF_SNVS) // 2, n - VCF_SNVS - (n - VCF_SNVS) // 2]))
    letters = np.array(list("ACGT"))
    first = rng.integers(0, 4, n)
    if genome is not None:
        first[on21] = genome["chr21"][pos[on21] - 1]
        first[~on21] = genome["chr22"][pos[~on21] - 1]
    other = (first + rng.integers(1, 4, n)) % 4
    extra = rng.integers(1, 6, n)
    tails = ["".join(letters[rng.integers(0, 4, e)]) for e in extra]
    refs, alts = [], []
    for i in range(n):
        a = letters[first[i]]
        if kind[i] == 0:
            refs.append(a)
            alts.append(letters[other[i]])
        elif kind[i] == 1:
            refs.append(a + tails[i])
            alts.append(a)
        else:
            refs.append(a)
            alts.append(a + tails[i])
    chroms = np.where(on21, "chr21", "chr22")
    ac = rng.integers(1, 5008, n)
    text = "".join(f"{c}\t{p}\trs{i}\t{r}\t{a}\t100\tPASS\tAC={x};AN=5008\n"
                   for i, (c, p, r, a, x) in enumerate(zip(
                       chroms, pos, refs, alts, ac)))
    return text.encode(), chroms.tolist(), pos, refs, alts


VCF_HEADER = (b"##fileformat=VCFv4.2\n"
              b"##INFO=<ID=AC,Number=1,Type=Integer,Description=\"count\">\n"
              b"##INFO=<ID=AN,Number=1,Type=Integer,Description=\"total\">\n"
              b"##contig=<ID=chr21,length=46709983>\n"
              b"##contig=<ID=chr22,length=50818468>\n"
              b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")


def _strings(column) -> list:
    """A string column (StringArray or EncodedRaggedArray) as str."""
    return [str(x) for x in column.tolist()]


def phase_open_records(dev, workdir: str, reads, proteins):
    """The host formats at bench config 5's scale, and translation file
    to file.  A seeded 8-member sites-only VCF (773,688 records) read
    back through bnp.open: every chromosome, position, ref and alt as
    written, the SNVs counted exactly; 2 M seeded BED intervals on chr21
    written with the port's writer and read back equal, a second write
    byte-identical; phase 13's codon-cut reads written as a two-line
    FASTA, translated chunk by chunk on the card into a .fa (the
    reference's translate example), read back equal to phase 13's
    proteins row by row.  Prints each read's and write's seconds and
    records/s.  Returns the kernel launches (none: no kernel of the port
    is on these paths)."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.datatypes import Interval, SequenceEntry
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import pwm_kernels as pk
    times = {}
    kk.reset_launches()
    pk.reset_launches()

    def timed(name, fn, n_records):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        times[name] = {"s": s, "records_per_s": n_records / s}
        return out

    # VCF: member 0 the header and the body, members 1-7 the body again
    body, chroms, pos, refs, alts = seeded_vcf_body(SEED)
    vcf_path = os.path.join(workdir, "sites.vcf.gz")
    member = gzip.compress(body, 6, mtime=0)
    with open(vcf_path, "wb") as f:
        f.write(gzip.compress(VCF_HEADER + body, 6, mtime=0))
        for _ in range(VCF_MEMBERS - 1):
            f.write(member)
    n_vcf = VCF_MEMBERS * VCF_RECORDS

    def read_sites():
        """The read as config 5 needs it: the lazy records and the four
        columns it uses."""
        vcf = bt.open(vcf_path).read()
        return len(vcf), (vcf.chromosome, vcf.position, vcf.ref_seq,
                          vcf.alt_seq)

    n, (chrom, position, ref, alt) = timed("vcf_read", read_sites, n_vcf)
    if not (n == n_vcf and _strings(chrom) == chroms * VCF_MEMBERS
            and np.array_equal(position, np.tile(pos - 1, VCF_MEMBERS))
            and _strings(ref) == refs * VCF_MEMBERS
            and _strings(alt) == alts * VCF_MEMBERS):
        raise AssertionError("the VCF read back differs from what was "
                             "written")
    n_snv = int(np.count_nonzero((np.asarray(ref.lengths) == 1)
                                 & (np.asarray(alt.lengths) == 1)))
    if n_snv != VCF_MEMBERS * VCF_SNVS:
        raise AssertionError(f"{n_snv} SNVs, {VCF_MEMBERS * VCF_SNVS} "
                             f"written")
    del chrom, position, ref, alt

    # BED: 2 M intervals on chr21, as bench.py's dense pileup scale
    n_iv = BED_INTERVALS
    starts, stops = fragments(np.random.default_rng(5), n_iv, CHR21)
    intervals = Interval(["chr21"] * n_iv, starts, stops)
    bed_paths = [os.path.join(workdir, f"iv{i}.bed") for i in (1, 2)]

    def write(path, data):
        with bt.open(path, "w") as f:
            f.write(data)

    timed("bed_write", lambda: write(bed_paths[0], intervals), n_iv)
    # eager, so that the second write formats every field again
    bed = timed("bed_read", lambda: bt.open(bed_paths[0], lazy=False).read(),
                n_iv)
    if not (_strings(bed.chromosome) == ["chr21"] * n_iv
            and np.array_equal(bed.start, starts)
            and np.array_equal(bed.stop, stops)):
        raise AssertionError("the BED read back differs from what was "
                             "written")
    timed("bed_write_again", lambda: write(bed_paths[1], bed), n_iv)
    with open(bed_paths[0], "rb") as a, open(bed_paths[1], "rb") as b:
        if a.read() != b.read():
            raise AssertionError("the second BED write differs in bytes")
    del bed, intervals

    # translation file to file (examples/translate.py)
    in_fa, out_fa = (os.path.join(workdir, f) for f in ("reads.fa",
                                                          "proteins.fa"))
    n_reads = len(reads)
    names = [f"r{i}" for i in range(n_reads)]
    timed("fasta_write", lambda: write(
        in_fa, SequenceEntry(names, reads)), n_reads)

    def translate_file():
        with bt.open(out_fa, "w") as out:
            for chunk in bt.open(in_fa).read_chunks():
                out.write(bt.translate_dna_to_protein(chunk, device=dev))

    timed("translate_file", translate_file, n_reads)
    back = timed("protein_read", lambda: bt.open(out_fa).read(), n_reads)
    if not (_strings(back.name) == names
            and np.array_equal(back.sequence.lengths, proteins.lengths)
            and np.array_equal(back.sequence.ravel().raw(),
                               proteins.ravel().raw())):
        raise AssertionError("the translated file differs from phase 13's "
                             "proteins")
    launches = {**kk.LAUNCHES, **pk.LAUNCHES}
    log(f"[open-records] exact: {n_vcf} VCF records ({n_snv} SNVs), {n_iv} "
        f"BED intervals (rewritten byte-identical), {n_reads} proteins "
        f"equal phase 13's")
    log("[open-records] " + json.dumps({**times, "launches": launches,
                                        "gpu": gpu_line()}))
    return launches


PEAKS = 60_000                # phase 18's second interval set


def seeded_peaks():
    """Phase 18's 60,000 seeded peaks of 200-400 bases on chr21 and
    chr22: (on chr21, starts, stops)."""
    rng = np.random.default_rng(SEED)
    on21 = rng.random(PEAKS) < CHR21 / (CHR21 + CHR22)
    p_start = np.where(on21, rng.integers(0, CHR21 - 400, PEAKS),
                       rng.integers(0, CHR22 - 400, PEAKS))
    return on21, p_start, p_start + rng.integers(200, 401, PEAKS)


def fragments(rng, n: int, size: int):
    """bench.py's dense-scale fragments: n starts below size - 600, each
    100-599 bases long."""
    starts = rng.integers(0, size - 600, n).astype(np.int64)
    return starts, starts + rng.integers(100, 600, n)


def numpy_depth(starts, stops, size: int) -> np.ndarray:
    """int64 depth over [0, size) by a boundary bincount and a cumsum."""
    diff = np.bincount(starts, minlength=size + 1) - \
        np.bincount(stops, minlength=size + 1)
    return np.cumsum(diff[:-1])


def numpy_bins(depth: np.ndarray, bin_size: int) -> np.ndarray:
    pad = (-len(depth)) % bin_size
    return np.concatenate([depth, np.zeros(pad, depth.dtype)]).reshape(
        -1, bin_size).sum(axis=1)


def kmer_revcomp(hashes: np.ndarray, k: int) -> np.ndarray:
    """The hash (sum code_j << 2j) of each k-mer's reverse complement."""
    out = np.zeros_like(hashes)
    for j in range(k):
        code = (hashes >> np.uint64(2 * j)) & np.uint64(3)
        out |= (np.uint64(3) - code) << np.uint64(2 * (k - 1 - j))
    return out


def phase_intervals(dev, workdir: str, seqs, c31):
    """Bench config 5's interval arithmetic (bench.py:727-779) on the
    card, every check exact.  (1) phase 17's 2 M chr21 fragments through
    get_pileup (host RLE) and get_pileup_device (dense, as an RLE; binned
    at 100 and 1000), each against a numpy recount, the two RLEs equal;
    the two pileup ops timed beside their bounds.  (2) those fragments
    and 2 M more on chr22 written as a gzip BED by the port's writer, then
    binned_pileup_bed at 1000 and 100 against the recount.  (3) jaccard
    and forbes of the 4 M fragments and 60,000 seeded peaks, both
    sort_intervals-ed, == a numpy boolean-mask recount in the same
    formula.  (4) mean, bincount, histogram and quantile of the fragment
    lengths over bnp.open(bed).read_chunks() against numpy over the whole
    file, and groupby(..., "chromosome") into get_pileup_device per
    chromosome against (2)'s bins at 1000.  (5) get_reverse_complement of
    phase 7's reads into count_kmers(., 31): phase 7's table with every
    hash mapped to its reverse complement, one upload, one launch of
    kmer_keys_kernel.  Returns the kernel launches and the two ops' rows
    of the torch-ops line."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch import arithmetics as ar
    from bionumpy_tpu_torch.datatypes import Interval
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import pwm_kernels as pk
    from bionumpy_tpu_torch.ops import resident
    from bionumpy_tpu_torch.ops.tracks import binned_pileup, dense_pileup
    sizes = {"chr21": CHR21, "chr22": CHR22}
    n = BED_INTERVALS
    out, peaks = {}, {}
    kk.reset_launches()
    pk.reset_launches()

    def warm_timed(name, fn):
        synced_s(fn)
        res, s = synced_s(fn)
        out[name] = s
        return res

    def peak(part):
        torch.cuda.synchronize()
        peaks[part] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.reset_peak_memory_stats(dev)
    # (1) pileups at the dense scale: phase 17's fragments (seed 5)
    rng = np.random.default_rng(5)
    s21, e21 = fragments(rng, n, CHR21)
    iv21 = Interval(["chr21"] * n, s21, e21)
    depth = numpy_depth(s21, e21, CHR21)
    host = warm_timed("get_pileup_s", lambda: ar.get_pileup(iv21, CHR21))
    dense = warm_timed("get_pileup_device_s", lambda: ar.get_pileup_device(
        iv21, CHR21, device=dev))
    if not (np.array_equal(host.to_array(), depth)
            and np.array_equal(dense.events, host.events)
            and np.array_equal(dense.values, host.values)):
        raise AssertionError("the pileups differ from the numpy recount or "
                             "from each other")
    n_runs = len(dense.values)
    del host, dense
    # the dense call's split: upload, the op, the fetch, the host RLE
    split = {}

    def lap(name, fn):
        res, split[name] = synced_s(fn)
        return res

    ends = lap("h2d_s", lambda: [torch.from_numpy(a.astype(np.int32)).to(dev)
                                 for a in (s21, e21)])
    on_card = lap("dense_pileup_s", lambda: dense_pileup(
        *ends, torch.ones(n, dtype=torch.bool, device=dev), CHR21))
    fetched = lap("fetch_s", lambda: on_card.cpu().numpy())
    lap("rle_s", lambda: ar.GenomicRunLengthArray.from_array(fetched))
    out["get_pileup_device_split"] = split
    del ends, on_card, fetched
    for bin_size in (100, 1000):
        got = warm_timed(f"binned_{bin_size}_s", lambda: ar.get_pileup_device(
            iv21, CHR21, bin_size=bin_size, device=dev))
        if not np.array_equal(got, numpy_bins(depth, bin_size)):
            raise AssertionError(f"get_pileup_device at bin_size {bin_size} "
                                 f"differs from the recount")
    del depth, iv21
    # the two ops alone on these inputs, beside a plain torch version
    starts = torch.from_numpy(s21.astype(np.int32)).to(dev)
    stops = torch.from_numpy(e21.astype(np.int32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    n_bins = -(-CHR21 // 100)

    def dense_plain():
        diff = torch.bincount(starts, minlength=CHR21 + 1) - \
            torch.bincount(stops, minlength=CHR21 + 1)
        return torch.cumsum(diff[:-1], 0).to(torch.int32)

    def binned_plain():
        d = torch.nn.functional.pad(dense_plain(), (0, n_bins * 100 - CHR21))
        return d.view(n_bins, 100).sum(1, dtype=torch.int32)

    dense_op = lambda: dense_pileup(starts, stops, valid, CHR21)  # noqa: E731
    binned_op = lambda: binned_pileup(  # noqa: E731
        starts, stops, valid, n_bins, 100)
    if not (torch.equal(dense_op(), dense_plain())
            and torch.equal(binned_op(), binned_plain())):
        raise AssertionError("a pileup op differs from its plain version")
    in_bytes = n * (4 + 4 + 1)
    rows = [torch_op_row("dense_pileup", "bionumpy_tpu/ops/tracks.py:24",
                         dense_op, dense_plain, in_bytes + 4 * CHR21,
                         per=f"{n} intervals over {CHR21} positions"),
            torch_op_row("binned_pileup", "bionumpy_tpu/ops/tracks.py:37",
                         binned_op, binned_plain, in_bytes + 4 * n_bins,
                         per=f"{n} intervals into {n_bins} bins of 100")]
    del starts, stops, valid
    torch.cuda.empty_cache()
    peak("pileups")

    # (2) binned_pileup_bed over a gzip BED of both chromosomes
    s22, e22 = fragments(rng, n, CHR22)
    bed_path = os.path.join(workdir, "fragments.bed.gz")
    both = Interval(["chr21"] * n + ["chr22"] * n, np.concatenate([s21, s22]),
                    np.concatenate([e21, e22]))
    t0 = time.perf_counter()
    with bt.open(bed_path, "w") as f:
        f.write(both)
    out["bed_write_s"] = time.perf_counter() - t0
    del both
    depths = {"chr21": numpy_depth(s21, e21, CHR21),
              "chr22": numpy_depth(s22, e22, CHR22)}
    bed_bins = {}
    for bin_size in (1000, 100):
        bt.instrument.reset()
        (tracks, stats), s = synced_s(lambda: bt.binned_pileup_bed(
            bed_path, sizes, bin_size, device=dev))
        st = bt.instrument.report()
        if not (stats == {"n_intervals": 2 * n, "n_bins": sum(
                -(-v // bin_size) for v in sizes.values())} and all(
                np.array_equal(tracks[c], numpy_bins(depths[c], bin_size))
                for c in sizes)):
            raise AssertionError(f"binned_pileup_bed at {bin_size} differs "
                                 f"from the recount")
        out[f"binned_pileup_bed_{bin_size}"] = {
            "s": s, "records_per_s": 2 * n / s,
            **{k: st[k]["seconds"] for k in ("read", "H2D", "step",
                                             "D2H-table")}}
        bed_bins[bin_size] = tracks
    del depths
    peak("binned_pileup_bed")

    # (3) jaccard and forbes against seeded peaks
    enc = bt.StringEncoding(list(sizes))
    on21, p_start, p_stop = seeded_peaks()

    def encoded(on_21, st, sp):
        return Interval(bt.EncodedArray((~on_21).astype(np.int64), enc),
                        st, sp)
    frag = encoded(np.arange(2 * n) < n, np.concatenate([s21, s22]),
                   np.concatenate([e21, e22]))
    pk_iv = encoded(on21, p_start, p_stop)
    t0 = time.perf_counter()
    frag, pk_iv = ar.sort_intervals(frag), ar.sort_intervals(pk_iv)
    out["sort_s"] = time.perf_counter() - t0
    j, out["jaccard_s"] = synced_s(lambda: ar.jaccard(sizes, frag, pk_iv))
    fb, out["forbes_s"] = synced_s(lambda: ar.forbes(sizes, frag, pk_iv))
    del frag, pk_iv
    cells = np.zeros(4, np.int64)
    for name, fs, fe, ps, pe in (
            ("chr21", s21, e21, p_start[on21], p_stop[on21]),
            ("chr22", s22, e22, p_start[~on21], p_stop[~on21])):
        a = numpy_depth(fs, fe, sizes[name]) > 0
        b = numpy_depth(ps, pe, sizes[name]) > 0
        cells += [np.sum(a & b), np.sum(a & ~b), np.sum(~a & b),
                  np.sum(~a & ~b)]
        del a, b
    table = cells.reshape(2, 2)
    (both_, a_only), (b_only, neither) = table
    want_j = float(both_ / (table.sum() - neither))
    want_f = float(both_ * table.sum() / ((both_ + a_only) * (both_ + b_only)))
    if not (j == want_j and fb == want_f):
        raise AssertionError(f"jaccard {j!r} / forbes {fb!r} != the recount "
                             f"{want_j!r} / {want_f!r}")
    out["jaccard"], out["forbes"] = j, fb
    peak("similarity")

    # (4) the stream layer over the file's chunks
    lengths = np.concatenate([e21 - s21, e22 - s22])
    del s21, e21, s22, e22

    def chunk_lengths():
        return (c.stop - c.start for c in bt.open(bed_path).read_chunks())
    edges = np.arange(100, 601, 50)
    q = [0.1, 0.5, 0.9]
    t0 = time.perf_counter()
    got = (bt.mean(chunk_lengths()), bt.bincount(chunk_lengths()),
           bt.histogram(chunk_lengths(), bins=edges),
           bt.quantile(chunk_lengths(), q))
    out["reductions_s"] = time.perf_counter() - t0
    cum = np.cumsum(np.bincount(lengths))
    want = (np.array([lengths.sum()]) / len(lengths), np.bincount(lengths),
            np.histogram(lengths, bins=edges),
            np.searchsorted(cum, np.asarray(q) * cum[-1]))
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))
            and np.array_equal(got[3], want[3])):
        raise AssertionError("a stream reduction differs from numpy over "
                             "the whole file")
    del lengths
    t0 = time.perf_counter()
    grouped = {name: ar.get_pileup_device(group, sizes[name], bin_size=1000,
                                          device=dev)
               for name, group in bt.groupby(bt.open(bed_path).read_chunks(),
                                             "chromosome")}
    out["groupby_pileup_s"] = time.perf_counter() - t0
    if not (list(grouped) == list(sizes) and all(
            np.array_equal(grouped[c], bed_bins[1000][c]) for c in sizes)):
        raise AssertionError("groupby into get_pileup_device differs from "
                             "binned_pileup_bed's bins")
    bins_100_chr21 = bed_bins[100]["chr21"]
    del grouped, bed_bins
    peak("streams")

    # (5) reverse complement into kernel 1
    resident.reset_transfer_counters()
    rc, out["reverse_complement_s"] = synced_s(
        lambda: bt.get_reverse_complement(seqs))
    table_rc, out["count_kmers_rc_s"] = synced_s(
        lambda: bt.count_kmers(rc, K, device=dev))
    uploads = resident.TRANSFER_COUNT
    mapped = kmer_revcomp(np.asarray(c31.label_codes, np.uint64), K)
    order = np.argsort(mapped)
    if not (np.array_equal(table_rc.label_codes, mapped[order])
            and np.array_equal(table_rc.counts, c31.counts[order])):
        raise AssertionError("the reverse complement's 31-mer table is not "
                             "phase 7's mapped to reverse complements")
    launches = {**kk.LAUNCHES, **pk.LAUNCHES}
    if uploads != 1 or launches["kmer_keys_kernel"] != 1:
        raise AssertionError(f"{uploads} uploads and "
                             f"{launches['kmer_keys_kernel']} launches for "
                             f"the reverse complement's count")
    del rc, table_rc
    peak("reverse_complement")
    log(f"[intervals] exact: pileups of {n} chr21 fragments ({n_runs} runs), "
        f"binned_pileup_bed of {2 * n} records at 1000 and 100, jaccard "
        f"{j!r} and forbes {fb!r} against {PEAKS} peaks, the stream "
        f"reductions and groupby, {len(c31.label_codes)} reverse-complement "
        f"31-mers")
    log("[intervals] " + json.dumps({**out, "peak_device_bytes": peaks,
                                     "launches": launches, "uploads": uploads,
                                     "gpu": gpu_line()}))
    return launches, rows, {"jaccard": j, "bins_100_chr21": bins_100_chr21}


# phase 19: sizes of the index-layer prefixes (their Python loops run once
# per distinct k-mer) and of the SBS96 job's repeats
INDEX_READS = 256_000         # KmerLookup over 8 variants x 32 copies
INDEX_QUERIES = 100
DBG_READS = 1000              # DeBruijnGraph over one copy of a variant
SBS_RUNS = 3


def _inflate_members_seq(path: str) -> bytes:
    """All gzip members of a file inflated one after another."""
    import zlib
    data = open(path, "rb").read()
    out = []
    while data:
        obj = zlib.decompressobj(wbits=31)
        out.append(obj.decompress(data))
        data = obj.unused_data
    return b"".join(out)


def numpy_sbs96_job(path: str, ref_codes: dict):
    """bench.py's numpy twin of config 5's whole SBS96 job
    (bench.py:551-606): inflate, a vectorized VCF field scan, then the
    strand-collapsed SBS96 counts in bin order ((ref C/T * 3 + alt rank)
    * 16 + left * 4 + right).  Returns (counts, number of SNVs)."""
    raw = np.frombuffer(_inflate_members_seq(path), np.uint8)
    nl = np.flatnonzero(raw == 10)
    line_starts = np.insert(nl[:-1] + 1, 0, 0)
    data_starts = line_starts[raw[line_starts] != ord("#")]
    tabs = np.flatnonzero(raw == 9)
    first = np.searchsorted(tabs, data_starts)
    t = [tabs[first + j] for j in range(5)]
    is22 = raw[t[0] - 1] == ord("2")
    lens = t[1] - t[0] - 1
    width = int(lens.max())
    idx = t[1][:, None] - width + np.arange(width)
    digits = (raw[np.maximum(idx, 0)] - ord("0")).astype(np.int64)
    digits[idx < (t[0] + 1)[:, None]] = 0
    pos = digits @ (10 ** np.arange(width - 1, -1, -1)) - 1
    ref_len = t[3] - t[2] - 1
    alt_len = t[4] - t[3] - 1
    snp = (ref_len == 1) & (alt_len == 1)
    enc = np.full(256, 255, np.uint8)
    for i, c in enumerate("ACGT"):
        enc[ord(c)] = i
    alt = enc[raw[t[3] + 1]][snp]
    pos_s = pos[snp]
    is22_s = is22[snp]
    counts = np.zeros(96, np.int64)
    names = sorted(ref_codes)
    for name, sel in ((names[0], ~is22_s), (names[1], is22_s)):
        codes = ref_codes[name]
        p = pos_s[sel]
        a = alt[sel].astype(np.int64)
        left = codes[p - 1].astype(np.int64)
        mid = codes[p].astype(np.int64)
        right = codes[p + 1].astype(np.int64)
        flip = (mid == 0) | (mid == 2)
        left2 = np.where(flip, 3 - right, left)
        right2 = np.where(flip, 3 - left, right)
        mid2 = np.where(flip, 3 - mid, mid)
        a2 = np.where(flip, 3 - a, a)
        ref_rank = (mid2 == 3).astype(np.int64)
        alt_rank = a2 - (a2 > mid2)
        bin_idx = ((ref_rank * 3 + alt_rank) * 4 + left2) * 4 + right2
        counts += np.bincount(bin_idx, minlength=96)
    return counts, int(snp.sum())


SBS96_LABELS = [f"{l}[{r}>{a}]{s}" for r in "CT" for a in "ACGT" if a != r
                for l in "ACGT" for s in "ACGT"]


class _Vars:
    """bench.py's config-5 variant view: chromosome and position from the
    genomic locations, the other fields from the parsed records."""

    def __init__(self, loc, var):
        self._loc, self._var = loc, var

    def get_data_field(self, name):
        if name in ("chromosome", "position"):
            return getattr(self._loc, name)
        return getattr(self._var, name)

    def __getitem__(self, idx):
        return _Vars(self._loc[idx], self._var[idx])

    def get_windows(self, flank):
        return self._loc.get_windows(flank=flank)


def phase_genomic(dev, workdir: str, seqs, phase18: dict):
    """The genomic layer, the SBS96 job, the streamed fold and the index
    layer, every check exact.  (1) Bench config 5's SBS96 whole job as
    bench.py:655-690 drives it, over a seeded genome of chr21 and chr22
    and an 8-member VCF of 773,688 records (669,304 SNVs) whose REFs are
    the genome's bases: read, SNP mask, Genome.get_locations,
    count_mutation_types_genomic through GenomicSequence.from_dict; 3
    timed runs and a split run, the 96-vector held to bench.py's numpy
    twin label by label.  (2) Genome.read_intervals of phase 18's 4 M
    record gzip BED, whole and stream=True, get_pileup of each equal event
    for event, chr21 equal to arithmetics.get_pileup and both to a numpy
    recount; Geometry.jaccard against phase 18's 60,000 peaks == phase
    18's jaccard; GenomicSequence extraction of the peaks == numpy
    slicing.  (3) One streamed pass over bt.open(bed).read_chunks() with
    three folds of partials made on the card: ops/tracks.binned_pileup of
    the chr21 records at 100 (through GlobalOffset) by SUM, the fragment
    lengths' bincount by BINCOUNT and their max by MAX; each result a CUDA
    tensor equal to binned_pileup_bed's bins / numpy.  (4) KmerLookup
    (k = 31) over the first INDEX_READS reads of phase 7's array and
    INDEX_QUERIES string queries, each query's rows equal to a numpy
    recount, kernel 1 launched once for the index and once a query;
    DeBruijnGraph over the first DBG_READS reads, its contigs equal to
    the same graph built with device="cpu".  Returns the kernel launches
    of parts (1)-(4)."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch import computation_graph as cg
    from bionumpy_tpu_torch import arithmetics as ar
    from bionumpy_tpu_torch.datatypes import Interval
    from bionumpy_tpu_torch.genomic_data import (GenomicSequence, Geometry,
                                                 GlobalOffset)
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import pwm_kernels as pk
    from bionumpy_tpu_torch.ops.tracks import binned_pileup
    from bionumpy_tpu_torch.sequence.debruijn import DeBruijnGraph
    from bionumpy_tpu_torch.sequence.indexing import KmerLookup
    from bionumpy_tpu_torch.variants import count_mutation_types_genomic
    from bionumpy_tpu_torch.variants.mutation_signature import encode_snps
    from bionumpy_tpu_torch.sequence import count_encoded
    sizes = {"chr21": CHR21, "chr22": CHR22}
    out, peaks, launches = {}, {}, {}
    torch.cuda.reset_peak_memory_stats(dev)

    def reset():
        kk.reset_launches()
        pk.reset_launches()

    def read_launches(part):
        launches[part] = {**kk.LAUNCHES, **pk.LAUNCHES}
        torch.cuda.synchronize()
        peaks[part] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # (1) config 5's SBS96 whole job
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 19)
    ref_codes = {name: rng.integers(0, 4, size).astype(np.uint8)
                 for name, size in sizes.items()}
    alpha = np.frombuffer(b"ACGT", np.uint8)
    sequence = GenomicSequence.from_dict(
        {name: bytes(alpha[c]).decode("ascii")
         for name, c in ref_codes.items()})
    genome = bt.Genome.from_dict(sizes)
    body, _, pos, refs, alts = seeded_vcf_body(SEED, ref_codes)
    vcf_path = os.path.join(workdir, "config5.vcf.gz")
    member = gzip.compress(body, 6, mtime=0)
    with open(vcf_path, "wb") as f:
        f.write(gzip.compress(VCF_HEADER + body, 6, mtime=0))
        for _ in range(VCF_MEMBERS - 1):
            f.write(member)
    n_snv_member = sum(len(r) == len(a) == 1 for r, a in zip(refs, alts))
    del body, member, pos, refs, alts
    out["sbs96_setup_s"] = time.perf_counter() - t0

    def sbs_job():
        variants = bt.open(vcf_path).read()
        is_snp = np.asarray(variants.ref_seq.lengths == 1) & \
            np.asarray(variants.alt_seq.lengths == 1)
        snps = variants[is_snp]
        locations = genome.get_locations(
            bt.LocationEntry(snps.chromosome, snps.position))
        counts = count_mutation_types_genomic(_Vars(locations, snps),
                                              sequence)
        return counts, len(snps), len(variants)

    reset()
    runs = []
    for _ in range(SBS_RUNS):
        (counts, n_snps, n_var), sec = synced_s(sbs_job)
        runs.append(sec)
    got = dict(zip([str(x) for x in counts.alphabet],
                   np.asarray(counts.counts).tolist()))
    (np_counts, np_snps), out["sbs96_numpy_s"] = synced_s(
        lambda: numpy_sbs96_job(vcf_path, ref_codes))
    if not (n_var == VCF_MEMBERS * VCF_RECORDS
            and n_snps == np_snps == VCF_MEMBERS * VCF_SNVS
            == VCF_MEMBERS * n_snv_member and set(got) == set(SBS96_LABELS)
            and all(got[label] == int(np_counts[b])
                    for b, label in enumerate(SBS96_LABELS))):
        raise AssertionError("the SBS96 job's 96-vector differs from the "
                             "numpy twin's")
    # the split: the same steps one by one, as count_mutation_types_genomic
    # runs them on the window_matrix path
    split = {}

    def lap(name, fn):
        res, split[name] = synced_s(fn)
        return res

    def read_parse():
        variants = bt.open(vcf_path).read()
        is_snp = np.asarray(variants.ref_seq.lengths == 1) & \
            np.asarray(variants.alt_seq.lengths == 1)
        return variants[is_snp]

    snps = lap("read_parse_s", read_parse)
    locations = lap("locations_s", lambda: genome.get_locations(
        bt.LocationEntry(snps.chromosome, snps.position)))
    kmers = lap("window_gather_s", lambda: sequence.window_matrix(
        locations.chromosome, np.asarray(locations.position), 1))
    hashes = lap("encode_s", lambda: encode_snps(
        kmers[~np.any(np.asarray(kmers == "N"), axis=-1)], snps.alt_seq,
        snps.ref_seq))
    split_counts = lap("count_s", lambda: count_encoded(hashes))
    if not np.array_equal(split_counts.counts, counts.counts):
        raise AssertionError("the split SBS96 steps differ from the job")
    del snps, locations, kmers, hashes
    best = min(runs)
    out["sbs96"] = {"runs_s": runs, "kvariants_per_s": n_snps / best / 1e3,
                    "n_variants": n_var, "n_snps": n_snps, "split": split}
    read_launches("sbs96")

    # (2) genomic intervals and tracks on phase 18's files
    reset()
    bed_path = os.path.join(workdir, "fragments.bed.gz")
    frng = np.random.default_rng(5)
    s21, e21 = fragments(frng, BED_INTERVALS, CHR21)
    s22, e22 = fragments(frng, BED_INTERVALS, CHR22)
    full, out["read_intervals_s"] = synced_s(
        lambda: genome.read_intervals(bed_path))
    track, out["get_pileup_s"] = synced_s(full.get_pileup)
    streamed, out["stream_pileup_s"] = synced_s(
        lambda: genome.read_intervals(bed_path, stream=True)
        .get_pileup().compute())
    host21 = ar.get_pileup(Interval(["chr21"] * BED_INTERVALS, s21, e21),
                           CHR21)
    for name, (st, sp) in (("chr21", (s21, e21)), ("chr22", (s22, e22))):
        a, b = track[name], streamed[name]
        if not (np.array_equal(a.events, b.events)
                and np.array_equal(a.values, b.values)
                and np.array_equal(a.to_array(),
                                   numpy_depth(st, sp, sizes[name]))):
            raise AssertionError(f"the genomic pileups of {name} differ "
                                 f"from each other or the recount")
    if not (np.array_equal(track["chr21"].events, host21.events)
            and np.array_equal(track["chr21"].values, host21.values)):
        raise AssertionError("the genomic pileup of chr21 differs from "
                             "arithmetics.get_pileup")
    n_runs = len(track._global_track.values)
    del track, streamed, host21
    on21, p_start, p_stop = seeded_peaks()
    peak_iv = Interval(np.where(on21, "chr21", "chr22").tolist(), p_start,
                       p_stop)
    j, out["geometry_jaccard_s"] = synced_s(
        lambda: Geometry(sizes).jaccard(full.data, peak_iv))
    if not j == phase18["jaccard"]:
        raise AssertionError(f"Geometry.jaccard {j!r} != phase 18's "
                             f"{phase18['jaccard']!r}")
    del full
    extracted, out["extract_intervals_s"] = synced_s(
        lambda: sequence.extract_intervals(peak_iv))
    want = np.concatenate([ref_codes["chr21" if o else "chr22"][a:b]
                           for o, a, b in zip(on21, p_start, p_stop)])
    if not (np.array_equal(extracted.lengths, p_stop - p_start)
            and np.array_equal(extracted.ravel().raw(), want)):
        raise AssertionError("GenomicSequence.extract_intervals differs "
                             "from numpy slicing")
    del extracted, want, peak_iv, sequence
    read_launches("intervals")

    # (3) the streamed fold on the card: one pass, three folds
    reset()
    go = GlobalOffset(sizes)
    n_bins = -(-CHR21 // 100)

    def upload(chunk):
        g = go.from_local_interval(chunk)
        return tuple(torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                     for a in (g.start, g.stop))

    def chunk_bins(ends):
        starts, stops = ends
        on_21 = starts < CHR21
        return binned_pileup(starts[on_21].int(), stops[on_21].int(),
                             torch.ones(int(on_21.sum()), dtype=torch.bool,
                                        device=dev), n_bins, 100)

    def run_fold():
        src = cg.StreamNode(bt.open(bed_path).read_chunks())
        ends = cg.ComputationNode(upload, [src])
        lengths = cg.ComputationNode(lambda e: e[1] - e[0], [ends])
        return cg.compute({
            "bins": cg.ReductionNode(cg.ComputationNode(chunk_bins, [ends]),
                                     cg.SUM),
            "bincount": cg.ReductionNode(cg.ComputationNode(
                torch.bincount, [lengths]), cg.Reduction(cg.BINCOUNT.combine)),
            "max": cg.ReductionNode(cg.ComputationNode(
                lambda x: x.amax().reshape(1), [lengths]), cg.MAX),
            "chunks": cg.ReductionNode(cg.ComputationNode(
                lambda e: 1, [ends]), cg.SUM)})

    fold, out["stream_fold_s"] = synced_s(run_fold)
    lengths = np.concatenate([e21 - s21, e22 - s22])
    want21 = numpy_bins(numpy_depth(s21, e21, CHR21), 100)
    if not all(isinstance(fold[k], torch.Tensor)
               and fold[k].device.type == dev.type == "cuda"
               for k in ("bins", "bincount", "max")):
        raise AssertionError("a streamed fold left the card")
    if not (np.array_equal(fold["bins"].cpu().numpy(),
                           phase18["bins_100_chr21"])
            and np.array_equal(fold["bins"].cpu().numpy(), want21)
            and np.array_equal(fold["bincount"].cpu().numpy(),
                               np.bincount(lengths))
            and int(fold["max"][0]) == int(lengths.max())):
        raise AssertionError("the streamed folds differ from "
                             "binned_pileup_bed's bins or numpy")
    out["stream_fold_chunks"] = fold["chunks"]
    del fold, lengths, want21, s21, e21, s22, e22
    read_launches("stream_fold")

    # (4) kernel 1 through the index layer
    prefix = seqs[:INDEX_READS]
    reset()
    lookup, out["kmer_lookup_create_s"] = synced_s(
        lambda: KmerLookup.create_lookup(prefix, k=K, device=dev))
    create_launches = kk.LAUNCHES["kmer_keys_kernel"]
    flat = np.asarray(prefix.ravel().raw())
    plen = np.asarray(prefix.lengths)
    h = numpy_kmer_hashes(flat, K)
    ends = np.cumsum(plen)
    row_of = np.repeat(np.arange(len(plen)), plen)
    inside = (np.repeat(ends, plen) - np.arange(len(flat)))[: len(h)] >= K
    h, row_of = h[inside], row_of[: len(inside)][inside]
    qrng = np.random.default_rng(SEED)
    q_rows = qrng.integers(0, INDEX_READS, INDEX_QUERIES)
    starts = np.concatenate([[0], ends[:-1]])
    q_pos = starts[q_rows] + (qrng.random(INDEX_QUERIES) *
                              (plen[q_rows] - K + 1)).astype(np.int64)
    queries = ["".join("ACGT"[c] for c in flat[p: p + K]) for p in q_pos]
    q_hash = numpy_kmer_hashes(flat[q_pos[:, None] + np.arange(K)].ravel(),
                               K)[:: K]
    sq = np.sort(q_hash)
    at = np.minimum(np.searchsorted(sq, h), len(sq) - 1)
    hit = sq[at] == h
    h, row_of = h[hit], row_of[hit]
    want_rows = {int(q): np.unique(row_of[h == q]) for q in sq}
    del h, row_of, inside, at, hit
    # the string queries, one launch each; the row sets by hash (a hash
    # query reads the index without a launch)
    kk.reset_launches()
    found, out["kmer_lookup_queries_s"] = synced_s(
        lambda: [lookup.get_sequences(q) for q in queries])
    query_launches = kk.LAUNCHES["kmer_keys_kernel"]
    for q, qh, seq in zip(queries, q_hash, found):
        rows = want_rows[int(qh)]
        got_rows = lookup._kmer_index.get_indices(int(qh))
        want_seq = prefix[rows]
        if not (np.array_equal(got_rows, rows) and q in seq[0].to_string()
                and np.array_equal(seq.lengths, want_seq.lengths)
                and np.array_equal(seq.ravel().raw(),
                                   want_seq.ravel().raw())):
            raise AssertionError(f"KmerLookup rows of {q} differ from the "
                                 f"recount")
    del flat, found
    if not (create_launches == 1 and query_launches == INDEX_QUERIES):
        raise AssertionError(f"kernel 1 launched {create_launches} times for "
                             f"create_index and {query_launches} for "
                             f"{INDEX_QUERIES} string queries")
    out["kmer_lookup_distinct"] = len(lookup._kmer_index._lookup)
    del lookup, prefix
    small = seqs[:DBG_READS]
    kk.reset_launches()
    graph, out["debruijn_build_s"] = synced_s(
        lambda: DeBruijnGraph.from_sequences(small, K, device=dev))
    dbg_launches = kk.LAUNCHES["kmer_keys_kernel"]
    contigs, out["debruijn_contigs_s"] = synced_s(graph.get_contigs)
    host = DeBruijnGraph.from_sequences(small, K, device="cpu")
    if not (dbg_launches == 1 and graph._kmer_set == host._kmer_set
            and contigs == host.get_contigs()):
        raise AssertionError("the de Bruijn graph on the card differs from "
                             "device='cpu'")
    out["debruijn_kmers"], out["debruijn_contigs"] = \
        len(graph._kmer_set), len(contigs)
    launches["index"] = {"kmer_keys_kernel": create_launches +
                         query_launches + dbg_launches,
                         "kmer_fullsum_kernel": kk.LAUNCHES[
                             "kmer_fullsum_kernel"],
                         "pwm_scores_kernel": pk.LAUNCHES["pwm_scores_kernel"]}
    torch.cuda.synchronize()
    peaks["index"] = torch.cuda.max_memory_allocated(dev)
    total = {name: sum(part[name] for part in launches.values())
             for name in ("kmer_keys_kernel", "kmer_fullsum_kernel",
                          "pwm_scores_kernel")}
    log(f"[genomic] exact: SBS96 over {n_var} variants / {n_snps} SNPs in "
        f"{best:.3f} s ({n_snps / best / 1e3:.1f} kvariants/s), pileups of "
        f"{2 * BED_INTERVALS} records ({n_runs} runs) whole and streamed, "
        f"jaccard {j!r}, {PEAKS} peaks extracted, {out['stream_fold_chunks']}"
        f"-chunk fold on the card, KmerLookup of {INDEX_READS} reads "
        f"({out['kmer_lookup_distinct']} 31-mers) with {INDEX_QUERIES} "
        f"queries, de Bruijn graph of {DBG_READS} reads "
        f"({out['debruijn_contigs']} contigs)")
    log("[genomic] " + json.dumps({**out, "peak_device_bytes": peaks,
                                   "launches": launches, "gpu": gpu_line()}))
    return total


# phase 20: the meshes, their overflow cap and the scaling sweep
MESH_SHARDS = 4               # the repeated-device mesh on the one card
MESH_OVERFLOW_CAP = 1 << 18   # a shard's distinct 31-mers overflow it
SCALING_SIZES = (1, 2, 4, 8)


def seeded_chr21() -> np.ndarray:
    """Phase 19's seeded chr21 codes (its generator's first draw)."""
    rng = np.random.default_rng(SEED + 19)
    return rng.integers(0, 4, CHR21).astype(np.uint8)


class _Records:
    """Collects the log records of one logger while active."""

    def __init__(self, name: str):
        import logging
        self.logger, self.messages = logging.getLogger(name), []
        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.messages.append(r.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def phase_mesh(dev, workdir: str, counts, stats, min_counts, motif):
    """The four pipelines' mesh= paths and the mesh steps on the card, on
    a mesh of the card (create_mesh(1)) and on MESH_SHARDS shards of it
    (create_mesh(4, devices=[cuda:0] * 4)), every result held to the
    single-device one of an earlier phase or of this call.  Per mesh:
    count_kmers_fastq over phase 4's file (warm-up + timed; phase 4's
    table and stats; kernel 1 once a shard a batch) and once more at a
    shard cap that overflows (the rerun logged, the same table);
    count_minimizers_fastq (phase 9's table); get_motif_matches_fastq
    over phase 5's file (phase 5's matches; kernel 3 once a shard a
    batch); binned_pileup_bed over phase 18's BED at 1000 (this call's
    single-device bins).  Then the histogram, sum-and-n and pileup steps
    over phase 18's chr21 fragments, and the halo k-mer and minimizer
    steps over the seeded chr21, 4 shards against 1; and
    scaling.measure on 1, 2, 4 and 8 shards of the card.  Prints each
    job's wall beside the single-device wall of the same call.  Returns
    the kernel launches of the mesh jobs."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import pwm_kernels as pk
    from bionumpy_tpu_torch.ops.tracks import dense_pileup
    from bionumpy_tpu_torch.parallel import (create_mesh, halo,
                                             sharded_histogram_step,
                                             sharded_pileup_step,
                                             sharded_sum_and_n_step)
    from bionumpy_tpu_torch.parallel.mesh import put_sharded
    from bionumpy_tpu_torch.parallel.scaling import measure
    path = os.path.join(workdir, "job.fq.gz")
    motif_path = os.path.join(workdir, "motif.fq.gz")
    bed_path = os.path.join(workdir, "fragments.bed.gz")
    sizes = {"chr21": CHR21, "chr22": CHR22}
    pwm, threshold, m_rows, m_offs = motif
    meshes = {"mesh1": create_mesh(1),
              f"mesh{MESH_SHARDS}": create_mesh(MESH_SHARDS,
                                                devices=[dev] * MESH_SHARDS)}
    walls, launches, batches, splits, idle = {}, {}, {}, {}, {}

    def same_table(got, want, what):
        if not (np.array_equal(got.label_codes, want.label_codes)
                and np.array_equal(got.counts, want.counts)):
            raise AssertionError(f"{what}: the table differs")

    def timed(job, name, fn, warm=True):
        """fn's result and wall (after one warm-up call when `warm`), its
        launches and mesh-step calls."""
        if warm:
            fn()
        bt.instrument.reset()
        kk.reset_launches()
        pk.reset_launches()
        out, s = synced_s(fn)
        walls.setdefault(job, {})[name] = s
        launches.setdefault(job, {})[name] = {**kk.LAUNCHES, **pk.LAUNCHES}
        stages = bt.instrument.report()
        batches.setdefault(job, {})[name] = stages.get(
            "mesh-step", {}).get("calls", 0)
        splits.setdefault(job, {})[name] = {
            k: v["seconds"] for k, v in stages.items()}
        return out

    def per_shard(job, name, kernel, n_dev):
        n, got = batches[job][name], launches[job][name][kernel]
        if got != n * n_dev or not n:
            raise AssertionError(f"{job} on {name}: {kernel} launched {got} "
                                 f"times for {n} batches of {n_dev} shards")

    # single-device walls of the same call
    timed("kmers", "single", lambda: bt.count_kmers_fastq(
        path, K, cap=1 << 21, device_parse=False, device=dev), warm=False)
    timed("minimizers", "single", lambda: bt.count_minimizers_fastq(
        path, MIN_K, MIN_WINDOW, device=dev), warm=False)
    timed("motif", "single", lambda: bt.get_motif_matches_fastq(
        motif_path, pwm, threshold, device=dev), warm=False)
    single_bins = timed("binned_pileup_bed", "single",
                        lambda: bt.binned_pileup_bed(bed_path, sizes, 1000,
                                                     device=dev), warm=False)
    overflow = {}
    for name, mesh in meshes.items():
        n_dev = int(mesh.devices.size)
        got, got_stats = timed("kmers", name, lambda: bt.count_kmers_fastq(
            path, K, cap=1 << 21, mesh=mesh))
        same_table(got, counts, f"count_kmers_fastq on {name}")
        if got_stats != stats:
            raise AssertionError(f"{name}: stats {got_stats} != {stats}")
        per_shard("kmers", name, "kmer_keys_kernel", n_dev)
        prof = profile_job(lambda: bt.count_kmers_fastq(
            path, K, cap=1 << 21, mesh=mesh), f"mesh kmers {name}")
        idle[name] = prof.get("device_idle_share")
        with _Records("bionumpy_tpu_torch.pipeline") as logged:
            got, _ = timed("kmers_overflow", name, lambda: bt.count_kmers_fastq(
                path, K, cap=MESH_OVERFLOW_CAP, acc_cap=1 << 23, mesh=mesh),
                warm=False)
        reruns = [m for m in logged if "shard table overflow" in m]
        if len(reruns) != 1:
            raise AssertionError(f"{name}: {len(reruns)} reruns logged at "
                                 f"cap {MESH_OVERFLOW_CAP}")
        overflow[name] = reruns[0]
        same_table(got, counts, f"the overflow rerun on {name}")
        got, _ = timed("minimizers", name, lambda: bt.count_minimizers_fastq(
            path, MIN_K, MIN_WINDOW, mesh=mesh))
        same_table(got, min_counts, f"count_minimizers_fastq on {name}")
        per_shard("minimizers", name, "kmer_keys_kernel", n_dev)
        rows, offs, _ = timed("motif", name, lambda: bt.get_motif_matches_fastq(
            motif_path, pwm, threshold, mesh=mesh))
        if not (np.array_equal(rows, m_rows) and np.array_equal(offs, m_offs)):
            raise AssertionError(f"the motif matches on {name} differ from "
                                 f"phase 5's")
        per_shard("motif", name, "pwm_scores_kernel.match", n_dev)
        bins, _ = timed("binned_pileup_bed", name, lambda: bt.binned_pileup_bed(
            bed_path, sizes, 1000, mesh=mesh))
        if not all(np.array_equal(bins[c], single_bins[0][c]) for c in sizes):
            raise AssertionError(f"binned_pileup_bed on {name} differs")
    torch.cuda.empty_cache()

    # the reduction steps over phase 18's chr21 fragments, 4 shards vs 1
    rng = np.random.default_rng(5)
    s21, e21 = fragments(rng, BED_INTERVALS, CHR21)
    lengths = (e21 - s21).astype(np.float32)
    edges = torch.arange(100, 601, 50, dtype=torch.float32, device=dev)
    steps = {}
    for name, mesh in meshes.items():
        n_dev = int(mesh.devices.size)

        def shards(a):
            return put_sharded(mesh, a.reshape(n_dev, -1))
        valid = np.ones(BED_INTERVALS, bool)
        hist, walls.setdefault("histogram", {})[name] = synced_s(
            lambda: sharded_histogram_step(mesh, 10)(
                shards(lengths), shards(valid), edges))
        (s, n), walls.setdefault("sum_and_n", {})[name] = synced_s(
            lambda: sharded_sum_and_n_step(mesh)(shards(lengths),
                                                 shards(valid)))
        depth, walls.setdefault("pileup", {})[name] = synced_s(
            lambda: sharded_pileup_step(mesh, CHR21)(
                shards(s21.astype(np.int32)), shards(e21.astype(np.int32)),
                shards(valid)))
        steps[name] = (hist.cpu(), float(s), int(n), depth.cpu())
        del depth
    one, many = steps["mesh1"], steps[f"mesh{MESH_SHARDS}"]
    want_hist = np.histogram(lengths, bins=np.arange(100, 601, 50))[0]
    want_depth = dense_pileup(
        torch.from_numpy(s21.astype(np.int32)).to(dev),
        torch.from_numpy(e21.astype(np.int32)).to(dev),
        torch.ones(BED_INTERVALS, dtype=torch.bool, device=dev), CHR21).cpu()
    if not (np.array_equal(one[0].numpy(), want_hist)
            and torch.equal(one[0], many[0])
            and one[2] == many[2] == BED_INTERVALS
            and abs(many[1] - one[1]) <= 1e-5 * abs(one[1])
            and abs(one[1] - float(lengths.sum(dtype=np.float64)))
            <= 1e-5 * abs(one[1])
            and torch.equal(one[3], want_depth)
            and torch.equal(many[3], want_depth)):
        raise AssertionError("a reduction step on 4 shards differs from 1 "
                             "shard or from the recount")
    del s21, e21, lengths, steps, one, many, want_depth

    # the halo steps over the seeded chr21, 4 shards vs 1
    codes = seeded_chr21()
    halo_keys = {}
    kk.reset_launches()
    for label, make in (("halo_kmers", lambda m: halo.sharded_kmer_hash_step(
                            m, K)),
                        ("halo_minimizers", lambda m: halo.sharded_minimizer_step(
                            m, MIN_K, MIN_WINDOW))):
        for name, mesh in meshes.items():
            blocks, n_true = halo.shard_long_sequence(
                codes, int(mesh.devices.size))
            step = make(mesh)

            def run():
                lo, hi, valid = step(put_sharded(mesh, blocks), n_true)
                return torch.cat([(a | (b << 32))[v]
                                  for a, b, v in zip(lo, hi, valid)])
            keys, walls.setdefault(label, {})[name] = synced_s(run)
            halo_keys[label, name] = keys
        if not torch.equal(halo_keys[label, "mesh1"],
                           halo_keys[label, f"mesh{MESH_SHARDS}"]):
            raise AssertionError(f"{label}: 4 shards differ from 1")
    n_windows = {label: int(halo_keys[label, "mesh1"].numel())
                 for label in ("halo_kmers", "halo_minimizers")}
    if n_windows != {"halo_kmers": CHR21 - K + 1,
                     "halo_minimizers": CHR21 - MIN_WINDOW + 1}:
        raise AssertionError(f"halo windows {n_windows}")
    halo_launches = kk.LAUNCHES["kmer_keys_kernel"]
    del halo_keys, codes
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    scaling = measure(SCALING_SIZES, n_bases=1 << 24, cap=1 << 18, iters=3,
                      devices=[dev] * max(SCALING_SIZES))
    walls["scaling_s"] = time.perf_counter() - t0
    log(f"[mesh] exact on 1 and {MESH_SHARDS} shards: count_kmers_fastq "
        f"(and its overflow rerun), count_minimizers_fastq, "
        f"get_motif_matches_fastq, binned_pileup_bed; the histogram, "
        f"sum-and-n and pileup steps; the halo steps over {CHR21} bases "
        f"({halo_launches} kernel-1 launches)")
    log("[mesh] " + json.dumps({"walls_s": walls, "launches": launches,
                                "mesh_steps": batches, "reruns": overflow,
                                "kmers_device_idle_share": idle,
                                "gpu": gpu_line()}))
    log("[mesh] stages_s " + json.dumps(splits))
    for rec in scaling:
        log("[mesh] scaling " + json.dumps(rec))
    out = {name: {kernel: sum(launches[job][name][kernel]
                              for job in ("kmers", "minimizers", "motif"))
                  for kernel in ("kmer_keys_kernel", "pwm_scores_kernel",
                                 "pwm_scores_kernel.match")}
           for name in meshes}
    return out


def phase_simulate(dev):
    """simulate_chip_seq_reads over the seeded chr21 (46,709,983 bases)
    with a seeded w = 11 motif at the settings' default coverage: kernel 3
    scores the whole chromosome once; under one seed the reads equal
    those of the same call with device="cpu" (kernel 3's plain version),
    whose window scores equal the card's bit for bit.  Then
    simulate_sequences -> get_reverse_complement -> count_kmers, on the
    card and on the CPU, as tests/test_user_flows.py chains them.
    Returns kernel 3's launches in the card's simulation."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import pwm_kernels as pk
    from bionumpy_tpu_torch.simulate import chipseq
    ref = bt.EncodedArray(seeded_chr21(), bt.DNAEncoding)
    pwm = pwm_matrix(SEED, MOTIF_WINDOW)
    settings = chipseq.ChipSeqSimulationSettings(pwm)
    out, reads = {}, {}
    for device in (dev, "cpu"):
        chipseq.rng = np.random.default_rng(SEED + 21)
        pk.reset_launches()
        t0 = time.perf_counter()
        reads[str(device)] = bt.simulate.simulate_chip_seq_reads(
            ref, settings, sequence_name="chr21", device=device)
        out[f"simulate_chip_seq_reads_{device}_s"] = \
            time.perf_counter() - t0
        out[f"launches_{device}"] = dict(pk.LAUNCHES)
    launches = out[f"launches_{dev}"]["pwm_scores_kernel"]
    if launches != 1 or out["launches_cpu"]["pwm_scores_kernel"]:
        raise AssertionError(f"pwm_scores_kernel launched {launches} times "
                             f"for one chromosome on the card")
    card, cpu = reads[str(dev)], reads["cpu"]
    n_reads = settings.coverage * CHR21 // settings.read_length
    if not (len(card) == len(cpu) == n_reads and all(
            np.array_equal(np.asarray(getattr(card, f)),
                           np.asarray(getattr(cpu, f)))
            for f in ("start", "stop")) and
            card.strand.tolist() == cpu.strand.tolist() and
            card.chromosome[:3].tolist() == ["chr21"] * 3):
        raise AssertionError("the simulated reads differ between the card's "
                             "and the CPU's scores")
    scores = {str(d): chipseq._window_scores(ref, pwm, d)
              for d in (dev, "cpu")}
    if not np.array_equal(scores[str(dev)], scores["cpu"]):
        raise AssertionError("get_motif_scores on the card differs from its "
                             "plain version")
    del reads, card, cpu, scores
    rng = np.random.default_rng(1)
    sim = bt.simulate.simulate_sequences(
        "ACGT", {f"s{i}": int(n)
                 for i, n in enumerate(rng.integers(40, 60, 20))}, rng=rng)
    rc = bt.get_reverse_complement(sim.sequence)
    kk.reset_launches()
    chained = [bt.count_kmers(bt.as_encoded_array(rc.tolist(),
                                                  bt.DNAEncoding), 5,
                              device=d) for d in (dev, "cpu")]
    if not np.array_equal(chained[0].counts, chained[1].counts) or \
            kk.LAUNCHES["kmer_keys_kernel"] != 1:
        raise AssertionError("the simulate -> reverse complement -> "
                             "count_kmers chain differs on the card")
    log(f"[simulate] exact: {n_reads} ChIP-seq reads over {CHR21} bases, "
        f"kernel 3 launched {launches} time(s); the simulate -> reverse "
        f"complement -> count_kmers chain")
    log("[simulate] " + json.dumps({**out, "gpu": gpu_line()}))
    return {"pwm_scores_kernel": launches,
            "kmer_keys_kernel": kk.LAUNCHES["kmer_keys_kernel"]}


def phase_table_passes(dev):
    """A table's passes at full size (ops/kmers.table_passes over two
    resident blocks, each of ~0.56 G seeded bases in rows of up to 60 M):
    kernel 1 over each pass's words (ops/kmers._pass_keys) equals its
    plain version on the same words and ends, and the whole block's keys
    at the pass's positions, with the sentinel before and after them;
    blocked_table of the minimizers (k=15, 24-base windows) launches
    kmer_keys once a pass and counts every window once.  Returns the
    launches of blocked_table."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch import instrument
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    from bionumpy_tpu_torch.ops import kmers, resident
    from bionumpy_tpu_torch.ops.minimizers import minimizer_keys_masked
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 22)
    blocks, all_lengths = [], []
    for _ in range(2):
        lengths = rng.integers(1, 60_000_000, 19)
        lengths[3] = 20  # a row shorter than a window
        flat = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
        blocks.append(resident.device_seqs(bt.EncodedRaggedArray(
            bt.EncodedArray(flat, bt.DNAEncoding), lengths), dev))
        all_lengths.append(lengths)
        del flat
    passes = kmers.table_passes(blocks)
    offsets = [p[3] % kk.WORD_BASES for p in passes]
    log(f"[table-passes] {sum(ds.n for ds in blocks)} bases in "
        f"{len(blocks)} blocks (made in {time.perf_counter() - t0:.1f} s); "
        f"{len(passes)} passes of {[p[4] - p[3] for p in passes]} bases, "
        f"first bases at {offsets} mod {kk.WORD_BASES}")
    if len(passes) < 2 * len(blocks) or not any(offsets):
        raise AssertionError("the blocks make too few passes, or none "
                             "starting inside a word")

    def raw_keys(k, seen):
        def keys_of(words, ends, n_true):
            keys = kk.kmer_keys(words, ends, k, n_true)
            seen.append((words, ends, n_true, keys.clone()))
            return keys
        return keys_of

    plain_checked = 0
    for ds in blocks:
        whole = kk.kmer_keys(ds.words, ds.ends, K, ds.n)
        for p in (p for p in passes if p[0] is ds):
            seen = []
            got = kmers._pass_keys(p, raw_keys(K, seen))
            words, ends, n_true, raw = seen[0]
            off, size = p[3] % kk.WORD_BASES, p[4] - p[3]
            if not (torch.equal(got[off: off + size], whole[p[3]: p[4]])
                    and bool((got[:off] == SENTINEL).all())
                    and bool((got[off + size:] == SENTINEL).all())):
                raise AssertionError(f"the keys of pass {p[1:]} differ "
                                     f"from the whole block's")
            if off and plain_checked < 2:
                for k in (K, 15):
                    if k != K:
                        seen = []
                        kmers._pass_keys(p, raw_keys(k, seen))
                        words, ends, n_true, raw = seen[0]
                    ref = kk.kmer_keys_plain(words, ends, k, n_true)
                    if not torch.equal(raw, ref):
                        raise AssertionError(
                            f"kmer_keys_kernel differs from its plain "
                            f"version over pass {p[1:]} at "
                            f"{int((raw != ref).sum())} positions (k={k})")
                    del ref
                plain_checked += 1
            del got, raw, seen
        del whole
    if plain_checked < 2:
        raise AssertionError("no two passes starting inside a word")
    log(f"[table-passes] exact: every pass's keys equal the whole "
        f"block's at k={K}, and kernel 1 its plain version over "
        f"{plain_checked} passes starting inside a word (k={K}, 15)")

    def min_keys(words, ends, n_true):
        return minimizer_keys_masked(words, ends, n_true, 15, 10)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the checks' blocks back before the folds
    torch.cuda.reset_peak_memory_stats(dev)
    kk.reset_launches()
    instrument.reset()
    t0 = time.perf_counter()
    keys, counts = kmers.blocked_table(passes, min_keys, 1 << 28)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kk.LAUNCHES)
    rep = instrument.report()
    windows = sum(int(np.maximum(n - 23, 0).sum()) for n in all_lengths)
    if launches["kmer_keys_kernel"] != len(passes):
        raise AssertionError(f"{launches['kmer_keys_kernel']} kmer_keys "
                             f"launches for {len(passes)} passes")
    if int(counts.sum()) != windows or not bool((keys[1:] > keys[:-1]).all()):
        raise AssertionError("the folded minimizer table does not count "
                             "every window once in rising keys")
    log("[table-passes] " + json.dumps({
        "passes": len(passes), "rows": keys.numel(), "windows": windows,
        "folds": rep["table-fold"]["calls"],
        "fold_rows": rep["table-fold"]["rows"],
        "cap_reruns": rep.get("cap-rerun", {}).get("calls", 0),
        "wall_s": wall, "launches": launches,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "gpu": gpu_line()}))
    return launches


def run_phase(name: str, phase, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[phase] {name} {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import bionumpy_tpu_torch  # noqa: F401  (fails outside a checkout)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    log(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(gpu_line())
    run_phase("build", phase_build)
    rows = run_phase("kernels", phase_kernels, dev)
    from bionumpy_tpu_torch.ops._build import BUILD_DIR
    workdir = os.path.join(BUILD_DIR, "smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        job_launches, counts, stats, stages, variants, lengths = run_phase(
            "job", phase_job, dev, workdir)
        parse_launches, auto_launches = run_phase(
            "device-parse", phase_device_parse, dev, workdir, counts, stats,
            stages)
        motif_launches, motif, motif_wall = run_phase(
            "motif", phase_motif, dev, workdir, variants, lengths)
        mfq_launches, min_counts = run_phase(
            "minimizers-fastq", phase_minimizers_fastq, dev, workdir,
            variants, lengths)
        op_rows = [run_phase("composition", phase_composition, dev, workdir,
                             variants, lengths)]
        api_launches, seqs, c31 = run_phase("user-api", phase_user_api, dev,
                                            variants, lengths)
        enc_launches, matches = run_phase(
            "motif-encoded", phase_motif_encoded, dev, seqs, motif, variants,
            lengths)
        open_launches, open_large_launches = run_phase(
            "open-fastq", phase_open_fastq, dev, workdir, lengths, c31,
            matches, motif, motif_wall)
        del matches
        sum_launches = run_phase("checksum", phase_checksum, dev, counts,
                                 variants, lengths)
        gc_launches, chunked_launches, gc_result = run_phase(
            "minimizers-gc", phase_minimizers_gc, dev)
        config3_launches = run_phase("open-config3", phase_open_config3, dev,
                                     workdir, gc_result)
        del gc_result
        row, reads, proteins = run_phase("translate", phase_translate, dev,
                                         variants, lengths)
        op_rows.append(row)
        records_launches = run_phase("open-records", phase_open_records, dev,
                                     workdir, reads, proteins)
        del reads, proteins
        interval_launches, pileup_rows, phase18 = run_phase(
            "intervals", phase_intervals, dev, workdir, seqs, c31)
        op_rows += pileup_rows
        del c31
        genomic_launches = run_phase("genomic", phase_genomic, dev, workdir,
                                     seqs, phase18)
        del seqs, phase18
        mesh_launches = run_phase("mesh", phase_mesh, dev, workdir, counts,
                                  stats, min_counts, motif)
        del min_counts
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    ops_launches = run_phase("kmer-ops", phase_kmer_ops, dev,
                             batch_inputs(SEED))
    sim_launches = run_phase("simulate", phase_simulate, dev)
    table_launches = run_phase("table-passes", phase_table_passes, dev)
    rows[0]["launches"] = job_launches["kmer_keys_kernel"]
    rows[0]["launches_by_path"] = {
        "job": job_launches["kmer_keys_kernel"],
        "device_parse": parse_launches["kmer_keys_kernel"],
        "device_parse_auto": auto_launches["kmer_keys_kernel"],
        "user_api": api_launches["kmer_keys_kernel"],
        "minimizers_gc": gc_launches["kmer_keys_kernel"],
        "minimizers_gc_4_chunks": chunked_launches["kmer_keys_kernel"],
        "minimizers_fastq": mfq_launches["kmer_keys_kernel"],
        "kmer_ops": ops_launches["kmer_keys_kernel"],
        "open_fastq": open_launches["kmer_keys_kernel"],
        "open_fastq_large_chunks": open_large_launches["kmer_keys_kernel"],
        "open_config3": config3_launches["kmer_keys_kernel"],
        "open_records": records_launches["kmer_keys_kernel"],
        "intervals": interval_launches["kmer_keys_kernel"],
        "genomic": genomic_launches["kmer_keys_kernel"],
        **{f"{name}_jobs": n["kmer_keys_kernel"]
           for name, n in mesh_launches.items()},
        "simulate": sim_launches["kmer_keys_kernel"],
        "table_passes": table_launches["kmer_keys_kernel"]}
    rows[1]["launches"] = sum_launches["kmer_fullsum_kernel"]
    rows[1]["launches_by_path"] = {
        "checksum": sum_launches["kmer_fullsum_kernel"],
        "kmer_ops": ops_launches["kmer_fullsum_kernel"],
        "intervals": interval_launches["kmer_fullsum_kernel"],
        "genomic": genomic_launches["kmer_fullsum_kernel"],
        "mesh": 0, "simulate": 0, "table_passes": 0}
    def pwm(n):  # both modes of kernel 3
        return n["pwm_scores_kernel"] + n.get("pwm_scores_kernel.match", 0)
    rows[2]["launches"] = pwm(motif_launches)
    rows[2]["launches_by_path"] = {
        "motif": pwm(motif_launches),
        "motif_encoded": pwm(enc_launches),
        "open_fastq": pwm(open_launches),
        "open_fastq_large_chunks": pwm(open_large_launches),
        "open_records": pwm(records_launches),
        "intervals": pwm(interval_launches),
        "genomic": pwm(genomic_launches),
        **{f"{name}_jobs": pwm(n) for name, n in mesh_launches.items()},
        "simulate": sim_launches["pwm_scores_kernel"]}
    print(json.dumps({"torch_ops": op_rows}))
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
