"""The plain reference and the comparison that decides `correct`.

Plain PyTorch (on the card after the window, on the CPU in the tests),
worked out from the codes and row lengths the generator made.  It
imports nothing of the program under test.

A k-mer's hash is sum(code[s + j] << 2j) over j < k; a minimizer is the
least k-mer hash over the window - k + 1 k-mers of a window of
`window` bases, counted once per window; windows and k-mers count only
where they lie inside their row.  GC bins count C and G codes (1, 2)
in every `bin_size` bases of the rows laid end to end.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK_BASES = 1 << 27  # bases hashed at once


def row_blocks(lengths: np.ndarray, block: int = BLOCK_BASES):
    """(base start, base end) of runs of whole rows of about `block`
    bases each."""
    ends = np.cumsum(np.asarray(lengths, np.int64))
    start, r0 = 0, 0
    while r0 < len(ends):
        r1 = max(int(np.searchsorted(ends, start + block, side="right")),
                 r0 + 1)
        yield start, int(ends[r1 - 1])
        start, r0 = int(ends[r1 - 1]), r1


def kmer_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64 hash of the k-mer at every start 0..n-k: hashes of
    power-of-two lengths joined by shifts, one pass per doubling and per
    set bit of k."""
    powers = {1: codes.to(torch.int64)}
    p = 1
    while 2 * p <= k:
        h = powers[p]
        powers[2 * p] = h[:-p] | (h[p:] << (2 * p))
        p *= 2
    n = codes.numel() - k + 1
    out, offset = None, 0
    for p in sorted(powers, reverse=True):
        if k - offset >= p:
            part = powers[p][offset: offset + n] << (2 * offset)
            out = part if out is None else out | part
            offset += p
    return out


def inside_rows(lengths: np.ndarray, n: int, span: int,
                device) -> torch.Tensor:
    """Bool over the starts 0..n-1: a span of `span` bases from there
    lies inside its row."""
    lengths = torch.as_tensor(np.asarray(lengths, np.int64), device=device)
    ends = torch.cumsum(lengths, 0)
    left = torch.repeat_interleave(ends, lengths) - torch.arange(
        int(ends[-1]), device=device)
    return left[:n] >= span


def window_values(flat: np.ndarray, lengths: np.ndarray, k: int,
                  window: int, device) -> torch.Tensor:
    """int64 value of every window inside its row, block by block: the
    k-mer hash (window == k) or the least of the window's k-mer hashes."""
    out = []
    cum = np.concatenate([[0], np.cumsum(lengths)])
    for lo, hi in row_blocks(lengths):
        rows = slice(int(np.searchsorted(cum, lo)),
                     int(np.searchsorted(cum, hi)))
        codes = torch.as_tensor(flat[lo:hi], device=device)
        if codes.numel() < window:
            continue
        m = kmer_hashes(codes, k)
        span, n_kmers = 1, window - k + 1
        while span < n_kmers:
            step = min(span, n_kmers - span)
            m = torch.minimum(m[:-step], m[step:])
            span += step
        out.append(m[inside_rows(lengths[rows], m.numel(), window,
                                 device)])
    if not out:
        return torch.empty(0, dtype=torch.int64, device=device)
    return torch.cat(out)


def count_table(values: torch.Tensor):
    """(sorted distinct int64 values, int64 counts)."""
    keys, _ = torch.sort(values)
    return torch.unique_consecutive(keys, return_counts=True)


def kmer_table(flat, lengths, k: int, device):
    return count_table(window_values(flat, lengths, k, k, device))


def minimizer_table(flat, lengths, k: int, window: int, device):
    return count_table(window_values(flat, lengths, k, window, device))


def gc_bins(flat: np.ndarray, bin_size: int, device) -> torch.Tensor:
    codes = torch.as_tensor(flat, device=device)
    gc = ((codes == 1) | (codes == 2)).to(torch.int64)
    pad = -gc.numel() % bin_size
    return torch.nn.functional.pad(gc, (0, pad)).view(-1, bin_size).sum(1)


def fingerprint_control(keys: torch.Tensor, counts: torch.Tensor,
                        bits: int = 32):
    """The control: the same table counted under `bits`-bit keys, as a
    table keyed by a hash fingerprint would count it.  Rows whose keys
    share their low `bits` bits merge into one row, labelled with the
    least full key, with their counts summed."""
    fp = keys & ((1 << bits) - 1)
    order = torch.argsort(fp, stable=True)
    fp, keys, counts = fp[order], keys[order], counts[order]
    _, inverse, n_rows = torch.unique_consecutive(
        fp, return_inverse=True, return_counts=True)
    first = torch.cumsum(n_rows, 0) - n_rows
    merged = torch.zeros(n_rows.numel(), dtype=counts.dtype,
                         device=counts.device).index_add_(0, inverse, counts)
    label = keys[first]
    order = torch.argsort(label)
    return label[order], merged[order]


def rows_differing(keys_a, counts_a, keys_b, counts_b) -> int:
    """Rows of two (sorted distinct key, count) tables that the other
    lacks: len(a) + len(b) - 2 * |rows equal in key and count|."""
    if keys_a.numel() == 0 or keys_b.numel() == 0:
        return int(keys_a.numel() + keys_b.numel())
    at = torch.searchsorted(keys_b, keys_a).clamp_(max=keys_b.numel() - 1)
    same = int(((keys_b[at] == keys_a) & (counts_b[at] == counts_a)).sum())
    return int(keys_a.numel() + keys_b.numel() - 2 * same)


def as_keys(label_codes: np.ndarray, device) -> torch.Tensor:
    """A table's uint64 labels as the int64 keys the reference sorts (no
    k <= 31 hash reaches the sign bit)."""
    return torch.as_tensor(np.ascontiguousarray(label_codes).view(np.int64),
                           device=device)


DIGEST_STRIDE = 1024  # every this many rows enter a job's digest


def digest(table: dict) -> tuple:
    """(rows, sum of every DIGEST_STRIDE-th key, sum of those rows'
    counts), sums mod 2^64, of an output's or a reference's table: the
    summary every job of the window is held to, cheap enough to take as
    each job returns."""
    keys = table["keys"][::DIGEST_STRIDE]
    counts = table["counts"][::DIGEST_STRIDE]
    if isinstance(keys, torch.Tensor):
        keys, counts = keys.cpu().numpy(), counts.cpu().numpy()
    return (len(table["keys"]),
            int(keys.astype(np.uint64).sum(dtype=np.uint64)),
            int(counts.astype(np.uint64).sum(dtype=np.uint64)))


def compare_output(out: dict, ref: dict, device) -> dict:
    """The numbers compared between a job's output and the reference:
    table rows that differ, stats that differ, GC bins that differ (a
    bin missing on one side counts as differing)."""
    keys = as_keys(out["keys"], device)
    counts = torch.as_tensor(np.asarray(out["counts"], np.int64),
                             device=device)
    res = {"rows_differing": rows_differing(keys, counts, ref["keys"],
                                            ref["counts"])}
    if "stats" in ref:
        res["stats_differing"] = sum(
            out["stats"].get(name) != value
            for name, value in ref["stats"].items())
    if "gc_bins" in ref:
        got = torch.as_tensor(np.asarray(out["gc_bins"], np.int64),
                              device=device)
        want = ref["gc_bins"]
        n = min(got.numel(), want.numel())
        res["gc_bins_differing"] = int((got[:n] != want[:n]).sum()) + \
            abs(got.numel() - want.numel())
    return res
