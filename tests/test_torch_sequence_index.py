"""The rest of the port's sequence/ against the JAX package's, on the
CPU: k-mer and wildcard indexes (sequence/indexing), de Bruijn graphs
(sequence/debruijn), string matching (match_string and the regex
matchers) and bloom filters, on seeded sequences.  The k-mer paths take
device="cpu", where get_kmers runs kernel 1's plain version; their
default (None) is the card, which raises here.  Outputs are compared by
value and dtype, exactly."""
import numpy as np
import pytest
import torch

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu.sequence import bloom_filter as jbloom
from bionumpy_tpu.sequence import debruijn as jdbg
from bionumpy_tpu.sequence import string_matcher as jsm
from bionumpy_tpu.sequence.indexing import (KmerIndex as JKmerIndex,
                                            KmerLookup as JKmerLookup,
                                            WildCardIndex as JWildCardIndex,
                                            WildCardLookup as JWildCardLookup)
from bionumpy_tpu_torch.sequence import bloom_filter as tbloom
from bionumpy_tpu_torch.sequence import debruijn as tdbg
from bionumpy_tpu_torch.sequence import string_matcher as tsm
from bionumpy_tpu_torch.sequence.indexing import (
    KmerIndex as TKmerIndex, KmerLookup as TKmerLookup,
    WildCardIndex as TWildCardIndex, WildCardLookup as TWildCardLookup)
from test_torch_genomic_data import assert_same

SEEDS = [0, 1, 2]
CPU = {"device": "cpu"}


def seeded_reads(seed, n=30, low=3, high=40, repeat=True):
    """Seeded DNA reads, some shorter than k, with shared stretches so
    that k-mers recur across reads."""
    rng = np.random.default_rng(seed)
    motif = "".join(rng.choice(list("ACGT"), 12))
    out = []
    for i in range(n):
        read = "".join(rng.choice(list("ACGT"), int(rng.integers(low, high))))
        if repeat and i % 3 == 0:
            cut = int(rng.integers(0, len(read) + 1))
            read = read[:cut] + motif + read[cut:]
        out.append(read)
    return out


def sample_kmers(reads, k, seed, n=12):
    rng = np.random.default_rng(seed)
    long = [r for r in reads if len(r) >= k]
    out = []
    for _ in range(n):
        r = long[int(rng.integers(0, len(long)))]
        s = int(rng.integers(0, len(r) - k + 1))
        out.append(r[s: s + k])
    return out + ["A" * k]  # absent in most seeds: the empty row set


def _lookup_items(index):
    return sorted((k, v.tolist(), v.dtype.str)
                  for k, v in index._lookup.items())


# -- k-mer index --------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 5, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_kmer_index(seed, k):
    reads = seeded_reads(seed)
    t_seqs = tbnp.as_encoded_array(reads, tbnp.DNAEncoding)
    j_seqs = jbnp.as_encoded_array(reads, jbnp.DNAEncoding)
    t_idx = TKmerIndex.create_index(t_seqs, k, device="cpu")
    j_idx = JKmerIndex.create_index(j_seqs, k)
    assert _lookup_items(t_idx) == _lookup_items(j_idx)
    assert t_idx.k == k and repr(t_idx) == repr(j_idx)
    for kmer in sample_kmers(reads, k, seed):
        assert_same(t_idx.get_indices(kmer), j_idx.get_indices(kmer))
    for code in list(j_idx._lookup)[:5]:
        assert_same(t_idx.get_indices(code), j_idx.get_indices(code))


@pytest.mark.parametrize("seed", SEEDS)
def test_kmer_lookup(seed):
    reads = seeded_reads(seed, n=50)
    k = 6
    t_look = TKmerLookup.create_lookup(
        tbnp.as_encoded_array(reads, tbnp.DNAEncoding), k=k, device="cpu")
    j_look = JKmerLookup.create_lookup(
        jbnp.as_encoded_array(reads, jbnp.DNAEncoding), k=k)
    assert repr(t_look) == repr(j_look)
    for kmer in sample_kmers(reads, k, seed + 5):
        got = t_look.get_sequences(kmer)
        assert_same(got, j_look.get_sequences(kmer))
        rows = [i for i, r in enumerate(reads) if kmer in r]
        assert [str(s) for s in got.tolist()] == [reads[i] for i in rows]


def test_kmer_index_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    seqs = tbnp.as_encoded_array(["ACGTACGT"], tbnp.DNAEncoding)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TKmerIndex.create_index(seqs, 3)
    idx = TKmerIndex.create_index(seqs, 3, device="cpu")
    card = TKmerIndex(3, idx._lookup, seqs.encoding)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        card.get_indices("ACG")


@pytest.mark.parametrize("seed", SEEDS)
def test_wildcard_index(seed):
    reads = seeded_reads(seed, n=40, low=1)
    t_look = TWildCardLookup.create_lookup(
        tbnp.as_encoded_array(reads, tbnp.DNAEncoding))
    j_look = JWildCardLookup.create_lookup(
        jbnp.as_encoded_array(reads, jbnp.DNAEncoding))
    assert repr(t_look) == repr(j_look)
    t_idx = TWildCardIndex.create_index(
        tbnp.as_encoded_array(reads, tbnp.DNAEncoding))
    j_idx = JWildCardIndex.create_index(
        jbnp.as_encoded_array(reads, jbnp.DNAEncoding))
    rng = np.random.default_rng(seed)
    for kmer in sample_kmers(reads, 6, seed, n=8):
        holes = rng.random(len(kmer)) < 0.3
        holes[0] = False
        pattern = "".join("." if h else c for h, c in zip(holes, kmer))
        assert_same(t_idx.get_indices(pattern), j_idx.get_indices(pattern))
        assert_same(t_look.get_sequences(pattern),
                    j_look.get_sequences(pattern))


# -- de Bruijn graphs ---------------------------------------------------------

@pytest.mark.parametrize("k", [3, 5, 9])
@pytest.mark.parametrize("seed", SEEDS)
def test_debruijn_graph(seed, k):
    reads = seeded_reads(seed, n=12, low=k, high=30)
    t_g = tdbg.DeBruijnGraph.from_sequences(reads, k, **CPU)
    j_g = jdbg.DeBruijnGraph.from_sequences(reads, k)
    assert t_g._kmer_set == j_g._kmer_set
    assert t_g.kmers == j_g.kmers
    assert t_g.get_contigs() == j_g.get_contigs()
    for kmer in t_g.kmers[:10]:
        assert t_g.forward(kmer) == j_g.forward(kmer)
        assert t_g.backward(kmer) == j_g.backward(kmer)


def test_debruijn_graph_default_k_is_31():
    reads = seeded_reads(3, n=6, low=31, high=60)
    t_g = tdbg.DeBruijnGraph.from_sequences(reads, **CPU)
    j_g = jdbg.DeBruijnGraph.from_sequences(reads)
    assert t_g._kmer_set == j_g._kmer_set
    assert t_g.get_contigs() == j_g.get_contigs()


@pytest.mark.parametrize("seed", SEEDS)
def test_colored_debruijn_graph(seed):
    k = 4
    reads = seeded_reads(seed, n=10, low=k, high=25)
    t_g = tdbg.ColoredDeBruijnGraph.from_sequences(reads, k, **CPU)
    j_g = jdbg.ColoredDeBruijnGraph.from_sequences(reads, k)
    assert dict(t_g._color_dict) == dict(j_g._color_dict)
    for kmer in sample_kmers(reads, k, seed):
        assert t_g[kmer] == j_g[kmer]


# -- string matching ----------------------------------------------------------

@pytest.mark.parametrize("pattern", ["AC", "GGT", "A", "TTTT"])
@pytest.mark.parametrize("seed", SEEDS)
def test_match_string(seed, pattern):
    reads = seeded_reads(seed, n=20, low=1, high=30, repeat=False)
    got = tbnp.match_string(tbnp.as_encoded_array(reads), pattern)
    want = jbnp.match_string(jbnp.as_encoded_array(reads), pattern)
    assert_same(got, want)
    for row, read in zip(got.tolist(), reads):
        hits = [i for i in range(len(read) - len(pattern) + 1)
                if read[i: i + len(pattern)] == pattern]
        assert [i for i, v in enumerate(row) if v] == hits


def test_match_string_flat_and_dna():
    for seqs in (["ACGTAC"], "ACGTACGAC"):
        assert_same(tbnp.match_string(tbnp.as_encoded_array(seqs), "AC"),
                    jbnp.match_string(jbnp.as_encoded_array(seqs), "AC"))
    dna = ["ACGTTACG", "CGA"]
    assert_same(
        tbnp.match_string(tbnp.as_encoded_array(dna, tbnp.DNAEncoding), "CG"),
        jbnp.match_string(jbnp.as_encoded_array(dna, jbnp.DNAEncoding), "CG"))


@pytest.mark.parametrize("regex", ["A.G", "[AC]G.", "AC.{1,3}T",
                                   "[CG]A.{0,2}C"])
@pytest.mark.parametrize("seed", SEEDS)
def test_regex_matchers(seed, regex):
    reads = seeded_reads(seed, n=15, low=6, high=30, repeat=False)

    def run(bnp, sm):
        seqs = bnp.as_encoded_array(reads, bnp.DNAEncoding)
        if "{" in regex:
            return sm.RegexMatcher(regex, bnp.DNAEncoding).rolling_window(
                seqs)
        return sm.FixedLenRegexMatcher(regex, bnp.DNAEncoding).rolling_window(
            seqs)
    assert_same(run(tbnp, tsm), run(jbnp, jsm))


# -- bloom filters ------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_bloom_filter(seed):
    rng = np.random.default_rng(seed)
    inserted = rng.integers(0, 1 << 20, 200)
    queries = np.concatenate([inserted[:50], rng.integers(0, 1 << 20, 300)])

    def run(bloom):
        f = bloom.BloomFilter.from_m_and_k(997, 3, seed=seed)
        f.insert(inserted)
        g = bloom.BloomFilter.from_hash_functions_and_sequences(
            [bloom.hash_function(o) for o in (3, 11)], inserted, 4093)
        return f[queries], g[queries], f._mask
    got, want = run(tbloom), run(jbloom)
    assert_same(got, want)
    assert got[0][:50].all() and got[1][:50].all()


@pytest.mark.parametrize("seed", SEEDS)
def test_interleaved_bloom_filter(seed):
    rng = np.random.default_rng(seed)
    columns = [rng.integers(0, 1 << 16, int(rng.integers(5, 40)))
               for _ in range(6)]
    q_kmer = np.concatenate([columns[2][:5], rng.integers(0, 1 << 16, 20)])
    q_col = np.full(len(q_kmer), 2)

    def run(bloom):
        f = bloom.InterleavedBloomFilter.from_hash_functions_and_sequences(
            [bloom.hash_function(o) for o in (5, 17, 29)], columns, 509)
        return f[q_kmer, q_col], f._mask
    got, want = run(tbloom), run(jbloom)
    assert_same(got, want)
    assert got[0][:5].all()
