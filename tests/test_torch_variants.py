"""The port's variants/ (SBS96 mutation-type counting and consensus
sequences) against the JAX package's, on the CPU, over a seeded genome
and seeded SNVs and indels whose REF is the genome's base.  SBS96 is
compared on both of its paths: the fixed-width window_matrix gather of a
dict-backed GenomicSequence, and the interval-window path (an indexed
FASTA reference, or genotypes given); an SNV at a chromosome's first or
last base, where window_matrix gives None and the interval path meets a
clipped window, raises the same ValueError in both packages.  Counts,
hashes and sequences are compared by value and dtype, exactly."""
import numpy as np
import pytest

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu.variants import mutation_signature as jms
from bionumpy_tpu_torch.variants import mutation_signature as tms
from test_torch_genomic_data import assert_same, both, write_fasta

SEEDS = [0, 1, 2]
SIZES = {"chr1": 1500, "chr2": 900, "chr3": 400}
PACKAGES = {"torch": (tbnp, tms), "jax": (jbnp, jms)}


def seeded_genome(seed):
    rng = np.random.default_rng(seed)
    return {name: "".join(rng.choice(list("ACGT"), size))
            for name, size in SIZES.items()}


def seeded_variants(seed, seqs, n=60, edge=None):
    """Sorted variants, 3 in 4 SNVs, the rest 1-3 base indels; REF from
    the genome.  `edge` puts the first SNV at "first" or "last" base of
    its chromosome.  Returns (chromosomes, positions, refs, alts)."""
    rng = np.random.default_rng(100 + seed)
    names = list(seqs)
    chrom_idx = np.sort(rng.integers(0, len(names), n))
    size = np.array([len(seqs[names[i]]) for i in chrom_idx])
    pos = 2 + (rng.random(n) * (size - 7)).astype(np.int64)
    order = np.lexsort((pos, chrom_idx))
    chrom_idx, pos, size = chrom_idx[order], pos[order], size[order]
    snv = rng.random(n) < 0.75
    snv[0] = True
    if edge == "first":
        pos[0] = 0
    elif edge == "last":
        pos[0] = size[0] - 1
    chroms = [names[i] for i in chrom_idx]
    refs, alts = [], []
    for i, (c, p) in enumerate(zip(chroms, pos)):
        ref = seqs[c][p]
        other = "ACGT"[("ACGT".index(ref) + int(rng.integers(1, 4))) % 4]
        tail = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 4))))
        if snv[i]:
            refs.append(ref)
            alts.append(other)
        elif i % 2:
            refs.append(ref + tail)
            alts.append(ref)
        else:
            refs.append(ref)
            alts.append(ref + tail)
    return chroms, pos, refs, alts


def variants(bnp, cols):
    return bnp.datatypes.Variant(*cols)


class Vars:
    """bench.py's config-5 wrapper: locations from Genome.get_locations,
    the other fields from the parsed records."""

    def __init__(self, loc, var):
        self._loc, self._var = loc, var

    def get_data_field(self, name):
        if name in ("chromosome", "position"):
            return getattr(self._loc, name)
        return getattr(self._var, name)

    def __getitem__(self, idx):
        return Vars(self._loc[idx], self._var[idx])

    def get_windows(self, flank):
        return self._loc.get_windows(flank=flank)


def counts(c):
    """EncodedCounts as (labels, counts with dtype)."""
    return [str(x) for x in c.alphabet], c.counts


@pytest.mark.parametrize("seed", SEEDS)
def test_sbs96_window_matrix_path(seed):
    seqs = seeded_genome(seed)
    cols = seeded_variants(seed, seqs)

    def run(bnp):
        gs = bnp.genomic_data.GenomicSequence.from_dict(seqs)
        assert gs.window_matrix(bnp.as_encoded_array(cols[0]), cols[1],
                                1) is not None
        locs = bnp.Genome.from_dict(SIZES).get_locations(variants(bnp, cols))
        return counts(bnp.variants.count_mutation_types_genomic(locs, gs))
    got, _ = both(run)
    assert int(got[1].sum()) == sum(
        len(r) == len(a) == 1 for r, a in zip(cols[2], cols[3]))


@pytest.mark.parametrize("seed", SEEDS)
def test_sbs96_wider_flank_overflows_alike(seed):
    """flank=2 (5-mers): both packages multiply the uint8 SNP code by
    4**4 and numpy refuses the overflow (a JAX package quirk the port
    keeps)."""
    seqs = seeded_genome(seed)
    cols = seeded_variants(seed, seqs)
    for bnp in (tbnp, jbnp):
        gs = bnp.genomic_data.GenomicSequence.from_dict(seqs)
        locs = bnp.Genome.from_dict(SIZES).get_locations(variants(bnp, cols))
        with pytest.raises(OverflowError):
            bnp.variants.count_mutation_types_genomic(locs, gs, flank=2)


@pytest.mark.parametrize("seed", SEEDS)
def test_sbs96_bench_wrapper(seed):
    """bench.py's config-5 job shape: the SNP mask, get_locations of
    LocationEntry, count_mutation_types_genomic(_Vars(...), sequence)."""
    seqs = seeded_genome(seed)
    cols = seeded_variants(seed, seqs, n=120)

    def run(bnp):
        v = variants(bnp, cols)
        is_snp = np.asarray(v.ref_seq.lengths == 1) & \
            np.asarray(v.alt_seq.lengths == 1)
        snps = v[is_snp]
        locs = bnp.Genome.from_dict(SIZES).get_locations(
            bnp.LocationEntry(snps.chromosome, snps.position))
        gs = bnp.genomic_data.GenomicSequence.from_dict(seqs)
        return counts(bnp.variants.count_mutation_types_genomic(
            Vars(locs, snps), gs))
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_sbs96_interval_path_indexed_fasta(seed, tmp_path):
    """An indexed FASTA reference has no window_matrix: the windows go
    through get_windows and interval extraction, and the counts equal the
    window_matrix path's."""
    seqs = seeded_genome(seed)
    cols = seeded_variants(seed, seqs)
    results = {}
    for key, (bnp, ms) in PACKAGES.items():
        (tmp_path / key).mkdir()
        fasta = tmp_path / key / "ref.fa"
        write_fasta(fasta, seqs)
        g = bnp.Genome.from_file(str(fasta), filter_function=None)
        ref = g.read_sequence()
        assert not hasattr(ref, "window_matrix")
        locs = g.get_locations(variants(bnp, cols))
        dict_ref = bnp.genomic_data.GenomicSequence.from_dict(seqs)
        results[key] = (
            counts(ms.count_mutation_types_genomic(locs, ref)),
            counts(ms.count_mutation_types_genomic(locs, dict_ref)))
    assert_same(results["torch"], results["jax"])
    assert_same(results["torch"][0], results["torch"][1])


@pytest.mark.parametrize("seed", SEEDS)
def test_sbs96_genotyped_interval_path(seed):
    seqs = seeded_genome(seed)
    cols = seeded_variants(seed, seqs)
    genotypes = np.random.default_rng(seed).integers(0, 3, (len(cols[1]), 4))

    def run(bnp):
        locs = bnp.Genome.from_dict(SIZES).get_locations(variants(bnp, cols))
        gs = bnp.genomic_data.GenomicSequence.from_dict(seqs)
        c = bnp.variants.count_mutation_types_genomic(locs, gs,
                                                      genotypes=genotypes)
        return counts(c)
    both(run)


@pytest.mark.parametrize("edge", ["first", "last"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sbs96_window_at_a_chromosome_edge(seed, edge):
    """window_matrix gives None for a window crossing an edge, and the
    interval path's clipped window is refused alike in both packages."""
    seqs = seeded_genome(seed)
    cols = seeded_variants(seed, seqs, edge=edge)
    for bnp in (tbnp, jbnp):
        gs = bnp.genomic_data.GenomicSequence.from_dict(seqs)
        assert gs.window_matrix(bnp.as_encoded_array(cols[0][:1]),
                                cols[1][:1], 1) is None
        locs = bnp.Genome.from_dict(SIZES).get_locations(variants(bnp, cols))
        with pytest.raises(ValueError, match="unequal length"):
            bnp.variants.count_mutation_types_genomic(locs, gs)


@pytest.mark.parametrize("seed", SEEDS)
def test_count_mutation_types_flat(seed):
    seqs = seeded_genome(seed)
    cols = seeded_variants(seed, {"chr1": seqs["chr1"]}, n=50)

    def run(bnp):
        return counts(bnp.variants.count_mutation_types(
            variants(bnp, cols), seqs["chr1"]))
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_snps_hashes_and_dtype(seed):
    rng = np.random.default_rng(seed)
    kmers = ["".join(rng.choice(list("ACGT"), 3)) for _ in range(40)]
    alts = ["ACGT"[("ACGT".index(k[1]) + int(rng.integers(1, 4))) % 4]
            for k in kmers]
    refs = [k[1] for k in kmers]

    def run(ms, bnp):
        h = ms.encode_snps(bnp.as_encoded_array(kmers),
                           bnp.as_encoded_array(alts), refs)
        return np.asarray(h.raw()), [h.encoding.to_string(x)
                                     for x in h.raw()[:10]]
    got, want = run(tms, tbnp), run(jms, jbnp)
    assert_same(got, want)
    assert got[0].dtype == want[0].dtype == np.int64


def test_mutation_type_encoding_and_snp_encoding():
    def run(ms, bnp):
        enc = ms.MutationTypeEncoding(1)
        snp = bnp.datatypes.Variant(["c"] * 6, list(range(6)), list("CCCTTT"),
                                    list("AGTACG"))
        with pytest.raises(ValueError):  # a JAX package quirk, kept
            enc.encode(bnp.as_encoded_array(["ACGTTCA", "TTAGCAG"]))
        return (enc.get_labels(), enc.h, enc.k,
                np.asarray(ms.SNPEncoding.encode(snp).raw()),
                ms.SNPEncoding.decode([0, 5, 3]).tolist())
    assert_same(run(tms, tbnp), run(jms, jbnp))
    assert tms.MutationTypeEncoding(1) == tms.MutationTypeEncoding(1)
    assert hash(tms.MutationTypeEncoding(2)) == \
        hash(tms.MutationTypeEncoding(2))


@pytest.mark.parametrize("seed", SEEDS)
def test_apply_variants_to_sequence(seed):
    seqs = seeded_genome(seed)
    cols = seeded_variants(seed, {"chr1": seqs["chr1"]}, n=40)
    snv = [i for i, (r, a) in enumerate(zip(cols[2], cols[3]))
           if len(r) == len(a) == 1]
    snv_cols = [[c[i] for i in snv] for c in cols]

    def run(bnp):
        seq = bnp.as_encoded_array(seqs["chr1"], bnp.DNAEncoding)
        out = bnp.variants.apply_variants_to_sequence(
            seq, variants(bnp, snv_cols))
        return out, seq
    got, _ = both(run)
    assert got[1].to_string() == seqs["chr1"]  # the input is not changed


@pytest.mark.parametrize("seed", SEEDS)
def test_apply_variants_to_records(seed):
    seqs = seeded_genome(seed)
    cols = seeded_variants(seed, seqs, n=50)
    snv = [i for i, (r, a) in enumerate(zip(cols[2], cols[3]))
           if len(r) == len(a) == 1]
    snv_cols = [[c[i] for i in snv] for c in cols]

    def run(bnp):
        entries = bnp.SequenceEntry(list(seqs), list(seqs.values()))
        return bnp.variants.apply_variants(entries, variants(bnp, snv_cols))
    both(run)


def test_apply_variants_refuses_indels_and_wrong_refs():
    seqs = seeded_genome(0)
    for bnp in (tbnp, jbnp):
        entries = bnp.SequenceEntry(["chr3"], [seqs["chr3"]])
        indel = bnp.datatypes.Variant(["chr3"], [5], [seqs["chr3"][5]],
                                      [seqs["chr3"][5] + "A"])
        with pytest.raises(AssertionError):
            bnp.variants.apply_variants(entries, indel)
        wrong = "ACGT"[("ACGT".index(seqs["chr3"][5]) + 1) % 4]
        bad_ref = bnp.datatypes.Variant(["chr3"], [5], [wrong], ["A"])
        with pytest.raises(AssertionError):
            bnp.variants.apply_variants_to_sequence(
                bnp.as_encoded_array(seqs["chr3"], bnp.DNAEncoding), bad_ref)
