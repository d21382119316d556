"""The port's host tail against the JAX package's: simulate/ under one
seed in both packages (the same draws give the same sequences, reads,
intervals and variants), cli.CliWrapper, plot on matplotlib's Agg
backend, and alignments.msa.  The port runs on the CPU; above 2^15 bases
its ChIP-seq scores run kernel 3's plain version (float32), held to
JAX's float64 host scores within float32 rounding."""
import numpy as np
import pytest

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu.genomic_data.genomic_sequence import \
    GenomicSequence as JGenomicSequence
from bionumpy_tpu_torch.genomic_data.genomic_sequence import GenomicSequence


def _tolist(x):
    return x.tolist() if hasattr(x, "tolist") else list(x)


def _same_records(a, b, fields):
    for f in fields:
        assert _tolist(getattr(a, f)) == _tolist(getattr(b, f)), f


def _genomes(seed=3, sizes=(("chr1", 5000), ("chr2", 3000))):
    rng = np.random.default_rng(seed)
    seqs = {name: "".join("ACGT"[c] for c in rng.integers(0, 4, n))
            for name, n in sizes}
    return JGenomicSequence.from_dict(seqs), GenomicSequence.from_dict(seqs)


def test_rng_seed():
    from bionumpy_tpu.simulate import rng as jrng
    from bionumpy_tpu_torch.simulate import rng
    draws = []
    for module in (jrng, rng, jrng):
        module.seed(42)
        draws.append(module.default_rng().integers(0, 100, 5))
        module.seed(None)
    np.testing.assert_array_equal(draws[0], draws[1])
    np.testing.assert_array_equal(draws[1], draws[2])


def test_simulate_sequences():
    out = [bnp.simulate.simulate_sequences(
        "ACGT", {"s1": 100, "s2": 50}, rng=np.random.default_rng(1))
        for bnp in (jbnp, tbnp)]
    assert out[1].sequence.lengths.tolist() == [100, 50]
    _same_records(out[0], out[1], ["name", "sequence"])
    one = [bnp.simulate.simulate_sequence("ACGU", 40,
                                          rng=np.random.default_rng(2))
           for bnp in (jbnp, tbnp)]
    assert one[0].to_string() == one[1].to_string()


def test_simulate_intervals():
    out = [bnp.simulate.simulate_intervals(
        {"chr1": 1000, "chr2": 500}, 50, 20, rng=np.random.default_rng(0))
        for bnp in (jbnp, tbnp)]
    assert len(out[1]) == 20
    assert np.all(np.asarray(out[1].stop) - np.asarray(out[1].start) == 50)
    _same_records(out[0], out[1], ["chromosome", "start", "stop"])


def test_simulate_reads_from_genome():
    genomes = _genomes()
    out = [list(bnp.simulate.simulate_reads_from_genome(
        g, length=40, n_reads=60, chunk_size=25, sequence_name_prefix="r",
        rng=11)) for bnp, g in zip((jbnp, tbnp), genomes)]
    assert [len(c) for c in out[1]] == [len(c) for c in out[0]]
    for a, b in zip(*out):
        _same_records(a, b, ["name", "sequence", "quality"])


@pytest.mark.parametrize("n_samples", [0, 3])
def test_simulate_variants(n_samples):
    genomes = _genomes(5)
    out = [list(bnp.simulate.simulate_variants(
        g, snp_prob=0.01, small_indel_prob=0.002, sv_prob=0.0005,
        rng=np.random.default_rng(9), n_samples=n_samples))
        for bnp, g in zip((jbnp, tbnp), genomes)]
    assert len(out[0]) == len(out[1]) == 2
    fields = ["chromosome", "position", "id", "ref_seq", "alt_seq",
              "quality", "filter", "info"]
    for a, b in zip(*out):
        assert len(b) > 0
        _same_records(a, b, fields + (["genotypes"] if n_samples else []))


def test_simulate_rnaseq():
    from bionumpy_tpu.simulate import rnaseq as jrnaseq
    from bionumpy_tpu_torch.simulate import rnaseq
    out = []
    for module, bnp in ((jrnaseq, jbnp), (rnaseq, tbnp)):
        module.rng = np.random.default_rng(4)
        refs = bnp.as_encoded_array(["ACGT" * 100, "GGTTA" * 80],
                                    bnp.DNAEncoding)
        settings = module.RNASeqSimulationSettings(
            transcript_counts=[2, 3], fragment_size=50, read_length=25,
            sampling_rate=0.8)
        out.append(module.simulate_rnaseq(refs, settings))
    assert len(out[1]) > 0
    assert np.all(np.asarray(out[1].sequence.lengths) == 25)
    _same_records(out[0], out[1], ["name", "sequence", "quality"])


def _chip(package, chipseq, reference, motif, **kw):
    chipseq.rng = np.random.default_rng(8)
    settings = chipseq.ChipSeqSimulationSettings(
        motif, fragment_length=60, read_length=30, coverage=2)
    return package.simulate.simulate_chip_seq_reads(
        reference, settings, sequence_name="chrS", **kw)


@pytest.mark.parametrize("length", [5000, 40_000])
def test_simulate_chip_seq_reads(length):
    """Both packages draw the same reads under one seed: below 2^15
    bases the port scores on the host as JAX does; above, kernel 3's
    plain version scores one row in float32."""
    from bionumpy_tpu.simulate import chipseq as jchipseq
    from bionumpy_tpu_torch.simulate import chipseq
    rng = np.random.default_rng(12)
    text = "".join("ACGT"[c] for c in rng.integers(0, 4, length))
    counts = {"A": [5, 1, 0, 8, 2], "C": [1, 9, 2, 0, 3],
              "G": [2, 0, 8, 1, 3], "T": [2, 0, 0, 1, 2]}
    jref = jbnp.as_encoded_array(text, jbnp.DNAEncoding)
    ref = tbnp.as_encoded_array(text, tbnp.DNAEncoding)
    jpwm, pwm = jbnp.PWM.from_dict(counts), tbnp.PWM.from_dict(counts)
    want = _chip(jbnp, jchipseq, jref, jpwm)
    got = _chip(tbnp, chipseq, ref, pwm, device="cpu")
    assert len(got) == 2 * length // 30
    _same_records(want, got, ["chromosome", "start", "stop", "name",
                              "score", "strand"])
    jscores = np.asarray(jbnp.get_motif_scores(jref, jpwm))
    scores = chipseq._window_scores(ref, pwm, "cpu")
    np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-5)
    if length < 1 << 15:
        np.testing.assert_array_equal(scores, jscores)


def test_simulate_revcomp_kmer_chain():
    """simulate_sequences -> get_reverse_complement -> count_kmers, as
    tests/test_user_flows.py chains them, equal in both packages."""
    out = []
    for bnp in (jbnp, tbnp):
        rng = np.random.default_rng(1)
        sim = bnp.simulate.simulate_sequences(
            "ACGT", {f"s{i}": int(n)
                     for i, n in enumerate(rng.integers(40, 60, 20))},
            rng=rng)
        rc = bnp.get_reverse_complement(sim.sequence)
        kw = {"device": "cpu"} if bnp is tbnp else {}
        out.append(bnp.count_kmers(bnp.as_encoded_array(
            rc.tolist(), bnp.DNAEncoding), 5, **kw))
    np.testing.assert_array_equal(np.asarray(out[0].counts),
                                  np.asarray(out[1].counts))
    assert int(np.asarray(out[1].counts).sum()) > 0


def test_cli_wrapper_file_io(tmp_path):
    from bionumpy_tpu_torch.cli import CliWrapper
    from bionumpy_tpu_torch.datatypes import SequenceEntry

    def upper_names(entries: SequenceEntry) -> SequenceEntry:
        return entries

    wrapped = CliWrapper()(upper_names)
    src = tmp_path / "in.fa"
    src.write_text(">a\nACGT\n>b\nGGTT\n")
    out = tmp_path / "out.fa"
    wrapped(str(src), output=str(out))
    assert tbnp.open(str(out)).read().sequence.tolist() == ["ACGT", "GGTT"]
    assert wrapped.__annotations__ == {"entries": str, "output": str}


def test_run_as_commandline(monkeypatch):
    seen = []

    def job(n: int, name: str):
        seen.append((n, name))

    monkeypatch.setattr("sys.argv", ["prog", "7", "x"])
    tbnp.run_as_commandline(job)
    assert seen == [(7, "x")]


def test_plot_on_agg(monkeypatch):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    monkeypatch.setattr(plt, "show", lambda: None)
    seqs = tbnp.as_encoded_array(["ACGT", "GGCA"], tbnp.DNAEncoding)
    tbnp.plot(tbnp.count_encoded(seqs.ravel()))
    tbnp.plot(np.arange(5.0))
    with pytest.raises(NotImplementedError, match="cannot plot"):
        tbnp.plot("text")
    plt.close("all")


def test_msa():
    from bionumpy_tpu.alignments.msa import \
        MultipleSequenceAlignment as JMSA
    from bionumpy_tpu_torch.alignments.msa import MultipleSequenceAlignment
    masks = []
    for bnp, cls in ((jbnp, JMSA), (tbnp, MultipleSequenceAlignment)):
        entries = bnp.SequenceEntry(["a", "b"], ["AC-T", "ACGT"])
        masks.append(cls.from_sequence_entries(entries).mask())
    np.testing.assert_array_equal(masks[1], [[True, True, False, True],
                                             [True, True, True, True]])
    np.testing.assert_array_equal(masks[0], masks[1])
