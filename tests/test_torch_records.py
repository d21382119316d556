"""Parity of the port's string and record layer with the JAX package's:
typing, config, string_array, the string, bool, base and VCF encodings,
io/exceptions, io/strops, io/regexp, io/dump_csv, bnpdataclass (eager and
lazy) and datatypes (with GTF/GFF attributes).  These are host modules,
copied; each case runs the same calls through both packages and
compares what comes out as plain Python and numpy values (never the two
packages' objects with each other).  Cases follow tests/test_record_model.py,
tests/test_strops.py and tests/test_encoded_array.py."""
import importlib
import math
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import pytest

_MODULES = ["", ".bnpdataclass", ".config", ".datatypes", ".encodings",
            ".encodings.base_encoding", ".encodings.bool_encoding",
            ".encodings.string_encodings", ".encodings.vcf_encoding",
            ".io.dump_csv", ".io.exceptions", ".io.regexp", ".io.strops",
            ".ragged", ".string_array", ".typing"]


def _package(root):
    ns = SimpleNamespace(**{(name.rsplit(".", 1)[-1] or "bnp"):
                            importlib.import_module(root + name)
                            for name in _MODULES})
    ns.root = root

    @ns.bnpdataclass.bnpdataclass
    class Person:
        name: str
        age: int

    @ns.bnpdataclass.bnpdataclass
    class Record:
        name: str
        count: int
        chrom: ns.typing.SequenceID

    ns.Person, ns.Record = Person, Record
    return ns


PKGS = [_package("bionumpy_tpu"), _package("bionumpy_tpu_torch")]


def test_port_modules_are_the_ports():
    for name, module in vars(PKGS[1]).items():
        if hasattr(module, "__name__") and name not in ("Person", "Record"):
            assert module.__name__.startswith("bionumpy_tpu_torch"), name


def _equal(a, b):
    """Nested equality of plain values: type for type, numpy arrays by
    dtype, shape and value (NaN equal to NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            _equal(a[key], b[key])
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def same(fn):
    """fn(package) through the JAX package and the port: equal results.
    Returns the port's."""
    want, got = (fn(p) for p in PKGS)
    _equal(got, want)
    return got


def _fields(batch):
    """A record batch as plain values, field by field."""
    out = {}
    for name, value in batch.todict().items():
        out[name] = value if isinstance(value, (np.ndarray, list, str)) else \
            value.tolist()
    return type(batch).__name__, len(batch), out


# ---- typing, config, string arrays ---------------------------------------

def test_typing_and_config():
    def run(m):
        seen = []
        with m.config.ConfigContext(LAZY=False, STRING_ARRAY=False):
            seen.append((m.config.LAZY, m.config.STRING_ARRAY))
        seen.append((m.config.LAZY, m.config.STRING_ARRAY))
        return m.typing.SequenceID.__name__, seen
    assert same(run) == ("SequenceID", [(False, False), (True, True)])


STRING_ARRAY_CASES = {
    "tolist": lambda m, s: s.tolist(),
    "eq": lambda m, s: s == "chr1",
    "ne": lambda m, s: s != "chr1",
    "isin": lambda m, s: np.isin(s, ["chr1", "chr10"]),
    "lengths": lambda m, s: s.lengths,
    "slice": lambda m, s: s[1:].tolist(),
    "fancy": lambda m, s: s[np.array([0, 2])].tolist(),
    "concat": lambda m, s: (type(np.concatenate(
        [s, m.string_array.string_array(["x"])])).__name__, np.concatenate(
            [s, m.string_array.string_array(["x"])]).tolist()),
    "unique": lambda m, s: np.unique(s).tolist(),
    "argsort": lambda m, s: np.argsort(s),
    "ragged": lambda m, s: (s.to_ragged().tolist(), s.to_ragged().lengths),
    "bytes": lambda m, s: s.as_bytes(),
    "repr": lambda m, s: repr(s),
    "from_encoded": lambda m, s: m.string_array.as_string_array(
        m.bnp.as_encoded_array(["ab", "", "c"])).tolist(),
    "eq_encoded": lambda m, s: s == m.bnp.as_encoded_array(
        ["chr1", "x", "chr10", "", "chr1"]),
}


@pytest.mark.parametrize("case", list(STRING_ARRAY_CASES))
def test_string_array(case):
    same(lambda m: STRING_ARRAY_CASES[case](
        m, m.bnp.string_array(["chr1", "chr2", "chr10", "", "chr1"])))


# ---- encodings -----------------------------------------------------------

def test_string_encoding():
    def run(m):
        enc = m.bnp.StringEncoding(["chr1", "chr2", "chr10"])
        vals = enc.encode(m.bnp.as_encoded_array(["chr2", "chr1", "chr10",
                                                  "chr2"]))
        one = enc.encode(m.bnp.as_encoded_array("chr10"))
        # a sorted column of runs takes the grouped-key path
        col = m.bnp.as_string_array(["chr1"] * 200 + ["chr10"] * 100
                                    + ["chr2"] * 50)
        grouped = enc.encode(col)
        decoded = enc.decode(vals)
        with pytest.raises(m.encodings.EncodingError):
            enc.encode(m.bnp.as_encoded_array(["chrX"]))
        return (vals.raw(), int(one.raw()), grouped.raw(),
                decoded.tolist(), enc.to_string(2), enc.get_labels(),
                enc.n_labels, repr(enc), str(vals), vals.tolist(),
                enc == m.bnp.StringEncoding(["chr1", "chr2", "chr10"]),
                enc == m.bnp.StringEncoding(["chr1"]))
    out = same(run)
    np.testing.assert_array_equal(out[0], [1, 0, 2, 1])


def test_bool_encoding():
    def run(m):
        enc = m.encodings.bool_string
        text = m.bnp.as_encoded_array(["True", "False", "False", "True"])
        flags = enc.encode(text)
        custom = m.encodings.BoolStringEncoding("yes", "no")
        return (np.asarray(flags), enc.decode(flags).tolist(),
                enc.get_labels(), custom.decode(np.array([True, False]))
                .tolist())
    assert same(run)[1] == ["True", "False", "False", "True"]


def test_base_encoding_module():
    def run(m):
        mod = m.base_encoding
        return sorted(n for n in dir(mod) if n.endswith("Encoding"))
    assert "BaseEncoding" in same(run)


GENOTYPES = ["0|1\t1|1\t./.", "1/0\t0|0\t2|1", "0|0\t1|0\t0/0"]
PHASED = ["0|1\t1|1\t0|0", "1|0\t0|0\t1|1"]


def _genotype_lines(m, rows):
    """The genotype columns of VCF lines as the parser hands them over:
    one writable row per line, ending in its newline."""
    lines = [row + "\n" for row in rows]
    flat = np.frombuffer("".join(lines).encode(), np.uint8).copy()
    return m.bnp.EncodedRaggedArray(m.bnp.EncodedArray(
        flat, m.encodings.BaseEncoding), [len(line) for line in lines])


@pytest.mark.parametrize("name,rows", [
    ("GenotypeRowEncoding", GENOTYPES),
    ("PhasedGenotypeRowEncoding", PHASED),
    ("PhasedHaplotypeRowEncoding", ["0|1\t3|2", "1|.\t0|4"])])
def test_vcf_genotype_encodings(name, rows):
    def run(m):
        enc = getattr(m.vcf_encoding, name)
        codes = enc.encode(_genotype_lines(m, rows))
        out = [codes, repr(enc), enc == getattr(m.vcf_encoding, name)]
        if name != "PhasedHaplotypeRowEncoding":
            out += [enc.decode(codes), enc.to_string(codes)]
        return out
    out = same(run)
    if name != "PhasedHaplotypeRowEncoding":
        assert out[-1].replace("\n", "\t").split("\t") == \
            "\t".join(rows).split("\t")


# ---- io: exceptions, strops, regexp --------------------------------------

def test_io_exceptions():
    def run(m):
        err = m.exceptions.FormatException("bad field", line_number=3)
        return (type(err).__mro__[1].__name__, str(err), err.line_number,
                issubclass(m.exceptions.ParsingException, Exception))
    same(run)


STROPS_CASES = {
    "str_to_int": lambda m, s, a: s.str_to_int(a(["123", "-42", "0", "+7",
                                                  "1000000"])),
    "str_to_int_flat": lambda m, s, a: int(s.str_to_int(a("1234"))),
    "str_to_float": lambda m, s, a: s.str_to_float(a(
        ["3.14", "-2.5", "100", "1e3", "-1.5e-2", "2.5E2", "nan"])),
    "int_missing": lambda m, s, a: s.str_to_int_with_missing(
        a([".", "5", "."])),
    "float_missing": lambda m, s, a: s.str_to_float_with_missing(
        a([".", "2.0"])),
    "ints_to_strings": lambda m, s, a: s.ints_to_strings(
        np.array([0, 5, -17, 100, 999, 1000])).tolist(),
    "int_to_str": lambda m, s, a: s.int_to_str(-305).to_string(),
    "float_to_strings": lambda m, s, a: s.float_to_strings(
        np.array([1.5, -2.25, 1e-7])).tolist(),
    "int_lists": lambda m, s, a: [
        s.int_lists_to_strings(m.ragged.RaggedArray(
            [[1, 22, 3], [4], []]), keep_last=keep).tolist()
        for keep in (False, True)],
    "join_split": lambda m, s, a: (
        s.join(a(["ab", "c", "", "def"]), sep="\t").to_string(),
        s.split(s.join(a(["ab", "c", "", "def"]), sep="\t"),
                sep="\t").tolist()),
    "split_multi": lambda m, s, a: s.split(a("a=1;b=2"),
                                           sep=[";", "="]).tolist(),
    "str_equal": lambda m, s, a: (
        s.str_equal(a(["chr1", "chr2", "chr1", "x"]), "chr1"),
        s.str_equal(a(["chr1", "chr2", "chr1", "x"]),
                    a(["chr1", "chr2", "chr2", "y"])),
        bool(s.str_equal(a("abc"), "abc")),
        bool(s.str_equal(a("abc"), "ab"))),
    "replace_inplace": lambda m, s, a: _replaced(s, m.bnp.EncodedArray(
        np.frombuffer(b"1,2,3", np.uint8).copy(), m.encodings.BaseEncoding)),
    "top_level": lambda m, s, a: m.bnp.str_equal(a(["x", "y"]), "y"),
}


def _replaced(strops, text):
    strops.replace_inplace(text, ",", ";")
    return text.to_string()


@pytest.mark.parametrize("case", list(STROPS_CASES))
def test_strops(case):
    same(lambda m: STROPS_CASES[case](m, m.strops, m.bnp.as_encoded_array))


def test_strops_int_round_trip():
    numbers = np.random.default_rng(3).integers(-10 ** 12, 10 ** 12, 50)

    def run(m):
        text = m.strops.ints_to_strings(numbers)
        return text.tolist(), m.strops.str_to_int(text)
    _, back = same(run)
    np.testing.assert_array_equal(back, numbers)


def test_regexp():
    text = 'gene_id "g1"; transcript_id "t1";\ngene_id "g2"; x "y";'

    def run(m):
        arr = m.bnp.as_encoded_array(text)
        return (m.regexp.match_regexp(arr, r'gene_id "(.*?)"').tolist(),
                m.regexp.match_regexp_string_array(
                    arr, r'(\w+) "').tolist())
    assert same(run)[0] == ["g1", "g2"]


# ---- bnpdataclass --------------------------------------------------------

def _people(m):
    return m.Person(name=["alice", "bob", "carol"], age=[10, 20, 30])


RECORD_CASES = {
    "coercion": lambda m, p: (type(p.name).__name__, p.age.dtype.kind,
                              _fields(p)),
    "index_list": lambda m, p: _fields(p[[0, 2]]),
    "index_scalar": lambda m, p: p[1].name.tolist(),
    "mask": lambda m, p: _fields(p[p.age < 25]),
    "slice": lambda m, p: _fields(p[1:]),
    "from_entry_tuples": lambda m, p: _fields(
        m.Person.from_entry_tuples([("x", 1), ("yy", 2)])),
    "empty_concat": lambda m, p: (len(m.Person.empty()), _fields(
        np.concatenate([m.Person.empty(), m.Person(name=["a"], age=[1])]))),
    "concatenate": lambda m, p: _fields(np.concatenate([p, p])),
    "equality": lambda m, p: (
        p == m.Person(name=["alice", "bob", "carol"], age=[10, 20, 30]),
        p == p[[0, 1]]),
    "todict_from_dict": lambda m, p: (
        m.Person.from_dict(p.todict()) == p, sorted(p.todict())),
    "tolist_toiter": lambda m, p: (
        [(r.name, int(r.age)) for r in p.tolist()],
        next(p.toiter()).name),
    "add_fields": lambda m, p: _fields(p.add_fields(
        {"score": np.array([1.0, 2.0, 3.0])}, {"score": float})),
    "extend": lambda m, p: _fields(m.Person.extend((("city", str),))(
        name=["a"], age=[5], city=["oslo"])),
    "sort_by": lambda m, p: _fields(p[[2, 0, 1]].sort_by("age")),
    "replace": lambda m, p: _fields(m.bnpdataclass.replace(
        p, age=np.array([1, 2, 3]))),
    "top_level_replace": lambda m, p: _fields(m.bnp.replace(
        p, name=["x", "y", "z"])),
    "make_dataclass": lambda m, p: (lambda DC: (
        issubclass(DC, m.bnpdataclass.BNPDataClass),
        _fields(DC(chrom=["chr1"], pos=[7]))))(
        m.bnpdataclass.make_dataclass([("chrom", str), ("pos", int)],
                                      name="Loc")),
    "narrow_type": lambda m, p: _fields(m.bnpdataclass.narrow_type(
        m.datatypes.Interval, "chromosome", str)(
            chromosome=["chr1"], start=[0], stop=[10])),
    "astype": lambda m, p: _fields(m.Person.extend((("city", str),))(
        name=["a"], age=[5], city=["oslo"]).astype(m.Person)),
    "context": lambda m, p: _context(p),
    "repr": lambda m, p: repr(p),
    "shallow_tuple": lambda m, p: [
        v.tolist() for v in p.shallow_tuple()],
}


def _context(p):
    p.set_context("source", "unit-test")
    return p.has_context("source"), p.get_context("source")


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_bnpdataclass(case):
    same(lambda m: RECORD_CASES[case](m, _people(m)))


def test_bnpdataclass_list_field():
    def run(m):
        @m.bnpdataclass.bnpdataclass
        class WithList:
            name: str
            values: List[int]
        w = WithList(name=["a", "b"], values=[[1, 2], [3]])
        return _fields(w), _fields(w[[1]])
    assert same(run)[0][2]["values"] == [[1, 2], [3]]


class _TsvBuffer:
    """A tab-separated stand-in for a FileBuffer: the interface the lazy
    record classes use (entry count, field parse, slicing, concatenation
    and the write path), over rows of strings."""
    supports_modified_write = True

    def __init__(self, pkg, rows):
        self._pkg, self._rows = pkg, list(rows)
        self.parsed = []

    def validate_if_not(self):
        pass

    def count_entries(self):
        return len(self._rows)

    def get_field_by_number(self, i, field_type):
        self.parsed.append(i)
        column = [row[i] for row in self._rows]
        if field_type is int:
            return np.array([int(c) for c in column])
        return self._pkg.bnp.as_encoded_array(column)

    def __getitem__(self, idx):
        keep = np.atleast_1d(np.arange(len(self._rows))[idx])
        return type(self)(self._pkg, [self._rows[i] for i in keep])

    def concatenate(self, buffers):
        return type(self)(self._pkg, [r for b in buffers for r in b._rows])

    @property
    def data(self):
        return self._pkg.bnp.as_encoded_array(
            "".join("\t".join(r) + "\n" for r in self._rows))

    def get_field_range_as_text(self, start, stop):
        return self._pkg.bnp.as_encoded_array(
            ["\t".join(r[start:stop]) for r in self._rows])

    @staticmethod
    def process_field_for_write(name, values):
        return values

    @staticmethod
    def join_fields(columns):
        rows = zip(*[c.tolist() for c in columns])
        return "".join("\t".join(r) + "\n" for r in rows)


ROWS = [("r1", "5", "chr1"), ("r22", "17", "chr2"), ("r3", "0", "chr1"),
        ("r4", "9", "chrX")]


def _lazy(m, rows=ROWS):
    lazy_cls = m.bnpdataclass.create_lazy_class(m.Record)
    return lazy_cls(m.bnpdataclass.ItemGetter(_TsvBuffer(m, rows),
                                              m.Record))


LAZY_CASES = {
    "parse_on_access": lambda m, x: (
        len(x), x.count, x._itemgetter.buffer.parsed,
        isinstance(x, m.bnpdataclass.LazyBNPDataClass),
        isinstance(x, m.Record)),
    "overlay": lambda m, x: _overlay(m, x),
    "slice": lambda m, x: (len(x[1:3]), x[1:3].name.tolist()),
    "mask_stays_lazy": lambda m, x: _masked(x),
    "scalar_index": lambda m, x: x[2].name.tolist(),
    "data_object": lambda m, x: _fields(x.get_data_object()),
    "concatenate": lambda m, x: (lambda both: (
        type(both).__name__, len(both), both.count))(
        np.concatenate([x, _lazy(m, ROWS[:2])])),
    "write_unmodified": lambda m, x: x.get_buffer().to_string(),
    "write_modified": lambda m, x: _modified_write(m, x),
    "replace": lambda m, x: m.bnpdataclass.replace(
        x, count=np.array([1, 2, 3, 4])).count,
    "context": lambda m, x: (x.has_context("header"),
                             x.get_context("header")),
}


def _overlay(m, x):
    x.name = m.bnp.as_encoded_array(["a", "b", "c", "d"])
    return x.name.tolist(), x.chrom.tolist(), x._itemgetter.buffer.parsed


def _masked(x):
    sub = x[x.count > 4]
    return len(sub), sub.name.tolist(), sub.count, \
        x._itemgetter.buffer.parsed


def _modified_write(m, x):
    x.count = np.array([1, 2, 3, 4])
    return x.get_buffer()


@pytest.mark.parametrize("case", list(LAZY_CASES))
def test_lazy_bnpdataclass(case):
    same(lambda m: LAZY_CASES[case](m, _lazy(m)))


# ---- dump_csv ------------------------------------------------------------

def test_dump_csv_columns():
    def run(m):
        a = m.bnp.as_encoded_array
        columns = [
            (int, np.array([1, -20, 300])),
            (str, a(["x", "", "zz"])),
            (float, np.array([0.5, -1.25, 3.0])),
            (List[int], m.ragged.RaggedArray([[1, 2], [], [3]])),
            (m.encodings.bool_string, np.array([True, False, True])),
            (m.typing.SequenceID, m.bnp.as_string_array(["c1", "c2", "c3"])),
            (Optional[int], np.array([1.0, np.nan, 3.0])),
            (bool, np.array([True, False, False])),
            (str, m.bnp.StringEncoding(["p", "q"]).encode(
                a(["q", "p", "q"]))),
        ]
        rendered = [m.dump_csv.get_column(v, t).tolist() for t, v in columns]
        return rendered, m.dump_csv.dump_csv(columns).to_string()
    _, text = same(run)
    assert text.splitlines()[1] == "-20\t\t-1.25\t\tFalse\tc2\t.\t0\tp"


# ---- datatypes -----------------------------------------------------------

ENTRIES = {
    "Interval": [("chr1", 10, 20), ("chr2", 0, 5)],
    "LocationEntry": [("chr1", 7), ("chr3", 9)],
    "SequenceEntry": [("r1", "ACGT"), ("r2", "GG")],
    "SequenceEntryWithQuality": [("r1", "ACGT", "II#I"), ("r2", "GG", "!!")],
    "Bed6": [("chr1", 1, 9, "a", 5, "+"), ("chr2", 3, 4, "b", 0, "-")],
    "VCFEntry": [("chr1", 100, "v1", "A", "T", "50", "PASS", "DP=3"),
                 ("chr1", 200, "v2", "AG", "T", ".", "PASS", "DP=9")],
    "SAMEntry": [("q1", 0, "chr1", 5, 60, "4M", "=", 0, 4, "ACGT", "IIII",
                  "NM:i:0")],
    "BamEntry": [("chr1", "q1", 16, 5, 60, "MI", [3, 1], "ACGT", "IIII")],
    "GFFEntry": [("chr1", "src", "gene", 1, 90, ".", "+", ".",
                  "gene_id=g1;name=x")],
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_datatypes_entry_classes(name):
    def run(m):
        cls = getattr(m.bnp, name)
        assert cls is getattr(m.datatypes, name)
        batch = cls.from_entry_tuples(ENTRIES[name])
        out = [_fields(batch), _fields(batch[[0]])]
        if name == "VCFEntry":
            out.append(batch.is_snp())
        return out
    same(run)


GTF = [("chr1", "ens", "gene", 1, 100, ".", "+", ".",
        'gene_id "g1"; gene_name "A";'),
       ("chr1", "ens", "transcript", 1, 100, ".", "+", ".",
        'gene_id "g1"; transcript_id "t1";'),
       ("chr1", "ens", "exon", 1, 40, ".", "+", ".",
        'gene_id "g1"; transcript_id "t1"; exon_id "e1";'),
       ("chr1", "ens", "exon", 60, 100, ".", "+", ".",
        'gene_id "g1"; transcript_id "t1"; exon_id "e2";'),
       ("chr2", "ens", "gene", 5, 50, ".", "-", ".",
        'gene_id "g2";')]


def test_gtf_attributes():
    def run(m):
        gtf = m.datatypes.GTFEntry.from_entry_tuples(GTF)
        genes, transcripts, exons = (gtf.get_genes(), gtf.get_transcripts(),
                                     gtf.get_exons())
        return (_fields(genes), _fields(transcripts), _fields(exons),
                exons.exon_id.tolist())
    assert same(run)[3] == ["e1", "e2"]


def test_gff_attributes():
    rows = [("chr1", "src", "gene", 1, 90, ".", "+", ".", "ID=g1;gene_id=g1"),
            ("chr1", "src", "mRNA", 1, 90, ".", "+", ".", "ID=t1"),
            ("chr2", "src", "gene", 3, 9, ".", "-", ".", "gene_id=g7;x=1")]

    def run(m):
        gff = m.datatypes.GFFEntry.from_entry_tuples(rows)
        genes = gff.get_genes()
        return _fields(genes), genes.gene_id.tolist()
    assert same(run)[1] == ["g1", "g7"]


def test_vcf_genotype_entries():
    def run(m):
        columns = [list(c) for c in zip(*ENTRIES["VCFEntry"])]
        batch = m.datatypes.PhasedVCFGenotypeEntry(
            *columns, _genotype_lines(m, PHASED))
        return _fields(batch), batch.genotypes, _fields(batch[[1]])
    same(run)


def test_top_level_exports():
    names = ["translate_dna_to_protein", "StringEncoding", "StringArray",
             "string_array", "as_string_array", "datatypes", "replace",
             "str_equal", "Interval", "SequenceEntry",
             "SequenceEntryWithQuality", "VCFEntry", "BamEntry", "SAMEntry",
             "Bed6", "GFFEntry", "LocationEntry"]
    for name in names:
        assert hasattr(PKGS[0].bnp, name) and hasattr(PKGS[1].bnp, name), name
        assert name in PKGS[1].bnp.__all__
