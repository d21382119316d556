"""GTF/GFF record types with attribute extraction (reference:
bionumpy/datatypes/gtf.py:9-70)."""
from ..bnpdataclass import BNPDataClass, bnpdataclass
from ..encodings import StrandEncoding
from ..io.regexp import match_regexp_string_array
from ..io.strops import join, split, str_equal
from ..string_array import as_string_array
from ..typing import SequenceID


@bnpdataclass
class GTFEntry:
    chromosome: SequenceID
    source: str
    feature_type: SequenceID
    start: int
    stop: int
    score: str
    strand: StrandEncoding
    phase: str
    atributes: str

    def _get_attributes(self, attribute_names):
        pattern_suffix = r''' \"(.*?)\"'''
        return {name: match_regexp_string_array(self.atributes.ravel(),
                                                name + pattern_suffix)
                for name in attribute_names}

    def get_genes(self):
        genes = self[str_equal(self.feature_type, "gene")]
        attributes = genes._get_attributes(["gene_id"])
        return GFFGeneEntry(*genes.shallow_tuple(), **attributes)

    def get_transcripts(self):
        transcripts = self[str_equal(self.feature_type, "transcript")]
        attributes = transcripts._get_attributes(["transcript_id", "gene_id"])
        return GFFTranscriptEntry(*transcripts.shallow_tuple(), **attributes)

    def get_exons(self):
        exons = self[str_equal(self.feature_type, "exon")]
        attributes = exons._get_attributes(
            ["transcript_id", "gene_id", "exon_id"])
        return GFFExonEntry(*exons.shallow_tuple(), **attributes)


class GFFEntry(GTFEntry):
    def _get_attributes(self, attribute_names):
        all_features = split(join(self.atributes, ";"), [";", "="])
        keys = all_features[:-1:2]
        values = all_features[1::2]
        return {name: as_string_array(values[str_equal(keys, name)])
                for name in attribute_names}


@bnpdataclass
class GFFGeneEntry(GFFEntry):
    gene_id: SequenceID


@bnpdataclass
class GFFTranscriptEntry(GFFGeneEntry):
    transcript_id: SequenceID


@bnpdataclass
class GFFExonEntry(GFFTranscriptEntry):
    exon_id: SequenceID
