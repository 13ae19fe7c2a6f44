"""The port's copies of the I/O boundary (``repro_torch.io`` and the
writers of ``repro_torch.data.genome``) against ``repro``'s: the same
files, the same parsed arrays and counts, the same validator verdicts."""
import gzip
from pathlib import Path

import numpy as np
import pytest

from repro.data import genome as jgen
from repro.io import fasta as jfasta
from repro.io import fastq as jfastq
from repro.io import sam as jsam
from repro_torch.data import genome as tgen
from repro_torch.io import fasta as tfasta
from repro_torch.io import fastq as tfastq
from repro_torch.io import sam as tsam

GOLDEN = Path(__file__).parent / "golden" / "paired_small.sam"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_io")
    c1 = tgen.make_reference(900, seed=1, repeat_frac=0.0)
    c2 = tgen.make_reference(400, seed=2, repeat_frac=0.0)
    c1[100:110] = 4
    rs = tgen.sample_reads(c1, 9, read_len=60, seed=4, both_strands=True)
    for pkg, tag in ((tgen, "t"), (jgen, "j")):
        pkg.write_fasta(d / f"{tag}.fa", [("chr1", c1), ("chr2", c2)],
                        width=50)
        pkg.write_fastq(d / f"{tag}.fq", rs.reads, rs.quals)
        pkg.write_fastq(d / f"{tag}.fq.gz", rs.reads, rs.quals,
                        [f"r{i}" for i in range(9)])
    # a FASTQ with a short record, a long one and two malformed ones
    lines = (d / "t.fq").read_text().splitlines(True)
    lines[1] = lines[1][:30] + "\n"            # short read: skipped
    lines[3] = lines[3][:30] + "\n"
    lines[5] = lines[5].rstrip("\n") + "ACGT\n"   # long read: truncated
    lines[7] = lines[7].rstrip("\n") + "IIII\n"
    lines[11] = lines[11][:-3] + "\n"          # quality length mismatch
    lines[14] = "-\n"                          # missing '+' separator
    (d / "messy.fq").write_text("".join(lines))
    return d


def test_writers_write_the_same_files(files):
    """Also for a ReadSet, whose qualities the writer takes itself."""
    assert (files / "t.fa").read_text() == (files / "j.fa").read_text()
    assert (files / "t.fq").read_text() == (files / "j.fq").read_text()
    rs = tgen.sample_reads(tgen.make_reference(500, seed=3), 3, read_len=40)
    tgen.write_fastq(files / "rs.fq", rs)
    jgen.write_fastq(files / "rs_j.fq", rs.reads, rs.quals)
    assert (files / "rs.fq").read_text() == (files / "rs_j.fq").read_text()
    with gzip.open(files / "t.fq.gz", "rt") as a, \
            gzip.open(files / "j.fq.gz", "rt") as b:
        assert a.read() == b.read()


def test_reference_loading_and_coordinates(files):
    got = tfasta.load_reference(files / "t.fa", spacer=72)
    want = jfasta.load_reference(files / "t.fa", spacer=72)
    np.testing.assert_array_equal(got[0], want[0])
    assert [(c.name, c.length, c.offset) for c in got[1]] == \
        [(c.name, c.length, c.offset) for c in want[1]]
    tmap, jmap = tfasta.ReferenceMap(got[1]), jfasta.ReferenceMap(want[1])
    for pos in range(0, len(got[0]), 7):
        (tc, tl), (jc, jl) = tmap.locate(pos), jmap.locate(pos)
        assert (tc.name, tl) == (jc.name, jl)
    streamed = list(tfasta.stream_fasta(files / "t.fa", max_chunk=128))
    assert [n for n, _, last in streamed if last] == ["chr1", "chr2"]
    np.testing.assert_array_equal(
        np.concatenate([c for n, c, _ in streamed if n == "chr1"]),
        next(tfasta.parse_fasta(files / "t.fa"))[1])


def _chunks(stream):
    return [(c.names, c.reads, c.quals, c.seqs) for c in stream]


def _same_chunks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])


@pytest.mark.parametrize("name", ["t.fq", "t.fq.gz"])
def test_fastq_chunks_match(files, name):
    got = _chunks(tfastq.FastqStream(str(files / name), chunk_reads=4))
    want = _chunks(jfastq.FastqStream(str(files / name), chunk_reads=4))
    _same_chunks(got, want)
    assert [len(c[0]) for c in got] == [4, 4, 1]
    _same_chunks(_chunks(tfastq.parse_fastq(str(files / name),
                                            chunk_reads=3)),
                 _chunks(jfastq.parse_fastq(str(files / name),
                                            chunk_reads=3)))


def test_fastq_permissive_quarantine_matches(files):
    streams = []
    for mod, tag in ((tfastq, "t"), (jfastq, "j")):
        s = mod.FastqStream(str(files / "messy.fq"), read_len=60,
                            chunk_reads=3, on_error="permissive",
                            rejects=str(files / f"{tag}_rej.fq"))
        streams.append((s, _chunks(s)))
    (ts, tc), (js, jc) = streams
    _same_chunks(tc, jc)
    for attr in ("n_reads", "n_skipped", "n_truncated", "n_rejected",
                 "reject_reasons", "rejected_names"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    assert ts.n_rejected == 2 and ts.n_skipped == 1 and ts.n_truncated == 1
    assert (files / "t_rej.fq").read_text() == \
        (files / "j_rej.fq").read_text()


def test_fastq_strict_error_matches(files):
    msgs = []
    for mod in (tfastq, jfastq):
        with pytest.raises(ValueError) as e:
            _chunks(mod.FastqStream(str(files / "messy.fq"), read_len=60))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "bases but" in msgs[0]


def test_validate_sam_verdicts_match():
    text = GOLDEN.read_text()
    assert tsam.validate_sam(text, require_mapq=True) == \
        jsam.validate_sam(text, require_mapq=True)
    rec = [ln for ln in text.splitlines() if not ln.startswith("@")][0]
    f = rec.split("\t")
    broken = text.replace(rec, "\t".join(f[:9] + [f[9][:-1]] + f[10:]))
    for mod in (tsam, jsam):
        with pytest.raises(AssertionError, match="QUAL/SEQ"):
            mod.validate_sam(broken)


def test_sam_header_and_record_match():
    contigs = [tfasta.Contig("chr1", 900, 0), tfasta.Contig("chr2", 400, 972)]
    jcontigs = [jfasta.Contig("chr1", 900, 0), jfasta.Contig("chr2", 400, 972)]
    got = tsam.sam_header(contigs, command_line="x y")
    want = jsam.sam_header(jcontigs, command_line="x y")
    assert got[:-1] == want[:-1]
    assert got[-1] == want[-1].replace("repro.launch", "repro_torch.launch")
    args = ("q", 16, "chr1", 5, 255, "4=", "ACGT", "IIII")
    assert tsam.sam_record(*args, nm=0) == jsam.sam_record(*args, nm=0)


# ---------------------------------------------------------------- paired

def test_mate_base_name_matches():
    for name in ("p7/1", "p7/2", "plain", "x/12", "SRR123.1", "SRR123_2",
                 "a/3", "/1"):
        assert tfastq.mate_base_name(name) == jfastq.mate_base_name(name)


def _fq(records) -> str:
    return "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in records)


def _rec(name, seq="ACGTACGT"):
    return (name, seq, "I" * len(seq))


def _two(d, recs1, recs2, tail2=""):
    (d / "r1.fq").write_text(_fq(recs1))
    (d / "r2.fq").write_text(_fq(recs2) + tail2)
    return (str(d / "r1.fq"), str(d / "r2.fq")), dict(read_len=8)


def _gz_world(d, interleaved):
    ps = tgen.sample_pairs(tgen.make_reference(8000, seed=31), 21,
                           read_len=80, insert_mean=220, insert_sd=20,
                           seed=32)
    if interleaved:
        tgen.write_fastq_pair(None, None, ps,
                              interleaved_path=str(d / "inter.fastq.gz"))
        return (str(d / "inter.fastq.gz"),), dict(interleaved=True,
                                                  chunk_reads=16)
    tgen.write_fastq_pair(str(d / "r1.fastq.gz"), str(d / "r2.fastq.gz"), ps)
    return (str(d / "r1.fastq.gz"), str(d / "r2.fastq.gz")), dict(
        chunk_reads=8)


# the paired cases of the reference's gzip and ingestion-fault tests:
# name -> (files, PairedFastqStream keywords)
PAIRED_CASES = {
    "two_file_gz": lambda d: _gz_world(d, False),
    "interleaved_gz": lambda d: _gz_world(d, True),
    "short_mate_skips_pair": lambda d: _two(
        d, [_rec("a/1"), _rec("b/1")],
        [_rec("a/2", "ACG"), _rec("b/2", "G" * 10)]),
    "name_mismatch": lambda d: _two(d, [_rec("a/1")], [_rec("zz/2")]),
    "desync": lambda d: _two(d, [_rec("a/1"), _rec("b/1"), _rec("c/1"),
                                 _rec("d/1")],
                             [_rec("a/2"), _rec("c/2"), _rec("d/2")]),
    "desync_unrepairable": lambda d: _two(
        d, [_rec("a/1"), _rec("b/1"), _rec("d/1")],
        [_rec("a/2"), _rec("x/2"), _rec("d/2")]),
    "unpaired_tail": lambda d: _two(d, [_rec("a/1"), _rec("b/1")],
                                    [_rec("a/2")]),
    "corrupt_record_in_pair": lambda d: _two(
        d, [_rec("a/1"), _rec("b/1"), _rec("c/1")], [_rec("a/2")],
        tail2="@b/2\nACGTACGT\n+\nII\n" + _fq([_rec("c/2")])),
}


def _paired_run(mod, files, kw, on_error, rejects):
    """Everything a ``PairedFastqStream`` reports: its chunks, counts and
    rejects file, or the error it raised."""
    kw = dict(dict(chunk_reads=4), **kw)
    try:
        s = mod.PairedFastqStream(*files, on_error=on_error,
                                  rejects=rejects, **kw)
        chunks = [(_chunks([c1]), _chunks([c2])) for c1, c2 in s]
    except ValueError as e:
        return type(e).__name__, str(e)
    counts = {a: getattr(s, a) for a in (
        "read_len", "n_pairs", "n_skipped", "n_truncated", "n_rejected",
        "n_rejected_pairs", "reject_reasons", "rejected_names")}
    counts["s2_reasons"] = s._s2.reject_reasons
    text = Path(rejects).read_text() if Path(rejects).exists() else None
    return chunks, counts, text


@pytest.mark.parametrize("on_error", ["strict", "permissive"])
@pytest.mark.parametrize("case", sorted(PAIRED_CASES))
def test_paired_fastq_stream_matches(tmp_path, case, on_error):
    files, kw = PAIRED_CASES[case](tmp_path)
    got = _paired_run(tfastq, files, kw, on_error, str(tmp_path / "t.rej"))
    want = _paired_run(jfastq, files, kw, on_error, str(tmp_path / "j.rej"))
    assert type(got) is type(want) and len(got) == len(want)
    if isinstance(want[0], str):            # both raised
        assert got == want
        return
    assert len(got[0]) == len(want[0])
    for (g1, g2), (w1, w2) in zip(got[0], want[0]):
        _same_chunks(g1, w1)
        _same_chunks(g2, w2)
    assert got[1:] == want[1:]


def test_paired_fastq_stream_refusals_match():
    for args, kw in ((("x.fq", "y.fq"), dict(interleaved=True)),
                     (("x.fq",), {}),
                     (("x.fq", "y.fq"), dict(chunk_reads=0)),
                     (("x.fq", "y.fq"), dict(on_error="lenient"))):
        msgs = []
        for mod in (tfastq, jfastq):
            with pytest.raises(ValueError) as e:
                mod.PairedFastqStream(*args, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
