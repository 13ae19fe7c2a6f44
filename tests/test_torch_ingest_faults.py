"""The ``fastq_record`` fault site of the port's FASTQ streams against the
reference's (``tests/test_ingest_faults.py`` covers the parser's own
faults): a seeded ``FaultInjector`` marks the same records corrupt in
both packages, so a permissive stream emits the same reads and writes the
same rejects, and a strict one stops at the same record with the same
file:line context, on single-end, two-file paired and interleaved
input."""
import numpy as np
import pytest

from repro.core.resilience import FaultInjector as JInjector
from repro.io import fastq as jfq
from repro_torch.core.resilience import FaultInjector
from repro_torch.io import fastq as tfq

N = 40


def _fastq(names, rng):
    seqs = ["".join(rng.choice(list("ACGT"), 30)) for _ in names]
    return "".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                   for n, s in zip(names, seqs))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ingest_faults")
    rng = np.random.default_rng(0)
    (d / "se.fq").write_text(_fastq([f"r{i}" for i in range(N)], rng))
    (d / "r1.fq").write_text(_fastq([f"p{i}/1" for i in range(N)], rng))
    (d / "r2.fq").write_text(_fastq([f"p{i}/2" for i in range(N)], rng))
    (d / "il.fq").write_text(_fastq([f"p{i // 2}/{i % 2 + 1}"
                                     for i in range(2 * N)], rng))
    return d


def _open(fq, layout, d, tag, **kw):
    if layout == "single":
        return fq.FastqStream(str(d / "se.fq"), chunk_reads=7,
                              rejects=str(d / f"{tag}.rej"), **kw)
    if layout == "paired":
        return fq.PairedFastqStream(str(d / "r1.fq"), str(d / "r2.fq"),
                                    chunk_reads=7,
                                    rejects=str(d / f"{tag}.rej"), **kw)
    return fq.PairedFastqStream(str(d / "il.fq"), interleaved=True,
                                chunk_reads=7,
                                rejects=str(d / f"{tag}.rej"), **kw)


def _drain(stream):
    out = []
    for chunk in stream:
        parts = chunk if isinstance(chunk, tuple) else (chunk,)
        out.append([(c.names, c.reads.tolist()) for c in parts])
    return out


@pytest.mark.parametrize("layout", ["single", "paired", "interleaved"])
def test_permissive_quarantines_the_reference_records(files, layout):
    got = _open(tfq, layout, files, f"t_{layout}", on_error="permissive",
                injector=FaultInjector.from_spec("record=0.15,seed=3"))
    want = _open(jfq, layout, files, f"j_{layout}", on_error="permissive",
                 injector=JInjector.from_spec("record=0.15,seed=3"))
    assert _drain(got) == _drain(want)
    assert got.n_rejected == want.n_rejected > 0
    assert got.reject_reasons == want.reject_reasons
    assert (files / f"t_{layout}.rej").read_text() == \
        (files / f"j_{layout}.rej").read_text()


@pytest.mark.parametrize("layout,rate", [("single", 0.05),
                                         ("paired", 0.15)])
def test_strict_raises_at_the_reference_record(files, layout, rate):
    errs = []
    for fq, inj in ((tfq, FaultInjector), (jfq, JInjector)):
        with pytest.raises(fq.FastqParseError) as e:
            _drain(_open(fq, layout, files, "strict",
                         injector=inj.from_spec(f"record={rate},seed=3")))
        errs.append((str(e.value), e.value.slug, e.value.lineno,
                     e.value.name))
    assert errs[0] == errs[1]
    assert errs[0][1] == "injected"
