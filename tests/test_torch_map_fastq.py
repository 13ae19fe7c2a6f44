"""The port's ``map_fastq`` CLI (run in-process with ``--device cpu``)
against the reference CLI (run as a subprocess): the same FASTA and FASTQ
give the same SAM line for line apart from ``@PG``, which records the
command.  The world is the reference e2e test's: two contigs with an N
run and 24 reads of 120 bases on both strands, plus a copy of the FASTQ
with one malformed record for the permissive path; and 24 pairs of those
contigs (some R2 mates junk) as R1/R2 files, one interleaved file and an
R2 file that lost a record (a mate desync); and sharded indexes of the
FASTA built by each package (``--index-dir``).  Injected faults under
``--on-error permissive`` and the ``--trace-out``, ``--metrics-out`` and
``--log-json`` surfaces are held to the reference CLI's too."""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.data.genome import (make_reference, sample_pairs, sample_reads,
                               write_fasta, write_fastq, write_fastq_pair)
from repro_torch.io.fastq import FastqParseError
from repro_torch.io.sam import validate_sam
from repro_torch.launch import map_fastq
from repro_torch.obs.validate import (load_json, validate_chrome_trace,
                                      validate_jsonl)

READ_LEN = 120
N_READS = 24
BAD_RECORD = 5
N_PAIRS = 24
LOST_MATE = 5
INJECT = "record=0.1,bucket=0.2,poison=3;11,seed=3"
PAIR_INJECT = "record=0.1,poison=2;30,seed=4"
SCHEMA = os.path.join(os.path.dirname(__file__), "..", "schemas",
                      "metrics_snapshot.schema.json")

# the reference runs: (name, FASTQ, argv).  The reference's three engines
# write the same SAM, so each engine is run once, each with one of the
# other cases: single strand, an odd chunk size, the permissive path.
REF_RUNS = (
    ("compacted", "reads.fq", ("--engine", "compacted")),
    ("fused_single", "reads.fq", ("--engine", "fused", "--single-strand")),
    ("padded_chunk7", "reads.fq", ("--engine", "padded",
                                   "--chunk-reads", "7")),
    ("permissive", "bad.fq", ("--on-error", "permissive", "--rejects",
                              "ref_rejects.fq")),
    ("inject", "reads.fq", ("--on-error", "permissive", "--rejects",
                            "ref_inject_rejects.fq", "--inject", INJECT)),
    ("obs", "reads.fq", ("--trace-out", "ref_trace.json", "--metrics-out",
                         "ref_metrics.jsonl", "--log-json")),
    ("mesh", "reads.fq", ("--topology", "mesh", "--shards", "2")),
    ("shards4", "reads.fq", ("--shards", "4")),
)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_map_fastq")
    c1 = make_reference(5_000, seed=0, repeat_frac=0.02)
    c2 = make_reference(3_000, seed=5, repeat_frac=0.0)
    c1[700:704] = 4  # an N run in the reference
    write_fasta(d / "ref.fa", [("chr1", c1), ("chr2", c2)])
    rs1 = sample_reads(c1, N_READS // 2, read_len=READ_LEN, seed=3,
                       both_strands=True)
    rs2 = sample_reads(c2, N_READS // 2, read_len=READ_LEN, seed=9,
                       both_strands=True)
    write_fastq(d / "reads.fq", np.concatenate([rs1.reads, rs2.reads]),
                np.concatenate([rs1.quals, rs2.quals]),
                [f"read{i}" for i in range(N_READS)])
    lines = (d / "reads.fq").read_text().splitlines(True)
    q = 4 * BAD_RECORD + 3                 # one record's quality line
    lines[q] = lines[q][:-6] + "\n"        # 5 qualities short
    (d / "bad.fq").write_text("".join(lines))
    return d


@pytest.fixture(scope="module")
def paired_world(world):
    """Pairs of both contigs; the same pairs interleaved; R2 with the mate
    of pair ``LOST_MATE`` lost."""
    ref = world / "ref.fa"
    from repro.io.fasta import parse_fasta
    contigs = [codes for _, codes in parse_fasta(str(ref))]
    halves = [sample_pairs(c, N_PAIRS // 2, read_len=READ_LEN,
                           insert_mean=300, insert_sd=30, seed=11 + i,
                           unmappable_frac=0.15)
              for i, c in enumerate(contigs)]
    ps = type(halves[0])(*(np.concatenate([getattr(h, f) for h in halves])
                           for f in halves[0].__dataclass_fields__))
    write_fastq_pair(str(world / "r1.fq"), str(world / "r2.fq"), ps)
    write_fastq_pair(None, None, ps, interleaved_path=str(world / "i.fq"))
    lines = (world / "r2.fq").read_text().splitlines(True)
    del lines[4 * LOST_MATE : 4 * LOST_MATE + 4]
    (world / "r2_lost.fq").write_text("".join(lines))
    return world


def _ref_cli(world, runs):
    """The reference CLI's SAM and stderr for each of ``runs`` (name,
    inputs, argv), at most four subprocesses at a time."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(os.path.dirname(__file__), "..",
                                      "src") +
                         os.pathsep + env.get("PYTHONPATH", ""))

    def one(run):
        name, inputs, argv = run
        fasta = [] if "--index-dir" in argv else [str(world / "ref.fa")]
        cmd = [sys.executable, "-m", "repro.launch.map_fastq",
               *fasta, *inputs,
               "-o", str(world / f"ref_{name}.sam"), "--chunk-reads", "16",
               *argv]
        proc = subprocess.run(cmd, env=env, cwd=str(world),
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        return name, ((world / f"ref_{name}.sam").read_text(), proc.stderr)
    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(pool.map(one, runs))


@pytest.fixture(scope="module")
def ref_runs(world):
    """The reference CLI's SAM and stderr for each of ``REF_RUNS``."""
    return _ref_cli(world, [(name, [str(world / fq)], argv)
                            for name, fq, argv in REF_RUNS])


@pytest.fixture(scope="module")
def ref_sams(ref_runs):
    return {name: sam for name, (sam, _) in ref_runs.items()}


# the reference's paired runs: (name, inputs, argv).  Its three engines
# write the same SAM, so the two-file layout is run once, and the
# interleaved one on another engine and chunk size.
REF_PAIRED_RUNS = (
    ("pairs", ("--r1", "r1.fq", "--r2", "r2.fq"), ()),
    ("pairs_inject", ("--r1", "r1.fq", "--r2", "r2.fq"),
     ("--on-error", "permissive", "--rejects", "ref_pair_inject_rejects.fq",
      "--inject", PAIR_INJECT)),
    ("pairs_interleaved", ("i.fq", "--interleaved"),
     ("--engine", "fused", "--chunk-reads", "7")),
    ("pairs_permissive", ("--r1", "r1.fq", "--r2", "r2_lost.fq"),
     ("--on-error", "permissive", "--rejects", "ref_pair_rejects.fq")),
    ("pairs_mesh", ("--r1", "r1.fq", "--r2", "r2.fq"),
     ("--topology", "mesh", "--shards", "2")),
)


@pytest.fixture(scope="module")
def ref_paired(paired_world):
    """The reference CLI's SAM and stderr for each of
    ``REF_PAIRED_RUNS``."""
    w = paired_world
    return _ref_cli(w, [(name, [str(w / a) if a.endswith(".fq") else a
                                for a in inputs], argv)
                        for name, inputs, argv in REF_PAIRED_RUNS])


def _body(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


def _port(world, out_name, *argv, fq="reads.fq", chunk_reads=16):
    rc = map_fastq.main([str(world / "ref.fa"), str(world / fq),
                         "-o", str(world / out_name),
                         "--chunk-reads", str(chunk_reads),
                         "--device", "cpu", *argv])
    assert rc == 0
    return (world / out_name).read_text()


@pytest.mark.parametrize("engine", ["compacted", "fused", "padded"])
def test_same_sam_as_reference(world, ref_sams, engine, capsys):
    text = _port(world, f"port_{engine}.sam", "--engine", engine)
    assert _body(text) == _body(ref_sams["compacted"])
    stats = validate_sam(text, expect_reads=N_READS)
    assert stats["n_mapped"] == N_READS and stats["n_reverse"] > 0
    assert "PN:repro_torch.launch.map_fastq" in text
    err = capsys.readouterr().err
    assert f"done: {N_READS} reads" in err
    if engine == "padded":      # no instance accounting on that engine
        assert "filter/affine" not in err and "plan cache:" in err
    else:
        assert "filter/affine [single]" in err and "index storage:" in err


@pytest.mark.parametrize("engine", ["fused", "padded"])
def test_single_strand_same_sam(world, ref_sams, engine):
    text = _port(world, f"port_single_{engine}.sam", "--engine", engine,
                 "--single-strand")
    assert _body(text) == _body(ref_sams["fused_single"])
    assert validate_sam(text, expect_reads=N_READS)["n_reverse"] == 0


@pytest.mark.parametrize("engine", ["compacted", "padded"])
def test_odd_chunk_same_sam(world, ref_sams, engine):
    text = _port(world, f"port_chunk7_{engine}.sam", "--engine", engine,
                 chunk_reads=7)
    assert _body(text) == _body(ref_sams["padded_chunk7"])


def test_permissive_same_sam_and_rejects(world, ref_sams, capsys):
    text = _port(world, "port_permissive.sam", "--on-error", "permissive",
                 "--rejects", str(world / "port_rejects.fq"), fq="bad.fq")
    assert _body(text) == _body(ref_sams["permissive"])
    assert validate_sam(text, expect_reads=N_READS - 1)
    assert (world / "port_rejects.fq").read_text() == \
        (world / "ref_rejects.fq").read_text()
    assert f"@read{BAD_RECORD}\n" in (world / "port_rejects.fq").read_text()
    assert "quarantined: 1 malformed record(s)" in capsys.readouterr().err


def test_strict_stops_at_the_malformed_record(world):
    with pytest.raises(FastqParseError, match="qualities"):
        _port(world, "port_strict.sam", fq="bad.fq")
    assert not (world / "port_strict.sam").exists()
    assert (world / "port_strict.sam.partial").exists()


def test_stdout_output(world, ref_sams, capsys):
    rc = map_fastq.main([str(world / "ref.fa"), str(world / "reads.fq"),
                         "--chunk-reads", "16", "--device", "cpu"])
    assert rc == 0
    assert _body(capsys.readouterr().out) == _body(ref_sams["compacted"])


def _cigars(text):
    return {ln.split("\t")[5] for ln in _body(text)
            if not ln.startswith("@")}


@pytest.mark.parametrize("argv,run", [
    (("--topology", "mesh", "--shards", "2"), "mesh"),
    (("--shards", "4"), "shards4"),
])
def test_mesh_flags_same_sam_as_reference(world, ref_runs, argv, run,
                                          capsys):
    """``--topology mesh --shards 2``: the reference's mesh SAM (CIGAR
    ``*``) and closing ``stage B [mesh]`` line; ``--shards`` alone is
    ignored off the mesh, as by the reference."""
    text = _port(world, f"port_{run}.sam", *argv)
    want, want_err = ref_runs[run]
    assert _body(text) == _body(want)
    validate_sam(text, expect_reads=N_READS)
    err = capsys.readouterr().err
    label = "stage B [mesh]:" if run == "mesh" else "filter/affine [single]:"
    assert _line(err, label) == _line(want_err, label)
    assert _line(err, "plan cache:") == _line(want_err, "plan cache:")
    assert (_cigars(text) == {"*"}) == (run == "mesh")


def test_inject_permissive_same_sam_and_rejects(world, ref_runs, capsys):
    """Corrupted records, poisoned rows and transient block faults from
    one seeded spec: the reference CLI's SAM (quarantined rows as unmapped
    records) and rejects file, with the fetch watchdog armed."""
    text = _port(world, "port_inject.sam", "--on-error", "permissive",
                 "--rejects", str(world / "port_inject_rejects.fq"),
                 "--inject", INJECT, "--watchdog", "60")
    want, want_err = ref_runs["inject"]
    assert _body(text) == _body(want)
    rejects = (world / "port_inject_rejects.fq").read_text()
    assert rejects == (world / "ref_inject_rejects.fq").read_text()
    assert rejects.count("@") >= 1
    err = capsys.readouterr().err
    assert _line(err, "quarantined:").split(" -> ")[0] == \
        _line(want_err, "quarantined:").split(" -> ")[0]
    # the same counts and ladder: the reference maps on jnp, the port on
    # the cuda backend (its plain versions on the CPU)
    assert _line(err, "resilience:") == \
        _line(want_err, "resilience:").replace("/jnp", "/cuda")


def _json_events(err):
    out = []
    for ln in err.splitlines():
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue
        out.append((rec["event"], sorted(rec)))
    return out


# the port's counters of its chunk schedule, which the reference lacks
PORT_COUNTERS = ("repro_device_syncs_total", "repro_h2d_bytes_total",
                 "repro_d2h_bytes_total")
# the port's spans of its index build and its chunk schedule, which the
# reference lacks
PORT_SPANS = {"index.build", "index.scan", "index.sort", "index.segments",
              "mapper.run", "host_prep", "h2d", "sync", "fetch_wait",
              "assemble"}


def _counts(snapshot):
    return {k: v for k, v in snapshot["counters"].items()
            if not k.startswith(("repro_stage_seconds",) + PORT_COUNTERS)}


def test_obs_flags_write_the_references_trace_metrics_and_log(
        world, ref_runs, capsys):
    """``--trace-out``, ``--metrics-out`` and ``--log-json``: a valid
    trace with the reference's span names, a snapshot a chunk plus a
    final one with the reference's metric names and counts (times aside)
    that validates against the schema, and the reference's JSON events;
    the SAM is unchanged.  The trace's per-stage durations equal the
    stage-seconds counters.  The port adds the index build's spans and
    the chunk schedule's (``PORT_SPANS``: its stages on the streamed path,
    syncs, waits) and their counters, which read the trace's numbers."""
    text = _port(world, "port_obs.sam", "--trace-out",
                 str(world / "trace.json"), "--metrics-out",
                 str(world / "metrics.jsonl"), "--log-json")
    assert _body(text) == _body(ref_runs["compacted"][0])
    err = capsys.readouterr().err
    trace, want_trace = (load_json(world / f"{p}trace.json")
                         for p in ("", "ref_"))
    assert validate_chrome_trace(trace) == []

    def names(t):
        return sorted({e["name"] for e in t["traceEvents"]
                       if e["ph"] == "X"})
    assert names(trace) == sorted(set(names(want_trace)) | PORT_SPANS)
    assert {"ingest", "sam_emit", "seed", "d2h"} <= set(names(trace))
    assert validate_jsonl(world / "metrics.jsonl", load_json(SCHEMA)) == []
    snaps, want_snaps = ([json.loads(ln) for ln in
                          (world / f"{p}metrics.jsonl").read_text()
                          .splitlines()] for p in ("", "ref_"))
    assert [s["seq"] for s in snaps] == [s["seq"] for s in want_snaps]
    assert [_counts(s) for s in snaps] == [_counts(s) for s in want_snaps]
    spans, port = {}, {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
            a = e.get("args", {})
            key = {"sync": ('repro_device_syncs_total'
                            f'{{site="{a.get("site")}"}}'),
                   "h2d": 'repro_h2d_bytes_total{memory="pageable"}',
                   "d2h": 'repro_d2h_bytes_total{memory="pageable"}'}.get(
                       e["name"])
            if key is not None:
                port[key] = port.get(key, 0) + a.get("bytes", 1)
    assert {k: v for k, v in snaps[-1]["counters"].items()
            if k.startswith(PORT_COUNTERS)} == port
    port.update({f'repro_stage_seconds_total{{stage="{s}"}}': 0
                 for s in ("host_prep", "h2d")})
    assert sorted(snaps[-1]["counters"]) == sorted(
        set(want_snaps[-1]["counters"]) | set(port))
    for k, v in snaps[-1]["counters"].items():
        if k.startswith("repro_stage_seconds"):
            stage = k.split('stage="')[1].rstrip('"}')
            assert spans[stage] == pytest.approx(v, rel=1e-6, abs=1e-7)
    assert _json_events(err) == _json_events(ref_runs["obs"][1])


def test_no_device_and_no_gpu_raises(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        map_fastq.main([str(world / "ref.fa"), str(world / "reads.fq"),
                        "-o", str(world / "nodev.sam")])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_card_refuses_eth_before_the_index_build(world, monkeypatch,
                                                 backend):
    """``--eth 13`` on the card with the kernels (``--wf-backend cuda``,
    the default) fails before the FASTA load and the index build, naming
    ``eth``; with ``--wf-backend torch`` no kernel runs and the run goes on
    to load the FASTA (stopped there: this machine has no card)."""
    import repro_torch.io.fasta as fasta

    class Reached(Exception):
        pass

    def stop(*a, **k):
        raise Reached("reached the FASTA load")
    monkeypatch.setattr(fasta, "load_reference", stop)
    argv = [str(world / "ref.fa"), str(world / "reads.fq"), "-o",
            str(world / "eth13.sam"), "--device", "cuda", "--eth", "13",
            "--wf-backend", backend]
    if backend == "cuda":
        with pytest.raises(ValueError, match="^eth=13 "):
            map_fastq.main(argv)
    else:
        with pytest.raises(Reached, match="FASTA load"):
            map_fastq.main(argv)
    assert not (world / "eth13.sam").exists()


def _port_paired(world, out_name, *argv, chunk_reads=16):
    rc = map_fastq.main([str(world / "ref.fa"), *argv,
                         "-o", str(world / out_name),
                         "--chunk-reads", str(chunk_reads),
                         "--device", "cpu"])
    assert rc == 0
    return (world / out_name).read_text()


def _line(err, prefix):
    lines = [ln for ln in err.splitlines() if ln.startswith(prefix)]
    assert len(lines) == 1, err
    return lines[0]


@pytest.mark.parametrize("engine", ["compacted", "fused", "padded"])
def test_paired_same_sam_as_reference(paired_world, ref_paired, engine,
                                      capsys):
    w = paired_world
    text = _port_paired(w, f"port_pairs_{engine}.sam", "--r1",
                        str(w / "r1.fq"), "--r2", str(w / "r2.fq"),
                        "--engine", engine)
    want, want_err = ref_paired["pairs"]
    assert _body(text) == _body(want)
    stats = validate_sam(text, expect_reads=2 * N_PAIRS, require_mapq=True)
    assert stats["n_paired"] == 2 * N_PAIRS and stats["n_proper"] > 0
    err = capsys.readouterr().err
    assert "paired=True" in err
    assert _line(err, "pairing:") == _line(want_err, "pairing:")


def test_interleaved_same_sam_as_reference(paired_world, ref_paired):
    w = paired_world
    text = _port_paired(w, "port_pairs_interleaved.sam", str(w / "i.fq"),
                        "--interleaved", "--engine", "fused", chunk_reads=7)
    assert _body(text) == _body(ref_paired["pairs_interleaved"][0])


@pytest.mark.parametrize("layout", ["r1_r2", "interleaved"])
def test_paired_mesh_same_sam_as_reference(paired_world, ref_paired, layout,
                                           capsys):
    """Paired input on a 2-shard mesh: the reference's mesh SAM (pairing
    FLAGs, MAPQ and mate rescue on CIGAR-less mesh results) from either
    input layout."""
    w = paired_world
    inputs = (("--r1", str(w / "r1.fq"), "--r2", str(w / "r2.fq"))
              if layout == "r1_r2" else (str(w / "i.fq"), "--interleaved"))
    text = _port_paired(w, f"port_pairs_mesh_{layout}.sam", *inputs,
                        "--topology", "mesh", "--shards", "2")
    want, want_err = ref_paired["pairs_mesh"]
    assert _body(text) == _body(want)
    validate_sam(text, expect_reads=2 * N_PAIRS, require_mapq=True)
    err = capsys.readouterr().err
    assert _line(err, "pairing:") == _line(want_err, "pairing:")
    assert _line(err, "stage B [mesh]:") == _line(want_err,
                                                  "stage B [mesh]:")


def test_paired_permissive_same_sam_and_rejects(paired_world, ref_paired,
                                                capsys):
    """A lost R2 record: the permissive stream re-pairs past it, and
    quarantines the orphaned R1 mate in both packages alike."""
    w = paired_world
    text = _port_paired(w, "port_pairs_permissive.sam", "--r1",
                        str(w / "r1.fq"), "--r2", str(w / "r2_lost.fq"),
                        "--on-error", "permissive", "--rejects",
                        str(w / "port_pair_rejects.fq"))
    want, want_err = ref_paired["pairs_permissive"]
    assert _body(text) == _body(want)
    validate_sam(text, expect_reads=2 * (N_PAIRS - 1), require_mapq=True)
    rejects = (w / "port_pair_rejects.fq").read_text()
    assert rejects == (w / "ref_pair_rejects.fq").read_text()
    assert rejects.startswith(f"@pair{LOST_MATE}/1\n")
    got = _line(capsys.readouterr().err, "quarantined:")
    assert got.split(" -> ")[0] == _line(want_err,
                                         "quarantined:").split(" -> ")[0]
    assert "{'mate_desync': 1}" in got


def test_paired_inject_permissive_same_sam_and_rejects(paired_world,
                                                       ref_paired):
    """Injected record faults quarantine both mates of a pair, and a
    poisoned row quarantines its block of the stacked mates: the
    reference CLI's SAM and rejects."""
    w = paired_world
    text = _port_paired(w, "port_pairs_inject.sam", "--r1",
                        str(w / "r1.fq"), "--r2", str(w / "r2.fq"),
                        "--on-error", "permissive", "--rejects",
                        str(w / "port_pair_inject_rejects.fq"),
                        "--inject", PAIR_INJECT)
    assert _body(text) == _body(ref_paired["pairs_inject"][0])
    assert (w / "port_pair_inject_rejects.fq").read_text() == \
        (w / "ref_pair_inject_rejects.fq").read_text()


@pytest.mark.parametrize("argv,msg", [
    (("--r2", "r2.fq"), "--r2 needs --r1"),
    (("--r1", "r1.fq"), "--r1 needs --r2"),
    (("reads.fq", "--r1", "r1.fq", "--r2", "r2.fq"), "not both"),
    (("--r1", "r1.fq", "--r2", "r2.fq", "--interleaved"),
     "--interleaved takes a single"),
    ((), "no reads given"),
])
def test_paired_input_layout_errors(paired_world, argv, msg):
    """The reference's exits for an input layout it does not take."""
    w = paired_world
    argv = [str(w / a) if a.endswith(".fq") else a for a in argv]
    with pytest.raises(SystemExit) as e:
        map_fastq.main([str(w / "ref.fa"), *argv, "--device", "cpu",
                        "-o", str(w / "layout.sam")])
    assert str(e.value.code).startswith("map_fastq: ") and \
        msg in str(e.value.code)
    assert not (w / "layout.sam").exists()


def test_card_refuses_eth_before_the_index_build_on_pairs(paired_world,
                                                          monkeypatch):
    """As ``test_card_refuses_eth_before_the_index_build``, on paired
    input: the stream is opened (for ``read_len``), the card's refusal
    comes before the FASTA load."""
    import repro_torch.io.fasta as fasta

    def stop(*a, **k):
        raise AssertionError("the FASTA load was reached")
    monkeypatch.setattr(fasta, "load_reference", stop)
    w = paired_world
    with pytest.raises(ValueError, match="^eth=13 "):
        map_fastq.main([str(w / "ref.fa"), "--r1", str(w / "r1.fq"),
                        "--r2", str(w / "r2.fq"), "-o",
                        str(w / "eth13_pairs.sam"), "--device", "cuda",
                        "--eth", "13"])
    assert not (w / "eth13_pairs.sam").exists()


# ------------------------------------------------------------ --index-dir

@pytest.fixture(scope="module")
def index_world(paired_world):
    """Sharded indexes of ``ref.fa`` (8 partitions, odd tiles): ``idx``
    built by the reference, ``idx_port`` by the port; both hold the same
    bytes."""
    from repro.index import build_sharded_index as ref_build
    from repro_torch.index import build_sharded_index
    w = paired_world
    kw = dict(num_partitions=8, tile_bp=1001, read_len=READ_LEN)
    ref_build(str(w / "ref.fa"), str(w / "idx"), **kw)
    build_sharded_index(str(w / "ref.fa"), str(w / "idx_port"),
                        device="cpu", **kw)
    return w


@pytest.fixture(scope="module")
def ref_index_sams(index_world):
    """The reference CLI's SAM over ``--index-dir idx``, single-end,
    paired and on an 8-shard mesh (three parallel subprocesses), and the
    mesh run's stderr."""
    w = index_world
    runs = _ref_cli(w, [
        ("index", [str(w / "reads.fq")], ("--index-dir", "idx")),
        ("index_pairs", ["--r1", str(w / "r1.fq"), "--r2", str(w / "r2.fq")],
         ("--index-dir", "idx")),
        ("index_mesh", [str(w / "reads.fq")],
         ("--index-dir", "idx", "--topology", "mesh", "--shards", "8")),
    ])
    out = {name: sam for name, (sam, _) in runs.items()}
    out["index_mesh_err"] = runs["index_mesh"][1]
    return out


def _budget_mb(index_dir):
    """A budget just holding every partition (a chunk of 16 reads on both
    strands touches all eight)."""
    from repro_torch.index import open_index
    idx = open_index(str(index_dir))
    rows = sum(p.n_occurrences for p in idx.parts)
    return str((rows + 1) * (idx.seg_len + 4) / (1 << 20))


def _port_index(w, out_name, *argv):
    rc = map_fastq.main([*argv, "-o", str(w / out_name), "--chunk-reads",
                         "16", "--device", "cpu"])
    assert rc == 0
    return (w / out_name).read_text()


@pytest.mark.parametrize("case", ["reference_index", "port_index_budget"])
def test_index_dir_same_sam_as_reference(index_world, ref_index_sams, case,
                                         capsys):
    """``--index-dir`` on an index of either package writes the reference
    CLI's SAM; the port's index mapped under a budget with prefetch on
    the fused engine, the reference's with a ``--eth`` the manifest
    overrides."""
    w = index_world
    if case == "reference_index":
        argv = ("--index-dir", str(w / "idx"), str(w / "reads.fq"),
                "--eth", "5")
    else:
        argv = ("--index-dir", str(w / "idx_port"), str(w / "reads.fq"),
                "--engine", "fused", "--index-budget-mb",
                _budget_mb(w / "idx_port"), "--prefetch")
    text = _port_index(w, f"port_{case}.sam", *argv)
    assert _body(text) == _body(ref_index_sams["index"])
    validate_sam(text, expect_reads=N_READS)
    err = capsys.readouterr().err
    assert "(8 partitions)" in err and "partitions: routed" in err
    if case == "reference_index":
        assert "--eth 5 ignored; index manifest has eth=6" in err


@pytest.mark.parametrize("index", ["idx", "idx_port"])
def test_index_dir_mesh_same_sam_as_reference(index_world, ref_index_sams,
                                              index, capsys):
    """``--index-dir`` on an 8-shard mesh: partition i of either
    package's index placed on shard i, the reference's mesh SAM and its
    ``partitions: 8 mesh-placed`` line."""
    w = index_world
    text = _port_index(w, f"port_index_mesh_{index}.sam", "--index-dir",
                       str(w / index), str(w / "reads.fq"), "--topology",
                       "mesh", "--shards", "8")
    assert _body(text) == _body(ref_index_sams["index_mesh"])
    validate_sam(text, expect_reads=N_READS)
    assert _cigars(text) == {"*"}
    err = capsys.readouterr().err
    assert _line(err, "partitions:") == \
        _line(ref_index_sams["index_mesh_err"], "partitions:")
    assert "8 mesh-placed" in err


def test_index_dir_paired_same_sam_as_reference(index_world, ref_index_sams):
    """Paired input over ``--index-dir``: mate rescue reads the genome
    from the index's packed reference."""
    w = index_world
    text = _port_index(w, "port_index_pairs.sam", "--index-dir",
                       str(w / "idx_port"), "--r1", str(w / "r1.fq"),
                       "--r2", str(w / "r2.fq"), "--index-budget-mb",
                       _budget_mb(w / "idx_port"), "--prefetch")
    assert _body(text) == _body(ref_index_sams["index_pairs"])
    validate_sam(text, expect_reads=2 * N_PAIRS, require_mapq=True)


@pytest.mark.parametrize("argv,msg", [
    (("ref.fa", "reads.fq", "--prefetch"),
     "--prefetch needs --index-dir with --topology single — only the "
     "shard-routed arena path has per-chunk partition uploads to overlap"),
    (("--index-dir", "idx", "reads.fq", "--read-len", "100"),
     "--read-len 100 conflicts with the index's read_len=120"),
    (("ref.fa", "reads.fq", "--index-dir", "idx"),
     "pass either a FASTA reference or --index-dir, not both"),
    (("--r1", "r1.fq", "--r2", "r2.fq"),
     "a FASTA reference (positional) or --index-dir is required"),
])
def test_index_dir_exits_in_the_reference_words(index_world, argv, msg):
    w = index_world
    argv = [str(w / a) if a.endswith((".fq", ".fa")) or a == "idx" else a
            for a in argv]
    with pytest.raises(SystemExit) as e:
        map_fastq.main([*argv, "--device", "cpu", "-o",
                        str(w / "exit.sam")])
    assert str(e.value.code).startswith("map_fastq: ")
    assert msg in str(e.value.code)
    assert not (w / "exit.sam").exists()
