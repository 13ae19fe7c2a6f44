"""The port's sharded index (``repro_torch.index``) against the reference's
(``repro.index``) on the CPU: the 2-bit packing, the on-disk format, the
streamed build on both minimizer backends (byte for byte, at an origin
straddling 2^31 too), indexes crossing between the packages, the
integrity checks, ``shard_flat_index`` and the ``build_index`` launcher.

The world: three contigs of a few kb (one with an N run), 60-base reads
geometry (k=10, w=12, eth=4) as the reference's index tests use, odd
tiles."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.core.encoding import pack_2bit as ref_pack_2bit
from repro.core.encoding import unpack_2bit as ref_unpack_2bit
from repro.core.index import build_index as ref_build_flat
from repro.data.genome import make_reference, write_fasta
from repro.index import build_sharded_index as ref_build
from repro.index import format as ref_fmt
from repro.index import open_index as ref_open
from repro.index import shard_flat_index as ref_shard
from repro.index import verify_index as ref_verify
from repro_torch.core.encoding import pack_2bit, unpack_2bit
from repro_torch.core.index import GenomeIndex
from repro_torch.index import (IndexFormatError, IndexIntegrityError,
                               build_sharded_index, load_index, open_index,
                               shard_flat_index, verify_index)
from repro_torch.index import build as port_build
from repro_torch.index import format as fmt
from repro_torch.launch import build_index as build_cli

READ_LEN, K, W, ETH = 60, 10, 12, 4
GEOM = dict(read_len=READ_LEN, k=K, w=W, eth=ETH)
ORIGIN = 2**31 - 1500       # positions straddle the int32 boundary
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_index")
    rng = np.random.default_rng(7)
    contigs = [("chr1", make_reference(4000, seed=1, repeat_frac=0.05)),
               ("chr2", make_reference(2500, seed=2, repeat_frac=0.0)),
               ("chr3", rng.integers(0, 4, 900).astype(np.uint8))]
    contigs[0][1][150:156] = 4  # an N run inside a contig
    write_fasta(d / "ref.fa", contigs)
    return d


def _files(path):
    return sorted(f for f in os.listdir(path) if not f.startswith("."))


def _assert_same_dir(a, b):
    """Every ``.npy`` byte-identical; manifests equal apart from
    ``build.wall_s``."""
    assert _files(a) == _files(b)
    for f in _files(a):
        x, y = (open(os.path.join(p, f), "rb").read() for p in (a, b))
        if f == "manifest.json":
            mx, my = json.loads(x), json.loads(y)
            mx["build"].pop("wall_s")
            my["build"].pop("wall_s")
            assert mx == my
        else:
            assert x == y, f


# ----------------------------------------------------------------- packing

@pytest.mark.parametrize("n", [1, 4, 7, 8, 31, 64, 301])
def test_pack_unpack_match_reference(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 5, (3, n)).astype(np.uint8)   # incl. sentinel
    packed, sent = fmt.pack_codes(codes)
    want_p, want_s = ref_fmt.pack_codes(codes)
    assert np.array_equal(packed, want_p) and np.array_equal(sent, want_s)
    assert np.array_equal(fmt.unpack_codes(packed, sent, n), codes)
    bases = codes[0] % 4
    assert np.array_equal(pack_2bit(bases), ref_pack_2bit(bases))
    assert np.array_equal(unpack_2bit(pack_2bit(bases), n),
                          ref_unpack_2bit(ref_pack_2bit(bases), n))


@pytest.mark.parametrize("origin", [0, 5, ORIGIN])
@pytest.mark.parametrize("seg_len", [1, 8, 13, 118])
def test_packed_segments_equal_gather(origin, seg_len):
    """The build's realigned segment bytes equal ``pack_codes`` of the
    reference's gather, at every start phase, inside the reference and
    reaching past either end."""
    rng = np.random.default_rng(seg_len)
    codes = rng.integers(0, 5, 1003).astype(np.uint8)
    packed, sent = fmt.pack_codes(codes)
    ref = ref_fmt.PackedReference(packed, sent, origin + len(codes),
                                  origin=origin)
    starts = origin + np.arange(-seg_len - 3, len(codes) + 3)
    got = port_build._packed_segments(ref, starts, seg_len)
    want = ref_fmt.pack_codes(ref.gather(starts[:, None]
                                         + np.arange(seg_len)))
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


# ------------------------------------------------------------- the build

@pytest.mark.parametrize("origin", [0, ORIGIN])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_build_byte_identical_to_reference(world, tmp_path, backend, origin):
    kw = dict(num_partitions=4, tile_bp=777, origin=origin, **GEOM)
    ref_build(world / "ref.fa", tmp_path / "ref", **kw)
    idx = build_sharded_index(world / "ref.fa", tmp_path / "port",
                              device="cpu", backend=backend, **kw)
    _assert_same_dir(tmp_path / "ref", tmp_path / "port")
    assert idx.manifest["position_dtype"] == ("int64" if origin else "int32")
    assert idx.manifest["build"]["tiles"] == -(-(idx.ref_len - origin)
                                               // 777)


def test_v1_builds_match_and_cross_load(world, tmp_path):
    kw = dict(num_partitions=2, tile_bp=1001, format_version=1, **GEOM)
    ref_build(world / "ref.fa", tmp_path / "ref", **kw)
    build_sharded_index(world / "ref.fa", tmp_path / "port", device="cpu",
                        **kw)
    _assert_same_dir(tmp_path / "ref", tmp_path / "port")
    man = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert man["format"] == fmt.FORMAT_VERSION_V1
    assert "origin" not in man
    got = open_index(tmp_path / "ref")
    assert got.manifest["origin"] == 0
    assert got.manifest["position_dtype"] == "int32"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_index_of_either_package_loads_in_the_other(world, tmp_path, writer):
    kw = dict(num_partitions=4, tile_bp=513, **GEOM)
    if writer == "reference":
        ref_build(world / "ref.fa", tmp_path / "idx", **kw)
    else:
        build_sharded_index(world / "ref.fa", tmp_path / "idx",
                            device="cpu", **kw)
    a, b = ref_open(tmp_path / "idx"), load_index(tmp_path / "idx")
    assert a.num_partitions == b.num_partitions == 4
    assert [(c.name, c.length, c.offset) for c in a.contigs] == \
        [(c.name, c.length, c.offset) for c in b.contigs]
    for pa, pb in zip(a.parts, b.parts):
        for f in ("kmers", "offsets", "positions"):
            x, y = np.asarray(getattr(pa, f)), np.asarray(getattr(pb, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert np.array_equal(pa.read_segments(), pb.read_segments())
    assert np.array_equal(a.reference_codes(), b.reference_codes())
    assert a.storage_bytes() == b.storage_bytes()
    km = int(np.asarray(a.parts[1].kmers)[0])
    assert np.array_equal(a.lookup(km), b.lookup(km))
    flat = b.to_genome_index()
    want = ref_build_flat(a.reference_codes(), **GEOM)
    assert isinstance(flat, GenomeIndex)
    for f in ("uniq_kmers", "offsets", "positions", "segments"):
        assert np.array_equal(getattr(flat, f), np.asarray(getattr(want, f)))
    assert verify_index(tmp_path / "idx") == ref_verify(tmp_path / "idx")


def test_flipped_byte_fails_verify_in_both(world, tmp_path):
    out = tmp_path / "idx"
    build_sharded_index(world / "ref.fa", out, num_partitions=2,
                        tile_bp=777, device="cpu", **GEOM)
    verify_index(out)
    with pytest.raises(ValueError, match="already holds an index"):
        build_sharded_index(world / "ref.fa", out, num_partitions=2,
                            device="cpu", **GEOM)
    target = out / "part0001.seg2bit.npy"
    blob = bytearray(target.read_bytes())
    blob[-1] ^= 0xFF
    target.write_bytes(bytes(blob))
    for verify in (verify_index, ref_verify):
        with pytest.raises(ValueError, match="crc32"):
            verify(out)
    with pytest.raises(IndexIntegrityError, match="part0001.seg2bit"):
        load_index(out)
    open_index(out, verify="size")      # a size check misses a bit flip
    target.write_bytes(bytes(blob[:-8]))
    with pytest.raises(IndexIntegrityError, match="bytes on disk"):
        open_index(out)


def test_manifest_gates(world, tmp_path):
    out = tmp_path / "idx"
    build_sharded_index(world / "ref.fa", out, num_partitions=1,
                        device="cpu", **GEOM)
    man = json.loads((out / "manifest.json").read_text())
    with pytest.raises(IndexFormatError, match="no manifest.json"):
        open_index(tmp_path)
    bad = dict(man, format="repro-sharded-index/999")
    (out / "manifest.json").write_text(json.dumps(bad))
    with pytest.raises(IndexFormatError, match="repro-sharded-index/999"):
        open_index(out)
    bad = dict(man, format=fmt.FORMAT_VERSION_V1, origin=100)
    (out / "manifest.json").write_text(json.dumps(bad))
    with pytest.raises(IndexFormatError, match="nonzero origin"):
        open_index(out)


def test_build_validation(world, tmp_path):
    for bad in (0, 3, 6):
        with pytest.raises(ValueError,
                           match=rf"num_partitions={bad}.*power of two"):
            build_sharded_index(world / "ref.fa", tmp_path / "x",
                                num_partitions=bad, device="cpu", **GEOM)
    with pytest.raises(ValueError, match=r"tile_bp=4.*minimizer window"):
        build_sharded_index(world / "ref.fa", tmp_path / "x", tile_bp=4,
                            device="cpu", **GEOM)
    with pytest.raises(ValueError, match="format_version"):
        build_sharded_index(world / "ref.fa", tmp_path / "x", origin=100,
                            format_version=1, device="cpu", **GEOM)
    empty = tmp_path / "empty.fa"
    empty.write_text(">c1\n")
    with pytest.raises(ValueError, match="no sequence"):
        build_sharded_index(empty, tmp_path / "y", device="cpu", **GEOM)


def test_pl_cap_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 40).astype(np.uint8)
    ref = np.concatenate([np.tile(unit, 60),
                          rng.integers(0, 4, 1500).astype(np.uint8)])
    write_fasta(tmp_path / "rep.fa", [("chrR", ref)])
    kw = dict(num_partitions=4, tile_bp=333, max_pls_per_minimizer=8,
              **GEOM)
    ref_build(tmp_path / "rep.fa", tmp_path / "ref", **kw)
    idx = build_sharded_index(tmp_path / "rep.fa", tmp_path / "port",
                              device="cpu", **kw)
    _assert_same_dir(tmp_path / "ref", tmp_path / "port")
    assert idx.manifest["build"]["dropped_pls"] > 0


# --------------------------------------------------------- in-memory index

def test_shard_flat_index_matches_reference(world):
    ref = make_reference(3000, seed=4, repeat_frac=0.02)
    want_flat = ref_build_flat(ref, **GEOM)
    flat = GenomeIndex.from_arrays(
        want_flat.uniq_kmers, want_flat.offsets, want_flat.positions,
        want_flat.segments, **GEOM)
    want = ref_shard(want_flat, 4, ref=ref)
    got = shard_flat_index(flat, 4, ref=ref)
    for pa, pb in zip(want.parts, got.parts):
        for f in ("kmers", "offsets", "positions", "segments"):
            x, y = np.asarray(getattr(pa, f)), np.asarray(getattr(pb, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert got.storage_bytes() == want.storage_bytes()
    assert np.array_equal(got.reference_codes(), ref)
    assert np.array_equal(got.to_genome_index().segments, flat.segments)
    mw, mg = want.to_mesh_shards(), got.to_mesh_shards()   # shard i = part i
    for f in ("uniq_kmers", "offsets", "positions", "segments"):
        x, y = getattr(mw, f), getattr(mg, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    with pytest.raises(ValueError, match="power of two"):
        shard_flat_index(flat, 3)


@pytest.mark.parametrize("parts", [2, 4])
def test_built_index_shards_match_reference(parts):
    """The port's own flat build (on a CPU device), split by the crossbar
    rule, stacked for the mesh (partition i on shard i) and sharded
    straight from the flat CSR: the reference's arrays, from its own
    build, byte for byte."""
    from repro.core import distributed as ref_dist
    from repro_torch.core import distributed as port_dist
    from repro_torch.core.index import build_index
    ref = make_reference(3000, seed=4, repeat_frac=0.02)
    want_flat = ref_build_flat(ref, **GEOM)
    flat = build_index(ref, **GEOM, device="cpu")
    want, got = (ref_shard(want_flat, parts, ref=ref),
                 shard_flat_index(flat, parts, ref=ref))
    for pa, pb in zip(want.parts, got.parts, strict=True):
        for f in ("kmers", "offsets", "positions", "segments"):
            x, y = np.asarray(getattr(pa, f)), np.asarray(getattr(pb, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    for mw, mg in ((want.to_mesh_shards(), got.to_mesh_shards()),
                   (ref_dist.shard_index(want_flat, parts),
                    port_dist.shard_index(flat, parts))):
        for f in ("uniq_kmers", "offsets", "positions", "segments"):
            x, y = getattr(mw, f), getattr(mg, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_origin_index_reference_codes_refused(world, tmp_path):
    idx = build_sharded_index(world / "ref.fa", tmp_path / "idx",
                              num_partitions=2, origin=ORIGIN, device="cpu",
                              **GEOM)
    with pytest.raises(ValueError, match="virtual origin"):
        idx.reference_codes()


# -------------------------------------------------------------- launcher

def test_build_index_cli_matches_reference(world, tmp_path, capsys):
    argv = [str(world / "ref.fa"), "--partitions", "2", "--tile-bp", "999",
            "--read-len", str(READ_LEN), "--k", str(K), "--w", str(W),
            "--eth", str(ETH), "--origin", str(ORIGIN), "--verify"]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "repro.launch.build_index",
                           *argv, "-o", str(tmp_path / "ref")], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert build_cli.main([*argv, "-o", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    _assert_same_dir(tmp_path / "ref", tmp_path / "port")
    err = capsys.readouterr().err
    assert "full integrity check passed" in err
    assert "2 partitions, 3 contig(s)" in err
    with pytest.raises(ValueError, match="already holds an index"):
        build_cli.main([*argv, "-o", str(tmp_path / "port"),
                        "--device", "cpu"])
    assert build_cli.main([*argv, "-o", str(tmp_path / "port"),
                           "--device", "cpu", "--force",
                           "--wf-backend", "torch"]) == 0
    _assert_same_dir(tmp_path / "ref", tmp_path / "port")


def test_build_index_cli_obs_matches_reference(world, tmp_path, capsys):
    """``--trace-out``, ``--metrics-out`` and ``--log-json``: the
    reference launcher's span names, metrics snapshot (the build's
    counters) and JSON events, and a trace and snapshot that validate."""
    from repro_torch.obs.validate import (load_json, validate_chrome_trace,
                                          validate_jsonl)
    argv = [str(world / "ref.fa"), "--partitions", "2", "--tile-bp", "999",
            "--read-len", str(READ_LEN), "--k", str(K), "--w", str(W),
            "--eth", str(ETH), "--log-json"]
    out = {}
    for who in ("ref", "port"):
        flags = ["-o", str(tmp_path / who), "--trace-out",
                 str(tmp_path / f"{who}.json"), "--metrics-out",
                 str(tmp_path / f"{who}.jsonl")]
        if who == "ref":
            env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            proc = subprocess.run(
                [sys.executable, "-m", "repro.launch.build_index", *argv,
                 *flags], env=env, capture_output=True, text=True,
                timeout=600)
            assert proc.returncode == 0, proc.stderr
            err = proc.stderr
        else:
            assert build_cli.main([*argv, *flags, "--device", "cpu"]) == 0
            err = capsys.readouterr().err
        trace = load_json(tmp_path / f"{who}.json")
        assert validate_chrome_trace(trace) == []
        snap = [json.loads(ln) for ln in
                (tmp_path / f"{who}.jsonl").read_text().splitlines()]
        events = [json.loads(ln) for ln in err.splitlines()
                  if ln.startswith("{")]
        out[who] = (sorted({e["name"] for e in trace["traceEvents"]
                            if e["ph"] == "X"}),
                    [(s["seq"], s["counters"], s["gauges"]) for s in snap],
                    [(e["event"], re.sub(r"[\d.]+s\b.*", "", e["msg"])
                      .replace(str(tmp_path / who), "OUT"))
                     for e in events])
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["index_partition", "index_scan"]
    assert validate_jsonl(tmp_path / "port.jsonl", load_json(os.path.join(
        SRC, "..", "schemas", "metrics_snapshot.schema.json"))) == []
    _assert_same_dir(tmp_path / "ref", tmp_path / "port")
