"""The port's copy of the paper's cost model (``repro_torch.core.costmodel``)
and its lowTh split (``repro_torch.core.index.minimizer_frequencies``,
``low_th_split``) against the reference's, exactly, on the CPU; and
``examples/quickstart_torch.py``, which prints the split.
"""
import contextlib
import dataclasses
import importlib.util
import inspect
import io
from pathlib import Path

import numpy as np
import pytest

import test_costmodel as ref_tests
from repro.core import costmodel as jcm
from repro.core import index as jindex
from repro.index import build_sharded_index as jbuild_sharded
from repro.io.fasta import load_reference as jload
from repro_torch.core import costmodel as tcm
from repro_torch.core import index as tindex
from repro_torch.data.genome import make_reference, write_fasta
from repro_torch.index import build_sharded_index as tbuild_sharded
from repro_torch.io.fasta import load_reference as tload

ROOT = Path(__file__).resolve().parent.parent


def _public(mod):
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and getattr(v, "__module__", mod.__name__)
            == mod.__name__ and n not in ("annotations",)}


def test_public_names_and_constants_equal_reference():
    """The same public names; every constant and table equal."""
    want, got = _public(jcm), _public(tcm)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if callable(value):
            continue
        assert got[name] == value, name
        assert type(got[name]) is type(value), name


def _calls():
    """(name, args, kwargs) for every public function at the paper's
    settings and off them."""
    yield from (("cycles_" + op, (n,), {}) for op in (
        "and", "xnor", "xor", "copy", "add", "add_bit", "add_const", "sub",
        "mux", "min") for n in (1, 3, 8, 32))
    for b in (1, 3, 8):
        yield "linear_wf_cell_ops", (b,), {}
        yield "linear_wf_cell_ops_closed", (b,), {}
    yield "linear_wf_cycles", (), {}
    yield "linear_wf_cycles", (100, 3, 5), {}
    yield "affine_wf_cycles", (), {}
    for mr in (12.5e3, 25e3, 50e3):
        yield "dart_pim_system", (), {"max_reads": mr}
        yield "speedup_table", (mr,), {}
    yield "dart_pim_system", (1e6, 1e3, 3.0, 2.0, 100.0), {}
    yield "sw_vs_wf_latency_ratio", (), {}
    yield "sw_vs_wf_latency_ratio", (16, 2), {}
    rng = np.random.default_rng(0)
    reads = rng.integers(0, 40_000, 500)
    pls = rng.integers(1, 300, 500)
    yield "full_system_simulation", (reads, pls), {}
    yield "full_system_simulation", (reads, pls), {"max_reads": 1000,
                                                   "linear_rows": 16}
    yield "full_system_simulation", (np.zeros(0), np.zeros(0)), {}


def test_every_function_equals_reference():
    """Each public function on the same arguments gives the reference's
    value exactly (plain float operations in the same order)."""
    called = set()
    for name, args, kw in _calls():
        called.add(name)
        want = getattr(jcm, name)(*args, **kw)
        got = getattr(tcm, name)(*args, **kw)
        if dataclasses.is_dataclass(want):
            assert type(got).__name__ == type(want).__name__
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        else:
            assert got == want, (name, args, kw)
    functions = {n for n, v in _public(jcm).items() if inspect.isfunction(v)}
    assert functions <= called, functions - called


def _reference_cases():
    """Each test of the reference's tests/test_costmodel.py, once per
    parametrized case."""
    for name, fn in vars(ref_tests).items():
        if not name.startswith("test_"):
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            yield pytest.param(name, {}, id=name)
            continue
        argnames, values = marks[0].args[:2]
        argnames = [a.strip() for a in argnames.split(",")]
        for v in values:
            v = v if isinstance(v, tuple) else (v,)
            yield pytest.param(name, dict(zip(argnames, v)),
                               id=f"{name}-{'-'.join(map(str, v))}")


@pytest.mark.parametrize("name,kwargs", list(_reference_cases()))
def test_reference_assertions_hold_on_the_port(name, kwargs, monkeypatch):
    """The reference's own cost-model tests, run against the port's
    module: the paper's Table I/IV values, Eq. 6/7, the headline speedups
    and energy ratios."""
    monkeypatch.setattr(ref_tests, "cm", tcm)
    getattr(ref_tests, name)(**kwargs)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """One two-contig FASTA (2% repeats, so some minimizers are frequent)."""
    path = tmp_path_factory.mktemp("lowth") / "ref.fa"
    ref = make_reference(60_000, seed=3, repeat_frac=0.02)
    write_fasta(path, [("chrA", ref[:35_000]), ("chrB", ref[35_000:])])
    return path


@pytest.mark.parametrize("low_th", [1, 3, 8])
def test_low_th_split_equals_reference(fasta, low_th):
    """``minimizer_frequencies`` and ``low_th_split`` on both packages'
    indexes of one FASTA: equal counts and fractions (the port's offsets
    are int64, the reference's int32)."""
    jref, _ = jload(fasta, spacer=400)
    tref, _ = tload(fasta, spacer=400)
    np.testing.assert_array_equal(tref, jref)
    jidx = jindex.build_index(jref)
    tidx = tindex.build_index(tref, device="cpu")
    want_f = jindex.minimizer_frequencies(jidx)
    got_f = tindex.minimizer_frequencies(tidx)
    assert got_f.dtype == np.int64 and want_f.dtype == np.int32
    np.testing.assert_array_equal(got_f, want_f)
    want = jindex.low_th_split(jidx, low_th)
    got = tindex.low_th_split(tidx, low_th)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got.pop("rare_mask"),
                                  want.pop("rare_mask"))
    assert got == want
    assert 0 < got["n_rare_minimizers"] <= got["n_minimizers"]


def test_low_th_split_of_merged_sharded_index(fasta, tmp_path):
    """A sharded index has no flat offsets in either package (nor a
    ``low_th_split`` of its own); merged by ``to_genome_index`` it splits
    as the reference's merged index does, and as the flat index does."""
    jsh = jbuild_sharded(fasta, str(tmp_path / "ref"), num_partitions=4)
    tsh = tbuild_sharded(fasta, str(tmp_path / "port"), num_partitions=4,
                         device="cpu")
    want = jindex.low_th_split(jsh.to_genome_index(), 3)
    got = tindex.low_th_split(tsh.to_genome_index(), 3)
    np.testing.assert_array_equal(got.pop("rare_mask"),
                                  want.pop("rare_mask"))
    assert got == want
    flat = tindex.low_th_split(tindex.build_index(
        tload(fasta, spacer=tsh.spacer)[0], device="cpu"), 3)
    flat.pop("rare_mask")
    assert got == flat


def test_quickstart_example_prints_the_reference_split():
    """``examples/quickstart_torch.py --device cpu`` maps its reads and
    prints the index's lowTh split, the reference's numbers."""
    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(["--device", "cpu", "--genome", "20000", "--reads", "8"])
    text = out.getvalue()
    assert "mapped 8/8 reads; accuracy(+-band) = 1.000" in text
    ref = make_reference(20_000, seed=0, repeat_frac=0.02)
    s = jindex.low_th_split(jindex.build_index(ref), low_th=3)
    assert (f"lowTh=3 split: {s['n_rare_minimizers']} of "
            f"{s['n_minimizers']} minimizers rare "
            f"({s['rare_minimizer_fraction']:.4f}), "
            f"{s['rare_pl_fraction']:.4f} of the PL work") in text
