"""The port's spec functions against the reference's, for every arch.

``configs.input_specs``, ``transformer.param_specs``, ``cache_specs`` and
``abstract_params`` and ``optimizer.adafactor_state_specs``: the same
keys, and each partition spec the same tuple of mesh-axis entries
(``tuple(P(...))`` against ``tuple(PartitionSpec(...))``), under the
layouts the dry run and the launcher build.  ``abstract_params`` holds the
reference's shapes and dtypes on ``meta``.  Pure bookkeeping, exact.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as jconfigs
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.core.tree import leaves
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as topt

ARCHS = sorted(tconfigs.ARCHS)
# (batch, model, fsdp, model_size): the 16x16 mesh, the 2x16x16 mesh, the
# flat-dp variant, no mesh, and a model axis of 2 (few KV heads divide it)
LAYOUTS = {
    "16x16": (("data",), ("model",), ("data",), 16),
    "2x16x16": (("pod", "data"), ("model",), ("data",), 16),
    "flat_dp": (("data", "model"), (), ("data",), 1),
    "serve": ((), ("model",), (), 16),
    "model2": (("data",), ("model",), ("data",), 2),
}
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.int8): torch.int8}


def _shardings(name):
    b, m, f, ms = LAYOUTS[name]
    return (jl.Shardings(batch=b, model=m, fsdp=f, model_size=ms),
            tl.Shardings(batch=b, model=m, fsdp=f, model_size=ms))


def _spec_leaves(tree, path=()):
    """{path: tuple(spec)} of a nested dict of the reference's specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_leaves(v, path + (k,)))
        return out
    assert isinstance(tree, (PartitionSpec, tl.P)), (path, tree)
    return {path: tuple(tree)}


def _same_specs(want, got):
    w, g = _spec_leaves(want), _spec_leaves(got)
    assert sorted(w) == sorted(g)
    for path in w:
        assert g[path] == w[path], (path, g[path], w[path])


def test_p_normalises_as_partition_spec():
    for entries in [(None, (), ("model",)), (("pod", "data"), None),
                    ("data", ("model",)), ()]:
        assert tuple(tl.P(*entries)) == tuple(PartitionSpec(*entries))
    assert leaves({"a": tl.P("data", None), "b": [tl.P()]}) == [
        tl.P("data", None), tl.P()]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    jc, tc = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    for name, shape in tconfigs.SHAPES.items():
        for override in (None, 8):
            want = jconfigs.input_specs(jc, jconfigs.SHAPES[name], override)
            got = tconfigs.input_specs(tc, shape, override)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape), (name, k)
                assert got[k].dtype == DTYPES[jnp.dtype(want[k].dtype)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_adafactor_specs_match_reference(arch):
    jc, tc = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    for layout in LAYOUTS:
        jsh, tsh = _shardings(layout)
        want = jt.param_specs(jc, jsh)
        got = tt.param_specs(tc, tsh)
        _same_specs(want, got)
        _same_specs(jopt.adafactor_state_specs(want),
                    topt.adafactor_state_specs(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    jc, tc = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    for layout in LAYOUTS:
        jsh, tsh = _shardings(layout)
        for seq in ((), ("data",), ("pod", "data")):
            for kv_quant in (False, True):
                _same_specs(
                    jt.cache_specs(jc, jsh, seq_shard_axes=seq,
                                   kv_quant=kv_quant),
                    tt.cache_specs(tc, tsh, seq_shard_axes=seq,
                                   kv_quant=kv_quant))


def test_cache_specs_cover_the_cache_tree():
    """cache_specs is keyed as init_cache's tree, leaf for leaf."""
    for arch in ARCHS:
        tc = tconfigs.reduced(tconfigs.ARCHS[arch])
        _, tsh = _shardings("16x16")
        for kv_quant in (False, True):
            if kv_quant and tc.family in ("ssm", "hybrid"):
                continue
            cache = tt.init_cache(tc, 1, 4, kv_quant=kv_quant, device="cpu")
            specs = tt.cache_specs(tc, tsh, kv_quant=kv_quant)
            got = {p: len(s) for p, s in _spec_leaves(specs).items()}
            want = {}

            def walk(t, path=()):
                for k, v in t.items():
                    if isinstance(v, dict):
                        walk(v, path + (k,))
                    else:
                        want[path + (k,)] = v.dim()
            walk(cache)
            assert got == want, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    jc, tc = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    want = jt.abstract_params(jc)
    got = tt.abstract_params(tc)
    w = {jax.tree_util.keystr(p): v for p, v in
         jax.tree_util.tree_flatten_with_path(want)[0]}
    g = {jax.tree_util.keystr(p): v for p, v in
         jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].device.type == "meta", k
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        assert g[k].dtype == DTYPES[jnp.dtype(w[k].dtype)], k
    # and the param specs name every leaf, with one entry a dim
    _, tsh = _shardings("16x16")
    dims = {p: len(s) for p, s in _spec_leaves(tt.param_specs(tc, tsh))
            .items()}
    for k, v in g.items():
        path = tuple(x.strip("[]'") for x in k.split("]["))
        assert dims[path] == v.dim(), k
