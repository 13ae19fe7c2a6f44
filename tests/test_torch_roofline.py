"""The port's roofline (``repro_torch.launch.roofline``) and dry run
(``repro_torch.launch.dryrun``) on the CPU.

* Every analytic term equals the reference's exactly, for every (arch,
  shape) on both production meshes; only the hardware constants differ
  (the H100's), so the times are the reference's terms over them.
* The reference's ``tests/test_roofline.py`` cases, their ranges
  re-derived for the H100: the reference bounds a 72B train step's
  compute time within 1-60 s at 197 TFLOP/s; the same FLOPs at 989
  TFLOP/s take 197/989 of that time, so the bounds become 0.199-11.95 s.
* ``FlopCounterMode`` over the port's forward, unrolled layer by layer on
  ``meta`` tensors, within the reference's 0.15 (dense) and 0.25 (moe) of
  ``forward_flops`` (its test holds XLA's count to the same bars).
* One dry-run cell on a fake 2x4 mesh in a subprocess: status OK, the
  argument bytes the local shards' bytes summed by hand, and SKIP where
  ``cell_applicable`` says so.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.launch import roofline as jrl
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import roofline as rl
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

ROOT = Path(__file__).resolve().parent.parent
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
ARCHS = sorted(tconfigs.ARCHS)


def _reference_dryrun():
    """The reference's ``launch/dryrun.py``, imported without the 512
    host devices it asks XLA for at import (``XLA_FLAGS`` restored)."""
    before = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jdry
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdry


def _cells(arch):
    jc, tc = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    for name in tconfigs.SHAPES:
        yield name, jc, tc, jconfigs.SHAPES[name], tconfigs.SHAPES[name]


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_equal_reference(arch):
    jc, tc = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    for fn in ("_attn_proj_flops", "_mlp_flops", "_moe_flops",
               "_mamba1_flops", "_mamba2_flops", "param_bytes",
               "_tp_allreduces_per_layer"):
        assert getattr(rl, fn)(tc) == getattr(jrl, fn)(jc), fn
    for s_ctx in (1, 4096, 32768, 524288):
        assert rl._attn_score_flops(tc, s_ctx) == \
            jrl._attn_score_flops(jc, s_ctx)
        for decode in (False, True):
            assert rl._layer_flops(tc, s_ctx, decode) == \
                jrl._layer_flops(jc, s_ctx, decode)
    for name, jc, tc, jshape, tshape in _cells(arch):
        assert rl.cell_flops(tc, tshape) == jrl.cell_flops(jc, jshape)
        B, S = tshape.global_batch, tshape.seq_len
        assert rl.forward_flops(tc, B * S, S, unembed_tokens=B) == \
            jrl.forward_flops(jc, B * S, S, unembed_tokens=B)
        for mesh in MESHES:
            n_dev = 1
            for v in mesh.values():
                n_dev *= v
            for n_micro in (1, 16):
                assert rl.cell_hbm_bytes(tc, tshape, n_dev, n_micro) == \
                    jrl.cell_hbm_bytes(jc, jshape, n_dev, n_micro)
                assert rl.cell_collective_bytes(tc, tshape, mesh, n_micro) \
                    == jrl.cell_collective_bytes(jc, jshape, mesh, n_micro)
                got = rl.cell_roofline(tc, tshape, mesh, n_micro)
                want = jrl.cell_roofline(jc, jshape, mesh, n_micro)
                for f in ("flops_per_dev", "hbm_bytes_per_dev",
                          "link_bytes_per_dev", "useful_flops",
                          "useful_ratio"):
                    assert getattr(got, f) == getattr(want, f), (name, f)
                # the same terms over the H100's rates
                assert got.compute_s == want.flops_per_dev / rl.PEAK_FLOPS
                assert got.memory_s == want.hbm_bytes_per_dev / rl.HBM_BW
                assert got.collective_s == \
                    want.link_bytes_per_dev / rl.LINK_BW
            shards = mesh["data"] * mesh.get("pod", 1)
            if tshape.kind == "train":     # the dry run's only caller
                assert tdry.pick_microbatches(tc, tshape, shards) == \
                    _reference_dryrun().pick_microbatches(jc, jshape,
                                                          shards)


def test_h100_constants():
    # NVIDIA H100 SXM5 datasheet: dense bf16, HBM3, NVLink 4 per direction
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)


def test_link_bytes_matches_reference():
    jdry = _reference_dryrun()
    colls = [{"kind": k, "result_bytes": b, "group": g}
             for k in ("all-reduce", "all-gather", "reduce-scatter",
                       "all-to-all", "collective-permute")
             for b, g in ((1024, 16), (3 << 20, 2), (7, 1))]
    assert tdry.link_bytes(colls) == jdry.link_bytes(colls)


def test_roofline_terms_reasonable():
    cfg = tconfigs.ARCHS["qwen2-vl-72b"]
    shape = ShapeCell("train_4k", 4096, 256, "train")
    r = rl.cell_roofline(cfg, shape, {"data": 16, "model": 16}, n_micro=16)
    # the reference's 1-60 s at 197 TFLOP/s, scaled by 197/989
    assert 1.0 * 197 / 989 < r.compute_s < 60.0 * 197 / 989
    assert r.dominant in ("compute", "memory", "collective")
    assert 0 < r.useful_ratio <= 1.0
    assert 0 < r.roofline_fraction <= 1.0


def test_decode_is_memory_bound():
    cfg = tconfigs.ARCHS["olmo-1b"]
    shape = ShapeCell("decode_32k", 32768, 128, "decode")
    r = rl.cell_roofline(cfg, shape, {"data": 16, "model": 16})
    assert r.dominant in ("memory", "collective")  # classic decode regime


def test_useful_ratio_definitions():
    cfg = tconfigs.ARCHS["qwen3-moe-235b-a22b"]
    shape = ShapeCell("train_4k", 4096, 256, "train")
    fl = rl.cell_flops(cfg, shape)
    # MoE useful flops use ACTIVE params
    assert fl["useful"] == 6 * cfg.active_params() * 256 * 4096
    assert fl["useful"] < fl["hlo_like_total"]


def _counted_flops(cfg, B, S):
    """FlopCounterMode over the port's forward, its layers unrolled, on
    meta tensors (shapes only)."""
    params = tt.cast_params(tt.abstract_params(cfg))
    per = tt._unstack(params["blocks"], cfg.n_layers)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        toks = torch.zeros((B, S), dtype=torch.int64, device="meta")
        x = tl.compute_dtype(params["embed"])[toks]
        for pl in per:
            x, _ = tt._block_fwd(x, pl, cfg)
        x = tl.apply_norm(x, params["final_norm"], cfg.norm)
        tl._mm(x, tl.compute_dtype(params["lm_head"]))
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,layers,rel", [
    ("smollm-135m", 3, 0.15), ("olmo-1b", 3, 0.15),
    ("moonshot-v1-16b-a3b", 2, 0.25)])
def test_analytic_flops_vs_counted(arch, layers, rel):
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.ARCHS[arch]),
                              remat=False, n_layers=layers)
    B, S = 2, 256
    counted = _counted_flops(cfg, B, S)
    model = rl.forward_flops(cfg, B * S, s_ctx=S)
    # the counted forward computes the full causal rectangle (s_ctx=S);
    # norms, rope and softmax are not in the analytic model
    assert model == pytest.approx(counted, rel=rel), (model, counted)


def _local_bytes(items, mesh):
    """Rank 0's shard bytes of each (shape, element bytes, spec), by hand:
    a dim sharded over mesh axes of total size n keeps ceil(dim / n) rows
    (``torch.chunk``)."""
    total = 0
    for shape, dtype_bytes, spec in items:
        n_el = 1
        for d, entry in enumerate(tuple(spec) + (None,) * len(shape)):
            if d >= len(shape):
                break
            names = (() if entry is None else (entry,)
                     if isinstance(entry, str) else entry)
            n = 1
            for a in names:
                n *= mesh[a]
            n_el *= -(-shape[d] // n)
        total += n_el * dtype_bytes
    return total


def _leaves_with_specs(tree, specs):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves_with_specs(v, specs[k])
        else:
            out.append((tuple(v.shape), v.element_size(), specs[k]))
    return out


def test_dryrun_cell_on_a_fake_mesh(tmp_path):
    """smollm-135m's decode_32k on a fake 2x4 (data, model) mesh: OK, and
    its argument bytes are rank 0's shards of the bf16 weights (sharded on
    model alone), the cache (KV heads 3 do not divide 4: the sequence
    takes the model axis; the batch of 128 splits over data) and the
    tokens.  hubert-xlarge has no decode step: SKIP."""
    report = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch in ("smollm-135m", "hubert-xlarge"):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", "decode_32k", "--mesh-override", "2x4",
             "--report", str(report)],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=str(ROOT))
        assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    res = json.loads(report.read_text())
    assert res["hubert-xlarge|decode_32k|16x16"]["status"] == "SKIP"
    cell = res["smollm-135m|decode_32k|16x16"]
    assert cell["status"] == "OK", cell
    assert cell["mesh"] == "2x4"

    cfg = tconfigs.ARCHS["smollm-135m"]
    shape = tconfigs.SHAPES["decode_32k"]
    mesh = {"data": 2, "model": 4}
    sh = tl.Shardings(batch=("data",), model=("model",), fsdp=(),
                      model_size=4)
    params = tt.cast_params(tt.abstract_params(cfg))
    cache = {"attn": {k: torch.empty(
        (cfg.n_layers, shape.global_batch, shape.seq_len, cfg.n_kv_heads,
         cfg.head_dim), dtype=torch.bfloat16, device="meta")
        for k in ("k", "v")}}
    want = (_local_bytes(_leaves_with_specs(params,
                                            tt.param_specs(cfg, sh)), mesh)
            + _local_bytes(_leaves_with_specs(cache,
                                              tt.cache_specs(cfg, sh)), mesh)
            + _local_bytes([((shape.global_batch, 1), 4,
                             tl.P(("data",), None))], mesh))
    assert cell["per_device"]["argument_bytes"] == want
    pd = cell["per_device"]
    assert pd["peak_bytes"] >= pd["argument_bytes"] > 0
    assert pd["flops"] > 0 and pd["link_bytes"] > 0
    assert pd["alias_bytes"] > 0          # the cache is written in place
    assert cell["n_collectives"] == sum(
        c["count"] for c in cell["collectives"].values())
