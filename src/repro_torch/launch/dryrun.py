"""Multi-pod dry run on the CPU: build and run every (arch x shape x mesh)
cell's sharded step with no device and no allocation — torch twin of
``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

Each cell runs in a process of its own, as rank 0 of a fake process group
of 256 (16x16) or 512 (2x16x16) ranks (``torch.testing``'s fake backend:
collectives move nothing), under ``FakeTensorMode`` (tensors have shapes
and no storage).  The cell's step is ``models.lm``'s sharded step on
DTensors placed by the reference's spec trees, so each rank's shards have
their true per-device shapes and DTensor issues the step's real
collectives.  ``CellProbe`` reads, below DTensor (on the local shards):

  * argument bytes: the step's inputs' local shards; output and alias
    bytes likewise (the decode cache is written in place, so it aliases);
  * the peak: the most local bytes alive at once during the step, the
    arguments included (``temp_bytes`` = peak - arguments - outputs +
    aliases, the reference's identity);
  * FLOPs: ``torch.utils.flop_counter``'s formulas over the local ops;
  * bytes accessed: each local op's operand and result bytes, summed
    (views excluded, nothing fused);
  * collectives by kind (count, result bytes, group) and their ring-model
    link bytes (``link_bytes``, the reference's).

The reference reads these from XLA's compiled module (memory and cost
analysis, the post-SPMD HLO text); ``lower_s``/``compile_s`` become one
``build_s``, the wall time of building and running the cell here.  The
report goes to ``reports/dryrun_torch.json`` (keys ``arch|shape|mesh``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

REPORT = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "reports",
    "dryrun_torch.json"))
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def link_bytes(colls: list[dict]) -> float:
    """Ring-model per-device link bytes for a collective schedule."""
    total = 0.0
    for c in colls:
        b, g = c["result_bytes"], max(c["group"], 1)
        f = (g - 1) / g
        if c["kind"] == "all-reduce":
            total += 2 * b * f
        elif c["kind"] == "all-gather":
            total += b * f            # result is the gathered (large) buffer
        elif c["kind"] == "reduce-scatter":
            total += b * (g - 1)      # result is the scattered (small) buffer
        elif c["kind"] == "all-to-all":
            total += b * f
        elif c["kind"] == "collective-permute":
            total += b
    return total


def pick_microbatches(cfg, shape, data_shards: int,
                      target_tokens_per_dev: int = 4096) -> int:
    """Gradient-accumulation factor: keep live tokens/device ~target."""
    tokens_per_dev = shape.global_batch * shape.seq_len // max(data_shards, 1)
    m = max(1, tokens_per_dev // target_tokens_per_dev)
    while shape.global_batch % m or (shape.global_batch // m) % data_shards:
        m -= 1
    return max(m, 1)


# ------------------------------------------------------------ the probe
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors among ``tree``'s leaves (``core.tree``)."""
    import torch

    from ..core.tree import leaves
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _group_size(args) -> int:
    """The size of a collective's group: functional collectives name it
    last among their string arguments; c10d ops pass the group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    return 1


def _probe_mode():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class CellProbe(TorchDispatchMode):
        """Counts, on local (non-DTensor) ops only: FLOPs, bytes accessed,
        collectives, and the local bytes alive (peak)."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes_accessed = 0
            self.colls = []
            self.live = self.peak = 0
            self._ids = set()
            self._storages = {}

        def track(self, t):
            """Count ``t``'s storage alive until its last tracked tensor
            is collected."""
            if id(t) in self._ids:
                return
            st = t.untyped_storage()
            key = st._cdata
            ent = self._storages.get(key)
            if ent is None:
                self._storages[key] = [1, st.nbytes()]
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
            else:
                ent[0] += 1
            self._ids.add(id(t))
            weakref.finalize(t, self._drop, id(t), key)

        def _drop(self, tid, key):
            self._ids.discard(tid)
            ent = self._storages[key]
            ent[0] -= 1
            if ent[0] == 0:
                self.live -= ent[1]
                del self._storages[key]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if any(issubclass(t, DTensor) for t in types):
                return out
            name = func.__name__.split(".")[0]
            ns = func.namespace
            outs = _tensors(out)
            if ns in ("_c10d_functional", "c10d"):
                kind = next((k for w, k in _KINDS if w in name), None)
                if kind is not None:
                    self.colls.append({
                        "kind": kind,
                        "result_bytes": sum(_nbytes(t) for t in outs),
                        "group": _group_size(args)})
            else:
                f = flop_registry.get(func.overloadpacket)
                if f is not None:
                    self.flops += f(*args, **kwargs, out_val=out)
                if not func.is_view:
                    self.bytes_accessed += sum(
                        _nbytes(t) for t in _tensors((args, kwargs))) + sum(
                        _nbytes(t) for t in outs)
            for t in outs:
                self.track(t)
            return out

    return CellProbe()


# ------------------------------------------------------------ the cells
def build_cell(cfg, shape, mesh, variant=None):
    """-> (step, args): the cell's sharded step and its arguments (fake
    DTensors laid out as the reference's ``build_cell`` lays them out).
    Call under ``FakeTensorMode``.

    ``variant`` (perf hillclimbing): dict with optional keys
      micro_target : int  — tokens/device per microbatch (default 4096)
      kv_quant     : bool — int8 KV cache for decode cells
      seq_parallel : bool — shard activation carries on (model) over seq
      grad_acc_bf16: bool — bf16 gradient accumulator
      flat_dp      : bool — the model axis as more data parallelism
    """
    import torch

    from ..configs import input_specs
    from ..models import lm, transformer
    from ..models.layers import P, Shardings
    from ..train.optimizer import adafactor, adafactor_state_specs, adamw
    from . import mesh as mesh_lib

    variant = variant or {}
    baxes = mesh_lib.batch_axes(mesh)
    names = mesh.mesh_dim_names
    bsize = 1
    for a in baxes:
        bsize *= mesh.size(names.index(a))
    m_size = mesh.size(names.index("model"))
    shard_batch = (shape.global_batch % bsize == 0
                   and shape.global_batch >= bsize)
    bspec = baxes if shard_batch else None
    n_dev = bsize * m_size
    if variant.get("flat_dp") and shape.global_batch % n_dev == 0:
        # the model axis as extra data parallelism (small archs)
        bspec = tuple(baxes) + ("model",)
        sh = Shardings(batch=bspec, model=(), fsdp=("data",), model_size=1)
    else:
        sh = Shardings(batch=bspec if shard_batch else (), model=("model",),
                       fsdp=("data",), model_size=m_size,
                       seq=("model",) if variant.get("seq_parallel") else ())

    def put(tree, specs):
        return mesh_lib.distribute(tree, mesh, specs)

    def data(t):
        return put(t, P(bspec, *([None] * (t.dim() - 1))))

    pspecs = transformer.param_specs(cfg, sh)
    params = transformer.init_params(cfg, torch.Generator(),
                                     device="cpu").tree()
    specs = input_specs(cfg, shape)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             specs.items() if k != "pos"}
    if shape.kind == "train":
        # >100B params: factored 2nd moment (Adafactor)
        if cfg.n_params() > 1.0e11:
            opt, opt_specs = adafactor(), adafactor_state_specs(pspecs)
        else:
            opt, opt_specs = adamw(), {"m": pspecs, "v": pspecs}
        data_like = (n_dev if variant.get("flat_dp")
                     and shape.global_batch % n_dev == 0 else bsize)
        n_micro = pick_microbatches(
            cfg, shape, data_like,
            target_tokens_per_dev=variant.get("micro_target", 4096))
        acc = (torch.bfloat16 if (variant.get("grad_acc_bf16")
                                  or cfg.n_params() > 1.0e11)
               else torch.float32)
        step = lm.make_train_step(cfg, opt, num_microbatches=n_micro,
                                  acc_dtype=acc, device="cpu", sh=sh)
        sharded = put(params, pspecs)
        state = (sharded, put(opt.init(params), opt_specs),
                 torch.zeros((), dtype=torch.int32))
        return step, (state, {k: data(v) for k, v in batch.items()})
    if shape.kind == "prefill":
        step = lm.make_prefill_step(cfg, device="cpu", sh=sh)
        return step, (put(params, pspecs),
                      {k: data(v) for k, v in batch.items()})
    # decode: bf16 weights resident, sharded on `model` alone except the
    # MoE's and those of 32B+ models (they keep the fsdp axis)
    if cfg.family != "moe" and cfg.n_params() < 32e9:
        sh = Shardings(batch=sh.batch, model=sh.model, fsdp=(),
                       model_size=m_size)
        pspecs = transformer.param_specs(cfg, sh)
    params = transformer.cast_params(params)
    seq_axes = () if shard_batch else tuple(baxes)  # long_500k: shard S
    kv_quant = bool(variant.get("kv_quant"))
    step = lm.make_serve_step(cfg, seq_shard_axes=seq_axes, device="cpu",
                              sh=sh)
    cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   kv_quant=kv_quant, device="cpu")
    cspecs = transformer.cache_specs(cfg, sh, seq_shard_axes=seq_axes,
                                     kv_quant=kv_quant)
    if cfg.input_kind == "embeds":
        tok = put(torch.zeros((shape.global_batch, 1, cfg.d_model),
                              dtype=torch.bfloat16), P(bspec, None, None))
    else:
        tok = data(batch["token"])
    return step, (put(params, pspecs), put(cache, cspecs), tok,
                  shape.seq_len - 1)


def _mesh_name(multi_pod: bool, variant) -> str:
    if (variant or {}).get("mesh_override"):
        return variant["mesh_override"]
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant=None) -> dict:
    """One cell in this process: a fake process group of the mesh's size
    (none may be up), the step built and run under ``FakeTensorMode``."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..configs import ARCHS, SHAPES, cell_applicable
    from . import mesh as mesh_lib

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"status": "SKIP", "reason": reason}
    name = _mesh_name(multi_pod, variant)
    dims = tuple(int(x) for x in name.split("x"))
    world = 1
    for d in dims:
        world *= d
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        if (variant or {}).get("mesh_override"):
            mesh = mesh_lib.make_mesh(dims, ("data", "model"), "cpu")
        else:
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                 device_type="cpu")
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args = build_cell(cfg, shape, mesh, variant=variant)
            probe = _probe_mode()
            arg_locals = [_local(t) for t in _tensors(args)]
            for t in arg_locals:
                probe.track(t)
            with probe:
                out = fn(*args)
            out_locals = [_local(t) for t in _tensors(out)]
        build_s = time.time() - t0
    finally:
        dist.destroy_process_group()
    arg_bytes = sum(_nbytes(t) for t in arg_locals)
    arg_keys = {t.untyped_storage()._cdata for t in arg_locals}
    out_bytes = sum(_nbytes(t) for t in out_locals)
    alias = sum(_nbytes(t) for t in out_locals
                if t.untyped_storage()._cdata in arg_keys)
    coll_summary = {}
    for c in probe.colls:
        k = coll_summary.setdefault(c["kind"], {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += c["result_bytes"]
    return {
        "status": "OK",
        "mesh": name,
        "build_s": round(build_s, 1),
        "per_device": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": probe.peak - arg_bytes - out_bytes + alias,
            "alias_bytes": alias,
            "peak_bytes": probe.peak,
            "flops": float(probe.flops),
            "bytes_accessed": float(probe.bytes_accessed),
            "link_bytes": link_bytes(probe.colls),
        },
        "collectives": coll_summary,
        "n_collectives": len(probe.colls),
    }


def _run_isolated(arch: str, shape: str, multi_pod: bool, variant) -> dict:
    """``run_cell`` in a process of its own (a fake process group's world
    size is fixed once it is up) -> its result."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--one-cell",
         json.dumps([arch, shape, multi_pod, variant])],
        capture_output=True, text=True, env=env)
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        return {"status": "FAIL",
                "error": f"cell process exited {out.returncode}",
                "traceback": out.stderr[-2000:]}
    return json.loads(lines[-1])


def _one_cell(spec: str) -> int:
    arch, shape, multi_pod, variant = json.loads(spec)
    try:
        res = run_cell(arch, shape, multi_pod, variant=variant)
    except Exception as e:  # noqa: BLE001 — record and continue
        res = {"status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    print(json.dumps(res))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--report", default=None)
    ap.add_argument("--tag", default="", help="variant suffix for the key")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--micro-target", type=int, default=4096)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--grad-acc-bf16", action="store_true")
    ap.add_argument("--flat-dp", action="store_true")
    ap.add_argument("--mesh-override", default=None,
                    help="DxM re-aim of the devices (perf variant)")
    ap.add_argument("--one-cell", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one_cell:
        return _one_cell(args.one_cell)
    variant = {"kv_quant": args.kv_quant, "micro_target": args.micro_target,
               "seq_parallel": args.seq_parallel,
               "grad_acc_bf16": args.grad_acc_bf16, "flat_dp": args.flat_dp,
               "mesh_override": args.mesh_override}

    from ..configs import ARCHS, SHAPES, cell_applicable
    report_path = args.report or REPORT
    os.makedirs(os.path.dirname(os.path.abspath(report_path)), exist_ok=True)
    results = {}
    if os.path.exists(report_path):
        with open(report_path) as f:
            results = json.load(f)

    cells = []
    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    for a, s, mp in cells:
        key = f"{a}|{s}|{'2x16x16' if mp else '16x16'}" + (
            f"|{args.tag}" if args.tag else "")
        if results.get(key, {}).get("status") in ("OK", "SKIP"):
            print(f"[cached] {key}: {results[key]['status']}")
            continue
        print(f"[run] {key} ...", flush=True)
        ok, reason = cell_applicable(ARCHS[a], SHAPES[s])
        res = (_run_isolated(a, s, mp, variant) if ok
               else {"status": "SKIP", "reason": reason})
        results[key] = res
        with open(report_path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"  -> {res['status']} "
              + (f"build={res.get('build_s')}s "
                 f"flops/dev={res['per_device']['flops']:.3g} "
                 f"temp/dev={res['per_device']['temp_bytes']/2**30:.2f}GiB"
                 if res["status"] == "OK" else res.get("reason",
                                                       res.get("error", ""))),
              flush=True)

    n_ok = sum(1 for r in results.values() if r["status"] == "OK")
    n_skip = sum(1 for r in results.values() if r["status"] == "SKIP")
    n_fail = sum(1 for r in results.values() if r["status"] == "FAIL")
    print(f"dry-run cells: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
