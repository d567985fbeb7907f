"""Production-mesh dry run: every (arch x shape) step sharded on the
production mesh, counted op by op, turned into roofline terms on the
H100 row.  No storage is allocated: parameters, optimizer state and
inputs are ``meta`` tensors, and the mesh's 256 or 512 ranks are a fake
process group (this process is rank 0; its collectives return at once).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 pairs, single-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --optimized

The port of ``repro.launch.dryrun``.  Where the JAX package lowers and
compiles the step and reads its HLO and ``memory_analysis()``, this
module runs the step once on the meta shards under ``op_costs.OpCosts``
and ``memory.LiveBytes`` (:func:`count_step`): the counts are rank 0's
FLOPs, bytes and collective wire bytes, and its memory as the H100 would
allocate it.  The estimate is analytic: there is no compiler, so no
fusion.  On meta tensors attention takes its plain version
(``attention_chunked``), whose products are the ones counted.

``memory_analysis`` holds XLA's four fields for rank 0's local shards:
``argument_bytes`` and ``output_bytes`` (the tensors' bytes),
``peak_bytes`` (the most bytes live at once in the step, arguments
included) and ``temp_bytes`` (the most live at once of the storages that
are neither arguments nor outputs); the dry run adds
``peak_share_of_hbm`` (the peak over the ``h100-sxm`` row's 80 GB).
Peak and temp follow every storage from the op that makes it until its
last reference goes, autograd's saved tensors included, each rounded up
to the caching allocator's 512-byte blocks; where the card runs a kernel
(B6/B7, B8, B9, B10) they charge what the kernel's wrapper allocates,
not the plain version's intermediates (``launch/memory.py``).  Where
a kernel refuses the step's inputs (the card raises there), the plain
version is charged and ``plain_charged`` names the site and the refusal;
no pair reaches one.
``chip_smoke.py``'s ``mesh`` phase holds the count against
``torch.cuda.max_memory_allocated()`` for five steps on a one-rank mesh
of the H100.  Not counted: NCCL's own buffers, cuBLAS's workspaces and
the allocator's fragmentation.

:func:`build_step` is the one sharded step: the dry run feeds it meta
tensors on the fake group, a caller on cards real ones on an NCCL mesh.
A process has one default group, so the CLI sets the fake group up and
tests run it in a subprocess.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch

from repro_torch import models
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.memory import LiveBytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_costs import OpCosts
from repro_torch.models import common as cm
from repro_torch.optim.adamw import (AdamW, AdamWState, cosine_schedule,
                                     tree_items, tree_map)
from repro_torch.runtime.roofline import HW_PEAKS, roofline_terms
from repro_torch.sharding_hints import axis_rules

# H100 SXM (NVIDIA's data sheet, 700 W): bf16 tensor-core peak, HBM3,
# NVLink 4 per direction; the dry run's parameters are bf16, as the JAX
# package's are
_ROW = HW_PEAKS["h100-sxm"]
HW = {"name": _ROW["name"], "peak_flops": _ROW["peak_flops_bf16"],
      "hbm_bw": _ROW["hbm_bw"], "hbm_bytes": _ROW["hbm_bytes"],
      "link_bw": _ROW["link_bw"]}

ARCHS = [
    "rwkv6-3b", "whisper-medium", "qwen3-8b", "chameleon-34b",
    "tinyllama-1.1b", "qwen3-0.6b", "qwen3-moe-235b-a22b",
    "recurrentgemma-9b", "llama3-8b", "granite-moe-3b-a800m",
]


def init_fake_group(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0: meshes build and collectives return at once."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def build_step(cfg, shape, rules, mesh, dtype=torch.bfloat16):
    """Returns (step, structs, placements): the step function, meta
    tensors for its arguments (parameters in ``dtype``, AdamW state in
    fp32) and the DTensor placements of each, by ``rules`` on ``mesh``.
    Place real or meta tensors with ``sharding.distribute`` and call the
    step under ``axis_rules(rules, mesh)``.

    train: ``step(params, opt_state, batch) -> (params, opt_state, loss,
    grads)``, the gradients in the parameters' placements (AdamW writes
    params and state in place); prefill: ``step(params, batch) ->
    (logits, cache)``; decode: ``step(params, token, cache, pos)``."""
    mod = models.get_module(cfg)
    window = models.effective_window(cfg, shape)
    template = models.param_template(cfg)
    pstruct = cm.param_struct(template, dtype)
    pshard = shd.param_shardings(template, rules, mesh)
    specs = models.input_specs(cfg, shape, dtype)
    bstruct = specs["batch"]
    bshard = shd.struct_shardings(bstruct, specs["batch_axes"], rules, mesh)
    rep = shd.replicated(mesh)

    if shape.kind == "train":
        opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
        f32 = lambda t: torch.empty(t.shape, dtype=torch.float32,
                                    device="meta")
        ostruct = {"step": torch.empty((), dtype=torch.int32, device="meta"),
                   "m": tree_map(f32, pstruct), "v": tree_map(f32, pstruct)}
        oshard = {"step": rep, "m": pshard, "v": pshard}

        def step(params, opt_state, batch):
            leaves = [p.requires_grad_() for _, p in tree_items(params)]
            with torch.enable_grad():
                loss, _ = mod.loss_fn(cfg, params, batch, window=window)
                it = iter(torch.autograd.grad(loss, leaves))
            # a gradient may come back partial or split otherwise
            grads = tree_map(lambda p: _like(next(it), p), params)
            st = AdamWState(opt_state["step"], opt_state["m"],
                            opt_state["v"])
            params, st, _ = opt.update(grads, st, params)
            return params, {"step": st.step, "m": st.m, "v": st.v}, \
                loss.detach(), grads

        return (step, (pstruct, ostruct, bstruct),
                (pshard, oshard, bshard))

    if shape.kind == "prefill":
        cl = models.cache_len(cfg, shape)

        @torch.no_grad()
        def step(params, batch):
            return mod.prefill(cfg, params, window=window, cache_len=cl,
                               **batch)

        return step, (pstruct, bstruct), (pshard, bshard)

    cstruct = specs["cache"]
    cshard = shd.struct_shardings(cstruct, specs["cache_axes"], rules, mesh)

    @torch.no_grad()
    def step(params, token, cache, pos):
        return mod.decode_step(cfg, params, token, cache, pos,
                               window=window)

    return (step, (pstruct, bstruct["token"], cstruct, specs["pos"]),
            (pshard, bshard["token"], cshard, rep))


def _like(g, p):
    """``g`` in ``p``'s placements (a no-op off a mesh)."""
    if hasattr(g, "placements") and tuple(g.placements) != \
            tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    from torch.utils._pytree import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total


def count_step(cfg, shape, rules, mesh, dtype=torch.bfloat16):
    """:func:`build_step`'s step run once on meta shards under
    ``OpCosts`` and ``LiveBytes``: (the costs, ``memory_analysis``).
    Call under the fake group (or any group the mesh spans)."""
    with axis_rules(rules, mesh):
        fn, structs, shardings = build_step(cfg, shape, rules, mesh, dtype)
        args = tuple(shd.distribute(s, p, mesh)
                     for s, p in zip(structs, shardings))
        with OpCosts() as oc, LiveBytes() as live:
            live.arguments(args)
            out = fn(*args)
            mem = live.analysis(out)
    return oc, {"argument_bytes": _local_bytes(args),
                "output_bytes": _local_bytes(out),
                "temp_bytes": mem["temp_bytes"],
                "peak_bytes": mem["peak_bytes"],
                "plain_charged": mem["plain_charged"],
                "note": "local shards of rank 0, as the H100's caching "
                        "allocator would hold them (512-byte blocks)"}


def dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
           optimized: bool = False, save_dir=None, verbose: bool = True,
           cfg=None, mesh_shape=None):
    """One (arch, shape) pair on the production mesh of the fake group;
    returns the JAX package's result keys.  ``cfg`` replaces the arch's
    config (a reduced one, for tests) and ``mesh_shape`` the mesh's
    shape (a smaller fake group)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    rules = shd.rules_for_pair(arch, shape_name, shape.kind,
                               multi_pod=multi_pod, optimized=optimized)
    perf_mesh = rules.pop("_mesh_shape", None)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                shape=mesh_shape or perf_mesh)
    chips = mesh.size()
    t0 = time.time()
    oc, memory = count_step(cfg, shape, rules, mesh)
    t_run = time.time() - t0
    memory["peak_share_of_hbm"] = memory["peak_bytes"] / HW["hbm_bytes"]

    flops_dev = float(oc.flops)
    bytes_dev = float(oc.bytes)
    wire = float(oc.wire_bytes)
    terms = roofline_terms(flops_dev, bytes_dev, HW, wire_bytes=wire)
    n_active = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens
    flops_global = flops_dev * chips
    useful = model_flops / flops_global if flops_global else 0.0

    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "chips": chips,
        "optimized": optimized,
        "kind": shape.kind,
        "hw": HW["name"],
        "run_s": round(t_run, 1),
        "ops_per_device": oc.ops,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "wire_bytes_per_device": wire,
        "collectives": oc.summary()["collectives"],
        "memory_analysis": memory,
        "roofline": {
            "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
            "collective_s": terms["collective_s"],
            "bottleneck": terms["bottleneck"],
            "model_flops": model_flops,
            "useful_flops_ratio": useful,
        },
    }
    if verbose:
        r = result["roofline"]
        print(f"{arch:>22s} {shape_name:>12s} {result['mesh']:>8s} "
              f"{'OPT' if optimized else 'base'} "
              f"compute={r['compute_s']*1e3:9.3f}ms "
              f"mem={r['memory_s']*1e3:9.3f}ms "
              f"coll={r['collective_s']*1e3:9.3f}ms -> "
              f"{r['bottleneck']:10s} useful={useful:5.1%} "
              f"args={_gib(memory['argument_bytes'])} "
              f"temp={_gib(memory['temp_bytes'])} "
              f"peak={_gib(memory['peak_bytes'])} (run {t_run:.0f}s)",
              flush=True)
    if save_dir:
        save_dir = pathlib.Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        tag = "opt" if optimized else "base"
        fp = save_dir / f"{arch}__{shape_name}__{result['mesh']}__{tag}.json"
        fp.write_text(json.dumps(result, indent=1))
    return result


def _gib(b) -> str:
    return f"{b / 2**30:5.2f}G"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply PERF_OVERRIDES sharding rules")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    init_fake_group(512 if args.multi_pod else 256)

    failures = []
    for arch, shape in pairs:
        try:
            dryrun(arch, shape, multi_pod=args.multi_pod,
                   optimized=args.optimized, save_dir=args.out)
        except Exception as e:  # noqa: BLE001 -- report, keep sweeping
            failures.append((arch, shape, repr(e)))
            print(f"{arch:>22s} {shape:>12s} FAILED: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(pairs)} dry runs counted OK")


if __name__ == "__main__":
    main()
