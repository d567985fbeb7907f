"""One gloo rank of the port's sharded paths, for test_torch_moe_parallel.

    python tests/torch_mesh_worker.py <io_dir> <rank> <world>

Reads ``<io_dir>/job.json`` and the numpy weights beside it, joins a
gloo group of ``world`` ranks through a file store in ``io_dir``, and for
each case builds its mesh, places the weights as DTensors by the rules
and runs the port: MoE forwards per ``moe_impl`` (and the dense
body's refusal of a split seq), the sharded train
step of ``launch.dryrun.build_step``, the RG-LRU's ``_log_a`` with its
gradients, and the encoder-decoder's decode step on a slot-split 'bskd'
cache.  Rank 0 writes the full results to ``<io_dir>/out_<case>.npz``.
Imports no JAX.
"""
import json
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import models  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.dryrun import build_step  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim.adamw import tree_items  # noqa: E402
from repro_torch.sharding_hints import axis_rules  # noqa: E402


def _nested(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def _config(case):
    import dataclasses
    cfg = reduced(get_config(case["arch"]))
    return dataclasses.replace(cfg, **case.get("cfg", {}))


def _full(x):
    return x.full_tensor().detach().numpy() if hasattr(x, "full_tensor") \
        else x.detach().numpy()


def _dense_form(cfg, tokens, mesh):
    """The dense body's route and the form of its expert products
    ('contract' or 'gather') for ``tokens`` under the installed rules."""
    from repro_torch.models import moe
    from repro_torch.sharding_hints import logical_to_spec, mesh_sizes
    b, s = tokens.shape
    bspec = logical_to_spec(("batch",), shape=(b,))[0]
    axes = () if bspec is None else \
        ((bspec,) if isinstance(bspec, str) else tuple(bspec))
    lay = moe.dense_layout(cfg, b * s, mesh_sizes(mesh), axes, "model")
    return np.array(lay.route), np.array(
        "contract" if lay.contract else "gather")


def run_moe(case, io, mesh):
    """The forward per ``moe_impl`` in ``case["impls"]`` (all three by
    default), the dense body's route and form, and with
    ``case["seq_guard"]`` the message of the dense body's refusal of a
    rule that splits seq."""
    from repro_torch.models import moe
    cfg = _config(case)
    np_params = _nested(dict(np.load(io / case["weights"])))
    tokens = torch.from_numpy(np.load(io / case["tokens"])).long()
    mod = models.get_module(cfg)
    out = {}
    extras = {"dense": {}, "a2a": {"tp_ff": None},
              "local": {"experts": None, "tp_ff": None}}
    for impl in case.get("impls", list(extras)):
        rules = shd.rules_for("train", overrides={"moe_impl": impl,
                                                  **extras[impl]})
        with axis_rules(rules, mesh), torch.no_grad():
            params = shd.shard_params(
                params_from_numpy(np_params, "cpu", cfg=cfg),
                models.param_template(cfg), rules, mesh)
            tok = shd.distribute(
                tokens, shd.struct_shardings(tokens, ("batch", None), rules,
                                             mesh), mesh)
            logits, aux = mod.forward(cfg, params, tok)
            out[impl] = _full(logits)
            out[impl + "_aux"] = _full(aux)
            if impl == "dense":
                out["route"], out["form"] = _dense_form(cfg, tokens, mesh)
    if case.get("seq_guard"):
        rules = shd.rules_for("train", overrides={"seq": "model"})
        b, s = tokens.shape
        with axis_rules(rules, mesh), torch.no_grad():
            params = shd.shard_params(
                params_from_numpy(np_params, "cpu", cfg=cfg),
                models.param_template(cfg), rules, mesh)
            x = torch.zeros(b, s, cfg.d_model)
            x = shd.distribute(x, shd.struct_shardings(
                x, ("batch", "seq", "embed"), rules, mesh), mesh)
            lp = {k: w[0] for k, w in params["layers"].items()}
            try:
                moe.moe_ffn_dense(cfg, lp, x)
                out["seq_guard"] = np.array("")
            except ValueError as e:
                out["seq_guard"] = np.array(str(e))
    return out


def run_train(case, io, mesh):
    cfg = _config(case)
    np_params = _nested(dict(np.load(io / case["weights"])))
    tokens = torch.from_numpy(np.load(io / case["tokens"])).long()
    b, s = tokens.shape
    rules = shd.rules_for("train")
    with axis_rules(rules, mesh):
        step, structs, shardings = build_step(
            cfg, ShapeSpec("mesh_train", s, b, "train"), rules, mesh,
            dtype=torch.float32)
        params = params_from_numpy(np_params, "cpu", cfg=cfg)
        opt = {"step": torch.zeros((), dtype=torch.int32),
               "m": _zeros_like(params), "v": _zeros_like(params)}
        batch = {"tokens": tokens, "labels": tokens}
        args = [shd.distribute(t, p, mesh)
                for t, p in zip((params, opt, batch), shardings)]
        _, _, loss, grads = step(*args)
        out = {"loss": _full(loss)}
        if cfg.is_moe:
            out["route"], out["form"] = _dense_form(cfg, tokens, mesh)
        for path, g in tree_items(grads):
            out["grad/" + "/".join(path)] = _full(g)
    return out


def run_remat_thread(case, io, mesh):
    """The MoE loss's gradients (base train rules, checkpointed layers)
    from a backward on the forward's thread and from one on a thread of
    its own, which has DTensor's implicit replication on but no rules
    installed: autograd runs a CUDA graph's backward so, and the layers'
    recompute must still take the dense body.  The error the second
    raised, if any."""
    import contextlib
    import threading
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils._pytree import tree_leaves
    cfg = _config(case)
    np_params = _nested(dict(np.load(io / case["weights"])))
    tokens = torch.from_numpy(np.load(io / case["tokens"])).long()
    mod = models.get_module(cfg)
    rules = shd.rules_for("train")
    out, errors = {}, []

    def backward(loss, replicate):
        try:
            with implicit_replication() if replicate else \
                    contextlib.nullcontext():
                loss.backward()
        except Exception as e:  # reported to the test
            errors.append(repr(e))
    for where in ("same", "thread"):
        with axis_rules(rules, mesh):
            params = shd.shard_params(
                params_from_numpy(np_params, "cpu", cfg=cfg),
                models.param_template(cfg), rules, mesh)
            leaves = [p.requires_grad_() for p in tree_leaves(params)]
            tok = shd.distribute(
                tokens, shd.struct_shardings(tokens, ("batch", None), rules,
                                             mesh), mesh)
            loss, _ = mod.loss_fn(cfg, params, {"tokens": tok,
                                                "labels": tok})
            if where == "same":
                backward(loss, False)
            else:
                t = threading.Thread(target=backward, args=(loss, True))
                t.start()
                t.join()
        for i, p in enumerate(leaves):
            if p.grad is not None:
                out[f"{where}/{i}"] = _full(p.grad)
    out["errors"] = np.array(" ".join(errors))
    return out


def run_prefill(case, io, mesh):
    """The sharded prefill step (``build_step``, fp32 parameters, the
    prefill rules): the logits, every cache leaf, and each leaf's
    placements and dtype."""
    cfg = _config(case)
    np_params = _nested(dict(np.load(io / case["weights"])))
    tokens = torch.from_numpy(np.load(io / case["tokens"])).long()
    b, s = tokens.shape
    rules = shd.rules_for("prefill")
    with axis_rules(rules, mesh):
        step, _, shardings = build_step(
            cfg, ShapeSpec("mesh_prefill", s, b, "prefill"), rules, mesh,
            dtype=torch.float32)
        params = params_from_numpy(np_params, "cpu", cfg=cfg)
        args = [shd.distribute(t, p, mesh)
                for t, p in zip((params, {"tokens": tokens}), shardings)]
        logits, cache = step(*args)
        spec, axes = models.get_module(cfg).cache_spec(
            cfg, b, models.cache_len(cfg, ShapeSpec("p", s, b, "prefill")),
            torch.bfloat16)
        placed = shd.struct_shardings(
            {k: torch.empty(sh, device="meta") for k, (sh, _) in spec.items()},
            axes, rules, mesh)
    out = {"logits": _full(logits),
           "logits_placements": np.array(str(logits.placements))}
    for k, v in cache.items():
        out[f"cache/{k}"] = _full(v.float())
        out[f"placed/{k}"] = np.array(tuple(v.placements) == placed[k]
                                      and v.dtype == spec[k][1])
    return out


def run_xent(case, io, mesh):
    """``common.softmax_xent`` on vocab-split DTensor logits (the train
    rules' (batch, seq, vocab_act)), unmasked and masked: the loss and
    its gradient with respect to the logits."""
    from repro_torch.models import common as cm
    data = np.load(io / case["tokens"])
    rules = shd.rules_for("train")
    out = {}
    with axis_rules(rules, mesh):
        x = torch.from_numpy(data["logits"])
        x = shd.distribute(x, shd.struct_shardings(
            x, ("batch", "seq", "vocab_act"), rules, mesh), mesh)
        x.requires_grad_()
        out["logits_placements"] = np.array(str(x.placements))
        bs = {}
        for k in ("labels", "mask"):
            y = torch.from_numpy(data[k])
            bs[k] = shd.distribute(y, shd.struct_shardings(
                y, ("batch", "seq"), rules, mesh), mesh)
        for name, mask in (("plain", None), ("masked", bs["mask"])):
            loss = cm.softmax_xent(x, bs["labels"], mask)
            grad, = torch.autograd.grad(loss, x)
            out[f"{name}/loss"] = _full(loss)
            out[f"{name}/grad"] = _full(grad)
    return out


def run_log_a(case, io, mesh):
    """``rglru._log_a`` of layer 0 on DTensors (lam split on ``tp_ff``,
    x on batch and ``ff``), and the gradients of a fixed weighted sum of
    its outputs with respect to x and every gate leaf."""
    from repro_torch.models import rglru
    cfg = _config(case)
    np_params = _nested(dict(np.load(io / case["weights"])))
    data = np.load(io / case["tokens"])
    rules = shd.rules_for("train")
    with axis_rules(rules, mesh):
        params = shd.shard_params(
            params_from_numpy(np_params, "cpu", cfg=cfg),
            models.param_template(cfg), rules, mesh)
        x = shd.distribute(
            torch.from_numpy(data["x"]),
            shd.struct_shardings(torch.from_numpy(data["x"]),
                                 ("batch", None, "ff"), rules, mesh), mesh)
        x.requires_grad_()
        lp = {k: w.requires_grad_() for k, w in params["rec"].items()
              if k in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b",
                       "lam")}
        log_a, gate_i = rglru._log_a(rglru._slice(lp, 0), x)
        loss = (log_a * torch.from_numpy(data["c_a"])).sum() + \
            (gate_i * torch.from_numpy(data["c_i"])).sum()
        names = sorted(lp)
        grads = torch.autograd.grad(loss, [x] + [lp[k] for k in names])
    out = {"log_a": _full(log_a), "gate_i": _full(gate_i),
           "grad/x": _full(grads[0])}
    out.update({f"grad/{k}": _full(g) for k, g in zip(names, grads[1:])})
    return out


def run_encdec_decode(case, io, mesh):
    """``encdec.decode_step`` on DTensor caches placed by the decode rules
    (the self-attention ring split on its slots, the cross cache on
    batch), one step at each of ``case["positions"]`` in turn; the logits
    of every step and the caches after the last."""
    from repro_torch.models import encdec
    cfg = _config(case)
    np_params = _nested(dict(np.load(io / case["weights"])))
    data = dict(np.load(io / case["tokens"]))
    b, s = data["k"].shape[1:3]
    rules = shd.rules_for("decode")
    _, axes = encdec.cache_spec(cfg, b, s, torch.float32)
    out = {}
    with axis_rules(rules, mesh), torch.no_grad():
        params = shd.shard_params(
            params_from_numpy(np_params, "cpu", cfg=cfg),
            models.param_template(cfg), rules, mesh)
        cache = {k: torch.from_numpy(data[k]) for k in axes}
        cache = shd.distribute(
            cache, shd.struct_shardings(cache, axes, rules, mesh), mesh)
        for i, pos in enumerate(case["positions"]):
            tok = torch.from_numpy(data["token"][i])
            tok = shd.distribute(tok, shd.replicated(mesh), mesh)
            logits, cache = encdec.decode_step(cfg, params, tok, cache,
                                               torch.tensor(pos))
            out[f"logits/{i}"] = _full(logits)
        out.update({f"cache/{k}": _full(v) for k, v in cache.items()})
        out["self_placements"] = np.array(str(cache["k"].placements))
    return out


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree, dtype=torch.float32)


def main():
    io, rank, world = pathlib.Path(sys.argv[1]), int(sys.argv[2]), \
        int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{io}/store",
                            rank=rank, world_size=world)
    try:
        job = json.loads((io / "job.json").read_text())
        for case in job["cases"]:
            mesh = make_host_mesh(model_axis=case["model_axis"])
            run = {"moe": run_moe, "train": run_train,
                   "remat_thread": run_remat_thread,
                   "prefill": run_prefill, "xent": run_xent,
                   "log_a": run_log_a,
                   "encdec_decode": run_encdec_decode}[case["kind"]]
            out = run(case, io, mesh)
            if rank == 0:
                out["jax_imported"] = np.array("jax" in sys.modules)
                np.savez(io / f"out_{case['name']}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
