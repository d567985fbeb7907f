"""The dry run's memory analysis (``launch/memory.py``): live storage
bytes counted op by op, rounded to the caching allocator's 512-byte
blocks, with the hand-written kernels charged as the card allocates them.

Hand-worked steps (two linear layers, AdamW's update, one B9 attention)
run here on meta tensors; the rest runs in subprocesses, since the dry
run needs a (fake) default process group: the count on meta tensors
against the same count on real CPU tensors, the argument bytes against
the JAX package's argument structs, a train step's growth with Sq, and
the FLOPs and bytes of reduced pairs against the parent commit's.  Every
comparison is exact unless a test says otherwise.
"""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import memory
from repro_torch.launch.memory import LiveBytes, block_bytes
from repro_torch.optim.adamw import AdamW, AdamWState

F32 = 4
SCALAR = 512       # a 0-dim tensor's block


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta").requires_grad_(grad)


def test_block_bytes_round_up_to_the_allocators_blocks():
    assert [block_bytes(n) for n in (0, 1, 512, 513, 4000)] == \
        [0, 512, 512, 1024, 4096]


def test_two_linear_layers_forward_and_backward_by_hand():
    """x (4, 64) @ w1 (64, 96) @ w2 (96, 40), summed, grads of w1 and w2.
    Live at the peak (gw1's allocation): the arguments, h and y (bound in
    the step), the loss, the root gradient (ones, which autograd.grad
    holds until it returns), dh (y's MmBackward's, still to be consumed)
    and gw2."""
    x, w1, w2 = _meta(4, 64), _meta(64, 96, grad=True), _meta(96, 40,
                                                                grad=True)

    def step(x, w1, w2):
        h = x @ w1
        y = h @ w2
        loss = y.sum()
        return loss, torch.autograd.grad(loss, (w1, w2))

    with LiveBytes() as live:
        live.arguments((x, w1, w2))
        out = step(x, w1, w2)
        got = live.analysis(out)
    args = (4 * 64 + 64 * 96 + 96 * 40) * F32              # all multiples
    h, y, dh = 4 * 96 * F32, block_bytes(4 * 40 * F32), 4 * 96 * F32
    gw1, gw2 = 64 * 96 * F32, 96 * 40 * F32
    assert got["peak_bytes"] == args + h + y + 2 * SCALAR + dh + gw2 + gw1
    # temporaries exclude the outputs (loss, gw1, gw2): at dh's
    # allocation h, y, the ones and dh are live
    assert got["temp_bytes"] == h + y + SCALAR + dh


def test_adamw_update_over_a_tree_of_known_sizes():
    """Per leaf of n bytes the update holds six n-byte temporaries at
    once (g * scale, m / bc1, v / bc2, the old and new direction and the
    weight decay term; then the same count in the parameter step); the
    largest leaf sets the peak.  Beside them live six 0-dim tensors: the
    new step, the grad norm and lr (outputs: the metrics hold lr itself),
    scale, bc1 and bc2."""
    shapes = {"a": (1000,), "b": (64, 48), "c": (7,)}
    params = {k: _meta(*s) for k, s in shapes.items()}
    grads = {k: _meta(*s) for k, s in shapes.items()}
    state = AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                       {k: _meta(*s) for k, s in shapes.items()},
                       {k: _meta(*s) for k, s in shapes.items()})
    opt = AdamW(lr=lambda step: step.float() * 1e-3)
    with LiveBytes() as live:
        live.arguments((grads, state, params))
        out = opt.update(grads, state, params)
        got = live.analysis(out)
    leaf = max(block_bytes(F32 * torch.Size(s).numel())
               for s in shapes.values())
    args = SCALAR + 4 * sum(block_bytes(F32 * torch.Size(s).numel())
                            for s in shapes.values())
    assert got["temp_bytes"] == 6 * leaf + 3 * SCALAR
    assert got["peak_bytes"] == args + 6 * leaf + 6 * SCALAR


def test_b9_is_charged_as_its_wrapper_allocates():
    """flash_attention_named with grad on meta tensors: the forward keeps
    o and lse; B9's backward holds dsum, dq, a contiguous copy of the
    (expanded) dO, dk and dv at its peak (in flash_dkv) -- not the plain
    version's (B, H, 1024, 1024) chunks of scores."""
    from repro_torch.models.common import flash_attention_named
    b, s, h, kv, d = 2, 2048, 4, 2, 32
    q, k, v = _meta(b, s, h, d, grad=True), _meta(b, s, kv, d, grad=True), \
        _meta(b, s, kv, d, grad=True)

    def step(q, k, v):
        o = flash_attention_named(q, k, v)
        loss = o.sum()
        return torch.autograd.grad(loss, (q, k, v))

    with LiveBytes() as live:
        live.arguments((q, k, v))
        out = step(q, k, v)
        got = live.analysis(out)
    qb, kb = b * s * h * d * F32, b * s * kv * d * F32
    lse = dsum = b * h * s * F32
    o, do_copy = qb, qb
    args = qb + 2 * kb
    assert got["peak_bytes"] == args + o + lse + SCALAR + SCALAR + dsum \
        + qb + do_copy + 2 * kb
    assert got["temp_bytes"] == o + lse + 2 * SCALAR + dsum + do_copy
    assert all(g.shape == x.shape for g, x in zip(out, (q, k, v)))


def test_without_a_count_the_plain_version_runs_as_it_is():
    assert memory.charging() is None
    x = torch.ones(3)
    assert memory.as_kernel(lambda t: t + 1, None, x).tolist() == [2, 2, 2]


def test_a_wrappers_refusal_propagates_under_a_count():
    """A kernel's wrapper that refuses its inputs raises under a count,
    as it does on the card: the plain version is not charged in its
    place."""
    from repro_torch.kernels import flash_attention as fa
    q, k = _meta(2, 40, 4, 48), _meta(2, 40, 2, 48)
    with LiveBytes():
        with pytest.raises(ValueError, match="head_dim 48"):
            memory.as_kernel(lambda *x: x[0] + 0, fa.flash_attention, q, k, k)


def test_a_loop_on_meta_holds_every_trips_output():
    """``op_costs.trips`` on meta runs two trips and holds n outputs,
    the first trip's standing for the n - 2 skipped ones: the second
    trip runs beside n - 1 of them, as the full loop's last one does."""
    from repro_torch.launch.op_costs import trips
    chunk = block_bytes(4 * 8 * F32)
    with LiveBytes() as live:
        loop = trips(5, True)
        for i in loop:
            loop.keep(torch.empty((4, 8), device="meta").t())
        got = live.analysis(None)
        assert len(loop.outs) == 5 and loop.outs[1].stride() == (1, 8)
    assert got["peak_bytes"] == 5 * chunk
    assert list(trips(3, False)) == [0, 1, 2]


PORT = textwrap.dedent("""
    import dataclasses, json, sys
    sys.path.insert(0, "src")
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as dr, memory, sharding as shd
    from repro_torch.launch.compat import make_mesh
    from repro_torch.sharding_hints import axis_rules

    dr.init_fake_group(8)
    AXES = ("data", "model")
    cuda1 = make_mesh((1, 1), AXES, device_type="cuda", devices=[0])
    cpu1 = make_mesh((1, 1), AXES, device_type="cpu", devices=[0])
    out = {"parity": {}, "plain": {}, "args": {}, "growth": {},
           "parent": {}, "ring": {}}

    def rules(arch, kind, pair):
        r = shd.rules_for_pair(arch, pair, kind, optimized=True) if pair \\
            else shd.rules_for(kind)
        r.pop("_mesh_shape", None)
        return r

    def on_cpu(cfg, shape, rules, dtype):
        with axis_rules(rules, cpu1):
            fn, structs, placements = dr.build_step(cfg, shape, rules, cpu1,
                                                    dtype)
            real = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                            structs)
            args = tuple(shd.distribute(t, p, cpu1)
                         for t, p in zip(real, placements))
            del real
            with memory.LiveBytes() as live:
                live.arguments(args)
                res = fn(*args)
                return live.analysis(res)

    for name, arch, kind, b, s, dtype, pair in %(parity)r:
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  **%(parity_cfg)r.get(name, {}))
        dt = getattr(torch, dtype)
        shape = ShapeSpec(name, s, b, kind)
        r = rules(arch, kind, pair)
        _, m = dr.count_step(cfg, shape, r, cpu1, dt)
        c = on_cpu(cfg, shape, r, dt)
        out["parity"][name] = [m["peak_bytes"], m["temp_bytes"],
                               c["peak_bytes"], c["temp_bytes"]]
        out["plain"][name] = m["plain_charged"]

    cfg = reduced(get_config("tinyllama-1.1b"))
    for kind in ("train", "prefill", "decode"):
        _, m = dr.count_step(cfg, ShapeSpec(kind, 256, 2, kind),
                             shd.rules_for(kind), cuda1)
        out["args"][kind] = m["argument_bytes"]

    def peaks():
        return [dr.count_step(cfg, ShapeSpec("g", s, 2, "train"),
                              shd.rules_for("train"), cuda1,
                              torch.float32)[1]["peak_bytes"]
                for s in (1024, 2048, 4096)]
    out["growth"]["kernel"] = peaks()
    charging, memory.charging = memory.charging, lambda: None
    out["growth"]["plain"] = peaks()    # every site ran its plain version
    memory.charging = charging

    for arch, shape in %(parent)r:
        r = dr.dryrun(arch, shape, optimized=True, verbose=False,
                      cfg=reduced(get_config(arch)), mesh_shape=(2, 4))
        ma = r["memory_analysis"]
        out["parent"][arch + "/" + shape] = [
            r["flops_per_device"], r["bytes_per_device"],
            r["wire_bytes_per_device"], r["ops_per_device"],
            ma["argument_bytes"], ma["peak_bytes"], ma["temp_bytes"]]
    # cache_attend_sharded on a rank that holds the whole ring: B6's
    # route ('cuda'; on CPU tensors B6's plain version) against the
    # einsum route ('ref') on the same caches, at a position below S and
    # one that has wrapped the ring, in both layouts, and the cross form
    from repro_torch.models import common as cm
    from repro_torch.sharding_hints import zeros
    B, KV, G, S, D = 2, 2, 3, 16, 8
    gen = torch.Generator().manual_seed(0)
    with axis_rules(shd.rules_for("decode"), cpu1):
        def filled(shape, *axes):
            t = zeros(shape, torch.float32, "cpu", *axes)
            t.to_local().copy_(torch.randn(shape, generator=gen))
            return t
        q = filled((B, 1, KV * G, D), "batch", None, "heads", None)
        for layout in ("bksd", "bskd"):
            cshape = (B, KV, S, D) if layout == "bksd" else (B, S, KV, D)
            caxes = ("batch", "tp_kv", "cache_seq", None) \
                if layout == "bksd" else ("batch", "cache_seq", "tp_kv", None)
            nshape = tuple(1 if n == S else n for n in cshape)
            naxes = tuple(None if a == "cache_seq" else a for a in caxes)
            ck0, cv0 = filled(cshape, *caxes), filled(cshape, *caxes)
            kn, vn = filled(nshape, *naxes), filled(nshape, *naxes)
            for pos in (S // 2 - 1, S + 5, None):
                got = []
                for backend in ("cuda", "ref"):
                    ck = zeros(cshape, torch.float32, "cpu", *caxes)
                    cv = zeros(cshape, torch.float32, "cpu", *caxes)
                    ck.to_local().copy_(ck0.to_local())
                    cv.to_local().copy_(cv0.to_local())
                    new = (None, None, None) if pos is None else \
                        (kn, vn, torch.tensor(pos))
                    o = cm.cache_attend_sharded(q, new[0], new[1], ck, cv,
                                                new[2], layout=layout,
                                                backend=backend)
                    got.append((o.to_local(), ck.to_local(), cv.to_local()))
                (o1, k1, v1), (o2, k2, v2) = got
                out["ring"][f"{layout}/{pos}"] = [
                    (o1 - o2).abs().max().item(), o2.abs().max().item(),
                    bool(torch.equal(k1, k2) and torch.equal(v1, v2)),
                    bool(torch.equal(k1, ck0.to_local())) == (pos is None)]
    # the largest storage one op makes (a block count), in the vocab-split
    # loss's forward and backward and in two prefill steps
    from repro_torch import models
    biggest = [0]
    charge = memory.LiveBytes._charge
    def tracked(self, t):
        sid = charge(self, t)
        if sid is not None:
            biggest[0] = max(biggest[0], memory.block_bytes(
                t.untyped_storage().nbytes()))
        return sid
    memory.LiveBytes._charge = tracked
    mesh8 = make_mesh((2, 4), AXES, device_type="cuda")
    def placed(x, axes, r):
        return shd.distribute(x, shd.struct_shardings(x, axes, r, mesh8),
                              mesh8)
    r = shd.rules_for("train")
    with axis_rules(r, mesh8):
        x = placed(torch.empty(4, 64, 1024, device="meta"),
                   ("batch", "seq", "vocab_act"), r).requires_grad_()
        lab = placed(torch.zeros(4, 64, dtype=torch.long, device="meta"),
                     ("batch", "seq"), r)
        biggest[0] = 0
        with memory.LiveBytes() as live:
            live.arguments((x, lab))
            loss = cm.softmax_xent(x, lab)
            g, = torch.autograd.grad(loss, x)
            m = live.analysis((loss, g))
        out["c6"] = {"xent": [biggest[0], x.to_local().numel() * 4,
                              x.numel() * 4, m["temp_bytes"]]}
    for arch in ("tinyllama-1.1b", "recurrentgemma-9b"):
        cfg = reduced(get_config(arch))
        shape = ShapeSpec("p", 256, 4, "prefill")
        r = shd.rules_for("prefill")
        with axis_rules(r, mesh8):
            fn, structs, pls = dr.build_step(cfg, shape, r, mesh8)
            args = tuple(shd.distribute(t, p, mesh8)
                         for t, p in zip(structs, pls))
            biggest[0] = 0
            with memory.LiveBytes() as live:
                live.arguments(args)
                logits, cache = fn(*args)
            mod = models.get_module(cfg)
            cl = models.cache_len(cfg, shape)
            spec, axes = mod.cache_spec(cfg, 4, cl, torch.bfloat16)
            want = shd.struct_shardings(
                {k: torch.empty(sh, device="meta")
                 for k, (sh, _) in spec.items()}, axes, r, mesh8)
            with memory.LiveBytes() as live:
                made = cm.prefill_cache(mod.init_cache, mod.cache_spec, cfg,
                                        4, cl, torch.bfloat16,
                                        args[1]["tokens"])
                made_peak = live.analysis(made)["peak_bytes"]
            out["c6"][arch] = {
                "biggest": biggest[0],
                "logits_whole": logits.numel() * logits.element_size(),
                "logits_local": logits.to_local().numel()
                * logits.element_size(),
                "cache_peak": made_peak,
                "cache_shards": sum(memory.block_bytes(
                    t.to_local().numel() * t.element_size())
                    for t in made.values()),
                "placed": all(tuple(cache[k].placements) == want[k]
                              and cache[k].dtype == dt
                              for k, (_, dt) in spec.items())}
    # one dense MoE call (no grad) on the fake (2, 4) mesh at a token
    # count where the global (E*C + 1, d) buffer dwarfs the weights
    from repro_torch.models import moe
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    b, s = %(c8_tokens)r
    r = shd.rules_for("prefill")
    with axis_rules(r, mesh8), torch.no_grad():
        tmpl = models.param_template(cfg)["layers"]
        lp = {k: placed(torch.empty(tmpl[k].shape[1:], device="meta"),
                        tmpl[k].axes[1:], r)
              for k in ("router", "we_gate", "we_up", "we_down")}
        x = placed(torch.empty(b, s, cfg.d_model, device="meta"),
                   ("batch", "seq", "embed"), r)
        biggest[0] = 0
        with memory.LiveBytes() as live:
            live.arguments((x, lp))
            res = moe.moe_ffn_dense(cfg, lp, x)
            m = live.analysis(res)
        C = moe._capacity(cfg, b * s)
        out["c8"] = {"peak": m["peak_bytes"], "biggest": biggest[0],
                     "buffer": (cfg.num_experts * C + 1) * cfg.d_model * 4,
                     "out_placements": str(res[0].placements),
                     "out_shape": list(res[0].shape)}
    memory.LiveBytes._charge = charge
    print("RESULT " + json.dumps(out))
""")

# (name, arch, kind, batch, seq, dtype, the pair whose rules it takes):
# TinyLlama's three steps (B9; B8 over 4 q chunks, two run on meta; B6),
# Granite's a2a prefill (collectives), Qwen3-MoE's prefill at the base
# rules (the dense body on DTensors) and its train step there with drops
# (the body's backward: a few tokens contract d, 2 x 1024 gather the
# weights), RWKV-6's prefill in fp32 (B10 over 4 chunks) and bf16 (B10 on
# bf16 r, k, v beside the fp32 decay)
PARITY = [
    ("tiny_train", "tinyllama-1.1b", "train", 2, 2048, "float32", None),
    ("tiny_prefill", "tinyllama-1.1b", "prefill", 2, 4096, "float32", None),
    ("tiny_decode", "tinyllama-1.1b", "decode", 2, 256, "float32", None),
    ("granite_prefill", "granite-moe-3b-a800m", "prefill", 2, 128,
     "float32", "prefill_32k"),
    ("qwen_moe_prefill", "qwen3-moe-235b-a22b", "prefill", 2, 128,
     "float32", None),
    ("qwen_moe_train", "qwen3-moe-235b-a22b", "train", 2, 128, "float32",
     None),
    ("qwen_moe_train_gather", "qwen3-moe-235b-a22b", "train", 2, 1024,
     "float32", None),
    ("rwkv_prefill", "rwkv6-3b", "prefill", 2, 64, "float32", None),
    ("rwkv_prefill_bf16", "rwkv6-3b", "prefill", 2, 64, "bfloat16", None),
]

# config fields of PARITY steps: the train steps drop entries
PARITY_CFG = {"qwen_moe_train": {"capacity_factor": 0.5},
              "qwen_moe_train_gather": {"capacity_factor": 0.5}}

# flops, bytes, wire bytes and ops of reduced pairs on a fake (2, 4) mesh
# with the perf overrides, recorded from commit 11534a4; the three train
# pairs' bytes, wire bytes and ops re-recorded where the loss came to
# keep each rank's vocab shard (no all-gather of the logits over the
# vocab, no scatter of their gradient; the FLOPs as recorded)
PARENT = {
    "tinyllama-1.1b/train_4k": (6081673691136.0, 1918316722242.0,
                                6555078676.0, 4557),
    "granite-moe-3b-a800m/prefill_32k": (9080097734656.0, 3590867354956.0,
                                         2315667476.0, 64122),
    "rwkv6-3b/prefill_32k": (650687545344.0, 179606120972.0,
                             20286793728.0, 172303),
    "whisper-medium/decode_32k": (1226833920.0, 17814551054.0, 3910144.0,
                                  421),
    "recurrentgemma-9b/train_4k": (4999341932544.0, 1384021004154.0,
                                   11941896970.0, 4121),
    "qwen3-moe-235b-a22b/train_4k": (6736656203776.0, 2489849459122.0,
                                     6252179624.0, 5950),
}


# the dense MoE call's batch and seq on the fake (2, 4) mesh
C8_TOKENS = (4, 2048)


@pytest.fixture(scope="module")
def port_run():
    code = PORT % {"parity": PARITY, "parity_cfg": PARITY_CFG,
                   "parent": [tuple(k.split("/")) for k in PARENT],
                   "c8_tokens": C8_TOKENS}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("name", [p[0] for p in PARITY])
def test_meta_count_equals_the_count_on_cpu_tensors(port_run, name):
    meta_peak, meta_temp, cpu_peak, cpu_temp = port_run["parity"][name]
    assert meta_peak > 0 and meta_temp > 0
    assert (meta_peak, meta_temp) == (cpu_peak, cpu_temp)


def test_no_parity_pair_charges_a_plain_version(port_run):
    """Every kernel a PARITY pair reaches takes its inputs, so no count
    charges a plain version in a kernel's place: B10 takes RWKV-6's fp32
    decay beside bf16 r, k, v (``rwkv_prefill_bf16``).  A refused dtype
    still raises under a count
    (``test_a_wrappers_refusal_propagates_under_a_count``)."""
    assert set(port_run["plain"]) == {p[0] for p in PARITY}
    for name, got in port_run["plain"].items():
        assert got == [], name


def test_the_vocab_split_loss_holds_no_more_than_a_logits_shard(port_run):
    """softmax_xent and its backward on (4, 64, 1024) fp32 logits split
    (batch over data, vocab over model) on the fake (2, 4) mesh: no op
    makes a storage larger than a rank's logits shard (the gathered
    (B, S, V) gradient was the whole logits, 8 shards), and the
    temporaries stay within three shards (the loss's exponentials, the
    backward's softmax and the gradient)."""
    biggest, local, whole, temp = port_run["c6"]["xent"]
    assert local * 8 == whole
    assert 0 < biggest <= memory.block_bytes(local)
    assert temp <= 3 * memory.block_bytes(local)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_prefill_keeps_its_cache_and_logits_sharded(port_run, arch):
    """The reduced prefill step (4 x 256, bf16) on the fake (2, 4) mesh:
    every cache leaf in its ``cache_spec`` placement and dtype; building
    the cache charges its shards' bytes and nothing else (its DTensors
    took a meta fp32 tensor of the global shape for their strides); and
    no op makes a storage larger than two logits shards (RecurrentGemma's
    logits came out of a matmul at the global batch and vocab, 8 shards).
    The largest is the fp32 copy that rms_norm makes of a rank's
    residual stream, (2, 256, 256): twice a bf16 (2, 256, 256) logits
    shard here, so a rank that held half the logits would fail."""
    got = port_run["c6"][arch]
    assert got["placed"]
    assert got["cache_peak"] == got["cache_shards"] > 0
    assert got["logits_local"] * 8 == got["logits_whole"]
    assert 0 < got["biggest"] <= 2 * memory.block_bytes(got["logits_local"])


def test_dense_moe_holds_less_than_one_global_buffer(port_run):
    """One ``moe_ffn_dense`` call (reduced Qwen3-MoE, 4 x 2048 tokens,
    fp32, no grad) on the fake (2, 4) mesh at the base rules: its counted
    peak, arguments included, stays below the bytes of one global
    (E*C + 1, d) buffer, and no storage it makes holds a third of one (a
    rank's filled buffer holds E*C/4 rows and a spare row, its gathered
    expert outputs the same and a zero row per token shard).
    Each rank holding the whole buffer and the experts' whole output, as
    the replicated body did, counts more than two buffers.  The output
    comes back split over the batch axis."""
    got = port_run["c8"]
    assert 0 < got["peak"] < got["buffer"]
    assert 0 < got["biggest"] <= got["buffer"] // 3
    assert got["out_shape"] == [*C8_TOKENS, 256]
    assert "Shard(dim=0)" in got["out_placements"]


@pytest.mark.parametrize("case", ["bksd/7", "bksd/21", "bksd/None",
                                  "bskd/7", "bskd/21", "bskd/None"])
def test_whole_ring_rank_takes_b6_with_the_einsum_routes_values(port_run,
                                                                case):
    """cache_attend_sharded's B6 route (``valid_len = min(pos + 1, S)``)
    against its einsum route on the same one-rank caches: pos 7 below
    the 16 slots, 21 past them (the ring wrapped), None the cross form
    (nothing written, every slot valid).  Outputs to 1e-6 of their
    largest value (fp32, two summation orders); the written caches
    equal, and the cross form writes nothing."""
    err, scale, caches_equal, written_as_asked = port_run["ring"][case]
    assert err <= 1e-6 * scale and scale > 0
    assert caches_equal and written_as_asked


JAX_ARGS = textwrap.dedent("""
    import dataclasses, json, sys
    sys.path.insert(0, "src")
    import jax, numpy as np
    from repro.configs.base import ShapeSpec, get_config, reduced
    from repro.launch import dryrun as jdr, sharding as jshd
    from repro.sharding_hints import axis_rules

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    cfg = reduced(get_config("tinyllama-1.1b"))
    out = {}
    for kind in ("train", "prefill", "decode"):
        rules = jshd.rules_for(kind)
        with axis_rules(rules, mesh):
            _, structs, _ = jdr.build_step(cfg, ShapeSpec(kind, 256, 2, kind),
                                           rules, mesh)
        out[kind] = int(sum(int(np.prod(s.shape)) * s.dtype.itemsize
                            for s in jax.tree.leaves(structs)))
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_args():
    r = subprocess.run([sys.executable, "-c", JAX_ARGS], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_equal_the_jax_argument_structs(port_run, jax_args,
                                                       kind):
    assert port_run["args"][kind] == jax_args[kind] > 0


def test_train_peak_grows_as_b9s_footprint_not_as_the_plain_scores(port_run):
    """Peaks at Sq 1024, 2048, 4096 (batch 2): with B9 charged every live
    tensor is linear in Sq, so the step from 2048 to 4096 is twice the
    step from 1024 to 2048 (within 1 %); the plain version's saved
    (B, H, 1024, 1024) score chunks grow as Sq^2 (over 3x)."""
    k1, k2, k4 = port_run["growth"]["kernel"]
    p1, p2, p4 = port_run["growth"]["plain"]
    assert abs((k4 - k2) - 2 * (k2 - k1)) <= 0.01 * (k4 - k2)
    assert (p4 - p2) > 3 * (p2 - p1)
    assert p4 > k4


@pytest.mark.parametrize("pair", sorted(PARENT))
def test_costs_of_reduced_pairs_equal_the_parent_commits(port_run, pair):
    flops, nbytes, wire, ops, args, peak, temp = port_run["parent"][pair]
    assert (flops, nbytes, wire, ops) == PARENT[pair]
    assert peak >= args > 0 and temp > 0


def test_meta_tensors_take_the_cuda_paths_checks_and_allocations():
    """B6/B7, B8, B9 and B10's wrappers on meta tensors: the outputs a
    launch returns, no launch counted, and the kernels' own checks (a
    head size only the plain versions take raises: no fall back)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    before = kops.launches()
    q, k = _meta(2, 40, 4, 64), _meta(2, 40, 2, 64)
    o, lse = fa.flash_fwd_lse(q, k, k)
    assert o.shape == q.shape and (lse.shape, lse.dtype) == \
        ((2, 4, 40), torch.float32)
    assert kops.flash_attention(q, k, k).shape == q.shape
    assert fa.flash_dq(q, k, k, q, lse, lse).shape == q.shape
    assert [t.shape for t in fa.flash_dkv(q, k, k, q, lse, lse)] == \
        [k.shape, k.shape]
    with pytest.raises(ValueError, match="head_dim 48"):
        kops.flash_attention(_meta(2, 40, 4, 48), *[_meta(2, 40, 2, 48)] * 2)
    qd, kd = _meta(2, 8, 32), _meta(2, 2, 16, 32)
    kq = kd.to(torch.int8)
    sc = _meta(2, 2, 16)
    pt = torch.zeros(2, 1, dtype=torch.int32, device="meta")
    for out in (kops.decode_attention(qd, kd, kd, 4, layout="bksd"),
                kops.decode_attention_q8(qd, kq, kq, sc, sc, 4, layout="bksd"),
                kops.decode_attention_paged(qd, kd, kd, pt, 4, layout="bksd"),
                kops.decode_attention_paged_q8(qd, kq, kq, sc, sc, pt, 4,
                                               layout="bksd")):
        assert (out.shape, out.dtype, out.device.type) == \
            (qd.shape, torch.float32, "meta")
    with pytest.raises(ValueError, match="head_dim 30"):
        kops.decode_attention(_meta(2, 8, 30), *[_meta(2, 2, 16, 30)] * 2, 4,
                              layout="bksd")
    r, u = _meta(1, 20, 2, 32), _meta(2, 32)
    out, state = kops.rwkv6_chunked(r, r, r, r, u)
    assert out.shape == r.shape and (state.shape, state.dtype) == \
        ((1, 2, 32, 32), torch.float32)
    with pytest.raises(ValueError, match="head size N 16"):
        kops.rwkv6_chunked(*[_meta(1, 20, 2, 16)] * 4, _meta(2, 16))
    assert kops.launches() == before
    kops.drop_meta()


def test_a_kept_workspace_is_charged_once_from_its_first_call():
    """B6's workspace is made by the first call of its geometry and kept:
    two calls charge it once and it stays live, each call's int32
    valid_len is a temporary, and every count starts without it."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops as kops
    q, k = _meta(2, 8, 32), _meta(2, 2, 16, 32)
    ws = block_bytes(4 * da.plan(2, 2, 4, 32, 4, slots=16).ws_words)
    out = block_bytes(2 * 8 * 32 * F32)
    for _ in range(2):
        with LiveBytes() as live:
            live.arguments((q, k))
            outs = [kops.decode_attention(q, k, k, 4, layout="bksd")
                    for _ in range(2)]
            got = live.analysis(outs)
        assert got["temp_bytes"] == ws + SCALAR
        assert got["peak_bytes"] == block_bytes(q.numel() * F32) + \
            block_bytes(k.numel() * F32) + ws + 2 * out + SCALAR
