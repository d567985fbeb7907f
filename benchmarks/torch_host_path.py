#!/usr/bin/env python3
"""Host cost of the PyTorch/CUDA port's kernel launches and of a NIN
request, the redesigned B1, B3, B4, B8, B9, B10 and B11 beside their
library calls, and the TinyLlama train step, for one tree of the port, on
one CUDA card.

    python3 benchmarks/torch_host_path.py [--src DIR] [--tag NAME]
                                          [--phases host_path,b3b4,...]

``repro_torch`` is imported from DIR (default: this checkout's ``src``),
so that two trees of the port, say a commit and its parent unpacked with
``git archive``, are compared on one card, one after the other (run them
in turns: parent, change, change, parent).  The kernels of that tree are
built as its own ``_build`` builds them.  The measurements are
``chip_smoke.py``'s:

  host_path  host µs per launch of every wrapper beside one PyTorch call
         (``launch_path_cases``, 10,000 calls with no synchronise), then
         NIN-CIFAR10 published to a temporary store and served through
         ``InferenceEngine``: batch-1 and batch-8 latency, batch-64
         images/s, and device time by part and idle share over 20
         requests at batch 1, 8 and 64
  b3b4   each B3 and B4 launch of one NIN forward at batch 8: events ms
         and device µs beside the library call's (F.max_pool2d,
         F.avg_pool2d, F.relu; B4 also in place beside torch.relu_, where
         the tree has ``relu_``), the plain version's ms and the bound
  b1     each LeNet dense layer at batch 8 (8 x 800 x 500, 8 x 500 x 10):
         events ms, device µs (torch.profiler), ``addmm``'s ms and µs
  b9     B8, B9's forward, dq and dk/dv at TinyLlama's train shape
         (batch 4 x 2048, 32/4 heads of 64, causal, fp32): events ms and
         device µs, beside SDPA's forward and the efficient-attention
         backward (dq, dk, dv in one call); B8 and SDPA's forward at the
         serving prefill (1 x 300, the same heads)
  train  TinyLlama-1.1B at batch 4 x 2048, fp32: train tokens/s and the
         step's device time by part (``train_step_record``)
  decode B6 (ring fp32) and B7 (paged int8) of TinyLlama-1.1B at batch 8
         (``serve_time_record``): decode tokens/s, TTFT, device ms per
         step by part and idle share, and per launch events ms and device
         µs at the live lanes and at 8 x 1000 of 1024 slots beside SDPA;
         the decode wrappers' host µs per launch (their ``launch_path``
         cases); on a split-KV tree (``decode_attention.plan``), both
         kernels at chunks of 32, 64 and 128 slots on 22
         synthetic layers at DECODE_SERVE_VALID and at 8 x 1000

  b10b11 B10 at 1 x 300 and 8 x 2048 x 40 x 64 (events ms, device µs,
         distance from the fp64 plain version; on a two-pass tree also
         every scan column block, device µs by pass) and B11 at the
         Granite int8 artifact's four shapes (beside torch._int_mm), their
         wrappers' host µs, and one 300-token RWKV-6 3B prefill's device
         ms with B10's part (``rwkv_prefill_profile``; full width and
         depth, weights from ``numpy_weights_chunked``)

  rg_attention  RecurrentGemma-9B's attention shapes (16 query heads of
         256 on one KV head, window 2048): B8 at the 1 x 300 and 1 x 2100
         prefills beside SDPA (``_b8_prefill_times``), B8's and B9's
         forward o against fp64 at 1 x 2100 (inputs uniform in [-2, 2),
         ``_flash_fp64_error``), and B6 (ring fp32) and B7 (paged int8)
         over 12 synthetic layers at RG_LIVE_VALID and B6 at 8 lanes of
         32, 512 and 2048 of 2048 slots (``decode_launch_record``: events
         ms, device µs, the error against fp64); on a tree with the wide
         route, its chunks of 32, 64 and 128 slots at RG_LIVE_VALID and
         8 x 2048 (``rg_chunks``)

``--phases`` runs the named phases only (default: all eight).  Prints
JSON lines, the card's name and power limit in each; exits 2 without a
CUDA card.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
PHASES = ("host_path", "b3b4", "b1", "b9", "train", "decode", "b10b11",
          "rg_attention")
B11_SHAPES = ((8, 1536, 1536), (300, 1536, 1536), (2048, 1536, 512),
              (2048, 512, 1536))   # (M, K, N) of the Granite int8 artifact's
# a decode step's 8 lanes of 5 to 300 slots (prompts of 5-300 plus new
# tokens), for the chunk sweep
DECODE_SERVE_VALID = (37, 300, 100, 5, 180, 120, 16, 250)
TRAIN_SHAPE = (4, 2048, 32, 4, 64)      # B, S, H, KV, D: TinyLlama's train
# RecurrentGemma-9B's attention: heads, KV heads, head dim, window, and
# 8 decode lanes like serve_hybrid's live ones (seven prompts of 5-300
# tokens into their first decode steps, one 2100-token prompt on a
# wrapped ring of 2048)
RG_HEADS = (16, 1, 256)
RG_WINDOW = 2048
RG_LIVE_VALID = (2048, 239, 100, 180, 150, 120, 210, 130)
RG_LAYERS = 12


def b9_calls(torch, fa):
    """B8, B9's forward, dq and dk/dv at the train shape beside SDPA's
    forward and the efficient-attention backward; B8 and SDPA's forward
    at the serving prefill."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    b, s, h, kvh, d = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(95)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v = randn(b, s, kvh, d), randn(b, s, kvh, d)
    qp, kp, vp = randn(1, 300, h, d), randn(1, 300, kvh, d), randn(1, 300, kvh, d)
    qpt = qp.transpose(1, 2).contiguous()
    kpt = kp.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
    vpt = vp.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
    o, lse = fa.flash_fwd_lse(q, k, v)
    res = (q, k, v, do, lse, fa.dsum_of(o, do))
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
    dot = do.transpose(1, 2).contiguous()
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    out_l, lse_l, seed_l, off_l = eff(qt, kt, vt, None, True, 0.0, True)

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            dot, qt, kt, vt, None, out_l, lse_l, seed_l, off_l, 0.0,
            [True, True, True, False], True)
    return {"b8": lambda: kops.flash_attention(q, k, v),
            "b9_forward": lambda: fa.flash_fwd_lse(q, k, v),
            "sdpa_forward": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True),
            "dq": lambda: fa.flash_dq(*res),
            "dkv": lambda: fa.flash_dkv(*res),
            "efficient_attention_backward": library,
            "b8_prefill_1x300": lambda: kops.flash_attention(qp, kp, vp),
            "sdpa_forward_prefill_1x300": lambda: F.scaled_dot_product_attention(
                qpt, kpt, vpt, is_causal=True)}


def decode_chunks(torch, cs, head):
    """B6 (ring fp32) and B7 (paged int8) at TinyLlama's heads through
    ``decode_attention.launch(..., chunk=)`` at chunks of 32, 64 and 128
    slots: events ms and device µs per launch over cs.DECODE_TIME_LAYERS
    synthetic layers cycled, and the largest distance from the plain
    version on the first layer, at DECODE_SERVE_VALID and at 8 x 1000."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(cs.SEED + 61)
    for form, dtype, paged, kern in (("ring fp32", "float32", False, da.RING),
                                     ("paged int8", "int8", True, da.PAGED_Q8)):
        for shape, valid in (("serve", DECODE_SERVE_VALID),
                             ("8 x 1000", (cs.DECODE_LONG_VALID,) * 8)):
            cases = [cs.decode_case(torch, gen, "cuda", b=8, kvh=4, g=8,
                                    dtype=dtype, layout="bksd", paged=paged,
                                    valid=list(valid))
                     for _ in range(cs.DECODE_TIME_LAYERS)]
            n = len(cases)
            want = cs.decode_call(kops, ref, cases[0], "bksd", plain=True)
            for chunk in (32, 64, 128):
                def call(c, chunk=chunk):
                    return da.launch(kern, c["q"], c["k"], c["v"], c["valid"],
                                     layout="bksd", scales=c["scales"],
                                     page_table=c.get("pt"), chunk=chunk)
                nxt = iter(range(1 << 62))
                cs.emit({"phase": "decode", **head, "chunk_sweep": form,
                         "shape": shape, "valid_len": list(valid),
                         "chunk": chunk,
                         "ms": cs.time_ms(torch, lambda: [call(c) for c in cases],
                                          iters=5) / n,
                         "device_us": cs.device_us(
                             torch, lambda: call(cases[next(nxt) % n]),
                             n=2 * n)[0],
                         "max_abs_vs_plain": float(
                             (call(cases[0]) - want).abs().max())})


def rg_attention(torch, cs, head):
    """B8, B9's forward and B6/B7 at RecurrentGemma-9B's attention shapes
    through their public wrappers, so any tree of the port runs them."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    h, kvh, d = RG_HEADS
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 121)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    for sq in (cs.PREFILL_SEQ, cs.HYBRID_LONG):
        cs.emit({"phase": "rg_attention", **head, "kernel": "flash_attention",
                 **cs._b8_prefill_times(torch, randn, h, kvh, d, sq=sq,
                                        window=RG_WINDOW)})
    q, k, v = (torch.rand(1, cs.HYBRID_LONG, n, d, generator=gen,
                          device="cuda") * 4 - 2 for n in (h, kvh, kvh))
    for name, o in (("B8", kops.flash_attention(q, k, v, window=RG_WINDOW)),
                    ("B9's forward", fa.flash_fwd_lse(q, k, v,
                                                      window=RG_WINDOW)[0])):
        rms, slope = cs._flash_fp64_error(torch, q, k, v, o, window=RG_WINDOW)
        cs.emit({"phase": "rg_attention", **head, "check": f"{name} against "
                 f"fp64 at 1 x {cs.HYBRID_LONG}, window {RG_WINDOW}",
                 "rms": rms, "slope_minus_1": slope})
    del q, k, v
    g = torch.Generator().manual_seed(cs.SEED + 122)
    rows = [("ring fp32", "float32", False, RG_LIVE_VALID),
            ("paged int8", "int8", True, RG_LIVE_VALID)] + [
        ("ring fp32", "float32", False, (n,) * 8) for n in (32, 512, 2048)]
    for form, dtype, paged, valid in rows:
        cases = [cs.decode_case(torch, g, "cuda", b=8, kvh=kvh, g=h // kvh,
                                dtype=dtype, layout="bksd", paged=paged,
                                s=cs.HYBRID_CACHE_LEN, d=d, valid=list(valid))
                 for _ in range(RG_LAYERS)]
        cs.emit({"phase": "rg_attention", **head, "kernel": "decode_attention",
                 "form": form, **cs.decode_launch_record(
                     torch, cases, h, d, plain=False)})
        if hasattr(da, "is_wide") and valid in (RG_LIVE_VALID, (2048,) * 8):
            rg_chunks(torch, cs, head, da, form, dtype, paged, cases)
        del cases
    torch.cuda.empty_cache()


def rg_chunks(torch, cs, head, da, form, dtype, paged, cases):
    """The wide route at every chunk it takes (32, 64 and 128 slots;
    fp32 rows fit 64): device µs per launch over the cycled layers and
    the largest distance from the plain version on the first."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    kern = da.PAGED_Q8 if paged else da.RING
    want = cs.decode_call(kops, ref, cases[0], "bksd", plain=True)
    n = len(cases)
    for chunk in (32, 64, 128):
        if chunk > 64 and dtype == "float32":
            continue

        def call(c, chunk=chunk):
            return da.launch(kern, c["q"], c["k"], c["v"], c["valid"],
                             layout="bksd", scales=c["scales"],
                             page_table=c.get("pt"), chunk=chunk)
        nxt = iter(range(1 << 62))
        cs.emit({"phase": "rg_attention", **head, "chunk_sweep": form,
                 "valid_len": cases[0]["valid"].tolist(), "chunk": chunk,
                 "device_us": cs.device_us(
                     torch, lambda: call(cases[next(nxt) % n]), n=2 * n)[0],
                 "max_abs_vs_plain": float((call(cases[0]) - want)
                                           .abs().max())})


def b10b11(torch, np, cs, head):
    """B10 and B11 through their public wrappers, so any tree of the port
    runs them: B10 at cs.WKV_TIMES (events ms, device µs, the out's
    distance from the fp64 plain version, also with w = 0 entries at
    1 x 300), B11 at B11_SHAPES (events ms, device µs, bit-equal to the
    plain version, torch._int_mm + epilogue beside it), both wrappers'
    host µs a launch, and one 300-token prefill of RWKV-6 3B at full width
    and depth (device ms, B10's part)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 81)
    for (b, t, h, n), w_zero in [(s_, False) for s_ in cs.WKV_TIMES] + [
            (cs.WKV_TIMES[0], True)]:
        x = cs.wkv_inputs(torch, gen, b, t, h, n, w_zero)
        want = ref.rwkv6_chunked_ref(*(y.double() for y in x))[0]
        got = kops.rwkv6_chunked(*x)[0].double() - want
        plain = ref.rwkv6_chunked_ref(*x)[0].double() - want
        del want
        rec = {"phase": "b10b11", **head, "kernel": "rwkv6_chunked",
               "shape": [b, t, h, n], "w_zero": w_zero,
               "fp64_max_abs": float(got.abs().max()),
               "fp64_rms": float(got.pow(2).mean().sqrt()),
               "plain_fp64_max_abs": float(plain.abs().max()),
               "plain_fp64_rms": float(plain.pow(2).mean().sqrt())}
        del got, plain
        if not w_zero:
            rec["ms"] = cs.time_ms(torch, lambda: kops.rwkv6_chunked(*x))
            rec["device_us"] = cs.device_us(
                torch, lambda: kops.rwkv6_chunked(*x))[0]
        cs.emit(rec)
        del x
    g = torch.Generator().manual_seed(cs.SEED + 112)
    for m, k, n in B11_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        sa, sb = torch.rand(m, generator=g) + 0.01, torch.rand(n, generator=g)
        a, b, sa, sb = (y.cuda() for y in (a, b, sa, sb))
        a_lib = a if m > 16 else torch.cat([a, a.new_zeros(32 - m, k)])
        cs.emit({"phase": "b10b11", **head, "kernel": "int8_matmul",
                 "shape": [m, k, n],
                 "bit_equal": torch.equal(kops.int8_matmul(a, b, sa, sb),
                                          ref.int8_matmul_ref(a, b, sa, sb)),
                 "ms": cs.time_ms(torch, lambda: kops.int8_matmul(a, b, sa, sb)),
                 "device_us": cs.device_us(
                     torch, lambda: kops.int8_matmul(a, b, sa, sb))[0],
                 "library_ms": cs.time_ms(torch, lambda: cs._int8_library(
                     torch, a_lib, b, sa, sb)),
                 "library_device_us": cs.device_us(
                     torch, lambda: cs._int8_library(torch, a_lib, b, sa,
                                                     sb))[0]})
    for row in [r for r in cs.launch_path_cases(torch)
                if r[0] in ("rwkv6_chunked", "int8_matmul")]:
        cs.emit({"phase": "b10b11", **head, "wrapper": row[0],
                 "shape": row[1], "calls": cs.LAUNCH_CALLS,
                 "host_us": cs.host_us(torch, row[2])})
    cfg = get_config(cs.RWKV_ARCH)
    params = params_from_numpy(cs.numpy_weights_chunked(np, cfg, cs.SEED + 3),
                               "cuda", cfg=cfg)
    prompt = torch.from_numpy(np.random.default_rng(cs.SEED + 95).integers(
        1, cfg.vocab_size, (1, cs.PREFILL_SEQ))).cuda()
    cs.emit({"phase": "b10b11", **head, "rwkv6_prefill":
             cs.rwkv_prefill_profile(torch, cfg, params, prompt)})
    del params
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds repro_torch")
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated, of " + ", ".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases: unknown {sorted(set(phases) - set(PHASES))}")
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_host_path: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    if pathlib.Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.importer import to_caffe_json
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import cnn

    cs.set_fp32_exact(torch)
    card = cs.phase_device(torch)
    head = {"tree": args.tag, "src": str(src), "card": card["nvidia_smi"]}
    graph = cnn.graph_for(get_config("nin-cifar10"))
    if "host_path" in phases:
        for row in cs.host_path_rows(torch):
            cs.emit({"phase": "host_path", **head, "calls": cs.LAUNCH_CALLS,
                     **row})
        params = params_from_numpy(cs.numpy_params(np, graph, cs.SEED),
                                   "cpu", graph=graph)
        build = ROOT / "build"
        build.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as store_root:
            store = ModelStore(pathlib.Path(store_root))
            store.publish("nin-cifar10", to_caffe_json(graph, params)[0],
                          params)
            engine = InferenceEngine(store)
            cs.emit({"phase": "host_path", **head,
                     **cs.nin_end_to_end(torch, np, engine, "nin-cifar10",
                                         graph.input_shape)})
            cs.phase_profile(torch, np, engine, card)
    if "b3b4" in phases:
        gen = torch.Generator().manual_seed(cs.SEED + 2)
        for kernel, d in cs.path_calls(graph, cs.TIMING_BATCH):
            if kernel in cs.DEVICE_TIMED:
                cs.emit({"phase": "b3b4", **head, "kernel": kernel,
                         **{("window" if k == "kernel" else k): v
                            for k, v in d.items()},
                         **cs.call_times(torch, kernel, d, gen)})
    if "b1" in phases:
        lenet = cnn.graph_for(get_config("lenet-mnist"))
        gen = torch.Generator().manual_seed(cs.SEED + 2)
        for row in cs.dense_layer_times(torch, lenet, gen):
            cs.emit({"phase": "b1", **head, **row})
    if "b9" in phases:
        cs.emit({"phase": "b9", **head, "shape": TRAIN_SHAPE,
                 **{name: {"ms": cs.time_ms(torch, fn, iters=5, reps=3),
                           "device_us": cs.device_us(torch, fn, n=5)[0]}
                    for name, fn in b9_calls(torch, fa).items()}})
    if "decode" in phases:
        from repro_torch.kernels import decode_attention as da
        for row in [r for r in cs.launch_path_cases(torch)
                    if r[0].startswith("decode")]:
            cs.emit({"phase": "decode", **head, "wrapper": row[0],
                     "shape": row[1], "calls": cs.LAUNCH_CALLS,
                     "host_us": cs.host_us(torch, row[2])})
        if hasattr(da, "plan"):                  # a split-KV tree: chunks to sweep
            decode_chunks(torch, cs, head)
        cfg = get_config("tinyllama-1.1b")
        params = params_from_numpy(cs.numpy_weights(np, cfg, cs.SEED), "cuda",
                                   cfg=cfg)
        for name in ("ring-fp32", "paged-int8"):
            cs.emit({**cs.serve_time_record(torch, np, cfg, params, name, card),
                     "phase": "decode", **head})
        del params
        torch.cuda.empty_cache()
    if "b10b11" in phases:
        b10b11(torch, np, cs, head)
    if "rg_attention" in phases:
        rg_attention(torch, cs, head)
    if "train" in phases:
        torch.cuda.empty_cache()
        tiny_np = cs.numpy_weights(np, get_config("tinyllama-1.1b"), cs.SEED)
        cs.emit({"phase": "train", **head,
                 **cs.train_step_record(torch, tiny_np)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
