#!/usr/bin/env python3
"""Drive the port's main paths on one CUDA card and hold every kernel of
them against its plain PyTorch version.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, one JSON line or more each (``"phase": ...``), each followed by
its seconds:

  device          the card's name and power limit (nvidia-smi), torch, CUDA
  build           nvcc builds src/repro_torch/kernels/csrc into build/kernels
  slice 1, the paper's CNN path:
  kernels         B1, B3-B5 against their plain versions at the main path's
                  shapes (batch 8) and at ragged shapes, tolerance per check
  nin, lenet      NIN-CIFAR10 / LeNet-MNIST at full width: numpy-seeded
                  weights -> Caffe JSON -> ModelStore (fp32 and int8) ->
                  InferenceEngine on the ``cuda`` backend at batch 1, 8, 64;
                  launch counts per forward; every layer against ``ref``
  times, profile  each kernel, its plain version and one PyTorch call at
                  NIN's batch-8 shapes; NIN latency and images/s; device
                  time by part and idle share (torch.profiler)
  b2_times        B2 conv2d (im2col + B1) over NIN's 9 convs against
                  F.conv2d (TF32 off) and its bound
  slice 2, transformer serving:
  decode_kernels  B6 and B7 against their plain versions: TinyLlama and
                  Qwen3 heads, B 1 and 8, S 1024, fp32/bf16/int8, both
                  layouts, fragmented page tables; nothing read past
                  valid_len
  serve           TinyLlama-1.1B at full width through ServingEngine in five
                  cache forms, on the kernel and on ``ref``: tokens, launches
                  (22 x decode steps), one host sync per request, 8 ticks
                  under sync debug mode "error", prefix hits, page audit;
                  teacher-forced logits and a ring that wraps
  serve_times     decode tokens/s and TTFT (scheduler counters), device time
                  per step and idle share, B6/B7 per launch against bound,
                  plain version and SDPA
  multimodel      TinyLlama-1.1B and Qwen3-0.6B (and its int8 artifact)
                  through MultiModelServer: hits, misses, switch log

Then the card's name and power limit, the ``{"kernels": [...]}`` line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check or
phase makes the run exit 1 without that line; so does a machine without
CUDA, or a directory without the repo.
"""
from __future__ import annotations

import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
BATCHES = (1, 8, 64)
TIMING_BATCH = 8
# H100 SXM, NVIDIA's data sheet (dense, no sparsity): fp32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
SOURCES = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:87"),
    "pool2d": ("src/repro_torch/kernels/csrc/pool.cu",
               "src/repro/kernels/pool.py:71"),
    "elementwise": ("src/repro_torch/kernels/csrc/elementwise.cu",
                    "src/repro/kernels/elementwise.py:40"),
    "softmax": ("src/repro_torch/kernels/csrc/softmax.cu",
                "src/repro/kernels/softmax.py:34"),
}
# launches of each kernel per forward: 9 conv (matmul) + 9 relu + 3 pool +
# softmax for NIN; 2 conv + 2 dense, 1 relu, 2 pool, softmax for LeNet
PER_FORWARD = {
    "nin-cifar10": {"matmul": 9, "conv2d": 9, "elementwise": 9, "pool2d": 3,
                    "softmax": 1},
    "lenet-mnist": {"matmul": 4, "conv2d": 2, "elementwise": 1, "pool2d": 2,
                    "softmax": 1},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Run:
    """Collects failed checks; a phase that raises is one failure."""

    def __init__(self):
        self.failures = []
        self.max_err = {}

    def check(self, phase, what, ok, **info):
        if not ok:
            self.failures.append({"phase": phase, "check": what, **info})
        return ok

    def phase(self, name, fn, *args):
        try:
            return fn(*args)
        except Exception as e:   # the run goes on to report every phase, then exits 1
            self.failures.append({"phase": name, "error": repr(e),
                                  "traceback": traceback.format_exc()[-2000:]})
            emit({"phase": name, "ok": False, "error": repr(e)})
            return None


# ---------------------------------------------------------------------------
# the main path's shapes, read from the graph
# ---------------------------------------------------------------------------


def path_calls(graph, batch):
    """(kernel, description) for every kernel launch of one forward."""
    calls = []
    s = graph.input_shape
    for layer, o in zip(graph.layers, graph.shapes()):
        a = layer.attrs
        if layer.kind == "conv":
            calls.append(("matmul", dict(m=batch * o[1] * o[2],
                                         k=s[0] * a["kernel"] ** 2,
                                         n=a["out_channels"], weight_t=True)))
        elif layer.kind == "dense":
            calls.append(("matmul", dict(m=batch, k=a["in_features"],
                                         n=a["out_features"], weight_t=False)))
        elif layer.kind == "relu":
            calls.append(("elementwise", dict(shape=(batch, *s))))
        elif layer.kind == "pool":
            calls.append(("pool2d", dict(shape=(batch, *s), mode=a["mode"],
                                         kernel=a["kernel"],
                                         stride=a["stride"], pad=a["pad"])))
        elif layer.kind == "softmax":
            calls.append(("softmax", dict(shape=(batch, int(math.prod(s))))))
        s = o
    return calls


def make_inputs(torch, kernel, d, gen, dev, act="none"):
    """Tensors for one launch; activations are nonnegative (relu outputs),
    weights He-scaled, as on the main path."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)
    if kernel == "matmul":
        a = randn(d["m"], d["k"]).relu_()
        if d["weight_t"]:                 # conv: w.reshape(O, -1).T view
            b = (randn(d["n"], d["k"]) * math.sqrt(2 / d["k"])).t()
        else:
            b = randn(d["k"], d["n"]) * math.sqrt(2 / d["k"])
        return (a, b, randn(d["n"]) * 0.1), dict(activation=act)
    if kernel == "pool2d":
        return (randn(*d["shape"]).relu_(),), dict(
            mode=d["mode"], kernel=d["kernel"], stride=d["stride"],
            pad=d["pad"])
    if kernel == "elementwise":
        return (randn(*d["shape"]) * 3,), dict(act=act)
    return (randn(*d["shape"]) * 3,), {}


def bound(kernel, d):
    """(seconds from bytes, seconds from operations): each input read once,
    each output written once; operations at the fp32 peak."""
    if kernel == "matmul":
        m, k, n = d["m"], d["k"], d["n"]
        nbytes = 4 * (m * k + k * n + n + m * n)
        ops = 2 * m * n * k
    elif kernel == "pool2d":
        b, c, h, w = d["shape"]
        oh = (h + 2 * d["pad"] - d["kernel"]) // d["stride"] + 1
        ow = (w + 2 * d["pad"] - d["kernel"]) // d["stride"] + 1
        nbytes = 4 * (b * c * h * w + b * c * oh * ow)
        ops = b * c * oh * ow * d["kernel"] ** 2
    else:
        n = math.prod(d["shape"])
        nbytes = 8 * n
        ops = n * (1 if kernel == "elementwise" else 4)
    return nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS


def kernel_and_plain():
    """kernel name -> (wrapper, plain version); same arguments for both."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    return {"matmul": (kops.matmul, ref.matmul_ref),
            "pool2d": (kops.pool2d, ref.pool2d_ref),
            "elementwise": (kops.elementwise, ref.elementwise_ref),
            "softmax": (kops.softmax, ref.softmax_ref)}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "disk_free_gb": shutil.disk_usage(ROOT).free / 1e9,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0]}
    emit({"phase": "device", **card})
    return card


def phase_build():
    from repro_torch.kernels import _build
    path = _build.build()
    regs = [line.replace("ptxas info    :", "").strip()
            for line in _build.build_log().splitlines()
            if any(w in line for w in ("entry function", "registers",
                                       "spill"))]
    emit({"phase": "build", "library": str(path.relative_to(ROOT)),
          "build_seconds": _build.build_seconds, "ptxas": regs})


def phase_kernels(run, torch, graphs):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "kernels", "cudnn.allow_tf32":
          torch.backends.cudnn.allow_tf32,
          "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    wrappers = kernel_and_plain()
    # tolerances: matmul sums K products in another order than cuBLAS
    # (fp32, no TF32); pooling repeats the plain version's order exactly;
    # activations differ by an ulp of expf/tanhf near cancellation
    tol = {"matmul": (1e-4, 1e-4), "pool2d/max": (0.0, 0.0),
           "pool2d/avg": (1e-6, 0.0), "elementwise": (1e-6, 1e-6),
           "softmax": (1e-5, 1e-8)}
    cases = []
    for g in graphs.values():
        cases += path_calls(g, TIMING_BATCH)
    uniq = []
    for c in cases:
        if c not in uniq:
            uniq.append(c)
    cases = uniq + [("matmul", dict(m=37, k=75, n=19, weight_t=False)),
                    ("matmul", dict(m=129, k=2401, n=65, weight_t=True)),
                    ("elementwise", dict(shape=(3, 7, 61))),
                    ("pool2d", dict(shape=(2, 3, 9, 10), mode="max",
                                    kernel=3, stride=2, pad=1)),
                    ("pool2d", dict(shape=(2, 3, 9, 10), mode="avg",
                                    kernel=3, stride=2, pad=1)),
                    ("softmax", dict(shape=(64, 1000))),
                    ("softmax", dict(shape=(5, 37), extreme=True))]
    summary = {}
    for kernel, d in cases:
        acts = {"matmul": ["none", "relu", "silu", "gelu"],
                "elementwise": ["relu", "silu", "gelu", "tanh", "sigmoid"]
                }.get(kernel, ["none"])
        for act in acts:
            args, kw = make_inputs(torch, kernel, d, gen, dev, act)
            if d.get("extreme"):
                args[0][0, 0], args[0][-1, -1] = 1e4, -1e4
            if kernel == "elementwise" and d["shape"] == (3, 7, 61):
                args = (torch.randn(3 * 7 * 61 + 1, generator=gen)
                        .to(dev)[1:],)          # 4-byte offset: scalar path
            if kernel == "pool2d" and d["mode"] == "max" and d["shape"][0] == 2:
                args = (torch.randn(*d["shape"], generator=gen).to(dev),)
            fn, plain = wrappers[kernel]
            got = fn(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            key = kernel if kernel != "pool2d" else f"pool2d/{d['mode']}"
            rtol, atol = tol[key]
            err = (got - want).abs()
            limit = atol + rtol * want.abs()
            bad = int((err > limit).sum()) + int(
                (torch.isnan(got) != torch.isnan(want)).sum())
            max_err = float(err.nan_to_num(0).max()) if err.numel() else 0.0
            run.max_err[kernel] = max(run.max_err.get(kernel, 0.0), max_err)
            s = summary.setdefault(key, {"checks": 0, "failed": 0,
                                         "max_abs_err": 0.0,
                                         "rtol": rtol, "atol": atol})
            s["checks"] += 1
            s["max_abs_err"] = max(s["max_abs_err"], max_err)
            if not run.check("kernels", f"{key} {d} act={act}", bad == 0,
                             max_abs_err=max_err, mismatches=bad):
                s["failed"] += 1
    for key, s in summary.items():
        emit({"phase": "kernels", "kernel": key, **s})


def numpy_params(np, graph, seed):
    """He-scaled numpy weights, nonzero biases, in the graph's layouts."""
    import torch
    rng = np.random.default_rng(seed)
    out = {}
    for layer, group in graph.init_params(torch.Generator()).items():
        out[layer] = {}
        for name, v in group.items():
            shape = tuple(v.shape)
            fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
            scale = math.sqrt(2.0 / fan_in) if len(shape) > 1 else 0.1
            out[layer][name] = (scale * rng.standard_normal(shape)) \
                .astype(np.float32)
    return out


def phase_model(run, torch, np, name, graph, store_root):
    """Publish, serve through the engine on the card, count launches,
    compare every layer with the ref backend on the card."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.importer import from_caffe_json, to_caffe_json
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.kernels import ops as kops

    params = params_from_numpy(numpy_params(np, graph, SEED), "cpu",
                               graph=graph)
    doc, _ = to_caffe_json(graph, params)
    store = ModelStore(store_root)
    store.publish(name, doc, params)
    store.publish(name + "-int8", doc, params, int8=True)
    engine = InferenceEngine(store)                   # cuda, backend cuda
    run.check(name, "engine defaults", engine.device.type == "cuda"
              and engine.backend == "cuda", backend=engine.backend)
    ref_engine = InferenceEngine(store, backend="ref")
    rng = np.random.default_rng(SEED + 1)
    per_fwd = PER_FORWARD[name]
    report = {"phase": name, "forwards": 0, "results": []}

    # the main path, with the counts at 0 just before it
    xs = {b: rng.standard_normal((b, *graph.input_shape)).astype(np.float32)
          for b in BATCHES}
    kops.reset_launches()
    outputs = []
    for model in (name, name + "-int8"):
        for batch, x in xs.items():
            before = kops.launches()
            cb = engine.enqueue(model, x)
            y = cb.wait_until_completed()
            engine.fence()
            y2 = engine.predict(model, x)
            after = kops.launches()
            report["forwards"] += 2
            delta = {k: after[k] - before[k] for k in after}
            run.check(name, f"launches {model} b={batch}",
                      delta == {k: 2 * per_fwd.get(k, 0) for k in delta},
                      launches=delta)
            outputs.append((model, batch, x, y, y2))
    counts = kops.launches()                          # read just after
    report["launches"] = counts
    n = report["forwards"]
    run.check(name, "launches over the run",
              counts == {k: n * per_fwd.get(k, 0) for k in counts},
              launches=counts)

    # correctness, outside the counted run
    for model, batch, x, y, y2 in outputs:
        y_ref = ref_engine.predict(model, x)
        ok_shape = tuple(y.shape) == (batch, 10) and bool(
            torch.isfinite(y).all())
        row_err = float((y.sum(-1) - 1).abs().max())
        prob_err = float((y - y_ref).abs().max())
        repeat_err = float((y - y2).abs().max())
        run.check(name, f"{model} b={batch} shape/finite", ok_shape)
        run.check(name, f"{model} b={batch} rows sum to 1", row_err < 1e-5,
                  err=row_err)
        run.check(name, f"{model} b={batch} probs vs ref (atol 1e-5)",
                  prob_err <= 1e-5, err=prob_err)
        run.check(name, f"{model} b={batch} repeat", repeat_err == 0.0,
                  err=repeat_err)
        # every layer, cuda backend against ref backend, on the card
        _, spec, dev_params, _ = engine.load(model)
        g, _ = from_caffe_json(spec)
        xs = torch.from_numpy(x).cuda()
        got, want = [], []
        with torch.inference_mode():
            g.apply(dev_params, xs, backend="cuda", trace=got)
            g.apply(dev_params, xs, backend="ref", trace=want)
        worst = 0.0
        for layer, a, b in zip(g.layers, got, want):
            err = (a - b).abs()
            ok = bool((err <= 1e-4 + 1e-3 * b.abs()).all())
            worst = max(worst, float((err / (1e-4 + 1e-3 * b.abs())).max()))
            run.check(name, f"{model} b={batch} layer {layer.name} "
                      "(rtol 1e-3, atol 1e-4)", ok, err=float(err.max()))
        report["results"].append({
            "model": model, "batch": batch, "row_sum_err": row_err,
            "probs_vs_ref_max_abs": prob_err,
            "worst_layer_err_over_tol": worst})
    int8_gap = max(float((a[3] - b[3]).abs().max())
                   for a, b in zip(outputs[:len(BATCHES)],
                                   outputs[len(BATCHES):]))
    run.check(name, "int8 within 0.05 of fp32", int8_gap < 0.05,
              gap=int8_gap)
    report["int8_vs_fp32_max_abs"] = int8_gap
    emit(report)
    return engine, counts


def time_ms(torch, fn, iters=20, reps=7):
    """Median over reps of (CUDA-event time of iters calls) / iters."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def phase_times(run, torch, np, graph, engine, card):
    """Per-kernel times over one NIN forward at batch 8: the sum over its
    launches of each launch's median time.  Inputs stay in L2 (< 50 MB),
    as the previous layer's output does on the main path."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    library = {
        "matmul": lambda a, b, bias, activation: torch.addmm(bias, a, b),
        "pool2d": lambda x, mode, kernel, stride, pad:
            F.max_pool2d(x, kernel, stride, pad) if mode == "max" else
            F.avg_pool2d(x, kernel, stride, pad, count_include_pad=False),
        "elementwise": lambda x, act: F.relu(x),
        "softmax": lambda x: torch.softmax(x, -1),
    }
    wrappers = kernel_and_plain()
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bytes_s": 0.0, "ops_s": 0.0, "bound_s": 0.0,
                  "launches_per_forward": 0}
              for k in SOURCES}
    per_call = []
    for kernel, d in path_calls(graph, TIMING_BATCH):
        act = "relu" if kernel == "elementwise" else "none"
        args, kw = make_inputs(torch, kernel, d, gen, dev, act)
        fn, plain = wrappers[kernel]
        t = totals[kernel]
        ms = time_ms(torch, lambda: fn(*args, **kw))
        plain_ms = time_ms(torch, lambda: plain(*args, **kw))
        lib_ms = time_ms(torch, lambda: library[kernel](*args, **kw))
        b_s, o_s = bound(kernel, d)
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["library_ms"] += lib_ms
        t["bytes_s"] += b_s
        t["ops_s"] += o_s
        t["bound_s"] += max(b_s, o_s)
        t["launches_per_forward"] += 1
        per_call.append({"kernel": kernel,
                         **{("window" if k == "kernel" else k): v
                            for k, v in d.items() if k != "weight_t"},
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": 1e3 * max(b_s, o_s),
                         "bound_by": "bytes" if b_s >= o_s else "operations"})
    for row in per_call:
        emit({"phase": "times", "card": card["nvidia_smi"], **row})

    # end to end through the engine (host clock around synchronised work)
    rng = np.random.default_rng(SEED + 3)
    x1 = rng.standard_normal((1, *graph.input_shape)).astype(np.float32)
    x64 = rng.standard_normal((64, *graph.input_shape)).astype(np.float32)
    for _ in range(5):
        engine.predict("nin-cifar10", x1)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        engine.predict("nin-cifar10", x1)
        lat.append(time.perf_counter() - t0)
    engine.predict("nin-cifar10", x64)
    torch.cuda.synchronize()
    thr = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(10):
            engine.predict("nin-cifar10", x64)
        torch.cuda.synchronize()
        thr.append(640 / (time.perf_counter() - t0))
    # device time of one batch-1 forward (CUDA events around the pipeline)
    _, _, params, fn = engine.load("nin-cifar10")
    xs = torch.from_numpy(x1).to(dev)
    fwd_ms = time_ms(torch, lambda: fn(params, xs), iters=10)
    e2e = {"phase": "times", "card": card["nvidia_smi"],
           "nin_b1_latency_ms_median": 1e3 * statistics.median(lat),
           "nin_b1_latency_ms_p90": 1e3 * sorted(lat)[int(0.9 * len(lat))],
           "nin_b1_forward_event_ms": fwd_ms,
           "nin_b64_images_per_s_median": statistics.median(thr)}
    emit(e2e)
    return totals


# device kernels by name -> the part of the forward they belong to
PROFILE_GROUPS = (("sgemm_bias_act", "matmul"), ("pool2d_kernel", "pool2d"),
                  ("ew_vec4", "elementwise"), ("ew_scalar", "elementwise"),
                  ("softmax_rows", "softmax"), ("im2col", "im2col (F.unfold)"),
                  ("Memcpy HtoD", "input copy"))


def phase_profile(torch, np, engine, card):
    """Device time by part and the device's idle share, over 20 NIN
    requests through engine.predict at batch 1 and 8 (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 4)
    for batch in (1, 8):
        x = rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)
        for _ in range(3):
            engine.predict("nin-cifar10", x)
        torch.cuda.synchronize()
        n = 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                engine.predict("nin-cifar10", x)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        parts = {}
        for e in prof.events():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            part = next((p for key, p in PROFILE_GROUPS if key in e.name),
                        "other (layout copies)")
            parts[part] = parts.get(part, 0.0) + e.device_time / n
        busy = sum(parts.values())
        emit({"phase": "profile", "card": card["nvidia_smi"], "batch": batch,
              "requests": n, "wall_us_per_request": wall_us / n,
              "device_us_per_request": busy if parts else "not measured",
              "device_idle_share": 1 - busy * n / wall_us if parts
              else "not measured",
              "device_us_by_part": parts})


# ---------------------------------------------------------------------------
# slice 2: the serving decode path of the dense transformer
# ---------------------------------------------------------------------------

DEVICE = "cuda"                   # every tensor and engine of slice 2
DECODE_SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:208"),
    "decode_attention_paged": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:311"),
}
# each family's entry points in kernels.ops (float and int8 caches)
DECODE_FAMILY = {"decode_attention": ("decode_attention", "decode_attention_q8"),
                 "decode_attention_paged": ("decode_attention_paged",
                                            "decode_attention_paged_q8")}
# both sides compute in fp32 from the same stored values
DECODE_TOL = (1e-4, 1e-5)                           # rtol, atol
SERVE_REQUESTS = 16
SERVE_MAX_NEW = 48
SERVE_CACHE_LEN = 1024
SERVE_CONFIGS = {                                   # name -> engine options
    "ring-fp32": {},
    "ring-bf16": {"kv_dtype": "bf16"},
    "ring-int8": {"kv_dtype": "int8"},
    "paged-fp32": {"kv_layout": "paged", "page_size": 16},
    "paged-int8": {"kv_layout": "paged", "page_size": 16, "kv_dtype": "int8"},
}


def set_fp32_exact(torch):
    """TF32 off everywhere: the plain versions and the JAX package keep
    fp32 products, and the bars below assume them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def compare(torch, got, want, rtol, atol):
    """(max abs error, count of elements out of tolerance or NaN-mismatched)."""
    err = (got.float() - want.float()).abs()
    bad = int((err > atol + rtol * want.float().abs()).sum()) + int(
        (torch.isnan(got) != torch.isnan(want)).sum())
    return (float(err.nan_to_num(0).max()) if err.numel() else 0.0), bad


def decode_case(torch, gen, dev, *, b, kvh, g, dtype, layout, paged,
                s=1024, d=64, ps=16, valid=None):
    """One B6/B7 call's inputs: q, caches (fp32, bf16 or int8 + scales),
    ragged valid lengths; for the paged form a fragmented, out-of-order
    table with the garbage page 0 in unused entries and one pool page
    shared by two lanes."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)
    if valid is None:
        valid = ([1, s, 65, 700, 64, 129, 1000, 2] * 2)[:b]
    outer = 1 + b * (s // ps) if paged else b
    slots = ps if paged else s
    shape = (outer, kvh, slots, d) if layout == "bksd" else (outer, slots, kvh, d)
    q = randn(b, kvh * g, d)
    if dtype == "int8":
        k = torch.randint(-127, 128, shape, generator=gen,
                          dtype=torch.int8).to(dev)
        v = torch.randint(-127, 128, shape, generator=gen,
                          dtype=torch.int8).to(dev)
        scales = tuple((0.01 + 0.04 * torch.rand(*shape[:3], generator=gen))
                       .to(dev) for _ in range(2))
    else:
        dt = getattr(torch, dtype)
        k, v = randn(*shape).to(dt), randn(*shape).to(dt)
        scales = None
    case = {"q": q, "k": k, "v": v, "scales": scales,
            "valid": torch.tensor(valid, dtype=torch.int32, device=dev)}
    if paged:
        w = s // ps
        perm = torch.randperm(outer - 1, generator=gen) + 1
        pt = perm[:b * w].reshape(b, w).to(torch.int32)
        for i, n in enumerate(valid):
            pt[i, -(-n // ps):] = 0                 # unused -> garbage page
        if b > 3:
            pt[3, 0] = pt[2, 0]                     # a page shared by two lanes
        case["pt"] = pt.to(dev)
    return case


def decode_call(kops, ref, case, layout, plain=False):
    """The wrapper (or its plain version) on one case."""
    q, k, v, sc, vl = (case["q"], case["k"], case["v"], case["scales"],
                       case["valid"])
    paged = "pt" in case
    if sc is not None:
        fn = (ref.decode_attention_paged_q8_ref if plain
              else kops.decode_attention_paged_q8) if paged else \
            (ref.decode_attention_q8_ref if plain else kops.decode_attention_q8)
        args = (q, k, v, *sc, case["pt"], vl) if paged else (q, k, v, *sc, vl)
    else:
        fn = (ref.decode_attention_paged_ref if plain
              else kops.decode_attention_paged) if paged else \
            (ref.decode_attention_ref if plain else kops.decode_attention)
        args = (q, k, v, case["pt"], vl) if paged else (q, k, v, vl)
    return fn(*args, layout=layout)


def phase_decode_kernels(run, torch):
    """B6 and B7 against their plain versions on the card: TinyLlama heads
    (KV 4, G 8) and Qwen3 heads (KV 8, G 2), B 1 and 8, S 1024, ragged
    valid lengths, fp32/bf16/int8 caches, both layouts; then slots past
    valid_len set to NaN must not change the output."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(SEED + 10)
    rtol, atol = DECODE_TOL
    summary = {}
    for paged in (False, True):
        fam = "decode_attention_paged" if paged else "decode_attention"
        for kvh, g in ((4, 8), (8, 2)):
            for b, valid in ((1, [1]), (1, [777]), (8, None)):
                if paged and b == 1:
                    continue
                for dtype in ("float32", "bfloat16", "int8"):
                    for layout in ("bksd", "bskd"):
                        case = decode_case(torch, gen, dev, b=b, kvh=kvh, g=g,
                                           dtype=dtype, layout=layout,
                                           paged=paged, valid=valid)
                        got = decode_call(kops, ref, case, layout)
                        want = decode_call(kops, ref, case, layout, plain=True)
                        torch.cuda.synchronize()
                        err, bad = compare(torch, got, want, rtol, atol)
                        run.max_err[fam] = max(run.max_err.get(fam, 0.0), err)
                        s = summary.setdefault(f"{fam}/{dtype}", {
                            "checks": 0, "failed": 0, "max_abs_err": 0.0,
                            "rtol": rtol, "atol": atol})
                        s["checks"] += 1
                        s["max_abs_err"] = max(s["max_abs_err"], err)
                        what = (f"{fam} {dtype} {layout} B={b} KV={kvh} G={g} "
                                f"(rtol {rtol}, atol {atol})")
                        if not run.check("decode_kernels", what, bad == 0,
                                         max_abs_err=err, mismatches=bad):
                            s["failed"] += 1
    # nothing past a lane's prefix is read: NaN there changes nothing
    for paged in (False, True):
        for dtype in ("float32", "int8"):
            case = decode_case(torch, gen, dev, b=8, kvh=4, g=8, dtype=dtype,
                               layout="bksd", paged=paged)
            clean = decode_call(kops, ref, case, "bksd")
            poison(torch, case)
            dirty = decode_call(kops, ref, case, "bksd")
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(dirty).all()) and torch.equal(clean, dirty)
            run.check("decode_kernels", f"nothing read past valid_len "
                      f"paged={paged} {dtype}", ok)
            summary.setdefault("nan_past_valid_len", []).append(
                {"paged": paged, "dtype": dtype, "ok": ok})
    for key, s in summary.items():
        emit({"phase": "decode_kernels", "check": key, "result": s})


def poison(torch, case):
    """NaN (or a wild scale) in every stored slot past each lane's prefix."""
    k, v, sc = case["k"], case["v"], case["scales"]
    nan_k = k.dtype != torch.int8
    targets = [k, v] if nan_k else list(sc)
    for i, n in enumerate(case["valid"].tolist()):
        if "pt" in case:
            ps = k.shape[2]
            row = case["pt"][i].tolist()
            shared = {int(p) for j, r in enumerate(case["pt"].tolist())
                      if j != i for p in r[:-(-case["valid"][j].item() // ps)]}
            for j, page in enumerate(row):
                if page == 0 or page in shared:
                    continue
                lo = max(n - j * ps, 0)
                if lo < ps:
                    for t in targets:
                        t[page, :, lo:] = float("nan")
        else:
            for t in targets:
                t[i, :, n:] = float("nan")


def numpy_weights(np, cfg, seed):
    """fp32 weights at the scales of common.init_params, from one numpy
    seed (norm weights start at zero, as there)."""
    from repro_torch.models import param_template
    from repro_torch.models.common import map_template
    rng = np.random.default_rng(seed)

    def leaf(p):
        if p.init == "zeros":
            return np.zeros(p.shape, np.float32)
        x = rng.standard_normal(p.shape, dtype=np.float32)
        x *= np.float32(p.std)
        return x
    return map_template(leaf, param_template(cfg))


def serve_requests(np, cfg, seed, n=None, max_new=None, lo=5, hi=300,
                   shared_prefix=64):
    """Greedy requests with prompts of lo..hi tokens; requests 0 and 1
    share their first ``shared_prefix`` tokens."""
    from repro_torch.runtime.scheduler import Request
    n = n or SERVE_REQUESTS
    max_new = max_new or SERVE_MAX_NEW
    rng = np.random.default_rng(seed)

    def tokens(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()
    prompts = [tokens(int(rng.integers(lo, hi + 1))) for _ in range(n)]
    if shared_prefix and n > 1:
        if len(prompts[0]) <= shared_prefix:
            prompts[0] += tokens(shared_prefix + 1 - len(prompts[0]))
        prompts[1] = prompts[0][:shared_prefix] + tokens(40)
    return [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def sync_window(torch):
    """A fault-injection hook that turns on torch's sync debug mode
    ("error": any host sync raises) for 8 ticks once every lane is live
    and none can retire within them, and records that it did."""
    from repro_torch.runtime.faults import FaultInjector

    class SyncWindow(FaultInjector):
        def __init__(self):
            self.start = None
            self.done = False
            self.syncs = None

        def on_step(self, tick, scheduler):
            if self.done:
                return
            live = [s for s, r in enumerate(scheduler.slots) if r is not None]
            if self.start is None:
                if len(live) == scheduler.max_slots and \
                        min(scheduler._steps_left[live]) >= 9:
                    self.start = tick
                    self.syncs = scheduler.host_syncs
                    torch.cuda.set_sync_debug_mode("error")
            elif tick == self.start + 8:
                torch.cuda.set_sync_debug_mode(0)
                self.done = scheduler.host_syncs == self.syncs
    return SyncWindow()


def phase_serve(run, torch, np, card):
    """TinyLlama-1.1B at full width through ServingEngine on the card, in
    five cache configurations, each on the default (cuda) backend and on
    ``ref``: tokens equal, 22 decode-kernel launches per decode step, one
    host sync per retired request, 8 ticks under sync debug mode "error",
    prefix hits and a clean page audit for the paged runs."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("tinyllama-1.1b")
    t0 = time.perf_counter()
    np_params = numpy_weights(np, cfg, SEED)
    t_make = time.perf_counter() - t0
    params = params_from_numpy(np_params, DEVICE, cfg=cfg)
    torch.cuda.synchronize()
    emit({"phase": "serve", "model": cfg.name, "params": cfg.param_count(),
          "weights_make_s": t_make,
          "weights_to_device_s": time.perf_counter() - t0 - t_make,
          **set_fp32_exact(torch)})
    L = cfg.num_layers
    engines, results = {}, {}
    kops.reset_launches()                            # the main path starts
    for name, opts in SERVE_CONFIGS.items():
        for backend in (None, "ref"):
            window = sync_window(torch) if backend is None else None
            eng = ServingEngine(cfg, params, max_batch=8,
                                cache_len=SERVE_CACHE_LEN, attn_backend=backend,
                                faults=window, device=DEVICE, **opts)
            reqs = serve_requests(np, cfg, SEED + 20)
            before = kops.launches()
            t1 = time.perf_counter()
            try:
                stats = eng.generate_batch(reqs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            after = kops.launches()
            sched = eng.scheduler()
            decode = {k: after[k] - before[k] for k in after
                      if k.startswith("decode_attention")}
            tag = f"{name}/{backend or 'cuda'}"
            results[tag] = [r.output for r in reqs]
            rec = {"phase": "serve", "config": tag, "wall_s": wall,
                   "decode_steps": sched.decode_steps,
                   "decode_launches": decode,
                   "host_syncs": sched.host_syncs,
                   "tokens": stats.tokens_out, "prefill_s": stats.prefill_s,
                   "decode_s": stats.decode_s,
                   "paged": sched.paged_stats() if sched._paged else None}
            fam = "decode_attention_paged" if "paged" in name \
                else "decode_attention"
            q8 = opts.get("kv_dtype") == "int8"
            want = {k: 0 for k in decode}
            if backend is None:
                want[DECODE_FAMILY[fam][int(q8)]] = L * sched.decode_steps
                engines[name] = eng
                rec["sync_window"] = {"start_tick": window.start,
                                      "ok": window.done}
                run.check("serve", f"{tag}: 8 ticks under sync debug mode "
                          "'error' with no retirement", window.done,
                          start=window.start)
            run.check("serve", f"{tag}: decode launches = {L} x decode steps",
                      decode == want, launches=decode, steps=sched.decode_steps)
            run.check("serve", f"{tag}: host_syncs == retired requests",
                      sched.host_syncs == len(reqs), host_syncs=sched.host_syncs)
            run.check("serve", f"{tag}: every request generated "
                      f"{SERVE_MAX_NEW} tokens", all(
                          len(r.output) == SERVE_MAX_NEW and r.done
                          and all(0 <= x < cfg.vocab_size for x in r.output)
                          for r in reqs))
            if sched._paged:
                run.check("serve", f"{tag}: prefix hits",
                          sched.prefix_hits >= 1, hits=sched.prefix_hits)
                try:
                    sched.audit_pages()
                    audit = True
                except AssertionError as e:
                    audit = repr(e)
                run.check("serve", f"{tag}: audit_pages", audit is True,
                          audit=audit)
            emit(rec)
        got, want = results[f"{name}/cuda"], results[f"{name}/ref"]
        match = sum(a == b for a, b in zip(got, want))
        rec = {"phase": "serve", "config": name,
               "tokens_equal_ref": got == want,
               "requests_equal": f"{match}/{len(want)}"}
        if opts.get("kv_dtype") == "bf16":
            # the ref casts q and p to bf16 and the kernel does not, so
            # greedy streams may part; each must part at a near-tie
            gaps = divergence_gaps(torch, cfg, params, reqs, got, want)
            rec["divergence_logit_gaps"] = gaps
            run.check("serve", f"{name}: cuda and ref part only at near-ties "
                      "(fp32 logit gap <= 2e-2)", all(g <= 2e-2 for g in gaps),
                      gaps=gaps)
        else:
            run.check("serve", f"{name}: greedy tokens on cuda equal ref",
                      got == want, requests_equal=match)
        emit(rec)
    counts = kops.launches()                         # read just after
    path = {"decode_attention": sum(counts[k] for k in
                                    DECODE_FAMILY["decode_attention"]),
            "decode_attention_paged": sum(counts[k] for k in
                                          DECODE_FAMILY["decode_attention_paged"])}
    emit({"phase": "serve", "main_path_launches": counts})
    run.phase("serve_teacher_forced", phase_teacher_forced, run, torch, np,
              cfg, params)
    return cfg, np_params, params, engines, path


def divergence_gaps(torch, cfg, params, reqs, got, want):
    """For each request whose two greedy streams part: the gap between
    the two chosen tokens' logits in an fp32 forward over the prompt and
    the shared prefix of the output."""
    from repro_torch.models import transformer as tf
    gaps = []
    with torch.inference_mode():
        for r, a, b in zip(reqs, got, want):
            if a == b:
                continue
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            toks = torch.tensor([r.prompt + a[:j]], device=DEVICE)
            lg = tf.forward(cfg, params, toks)[0, -1]
            gaps.append(float((lg[a[j]] - lg[b[j]]).abs()))
    return gaps


def _prefilled_cache(torch, tf, cfg, params, prompts, cache_len, kv_dtype):
    """A batch ring cache spliced from B=1 fp32 prefills; the last logits'
    argmax as each lane's next token."""
    cache = tf.init_cache(cfg, len(prompts), cache_len, torch.float32,
                          kv_dtype=kv_dtype, device=DEVICE)
    toks = []
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            lg, row = tf.prefill(cfg, params, torch.tensor([p], device=DEVICE),
                                 cache_len, cache_dtype=torch.float32)
            row = tf.cache_to_kv_dtype(cfg, row, kv_dtype)
            for key, c in cache.items():
                c[:, i] = row[key][:, 0]
            toks.append(int(lg[0, -1].argmax()))
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device=DEVICE)
    return cache, torch.tensor(toks, device=DEVICE)[:, None], pos


def phase_teacher_forced(run, torch, np, cfg, params):
    """8 steps of decode_step_batch on the cuda and ref backends from one
    prefilled cache, the same tokens fed to both: fp32 cache at rtol/atol
    1e-3; bf16 cache at 2e-2 (the ref casts q and p to bf16); a 128-slot
    ring whose streams pass the end, so prefill rolls and decode wraps."""
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(SEED + 30)
    cases = [("fp32", None, SERVE_CACHE_LEN, (5, 300), 1e-3),
             ("bf16", "bf16", SERVE_CACHE_LEN, (5, 300), 2e-2),
             ("wrap128-fp32", None, 128, (120, 200), 1e-3)]
    for name, kv_dtype, cache_len, (lo, hi), tol in cases:
        prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(lo, hi)))
                   .tolist() for _ in range(8)]
        cache, tok, pos = _prefilled_cache(torch, tf, cfg, params, prompts,
                                           cache_len, kv_dtype)
        caches = {"cuda": cache,
                  "ref": {k: c.clone() for k, c in cache.items()}}
        worst = 0.0
        bad_total = 0
        with torch.inference_mode():
            for step in range(8):
                lg = {}
                for backend, c in caches.items():
                    lg[backend], _ = tf.decode_step_batch(
                        cfg, params, tok, c, pos, attn_backend=backend)
                err, bad = compare(torch, lg["cuda"], lg["ref"], tol, tol)
                worst = max(worst, err)
                bad_total += bad
                tok = lg["ref"][:, -1].argmax(-1, keepdim=True).to(torch.int32)
                pos = pos + 1
        emit({"phase": "serve_teacher_forced", "case": name,
              "cache_len": cache_len, "steps": 8,
              "max_abs_logit_err": worst, "rtol": tol, "atol": tol})
        run.check("serve_teacher_forced", f"{name}: logits cuda vs ref "
                  f"(rtol {tol}, atol {tol})", bad_total == 0,
                  max_abs_err=worst, mismatches=bad_total)
    # the engine's aligned baseline through a 128-slot ring that wraps
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, max_batch=2, cache_len=128,
                        device=DEVICE)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size, 100)
                    .tolist(), max_new_tokens=48) for i in range(2)]
    eng.generate_aligned(reqs)
    run.check("serve_teacher_forced", "aligned baseline wraps a 128 ring",
              all(len(r.output) == 48 and all(0 <= x < cfg.vocab_size
                                              for x in r.output)
                  for r in reqs))


def phase_multimodel(run, torch, np, tiny_np, store_root):
    """TinyLlama-1.1B and Qwen3-0.6B at full width, published with
    publish_checkpoint (Qwen3 also as int8), served through
    MultiModelServer(max_resident=2) in the order A, B, A, B, then the
    int8 artifact: resident-cache hits, misses and the switch log."""
    from repro_torch.checkpoint.ckpt import load_published, publish_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.serving.engine import MultiModelServer
    store = ModelStore(store_root)
    qwen = get_config("qwen3-0.6b")
    tiny = get_config("tinyllama-1.1b")
    t0 = time.perf_counter()
    qwen_np = numpy_weights(np, qwen, SEED + 1)
    as_torch = lambda tree: {k: as_torch(v) if isinstance(v, dict)
                             else torch.from_numpy(v) for k, v in tree.items()}
    publish_checkpoint(store, tiny.name, tiny, tiny_np)
    publish_checkpoint(store, qwen.name, qwen, qwen_np)
    publish_checkpoint(store, qwen.name + "-int8", qwen, as_torch(qwen_np),
                       int8=True)
    t_pub = time.perf_counter() - t0
    cfg_i8, p_i8, rec = load_published(store, qwen.name + "-int8")
    gap = float((p_i8["embed"] - torch.from_numpy(qwen_np["embed"])).abs()
                .max())
    run.check("multimodel", "int8 artifact dequantizes within 1% of absmax",
              cfg_i8 == qwen and gap <= 0.01 * float(abs(qwen_np["embed"])
                                                     .max()), gap=gap)
    del qwen_np, p_i8
    server = MultiModelServer(store, max_resident=2, max_batch=8,
                              cache_len=512, device=DEVICE)
    order = [tiny.name, qwen.name, tiny.name, qwen.name, qwen.name + "-int8"]
    rounds, outs = [], {}
    for i, name in enumerate(order):
        cfg = qwen if "qwen" in name else tiny
        reqs = serve_requests(np, cfg, SEED + 40 + ("qwen" in name), n=8,
                              max_new=16, hi=100, shared_prefix=0)
        t1 = time.perf_counter()
        stats = server.serve(reqs, model=name)
        torch.cuda.synchronize()
        outs.setdefault(name, []).append([r.output for r in reqs])
        rounds.append({"round": i, "model": name,
                       "wall_s": time.perf_counter() - t1,
                       "switch_s": server.switch_log[-1][1],
                       "tokens": stats.tokens_out,
                       "decode_tok_per_s": stats.tok_per_s,
                       "resident": [list(k) for k in server.cache.resident]})
        run.check("multimodel", f"round {i} {name}: 8 x 16 tokens",
                  stats.tokens_out == 128 and all(
                      0 <= x < cfg.vocab_size for r in reqs for x in r.output))
    hits, misses = server.cache.hits, server.cache.misses
    emit({"phase": "multimodel", "publish_s": t_pub, "rounds": rounds,
          "hits": hits, "misses": misses,
          "switch_log": [n for n, _ in server.switch_log]})
    run.check("multimodel", "resident cache: 2 hits, 3 misses",
              (hits, misses) == (2, 3), hits=hits, misses=misses)
    run.check("multimodel", "switch log A, B, A, B, C",
              [n for n, _ in server.switch_log] == order)
    for name in (tiny.name, qwen.name):
        run.check("multimodel", f"{name}: warm round repeats the cold one",
                  outs[name][0] == outs[name][1])


def decode_bound(case, layout, h, d=64):
    """(seconds from bytes, seconds from operations) of one call: q, the
    K/V (and scales) of each lane's valid prefix, the table entries it
    reads, valid_len and the output; 4*H*D flops per valid slot at the
    fp32 peak."""
    valid = case["valid"].tolist()
    elem = case["k"].element_size()
    kvh = case["k"].shape[1] if layout == "bksd" else case["k"].shape[2]
    slots = sum(valid)
    nbytes = 2 * slots * kvh * d * elem + 2 * 4 * case["q"].numel() \
        + 4 * len(valid)
    if case["scales"] is not None:
        nbytes += 2 * 4 * slots * kvh
    if "pt" in case:
        ps = case["k"].shape[2] if layout == "bksd" else case["k"].shape[1]
        nbytes += 4 * sum(-(-n // ps) for n in valid)
    ops = 4 * h * d * slots
    return nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS


# device kernels by name -> the part of a decode step they belong to
STEP_GROUPS = (("decode_attn", "decode attention (B6/B7)"),
               ("gemm", "matmul (cuBLAS)"), ("Gemm", "matmul (cuBLAS)"),
               ("gemv", "matmul (cuBLAS)"), ("Memcpy", "copies"),
               ("Memset", "copies"))


def _profile_ticks(torch, sched, ticks):
    """Device time by part, launches and idle share over ``ticks`` decode
    ticks with every lane live (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            sched.tick()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    parts, kernels = {}, 0
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        kernels += 1
        part = next((p for key, p in STEP_GROUPS if key in e.name),
                    "other (norms, RoPE, cache writes, sampling)")
        parts[part] = parts.get(part, 0.0) + e.device_time / ticks
    busy = sum(parts.values())
    return {"ticks": ticks, "wall_ms_per_step": wall_us / ticks / 1e3,
            "device_ms_per_step": busy / 1e3 if parts else "not measured",
            "device_idle_share": 1 - busy * ticks / wall_us if parts
            else "not measured",
            "device_kernels_per_step": kernels / ticks,
            "device_ms_by_part": {k: v / 1e3 for k, v in parts.items()}}


def _time_decode_kernel(torch, cfg, sched, q8, paged):
    """B6 or B7 at the main path's shapes and data: the live scheduler's
    layer views and the lanes' valid lengths, cycling the layers as a
    step does (so the K/V come from device memory, not L2).  Returns
    per-launch ms of the kernel, its plain version and SDPA on the
    dequantized (and gathered) K/V with a boolean valid mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    cache, L = sched.state["cache"], cfg.num_layers
    b, h, d = sched.max_slots, cfg.num_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(SEED + 60)
    q = torch.randn(b, h, d, generator=gen).to(DEVICE)
    valid = torch.from_numpy(sched._host_valid.astype("int32") + 1).to(DEVICE)
    pre = "k_pages" if paged else "k"
    cases = []
    for l in range(L):
        case = {"q": q, "valid": valid,
                "k": cache[pre][l], "v": cache[pre.replace("k", "v", 1)][l],
                "scales": (cache["k_scale_pages" if paged else "k_scale"][l],
                           cache["v_scale_pages" if paged else "v_scale"][l])
                if q8 else None}
        if paged:
            case["pt"] = cache["page_table"]
        cases.append(case)
    lib_kv = []
    for case in cases:                              # dequantize + gather
        k, v = case["k"].float(), case["v"].float()
        if q8:
            k = k * case["scales"][0][..., None]
            v = v * case["scales"][1][..., None]
        if paged:
            k = ref.paged_gather(k, case["pt"], layout="bksd")
            v = ref.paged_gather(v, case["pt"], layout="bksd")
        lib_kv.append((k.contiguous(), v.contiguous()))
    s_len = lib_kv[0][0].shape[2]
    mask = (torch.arange(s_len, device=DEVICE)[None, :]
            < valid[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]

    def library(l):
        return F.scaled_dot_product_attention(q4, *lib_kv[l], attn_mask=mask,
                                              enable_gqa=True)[:, :, 0]
    got = decode_call(kops, ref, cases[0], "bksd")
    lib_err = float((library(0) - got).abs().max())
    ms = time_ms(torch, lambda: [decode_call(kops, ref, c, "bksd")
                                 for c in cases], iters=5) / L
    plain_ms = time_ms(torch, lambda: [decode_call(kops, ref, c, "bksd",
                                                   plain=True)
                                       for c in cases], iters=2, reps=3) / L
    lib_ms = time_ms(torch, lambda: [library(l) for l in range(L)],
                     iters=5) / L
    b_s, o_s = decode_bound(cases[0], "bksd", h, d)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bytes_s": b_s, "ops_s": o_s, "bound_ms": 1e3 * max(b_s, o_s),
            "bound_by": "bytes" if b_s >= o_s else "operations",
            "library_vs_kernel_max_abs": lib_err,
            "valid_len": valid.tolist(), "batch": b, "heads": h,
            "kv_heads": cfg.num_kv_heads, "head_dim": d}


def phase_serve_times(run, torch, np, cfg, params, card):
    """TinyLlama-1.1B, batch 8, ring fp32 and paged int8: decode tokens/s
    and TTFT from the scheduler's counters over 16 requests after a warm
    pass; device time per decode step by part and the device's idle
    share (torch.profiler over 8 ticks with 8 live lanes); B6 and B7 per
    launch at those lanes' shapes against the bytes bound, the plain
    version and SDPA."""
    from repro_torch.serving.engine import ServingEngine
    out = {}
    for name, q8, paged in (("ring-fp32", False, False),
                            ("paged-int8", True, True)):
        eng = ServingEngine(cfg, params, max_batch=8,
                            cache_len=SERVE_CACHE_LEN, device=DEVICE,
                            **SERVE_CONFIGS[name])
        eng.generate_batch(serve_requests(np, cfg, SEED + 50, n=8, hi=50))
        sched = eng.scheduler()
        sched.metrics.reset()
        stats = eng.generate_batch(serve_requests(np, cfg, SEED + 51))
        ttft = sched.metrics.histogram("req.ttft_s").snapshot()
        rec = {"phase": "serve_times", "card": card["nvidia_smi"],
               "config": name, "requests": SERVE_REQUESTS,
               "max_new": SERVE_MAX_NEW,
               "decode_tokens_per_s": stats.tok_per_s,
               "decode_s": stats.decode_s, "prefill_s": stats.prefill_s,
               "tokens": stats.tokens_out, "ttft_s": ttft,
               "roofline": {k: v for k, v in sched.roofline_stats().items()
                            if k in ("bytes_per_token", "mbu", "mfu",
                                     "roofline_tok_per_s")}}
        # a steady window: 8 lanes live, none retiring
        for r in serve_requests(np, cfg, SEED + 52, n=8):
            sched.submit(r)
        sched.tick()                                # admits all 8
        rec["step_profile"] = _profile_ticks(torch, sched, 8)
        rec["kernel"] = _time_decode_kernel(torch, cfg, sched, q8, paged)
        sched.run()
        run.check("serve_times", f"{name}: SDPA computes the kernel's "
                  "function (atol 1e-4)",
                  rec["kernel"]["library_vs_kernel_max_abs"] <= 1e-4,
                  err=rec["kernel"]["library_vs_kernel_max_abs"])
        emit(rec)
        out[name] = rec["kernel"]
    return out


def phase_b2_times(run, torch, graph, card):
    """B2 conv2d (im2col + B1) over NIN's 9 convs at batch 8, against
    F.conv2d (cuDNN, TF32 off) and the bound of each conv."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    set_fp32_exact(torch)
    gen = torch.Generator().manual_seed(SEED + 70)
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_s": 0.0,
         "ops_s": 0.0, "bound_s": 0.0, "convs": 0}
    s = graph.input_shape
    for layer, o in zip(graph.layers, graph.shapes()):
        a = layer.attrs
        if layer.kind == "conv":
            c, k = s[0], a["kernel"]
            x = torch.randn(TIMING_BATCH, *s, generator=gen).to(DEVICE).relu_()
            w = (torch.randn(a["out_channels"], c, k, k, generator=gen)
                 * math.sqrt(2 / (c * k * k))).to(DEVICE)
            bias = (0.1 * torch.randn(a["out_channels"], generator=gen)).to(DEVICE)
            kw = dict(stride=a["stride"], pad=a["pad"])
            got = kops.conv2d(x, w, bias, **kw)
            want = F.conv2d(x, w, bias, stride=a["stride"], padding=a["pad"])
            err = float((got - want).abs().max())
            run.check("b2_times", f"{layer.name} conv2d vs F.conv2d "
                      "(atol 1e-3)", err <= 1e-3, err=err)
            t["ms"] += time_ms(torch, lambda: kops.conv2d(x, w, bias, **kw))
            t["plain_ms"] += time_ms(torch, lambda: ref.conv2d_ref(x, w, bias,
                                                                   **kw))
            t["library_ms"] += time_ms(torch, lambda: F.conv2d(
                x, w, bias, stride=a["stride"], padding=a["pad"]))
            nbytes = 4 * (x.numel() + w.numel() + bias.numel()
                          + TIMING_BATCH * math.prod(o))
            ops = 2 * TIMING_BATCH * math.prod(o) * c * k * k
            b_s, o_s = nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS
            t["bytes_s"] += b_s
            t["ops_s"] += o_s
            t["bound_s"] += max(b_s, o_s)
            t["convs"] += 1
        s = o
    emit({"phase": "b2_times", "card": card["nvidia_smi"],
          "batch": TIMING_BATCH, **t, "bound_ms": 1e3 * t["bound_s"]})
    return t


def kernel_rows(totals, b2, dec, nin_launches, serve_launches, max_err):
    """The ``{"kernels": [...]}`` entries: slice 1's four kernels and B2
    timed over one NIN forward at batch 8; B6 and B7 per launch at the
    serving path's batch-8 shapes."""
    rows = []
    for name, (source, replaces) in SOURCES.items():
        t = (totals or {}).get(name, {})
        b_s, o_s = t.get("bytes_s", 0.0), t.get("ops_s", 0.0)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (nin_launches or {}).get(name, 0),
            "max_abs_err": max_err.get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": 1e3 * t["bound_s"] if t else None,
            "bound_by": "bytes" if b_s >= o_s else "operations",
            "library_ms": t.get("library_ms"),
            "ms_per": "one NIN forward at batch 8"})
    b2 = b2 or {}
    rows.append({
        "name": "conv2d", "route": "cuda",
        "source": "src/repro_torch/kernels/conv2d.py",
        "replaces": "src/repro/kernels/conv2d.py:59",
        "launches": (nin_launches or {}).get("conv2d", 0),
        "max_abs_err": max_err.get("matmul"),
        "ms": b2.get("ms"), "plain_ms": b2.get("plain_ms"),
        "bound_ms": 1e3 * b2["bound_s"] if b2 else None,
        "bound_by": "bytes" if b2.get("bytes_s", 0) >= b2.get("ops_s", 0)
        else "operations",
        "library_ms": b2.get("library_ms"),
        "ms_per": "NIN's 9 convs at batch 8 (im2col + the matmul kernel)"})
    for name, (source, replaces) in DECODE_SOURCES.items():
        t = (dec or {}).get("paged-int8" if "paged" in name else "ring-fp32",
                            {})
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (serve_launches or {}).get(name, 0),
            "max_abs_err": max_err.get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
            "ms_per": "one launch (one layer of a decode step), TinyLlama, "
                      "batch 8, " + ("paged int8" if "paged" in name
                                     else "ring fp32")})
    return rows


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import cnn

    run = Run()
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = run.phase(name, fn, *args)
        seconds[name] = time.perf_counter() - t0
        emit({"phase": name, "seconds": seconds[name]})
        return out

    card = timed("device", phase_device, torch)
    if card is None:
        return 1
    graphs = {n: cnn.graph_for(get_config(n)) for n in PER_FORWARD}
    timed("build", phase_build)
    # slice 1: NIN / LeNet through ModelStore -> InferenceEngine
    timed("kernels", phase_kernels, run, torch, graphs)
    (ROOT / "build").mkdir(exist_ok=True)
    totals = b2 = None
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store_root:
        engine, nin_launches = timed(
            "nin", phase_model, run, torch, np, "nin-cifar10",
            graphs["nin-cifar10"], pathlib.Path(store_root)) or (None, None)
        timed("lenet", phase_model, run, torch, np, "lenet-mnist",
              graphs["lenet-mnist"], pathlib.Path(store_root))
        if engine is not None:
            totals = timed("times", phase_times, run, torch, np,
                           graphs["nin-cifar10"], engine, card)
            timed("profile", phase_profile, torch, np, engine, card)
        b2 = timed("b2_times", phase_b2_times, run, torch,
                   graphs["nin-cifar10"], card)
    del engine
    # slice 2: TinyLlama / Qwen3 through ServingEngine and MultiModelServer
    timed("decode_kernels", phase_decode_kernels, run, torch)
    served = timed("serve", phase_serve, run, torch, np, card)
    serve_launches = dec = None
    if served is not None:
        cfg, tiny_np, params, engines, serve_launches = served
        del engines
        dec = timed("serve_times", phase_serve_times, run, torch, np, cfg,
                    params, card)
        del params
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as store_root:
            timed("multimodel", phase_multimodel, run, torch, np, tiny_np,
                  pathlib.Path(store_root))
    kernels = kernel_rows(totals, b2, dec, nin_launches, serve_launches,
                          run.max_err)
    for k in kernels:
        run.check("summary", f"{k['name']} launched on the main path",
                  k["launches"] > 0)
    emit({"phase": "summary", "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds, "failures": len(run.failures)})
    if run.failures:
        for f in run.failures[:40]:
            emit({"failure": f})
        return 1
    print(card["nvidia_smi"])
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
