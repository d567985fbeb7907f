#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold every kernel of it
against its plain PyTorch version.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, one JSON line each (``"phase": ...``):

  device   the card's name and power limit (nvidia-smi), torch and CUDA
  build    nvcc builds src/repro_torch/kernels/csrc into build/kernels
  kernels  each kernel against its plain version at the main path's shapes
           (batch 8) and at ragged shapes, tolerance stated per check
  nin      NIN-CIFAR10 at full width: numpy-seeded weights -> Caffe JSON ->
           ModelStore (fp32 and int8) -> InferenceEngine on the ``cuda``
           backend at batch 1, 8, 64; launch counts per forward; every
           layer against the ``ref`` backend on the card
  lenet    LeNet-MNIST, the same steps
  times    each kernel, its plain version and one PyTorch call for the same
           function, at NIN's batch-8 shapes (CUDA events, medians); NIN
           latency at batch 1 and images/s at batch 64
  profile  device time by part of the forward and the device's idle share
           over NIN requests at batch 1 and 8 (torch.profiler)

Then the card's name and power limit, the ``{"kernels": [...]}`` line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check or
phase makes the run exit 1 without that line; so does a machine without
CUDA, or a directory without the repo.
"""
from __future__ import annotations

import json
import math
import pathlib
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
    "nin-cifar10": {"matmul": 9, "elementwise": 9, "pool2d": 3, "softmax": 1},
    "lenet-mnist": {"matmul": 4, "elementwise": 1, "pool2d": 2, "softmax": 1},
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
                      delta == {k: 2 * v for k, v in per_fwd.items()},
                      launches=delta)
            outputs.append((model, batch, x, y, y2))
    counts = kops.launches()                          # read just after
    report["launches"] = counts
    n = report["forwards"]
    run.check(name, "launches over the run",
              counts == {k: n * v for k, v in per_fwd.items()},
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
    card = run.phase("device", phase_device, torch)
    if card is None:
        return 1
    graphs = {n: cnn.graph_for(get_config(n)) for n in PER_FORWARD}
    run.phase("build", phase_build)
    run.phase("kernels", phase_kernels, run, torch, graphs)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store_root:
        engine, nin_launches = run.phase(
            "nin", phase_model, run, torch, np, "nin-cifar10",
            graphs["nin-cifar10"], pathlib.Path(store_root)) or (None, None)
        run.phase("lenet", phase_model, run, torch, np, "lenet-mnist",
                  graphs["lenet-mnist"], pathlib.Path(store_root))
        totals = None
        if engine is not None:
            totals = run.phase("times", phase_times, run, torch, np,
                               graphs["nin-cifar10"], engine, card)
            run.phase("profile", phase_profile, torch, np, engine, card)
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = (totals or {}).get(name, {})
        b_s, o_s = t.get("bytes_s", 0.0), t.get("ops_s", 0.0)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (nin_launches or {}).get(name, 0),
            "max_abs_err": run.max_err.get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": 1e3 * t["bound_s"] if t else None,
            "bound_by": "bytes" if b_s >= o_s else "operations",
            "library_ms": t.get("library_ms"),
            "launches_per_nin_forward": t.get("launches_per_forward")})
    for k in kernels:
        run.check("summary", f"{k['name']} launched on the main path",
                  k["launches"] > 0)
    emit({"phase": "summary", "seconds": time.perf_counter() - t_start,
          "failures": len(run.failures)})
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
