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
                  shapes (batch 8) and at ragged shapes, tolerance per check;
                  B1 at M 1, 8, 16 of LeNet's K and N, a ragged K and a
                  transposed B, two runs bit-equal; B3 bit-equal at every
                  shape (global pools of 13 x 13, 64 x 64 and 31 of 33 x 31
                  too), NaN in a max window; B4 at n % 4 != 0 on an
                  aligned base, in place, and its input untouched out of
                  place
  nin, lenet      NIN-CIFAR10 / LeNet-MNIST at full width: numpy-seeded
                  weights -> Caffe JSON -> ModelStore (fp32 and int8) ->
                  InferenceEngine on the ``cuda`` backend at batch 1, 8, 64;
                  launch counts per forward; every layer against ``ref``
  times, profile  each kernel, its plain version and one PyTorch call at
                  NIN's batch-8 shapes (B1 at LeNet's dense layers: its
                  route, events and device µs beside addmm's; B3 and B4
                  device µs per launch beside the library call's, B4 also
                  in place beside torch.relu_); NIN
                  latency at batch 1 and 8 and images/s at 64; device
                  time by part and idle share (torch.profiler)
  b2_times        B2, the implicit-GEMM conv kernel, at each of NIN's 9
                  convs at batch 8: against its plain version and
                  F.conv2d (TF32 off), two runs bit-equal; CTAs and depth
                  splits, events, device µs, bound, plain version and
                  F.conv2d per conv; split convs also unsplit and split
                  for one CTA per SM
  fft_conv        NIN at batch 8 with every conv on the ``fft`` route
                  (core/fftconv.py, torch.fft) and B3-B5 for the rest
                  against ``ref`` (rtol 1e-3, atol 1e-4), no B2 launch;
                  forward ms on the fft route, the kernels and ``ref``;
                  fft_conv2d against B2 at each of NIN's 9 convs
  launch_path     host µs per launch (10,000 calls, no synchronise) of
                  every wrapper at NIN's batch-1 and a decode step's
                  shapes, beside one PyTorch call each; B3's, B4's and
                  B5's wrappers step by step (checks, plan lookup, output,
                  stream, pointers, ctypes call, the whole wrapper, the
                  library call)
  slice 2, transformer serving:
  decode_kernels  B6 and B7 against their plain versions: TinyLlama,
                  Qwen3, Granite-MoE and RecurrentGemma (16/1 heads of
                  256) heads, B 1 and 8, S 1024, fp32/bf16/int8, both
                  layouts, fragmented page tables; Whisper's 'bskd'
                  shapes (16/16 heads of 64: a 448-slot ring and pages,
                  the 1500-frame cross cache); nothing read past
                  valid_len (both layouts); the split-KV kernel's chunk edges, the
                  capacity and past it (reruns bit-equal), a lane alone
                  bit-equal to the lane in a batch of 8, NaN for
                  valid_len 0 and for a page id outside the pool, at
                  TinyLlama's heads and on the wide route (G 16); the wide
                  route's max and rms error against fp64 within bounds
                  that the FFMA route's error set
  serve           TinyLlama-1.1B at full width through ServingEngine in five
                  cache forms, on the kernels and on ``ref``: tokens, launches
                  (B6/B7 22 x decode steps, B8 22 x full prefills), one host
                  sync per request, 8 ticks
                  under sync debug mode "error", prefix hits, page audit;
                  the fp32 logit gap wherever a bf16 or int8 stream parts
                  from ``ref``; teacher-forced logits and a ring that wraps
  serve_times     decode tokens/s and TTFT (scheduler counters), device time
                  per step and idle share, B6/B7 per launch (events ms,
                  device µs) at the live lanes and at 8 x 1000 of 1024
                  slots against bound, plain version and SDPA, with their
                  max and rms error against an fp64 evaluation
  graphs          the twin of jax.jit, CUDA graphs against the same code
                  eagerly (disable_graphs()): NIN and LeNet through
                  InferenceEngine at batch 1, 8, 64 (a capture and two
                  replays torch.equal eager, equal launches, three
                  commands in flight, an evict and reload over NaN-filled
                  memory; NIN latency and images/s eager, graph, graph,
                  eager); TinyLlama-1.1B's captured decode step in ring
                  fp32 and paged int8 (serve's 16 requests: tokens equal
                  eager and ``ref``, decode_steps, host_syncs and launches
                  equal eager; sampled tokens equal; tokens/s, TTFT, device
                  ms a step, idle share and host launch calls over 8
                  ticks); both forms again with power-of-two prefill
                  buckets (4-128, 8 requests of prompts 5-128, 24 new
                  tokens): admission
                  captured once a bucket and
                  replayed for every cold admission, the prefix hit's
                  suffix steps and closing sample captured, tokens,
                  counters and launches equal eager, TTFT and prefill
                  seconds graph against eager, peak device memory;
                  B6/B7's ticket counters 0 after the replays
  multimodel      TinyLlama-1.1B and Qwen3-0.6B (and its int8 artifact),
                  full width, cut to 8 layers, through MultiModelServer:
                  hits, misses, switch log
  slice 3, training, then publish and serve:
  flash_kernels   B8 and B9 (forward, dq, dk/dv) against their plain
                  versions: TinyLlama and Qwen3 heads (head_dim 64, 128)
                  and their reduced configs' (head_dim 32), B 1 and 4, S 1
                  to 2048, window 0 and 256, fp32 and bf16; head_dim 256
                  (RecurrentGemma, window 2048), Whisper's 1500 x 1500
                  encoder and Sq != Sk (Whisper's
                  300 x 1500 cross attention, causal and not; rows no key
                  can see); every kernel runs each case twice, bit-equal;
                  causality; B8 and B9's forward against fp64 at the train
                  shape and at RecurrentGemma's 1 x 2100 prefill
  cli             ``launch.serve --model tinyllama-1.1b`` on an empty store
                  (bootstraps a reduced model; B8 prefill, B6 decode; tokens
                  equal ``ref``) and ``launch.train`` with its defaults
                  (reduced TinyLlama, 2 steps on B9; losses equal ``ref``)
  train           TinyLlama-1.1B at full width and depth, fp32, batch 4 x
                  2048, 4 AdamW steps through launch.train on the kernels
                  and on ``ref`` from one numpy tree: losses, step-1 grads,
                  launches (forward 2 x 22 x steps under remat, dq and
                  dk/dv 22 x steps); then Qwen3-0.6B, 2 steps at 4 x 1024
  train_publish_serve  the trained TinyLlama from the model store through
                  ServingEngine: tokens equal ``ref``, B8 22 x prefills
  train_times     train tokens/s, device time per step by part and idle
                  share; B8/B9 per launch at the train shapes (events ms,
                  device µs) against the bound (3xTF32 at the TF32 peak,
                  the FFMA bound beside it), the plain versions and the
                  library (SDPA forward; the efficient-attention backward
                  for dq and dk/dv); B8 at the serving prefill (1 x 300)
                  beside SDPA there
  slice 4, RWKV-6 serving and the meta-selector:
  wkv_kernels     B10 against its plain version evaluated in fp64: B 1, 4,
                  8, T 1 to 2048, heads 40 x 64 and 8 x 32, decays in
                  (0, 1) and w = 0; nothing written past T; the kernel's
                  and the fp32 plain version's max and rms error beside
                  each other; every column block, a rerun, a lone lane
                  and unaligned inputs bit-equal at T 15 to 33 and 300;
                  bf16 r, k, v beside an fp32 decay (a bf16 RWKV-6's) at
                  1 x 300 and 8 x 2048 (40 x 64), out at the bf16 bar, the
                  state at the fp32 one, a rerun bit-equal
  wkv_times       B10 per launch at 1 x 300 and 8 x 2048 (40 x 64), fp32
                  and bf16 r, k, v with an fp32 w: events, device µs of
                  both passes and of each, CTAs, against its bound and
                  its plain version (no library call)
  serve_rwkv6     RWKV-6 Finch 3B at full width through ServingEngine,
                  batch 8, on the kernels and on ``ref``: tokens, B10 32 x
                  full prefills, 8 ticks under sync debug mode "error",
                  paged and int8 asked for (ring kept, state unchanged),
                  each layer's prefill output and state within 1e-4 on
                  the same input (end to end reported beside the model's
                  sensitivity to a 1e-7 input change); the captured
                  decode step against the same requests under
                  disable_graphs() (captured and not, tokens, decode_steps,
                  host_syncs and launches equal; sampled tokens equal),
                  and a bucketed run of prompts 5-64 graph against eager
                  (as the graphs phase's); decode tokens/s, TTFT, a
                  replayed step (device ms, idle
                  share, host launch calls <= 3), an eager step's device
                  time by part, and one 300-token prefill's device ms with
                  B10's part; then the model in bf16 (6.2 GB): a 300-token
                  prompt's every layer (B10 on bf16 r, k, v and the fp32
                  decay) against ``ref`` on the same input (output at the
                  bf16 bar, state within 1e-4), B10 32 x a full prefill;
                  the end-to-end logits and state no farther from
                  ``ref`` than ``ref`` moves under a one-bf16-step change
                  of its embeddings; 8 greedy tokens reported
  selector        TinyLlama-1.1B, Qwen3-0.6B and RWKV-6 3B (int8 artifact),
                  full width, cut to 8 layers, behind
                  MultiModelServer(max_resident=3) and the
                  meta-selector fitted on the card: 6 rounds, every pick
                  its label, B10 in the RWKV rounds; switch_s per round;
                  every model's step captured, the rounds again under
                  disable_graphs() with the same picks and tokens
  slice 5, Granite-MoE serving and B11:
  serve_moe       Granite-MoE 3B-A800M at full width, depth cut to 16 of
                  its 32 layers (d 1536, 24/8 heads of 64, 40 experts
                  top-8, 6.8 GB fp32) through ServingEngine, batch 8, on
                  the kernels and on ``ref`` in ring fp32 and paged int8:
                  tokens (streams part only at near-ties), B8 16 x full
                  prefills and B6/B7 16 x decode steps, 8 ticks under sync
                  debug mode "error"; the captured decode step (and the
                  prefix hits' captured suffix step) against the same
                  requests under disable_graphs() per cache form (as
                  serve_rwkv6); each
                  layer's prefill output on the same input within 1e-4,
                  router flips counted; decode tokens/s, TTFT, a replayed
                  step (host launch calls <= 3) and an eager step's
                  device time by part beside the weight bytes; then
                  its int8 artifact (3.3 GB) published and served through
                  MultiModelServer on both backends
  int8_kernels    B11 bit-equal to its plain version: the JAX suite's
                  shapes, all-127 int32 sums, ragged shapes, and the
                  artifact's QTensors (layer 0's wq, expert 0's we_gate and
                  we_down) against per-row int8 hidden states at M 8, 300,
                  2048, launches counted; byte-load routes (K, N off 16,
                  bases off 16 bytes), M 8 split over K and not, all-127
                  at K 133,144, reruns, the split workspace left at 0; per
                  launch at four of those shapes against the bound, the
                  plain version and torch._int_mm
  slice 12, RecurrentGemma-9B serving:
  serve_hybrid    RecurrentGemma-9B at full width and depth (38 layers: 26
                  RG-LRU blocks, 12 local-attention layers of 16/1 heads
                  of 256, window 2048; 41.8 GB fp32) through
                  ServingEngine, batch 8, cache 2048, on the kernels and
                  on ``ref`` in ring fp32 and paged int8: serve_requests'
                  16 requests and one of 2100 tokens (prefill past the
                  window, a wrapped ring); tokens (streams part only at
                  near-ties), B8 12 x full prefills and B6/B7 12 x
                  decode steps, 8 ticks under sync debug mode "error";
                  three prompts layer by layer on the same input (local
                  attention cuda vs ref, recurrent blocks vs fp64, the
                  rolled K/V window) within 1e-4; the doubling scan at T
                  2100 x 4096 against an fp64 recurrence; the captured
                  decode step against the same requests under
                  disable_graphs() per cache form (as serve_rwkv6), a
                  bucketed paged int8 run of prompts 5-64 (as the graphs
                  phase's), the wide route's workspaces at 0 after the
                  replays; decode
                  tokens/s, TTFT, per cache form a replayed step and an
                  eager step by part, B6/B7 at the live lanes and B8 at
                  1 x 300 and 1 x 2100, beside SDPA; peak device memory
  slice 13, Whisper-medium serving:
  serve_audio     Whisper-medium at full width and depth (24 encoder + 24
                  decoder layers, d 1024, 16/16 heads of 64, 1500 frames;
                  3.03 GB fp32) through ServingEngine, batch 8, cache 448,
                  on the kernels and on ``ref`` in ring fp32 and paged
                  int8: serve_requests' 16 requests, 48 new tokens;
                  tokens (streams part only at near-ties), B8 72 x full
                  prefills, B6 (cross) 24 x decode steps and B6/B7 (self,
                  'bskd') 24 x decode steps, nothing else; 8 ticks under
                  sync debug mode "error"; a 300-token prompt with random
                  frames layer by layer (every encoder layer, each decoder
                  layer's self- and cross-attention and the whole layer)
                  within 1e-4 of ``ref``; the captured decode step
                  against the same requests under disable_graphs() per
                  cache form (as serve_rwkv6), a bucketed paged int8 run
                  of prompts 5-64 (as the graphs phase's), B6/B7's ticket
                  counters 0 after the replays; decode tokens/s, TTFT, per
                  cache
                  form a replayed step and an eager step by part, B6/B7
                  at the live lanes, B6 at 8 x 1500 'bskd' (cross), B8 at
                  1 x 1500 (encoder), 1 x 300 x 1500 (cross) and 1 x 300,
                  beside SDPA
  slice 21, the examples:
  examples        examples/quickstart_torch.py, compress_models_torch.py,
                  train_publish_serve_torch.py and serve_batched_torch.py,
                  each one's function in this process on the card at its
                  defaults: quickstart's class ids equal ``ref``'s, the
                  compression report finite, train_publish_serve's loss
                  drop > 0.3 in 150 steps and its served tokens, every
                  serve_batched pick its location's model; their printed
                  lines and launches recorded
  slice 14, the launch tooling on a one-rank NCCL mesh:
  mesh            TinyLlama-1.1B at full width cut to 2 layers, batch 4 x
                  2048: one step of ``launch.dryrun.build_step`` on
                  DTensor parameters and AdamW state (rules_for("train"),
                  attention on the local shards through B9) against the
                  eager ``make_train_step``: loss (rtol 1e-4), step-1
                  grads (1e-3 relative norm per leaf), B9 launches equal
                  to the eager step's, bit-equality reported; Granite-MoE
                  at full width cut to 2 layers, 4 x 512 tokens, one
                  forward per moe_impl (dense, a2a, local) against the
                  eager forward (max |d| <= 1e-5, B8 launches equal); the
                  full-size ``python -m repro_torch.launch.dryrun --arch
                  granite-moe-3b-a800m --shape prefill_32k --optimized``
                  on the (32, 8) fake mesh: exit 0, every roofline term
                  on the h100-sxm row > 0
  (cli also runs ``launch.serve`` and ``launch.train`` with ``--model`` /
  ``--arch`` rwkv6-3b, granite-moe-3b-a800m, recurrentgemma-9b and
  whisper-medium against ``ref``, and ``launch.serve`` with llama3-8b, qwen3-8b and
  chameleon-34b)

Then the card's name and power limit, the ``{"kernels": [...]}`` line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check or
phase makes the run exit 1 without that line; so does a machine without
CUDA, or a directory without the repo.
"""
from __future__ import annotations

import bisect
import functools
import gc
import io
import itertools
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
from contextlib import nullcontext, redirect_stdout

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
BATCHES = (1, 8, 64)
TIMING_BATCH = 8
# H100 SXM, NVIDIA's data sheet (dense, no sparsity): fp32 outside the
# tensor cores, TF32 on them, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_HBM_BYTES = 3.35e12
SOURCES = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:87"),
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:52"),
    "pool2d": ("src/repro_torch/kernels/csrc/pool.cu",
               "src/repro/kernels/pool.py:71"),
    "elementwise": ("src/repro_torch/kernels/csrc/elementwise.cu",
                    "src/repro/kernels/elementwise.py:40"),
    "softmax": ("src/repro_torch/kernels/csrc/softmax.cu",
                "src/repro/kernels/softmax.py:34"),
}
# launches of each kernel per forward: 9 conv + 9 relu + 3 pool + softmax
# for NIN; 2 conv, 2 dense (matmul), 1 relu, 2 pool, softmax for LeNet
PER_FORWARD = {
    "nin-cifar10": {"conv2d": 9, "elementwise": 9, "pool2d": 3,
                    "softmax": 1},
    "lenet-mnist": {"matmul": 2, "conv2d": 2, "elementwise": 1, "pool2d": 2,
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
            calls.append(("conv2d", dict(shape=(batch, *s),
                                         out_channels=a["out_channels"],
                                         kernel=a["kernel"],
                                         stride=a["stride"], pad=a["pad"])))
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
    if kernel == "conv2d":
        c, k = d["shape"][1], d["kernel"]
        w = randn(d["out_channels"], c, k, k) * math.sqrt(2 / (c * k * k))
        return (randn(*d["shape"]).relu_(), w,
                randn(d["out_channels"]) * 0.1), dict(
            stride=d["stride"], pad=d["pad"], activation=act)
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
    elif kernel == "conv2d":
        b, c, h, w = d["shape"]
        o, k = d["out_channels"], d["kernel"]
        oh = (h + 2 * d["pad"] - k) // d["stride"] + 1
        ow = (w + 2 * d["pad"] - k) // d["stride"] + 1
        nbytes = 4 * (b * c * h * w + o * c * k * k + o + b * o * oh * ow)
        ops = 2 * b * o * oh * ow * c * k * k
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
            "conv2d": (kops.conv2d, ref.conv2d_im2col_ref),
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
    from repro_torch.kernels import ops as kops
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    wrappers = kernel_and_plain()
    # tolerances: matmul sums K products in another order than cuBLAS
    # (fp32, no TF32); pooling repeats the plain version's order exactly;
    # activations differ by an ulp of expf/tanhf near cancellation
    # conv2d: the implicit GEMM sums its depth in another order than the
    # plain im2col product (rtol 1e-3 / atol 1e-4, the CNN's layer bar)
    tol = {"matmul": (1e-4, 1e-4), "conv2d": (1e-3, 1e-4),
           "pool2d/max": (0.0, 0.0),
           "pool2d/avg": (1e-6, 0.0), "elementwise": (1e-6, 1e-6),
           "softmax": (1e-5, 1e-8)}
    cases = []
    for g in graphs.values():
        cases += path_calls(g, TIMING_BATCH)
        cases += [c for b in BATCHES for c in path_calls(g, b)
                  if c[0] == "pool2d"]      # B3 at every batch served
    uniq = []
    for c in cases:
        if c not in uniq:
            uniq.append(c)
    cases = uniq + [("matmul", dict(m=37, k=75, n=19, weight_t=False)),
                    ("matmul", dict(m=129, k=2401, n=65, weight_t=True)),
                    ("conv2d", dict(shape=(3, 8, 11, 11), out_channels=16,
                                    kernel=3, stride=2, pad=0)),
                    ("conv2d", dict(shape=(2, 5, 7, 7), out_channels=70,
                                    kernel=1, stride=1, pad=0)),
                    ("elementwise", dict(shape=(3, 7, 61))),
                    ("elementwise", dict(shape=(7, 61))),
                    ("pool2d", dict(shape=(2, 3, 9, 10), mode="max",
                                    kernel=3, stride=2, pad=1)),
                    ("pool2d", dict(shape=(2, 3, 9, 10), mode="avg",
                                    kernel=3, stride=2, pad=1)),
                    ("pool2d", dict(shape=(2, 3, 9, 10), mode="max",
                                    kernel=3, stride=2, pad=1, nan=True)),
                    ("pool2d", dict(shape=(8, 10, 8, 8), mode="max",
                                    kernel=8, stride=1, pad=0, nan=True))]
    # B3's plane route beyond NIN's 8 x 8: whole 13 x 13 and 64 x 64
    # planes, and a 31 x 31 window on 33 x 31 planes
    cases += [("pool2d", dict(shape=shape, mode=mode, kernel=k, stride=s,
                              pad=0))
              for shape, k, s in (((2, 3, 13, 13), 13, 1),
                                  ((1, 1, 64, 64), 64, 1),
                                  ((2, 3, 33, 31), 31, 31))
              for mode in ("max", "avg")]
    cases += [("softmax", dict(shape=(64, 1000))),
              ("softmax", dict(shape=(5, 37), extreme=True))]
    # B1's split-K route: M 1 and 16 at LeNet's K and N (M 8 is the
    # path's), a ragged K and a transposed B
    cases += [("matmul", dict(m=m, k=k, n=n, weight_t=False))
              for m in (1, 16) for k, n in ((800, 500), (500, 10))]
    cases += [("matmul", dict(m=8, k=803, n=500, weight_t=False)),
              ("matmul", dict(m=8, k=800, n=500, weight_t=True))]
    summary = {}
    for kernel, d in cases:
        acts = {"matmul": ["none", "relu", "silu", "gelu"],
                "conv2d": ["none", "relu", "gelu"],
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
            if d.get("nan"):          # NaN wins a max window, as in lax.max
                args[0][0, 0, 1, 1] = args[0][-1, -1, -1, -1] = math.nan
            fn, plain = wrappers[kernel]
            before = args[0].clone() if kernel == "elementwise" else None
            got = fn(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            if kernel == "matmul":     # both routes sum in a fixed order
                run.check("kernels", f"matmul {d} act={act}: two runs "
                          "bit-equal", torch.equal(got, fn(*args, **kw)))
            if kernel == "pool2d":     # both routes keep the plain order
                run.check("kernels", f"pool2d {d}: bit-equal to the plain "
                          "version", torch.equal(got.isnan(), want.isnan())
                          and torch.equal(got.nan_to_num(0.0),
                                          want.nan_to_num(0.0)))
            if kernel == "elementwise":
                run.check("kernels", f"elementwise {d} act={act}: input "
                          "untouched", torch.equal(args[0], before))
            if kernel == "elementwise" and act == "relu":
                y = args[0].clone()
                ptr = y.data_ptr()
                same = kops.relu_(y)
                torch.cuda.synchronize()
                run.check("kernels", f"relu_ {d}: in place, equal to "
                          "relu", same is y and y.data_ptr() == ptr
                          and torch.equal(y, got))
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


def library_calls(torch):
    """kernel name -> one PyTorch call computing the same function, with
    the wrapper's arguments (the yardstick; the port never calls it)."""
    import torch.nn.functional as F
    return {
        "matmul": lambda a, b, bias, activation: torch.addmm(bias, a, b),
        "conv2d": lambda x, w, b, stride, pad, activation: F.conv2d(
            x, w, b, stride=stride, padding=pad),
        "pool2d": lambda x, mode, kernel, stride, pad:
            F.max_pool2d(x, kernel, stride, pad) if mode == "max" else
            F.avg_pool2d(x, kernel, stride, pad, count_include_pad=False),
        "elementwise": lambda x, act: F.relu(x),
        "softmax": lambda x: torch.softmax(x, -1),
    }


# the kernels whose per-launch device µs the times phase records
DEVICE_TIMED = ("pool2d", "elementwise")


def call_times(torch, kernel, d, gen):
    """One launch of ``kernel`` at the path call ``d``: events ms of the
    wrapper, its plain version and the library call, and the bound; for
    B3 and B4 also device µs (torch.profiler) of the wrapper and of the
    library call, and for B4 the in-place ReLU (``kops.relu_``, where the
    tree has it) beside ``torch.relu_``."""
    from repro_torch.kernels import ops as kops
    act = "relu" if kernel == "elementwise" else "none"
    args, kw = make_inputs(torch, kernel, d, gen, "cuda", act)
    fn, plain = kernel_and_plain()[kernel]
    lib = library_calls(torch)[kernel]
    b_s, o_s = bound(kernel, d)
    row = {"ms": time_ms(torch, lambda: fn(*args, **kw)),
           "plain_ms": time_ms(torch, lambda: plain(*args, **kw)),
           "library_ms": time_ms(torch, lambda: lib(*args, **kw)),
           "bytes_s": b_s, "ops_s": o_s, "bound_ms": 1e3 * max(b_s, o_s),
           "bound_by": "bytes" if b_s >= o_s else "operations"}
    if kernel in DEVICE_TIMED:
        row["device_us"] = device_us(torch, lambda: fn(*args, **kw))[0]
        row["library_device_us"] = device_us(
            torch, lambda: lib(*args, **kw))[0]
    if kernel == "elementwise" and hasattr(kops, "relu_"):
        x = args[0]
        row["inplace_ms"] = time_ms(torch, lambda: kops.relu_(x))
        row["library_inplace_ms"] = time_ms(torch, lambda: torch.relu_(x))
        row["inplace_device_us"] = device_us(torch, lambda: kops.relu_(x))[0]
        row["library_inplace_device_us"] = device_us(
            torch, lambda: torch.relu_(x))[0]
    return row


def phase_times(run, torch, np, graph, lenet_graph, engine, card):
    """Per-kernel times over one NIN forward at batch 8 (B1, which NIN no
    longer runs, over LeNet's two dense layers at batch 8): the sum over
    its launches of each launch's median time.  Inputs stay in L2
    (< 50 MB), as the previous layer's output does on the main path."""
    from repro_torch.kernels import matmul as mm
    set_fp32_exact(torch)
    gen = torch.Generator().manual_seed(SEED + 2)
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bytes_s": 0.0, "ops_s": 0.0, "bound_s": 0.0,
                  "launches_per_forward": 0}
              for k in SOURCES}
    per_call = []
    for kernel, d in path_calls(graph, TIMING_BATCH):
        row = call_times(torch, kernel, d, gen)
        t = totals[kernel]
        for key, v in row.items():           # summed over the launches
            if key not in ("bound_ms", "bound_by"):
                old = t.get(key, 0.0)
                t[key] = None if v is None or old is None else old + v
        t["bound_s"] += max(row["bytes_s"], row["ops_s"])
        t["launches_per_forward"] += 1
        per_call.append({"kernel": kernel,
                         **{("window" if k == "kernel" else k): v
                            for k, v in d.items() if k != "weight_t"},
                         "model": "nin-cifar10",
                         **{k: v for k, v in row.items()
                            if k not in ("bytes_s", "ops_s")}})
    t = totals["matmul"]
    t["device_us"] = t["library_device_us"] = 0.0
    t["layers"] = dense_layer_times(torch, lenet_graph, gen)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for row in t["layers"]:
        m, n, k = row["m"], row["n"], row["k"]
        splits = mm.plan(m, n, k, sms)
        row["route"] = f"split-K, {splits} slices" if splits else "tiled"
        row["ctas"] = (-(-n // mm.SPLIT_COLS) * splits if splits
                       else -(-m // 64) * -(-n // 64))
        for key in ("ms", "plain_ms", "library_ms", "bytes_s", "ops_s"):
            t[key] += row[key]
        for key in ("device_us", "library_device_us"):
            t[key] = None if t[key] is None or row[key] is None \
                else t[key] + row[key]
        t["bound_s"] += max(row["bytes_s"], row["ops_s"])
        t["launches_per_forward"] += 1
        per_call.append({"kernel": "matmul", "model": "lenet-mnist", **row})
    for row in per_call:
        emit({"phase": "times", "card": card["nvidia_smi"], **row})

    e2e = {"phase": "times", "card": card["nvidia_smi"],
           **nin_end_to_end(torch, np, engine, "nin-cifar10",
                            graph.input_shape)}
    emit(e2e)
    return totals


def dense_layer_times(torch, lenet_graph, gen):
    """B1 at each of LeNet's dense layers at batch 8: events ms and device
    µs (torch.profiler) of the kernel and of ``addmm``; the plain
    version's ms; the bound.  The inputs come from ``gen``."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    rows = []
    for kernel, d in path_calls(lenet_graph, TIMING_BATCH):
        if kernel != "matmul":
            continue
        (a, b, bias), kw = make_inputs(torch, kernel, d, gen, "cuda")
        b_s, o_s = bound(kernel, d)
        fn = lambda: mm.matmul(a, b, bias, **kw)          # noqa: E731
        lib = lambda: torch.addmm(bias, a, b)             # noqa: E731
        rows.append({
            "m": d["m"], "k": d["k"], "n": d["n"],
            "ms": time_ms(torch, fn), "device_us": device_us(torch, fn)[0],
            "plain_ms": time_ms(torch, lambda: ref.matmul_ref(a, b, bias,
                                                              **kw)),
            "library_ms": time_ms(torch, lib),
            "library_device_us": device_us(torch, lib)[0],
            "bytes_s": b_s, "ops_s": o_s, "bound_ms": 1e3 * max(b_s, o_s),
            "bound_by": "bytes" if b_s >= o_s else "operations"})
    return rows


def nin_end_to_end(torch, np, engine, name, input_shape):
    """NIN through ``engine.predict`` on the host clock around synchronised
    work: batch-1 latency (median and p90 of 50 after 5 warm-ups), batch-8
    latency (median of 20), batch-64 images/s (median of 5 runs of 10
    calls), and the CUDA-event time of one batch-1 forward."""
    rng = np.random.default_rng(SEED + 3)
    xs = {b: rng.standard_normal((b, *input_shape)).astype(np.float32)
          for b in (1, 8, 64)}
    lat = {}
    for b, n in ((1, 50), (8, 20)):
        for _ in range(5):
            engine.predict(name, xs[b])
        lat[b] = []
        for _ in range(n):
            t0 = time.perf_counter()
            engine.predict(name, xs[b])
            lat[b].append(time.perf_counter() - t0)
    engine.predict(name, xs[64])
    torch.cuda.synchronize()
    thr = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(10):
            engine.predict(name, xs[64])
        torch.cuda.synchronize()
        thr.append(640 / (time.perf_counter() - t0))
    _, _, params, fn = engine.load(name)
    x1 = torch.from_numpy(xs[1]).to("cuda")
    return {"nin_b1_latency_ms_median": 1e3 * statistics.median(lat[1]),
            "nin_b1_latency_ms_p90": 1e3 * sorted(lat[1])[int(0.9 * 50)],
            "nin_b8_latency_ms_median": 1e3 * statistics.median(lat[8]),
            "nin_b1_forward_event_ms": time_ms(torch, lambda: fn(params, x1),
                                               iters=10),
            "nin_b64_images_per_s_median": statistics.median(thr)}


# device kernels by name -> the part of the forward they belong to (B3's
# pool2d_plane and pool2d_window; pool2d_kernel and ew_scalar are the
# names in trees before them)
PROFILE_GROUPS = (("conv_igemm", "conv2d"), ("conv_reduce", "conv2d"),
                  ("sgemm_bias_act", "matmul"), ("pool2d_", "pool2d"),
                  ("ew_vec4", "elementwise"), ("ew_scalar", "elementwise"),
                  ("softmax_rows", "softmax"), ("Memcpy HtoD", "input copy"))


def phase_profile(torch, np, engine, card):
    """Device time by part and the device's idle share, over 20 NIN
    requests through engine.predict at batch 1, 8 and 64 (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 4)
    for batch in (1, 8, 64):
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
# the launch path: host µs per launch of every wrapper
# ---------------------------------------------------------------------------

LAUNCH_CALLS = 10_000


def host_us(torch, fn, n=LAUNCH_CALLS):
    """Host µs per call of ``fn`` over ``n`` calls with no synchronise
    between them (time.perf_counter_ns), after 200 warm calls on a
    drained device."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    ns = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return ns / n / 1e3


def launch_path_cases(torch):
    """(wrapper name, shape, wrapper call, one PyTorch call computing the
    same function or None): the CNN kernels at NIN's batch-1 shapes (B1 at
    LeNet's first dense layer), B6/B7 at a TinyLlama decode step's (batch
    8, ring fp32, paged int8), B8 at a 5-token prefill, B10 at a 5-token
    RWKV-6 prefill and B11 at a decode batch of Granite's wq; B3 also at
    NIN's average pools, and B4 also in place.  Only the wrappers' public
    signatures are used, so the cases run on any tree of the port (the
    in-place ReLU where the tree has ``relu_``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    gen = torch.Generator().manual_seed(SEED + 95)
    dev = DEVICE

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)
    x_sm, x_ew, x_pool = randn(1, 10), randn(1, 192, 32, 32), \
        randn(1, 96, 32, 32)
    x_avg, x_gap = randn(1, 192, 16, 16), randn(1, 10, 8, 8)
    a_mm, b_mm, c_mm = randn(1, 800), randn(800, 500) * 0.05, randn(500)
    x1, w1, b1 = randn(1, 3, 32, 32), randn(192, 3, 5, 5) * 0.16, randn(192)
    x9, w9, b9 = randn(1, 192, 8, 8), randn(10, 192, 1, 1) * 0.1, randn(10)
    q_dec = randn(8, 32, 64)
    k_dec, v_dec = randn(8, 4, 1024, 64), randn(8, 4, 1024, 64)
    valid = torch.tensor([37, 64, 100, 5, 80, 120, 16, 90],
                         dtype=torch.int32, device=dev)
    mask = (torch.arange(1024, device=dev)[None, :]
            < valid[:, None].long())[:, None, None, :]
    ps, w_pages = 16, 64
    k_pg = torch.randint(-127, 128, (1 + 8 * w_pages, 4, ps, 64),
                         generator=gen, dtype=torch.int8).to(dev)
    v_pg = k_pg.flip(0)
    ks_pg = (0.01 + 0.04 * torch.rand(1 + 8 * w_pages, 4, ps,
                                      generator=gen)).to(dev)
    pt = (torch.randperm(8 * w_pages, generator=gen) + 1).reshape(
        8, w_pages).to(torch.int32).to(dev)
    q_pf, k_pf, v_pf = randn(1, 5, 32, 64), randn(1, 5, 4, 64), \
        randn(1, 5, 4, 64)
    r_w = [randn(1, 5, 40, 64) for _ in range(3)]
    w_w = torch.rand(1, 5, 40, 64, generator=gen).to(dev) * 0.9 + 0.05
    u_w = randn(40, 64)
    a8 = torch.randint(-127, 128, (8, 1536), generator=gen,
                       dtype=torch.int8).to(dev)
    b8 = torch.randint(-127, 128, (1536, 1536), generator=gen,
                       dtype=torch.int8).to(dev)
    sa, sb = randn(8).abs(), randn(1536).abs()
    a8_pad = torch.cat([a8, a8.new_zeros(24, 1536)])
    return [
        ("softmax", "1 x 10", lambda: kops.softmax(x_sm),
         lambda: torch.softmax(x_sm, -1)),
        ("elementwise", "relu 1 x 192 x 32 x 32",
         lambda: kops.elementwise(x_ew, "relu"), lambda: F.relu(x_ew)),
        ("pool2d", "max 3/2/1 on 1 x 96 x 32 x 32",
         lambda: kops.pool2d(x_pool, mode="max", kernel=3, stride=2, pad=1),
         lambda: F.max_pool2d(x_pool, 3, 2, 1)),
        ("pool2d", "avg 3/2/1 on 1 x 192 x 16 x 16",
         lambda: kops.pool2d(x_avg, mode="avg", kernel=3, stride=2, pad=1),
         lambda: F.avg_pool2d(x_avg, 3, 2, 1, count_include_pad=False)),
        ("pool2d", "global avg 8/1/0 on 1 x 10 x 8 x 8",
         lambda: kops.pool2d(x_gap, mode="avg", kernel=8, stride=1, pad=0),
         lambda: F.avg_pool2d(x_gap, 8, 1, 0)),
        ("matmul", "1 x 800 @ 800 x 500 + bias (LeNet dense)",
         lambda: kops.matmul(a_mm, b_mm, c_mm),
         lambda: torch.addmm(c_mm, a_mm, b_mm)),
        ("conv2d", "3->192 5x5 pad 2 on 1 x 32 x 32 (NIN conv 1)",
         lambda: kops.conv2d(x1, w1, b1, pad=2),
         lambda: F.conv2d(x1, w1, b1, padding=2)),
        ("conv2d", "192->10 1x1 on 1 x 8 x 8 (NIN conv 9)",
         lambda: kops.conv2d(x9, w9, b9), lambda: F.conv2d(x9, w9, b9)),
        ("decode_attention", "ring fp32, 8 lanes of 5-120 tokens, 32/4 "
         "heads of 64",
         lambda: kops.decode_attention(q_dec, k_dec, v_dec, valid,
                                       layout="bksd"),
         lambda: F.scaled_dot_product_attention(
             q_dec[:, :, None], k_dec, v_dec, attn_mask=mask,
             enable_gqa=True)),
        ("decode_attention_paged_q8", "paged int8, 8 lanes of 5-120 "
         "tokens, 32/4 heads of 64, pages of 16",
         lambda: kops.decode_attention_paged_q8(q_dec, k_pg, v_pg, ks_pg,
                                                ks_pg, pt, valid,
                                                layout="bksd"), None),
        ("flash_attention", "prefill 5 tokens, 32/4 heads of 64",
         lambda: kops.flash_attention(q_pf, k_pf, v_pf),
         lambda: F.scaled_dot_product_attention(
             q_pf.transpose(1, 2), k_pf.transpose(1, 2), v_pf.transpose(1, 2),
             is_causal=True, enable_gqa=True)),
        ("rwkv6_chunked", "1 x 5 x 40 x 64",
         lambda: kops.rwkv6_chunked(*r_w, w_w, u_w), None),
        ("int8_matmul", "8 x 1536 @ 1536 x 1536",
         lambda: kops.int8_matmul(a8, b8, sa, sb),
         lambda: torch._int_mm(a8_pad, b8)),
    ] + ([("elementwise", "relu in place 1 x 192 x 32 x 32",
           lambda: kops.relu_(x_ew), lambda: torch.relu_(x_ew))]
         if hasattr(kops, "relu_") else [])


def host_path_rows(torch):
    """Per case: host µs per launch of the wrapper and of the PyTorch call
    (no synchronise), and the wrapper's device µs per launch (profiler),
    so a reader sees where the host, not the device, sets the pace."""
    rows = []
    for name, shape, fn, lib in launch_path_cases(torch):
        rows.append({"wrapper": name, "shape": shape,
                     "host_us": host_us(torch, fn),
                     "device_us": device_us(torch, fn)[0],
                     "library_host_us": host_us(torch, lib) if lib else None})
    return rows


def softmax_steps(torch):
    """B5's wrapper taken apart, host µs per call of each step over
    LAUNCH_CALLS calls at NIN's (1, 10): the checks, the output, the
    stream lookup, the pointer arguments and the ctypes call, as the
    launch path does them; the whole wrapper and torch.softmax beside
    them."""
    from repro_torch.kernels import _build, softmax as sm
    from repro_torch.kernels import ops as kops
    x = torch.randn(1, 10, device=DEVICE)
    out = torch.empty_like(x)
    kops.softmax(x)                                   # binds the symbol
    fn, idx = sm.KERNEL._fn, x.get_device()
    raw = _build._raw_stream_fn()
    stream = raw(idx)
    xp, op = x.data_ptr(), out.data_ptr()

    def checks():
        if x.ndim != 2 or x.is_cpu:
            raise AssertionError
        _build.check_cuda_f32("softmax", x)
        if not x.is_contiguous():
            raise AssertionError
    steps = {
        "checks": checks,
        "output torch.empty_like": lambda: torch.empty_like(x),
        "stream raw current stream": lambda: raw(idx),
        "pointers data_ptr()": lambda: (x.data_ptr(), out.data_ptr()),
        "ctypes call, int arguments": lambda: fn(xp, op, 1, 10, stream),
        "wrapper kops.softmax": lambda: kops.softmax(x),
        "torch.softmax": lambda: torch.softmax(x, -1),
    }
    return {k: host_us(torch, f) for k, f in steps.items()}


def _gil_held(kernel):
    """The entry point of ``kernel`` bound through ``ctypes.PyDLL``, which
    keeps the GIL across the call (``CudaKernel`` binds through
    ``ctypes.CDLL``, which releases and retakes it)."""
    import ctypes
    from repro_torch.kernels import _build
    fn = getattr(ctypes.PyDLL(str(_build.library_path())), kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    return fn


def pool2d_steps(torch):
    """B3's wrapper taken apart, host µs per call of each step over
    LAUNCH_CALLS calls at max 3/2/1 on 1 x 96 x 32 x 32 (NIN's first pool
    at batch 1): the fast check, the plan lookup, three ways to allocate
    the output, the device index, the stream, the pointers and the ctypes
    call with the plan's address (through CDLL and through PyDLL), as the
    launch path does them; what ctypes spends converting one pointer
    against the 9 ints the geometry would take as arguments (``from_param``,
    which ctypes calls for each argument); the whole wrapper and
    F.max_pool2d beside them."""
    import ctypes
    import torch.nn.functional as F
    from repro_torch.kernels import _build, pool
    x = torch.randn(1, 96, 32, 32, device=DEVICE)
    kw = dict(mode="max", kernel=3, stride=2, pad=1)
    out = pool.pool2d(x, **kw)           # makes the plan, binds the symbol
    plan, addr, shape = pool._PLANS[(x.shape, "max", 3, 2, 1)]
    fn, idx, dev = pool.KERNEL._fn, x.get_device(), x.device
    pyfn = _gil_held(pool.KERNEL)
    raw = _build._raw_stream_fn()
    stream = raw(idx)
    xp, op = x.data_ptr(), out.data_ptr()
    ints = [getattr(plan, f) for f in ("bc", "h", "w", "oh", "ow", "kernel",
                                       "stride", "pad", "is_max")]
    f32, as_int, as_ptr = torch.float32, ctypes.c_int.from_param, \
        ctypes.c_void_p.from_param
    steps = {
        "checks is_cuda, dtype, is_contiguous": lambda: (
            x.is_cuda and x.dtype is f32 and x.is_contiguous()),
        "plan lookup": lambda: pool._PLANS.get((x.shape, "max", 3, 2, 1)),
        "output torch.empty(shape, device=x.device)":
            lambda: torch.empty(shape, device=x.device),
        "output torch.empty(shape, device=<cached>)":
            lambda: torch.empty(shape, device=dev),
        "output x.new_empty(shape)": lambda: x.new_empty(shape),
        "device index x.get_device()": lambda: x.get_device(),
        "stream raw current stream": lambda: raw(idx),
        "pointers data_ptr()": lambda: (x.data_ptr(), out.data_ptr()),
        "ctypes call, plan address (CDLL)": lambda: fn(xp, op, addr, stream),
        "ctypes call, plan address (PyDLL)":
            lambda: pyfn(xp, op, addr, stream),
        "ctypes conversion, 1 pointer": lambda: as_ptr(addr),
        "ctypes conversion, 9 ints": lambda: tuple(map(as_int, ints)),
        "wrapper kops.pool2d": lambda: pool.pool2d(x, **kw),
        "F.max_pool2d": lambda: F.max_pool2d(x, 3, 2, 1),
    }
    return {k: host_us(torch, f) for k, f in steps.items()}


def elementwise_steps(torch):
    """B4's wrapper taken apart, host µs per call of each step over
    LAUNCH_CALLS calls at NIN's relu on 1 x 192 x 32 x 32: the fast check,
    the output, the device index, the stream, the pointers, the ctypes
    call out of place and in place (through CDLL and through PyDLL); the
    whole wrappers, out of place and in place, and F.relu and torch.relu_
    beside them."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build, elementwise as ew
    from repro_torch.kernels import ops as kops
    x = torch.randn(1, 192, 32, 32, device=DEVICE)
    y = x.relu()
    out = kops.elementwise(x, "relu")         # binds the symbol
    fn, idx, n = ew.KERNEL._fn, x.get_device(), x.numel()
    pyfn = _gil_held(ew.KERNEL)
    raw = _build._raw_stream_fn()
    stream = raw(idx)
    xp, op, yp = x.data_ptr(), out.data_ptr(), y.data_ptr()
    f32, codes = torch.float32, ew._CODES
    steps = {
        "checks act code, is_cuda, dtype, is_contiguous": lambda: (
            codes.get("relu") is not None and x.is_cuda and x.dtype is f32
            and x.is_contiguous()),
        "output torch.empty_like": lambda: torch.empty_like(x),
        "device index x.get_device()": lambda: x.get_device(),
        "numel": lambda: x.numel(),
        "stream raw current stream": lambda: raw(idx),
        "pointers data_ptr()": lambda: (x.data_ptr(), out.data_ptr()),
        "ctypes call (CDLL)": lambda: fn(xp, op, n, 1, stream),
        "ctypes call in place (CDLL)": lambda: fn(yp, yp, n, 1, stream),
        "ctypes call (PyDLL)": lambda: pyfn(xp, op, n, 1, stream),
        "wrapper kops.elementwise": lambda: kops.elementwise(x, "relu"),
        "wrapper kops.relu_": lambda: kops.relu_(y),
        "F.relu": lambda: F.relu(x),
        "torch.relu_": lambda: torch.relu_(y),
    }
    return {k: host_us(torch, f) for k, f in steps.items()}


def phase_launch_path(run, torch, card):
    """Host µs per launch of every wrapper (launch_path_cases) beside one
    PyTorch call computing the same function, and B3's, B4's and B5's
    wrappers step by step (pool2d_steps, elementwise_steps,
    softmax_steps)."""
    rows = host_path_rows(torch)
    steps = {"pool2d_steps_host_us": pool2d_steps(torch),
             "elementwise_steps_host_us": elementwise_steps(torch),
             "softmax_steps_host_us": softmax_steps(torch)}
    for row in rows:
        emit({"phase": "launch_path", "card": card["nvidia_smi"],
              "calls": LAUNCH_CALLS, **row})
    for name, row in steps.items():
        emit({"phase": "launch_path", "card": card["nvidia_smi"],
              "calls": LAUNCH_CALLS, name: row})
    run.check("launch_path", "every wrapper timed", all(
        r["host_us"] > 0 for r in rows))
    first = {}
    for r in rows:
        first.setdefault(r["wrapper"], r)
    return first


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
DECODE_ROUTES = ["decode_attn_split: FFMA split-KV, the last CTA merges "
                 "(every (KV, G, D) but G 16)",
                 "decode_attn_wide + decode_merge_wide: 3xTF32 on mma.sync "
                 "with the 16 query heads as M, a merge kernel (G 16)"]
# (KV, G, D): TinyLlama, Qwen3, Granite-MoE, the reduced Granite and
# RecurrentGemma-9B's local attention (one KV head for 16 query heads of 256)
DECODE_HEADS = ((4, 8, 64), (8, 2, 64), (8, 3, 64), (2, 4, 32), (1, 16, 256))
# Whisper-medium's decode attention, 'bskd', 16/16 heads of 64, 8 lanes:
# (slots, valid lengths, paged, cache dtypes) for the decoder's
# self-attention ring of 448 slots (ring and 16-slot pages) and the
# cross-attention over 1500 encoder frames (every lane's valid length the
# encoder's)
WHISPER_SELF = [1, 448, 65, 300, 64, 129, 447, 2]
WHISPER_DECODE = ((448, WHISPER_SELF, False, ("float32", "bfloat16", "int8")),
                  (448, WHISPER_SELF, True, ("float32", "int8")),
                  (1500, [1500] * 8, False, ("float32", "bfloat16")))
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
    (KV 4, G 8), Qwen3 heads (KV 8, G 2), Granite-MoE heads (KV 8, G 3)
    at D 64, the reduced Granite's (KV 2, G 4) at D 32 and RecurrentGemma's
    (KV 1, G 16) at D 256, B 1 and 8,
    S 1024, ragged valid lengths, fp32/bf16/int8 caches, both layouts;
    then slots past valid_len set to NaN must not change the output."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(SEED + 10)
    rtol, atol = DECODE_TOL
    summary = {}
    for paged in (False, True):
        fam = "decode_attention_paged" if paged else "decode_attention"
        for kvh, g, d in DECODE_HEADS:
            for b, valid in ((1, [1]), (1, [777]), (8, None)):
                if paged and b == 1:
                    continue
                for dtype in ("float32", "bfloat16", "int8"):
                    for layout in ("bksd", "bskd"):
                        case = decode_case(torch, gen, dev, b=b, kvh=kvh, g=g,
                                           dtype=dtype, layout=layout,
                                           paged=paged, valid=valid, d=d)
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
                                f"D={d} (rtol {rtol}, atol {atol})")
                        if not run.check("decode_kernels", what, bad == 0,
                                         max_abs_err=err, mismatches=bad):
                            s["failed"] += 1
    for s, valid, paged, dtypes in WHISPER_DECODE:
        fam = "decode_attention_paged" if paged else "decode_attention"
        for dtype in dtypes:
            case = decode_case(torch, gen, dev, b=8, kvh=16, g=1,
                               dtype=dtype, layout="bskd", paged=paged,
                               valid=valid, s=s, d=64)
            got = decode_call(kops, ref, case, "bskd")
            want = decode_call(kops, ref, case, "bskd", plain=True)
            torch.cuda.synchronize()
            err, bad = compare(torch, got, want, rtol, atol)
            run.max_err[fam] = max(run.max_err.get(fam, 0.0), err)
            summary.setdefault("whisper_bskd", []).append(
                {"family": fam, "dtype": dtype, "slots": s,
                 "max_abs_err": err, "mismatches": bad})
            run.check("decode_kernels", f"{fam} {dtype} bskd at Whisper's "
                      f"{s} slots, B=8 KV=16 G=1 D=64 (rtol {rtol}, atol "
                      f"{atol})", bad == 0, max_abs_err=err, mismatches=bad)
    # nothing past a lane's prefix is read: NaN there changes nothing
    for paged in (False, True):
        for dtype in ("float32", "int8"):
            for layout, heads, s in (("bksd", (4, 8, 64), 1024),
                                     ("bskd", (16, 1, 64), 448),
                                     ("bksd", (1, 16, 256), 1024)):
                case = decode_case(torch, gen, dev, b=8, kvh=heads[0],
                                   g=heads[1], d=heads[2], dtype=dtype,
                                   layout=layout, paged=paged, s=s,
                                   valid=None if s == 1024 else WHISPER_SELF)
                clean = decode_call(kops, ref, case, layout)
                poison(torch, case, layout)
                dirty = decode_call(kops, ref, case, layout)
                torch.cuda.synchronize()
                ok = bool(torch.isfinite(dirty).all()) and \
                    torch.equal(clean, dirty)
                run.check("decode_kernels", f"nothing read past valid_len "
                          f"paged={paged} {dtype} {layout} (KV, G, D) "
                          f"{heads}", ok)
                summary.setdefault("nan_past_valid_len", []).append(
                    {"paged": paged, "dtype": dtype, "layout": layout,
                     "heads": list(heads), "ok": ok})
    summary["split_kv"] = split_kv_checks(run, torch, gen, dev)
    summary["split_kv_wide"] = split_kv_checks(run, torch, gen, dev,
                                               heads=(1, 16, 256))
    summary["fp64_wide"] = wide_fp64_checks(run, torch, dev)
    for key, s in summary.items():
        emit({"phase": "decode_kernels", "check": key, "result": s})


def split_kv_checks(run, torch, gen, dev, heads=(4, 8, 64)):
    """The split-KV kernel at ``heads`` (KV, G, D; TinyLlama's by default,
    RecurrentGemma's takes the wide route), ring and paged, fp32, bf16
    and int8: valid lengths on the chunk's edges and at and past the
    capacity against the plain version (DECODE_TOL), each call run twice
    bit-equal (a ticket counter left non-zero would break the second); one
    lane run alone bit-equal to the same lane in the batch of 8; NaN for
    the lane whose valid_len is 0 and, paged, for the lane whose table
    holds a page id outside the pool in its prefix, the other lanes as
    the plain version."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    kvh, g, d = heads
    rtol, atol = DECODE_TOL
    rows = []
    for paged in (False, True):
        fam = "decode_attention_paged" if paged else "decode_attention"
        for dtype in ("float32", "bfloat16", "int8"):
            elem = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
            p = da.plan(8, kvh, g, d, elem, slots=16 if paged else 1024,
                        page_size=16 if paged else None, width=64,
                        scaled=dtype == "int8")
            chunk = p.chunk
            edges = [1, chunk - 1, chunk, chunk + 1, 2 * chunk, 1023, 1024,
                     1031]
            case = decode_case(torch, gen, dev, b=8, kvh=kvh, g=g, d=d,
                               dtype=dtype, layout="bksd", paged=paged,
                               valid=edges)
            got = decode_call(kops, ref, case, "bksd")
            again = decode_call(kops, ref, case, "bksd")
            want = decode_call(kops, ref, case, "bksd", plain=True)
            i = 3                                   # valid chunk + 1
            one = {"q": case["q"][i:i + 1], "valid": case["valid"][i:i + 1],
                   "k": case["k"], "v": case["v"], "scales": case["scales"]}
            if paged:
                one["pt"] = case["pt"][i:i + 1]
            else:
                one["k"], one["v"] = case["k"][i:i + 1], case["v"][i:i + 1]
                if case["scales"] is not None:
                    one["scales"] = tuple(x[i:i + 1] for x in case["scales"])
            alone = decode_call(kops, ref, one, "bksd")
            bad_case = dict(case, valid=case["valid"].clone())
            bad_case["valid"][0] = 0
            nan_lanes = [0]
            if paged:
                bad_case["pt"] = case["pt"].clone()
                bad_case["pt"][2, 1] = 10 ** 6       # in lane 2's prefix
                nan_lanes.append(2)
            poisoned = decode_call(kops, ref, bad_case, "bksd")
            torch.cuda.synchronize()
            err, bad = compare(torch, got, want, rtol, atol)
            run.max_err[fam] = max(run.max_err.get(fam, 0.0), err)
            keep = [j for j in range(8) if j not in nan_lanes]
            row = {"paged": paged, "dtype": dtype, "heads": list(heads),
                   "chunk": chunk, "wide": p.wide,
                   "valid_len": edges, "max_abs_err": err,
                   "edges_within_tol": bad == 0,
                   "rerun_bit_equal": torch.equal(got, again),
                   "alone_bit_equal": torch.equal(alone[0], got[i]),
                   "nan_lanes": bool(torch.isnan(poisoned[nan_lanes]).all()),
                   "other_lanes_kept": torch.equal(poisoned[keep], got[keep])}
            rows.append(row)
            for key in ("edges_within_tol", "rerun_bit_equal",
                        "alone_bit_equal", "nan_lanes", "other_lanes_kept"):
                run.check("decode_kernels", f"split-KV {fam} {dtype} (KV, G, "
                          f"D) {heads}: {key}", row[key], max_abs_err=err,
                          mismatches=bad)
    return rows


def wide_fp64_checks(run, torch, dev):
    """B6 (ring fp32) and B7 (paged int8) at RecurrentGemma's heads (the
    wide route) against fp64 (decode_fp64) at 8 lanes like serve_hybrid's
    live ones: the largest and the rms error within the bounds that the
    FFMA route's errors on the same inputs set (DECODE_WIDE_FP64)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    kvh, g, d = DECODE_WIDE_FP64["heads"]
    gen = torch.Generator().manual_seed(SEED + DECODE_WIDE_FP64["seed"])

    def draw(dtype, paged, where=dev):
        return decode_case(torch, gen, where, b=8, kvh=kvh, g=g, d=d,
                           dtype=dtype, layout="bksd", paged=paged,
                           s=HYBRID_CACHE_LEN,
                           valid=list(DECODE_WIDE_FP64["valid"]))
    rows = []
    for form, (dtype, paged) in (("ring fp32", ("float32", False)),
                                 ("paged int8", ("int8", True))):
        case = draw(dtype, paged)
        if not paged:       # the phase's other ring layers precede paged's
            for _ in range(DECODE_WIDE_FP64["layers"] - 1):
                draw(dtype, paged, "cpu")
        err = decode_call(kops, ref, case, "bksd").double() - \
            decode_fp64(torch, case)
        row = {"form": form, "max_abs_err_fp64": float(err.abs().max()),
               "rms_err_fp64": float(err.pow(2).mean().sqrt())}
        bound = DECODE_WIDE_FP64[form]
        run.check("decode_kernels", f"{form} at (KV, G, D) {(kvh, g, d)} "
                  f"against fp64: max <= {bound[0]}, rms <= {bound[1]}",
                  row["max_abs_err_fp64"] <= bound[0]
                  and row["rms_err_fp64"] <= bound[1], **row)
        rows.append(row)
    return rows


def poison(torch, case, layout="bksd"):
    """NaN (or a wild scale) in every stored slot past each lane's prefix."""
    k, v, sc = case["k"], case["v"], case["scales"]
    nan_k = k.dtype != torch.int8
    targets = [k, v] if nan_k else list(sc)
    if layout == "bskd":                # slots second: view them as bksd
        targets = [t.transpose(1, 2) for t in targets]
    for i, n in enumerate(case["valid"].tolist()):
        if "pt" in case:
            ps = targets[0].shape[2]
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
    seed (norm weights start at zero and group-norm scales at one, as
    there)."""
    from repro_torch.models import param_template
    from repro_torch.models.common import map_template
    rng = np.random.default_rng(seed)

    def leaf(p):
        if p.init in ("zeros", "ones"):
            return (np.zeros if p.init == "zeros" else np.ones)(p.shape,
                                                               np.float32)
        x = rng.standard_normal(p.shape, dtype=np.float32)
        x *= np.float32(p.std)
        return x
    return map_template(leaf, param_template(cfg))


WEIGHT_CHUNK = 1 << 24          # elements per independently seeded draw


def numpy_weights_chunked(np, cfg, seed):
    """As :func:`numpy_weights`, drawn on every core: chunk j of leaf i
    from its own generator, ``SeedSequence(seed, spawn_key=(i, j))``, on
    a pool of threads (numpy fills without the GIL), so the draws do not
    depend on the number of threads and 3 B parameters take seconds,
    not a minute.  The models of earlier slices keep numpy_weights' one
    serial stream, so the inputs of their checks stay as they were."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.models import param_template
    from repro_torch.models.common import map_template
    drawn = []

    def leaf(p):
        if p.init in ("zeros", "ones"):
            return (np.zeros if p.init == "zeros" else np.ones)(p.shape,
                                                               np.float32)
        x = np.empty(p.shape, np.float32)
        drawn.append((x, np.float32(p.std)))
        return x
    tree = map_template(leaf, param_template(cfg))

    def fill(job):
        i, j = job
        x, std = drawn[i]
        part = x.reshape(-1)[j * WEIGHT_CHUNK:(j + 1) * WEIGHT_CHUNK]
        rng = np.random.default_rng(np.random.SeedSequence(seed,
                                                           spawn_key=(i, j)))
        rng.standard_normal(out=part, dtype=np.float32)
        part *= std
    jobs = [(i, j) for i, (x, _) in enumerate(drawn)
            for j in range(-(-x.size // WEIGHT_CHUNK))]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(fill, jobs))
    return tree


SWAP_LAYERS = 8     # depth of the models the model-swap phases publish


def cut_depth(cfg, tree, n=SWAP_LAYERS):
    """(cfg, tree) with only the first ``n`` layers: the width, and so
    every kernel shape, stays the model's."""
    import dataclasses
    return (dataclasses.replace(cfg, num_layers=n),
            {**tree, "layers": {k: v[:n] for k, v in tree["layers"].items()}})


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
    torch.cuda.reset_peak_memory_stats()
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
            prefills = full_prefills(sched, len(reqs))
            b8 = after["flash_attention"] - before["flash_attention"]
            rec = {"phase": "serve", "config": tag, "wall_s": wall,
                   "decode_steps": sched.decode_steps,
                   "decode_launches": decode,
                   "full_prefills": prefills, "prefill_launches": b8,
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
            want_b8 = L * prefills if backend is None else 0
            run.check("serve", f"{tag}: B8 launches = {L} x full prefills",
                      b8 == want_b8, launches=b8, prefills=prefills)
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
            if got != want and opts.get("kv_dtype") == "int8":
                # measured, not excused: the check below stays
                rec["divergence_logit_gaps"] = divergence_gaps(
                    torch, cfg, params, reqs, got, want)
                rec["parted_lane"] = parted_lane_logits(
                    torch, kops, cfg, params, opts,
                    lambda: serve_requests(np, cfg, SEED + 20), got, want)
            run.check("serve", f"{name}: greedy tokens on cuda equal ref",
                      got == want, requests_equal=match,
                      gaps=rec.get("divergence_logit_gaps"))
        emit(rec)
    counts = kops.launches()                         # read just after
    path = {"decode_attention": sum(counts[k] for k in
                                    DECODE_FAMILY["decode_attention"]),
            "decode_attention_paged": sum(counts[k] for k in
                                          DECODE_FAMILY["decode_attention_paged"]),
            "flash_attention": counts["flash_attention"]}
    emit({"phase": "serve", "main_path_launches": counts,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    run.phase("serve_teacher_forced", phase_teacher_forced, run, torch, np,
              cfg, params)
    return cfg, np_params, params, engines, path, results


def parted_lane_logits(torch, kops, cfg, params, opts, make_requests, got,
                       want, cache_len=SERVE_CACHE_LEN):
    """C4: the first request whose stream on the kernels parts from
    ``ref``'s, replayed through a batch-8 ServingEngine on each backend,
    its lane's logits read at the decode step that chose the first
    differing token: each backend's logits of the two tokens, their gap,
    its argmax and the lane's valid length.  That is the engine's own
    batch-8 int8 step, which divergence_gaps' fp32 batch-1 forward does
    not reproduce.  The replays' launches are not counted."""
    from repro_torch.serving.engine import ServingEngine
    i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    j = next(k for k, (x, y) in enumerate(zip(got[i], want[i])) if x != y)
    ta, tb = got[i][j], want[i][j]
    out = {"request": i, "token_index": j, "cuda_token": ta, "ref_token": tb}
    if j == 0:
        out["note"] = "the first token comes from the prefill, not a decode step"
        return out
    from repro_torch.core.jit import disable_graphs
    saved = kops.launches()
    for backend, name in ((None, "cuda"), ("ref", "ref")):
        eng = ServingEngine(cfg, params, max_batch=8,
                            cache_len=cache_len, attn_backend=backend,
                            device=DEVICE, **opts)
        reqs = make_requests()
        sched = eng.scheduler(max_new_cap=max(r.max_new_tokens for r in reqs))
        step, steps = sched._decode_lanes, [0]

        def capture(tokens, pos, step=step, sched=sched, steps=steps,
                    name=name, uid=reqs[i].uid):
            lg = step(tokens, pos)
            slot = next((k for k, r in enumerate(sched.slots) if r is not None
                         and r.uid == uid and sched._steps_left[k] > 0), None)
            if slot is not None:
                steps[0] += 1
                if steps[0] == j:                    # this step samples token j
                    row = lg[slot].float()
                    out[name] = {"logit_cuda_token": float(row[ta]),
                                 "logit_ref_token": float(row[tb]),
                                 "gap": float(row[ta] - row[tb]),
                                 "argmax": int(row.argmax()),
                                 "valid_len": int(sched._host_valid[slot]) + 1}
            return lg
        sched._decode_lanes = capture
        with disable_graphs():          # capture() reads logits on the host
            eng.generate_batch(reqs)
    for k, n in saved.items():
        kops.KERNELS[k].launches = n
    return out


def full_prefills(sched, n_requests):
    """Admissions that ran a full prefill: every request on a ring (no
    preemption there); on pages, the admissions that missed the prefix
    cache (a hit feeds its suffix through decode steps)."""
    if sched._paged:
        return sched.admissions - sched.prefix_hits
    return n_requests


def divergence_gaps(torch, cfg, params, reqs, got, want):
    """For each request whose two greedy streams part: the gap between
    the two chosen tokens' logits in an fp32 forward over the prompt and
    the shared prefix of the output."""
    from repro_torch import models
    mod = models.get_module(cfg)
    gaps = []
    with torch.inference_mode():
        for r, a, b in zip(reqs, got, want):
            if a == b:
                continue
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            toks = torch.tensor([r.prompt + a[:j]], device=DEVICE)
            if cfg.family == "audio":       # the scheduler's zero frames
                frames = torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                                     device=DEVICE)
                out = mod.forward(cfg, params, toks, frames, backend="ref")
            else:
                out = mod.forward(cfg, params, toks, backend="ref")
            lg = (out[0] if isinstance(out, tuple) else out)[0, -1]
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
    """TinyLlama-1.1B and Qwen3-0.6B at full width and SWAP_LAYERS deep,
    published with publish_checkpoint (Qwen3 also as int8), served
    through MultiModelServer(max_resident=2) in the order A, B, A, B,
    then the int8 artifact: resident-cache hits, misses and the switch
    log."""
    from repro_torch.checkpoint.ckpt import load_published, publish_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.serving.engine import MultiModelServer
    store = ModelStore(store_root)
    qwen = cut_depth(get_config("qwen3-0.6b"), {"layers": {}})[0]
    tiny, tiny_np = cut_depth(get_config("tinyllama-1.1b"), tiny_np)
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
    fp32 peak, or on the wide route (16 query heads a KV head) three
    times as many at the TF32 tensor-core peak, twice as many where K/V
    (bf16, int8) are exact in TF32 and the kernel drops their lo
    products."""
    from repro_torch.kernels import decode_attention as da
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
    if da.is_wide(h // kvh, d):
        return nbytes / PEAK_HBM_BYTES, \
            (3 if elem == 4 else 2) * ops / PEAK_TF32_FLOPS
    return nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS


# B6/B7's kernels by name: the split-KV kernels and the wide route's merge
DECODE_KERNEL_NAMES = ("decode_attn", "decode_merge")
# device kernels by name -> the part of a decode step they belong to
STEP_GROUPS = tuple((key, "decode attention (B6/B7)")
                    for key in DECODE_KERNEL_NAMES) + (
    ("gemm", "matmul (cuBLAS)"), ("Gemm", "matmul (cuBLAS)"),
    ("gemv", "matmul (cuBLAS)"), ("Memcpy", "copies"), ("Memset", "copies"))


# the runtime calls by which the host launches device work: a kernel each,
# or a whole captured graph
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def _profile_ticks(torch, sched, ticks):
    """Device time by part, launches and idle share over ``ticks`` decode
    ticks with every lane live (torch.profiler), and the host's launch
    calls a step with the host µs they took."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            sched.tick()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    parts, kernels, calls, call_us = {}, 0, {}, 0.0
    for e in prof.events():
        if e.name in HOST_LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
            call_us += e.time_range.elapsed_us()
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
            "host_launch_calls_per_step": {k: v / ticks
                                           for k, v in calls.items()},
            "host_launch_us_per_step": call_us / ticks,
            "device_ms_by_part": {k: v / 1e3 for k, v in parts.items()}}


DECODE_LONG_VALID = 1000     # 8 lanes x 1000 of 1024: bytes the bound sees
# B6/B7 at RecurrentGemma's heads against fp64 at 8 lanes like
# serve_hybrid's live ones (one wrapped ring of 2048, seven prompts into
# their first steps), on the first synthetic layer of
# benchmarks/torch_host_path.py's rg_attention phase (the same seed and
# draws): the bounds (max, rms) are 3x and 1.5x the FFMA route's errors on
# those inputs (ring fp32 3.306e-7 / 2.851e-8, paged int8 4.890e-6 /
# 5.517e-7; that phase on the tree before the wide route, NVIDIA H100
# 80GB HBM3, 700 W): the wide route's products run on the tensor core,
# whose sums truncate
DECODE_WIDE_FP64 = {"heads": (1, 16, 256), "seed": 122, "layers": 12,
                    "valid": (2048, 239, 100, 180, 150, 120, 210, 130),
                    "ring fp32": (9.92e-7, 4.28e-8),
                    "paged int8": (1.467e-5, 8.28e-7)}
DECODE_TIME_LAYERS = 22      # synthetic layers cycled (TinyLlama's depth)


def decode_fp64(torch, case, layout="bksd"):
    """The function B6/B7 compute, evaluated in fp64 from the stored
    values of one case: pages gathered, int8 K/V times their scales (the
    kernel's order of scaling is exact in fp64 up to rounding), a masked
    softmax over each lane's prefix."""
    from repro_torch.kernels import ref
    q, k, v, sc, valid = (case["q"], case["k"], case["v"], case["scales"],
                          case["valid"])
    k, v = k.double(), v.double()
    if sc is not None:
        k, v = k * sc[0].double()[..., None], v * sc[1].double()[..., None]
    if "pt" in case:
        k = ref.paged_gather(k, case["pt"], layout=layout)
        v = ref.paged_gather(v, case["pt"], layout=layout)
    if layout == "bskd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)      # -> (B, KV, S, D)
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) / math.sqrt(d)
    mask = torch.arange(s, device=q.device)[None, :] < valid.long()[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    out = torch.einsum("bkgs,bksd->bkgd", torch.softmax(scores, -1), v)
    return out.reshape(b, h, d)


def decode_launch_record(torch, cases, h, d, plain=True, layout="bksd"):
    """B6 or B7 per launch over ``cases`` (one a layer, cycled as a decode
    step cycles its layers, so the K/V come from device memory): events ms
    and device µs, the bound from the first case's bytes and its share of
    the device time, the plain version's ms, and the kernel's (and the
    plain version's) max and rms error against the fp64 evaluation on the
    first case."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    n = len(cases)
    nxt = iter(range(1 << 62))
    got = decode_call(kops, ref, cases[0], layout)
    exact = decode_fp64(torch, cases[0], layout)
    err = got.double() - exact
    ms = time_ms(torch, lambda: [decode_call(kops, ref, c, layout)
                                 for c in cases], iters=5) / n
    dev_us = device_us(torch, lambda: decode_call(
        kops, ref, cases[next(nxt) % n], layout), n=2 * n)[0]
    b_s, o_s = decode_bound(cases[0], layout, h, d)
    rec = {"ms": ms, "device_us": dev_us,
           "bytes_s": b_s, "ops_s": o_s, "bound_ms": 1e3 * max(b_s, o_s),
           "bound_by": "bytes" if b_s >= o_s else "operations",
           "share_of_bound": dev_us and 1e6 * max(b_s, o_s) / dev_us,
           "max_abs_err_fp64": float(err.abs().max()),
           "rms_err_fp64": float(err.pow(2).mean().sqrt()),
           "valid_len": cases[0]["valid"].tolist()}
    if plain:
        want = decode_call(kops, ref, cases[0], layout, plain=True)
        perr = want.double() - exact
        rec["plain_ms"] = time_ms(
            torch, lambda: [decode_call(kops, ref, c, layout, plain=True)
                            for c in cases], iters=2, reps=3) / n
        rec["plain_max_abs_err_fp64"] = float(perr.abs().max())
        rec["plain_rms_err_fp64"] = float(perr.pow(2).mean().sqrt())
    return rec


def decode_library_record(torch, cases, layout="bksd"):
    """SDPA on the dequantized (and gathered) K/V of ``cases`` with a
    boolean valid mask, per launch: events ms, device µs and its largest
    distance from the kernel on the first case ('bskd' K/V are given to
    SDPA as (B, KV, S, D), transposed outside the timing)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    kv = []
    for case in cases:                              # dequantize + gather
        k, v = case["k"].float(), case["v"].float()
        if case["scales"] is not None:
            k = k * case["scales"][0][..., None]
            v = v * case["scales"][1][..., None]
        if "pt" in case:
            k = ref.paged_gather(k, case["pt"], layout=layout)
            v = ref.paged_gather(v, case["pt"], layout=layout)
        if layout == "bskd":
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        kv.append((k.contiguous(), v.contiguous()))
    valid, q = cases[0]["valid"], cases[0]["q"]
    mask = (torch.arange(kv[0][0].shape[2], device=q.device)[None, :]
            < valid[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    n = len(cases)
    nxt = iter(range(1 << 62))

    def library(i):
        return F.scaled_dot_product_attention(q4, *kv[i], attn_mask=mask,
                                              enable_gqa=True)[:, :, 0]
    got = decode_call(kops, ref, cases[0], layout)
    return {"library_ms": time_ms(torch, lambda: [library(i) for i in range(n)],
                                  iters=5) / n,
            "library_device_us": device_us(
                torch, lambda: library(next(nxt) % n), n=2 * n)[0],
            "library_vs_kernel_max_abs": float((library(0) - got).abs().max())}


def _time_decode_kernel(torch, cfg, sched, q8, paged, long=True,
                        layout="bksd"):
    """B6 or B7 at the main path's shapes and data (the live scheduler's
    layer views and the lanes' valid lengths, every layer with a cache in
    turn), then, with ``long``, at 8 lanes x DECODE_LONG_VALID of 1024
    slots on DECODE_TIME_LAYERS synthetic layers: decode_launch_record and
    SDPA beside it (decode_library_record) at both."""
    cache = sched.state["cache"]
    b, h, d = sched.max_slots, cfg.num_heads, cfg.resolved_head_dim
    kvh = cfg.num_kv_heads
    gen = torch.Generator().manual_seed(SEED + 60)
    q = torch.randn(b, h, d, generator=gen).to(DEVICE)
    pre = "k_pages" if paged else "k"
    L = cache[pre].shape[0]                         # the layers with a cache
    capacity = sched._capacity if paged else \
        cache[pre].shape[3 if layout == "bksd" else 2]
    valid = torch.from_numpy((sched._host_valid + 1).clip(max=capacity)
                             .astype("int32")).to(DEVICE)
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
    rec = {**decode_launch_record(torch, cases, h, d, layout=layout),
           **decode_library_record(torch, cases, layout),
           "batch": b, "heads": h, "kv_heads": kvh, "head_dim": d,
           "layout": layout}
    if not long:
        return rec
    long_cases = [decode_case(torch, gen, DEVICE, b=b, kvh=kvh, g=h // kvh,
                              dtype="int8" if q8 else "float32",
                              layout="bksd", paged=paged, d=d,
                              valid=[DECODE_LONG_VALID] * b)
                  for _ in range(DECODE_TIME_LAYERS)]
    rec["long"] = {**decode_launch_record(torch, long_cases, h, d),
                   **decode_library_record(torch, long_cases),
                   "layers": DECODE_TIME_LAYERS}
    return rec


def serve_time_record(torch, np, cfg, params, name, card):
    """One cache form of TinyLlama-1.1B at batch 8 (``name`` of
    SERVE_CONFIGS, ring-fp32 or paged-int8): decode tokens/s and TTFT
    from the scheduler's counters over 16 requests after a warm pass;
    device time per decode step by part and the device's idle share
    (torch.profiler over 8 ticks with 8 live lanes); B6 or B7 per launch
    (_time_decode_kernel)."""
    from repro_torch.serving.engine import ServingEngine
    q8, paged = "int8" in name, "paged" in name
    eng = ServingEngine(cfg, params, max_batch=8, cache_len=SERVE_CACHE_LEN,
                        device=DEVICE, **SERVE_CONFIGS[name])
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
    sched.tick()                                    # admits all 8
    rec["step_profile"] = _profile_ticks(torch, sched, 8)
    rec["kernel"] = _time_decode_kernel(torch, cfg, sched, q8, paged)
    sched.run()
    return rec


def phase_serve_times(run, torch, np, cfg, params, card):
    """serve_time_record for TinyLlama's ring fp32 (B6) and paged int8
    (B7) forms; SDPA must compute the kernels' function (atol 1e-4)."""
    out = {}
    for name in ("ring-fp32", "paged-int8"):
        rec = serve_time_record(torch, np, cfg, params, name, card)
        for shape, k in (("serve", rec["kernel"]),
                         ("8 x 1000", rec["kernel"]["long"])):
            run.check("serve_times", f"{name} at {shape}: SDPA computes the "
                      "kernel's function (atol 1e-4)",
                      k["library_vs_kernel_max_abs"] <= 1e-4,
                      err=k["library_vs_kernel_max_abs"])
        emit(rec)
        out[name] = rec["kernel"]
    return out


# ---------------------------------------------------------------------------
# the twin of jax.jit: Graph.jit_apply behind InferenceEngine and the dense
# family's captured decode step, against the same code run eagerly under
# disable_graphs(), in the same run
# ---------------------------------------------------------------------------

GRAPH_FORMS = ("ring-fp32", "paged-int8")
GRAPH_TEMP = 0.8        # every other request of the sampled runs


def _launch_delta(kops, before):
    after = kops.launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _cnn_graphs(run, torch, np, graphs, card):
    """NIN and LeNet through ModelStore -> InferenceEngine on the kernels
    at batch 1, 8 and 64: a capture and two replays torch.equal to eager
    forwards with the same launches; three commands in flight, each its
    own output; NIN evicted (max_resident=1), its graphs dropped, and
    reloaded over freed memory filled with NaN; NIN latency and images/s
    (nin_end_to_end) eager, graph, graph, eager."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.importer import to_caffe_json
    from repro_torch.core.jit import disable_graphs
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.kernels import ops as kops
    rec = {"phase": "graphs", "part": "cnn", "card": card["nvidia_smi"],
           "cases": []}
    nin = "nin-cifar10"
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        store = ModelStore(root)
        for name, graph in graphs.items():
            params = params_from_numpy(numpy_params(np, graph, SEED), "cpu",
                                       graph=graph)
            store.publish(name, to_caffe_json(graph, params)[0], params)
        engine = InferenceEngine(store, max_resident=1, device=DEVICE)
        rng = np.random.default_rng(SEED + 70)
        for name, graph in graphs.items():
            for batch in BATCHES:
                xs = [rng.standard_normal((batch, *graph.input_shape))
                      .astype(np.float32) for _ in range(3)]
                with disable_graphs():
                    before = kops.launches()
                    eager = [engine.predict(name, x) for x in xs]
                    eager_launches = _launch_delta(kops, before)
                before = kops.launches()
                got = [engine.predict(name, x) for x in xs]
                graph_launches = _launch_delta(kops, before)
                cbs = [engine.enqueue(name, x) for x in xs]
                flight = [cb.wait_until_completed() for cb in cbs]
                engine.fence()
                tag = f"{name} b={batch}"
                run.check("graphs", f"{tag}: a capture and two replays "
                          "torch.equal the eager forwards", all(
                              torch.equal(a, b) for a, b in zip(got, eager)))
                run.check("graphs", f"{tag}: launches equal eager's",
                          graph_launches == eager_launches,
                          graph=graph_launches, eager=eager_launches)
                run.check("graphs", f"{tag}: three commands in flight each "
                          "give their own result", all(
                              torch.equal(a, b) for a, b in zip(flight, eager))
                          and len({t.data_ptr() for t in flight}) == 3)
                rec["cases"].append({"model": name, "batch": batch,
                                     "launches": graph_launches})
        x = rng.standard_normal((8, *graphs[nin].input_shape)) \
            .astype(np.float32)
        fn = engine.load(nin)[3]                     # reloaded: no graphs
        first = engine.predict(nin, x)
        engine.predict(nin, x)
        held = len(fn._graphs)
        engine.predict("lenet-mnist", rng.standard_normal(
            (8, *graphs["lenet-mnist"].input_shape)).astype(np.float32))
        dropped = fn._graphs == {}
        junk = [torch.full((1 << 22,), float("nan"), device=DEVICE)
                for _ in range(4)]
        again = [engine.predict(nin, x) for _ in range(2)]
        with disable_graphs():
            eager = engine.predict(nin, x)
        del junk
        run.check("graphs", "evicted NIN's graph dropped, reloaded NIN "
                  "torch.equal eager", held == 1 and dropped
                  and all(torch.equal(y, eager) for y in (first, *again)),
                  held=held, dropped=dropped)
        times = []
        for eager_turn in (True, False, False, True):
            with disable_graphs() if eager_turn else nullcontext():
                t = nin_end_to_end(torch, np, engine, nin,
                                   graphs[nin].input_shape)
            times.append({"mode": "eager" if eager_turn else "graph", **t})
        rec["nin_times"] = times
    emit(rec)


def _decode_run(torch, np, cfg, params, form, eager, card):
    """One cache form of full-width TinyLlama on a fresh ServingEngine
    (8 lanes, cache 1024), graph or eager (disable_graphs): a warm pass,
    then serve's 16 requests (serve_requests(SEED + 20): tokens, counters,
    launches, decode tokens/s, TTFT), 8 profiled ticks with 8 live lanes
    (device ms a step, idle share, launch calls a step on the host), and
    on a fresh engine (seed SEED + 7) 8 requests with every other one
    sampled at GRAPH_TEMP."""
    from repro_torch.core.jit import disable_graphs
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.engine import ServingEngine
    opts = dict(max_batch=8, cache_len=SERVE_CACHE_LEN, device=DEVICE,
                **SERVE_CONFIGS[form])
    with disable_graphs() if eager else nullcontext():
        eng = ServingEngine(cfg, params, **opts)
        eng.generate_batch(serve_requests(np, cfg, SEED + 50, n=8, hi=50))
        sched = eng.scheduler()
        sched.metrics.reset()
        reqs = serve_requests(np, cfg, SEED + 20)
        before = kops.launches()
        stats = eng.generate_batch(reqs)
        torch.cuda.synchronize()
        rec = {"phase": "graphs", "part": "decode", "config": form,
               "mode": "eager" if eager else "graph",
               "card": card["nvidia_smi"],
               "graph_captured": sched._graph is not None,
               "decode_tokens_per_s": stats.tok_per_s,
               "decode_s": stats.decode_s, "prefill_s": stats.prefill_s,
               "tokens": stats.tokens_out,
               "ttft_s": sched.metrics.histogram("req.ttft_s").snapshot(),
               "decode_steps": sched.decode_steps,
               "host_syncs": sched.host_syncs,
               "launches": _launch_delta(kops, before)}
        tokens = [r.output for r in reqs]
        for r in serve_requests(np, cfg, SEED + 52, n=8):
            sched.submit(r)
        sched.tick()                                # admits all 8
        rec["step_profile"] = _profile_ticks(torch, sched, 8)
        sched.run()
        sampled = serve_requests(np, cfg, SEED + 53, n=8, max_new=24)
        for i, r in enumerate(sampled):
            r.temperature = GRAPH_TEMP if i % 2 else 0.0
        ServingEngine(cfg, params, seed=SEED + 7, **opts).generate_batch(
            sampled)
    emit(rec)
    return rec, tokens, [r.output for r in sampled]


GRAPH_BUCKET_REQUESTS = 8        # the graphs phase's bucketed runs
GRAPH_BUCKET_NEW = 24


def phase_graphs(run, torch, np, cfg, params, serve_tokens, graphs, card):
    """CUDA graphs against the eager steps in the same run: the CNN engine
    (_cnn_graphs), then TinyLlama-1.1B's decode step in ring fp32 and
    paged int8 (_decode_run, eager then graph in one form, graph then
    eager in the other): greedy tokens equal the eager run's and
    serve's ``ref`` run's, decode_steps, host_syncs and every kernel's
    launches equal the eager run's, sampled tokens equal; then both forms
    with power-of-two prefill buckets (bucketed_against_eager: admission
    replayed per bucket, the prefix hit's suffix step captured, TTFT and
    prefill seconds graph against eager); B6/B7's ticket counters at 0
    after the replays."""
    emit({"phase": "graphs", "torch": torch.__version__,
          "register_generator_state": hasattr(torch.cuda.CUDAGraph,
                                              "register_generator_state")})
    torch.cuda.reset_peak_memory_stats()
    _cnn_graphs(run, torch, np, graphs, card)
    for n, form in enumerate(GRAPH_FORMS):
        runs = {}
        for eager in ((True, False) if n == 0 else (False, True)):
            runs[eager] = _decode_run(torch, np, cfg, params, form, eager,
                                      card)
        (g, g_tok, g_smp), (e, e_tok, e_smp) = runs[False], runs[True]
        ref_tok = serve_tokens[f"{form}/ref"]
        run.check("graphs", f"{form}: the step was captured (graph run) and "
                  "not (eager run)", g["graph_captured"]
                  and not e["graph_captured"])
        run.check("graphs", f"{form}: greedy tokens graph == eager == ref",
                  g_tok == e_tok == ref_tok, graph_vs_eager=sum(
                      a == b for a, b in zip(g_tok, e_tok)),
                  graph_vs_ref=sum(a == b for a, b in zip(g_tok, ref_tok)))
        for key in ("decode_steps", "host_syncs", "launches"):
            run.check("graphs", f"{form}: {key} equal eager's",
                      g[key] == e[key], graph=g[key], eager=e[key])
        run.check("graphs", f"{form}: sampled tokens (temperature "
                  f"{GRAPH_TEMP}) graph == eager", g_smp == e_smp,
                  equal=sum(a == b for a, b in zip(g_smp, e_smp)))
    # admission per prefill bucket and the prefix-hit suffix step: 8
    # requests of 24 tokens, prompts 5-128 (buckets 4-128; past 128 the
    # pads that prompts of one bucket share make prefix hits whose long
    # suffixes cost the eager run minutes), graph against eager; 16 of 48
    # until the examples phase came, which this cut pays for
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.engine import ServingEngine
    bucketed_against_eager(
        run, torch, np, kops, "graphs", cfg,
        lambda form, buckets: ServingEngine(
            cfg, params, max_batch=8, cache_len=SERVE_CACHE_LEN,
            device=DEVICE, prefill_buckets=buckets, **SERVE_CONFIGS[form]),
        GRAPH_FORMS, SEED + 20, n=GRAPH_BUCKET_REQUESTS,
        max_new=GRAPH_BUCKET_NEW, hi=128)
    emit({"phase": "graphs",
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    counters = ticket_counters(torch)
    run.check("graphs", "B6/B7 ticket counters at 0 after the replays",
              not any(counters.values()),
              counters={str(k): v for k, v in counters.items()})


def ticket_counters(torch):
    """Every B6/B7 workspace's ticket counters, summed per (B, KV,
    splits, G, D), after a synchronise: the last CTA of a lane leaves them
    at 0 and the wide route (G 16) takes none, so a replay needs no
    memset."""
    from repro_torch.kernels import decode_attention as da
    torch.cuda.synchronize()
    out = {}
    for k, ws in da._WORKSPACES.items():
        out[k[2:]] = out.get(k[2:], 0) + int(ws[:k[2] * k[3]].abs().sum())
    return out


def graph_against_eager(run, torch, np, kops, phase, cfg, graph_runs,
                        make_engine, make_requests):
    """Each cache form's graph run (``graph_runs``: form -> (its record,
    its tokens)) against the same requests on a fresh engine under
    ``disable_graphs()``, built once the graph engines are freed and freed
    before the next: captured once and not, greedy tokens exactly equal,
    decode_steps, host_syncs and every kernel's launches equal.  Then 8
    requests of 24 new tokens, every other one at GRAPH_TEMP, on a fresh
    ring fp32 engine seeded SEED + 7, graph and eager: the same tokens.
    ``make_engine(form, seed)`` builds an engine; returns the eager
    records by form."""
    from repro_torch.core.jit import disable_graphs
    eager = {}
    for form, (graph, g_tok) in graph_runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        with disable_graphs():
            eng = make_engine(form, 0)
            reqs = make_requests()
            before = kops.launches()
            t1 = time.perf_counter()
            stats = eng.generate_batch(reqs)
            torch.cuda.synchronize()
            sched = eng.scheduler()
            rec = eager[form] = {
                "mode": "eager", "wall_s": time.perf_counter() - t1,
                "graph_captured": sched._graph is not None,
                "decode_steps": sched.decode_steps,
                "host_syncs": sched.host_syncs,
                "launches": _launch_delta(kops, before),
                "tokens": stats.tokens_out, "prefill_s": stats.prefill_s,
                "decode_s": stats.decode_s,
                "decode_tokens_per_s": stats.tok_per_s}
            e_tok = [r.output for r in reqs]
        del eng, sched
        emit({"phase": phase, "config": f"{form}/cuda", **rec})
        run.check(phase, f"{form}: the step was captured (graph run) and "
                  "not (eager run)", graph["graph_captured"]
                  and not rec["graph_captured"])
        run.check(phase, f"{form}: greedy tokens graph == eager",
                  g_tok == e_tok,
                  equal=sum(a == b for a, b in zip(g_tok, e_tok)))
        for key in ("decode_steps", "host_syncs", "launches"):
            run.check(phase, f"{form}: {key} equal eager's", graph[key] ==
                      rec[key], graph=graph[key], eager=rec[key])
    gc.collect()
    torch.cuda.empty_cache()
    outs = {}
    for mode in ("graph", "eager"):
        reqs = serve_requests(np, cfg, SEED + 53, n=8, max_new=24)
        for i, r in enumerate(reqs):
            r.temperature = GRAPH_TEMP if i % 2 else 0.0
        with disable_graphs() if mode == "eager" else nullcontext():
            make_engine("ring-fp32", SEED + 7).generate_batch(reqs)
        outs[mode] = [r.output for r in reqs]
    run.check(phase, f"ring-fp32: sampled tokens (every other request at "
              f"temperature {GRAPH_TEMP}) graph == eager",
              outs["graph"] == outs["eager"], equal=sum(
                  a == b for a, b in zip(outs["graph"], outs["eager"])))
    return eager


def graph_step_record(run, torch, phase, form, sched, ticks=8):
    """A replayed decode step with every lane live (_profile_ticks over
    ``ticks`` ticks, one warm replay first): device ms a step, idle share
    and the host's launch calls a step, which must be at most 3."""
    sched.tick()
    rec = {"mode": "graph", **_profile_ticks(torch, sched, ticks)}
    calls = sum(rec["host_launch_calls_per_step"].values())
    run.check(phase, f"{form}: at most 3 host launch calls a replayed step",
              sched._graph is not None and calls <= 3, calls=calls)
    return rec


def bucket_requests(np, cfg, seed, n, max_new, hi):
    """serve_requests of prompts 5..hi without the shared prefix; request
    0 has hi - 3 tokens and request 1 is request 0 with another last
    token, so both pad to one bucket and share all but its last slot (a
    prefix hit on pages of 16)."""
    reqs = serve_requests(np, cfg, seed, n=n, max_new=max_new, hi=hi,
                          shared_prefix=0)
    first = np.random.default_rng(seed + 1).integers(
        1, cfg.vocab_size, hi - 3).tolist()
    reqs[0].prompt = first
    reqs[1].prompt = first[:-1] + [first[-1] % (cfg.vocab_size - 1) + 1]
    return reqs


def _replays(sched):
    return {k: g.replays for k, g in sched._graphs.items()}


def bucketed_run(torch, np, kops, cfg, make_engine, form, eager, seed, n,
                 max_new, hi):
    """One cache form with power-of-two prefill buckets up to ``hi`` on a
    fresh engine (``make_engine(form, buckets)``), graph or eager
    (disable_graphs): a warm pass of one prompt a bucket (every bucket's
    admission captured; ``max_new`` tokens, so that the measured run
    keeps the scheduler), then bucket_requests: tokens, counters,
    launches, TTFT, prefill seconds, peak device memory, and what each
    captured program ran in it (replays; a capture in the run counts
    one)."""
    from repro_torch.core.jit import disable_graphs
    from repro_torch.launch.serve import pow2_buckets
    from repro_torch.runtime.scheduler import Request
    buckets = pow2_buckets(hi)
    with disable_graphs() if eager else nullcontext():
        eng = make_engine(form, buckets)
        eng.generate_batch([Request(uid=1000 + i, prompt=[1 + i] * b,
                                    max_new_tokens=max_new)
                            for i, b in enumerate(buckets)])
        sched = eng.scheduler()
        sched.metrics.reset()
        held = _replays(sched)
        reqs = bucket_requests(np, cfg, seed, n, max_new, hi)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kops.launches()
        stats = eng.generate_batch(reqs)
        torch.cuda.synchronize()
        after = _replays(sched)
        rec = {"config": form, "mode": "eager" if eager else "graph",
               "scheduler_kept": sched is eng.scheduler(),
               "buckets": buckets, "requests": n, "max_new": max_new,
               "graphs_held": sorted(str(k) for k in after),
               "captured_in_run": sorted(str(k) for k in after
                                         if k not in held),
               "program_runs": {str(k): v - held.get(k, -1)
                                for k, v in after.items()},
               "cold_admissions": (sched.admissions if sched._paged
                                   else len(reqs)) - sched.prefix_hits,
               "prefix_hits": sched.prefix_hits,
               "ttft_s": sched.metrics.histogram("req.ttft_s").snapshot(),
               "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
               "decode_tokens_per_s": stats.tok_per_s,
               "tokens": stats.tokens_out,
               "decode_steps": sched.decode_steps,
               "host_syncs": sched.host_syncs,
               "launches": _launch_delta(kops, before),
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return rec, [r.output for r in reqs]


def bucketed_against_eager(run, torch, np, kops, phase, cfg, make_engine,
                           forms, seed, n=8, max_new=16, hi=64):
    """Each cache form's bucketed_run, graph then eager on fresh engines:
    greedy tokens equal; decode_steps, host_syncs, prefix hits and every
    kernel's launches equal; the graph run captured one admission a
    bucket in its warm pass and replayed it for every cold admission,
    prefix hits ran the captured suffix step and closing sample (one
    sample a hit); the eager run captured nothing.  TTFT and prefill
    seconds graph against eager are in the records."""
    out = {}
    for form in forms:
        recs = {}
        for eager in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            recs[eager] = bucketed_run(torch, np, kops, cfg, make_engine,
                                       form, eager, seed, n, max_new, hi)
            emit({"phase": phase, "part": "buckets", **recs[eager][0]})
        (g, g_tok), (e, e_tok) = recs[False], recs[True]
        tag = f"{form} with prefill buckets"
        run.check(phase, f"{tag}: greedy tokens graph == eager",
                  g_tok == e_tok,
                  equal=sum(a == b for a, b in zip(g_tok, e_tok)))
        run.check(phase, f"{tag}: the warm pass's scheduler served the "
                  "run", g["scheduler_kept"] and e["scheduler_kept"])
        for key in ("decode_steps", "host_syncs", "prefix_hits",
                    "launches"):
            run.check(phase, f"{tag}: {key} equal eager's",
                      g[key] == e[key], graph=g[key], eager=e[key])
        runs = g["program_runs"]
        admits = sum(v for k, v in runs.items() if k.startswith("('admit'"))
        run.check(phase, f"{tag}: one admission graph a bucket, captured "
                  "in the warm pass, replayed for every cold admission; "
                  "nothing captured eagerly",
                  len([k for k in g["graphs_held"] if "admit" in k])
                  == len(g["buckets"]) and admits == g["cold_admissions"]
                  and not any("admit" in k for k in g["captured_in_run"])
                  and not e["graphs_held"],
                  runs=runs, cold=g["cold_admissions"])
        if g["prefix_hits"]:
            run.check(phase, f"{tag}: prefix hits ran the captured suffix "
                      "step and closing sample",
                      runs.get("suffix", 0) >= g["prefix_hits"]
                      and runs.get("finalize", 0) == g["prefix_hits"],
                      runs=runs, hits=g["prefix_hits"])
        out[form] = {"graph": g, "eager": e}
    return out


def phase_b2_times(run, torch, graph, card):
    """B2, the implicit-GEMM conv kernel, at each of NIN's 9 convs at batch
    8: against its plain version (im2col + matmul_ref, rtol 1e-3 / atol
    1e-4) and F.conv2d (cuDNN, TF32 off, within 1e-3), two runs
    bit-equal; per conv the CTAs and depth splits, events (kernel, plain
    version, F.conv2d), device µs by torch.profiler (kernel, F.conv2d)
    and the bound; for a split conv the same unsplit and split for one
    CTA per SM."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d as cv
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    set_fp32_exact(torch)
    gen = torch.Generator().manual_seed(SEED + 70)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "device_us": 0.0,
         "library_device_us": 0.0, "bytes_s": 0.0, "ops_s": 0.0,
         "bound_s": 0.0, "convs": 0}
    rows = []
    for kernel, d in path_calls(graph, TIMING_BATCH):
        if kernel != "conv2d":
            continue
        (x, w, bias), kw = make_inputs(torch, kernel, d, gen, DEVICE)
        kw.pop("activation")
        name = f"{d['shape'][1]}->{d['out_channels']} {d['kernel']}x" \
               f"{d['kernel']} on {d['shape'][2]}x{d['shape'][3]}"
        got = kops.conv2d(x, w, bias, **kw)
        again = kops.conv2d(x, w, bias, **kw)
        want = ref.conv2d_im2col_ref(x, w, bias, **kw)
        lib = F.conv2d(x, w, bias, stride=kw["stride"], padding=kw["pad"])
        torch.cuda.synchronize()
        err, bad = compare(torch, got, want, 1e-3, 1e-4)
        run.max_err["conv2d"] = max(run.max_err.get("conv2d", 0.0), err)
        run.check("b2_times", f"{name} vs its plain version (rtol 1e-3, "
                  "atol 1e-4)", bad == 0, max_abs_err=err, mismatches=bad)
        lib_err = float((got - lib).abs().max())
        run.check("b2_times", f"{name} vs F.conv2d (atol 1e-3)",
                  lib_err <= 1e-3, err=lib_err)
        run.check("b2_times", f"{name}: two runs bit-equal",
                  torch.equal(got, again))
        o, (b, c, h, wd) = d["out_channels"], d["shape"]
        k = d["kernel"]
        oh = (h + 2 * d["pad"] - k) // d["stride"] + 1
        p = b * oh * ((wd + 2 * d["pad"] - k) // d["stride"] + 1)
        splits = cv.split_count(o, p, c * k * k, sms)
        tiles = -(-o // cv.TILE_O) * -(-p // cv.TILE_P)
        b_s, o_s = bound(kernel, d)
        row = {"conv": name, "splits": splits, "ctas": tiles * splits,
               "ms": time_ms(torch, lambda: kops.conv2d(x, w, bias, **kw)),
               "device_us": device_us(torch, lambda: kops.conv2d(
                   x, w, bias, **kw))[0],
               "plain_ms": time_ms(torch, lambda: ref.conv2d_im2col_ref(
                   x, w, bias, **kw)),
               "library_ms": time_ms(torch, lambda: F.conv2d(
                   x, w, bias, stride=kw["stride"], padding=kw["pad"])),
               "library_device_us": device_us(torch, lambda: F.conv2d(
                   x, w, bias, stride=kw["stride"], padding=kw["pad"]))[0],
               "bound_ms": 1e3 * max(b_s, o_s),
               "bound_by": "bytes" if b_s >= o_s else "operations",
               "max_abs_err": err, "vs_library_max_abs": lib_err}
        if splits > 1:
            alts = [("unsplit", dict(splits=1))]
            one_wave = cv.split_count(o, p, c * k * k, sms // cv.CTAS_PER_SM)
            if one_wave != splits:      # one CTA per SM instead of two
                alts.append((f"splits={one_wave}", dict(splits=one_wave)))
            for tag, args in alts:
                alt = cv.launch(x, w, bias, **kw, **args)
                alt2 = cv.launch(x, w, bias, **kw, **args)
                torch.cuda.synchronize()
                e2, bad2 = compare(torch, alt, want, 1e-3, 1e-4)
                run.check("b2_times", f"{name} {tag} vs its plain version "
                          "(rtol 1e-3, atol 1e-4), two runs bit-equal",
                          bad2 == 0 and torch.equal(alt, alt2), max_abs_err=e2)
                row[tag] = {
                    "ms": time_ms(torch, lambda: cv.launch(x, w, bias, **kw,
                                                           **args)),
                    "device_us": device_us(torch, lambda: cv.launch(
                        x, w, bias, **kw, **args))[0]}
        rows.append(row)
        emit({"phase": "b2_times", "card": card["nvidia_smi"],
              "batch": TIMING_BATCH, **row})
        for key in ("ms", "plain_ms", "library_ms"):
            t[key] += row[key]
        for key in ("device_us", "library_device_us"):
            t[key] = None if t[key] is None or row[key] is None \
                else t[key] + row[key]
        t["bytes_s"] += b_s
        t["ops_s"] += o_s
        t["bound_s"] += max(b_s, o_s)
        t["convs"] += 1
    emit({"phase": "b2_times", "card": card["nvidia_smi"],
          "batch": TIMING_BATCH, "total": t,
          "bound_ms": 1e3 * t["bound_s"]})
    return t


def phase_fft_conv(run, torch, np, graph, card):
    """NIN-CIFAR10 at batch 8 with every conv on the ``fft`` route
    (``core/fftconv.py``: torch.fft; the JAX package has no Pallas kernel
    for it either) and the pools, ReLUs and softmax on B3, B4 and B5,
    against ``ref`` at the CNN bars (rtol 1e-3, atol 1e-4), with no B2
    launch on that route.  Forward ms (CUDA events) on the fft route, on
    the kernels alone (B2 for the convs) and on ``ref``; per conv,
    fft_conv2d's events ms and device µs beside B2's."""
    from repro_torch.core.fftconv import fft_conv2d
    from repro_torch.kernels import ops as kops
    set_fp32_exact(torch)
    params = {layer: {k: torch.from_numpy(v).to(DEVICE) for k, v in g.items()}
              for layer, g in numpy_params(np, graph, SEED + 7).items()}
    x = torch.from_numpy(np.random.default_rng(SEED + 8).standard_normal(
        (TIMING_BATCH, *graph.input_shape)).astype(np.float32)).to(DEVICE)
    routes = {"fft": {"conv": "fft", "default": "cuda"}, "cuda": "cuda",
              "ref": "ref"}
    with torch.inference_mode():
        kops.reset_launches()
        got = graph.apply(params, x, backend=routes["fft"])
        torch.cuda.synchronize()
        launched = {k: v for k, v in kops.launches().items() if v}
        want = graph.apply(params, x, backend="ref")
        err, bad = compare(torch, got, want, 1e-3, 1e-4)
        run.check("fft_conv", "NIN at batch 8 on the fft conv route vs ref "
                  "(rtol 1e-3, atol 1e-4)", bad == 0, max_abs_err=err,
                  mismatches=bad)
        run.check("fft_conv", "the fft route launches B3, B4 and B5, no B2",
                  set(launched) == {"pool2d", "elementwise", "softmax"},
                  launches=launched)
        forward_ms = {name: time_ms(torch, lambda b=b: graph.apply(
            params, x, backend=b), iters=10) for name, b in routes.items()}
        convs = []
        for kernel, d in path_calls(graph, TIMING_BATCH):
            if kernel != "conv2d":
                continue
            xi = torch.randn(d["shape"], device=DEVICE)
            w = 0.05 * torch.randn(d["out_channels"], d["shape"][1],
                                   d["kernel"], d["kernel"], device=DEVICE)
            b = torch.randn(d["out_channels"], device=DEVICE)
            kw = dict(stride=d["stride"], pad=d["pad"])

            def fft():
                return fft_conv2d(xi, w, b, **kw)

            def b2():
                return kops.conv2d(xi, w, b, **kw)
            e, n_bad = compare(torch, fft(), b2(), 1e-3, 1e-4)
            convs.append({
                "conv": f"{d['shape'][1]}->{d['out_channels']} "
                        f"{d['kernel']}x{d['kernel']} on "
                        f"{d['shape'][2]}x{d['shape'][3]}",
                "fft_ms": time_ms(torch, fft),
                "fft_device_us": device_us(torch, fft)[0],
                "b2_ms": time_ms(torch, b2),
                "b2_device_us": device_us(torch, b2)[0],
                "fft_vs_b2_max_abs": e})
            run.check("fft_conv", f"fft_conv2d vs B2 at {convs[-1]['conv']} "
                      "(rtol 1e-3, atol 1e-4)", n_bad == 0, max_abs_err=e)
    emit({"phase": "fft_conv", "card": card["nvidia_smi"],
          "batch": TIMING_BATCH, "max_abs_err_vs_ref": err,
          "launches": launched, "forward_ms": forward_ms, "convs": convs,
          "fft_conv_ms_sum": sum(c["fft_ms"] for c in convs),
          "b2_conv_ms_sum": sum(c["b2_ms"] for c in convs)})
    return forward_ms


# ---------------------------------------------------------------------------
# slice 3: training through launch.train, then publish and serve
# ---------------------------------------------------------------------------

FLASH_CU = "src/repro_torch/kernels/csrc/flash_attention.cu"
# the kernels behind each wrapper, by head dim (the kernels line names them)
FLASH_ROUTES = {
    "fwd": ["flash_fwd_tc: 3xTF32 on wgmma, one warpgroup, head dim <= 128",
            "flash_fwd_tc256: 3xTF32 on wgmma, two warpgroups splitting "
            "q.k^T and o by head-dim halves, head dim 256"],
    "bwd": ["flash_dq_tc, flash_dkv_tc: 3xTF32 on mma.sync, head dim <= 128",
            "flash_dq, flash_dkv: FFMA, head dim 256"]}
FLASH_SOURCES = {
    "flash_attention": (FLASH_CU, "src/repro/kernels/flash_attention.py:77"),
    "flash_attention_fwd": (FLASH_CU,
                            "src/repro/kernels/flash_attention_bwd.py:92"),
    "flash_attention_dq": (FLASH_CU,
                           "src/repro/kernels/flash_attention_bwd.py:203"),
    "flash_attention_dkv": (FLASH_CU,
                            "src/repro/kernels/flash_attention_bwd.py:220"),
}
# H, KV, D: the full models', and the reduced configs' that the serve and
# train command lines bootstrap by default (head_dim 32)
FLASH_HEADS = {"tinyllama": (32, 4, 64), "qwen3": (16, 8, 128),
               "granite-moe": (24, 8, 64),
               "tinyllama-reduced": (8, 1, 32), "qwen3-reduced": (8, 4, 32),
               "granite-moe-reduced": (8, 2, 32)}
FLASH_SEQS = (1, 5, 64, 127, 300, 1024, 2048)
# (name, B, Sq, Sk, H, KV, D, causal, window): RecurrentGemma-9B's local
# attention (16/1 heads of 256, window 2048; head_dim 256 takes 32-row
# tiles); Whisper-medium's encoder (1500 frames, non-causal) and its
# cross-attention prefill (16/16 heads of 64, a 300-token prompt against
# 1500 frames), non-causal and causal; and query
# rows that no key can see (Sq > Sk + window - 1), where the kernels give
# the Pallas kernels' mean of v
FLASH_EXTRA = (
    ("recurrentgemma", 1, 2500, 2500, 16, 1, 256, True, 2048),
    ("recurrentgemma", 2, 300, 300, 16, 1, 256, True, 2048),
    ("recurrentgemma", 1, 5, 5, 16, 1, 256, True, 2048),
    ("whisper-encoder", 1, 1500, 1500, 16, 16, 64, False, 0),
    ("whisper-cross", 1, 300, 1500, 16, 16, 64, False, 0),
    ("whisper-cross", 2, 300, 1500, 16, 16, 64, True, 0),
    ("blind-rows", 2, 300, 100, 16, 1, 256, True, 64),
    ("blind-rows", 1, 300, 100, 32, 4, 64, False, 64))
# rtol, atol.  fp32: outputs, lse and grads differ from the plain
# versions in summation order and in the forward's and the backward's
# 3xTF32 products (each split x = hi + lo, the lo.lo term left out);
# grads take the JAX suite's bar for its fused backward
# (tests/test_kernels.py:441-446).  bf16: the plain B8 rounds p
# to bf16 before PV, and every output is rounded to bf16.
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 3e-2)}
FLASH_GRAD_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (2e-2, 3e-2)}
# TinyLlama's own context (arXiv:2401.02385) at batch 4; Qwen3 shorter
TRAIN = {"tinyllama-1.1b": dict(batch=4, seq=2048, steps=4),
         "qwen3-0.6b": dict(batch=4, seq=1024, steps=2)}
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-3                       # ||g_cuda - g_ref|| / ||g_ref||
# o against fp64 at RecurrentGemma-9B's 1 x 2100 prefill (16/1 heads of
# 256, window 2048, inputs uniform in [-2, 2)): rms at most the FFMA
# forward's there, 1.035e-7, which the head-dim-256 wgmma route replaced
# (benchmarks/torch_host_path.py --phases rg_attention on the tree before
# it; NVIDIA H100 80GB HBM3, 700 W), rounded up; |slope - 1| the
# train-shape bar of the tensor-core route (the FFMA forward's -6.1e-9
# has no truncating sums)
RG_FP64 = {"heads": (16, 1, 256), "window": 2048, "rms": 1.1e-7,
           "slope": 5e-7}
PREFILL_SEQ = 300          # B8 timed at a serving prompt's length as well


def _flash_fp64_error(torch, q, k, v, o, window=0):
    """(rms of o - exact, slope of o against exact less 1), exact being
    causal attention in fp64 on the same inputs (local within ``window``
    keys where it is set), one batch row at a time."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    if window:
        future |= torch.ones_like(future).tril(-window)
    sq = gw = ww = 0.0
    for i in range(b):
        qi = q[i].double().transpose(0, 1)
        ki = k[i].double().repeat_interleave(g, dim=1).transpose(0, 1)
        vi = v[i].double().repeat_interleave(g, dim=1).transpose(0, 1)
        sc = (qi @ ki.transpose(1, 2)) / math.sqrt(d)
        exact = torch.softmax(sc.masked_fill_(future, float("-inf")), -1) @ vi
        got = o[i].double().transpose(0, 1)
        sq += float(((got - exact) ** 2).sum())
        gw += float((got * exact).sum())
        ww += float((exact * exact).sum())
    return math.sqrt(sq / o.numel()), gw / ww - 1.0


def phase_flash_kernels(run, torch):
    """B8, B9's forward (o and lse), dq and dk/dv against their plain
    versions: TinyLlama, Qwen3 and Granite-MoE heads (G 8, 2 and 3),
    full (head_dim 64 and 128) and reduced (head_dim 32), B 1 and 4, S 1
    to 2048 (ragged against the 64-row tiles), causal with window 0 and
    256, fp32 and bf16; then FLASH_EXTRA: head_dim 256 and Sq != Sk
    (RecurrentGemma, Whisper cross attention, rows no key can see); then
    a perturbed future token; then B8 and B9's forward at the train shape
    against fp64.  Every kernel runs each case twice: the two runs are
    bit-equal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    summary = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def check(kernel, dtype, what, got, want, tol):
        rtol, atol = tol
        err, bad = compare(torch, got, want, rtol, atol)
        run.max_err[kernel] = max(run.max_err.get(kernel, 0.0), err)
        s = summary.setdefault(f"{kernel}/{dtype}", {
            "checks": 0, "failed": 0, "max_abs_err": 0.0, "rtol": rtol,
            "atol": atol})
        s["checks"] += 1
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if not run.check("flash_kernels", f"{kernel} {dtype} {what} "
                         f"(rtol {rtol}, atol {atol})", bad == 0,
                         max_abs_err=err, mismatches=bad):
            s["failed"] += 1

    def check_bwd(dtype, what, res, kw):
        """dq and dk/dv against their plain versions, and a second run of
        each bit-equal to the first (no float atomics)."""
        dq, dkv = fa.flash_dq(*res, **kw), fa.flash_dkv(*res, **kw)
        check("flash_attention_dq", dtype, what, dq,
              ref.flash_dq_ref(*res, **kw), FLASH_GRAD_TOL[dtype])
        for part, got, want in zip(("dk", "dv"), dkv,
                                   ref.flash_dkv_ref(*res, **kw)):
            check("flash_attention_dkv", dtype, f"{what} {part}", got, want,
                  FLASH_GRAD_TOL[dtype])
        again = (fa.flash_dq(*res, **kw),) + fa.flash_dkv(*res, **kw)
        run.check("flash_kernels", f"dq, dk/dv {dtype} {what}: two runs "
                  "bit-equal", all(torch.equal(x, y) for x, y in
                                   zip((dq,) + dkv, again)))

    def check_fwd(dtype, what, q, k, v, kw):
        """B8's o, B9's (o, lse) against their plain versions, and a second
        run of each bit-equal to the first (no float atomics); returns the
        plain (o, lse)."""
        o8 = kops.flash_attention(q, k, v, **kw)
        check("flash_attention", dtype, what, o8,
              ref.flash_attention_ref(q, k, v, **kw), FLASH_TOL[dtype])
        o, lse = fa.flash_fwd_lse(q, k, v, **kw)
        o_ref, lse_ref = ref.flash_fwd_lse_ref(q, k, v, **kw)
        check("flash_attention_fwd", dtype, what + " o", o, o_ref,
              FLASH_TOL[dtype])
        check("flash_attention_fwd", dtype, what + " lse", lse, lse_ref,
              FLASH_TOL["float32"])
        again = (kops.flash_attention(q, k, v, **kw),) + \
            fa.flash_fwd_lse(q, k, v, **kw)
        run.check("flash_kernels", f"B8, B9's forward {dtype} {what}: two "
                  "runs bit-equal", all(torch.equal(x, y) for x, y in
                                        zip((o8, o, lse), again)))
        return o_ref, lse_ref

    for heads, (h, kvh, d) in FLASH_HEADS.items():
        for b in (1, 4):
            for s in FLASH_SEQS:
                for window in (0, 256):
                    for dtype in ("float32", "bfloat16"):
                        dt = getattr(torch, dtype)
                        q, do = randn(b, s, h, d, dtype=dt), randn(b, s, h, d, dtype=dt)
                        k, v = randn(b, s, kvh, d, dtype=dt), randn(b, s, kvh, d, dtype=dt)
                        kw = dict(causal=True, window=window)
                        what = f"{heads} B={b} S={s} window={window}"
                        o_ref, lse_ref = check_fwd(dtype, what, q, k, v, kw)
                        res = (q, k, v, do, lse_ref, fa.dsum_of(o_ref, do))
                        check_bwd(dtype, what, res, kw)
                        torch.cuda.synchronize()    # a fault shows here
    for heads, b, sq, sk, h, kvh, d, causal, window in FLASH_EXTRA:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, do = randn(b, sq, h, d, dtype=dt), randn(b, sq, h, d, dtype=dt)
            k, v = randn(b, sk, kvh, d, dtype=dt), randn(b, sk, kvh, d, dtype=dt)
            kw = dict(causal=causal, window=window)
            what = (f"{heads} B={b} Sq={sq} Sk={sk} H={h} KV={kvh} D={d} "
                    f"causal={causal} window={window}")
            o_ref, lse_ref = check_fwd(dtype, what, q, k, v, kw)
            res = (q, k, v, do, lse_ref, fa.dsum_of(o_ref, do))
            check_bwd(dtype, what, res, kw)
            torch.cuda.synchronize()
    # causality: a perturbed last token leaves every earlier row unchanged
    q, k, v = randn(2, 300, 32, 64), randn(2, 300, 4, 64), randn(2, 300, 4, 64)
    base = kops.flash_attention(q, k, v)
    k[:, -1] += 10.0
    v[:, -1] += 10.0
    pert = kops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    changed = float((base[:, -1] - pert[:, -1]).abs().max())
    ok = torch.equal(base[:, :-1], pert[:, :-1]) and changed > 1e-3
    run.check("flash_kernels", "a perturbed last token changes only the "
              "last row", ok, last_row_change=changed)
    # o against fp64 at the train shape: the tensor-core sums' structure
    # (small terms first, hi.hi over several accumulators), which the
    # plain-version tolerance does not see (one accumulator a product
    # passed it and parted greedy int8 streams from ref's)
    q, k, v = (torch.rand(4, 2048, n, 64, generator=gen, device=dev) * 4 - 2
               for n in (32, 4, 4))
    for name, o in (("B8", kops.flash_attention(q, k, v)),
                    ("B9's forward", fa.flash_fwd_lse(q, k, v)[0])):
        rms, slope = _flash_fp64_error(torch, q, k, v, o)
        run.check("flash_kernels", f"{name} fp32 at the train shape against "
                  "fp64: rms <= 1e-7, |slope - 1| <= 5e-7",
                  rms <= 1e-7 and abs(slope) <= 5e-7, rms=rms,
                  slope_minus_1=slope)
        emit({"phase": "flash_kernels", "check": f"{name} against fp64",
              "rms": rms, "slope_minus_1": slope})
    # and at RecurrentGemma-9B's longest prefill (1 x 2100, 16/1 heads of
    # 256, window 2048): the head-dim-256 route held to the FFMA forward's
    # error on the same shape and distribution (RG_FP64)
    h, kvh, d = RG_FP64["heads"]
    q, k, v = (torch.rand(1, HYBRID_LONG, n, d, generator=gen, device=dev)
               * 4 - 2 for n in (h, kvh, kvh))
    win = RG_FP64["window"]
    for name, o in (("B8", kops.flash_attention(q, k, v, window=win)),
                    ("B9's forward", fa.flash_fwd_lse(q, k, v,
                                                      window=win)[0])):
        rms, slope = _flash_fp64_error(torch, q, k, v, o, window=win)
        run.check("flash_kernels", f"{name} fp32 at RecurrentGemma's 1 x "
                  f"{HYBRID_LONG} prefill (window {win}) against fp64: rms "
                  f"<= {RG_FP64['rms']}, |slope - 1| <= {RG_FP64['slope']}",
                  rms <= RG_FP64["rms"] and abs(slope) <= RG_FP64["slope"],
                  rms=rms, slope_minus_1=slope)
        emit({"phase": "flash_kernels", "check": f"{name} against fp64 at "
              f"1 x {HYBRID_LONG}, window {win}", "rms": rms,
              "slope_minus_1": slope})
    del q, k, v
    for key, s in summary.items():
        emit({"phase": "flash_kernels", "check": key, "result": s})
    emit({"phase": "flash_kernels", "check": "causality", "ok": ok,
          "last_row_change": changed})


def _step1_grads(torch, cfg, np_params, batch, backend):
    """(loss, grads in tree order) of loss_fn on the initial params."""
    from repro_torch import models
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import to_device
    from repro_torch.optim.adamw import tree_items
    params = params_from_numpy(np_params, DEVICE, cfg=cfg)
    paths, leaves = zip(*[(p, x.requires_grad_())
                          for p, x in tree_items(params)])
    loss, _ = models.get_module(cfg).loss_fn(
        cfg, params, to_device(batch, DEVICE), backend=backend)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(("/".join(p) for p in paths), grads))


def _train_run(torch, cfg, np_params, backend, publish_to=None):
    """launch.train.train on the card from ``np_params``: (losses, the
    launch counts of the run, wall s, peak device bytes)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import train
    kw = TRAIN[cfg.name]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()                            # the main path starts
    t0 = time.perf_counter()
    params, losses = train(cfg.name, steps=kw["steps"], batch=kw["batch"],
                           seq=kw["seq"], use_reduced=False,
                           publish_to=publish_to, log_every=1, seed=SEED,
                           device=DEVICE, params=np_params, backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launches()                         # read just after
    del params
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return losses, counts, wall, peak


def _train_model(run, torch, cfg, np_params, publish_to=None):
    """One model: step-1 gradients on cuda and ref, then the trainer on
    cuda (the main path) and on ref from the same numpy params."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    kw = TRAIN[cfg.name]
    L, steps = cfg.num_layers, kw["steps"]
    batch0 = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=kw["seq"],
                                    global_batch=kw["batch"],
                                    seed=SEED)).batch(0)
    loss_c, g_cuda = _step1_grads(torch, cfg, np_params, batch0, None)
    g_cuda = {k: g.cpu() for k, g in g_cuda.items()}
    torch.cuda.empty_cache()
    loss_r, g_ref = _step1_grads(torch, cfg, np_params, batch0, "ref")
    rel, finite = {}, True
    for key, gr in g_ref.items():
        gc = g_cuda[key].to(DEVICE)
        finite &= bool(torch.isfinite(gc).all())
        rel[key] = float((gc - gr).norm() / gr.norm().clamp_min(1e-30))
    del g_cuda, g_ref, gc, gr
    torch.cuda.empty_cache()
    worst = max(rel, key=rel.get)
    run.check("train", f"{cfg.name}: step-1 grads, cuda vs ref, per leaf "
              f"||dg|| / ||g|| <= {TRAIN_GRAD_REL}",
              all(r <= TRAIN_GRAD_REL for r in rel.values()) and finite,
              worst=worst, rel=rel[worst], finite=finite)
    losses, rec = {}, {"phase": "train", "model": cfg.name, **kw,
                       "params": cfg.param_count(),
                       "step1_loss": {"cuda": loss_c, "ref": loss_r},
                       "step1_grad_rel": rel}
    for backend in (None, "ref"):
        tag = backend or "cuda"
        got, counts, wall, peak = _train_run(
            torch, cfg, np_params, backend,
            publish_to if backend is None else None)
        losses[tag] = got
        want = {k: 0 for k in counts}
        if backend is None:
            want.update(flash_attention_fwd=2 * L * steps,
                        flash_attention_dq=L * steps,
                        flash_attention_dkv=L * steps)
            rec["main_path_launches"] = counts
        run.check("train", f"{cfg.name}/{tag}: launches (forward 2 x {L} "
                  f"x steps under remat, dq and dk/dv {L} x steps)",
                  counts == want, launches={k: v for k, v in counts.items()
                                            if v or want[k]})
        run.check("train", f"{cfg.name}/{tag}: finite losses",
                  all(math.isfinite(x) for x in got), losses=got)
        rec[tag] = {"losses": got, "wall_s": wall,
                    "tokens_per_s_incl_first_step":
                        steps * kw["batch"] * kw["seq"] / wall,
                    "peak_device_gb": peak / 1e9}
    rel_loss = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                     losses["ref"])]
    rec["loss_rel_diff"] = rel_loss
    run.check("train", f"{cfg.name}: losses cuda vs ref at every step "
              f"(rtol {TRAIN_LOSS_RTOL})",
              len(rel_loss) == steps and max(rel_loss) <= TRAIN_LOSS_RTOL,
              rel=rel_loss)
    emit(rec)
    return rec


def phase_train(run, torch, np, tiny_np, store_root):
    """TinyLlama-1.1B at full width and depth (fp32, batch 4 x 2048, 4
    AdamW steps on SyntheticLM) through launch.train on the flash kernels
    and on ``ref`` from one numpy-seeded tree, publishing the cuda run;
    then Qwen3-0.6B (qk-norm, tied embeddings, head_dim 128), 2 steps at
    batch 4 x 1024."""
    from repro_torch.configs import get_config
    set_fp32_exact(torch)
    tiny = get_config("tinyllama-1.1b")
    out = {tiny.name: _train_model(run, torch, tiny, tiny_np,
                                   publish_to=store_root)}
    qwen = get_config("qwen3-0.6b")
    qwen_np = numpy_weights(np, qwen, SEED + 1)
    out[qwen.name] = _train_model(run, torch, qwen, qwen_np)
    return out[tiny.name]["main_path_launches"]


def phase_train_publish_serve(run, torch, np, tiny_np, store_root):
    """The trained TinyLlama, loaded back from the model store it was
    published to, served through ServingEngine (4 greedy requests) on the
    kernels and on ``ref``: tokens equal, 22 B8 launches per full
    prefill and 22 B6 launches per decode step."""
    from repro_torch.checkpoint.ckpt import load_published
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.kernels import ops as kops
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serving.engine import ServingEngine
    cfg, cpu_params, rec = load_published(ModelStore(store_root),
                                          "tinyllama-1.1b")
    meta = rec.load_spec()["metadata"]
    moved = float((cpu_params["layers"]["wq"][0]
                   - torch.from_numpy(tiny_np["layers"]["wq"][0])).abs().max())
    run.check("train_publish_serve", "the artifact holds the trained "
              "weights", meta.get("steps") == TRAIN[cfg.name]["steps"]
              and moved > 0, metadata=meta, wq0_moved=moved)
    params = tree_map(lambda p: p.to(DEVICE), cpu_params)
    del cpu_params
    L, outs, report = cfg.num_layers, {}, {"phase": "train_publish_serve",
                                           "metadata": meta}
    for backend in (None, "ref"):
        tag = backend or "cuda"
        eng = ServingEngine(cfg, params, max_batch=4,
                            cache_len=SERVE_CACHE_LEN, attn_backend=backend,
                            device=DEVICE)
        reqs = serve_requests(np, cfg, SEED + 80, n=4, max_new=16,
                              shared_prefix=0)
        kops.reset_launches()                        # the main path starts
        eng.generate_batch(reqs)
        torch.cuda.synchronize()
        counts = kops.launches()                     # read just after
        sched = eng.scheduler()
        want = {k: 0 for k in counts}
        if backend is None:
            want["flash_attention"] = L * full_prefills(sched, len(reqs))
            want["decode_attention"] = L * sched.decode_steps
        run.check("train_publish_serve", f"{tag}: launches (B8 {L} x full "
                  f"prefills, B6 {L} x decode steps)", counts == want,
                  launches={k: v for k, v in counts.items() if v})
        outs[tag] = [r.output for r in reqs]
        report[tag] = {"launches": {k: v for k, v in counts.items() if v},
                       "decode_steps": sched.decode_steps,
                       "tokens": [len(o) for o in outs[tag]]}
        del eng
    run.check("train_publish_serve", "greedy tokens on cuda equal ref",
              outs["cuda"] == outs["ref"] and all(
                  len(o) == 16 for o in outs["cuda"]))
    report["tokens_equal_ref"] = outs["cuda"] == outs["ref"]
    emit(report)
    return report["cuda"]["launches"].get("flash_attention", 0)


CLI_TRAIN_STEPS = 2
# the dense-family configs the command line serves reduced (2 layers, d
# 256, head_dim 32): their full widths (32.1 GB, 32.8 GB, 137 GB in fp32)
# are not served in this script
CLI_SERVE_ONLY = ("llama3-8b", "qwen3-8b", "chameleon-34b")


def _quiet(fn, *args):
    """fn(*args) with its printed lines kept: (result, the last lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().strip().splitlines()[-6:]


def phase_cli(run, torch, np):
    """The two command lines a user starts from, on the card with their
    defaults (reduced configs, head_dim 32): ``launch.serve --model
    tinyllama-1.1b`` on an empty store bootstraps a model and serves it
    (B8 in prefill, B6 in decode), and its tokens equal a ``ref`` engine's
    on the bootstrapped weights; ``launch.train`` (reduced TinyLlama) runs
    on B9, its losses equal a ``ref`` run's; then the same for RWKV-6,
    Granite-MoE, RecurrentGemma-9B and Whisper-medium, and
    ``launch.serve`` alone for Llama3-8B, Qwen3-8B and Chameleon-34B
    (CLI_SERVE_ONLY)."""
    from repro_torch.checkpoint.ckpt import load_published
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve, train
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serving.engine import ServingEngine
    set_fp32_exact(torch)
    rec = {"phase": "cli"}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
        kops.reset_launches()                        # the main path starts
        _, rec["serve_out"] = _quiet(serve.main, [
            "--store", store, "--model", "tinyllama-1.1b"])
        torch.cuda.synchronize()
        counts = kops.launches()                     # read just after
        rec["serve_launches"] = {k: v for k, v in counts.items() if v}
        run.check("cli", "launch.serve --model tinyllama-1.1b on an empty "
                  "store: B8 in prefill and B6 in decode, nothing else",
                  set(rec["serve_launches"]) == {"flash_attention",
                                                 "decode_attention"},
                  launches=rec["serve_launches"])
        cfg, cpu_params, _ = load_published(ModelStore(store),
                                            "tinyllama-1.1b")
        params = tree_map(lambda p: p.to(DEVICE), cpu_params)
        outs = {}
        for backend in (None, "ref"):
            eng = ServingEngine(cfg, params, max_batch=4, cache_len=128,
                                attn_backend=backend, device=DEVICE)
            reqs = serve_requests(np, cfg, SEED + 85, n=4, max_new=16,
                                  lo=5, hi=100, shared_prefix=0)
            eng.generate_batch(reqs)
            outs[backend or "cuda"] = [r.output for r in reqs]
        run.check("cli", f"the bootstrapped {cfg.name} (head_dim "
                  f"{cfg.resolved_head_dim}): greedy tokens on cuda equal "
                  "ref", outs["cuda"] == outs["ref"]
                  and all(len(o) == 16 for o in outs["cuda"]))
        rec["bootstrapped"] = {"num_layers": cfg.num_layers,
                               "head_dim": cfg.resolved_head_dim,
                               "tokens_equal_ref": outs["cuda"] == outs["ref"]}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
        argv = ["--steps", str(CLI_TRAIN_STEPS), "--publish", store]
        kops.reset_launches()                        # the main path starts
        got, rec["train_out"] = _quiet(train.main, argv)
        torch.cuda.synchronize()
        counts = kops.launches()                     # read just after
        L = load_published(ModelStore(store), "tinyllama-1.1b")[0].num_layers
    steps = CLI_TRAIN_STEPS
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=2 * L * steps,
                flash_attention_dq=L * steps, flash_attention_dkv=L * steps)
    rec["train_launches"] = {k: v for k, v in counts.items() if v}
    run.check("cli", f"launch.train {' '.join(argv[:2])}: launches (forward "
              f"2 x {L} x steps under remat, dq and dk/dv {L} x steps)",
              counts == want, launches=rec["train_launches"])
    (_, want_losses), _ = _quiet(lambda: train.train(
        "tinyllama-1.1b", steps=steps, batch=8, seq=128, device=DEVICE,
        backend="ref"))
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want_losses)]
    rec["train_losses"] = {"cuda": got, "ref": want_losses, "rel": rel}
    run.check("cli", f"launch.train losses equal a ref run's (rtol "
              f"{TRAIN_LOSS_RTOL})", len(rel) == steps
              and all(math.isfinite(x) for x in got)
              and max(rel) <= TRAIN_LOSS_RTOL, rel=rel)
    rec["rwkv6"] = _cli_arch(run, torch, np, RWKV_ARCH, SEED + 86,
                             {"rwkv6_chunked"}, lambda L, steps: {})
    rec["moe"] = _cli_arch(
        run, torch, np, MOE_ARCH, SEED + 87,
        {"flash_attention", "decode_attention"},
        lambda L, steps: {"flash_attention_fwd": 2 * L * steps,
                          "flash_attention_dq": L * steps,
                          "flash_attention_dkv": L * steps})
    rec["hybrid"] = _cli_arch(
        run, torch, np, HYBRID_ARCH, SEED + 89,
        {"flash_attention", "decode_attention"},
        lambda L, steps: {"flash_attention_fwd": 2 * L * steps,
                          "flash_attention_dq": L * steps,
                          "flash_attention_dkv": L * steps})
    # Whisper (2 encoder + 2 decoder layers): B9 in each encoder layer
    # and in each decoder layer's self- and cross-attention, the decoder
    # layers' forward twice under remat
    rec["audio"] = _cli_arch(
        run, torch, np, AUDIO_ARCH, SEED + 91,
        {"flash_attention", "decode_attention"},
        lambda L, steps: {"flash_attention_fwd": (L + 2 * 2 * L) * steps,
                          "flash_attention_dq": (L + 2 * L) * steps,
                          "flash_attention_dkv": (L + 2 * L) * steps})
    for arch in CLI_SERVE_ONLY:
        rec[arch] = _cli_arch(run, torch, np, arch, SEED + 88,
                              {"flash_attention", "decode_attention"}, None)
    emit(rec)
    return rec["serve_launches"], rec["train_launches"]


def kernel_layers(cfg):
    """The layers that launch a model kernel once per call: the hybrid's
    local-attention layers, every layer of the other families."""
    if cfg.family == "hybrid":
        from repro_torch.models import rglru
        return rglru._counts(cfg)[1]
    return cfg.num_layers


def _cli_arch(run, torch, np, arch, seed, serve_kernels, train_want):
    """The command lines on another family's reduced config: ``launch.serve
    --model arch`` on an empty store launches ``serve_kernels`` and
    nothing else, each a multiple of num_layers times, and its tokens
    equal a ``ref`` engine's on the bootstrapped weights; ``launch.train
    --arch arch`` launches ``train_want(num_layers, steps)`` and its
    losses equal a ``ref`` run's.  RWKV-6 (2 layers, 8 heads of N 32): B10
    in prefill, no kernel in training (the WKV is differentiated through
    the plain scan).  Granite-MoE (2 layers, 8/2 heads of 32, 4 experts
    top-2): B8 and B6 in serving, B9 in training.  RecurrentGemma (3
    layers of which one is local attention, 8/1 heads of 32, window 32):
    B8 and B6 in its attention layer, B9 in training; its counts are
    multiples of the attention layers (:func:`kernel_layers`).
    Whisper-medium (2 + 2 layers, 8/8 heads of 32, 64 zero frames): B8
    and B6 (self and cross) in serving, B9 in training.  With
    ``train_want`` None only the serve command line runs."""
    from repro_torch.checkpoint.ckpt import load_published
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve, train
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serving.engine import ServingEngine
    rec = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
        kops.reset_launches()                        # the main path starts
        _, rec["serve_out"] = _quiet(serve.main, [
            "--store", store, "--model", arch])
        torch.cuda.synchronize()
        counts = kops.launches()                     # read just after
        rec["serve_launches"] = {k: v for k, v in counts.items() if v}
        cfg, cpu_params, _ = load_published(ModelStore(store), arch)
        n_layers = kernel_layers(cfg)
        run.check("cli", f"launch.serve --model {arch} on an empty store: "
                  f"{sorted(serve_kernels)} {n_layers} x n times, "
                  "nothing else", set(rec["serve_launches"]) == serve_kernels
                  and all(v % n_layers == 0
                          for v in rec["serve_launches"].values()),
                  launches=rec["serve_launches"])
        params = tree_map(lambda p: p.to(DEVICE), cpu_params)
        outs = {}
        for backend in (None, "ref"):
            eng = ServingEngine(cfg, params, max_batch=4, cache_len=128,
                                attn_backend=backend, device=DEVICE)
            reqs = serve_requests(np, cfg, seed, n=4, max_new=16,
                                  lo=5, hi=100, shared_prefix=0)
            eng.generate_batch(reqs)
            outs[backend or "cuda"] = [r.output for r in reqs]
        run.check("cli", f"the bootstrapped {cfg.name}: greedy tokens on "
                  "cuda equal ref", outs["cuda"] == outs["ref"]
                  and all(len(o) == 16 for o in outs["cuda"]))
        rec["bootstrapped"] = {"num_layers": cfg.num_layers,
                               "head_dim": cfg.resolved_head_dim,
                               "tokens_equal_ref": outs["cuda"] == outs["ref"]}
    if train_want is None:
        return rec
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
        argv = ["--arch", arch, "--steps", str(CLI_TRAIN_STEPS),
                "--publish", store]
        kops.reset_launches()                        # the main path starts
        got, rec["train_out"] = _quiet(train.main, argv)
        torch.cuda.synchronize()
        rec["train_launches"] = {k: v for k, v in kops.launches().items()
                                 if v}                # read just after
    want = train_want(n_layers, CLI_TRAIN_STEPS)
    run.check("cli", f"launch.train --arch {arch}: launches {want}",
              rec["train_launches"] == want, launches=rec["train_launches"])
    (_, want), _ = _quiet(lambda: train.train(
        arch, steps=CLI_TRAIN_STEPS, batch=8, seq=128, device=DEVICE,
        backend="ref"))
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    rec["train_losses"] = {"cuda": got, "ref": want, "rel": rel}
    run.check("cli", f"launch.train --arch {arch} losses equal a ref "
              f"run's (rtol {TRAIN_LOSS_RTOL})", len(rel) == CLI_TRAIN_STEPS
              and all(math.isfinite(x) for x in got)
              and max(rel) <= TRAIN_LOSS_RTOL, rel=rel)
    return rec


def visible_pairs(s, window=0):
    """(query, key) pairs one causal head sees over s tokens: each query
    sees itself and the keys before it, at most ``window`` of them."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bound(kernel, b, s, h, kvh, d, elem=4, unit="fp32", window=0,
                sk=None, causal=True):
    """(seconds from bytes, seconds from operations) of one call at these
    shapes, causal (within ``window`` keys), or with ``causal`` False
    every one of ``sk`` keys (default s) for each of s queries: each
    input read once and each output
    written once; per visible (query, key) pair 2*D flops per product,
    2 products in the forward, 3 in dq (q.k, dO.v, ds.k), 4 in dk/dv
    (q.k, dO.v, p^T dO, ds^T q), at the fp32 peak, or with unit "3xtf32"
    three times as many at the TF32 tensor-core peak (the kernels' 3xTF32
    products)."""
    sk = s if sk is None else sk
    pairs = b * h * (visible_pairs(s, window) if causal else s * sk)
    q_bytes, kv_bytes, row_bytes = b * s * h * d * elem, b * sk * kvh * d * elem, b * h * s * 4
    if kernel in ("flash_attention", "flash_attention_fwd"):
        nbytes = 2 * q_bytes + 2 * kv_bytes
        nbytes += row_bytes if kernel == "flash_attention_fwd" else 0
        products = 2
    elif kernel == "flash_attention_dq":
        nbytes = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
        products = 3
    else:
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
        products = 4
    flops = 2 * d * products * pairs
    if unit == "3xtf32":
        return nbytes / PEAK_HBM_BYTES, 3 * flops / PEAK_TF32_FLOPS
    return nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS


TRAIN_GROUPS = (("flash_fwd", "flash forward (B9)"),
                ("flash_dq", "flash dq (B9)"),
                ("flash_dkv", "flash dk/dv (B9)"),
                ("gemm", "matmul (cuBLAS)"), ("Gemm", "matmul (cuBLAS)"),
                ("gemv", "matmul (cuBLAS)"))


def _profile_train_step(torch, cfg, params, opt, state, batch):
    """Device time by part over one train step (torch.profiler): the
    optimizer's kernels are those that start after a synchronize placed
    between the backward and ``opt.update``; the idle share counts that
    synchronize.  The profiler also puts the "optimizer" range itself on
    the device timeline; it is a span over kernels, not one, and is not
    summed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import models
    from repro_torch.optim.adamw import tree_items, tree_map
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = models.get_module(cfg).loss_fn(cfg, params, batch)
        it = iter(torch.autograd.grad(loss, [p for _, p in
                                             tree_items(params)]))
        grads = tree_map(lambda p: next(it), params)
        torch.cuda.synchronize()
        with record_function("optimizer"):
            opt.update(grads, state, params)
        float(loss.detach())
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = list(prof.events())
    opt_start = min(e.time_range.start for e in events
                    if e.name == "optimizer")
    parts, spans = {}, []
    for e in events:
        if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                or e.name == "optimizer":
            continue
        spans.append((e.time_range.start, e.time_range.start + e.device_time))
        if e.time_range.start >= opt_start:
            part = "optimizer (AdamW)"
        else:
            part = next((p for key, p in TRAIN_GROUPS if key in e.name),
                        "other (norms, RoPE, SiLU, loss, copies)")
        parts[part] = parts.get(part, 0.0) + e.device_time
    busy, end = 0.0, float("-inf")          # the union of kernel spans
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"wall_ms_per_step": wall_us / 1e3,
            "device_ms_per_step": busy / 1e3 if spans else "not measured",
            "device_kernel_ms_sum": sum(parts.values()) / 1e3,
            "device_idle_share": 1 - busy / wall_us if spans
            else "not measured",
            "device_kernels_per_step": len(spans),
            "device_ms_by_part": {k: v / 1e3 for k, v in parts.items()}}


def train_step_record(torch, tiny_np):
    """TinyLlama-1.1B, batch 4 x 2048, from the numpy tree: train tokens/s
    over 3 steps of make_train_step after a warm one (host clock around
    synchronised steps), and device time per step by part and the idle
    share (torch.profiler over one step)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim.adamw import AdamW, cosine_schedule, tree_map
    cfg = get_config("tinyllama-1.1b")
    kw = TRAIN[cfg.name]
    b, s = kw["batch"], kw["seq"]
    params = tree_map(lambda p: p.requires_grad_(),
                      params_from_numpy(tiny_np, DEVICE, cfg=cfg))
    opt = AdamW(lr=cosine_schedule(3e-4, 20, 100))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                  global_batch=b, seed=SEED))
    params, state, m = step_fn(params, state, to_device(data.batch(0), DEVICE))
    float(m["loss"])                                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(1, 4):
        params, state, m = step_fn(params, state,
                                   to_device(data.batch(step), DEVICE))
        float(m["loss"])                             # the trainer's one read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"model": cfg.name, "batch": b, "seq": s, "timed_steps": 3,
           "train_tokens_per_s": 3 * b * s / wall,
           "step_s": wall / 3,
           "step_profile": _profile_train_step(
               torch, cfg, params, opt, state,
               to_device(data.batch(4), DEVICE))}
    del params, state, m, step_fn
    torch.cuda.empty_cache()
    return rec


def _b8_prefill_times(torch, randn, h, kvh, d, sq=PREFILL_SEQ, window=0,
                      sk=None, causal=True):
    """B8 at the serving prefill's shape (one 300-token prompt, fp32,
    causal, or local within ``window`` keys; or, with ``causal`` False,
    ``sq`` queries against all of ``sk`` keys): events ms and device µs
    against the bound, the plain version and SDPA's forward on the same
    inputs (K/V heads repeated outside the timing; a window past the
    prompt's start as a boolean mask)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    sk = sq if sk is None else sk
    q, k, v = randn(1, sq, h, d), randn(1, sk, kvh, d), randn(1, sk, kvh, d)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()

    mask = None
    if window and window < sq:
        i = torch.arange(sq, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def fn():
        return kops.flash_attention(q, k, v, causal=causal, window=window)

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)
    bound = dict(window=window, sk=sk, causal=causal)
    b_s, o_s = flash_bound("flash_attention", 1, sq, h, kvh, d, unit="3xtf32",
                           **bound)
    return {"ms": time_ms(torch, fn), "device_us": device_us(torch, fn)[0],
            "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window)),
            "library_ms": time_ms(torch, sdpa),
            "library_device_us": device_us(torch, sdpa)[0],
            "library_vs_kernel_max_abs": float(
                (sdpa().transpose(1, 2) - fn()).abs().max()),
            "bound_ms": 1e3 * max(b_s, o_s),
            "bound_by": "bytes" if b_s >= o_s else "operations",
            "bound_ffma_ms": 1e3 * flash_bound("flash_attention", 1, sq, h,
                                               kvh, d, **bound)[1],
            "shape": {"batch": 1, "seq": sq, "keys": sk, "heads": h,
                      "kv_heads": kvh, "head_dim": d, "causal": causal,
                      "window": window, "dtype": "float32"}}


def phase_train_times(run, torch, np, tiny_np, card):
    """TinyLlama-1.1B, batch 4 x 2048: train_step_record; then B8 and each
    B9 kernel per launch at the train shapes (events ms, device µs)
    against the bound, the plain version and the library (SDPA forward;
    the efficient-attention backward for dq and dk/dv); then B8 at the
    serving prefill's shape (1 x 300) beside SDPA there."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    set_fp32_exact(torch)
    cfg = get_config("tinyllama-1.1b")
    b, s = TRAIN[cfg.name]["batch"], TRAIN[cfg.name]["seq"]
    rec = {"phase": "train_times", "card": card["nvidia_smi"],
           **train_step_record(torch, tiny_np)}

    # each kernel at the train shapes: random fp32 inputs, causal
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 95)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=DEVICE)
    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v = randn(b, s, kvh, d), randn(b, s, kvh, d)
    o, lse = fa.flash_fwd_lse(q, k, v)
    res = (q, k, v, do, lse, fa.dsum_of(o, do))
    calls = {
        "flash_attention": (lambda: kops.flash_attention(q, k, v),
                            lambda: ref.flash_attention_ref(q, k, v)),
        "flash_attention_fwd": (lambda: fa.flash_fwd_lse(q, k, v),
                                lambda: ref.flash_fwd_lse_ref(q, k, v)),
        "flash_attention_dq": (lambda: fa.flash_dq(*res),
                               lambda: ref.flash_dq_ref(*res)),
        "flash_attention_dkv": (lambda: fa.flash_dkv(*res),
                                lambda: ref.flash_dkv_ref(*res)),
    }
    # the library: SDPA on (B, H, S, D) with K/V heads repeated outside
    # the timing (the memory-efficient backend takes fp32 and no GQA)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_err = float((sdpa().transpose(1, 2) - o).abs().max())
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(out, leaves, dot)
    # the library's backward alone: one call gives dq, dk and dv per query
    # head from the forward's saved (out, lse), as dq and dk/dv do together
    # (the group sum of dk/dv is left out of the timing)
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    out_l, lse_l, seed_l, off_l = eff(qt, kt, vt, None, True, 0.0, True)

    def sdpa_bwd():
        return torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            dot, qt, kt, vt, None, out_l, lse_l, seed_l, off_l, 0.0,
            [True, True, True, False], True)
    dq_l, dk_l, dv_l, _ = sdpa_bwd()
    g = h // kvh
    lib_grads = (dq_l.transpose(1, 2),
                 dk_l.transpose(1, 2).reshape(b, s, kvh, g, d).sum(3),
                 dv_l.transpose(1, 2).reshape(b, s, kvh, g, d).sum(3))
    mine = (fa.flash_dq(*res),) + fa.flash_dkv(*res)
    lib_bwd_rel = max(float((x - y).norm() / y.norm())
                      for x, y in zip(lib_grads, mine))
    del dq_l, dk_l, dv_l, lib_grads, mine
    sdpa_ms = time_ms(torch, sdpa, iters=5, reps=3)
    sdpa_bwd_ms = time_ms(torch, sdpa_bwd, iters=3, reps=3)
    sdpa_fb_ms = time_ms(torch, sdpa_fwd_bwd, iters=3, reps=3)
    run.check("train_times", "SDPA computes the kernel's function "
              "(atol 1e-4)", lib_err <= 1e-4, err=lib_err)
    run.check("train_times", "the library backward computes the kernels' "
              f"dq, dk, dv (||d|| / ||g|| <= {TRAIN_GRAD_REL})",
              lib_bwd_rel <= TRAIN_GRAD_REL, rel=lib_bwd_rel)
    kernels = {}
    sdpa_dev = device_us(torch, sdpa, n=5)[0]
    sdpa_bwd_dev = device_us(torch, sdpa_bwd, n=3)[0]
    for name, (fn, plain) in calls.items():
        bwd = name in ("flash_attention_dq", "flash_attention_dkv")
        # every product runs 3xTF32 on the tensor cores (the forward on
        # wgmma, the backward on mma.sync): the bound is at the TF32 peak;
        # the FFMA figure stays beside it
        b_s, o_s = flash_bound(name, b, s, h, kvh, d, unit="3xtf32")
        kernels[name] = {
            "ms": time_ms(torch, fn, iters=5, reps=3),
            "device_us": device_us(torch, fn, n=5)[0],
            "library_device_us": sdpa_bwd_dev if bwd else sdpa_dev,
            "bound_unit": "3xTF32 at the TF32 peak",
            "bound_ffma_ms": 1e3 * flash_bound(name, b, s, h, kvh, d)[1],
            "plain_ms": time_ms(torch, plain, iters=1, reps=3),
            "library_ms": sdpa_bwd_ms if bwd else sdpa_ms,
            "library_call": "_scaled_dot_product_efficient_attention_backward "
                            "(dq, dk and dv in one call)" if bwd
            else "scaled_dot_product_attention (forward)",
            "library_fwd_bwd_ms": sdpa_fb_ms,
            "bytes_s": b_s, "ops_s": o_s, "bound_ms": 1e3 * max(b_s, o_s),
            "bound_by": "bytes" if b_s >= o_s else "operations",
            "shape": {"batch": b, "seq": s, "heads": h, "kv_heads": kvh,
                      "head_dim": d, "causal": True, "dtype": "float32"}}
    kernels["flash_attention"]["prefill"] = _b8_prefill_times(
        torch, randn, h, kvh, d)
    rec["kernels"] = kernels
    rec["sdpa_fwd_ms"], rec["sdpa_fwd_bwd_ms"] = sdpa_ms, sdpa_fb_ms
    rec["sdpa_bwd_ms"] = sdpa_bwd_ms
    rec["sdpa_vs_kernel_max_abs"] = lib_err
    rec["sdpa_bwd_vs_kernels_rel"] = lib_bwd_rel
    emit(rec)
    return kernels


# ---------------------------------------------------------------------------
# slice 4: RWKV-6 Finch 3B serving on B10, and the meta-selector
# ---------------------------------------------------------------------------

WKV_SOURCE = ("src/repro_torch/kernels/csrc/rwkv6_chunk.cu",
              "src/repro/kernels/rwkv6_chunk.py:73")
WKV_BATCHES = (1, 4, 8)
WKV_SEQS = (1, 5, 16, 33, 300, 2048)
WKV_HEADS = ((40, 64), (8, 32))      # RWKV-6 3B's (H, N), the reduced one's
# rtol, atol against the plain version evaluated in fp64 on the same fp32
# inputs: the kernel computes in fp64 and rounds once, while the fp32 plain
# version is itself ~1e-5 off near cancellations and ~1e-3 off where w = 0
# puts |cum| near 1000 (fp32 spacing ~6e-5 in the exponents)
WKV_TOL = (1e-4, 1e-5)
# B10 timed at the serving prefill's shape and at a long batched one
WKV_TIMES = ((1, 300, 40, 64), (8, 2048, 40, 64))
# B10 on a bf16 RWKV-6's inputs, bf16 r, k, v beside the fp32 decay: out
# (bf16, rounded once) against the fp64 plain version at the all-bf16 bar
# of tests/test_torch_cuda.py, the fp32 state at WKV_TOL
WKV_BF16_OUT_TOL = (4e-3, 1e-3)
# a bf16 RWKV-6 layer's time-mix output, cuda against ref on the same
# input (its fp32 state at RWKV_TOL): the bf16 bar of the serve phases
# (FLASH_TOL["bfloat16"])
RWKV_BF16_TOL = (2e-2, 3e-2)
RWKV_BF16_PROMPT = 300
RWKV_BF16_NEW = 8          # greedy tokens after the bf16 prefill
RWKV_ARCH = "rwkv6-3b"
RWKV_TOL = 1e-4             # a layer's prefill output and state, cuda vs ref
SELECTOR_MODELS = ("tinyllama-1.1b", "qwen3-0.6b", RWKV_ARCH)


def wkv_inputs(torch, gen, b, t, h, n, w_zero=False):
    """r, k, v ~ N(0, 1) drawn separately (r != k), decays uniform in
    (0, 1) with every third token's exactly 0 when ``w_zero``, and the
    bonus u, on the card."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)
    r, k, v = randn(b, t, h, n), randn(b, t, h, n), randn(b, t, h, n)
    w = torch.rand(b, t, h, n, generator=gen, device=DEVICE)
    if w_zero:
        w[:, ::3] = 0.0
    return [r, k, v, w, randn(h, n)]


def wkv_flops(b, t, h, n, c=16):
    """Operations of one B10 call, per (batch, head, chunk) of c tokens:
    the c(c-1)/2 pairs j < i (r*k*exp(.) summed over N: 4N, the exp
    counted as one), the c diagonal bonus terms (3N), att.v over the
    c(c+1)/2 pairs j <= i (2N), the decayed r and k (2 * 2cN), the
    inter-chunk product (r decayed).S (2cN^2) and the state update
    (2cN^2 + N^2)."""
    pairs, tri = c * (c - 1) // 2, c * (c + 1) // 2
    per_chunk = (4 * n * pairs + 3 * n * c + 2 * n * tri + 4 * c * n
                 + 4 * c * n * n + n * n)
    return b * h * (-(-t // c)) * per_chunk


def wkv_bytes(b, t, h, n, elem=4, w_elem=None):
    """Bytes B10 must move: r, k, v (``elem`` bytes an element), w
    (``w_elem``, default ``elem``) and the fp32 u read once, out (in r's
    dtype) and the fp32 state written once."""
    bthn = b * t * h * n
    return (4 * elem * bthn + (w_elem or elem) * bthn + 4 * h * n
            + 4 * b * h * n * n)


def wkv_mixed_inputs(torch, gen, b, t, h, n):
    """wkv_inputs with r, k, v in bf16 and w in fp32: a bf16 RWKV-6's."""
    x = wkv_inputs(torch, gen, b, t, h, n)
    return [y.bfloat16() for y in x[:3]] + x[3:]


def phase_wkv_kernels(run, torch):
    """B10 against its plain version evaluated in fp64 on the same inputs:
    B 1, 4 and 8, T 1 to 2048, RWKV-6 3B's heads (40 of 64) and the
    reduced config's (8 of 32), decays in (0, 1), and at B 4 also with
    w = 0 entries.  ``out`` is the head of a NaN-filled buffer and the
    state NaN-filled: every row < T and every state entry must be
    written, nothing past them.  The kernel's and the fp32 plain
    version's distance from the fp64 one are reported side by side (max
    and rms over every out element).  Then wkv_bit_checks."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_chunk as rw
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 80)
    rtol, atol = WKV_TOL
    s = {"checks": 0, "failed": 0, "max_abs_err": 0.0,
         "fp32_plain_max_abs_err": 0.0, "rtol": rtol, "atol": atol,
         "reference": "the plain version (wkv_chunked) in fp64"}
    sq = {"kernel": [0.0, 0], "fp32_plain": [0.0, 0]}
    for h, n in WKV_HEADS:
        for b in WKV_BATCHES:
            for t in WKV_SEQS:
                for w_zero in ((False, True) if b == 4 else (False,)):
                    x = wkv_inputs(torch, gen, b, t, h, n, w_zero)
                    size = b * t * h * n
                    buf = torch.full((size + 4096,), math.nan, device=DEVICE)
                    out = buf[:size].view(b, t, h, n)
                    state = torch.full((b, h, n, n), math.nan, device=DEVICE)
                    rw.rwkv6_chunked_into(*x, out, state)
                    want = ref.rwkv6_chunked_ref(*(y.double() for y in x))
                    plain = ref.rwkv6_chunked_ref(*x)
                    torch.cuda.synchronize()
                    case = f"B={b} T={t} H={h} N={n} w0={w_zero}"
                    for what, got, w64, w32 in zip(("out", "state"),
                                                   (out, state), want, plain):
                        err, bad = compare(torch, got, w64, rtol, atol)
                        s["checks"] += 1
                        s["max_abs_err"] = max(s["max_abs_err"], err)
                        s["fp32_plain_max_abs_err"] = max(
                            s["fp32_plain_max_abs_err"],
                            float((w32.double() - w64).abs().max()))
                        if what == "out":
                            for key, y in (("kernel", got), ("fp32_plain", w32)):
                                sq[key][0] += float(
                                    (y.double() - w64).pow(2).sum())
                                sq[key][1] += y.numel()
                        if not run.check("wkv_kernels", f"{case} {what} "
                                         f"(rtol {rtol}, atol {atol})",
                                         bad == 0, max_abs_err=err,
                                         mismatches=bad):
                            s["failed"] += 1
                    s["checks"] += 1
                    if not run.check("wkv_kernels", f"{case}: nothing "
                                     "written past T",
                                     bool(torch.isnan(buf[size:]).all())):
                        s["failed"] += 1
                    del x, buf, out, state, want, plain
    s["rms_err_fp64"] = {k: math.sqrt(v[0] / v[1]) for k, v in sq.items()}
    s["bit_checks"] = wkv_bit_checks(run, torch, gen)
    s["bf16_fp32_decay"] = wkv_mixed_checks(run, torch, gen)
    run.max_err["rwkv6_chunked"] = s["max_abs_err"]
    emit({"phase": "wkv_kernels", "result": s})


def wkv_mixed_checks(run, torch, gen):
    """B10 on bf16 r, k, v beside an fp32 decay at WKV_TIMES' shapes:
    out (bf16) at WKV_BF16_OUT_TOL and the state at WKV_TOL against the
    plain version in fp64 on the same inputs, and a rerun bit-equal."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    out = {}
    for b, t, h, n in WKV_TIMES:
        x = wkv_mixed_inputs(torch, gen, b, t, h, n)
        o, st = kops.rwkv6_chunked(*x)
        o2, st2 = kops.rwkv6_chunked(*x)
        want = ref.rwkv6_chunked_ref(*(y.double() for y in x))
        torch.cuda.synchronize()
        case = f"bf16 r, k, v beside fp32 w, B={b} T={t} H={h} N={n}"
        errs = {}
        for what, got, w64, dtype, (rtol, atol) in (
                ("out", o, want[0], torch.bfloat16, WKV_BF16_OUT_TOL),
                ("state", st, want[1], torch.float32, WKV_TOL)):
            err, bad = compare(torch, got, w64, rtol, atol)
            errs[what] = err
            run.check("wkv_kernels", f"{case}: {what} in {dtype} (rtol "
                      f"{rtol}, atol {atol})", bad == 0 and got.dtype == dtype,
                      max_abs_err=err, mismatches=bad)
        run.check("wkv_kernels", f"{case}: a rerun bit-equal",
                  torch.equal(o, o2) and torch.equal(st, st2))
        out[f"{b}x{t}x{h}x{n}"] = errs
        del x, o, st, o2, st2, want
    return out


def wkv_bit_checks(run, torch, gen):
    """B10's arithmetic does not depend on the batch or the alignment: at
    T at and around the chunk edges a rerun is bit-equal, a lane run
    alone equals the same lane in a batch of 3, and inputs that do not
    start on 16 bytes (the plain-load path) give the same bits."""
    from repro_torch.kernels import ops as kops
    checks = 0
    for h, n in WKV_HEADS:
        for t in (15, 16, 17, 33, 300):
            x = wkv_inputs(torch, gen, 3, t, h, n, w_zero=t % 2 == 1)
            o, st = kops.rwkv6_chunked(*x)
            o2, st2 = kops.rwkv6_chunked(*x)
            lone = kops.rwkv6_chunked(*(y[1:2] for y in x[:4]), x[4])
            shifted = [torch.cat([y.new_zeros(1), y.flatten()])[1:].view(
                y.shape) for y in x[:4]]
            odd = kops.rwkv6_chunked(*shifted, x[4])
            cases = {"rerun": (o2, st2), "unaligned inputs": odd}
            torch.cuda.synchronize()
            for what, (go, gs) in cases.items():
                checks += 1
                run.check("wkv_kernels", f"T={t} N={n}: {what} bit-equal",
                          torch.equal(go, o) and torch.equal(gs, st))
            checks += 1
            run.check("wkv_kernels", f"T={t} N={n}: a lane alone equals the "
                      "lane in a batch of 3", torch.equal(lone[0], o[1:2])
                      and torch.equal(lone[1], st[1:2]))
    return checks


def phase_wkv_times(run, torch, card):
    """B10 per launch (CUDA events, median of 7 x 20; device µs of both
    passes and of each under torch.profiler) at the serving prefill's
    shape and at 8 x 2048, against its bound and its plain version.  No
    single PyTorch call computes the WKV recurrence, so there is no
    library time."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_chunk as rw
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 81)
    out = {}
    for (b, t, h, n), mixed in itertools.product(WKV_TIMES, (False, True)):
        x = (wkv_mixed_inputs if mixed else wkv_inputs)(torch, gen, b, t, h,
                                                         n)
        ms = time_ms(torch, lambda: kops.rwkv6_chunked(*x))
        plain_ms = time_ms(torch, lambda: ref.rwkv6_chunked_ref(*x), iters=2,
                           reps=3)
        parts = device_us_by(torch, lambda: kops.rwkv6_chunked(*x),
                             ("wkv_prepare", "wkv_scan", ""))
        us = parts and parts.pop("")
        p = rw.plan(b, t, h, n)
        nbytes = wkv_bytes(b, t, h, n, *((2, 4) if mixed else ()))
        b_s = nbytes / PEAK_HBM_BYTES
        o_s = wkv_flops(b, t, h, n) / PEAK_FP32_FLOPS
        rec = {"shape": [b, t, h, n], "ms": ms, "plain_ms": plain_ms,
               "dtypes": "bf16 r, k, v, fp32 w" if mixed else "fp32",
               "device_us": us, "device_us_by_pass": parts, "mb": p.mb,
               "ctas": {"prepare": p.prep_grid[0] * h * b,
                        "scan": p.grid[0] * h * b},
               "workspace_bytes": p.workspace,
               "bytes": nbytes, "flops": wkv_flops(b, t, h, n),
               "bound_ms": 1e3 * max(b_s, o_s),
               "bound_by": "bytes" if b_s >= o_s else "operations",
               "library_ms": None}
        rec["ms_over_bound"] = ms / rec["bound_ms"]
        rec["share_of_bound"] = us and rec["bound_ms"] * 1e3 / us
        out[f"{b}x{t}x{h}x{n}" + ("_bf16_w32" if mixed else "")] = rec
        del x
    emit({"phase": "wkv_times", "card": card["nvidia_smi"], "times": out})
    return out


def rwkv_prefill_profile(torch, cfg, params, toks):
    """One prompt's full prefill (``rwkv6.prefill`` on the kernels, under
    inference mode): device ms by part, B10 (kernels named ``wkv_``)
    beside the rest, traced as :func:`device_us` traces (a warm call
    first, then the counted one)."""
    from repro_torch.models import rwkv6 as rw6

    def call():
        with torch.inference_mode():
            rw6.prefill(cfg, params, toks, SERVE_CACHE_LEN)
    parts = device_us_by(torch, call, ("wkv_", ""), n=2, warm=1)
    if parts is None:
        return None
    return {"prompt": int(toks.shape[1]), "layers": cfg.num_layers,
            "device_ms": parts[""] / 1e3, "b10_ms": parts["wkv_"] / 1e3,
            "other_ms": (parts[""] - parts["wkv_"]) / 1e3}


def _kernel_time_by_part(prof, ticks, wall_us):
    """Device time per step by part from a profile whose WKV steps ran
    inside ``record_function("wkv_step")`` ranges: the kernels launched
    in those ranges are the WKV step, the other cuBLAS kernels the
    matmuls, the rest other work."""
    events = prof.events()
    total_us = gemm_us = 0.0
    kernels = 0
    calls = {}
    for e in events:
        if e.name in HOST_LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
        if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                or e.name == "wkv_step":
            continue
        kernels += 1
        total_us += e.device_time
        if any(key in e.name for key in ("gemm", "Gemm", "gemv")):
            gemm_us += e.device_time

    def under(e):
        yield from e.kernels
        for c in e.cpu_children:
            yield from under(c)
    wkv = [k for e in events if e.name == "wkv_step"
           and not str(getattr(e, "device_type", "")).endswith("CUDA")
           for k in under(e)]
    wkv_us = sum(k.duration for k in wkv)
    wkv_gemm_us = sum(k.duration for k in wkv
                      if any(key in k.name for key in ("gemm", "Gemm", "gemv")))
    parts = {"matmul (cuBLAS)": (gemm_us - wkv_gemm_us) / ticks,
             "WKV step (wkv_step: outer product, einsum, decay)":
                 wkv_us / ticks,
             "other (norms, ddlerp, group norm, sampling)":
                 (total_us - gemm_us - wkv_us + wkv_gemm_us) / ticks}
    return {"ticks": ticks, "wall_ms_per_step": wall_us / ticks / 1e3,
            "device_ms_per_step": total_us / ticks / 1e3,
            "device_idle_share": 1 - total_us / wall_us,
            "device_kernels_per_step": kernels / ticks,
            "host_launch_calls_per_step": {k: v / ticks
                                           for k, v in calls.items()},
            "wkv_step_attributed": bool(wkv),
            "device_ms_by_part": {k: v / 1e3 for k, v in parts.items()}}


def _profile_rwkv_ticks(torch, sched, ticks):
    """``ticks`` decode ticks with every lane live under torch.profiler,
    each layer's WKV step in a ``wkv_step`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import rwkv6 as rw6
    step = rw6.wkv_step

    def traced(*args):
        with record_function("wkv_step"):
            return step(*args)
    rw6.wkv_step = traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                sched.tick()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        rw6.wkv_step = step
    return _kernel_time_by_part(prof, ticks, wall_us)


def _prefill_layerwise(torch, cfg, params, toks):
    """Each layer's time mix on the ``ref`` trajectory's input, through
    B10 and through the plain version: (what, max abs error, count out of
    RWKV_TOL) of its output and of its wkv state, per layer."""
    from repro_torch.models import common as cm
    from repro_torch.models import rwkv6 as rw6
    out = []
    with torch.inference_mode():
        x = params["embed"][toks]
        for l in range(cfg.num_layers):
            lp = rw6._layer(params, l)
            xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, _, s = rw6.time_mix(cfg, lp, xn)
            a_ref, _, s_ref = rw6.time_mix(cfg, lp, xn, backend="ref")
            out.append(("time_mix_out",
                        *compare(torch, a, a_ref, RWKV_TOL, RWKV_TOL)))
            out.append(("wkv", *compare(torch, s, s_ref, RWKV_TOL, RWKV_TOL)))
            x = x + a_ref
            c, _ = rw6.channel_mix(cfg, lp, cm.rms_norm(x, lp["ln2"],
                                                        cfg.norm_eps))
            x = x + c
    return out


def _prefill_end_to_end(torch, cfg, params, toks, noise=1e-7):
    """Relative distance of the full prefill's logits and wkv state, cuda
    against ref, beside the distance of two ``ref`` prefills whose
    embeddings differ by a relative ``noise`` (1e-7: fp32 rounding; 2^-8
    for bf16 weights): the model's own sensitivity, which a kernel cannot
    undercut."""
    from repro_torch.models import common as cm
    from repro_torch.models import rwkv6 as rw6

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    def run_layers(x, backend):
        states = []
        for l in range(cfg.num_layers):
            lp = rw6._layer(params, l)
            a, _, s = rw6.time_mix(cfg, lp, cm.rms_norm(
                x, lp["ln1"], cfg.norm_eps), backend=backend)
            x = x + a
            c, _ = rw6.channel_mix(cfg, lp, cm.rms_norm(
                x, lp["ln2"], cfg.norm_eps))
            x = x + c
            states.append(s)
        return rw6._logits(cfg, params, x), torch.stack(states)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 94)
    with torch.inference_mode():
        x0 = params["embed"][toks]
        noisy = (x0 * (1 + noise * torch.randn(x0.shape, generator=gen,
                                                device=DEVICE))).to(x0.dtype)
        lg, st = run_layers(x0, None)
        lg_ref, st_ref = run_layers(x0, "ref")
        lg_noisy, st_noisy = run_layers(noisy, "ref")
    return {"noise": noise, "logits_rel_cuda_vs_ref": rel(lg, lg_ref),
            "logits_rel_ref_noise": rel(lg_noisy, lg_ref),
            "wkv_rel_cuda_vs_ref": rel(st, st_ref),
            "wkv_rel_ref_noise": rel(st_noisy, st_ref),
            "logits_max_abs_cuda_vs_ref": float((lg - lg_ref).abs().max())}


def rwkv_bf16_prefill(run, torch, np, cfg, params):
    """RWKV-6 Finch 3B at full width in bf16 (the fp32 weights cast, 6.2
    GB), a RWKV_BF16_PROMPT-token prompt: B10 takes bf16 r, k, v beside
    the fp32 decay.  Each layer's time mix on the ``ref`` trajectory's
    input, cuda against ref: the bf16 output within RWKV_BF16_TOL, the
    fp32 wkv state within RWKV_TOL as in the fp32 prefill (its largest
    magnitude recorded); a full prefill launches B10 once a layer (none
    on ``ref``).  End to end, the logits and the state, cuda against
    ref, must lie no farther apart than ``ref`` lies from itself after a
    one-bf16-step (2^-8) change of its embeddings (_prefill_end_to_end):
    the kernels may not move the model more than its own bf16 rounding
    does.  Reported, not held: RWKV_BF16_NEW greedy tokens on each
    backend (the first parting and ref's fp32 logit gap there); at full
    depth a random bf16 model parts at its first token however the WKV
    rounds (PERF.md §6)."""
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.kernels import ops as kops
    from repro_torch.models import common as cm
    from repro_torch.models import rwkv6 as rw6
    bf = tree_map(lambda t: t.to(torch.bfloat16), params)
    L = cfg.num_layers
    toks = torch.from_numpy(np.random.default_rng(SEED + 97).integers(
        1, cfg.vocab_size, (1, RWKV_BF16_PROMPT))).to(DEVICE)
    tols = {"time_mix_out": RWKV_BF16_TOL, "wkv": (RWKV_TOL, RWKV_TOL)}
    worst = {"time_mix_out": 0.0, "wkv": 0.0}
    state_max = 0.0
    bad_layers = []
    out = {"prompt": RWKV_BF16_PROMPT, "weights_bytes": sum(
        t.numel() * t.element_size() for t in tree_leaves(bf))}
    with torch.inference_mode():
        x = bf["embed"][toks]
        for l in range(L):
            lp = rw6._layer(bf, l)
            xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, _, st = rw6.time_mix(cfg, lp, xn)
            a_ref, _, st_ref = rw6.time_mix(cfg, lp, xn, backend="ref")
            state_max = max(state_max, float(st_ref.abs().max()))
            for key, got, want in (("time_mix_out", a, a_ref),
                                   ("wkv", st, st_ref)):
                err, bad = compare(torch, got, want, *tols[key])
                worst[key] = max(worst[key], err)
                if bad:
                    bad_layers.append([l, key, bad, err])
            x = x + a_ref
            x = x + rw6.channel_mix(cfg, lp, cm.rms_norm(
                x, lp["ln2"], cfg.norm_eps))[0]
        run.check("serve_rwkv6", f"bf16 prefill of {RWKV_BF16_PROMPT}: every "
                  "layer's time-mix output (rtol, atol "
                  f"{tols['time_mix_out']}) and wkv state ({tols['wkv']}) on "
                  "the same input, cuda vs ref", not bad_layers,
                  worst=worst, state_max_abs=state_max, bad=bad_layers[:8])
        streams = {}
        for backend in (None, "ref"):
            before = kops.launches()["rwkv6_chunked"]
            lg, cache = rw6.prefill(cfg, bf, toks, SERVE_CACHE_LEN,
                                    backend=backend)
            launched = kops.launches()["rwkv6_chunked"] - before
            tag = backend or "cuda"
            run.check("serve_rwkv6", f"bf16 prefill on {tag}: B10 launched "
                      f"{L if backend is None else 0} times",
                      launched == (L if backend is None else 0),
                      launches=launched)
            out[f"{tag}_launches"] = launched
            tokens, logits = [], []
            pos = RWKV_BF16_PROMPT
            for _ in range(RWKV_BF16_NEW):
                last = lg[0, -1].float()
                tokens.append(int(last.argmax()))
                logits.append(last)
                lg, cache = rw6.decode_step(
                    cfg, bf, torch.tensor([[tokens[-1]]], device=DEVICE),
                    cache, pos)
                pos += 1
            streams[tag] = (tokens, logits)
    (got, _), (want, ref_logits) = streams["cuda"], streams["ref"]
    part = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None)
    gap = None if part is None else float(
        ref_logits[part][want[part]] - ref_logits[part][got[part]])
    e2e = _prefill_end_to_end(torch, cfg, bf, toks, noise=2.0 ** -8)
    for what in ("logits", "wkv"):
        run.check("serve_rwkv6", f"bf16 prefill end to end: the {what}, "
                  "cuda vs ref, no farther apart than ref from itself after "
                  "a 2^-8 change of the embeddings",
                  e2e[f"{what}_rel_cuda_vs_ref"]
                  <= e2e[f"{what}_rel_ref_noise"],
                  cuda_vs_ref=e2e[f"{what}_rel_cuda_vs_ref"],
                  ref_noise=e2e[f"{what}_rel_ref_noise"])
    out.update({"layerwise_max_abs": worst, "tolerances": tols,
                "state_max_abs": state_max,
                "tokens_cuda": got, "tokens_ref": want,
                "first_parting": part, "gap": gap, "end_to_end": e2e})
    del bf
    return out


def phase_serve_rwkv6(run, torch, np, card):
    """RWKV-6 Finch 3B at full width (32 layers, d 2560, 40 heads of 64,
    3.10 B parameters, fp32) through ServingEngine at batch 8: the 16
    greedy requests of serve_requests on the kernels (B10 in prefill)
    and on ``ref``, tokens equal; B10 launches 32 x full prefills and
    none on ``ref``; 8 ticks under sync debug mode "error"; paged asked
    for, ring kept; int8 asked for, state unchanged.  The prefill of 4
    prompts: every layer's time-mix output and wkv state on both
    backends from the same input within 1e-4, and the end-to-end logits
    and state reported beside the model's own sensitivity (at full
    depth, a relative 1e-7 change of the embeddings moves the logits by
    1e-3 to 1e-1, so no fp32 evaluation holds an end-to-end 1e-4).  Both
    runs replay the captured decode step; the kernels' run is held to the
    same requests on the kernels under ``disable_graphs()``
    (graph_against_eager), and so are 8 requests sampled at GRAPH_TEMP.
    Then a warm run's decode tokens/s, TTFT and prefill
    seconds, a replayed decode step (device ms, idle share, host launch
    calls) and, eagerly, a decode step's device time by part.  Last, the
    same weights in bf16 (rwkv_bf16_prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.jit import disable_graphs
    from repro_torch.kernels import ops as kops
    from repro_torch.models import rwkv6 as rw6
    from repro_torch.serving.engine import ServingEngine
    set_fp32_exact(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(RWKV_ARCH)
    t0 = time.perf_counter()
    np_params = numpy_weights(np, cfg, SEED + 3)
    t_make = time.perf_counter() - t0
    params = params_from_numpy(np_params, DEVICE, cfg=cfg)   # leaf by leaf
    del np_params
    torch.cuda.synchronize()
    emit({"phase": "serve_rwkv6", "model": cfg.name,
          "params": cfg.param_count(), "weights_make_s": t_make,
          "weights_to_device_s": time.perf_counter() - t0 - t_make})
    L = cfg.num_layers
    outs, recs, caches = {}, {}, {}
    kops.reset_launches()                            # the main path starts
    for backend in (None, "ref"):
        window = sync_window(torch) if backend is None else None
        eng = ServingEngine(cfg, params, max_batch=8,
                            cache_len=SERVE_CACHE_LEN, attn_backend=backend,
                            faults=window, device=DEVICE)
        reqs = serve_requests(np, cfg, SEED + 90)
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
        tag = backend or "cuda"
        launched = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        want = {"rwkv6_chunked": L * len(reqs)} if backend is None else {}
        run.check("serve_rwkv6", f"{tag}: B10 launches = {L} x full "
                  "prefills, no other kernel", launched == want,
                  launches=launched)
        run.check("serve_rwkv6", f"{tag}: host_syncs == retired requests",
                  sched.host_syncs == len(reqs), host_syncs=sched.host_syncs)
        run.check("serve_rwkv6", f"{tag}: the decode step was captured",
                  sched._graph is not None)
        run.check("serve_rwkv6", f"{tag}: every request generated "
                  f"{SERVE_MAX_NEW} tokens", all(
                      len(r.output) == SERVE_MAX_NEW and r.done
                      and all(0 <= x < cfg.vocab_size for x in r.output)
                      for r in reqs))
        rec = {"phase": "serve_rwkv6", "config": tag, "mode": "graph",
               "wall_s": wall, "graph_captured": sched._graph is not None,
               "launches": launched, "decode_steps": sched.decode_steps,
               "host_syncs": sched.host_syncs,
               "tokens": stats.tokens_out, "prefill_s": stats.prefill_s,
               "decode_s": stats.decode_s,
               "decode_tokens_per_s": stats.tok_per_s}
        if backend is None:
            rec["sync_window"] = {"start_tick": window.start,
                                  "ok": window.done}
            run.check("serve_rwkv6", "8 ticks under sync debug mode 'error' "
                      "with no retirement", window.done, start=window.start)
        emit(rec)
        recs[tag] = rec
        outs[tag] = [r.output for r in reqs]
        caches[tag] = sched.state["cache"]
    counts = kops.launches()                         # read just after
    match = sum(a == b for a, b in zip(outs["cuda"], outs["ref"]))
    run.check("serve_rwkv6", "greedy tokens on cuda equal ref",
              outs["cuda"] == outs["ref"], requests_equal=match)
    eager = graph_against_eager(
        run, torch, np, kops, "serve_rwkv6", cfg,
        {"ring-fp32": (recs["cuda"], outs["cuda"])},
        lambda form, seed: ServingEngine(
            cfg, params, max_batch=8, cache_len=SERVE_CACHE_LEN,
            device=DEVICE, seed=seed, **MOE_CONFIGS[form]),
        lambda: serve_requests(np, cfg, SEED + 90))["ring-fp32"]
    bucketed_against_eager(
        run, torch, np, kops, "serve_rwkv6", cfg,
        lambda form, buckets: ServingEngine(
            cfg, params, max_batch=8, cache_len=SERVE_CACHE_LEN,
            device=DEVICE, prefill_buckets=buckets, **MOE_CONFIGS[form]),
        ("ring-fp32",), SEED + 96)
    # a paged layout is asked for and the ring is kept; int8 leaves the
    # fp32 state as it is: the same tokens and the same final state
    for name, opts in (("paged", {"kv_layout": "paged", "page_size": 16}),
                       ("int8", {"kv_dtype": "int8"})):
        eng = ServingEngine(cfg, params, max_batch=8,
                            cache_len=SERVE_CACHE_LEN, device=DEVICE, **opts)
        reqs = serve_requests(np, cfg, SEED + 90)
        eng.generate_batch(reqs)
        sched = eng.scheduler()
        cache = sched.state["cache"]
        same = all(torch.equal(cache[k], caches["cuda"][k]) for k in cache)
        ok = (sched.kv_layout == "ring"
              and [r.output for r in reqs] == outs["cuda"] and same
              and all(c.dtype == torch.float32 for c in cache.values()))
        run.check("serve_rwkv6", f"{name} asked for: ring layout, fp32 state, "
                  "tokens and final state equal the ring fp32 run's", ok,
                  layout=sched.kv_layout, state_equal=same)
        emit({"phase": "serve_rwkv6", "config": name,
              "layout": sched.kv_layout, "tokens_equal": ok,
              "state_equal": same})
    del caches
    # prefill of 4 prompts, cuda against ref: layer by layer on the same
    # input, then end to end beside the model's own sensitivity
    worst = {"time_mix_out": 0.0, "wkv": 0.0}
    e2e = []
    for r in serve_requests(np, cfg, SEED + 90)[:4]:
        toks = torch.tensor([r.prompt], device=DEVICE)
        for key, err, bad in _prefill_layerwise(torch, cfg, params, toks):
            worst[key] = max(worst[key], err)
            run.check("serve_rwkv6", f"prefill {key}, prompt of "
                      f"{len(r.prompt)}, every layer on the same input: "
                      f"cuda vs ref (rtol/atol {RWKV_TOL})", bad == 0,
                      max_abs_err=err, mismatches=bad)
        e2e.append({"prompt": len(r.prompt),
                    **_prefill_end_to_end(torch, cfg, params, toks)})
    emit({"phase": "serve_rwkv6", "prefill_layerwise_max_abs": worst,
          "rtol": RWKV_TOL, "atol": RWKV_TOL, "prefill_end_to_end": e2e})
    # a warm run: decode tokens/s and TTFT from the scheduler's counters;
    # then a decode step with 8 live lanes by part
    eng = ServingEngine(cfg, params, max_batch=8, cache_len=SERVE_CACHE_LEN,
                        device=DEVICE)
    eng.generate_batch(serve_requests(np, cfg, SEED + 91, n=8, hi=50))
    sched = eng.scheduler()
    sched.metrics.reset()
    stats = eng.generate_batch(serve_requests(np, cfg, SEED + 92))
    ttft = sched.metrics.histogram("req.ttft_s").snapshot()
    for r in serve_requests(np, cfg, SEED + 93, n=8):
        sched.submit(r)
    sched.tick()                                     # admits all 8
    graph_profile = graph_step_record(run, torch, "serve_rwkv6", "ring-fp32",
                                      sched)
    with disable_graphs():               # the ranges run only eagerly
        sched.tick()
        profile = {"mode": "eager", **_profile_rwkv_ticks(torch, sched, 3)}
    sched.run()
    prompt = torch.from_numpy(np.random.default_rng(SEED + 95).integers(
        1, cfg.vocab_size, (1, PREFILL_SEQ))).to(DEVICE)
    prefill = rwkv_prefill_profile(torch, cfg, params, prompt)
    emit({"phase": "serve_rwkv6", "card": card["nvidia_smi"], "warm": True,
          "requests": SERVE_REQUESTS, "max_new": SERVE_MAX_NEW,
          "decode_tokens_per_s": stats.tok_per_s, "decode_s": stats.decode_s,
          "prefill_s": stats.prefill_s, "ref_prefill_s": recs["ref"]["prefill_s"],
          "cuda_prefill_s": recs["cuda"]["prefill_s"], "ttft_s": ttft,
          "eager_decode_tokens_per_s": eager["decode_tokens_per_s"],
          "graph_decode_tokens_per_s": recs["cuda"]["decode_tokens_per_s"],
          "step_profile": profile, "graph_step_profile": graph_profile,
          "prefill_profile": prefill,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    # the same model in bf16: B10 on bf16 r, k, v beside the fp32 decay
    emit({"phase": "serve_rwkv6", "bf16_prefill": rwkv_bf16_prefill(
        run, torch, np, cfg, params)})
    return params, {"rwkv6_chunked": counts["rwkv6_chunked"]}


def phase_selector(run, torch, np, tiny_np, rwkv_params, store_root):
    """examples/serve_batched.py at full width and SWAP_LAYERS deep:
    TinyLlama-1.1B and Qwen3-0.6B (fp32) and the int8 artifact of RWKV-6
    3B published into one store; the meta-selector fitted on the card
    (location i prefers model i); MultiModelServer(max_resident=3,
    selector=...) serves 6 rounds of 3 requests, each context picking its
    model; every pick is its label, and the RWKV rounds launch B10
    (layers x 3 prefills).  Every model's decode step replays a graph;
    the 6 rounds once more under ``disable_graphs()`` give the same picks
    and tokens."""
    from repro_torch.checkpoint.ckpt import publish_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.jit import disable_graphs
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.core.selector import ContextSpec, MetaSelector, featurize
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.engine import MultiModelServer, Request
    store = ModelStore(store_root)
    cfgs = {n: cut_depth(get_config(n), {"layers": {}})[0]
            for n in SELECTOR_MODELS}
    tiny_np = cut_depth(cfgs["tinyllama-1.1b"], tiny_np)[1]
    rwkv_params = cut_depth(cfgs[RWKV_ARCH], rwkv_params)[1]
    t0 = time.perf_counter()
    publish_checkpoint(store, "tinyllama-1.1b", cfgs["tinyllama-1.1b"],
                       tiny_np)
    publish_checkpoint(store, "qwen3-0.6b", cfgs["qwen3-0.6b"],
                       numpy_weights(np, cfgs["qwen3-0.6b"], SEED + 1))
    rec8 = publish_checkpoint(store, RWKV_ARCH, cfgs[RWKV_ARCH], rwkv_params,
                              int8=True)            # quantized on the card
    t_pub = time.perf_counter() - t0
    spec = ContextSpec(num_locations=4, history_classes=4)
    feats, labels = [], []
    for i in range(300):
        feats.append(featurize(spec, hour=i % 24, weekday=i % 7,
                               location=i % 3, history=np.eye(4)[i % 4]))
        labels.append(i % 3)
    feats, labels = torch.stack(feats), torch.tensor(labels)
    sel = MetaSelector(spec, list(SELECTOR_MODELS), device=DEVICE,
                       generator=torch.Generator(DEVICE).manual_seed(SEED))
    t1 = time.perf_counter()
    loss = sel.fit(feats, labels)
    fit_s = time.perf_counter() - t1
    acc = sel.accuracy(feats, labels)
    run.check("selector", "the selector fits its contexts (accuracy 1.0)",
              acc == 1.0, accuracy=acc, loss=loss)
    server = MultiModelServer(store, max_resident=3, selector=sel,
                              max_batch=4, cache_len=96, device=DEVICE)
    rng = np.random.default_rng(SEED + 95)
    rounds, served = [], []
    for i in range(6):
        loc = i % 3
        ctx = featurize(spec, hour=9 + i, weekday=2, location=loc,
                        history=np.eye(4)[0])
        reqs = [Request(uid=3 * i + j, prompt=rng.integers(1, 250, 12)
                        .tolist(), max_new_tokens=8) for j in range(3)]
        served.append((ctx, reqs))
        kops.reset_launches()
        t1 = time.perf_counter()
        stats = server.serve(reqs, context_feats=ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        model, switch_s = server.switch_log[-1]
        launched = {k: v for k, v in kops.launches().items() if v}
        rounds.append({"round": i, "location": loc, "model": model,
                       "switch_s": switch_s, "wall_s": wall,
                       "tokens": stats.tokens_out,
                       "decode_tok_per_s": stats.tok_per_s,
                       "launches": launched})
        run.check("selector", f"round {i}: location {loc} picks "
                  f"{SELECTOR_MODELS[loc]}", model == SELECTOR_MODELS[loc],
                  picked=model)
        run.check("selector", f"round {i}: 3 x 8 tokens",
                  stats.tokens_out == 24)
        if model == RWKV_ARCH:
            n = cfgs[RWKV_ARCH].num_layers
            run.check("selector", f"round {i}: B10 launches = {n} x 3 "
                      "prefills", launched == {"rwkv6_chunked": n * 3},
                      launches=launched)
        else:
            run.check("selector", f"round {i}: B8 in prefill, B6 in decode",
                      set(launched) == {"flash_attention",
                                        "decode_attention"},
                      launches=launched)
    emit({"phase": "selector", "publish_s": t_pub, "fit_s": fit_s,
          "fit_loss": loss, "accuracy": acc,
          "rwkv_int8_artifact_bytes": rec8.manifest["weights_bytes"],
          "rounds": rounds, "hits": server.cache.hits,
          "misses": server.cache.misses})
    run.check("selector", "resident cache: 3 misses, then 3 hits",
              (server.cache.hits, server.cache.misses) == (3, 3))
    captured = {name: eng.scheduler()._graph is not None
                for (name, _), eng in server._engines.items()}
    run.check("selector", "every model's decode step was captured",
              len(captured) == 3 and all(captured.values()),
              captured=captured)
    same = []
    with disable_graphs():
        for i, (ctx, reqs) in enumerate(served):
            again = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=8)
                     for r in reqs]
            server.serve(again, context_feats=ctx)
            same.append(server.switch_log[-1][0] == rounds[i]["model"]
                        and [r.output for r in again]
                        == [r.output for r in reqs])
    run.check("selector", "the 6 rounds under disable_graphs(): the same "
              "picks and tokens", all(same), rounds_equal=same)


# ---------------------------------------------------------------------------
# slice 5: Granite-MoE 3B served on B8 and B6/B7, and B11 on its artifact
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
MOE_SERVE_LAYERS = 16    # serve_moe's depth: 16 of Granite's 32 layers
MOE_TOL = 1e-4          # a layer's output on the same input, cuda vs ref
MOE_GAP = 2e-2          # fp32 logit gap of a near-tie where greedy streams part
MOE_CONFIGS = {"ring-fp32": {},
               "paged-int8": {"kv_layout": "paged", "page_size": 16,
                              "kv_dtype": "int8"}}
INT8_SOURCE = ("src/repro_torch/kernels/csrc/int8_matmul.cu",
               "src/repro/kernels/int8_matmul.py:53")
# (M, K, N): the JAX suite's shapes, all-127 int32 sums, ragged shapes
INT8_SHAPES = ((128, 128, 128), (64, 512, 256), (8, 512, 8), (1, 1, 1),
               (37, 130, 75), (17, 1000, 3))
INT8_ROWS = (8, 300, 2048)      # a decode batch, a prompt, a long prompt
# H100 SXM, NVIDIA's data sheet: dense int8 tensor-core operations
PEAK_INT8_OPS = 1979e12
MOE_PARTS = {"moe_route": "router, dispatch and combine",
             "moe_experts": "expert einsums (bmm over every expert)"}
OTHER_MM = "other matmul (q/k/v/o, logits)"
OTHER = "other (norms, RoPE, cache writes, sampling)"


def _is_device(e):
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _is_gemm(name):
    return any(key in name for key in ("gemm", "Gemm", "gemv"))


def _profile_ranged_ticks(torch, sched, ticks, module, ranges):
    """Device time per decode step by part over ``ticks`` ticks with every
    lane live (torch.profiler), the functions of ``module`` named in
    ``ranges`` ({name: (range, part)}) run inside ``record_function``
    ranges: the kernels launched in a range go to its part, the others to
    attention (B6/B7), the other matmuls or the rest; the idle share and
    kernels per step."""
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = {n: getattr(module, n) for n in ranges}
    part_of = dict(ranges.values())

    def ranged(label, fn):
        def inner(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return inner
    for n, fn in saved.items():
        setattr(module, n, ranged(ranges[n][0], fn))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                sched.tick()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)
    events = prof.events()
    # kernels launched inside a range: the runtime launch calls that start
    # within its span on its thread, matched to their device events by
    # correlation id (a kernel launched through ctypes has no aten op
    # above it that would list it under the range)
    spans = {}
    for e in events:
        if e.name in part_of and not _is_device(e):
            spans.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, part_of[e.name]))
    for v in spans.values():
        v.sort()
    in_range = {}
    for e in events:
        if _is_device(e) or not e.name.startswith("cu") \
                or "Launch" not in e.name or e.thread not in spans:
            continue
        rows = spans[e.thread]
        i = bisect.bisect_right(rows, (e.time_range.start, math.inf)) - 1
        if i >= 0 and e.time_range.start <= rows[i][1]:
            in_range[e.id] = rows[i][2]
    parts, total, kernels = {}, 0.0, 0
    calls = {}
    for e in events:
        if e.name in HOST_LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
        if not _is_device(e) or e.name in part_of:
            continue
        kernels += 1
        total += e.device_time
        part = in_range.get(e.id) or (
            "attention (B6/B7)" if any(key in e.name for key in
                                       DECODE_KERNEL_NAMES) else
            OTHER_MM if _is_gemm(e.name) else OTHER)
        parts[part] = parts.get(part, 0.0) + e.device_time
    return {"ticks": ticks, "wall_ms_per_step": wall_us / ticks / 1e3,
            "device_ms_per_step": total / ticks / 1e3,
            "device_idle_share": 1 - total / wall_us,
            "device_kernels_per_step": kernels / ticks,
            "host_launch_calls_per_step": {k: v / ticks
                                           for k, v in calls.items()},
            "device_ms_by_part": {k: v / ticks / 1e3
                                  for k, v in parts.items()}}


def _profile_moe_ticks(torch, sched, ticks):
    """A decode step by part (:func:`_profile_ranged_ticks`), the MoE
    pieces in ranges: the expert einsums, and the router with dispatch
    and combine."""
    from repro_torch.models import moe as tmoe
    route = ("moe_route", MOE_PARTS["moe_route"])
    return _profile_ranged_ticks(
        torch, sched, ticks, tmoe,
        {"_route": route, "_dispatch": route, "_combine": route,
         "_expert_ffn": ("moe_experts", MOE_PARTS["moe_experts"])})


def _moe_prefill_layerwise(torch, cfg, params, toks):
    """One prompt's prefill, layer by layer, on the ``ref`` trajectory:
    each layer's attention (B8 against the plain version) and the whole
    layer's output on the same input within MOE_TOL, tokens whose top-k
    expert set flips between the two backends excluded and counted, with
    the ref router's gap between its k-th and (k+1)-th probability there;
    then the cuda trajectory end to end: per layer, the tokens routed to
    another expert set than on ``ref``."""
    from repro_torch.models import common as cm
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as tfm
    k = cfg.experts_per_token
    out = {"attn_max_abs": 0.0, "attn_bad": 0, "layer_max_abs": 0.0,
           "layer_bad": 0, "flips_same_input": 0, "flip_gaps": [],
           "flips_end_to_end": []}

    def experts(x, lp):
        xn = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
        logits = xn.reshape(-1, cfg.d_model).float() @ lp["router"].float()
        top = torch.topk(torch.softmax(logits, dim=-1), k + 1, dim=-1)
        gap = top.values[:, k - 1] - top.values[:, k]
        return top.indices[:, :k].sort(-1).values, gap
    with torch.inference_mode():
        x = x_cuda = params["embed"][toks]
        for l in range(cfg.num_layers):
            lp = tfm._layer(params, l)
            a_c = tfm.attn(cfg, lp, x)[0]
            a_r = tfm.attn(cfg, lp, x, backend="ref")[0]
            err, bad = compare(torch, a_c, a_r, MOE_TOL, MOE_TOL)
            out["attn_max_abs"] = max(out["attn_max_abs"], err)
            out["attn_bad"] += bad
            e_c, _ = experts(x + a_c, lp)
            e_r, gap = experts(x + a_r, lp)
            flip = (e_c != e_r).any(-1)
            y_c = x + a_c + tmoe._ffn(cfg, lp, x + a_c)
            y_r = x + a_r + tmoe._ffn(cfg, lp, x + a_r)
            keep = ~flip.reshape(y_r.shape[:2])[..., None]
            err, bad = compare(torch, torch.where(keep, y_c, 0),
                               torch.where(keep, y_r, 0), MOE_TOL, MOE_TOL)
            out["layer_max_abs"] = max(out["layer_max_abs"], err)
            out["layer_bad"] += bad
            n_flip = int(flip.sum())
            out["flips_same_input"] += n_flip
            if n_flip:
                out["flip_gaps"] += gap[flip].tolist()
            # the cuda trajectory, end to end
            a = tfm.attn(cfg, lp, x_cuda)[0]
            e_cuda, _ = experts(x_cuda + a, lp)
            out["flips_end_to_end"].append(int((e_cuda != e_r).any(-1).sum()))
            x_cuda = x_cuda + a + tmoe._ffn(cfg, lp, x_cuda + a)
            x = y_r
    out["max_flip_gap"] = max(out["flip_gaps"], default=None)
    return out


def _tokens_or_near_ties(torch, cfg, params, reqs, got, want):
    """(ok, equal requests, logit gaps where streams part): greedy tokens
    equal, or every stream that parts does so at a near-tie."""
    gaps = divergence_gaps(torch, cfg, params, reqs, got, want)
    equal = sum(a == b for a, b in zip(got, want))
    return got == want or all(g <= MOE_GAP for g in gaps), equal, gaps


def phase_serve_moe(run, torch, np, card, store_root):
    """Granite-MoE 3B-A800M at full width (d 1536, 24/8 heads of 64, 40
    experts top-8 of d_ff 512, vocab 49155), depth cut to
    MOE_SERVE_LAYERS = 16 of its 32 layers (1.71 B parameters, 6.8 GB in
    fp32) through ServingEngine at batch 8, cache
    1024: the 16 greedy requests of serve_requests on the kernels and on
    ``ref`` in ring fp32 and paged int8; tokens equal ``ref`` (streams
    part only at near-ties, fp32 logit gap <= MOE_GAP); B8 launches 16 x
    full prefills and B6/B7 16 x decode steps, none on ``ref``; 8 ticks
    under sync debug mode "error".  The prefill of 4 prompts layer by
    layer on the same input within MOE_TOL, router flips counted.  A warm
    run's decode tokens/s and TTFT, a decode step's device time by part,
    the accountant's active weight bytes beside the whole bank's.  Then
    the int8 artifact (3.3 GB) published into ``store_root`` and served
    through MultiModelServer on both backends: tokens equal.  Every run
    replays the captured decode step (and, paged, the prefix hits'
    captured suffix step); each form's kernels run is held to the same
    requests under ``disable_graphs()`` (graph_against_eager), ring
    fp32's to 8 requests sampled at GRAPH_TEMP; the warm run profiles a
    replayed step (host launch calls <= 3) and, eagerly, a step by part;
    peak device memory."""
    from repro_torch.checkpoint.ckpt import publish_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.jit import disable_graphs
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.engine import MultiModelServer, ServingEngine
    import dataclasses
    set_fp32_exact(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    np_params = numpy_weights_chunked(np, cfg, SEED + 4)
    t_make = time.perf_counter() - t0
    params = params_from_numpy(np_params, DEVICE, cfg=cfg)
    del np_params
    torch.cuda.synchronize()
    emit({"phase": "serve_moe", "model": cfg.name,
          "params": cfg.param_count(),
          "active_params": cfg.active_param_count(),
          "weights_make_s": t_make,
          "weights_to_device_s": time.perf_counter() - t0 - t_make})
    L = cfg.num_layers
    path, graph_runs = {}, {}
    kops.reset_launches()                            # the main path starts
    for name, opts in MOE_CONFIGS.items():
        outs = {}
        for backend in (None, "ref"):
            window = sync_window(torch) if backend is None else None
            eng = ServingEngine(cfg, params, max_batch=8,
                                cache_len=SERVE_CACHE_LEN,
                                attn_backend=backend, faults=window,
                                device=DEVICE, **opts)
            reqs = serve_requests(np, cfg, SEED + 100)
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
            tag = f"{name}/{backend or 'cuda'}"
            launched = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            prefills = full_prefills(sched, len(reqs))
            dec = "decode_attention_paged_q8" if "paged" in name \
                else "decode_attention"
            want = {"flash_attention": L * prefills,
                    dec: L * sched.decode_steps} if backend is None else {}
            run.check("serve_moe", f"{tag}: B8 {L} x full prefills, B6/B7 "
                      f"{L} x decode steps, nothing else", launched == want,
                      launches=launched, prefills=prefills,
                      steps=sched.decode_steps)
            run.check("serve_moe", f"{tag}: host_syncs == retired requests",
                      sched.host_syncs == len(reqs),
                      host_syncs=sched.host_syncs)
            run.check("serve_moe", f"{tag}: every request generated "
                      f"{SERVE_MAX_NEW} tokens", all(
                          len(r.output) == SERVE_MAX_NEW and r.done
                          and all(0 <= x < cfg.vocab_size for x in r.output)
                          for r in reqs))
            run.check("serve_moe", f"{tag}: the decode step was captured",
                      sched._graph is not None)
            rec = {"phase": "serve_moe", "config": tag, "mode": "graph",
                   "wall_s": wall, "graph_captured": sched._graph is not None,
                   "launches": launched, "decode_steps": sched.decode_steps,
                   "host_syncs": sched.host_syncs,
                   "full_prefills": prefills, "tokens": stats.tokens_out,
                   "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
                   "decode_tokens_per_s": stats.tok_per_s}
            if backend is None:
                rec["sync_window"] = {"start_tick": window.start,
                                      "ok": window.done}
                run.check("serve_moe", f"{tag}: 8 ticks under sync debug "
                          "mode 'error' with no retirement", window.done,
                          start=window.start)
            if sched._paged:
                run.check("serve_moe", f"{tag}: prefix hits, their suffix "
                          "steps through the captured graph",
                          sched.prefix_hits >= 1 and "suffix" in
                          sched._graphs, hits=sched.prefix_hits)
                sched.audit_pages()
                rec["program_runs"] = {str(k): g.replays + 1 for k, g in
                                       sched._graphs.items()}
            emit(rec)
            outs[backend or "cuda"] = [r.output for r in reqs]
            if backend is None:
                graph_runs[name] = (rec, outs["cuda"])
            del eng, sched
        ok, equal, gaps = _tokens_or_near_ties(torch, cfg, params, reqs,
                                               outs["cuda"], outs["ref"])
        run.check("serve_moe", f"{name}: greedy tokens on cuda equal ref, "
                  f"streams parting only at near-ties (gap <= {MOE_GAP})",
                  ok, requests_equal=equal, gaps=gaps)
        emit({"phase": "serve_moe", "config": name,
              "tokens_equal_ref": outs["cuda"] == outs["ref"],
              "requests_equal": f"{equal}/{len(reqs)}",
              "divergence_logit_gaps": gaps})
    counts = kops.launches()                         # read just after
    path = {"flash_attention": counts["flash_attention"],
            "decode_attention": counts["decode_attention"],
            "decode_attention_paged": counts["decode_attention_paged_q8"]}
    emit({"phase": "serve_moe", "main_path_launches": path})
    eager = graph_against_eager(
        run, torch, np, kops, "serve_moe", cfg, graph_runs,
        lambda form, seed: ServingEngine(
            cfg, params, max_batch=8, cache_len=SERVE_CACHE_LEN,
            device=DEVICE, seed=seed, **MOE_CONFIGS[form]),
        lambda: serve_requests(np, cfg, SEED + 100))
    # the prefill of 4 prompts, layer by layer on the same input
    layerwise = []
    for r in serve_requests(np, cfg, SEED + 100)[:4]:
        toks = torch.tensor([r.prompt], device=DEVICE)
        res = _moe_prefill_layerwise(torch, cfg, params, toks)
        res["prompt"] = len(r.prompt)
        layerwise.append(res)
        run.check("serve_moe", f"prefill of {len(r.prompt)} tokens, every "
                  f"layer's attention on the same input: B8 vs ref "
                  f"(rtol/atol {MOE_TOL})", res["attn_bad"] == 0,
                  max_abs_err=res["attn_max_abs"])
        run.check("serve_moe", f"prefill of {len(r.prompt)} tokens, every "
                  f"layer's output on the same input, flipped tokens aside "
                  f"(rtol/atol {MOE_TOL}); flips at near-ties only (router "
                  "gap <= 1e-4)", res["layer_bad"] == 0
                  and all(g <= 1e-4 for g in res["flip_gaps"]),
                  max_abs_err=res["layer_max_abs"],
                  flips=res["flips_same_input"], gaps=res["flip_gaps"])
    emit({"phase": "serve_moe", "prefill_layerwise": layerwise})
    # a warm run: decode tokens/s and TTFT, then a decode step by part
    eng = ServingEngine(cfg, params, max_batch=8, cache_len=SERVE_CACHE_LEN,
                        device=DEVICE)
    eng.generate_batch(serve_requests(np, cfg, SEED + 101, n=8, hi=50))
    sched = eng.scheduler()
    sched.metrics.reset()
    stats = eng.generate_batch(serve_requests(np, cfg, SEED + 102))
    ttft = sched.metrics.histogram("req.ttft_s").snapshot()
    for r in serve_requests(np, cfg, SEED + 103, n=8):
        sched.submit(r)
    sched.tick()                                     # admits all 8
    graph_profile = graph_step_record(run, torch, "serve_moe", "ring-fp32",
                                      sched)
    with disable_graphs():               # the ranges run only eagerly
        sched.tick()
        profile = {"mode": "eager", **_profile_moe_ticks(torch, sched, 4)}
    sched.run()
    bank = sum(w.numel() * w.element_size()
               for w in params["layers"].values()) + \
        params["embed"].numel() * 4 + params["final_ln"].numel() * 4
    emit({"phase": "serve_moe", "card": card["nvidia_smi"], "warm": True,
          "requests": SERVE_REQUESTS, "max_new": SERVE_MAX_NEW,
          "decode_tokens_per_s": stats.tok_per_s, "decode_s": stats.decode_s,
          "prefill_s": stats.prefill_s, "ttft_s": ttft,
          "weight_bytes_per_step_accountant":
              sched.roofline.weight_bytes_per_step,
          "weight_bytes_whole_bank": bank,
          "whole_bank_stream_ms": 1e3 * bank / PEAK_HBM_BYTES,
          "eager_decode_tokens_per_s": {
              f: e["decode_tokens_per_s"] for f, e in eager.items()},
          "graph_decode_tokens_per_s": {
              f: g[0]["decode_tokens_per_s"] for f, g in graph_runs.items()},
          "step_profile": profile, "graph_step_profile": graph_profile,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del eng, sched
    # the int8 artifact through MultiModelServer on both backends
    store = ModelStore(store_root)
    t1 = time.perf_counter()
    rec8 = publish_checkpoint(store, MOE_ARCH, cfg, params, int8=True)
    t_pub = time.perf_counter() - t1
    del params
    torch.cuda.empty_cache()
    outs, rounds = {}, []
    for backend in (None, "ref"):
        server = MultiModelServer(store, max_resident=1, max_batch=8,
                                  cache_len=SERVE_CACHE_LEN,
                                  attn_backend=backend, device=DEVICE)
        reqs = serve_requests(np, cfg, SEED + 104, n=8, max_new=16, hi=100,
                              shared_prefix=0)
        kops.reset_launches()
        t1 = time.perf_counter()
        stats = server.serve(reqs, model=MOE_ARCH)
        torch.cuda.synchronize()
        launched = {k: v for k, v in kops.launches().items() if v}
        want = {"flash_attention", "decode_attention"} if backend is None \
            else set()
        run.check("serve_moe", f"int8 artifact via MultiModelServer "
                  f"({backend or 'cuda'}): B8 and B6 only on cuda",
                  set(launched) == want, launches=launched)
        rounds.append({"backend": backend or "cuda",
                       "wall_s": time.perf_counter() - t1,
                       "switch_s": server.switch_log[-1][1],
                       "tokens": stats.tokens_out,
                       "decode_tok_per_s": stats.tok_per_s,
                       "launches": launched})
        outs[backend or "cuda"] = [r.output for r in reqs]
        if backend == "ref":
            served = next(iter(server._engines.values())).params
            ok, equal, gaps = _tokens_or_near_ties(
                torch, cfg, served, reqs, outs["cuda"], outs["ref"])
            run.check("serve_moe", "int8 artifact: greedy tokens on cuda "
                      "equal ref (near-ties aside)", ok,
                      requests_equal=equal, gaps=gaps)
            rounds[-1]["divergence_logit_gaps"] = gaps
            del served
        del server
        torch.cuda.empty_cache()
    emit({"phase": "serve_moe", "int8_artifact_bytes":
          rec8.manifest["weights_bytes"], "publish_s": t_pub,
          "multimodel": rounds})
    return path


def int8_bound(m, k, n):
    """(seconds from bytes, seconds from operations): the int8 operands
    and fp32 scales read once, the fp32 output written once; 2MKN integer
    operations at the int8 tensor-core peak."""
    nbytes = m * k + k * n + 4 * (m + n) + 4 * m * n
    return nbytes / PEAK_HBM_BYTES, 2 * m * k * n / PEAK_INT8_OPS


def device_us(torch, fn, n=20, warm=20, tries=3):
    """(device µs per call of ``fn``, the kernel names): the spans of the
    device events torch.profiler records for the launches of ``n`` calls
    (the host's launch gaps left out); None when a launch's device event
    is missing.

    Kineto drops device events "outside of profiling window": in a
    session that starts tracing at once, the first launches' events went
    missing, more of them the older the process (our kernels and SDPA's
    alike), which left every train_times row without device µs.  So a schedule
    step of ``warm`` calls runs with tracing on and its events discarded,
    and the active step's ``n`` calls count through their runtime API
    events, each matched to its device events by correlation id.  A
    trace in which some launch has no device event is taken again, up to
    ``tries`` times; a missing launch is never estimated."""
    us, kernels = _device_kernels(torch, fn, n, warm, tries)
    if us is None:
        return None, []
    return us, sorted({e.name[:60] for e in kernels})


def device_us_by(torch, fn, keys, n=20, warm=20, tries=3):
    """Device µs per call of ``fn`` split by kernel: for each key, the
    kernels whose name contains it (as :func:`device_us` counts them);
    None when a launch's device event is missing."""
    us, kernels = _device_kernels(torch, fn, n, warm, tries)
    if us is None:
        return None
    return {key: sum(e.time_range.elapsed_us() for e in kernels
                     if key in e.name) / n for key in keys}


def _device_kernels(torch, fn, n, warm, tries):
    """(device µs per call, the device events of the counted launches),
    or (None, []): the trace of :func:`device_us`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.profiler import schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(warm):
                fn()
            torch.cuda.synchronize()
            prof.step()
            with record_function("device_us"):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        events = list(prof.events())       # the active step's, kept at exit
        span = next(e.time_range for e in events if e.name == "device_us"
                    and not _is_device(e))
        runtime = [e for e in events if not _is_device(e)
                   and e.name.startswith("cu")
                   and span.start <= e.time_range.start <= span.end]
        by_id = {}
        for e in events:
            if _is_device(e) and e.name != "device_us":
                by_id.setdefault(e.id, []).append(e)
        launched = [e for e in runtime if "Launch" in e.name]
        if launched and all(e.id in by_id for e in launched):
            kernels = [d for e in runtime for d in by_id.get(e.id, [])]
            us = sum(e.time_range.elapsed_us() for e in kernels)
            return us / n, kernels
    return None, []


def _int8_library(torch, a, b, sa, sb):
    """torch._int_mm (cuBLASLt) + the same epilogue: it takes M > 16 and
    K, N multiples of 8, so fewer rows are padded to 32 with zeros (the
    padding is made once, outside the timed call)."""
    acc = torch._int_mm(a, b)[:sa.shape[0]]
    return acc.float() * sa[:, None] * sb[None, :]


def phase_int8_kernels(run, torch, np, store_root, card):
    """B11 against its plain version, bit-equal (torch.equal): the JAX
    suite's shapes, all-127 sums in int32 and ragged shapes; then the
    main path, ``kernels.ops.int8_matmul`` on the store's int8 Granite
    artifact (``load_params(dequantize=False)``: QTensors scaled per
    output column): b is layer 0's wq, expert 0's we_gate and we_down
    with their stored scales, a the per-row int8 quantization of the
    layer's normed hidden states (for we_down, expert 0's SwiGLU
    activations) at M 8, 300 and 2048.  Then per launch (median of 7 x 20
    CUDA-event runs, and the device time under torch.profiler) at four of
    those shapes, against the bound, the plain version and torch._int_mm
    with the epilogue."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import _build
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(SEED + 110)
    checks = []
    for m, k, n in INT8_SHAPES:
        if (m, k, n) == (8, 512, 8):
            a = torch.full((m, k), 127, dtype=torch.int8)
            b = torch.full((k, n), 127, dtype=torch.int8)
            sa, sb = torch.ones(m), torch.ones(n)
        else:
            a = torch.randint(-127, 128, (m, k), generator=gen,
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (k, n), generator=gen,
                              dtype=torch.int8)
            sa = torch.rand(m, generator=gen) + 0.01
            sb = torch.rand(n, generator=gen) + 0.01
        args = [x.to(dev) for x in (a, b, sa, sb)]
        got = kops.int8_matmul(*args)
        want = ref.int8_matmul_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.equal(got, want)
        if (m, k, n) == (8, 512, 8):
            ok = ok and bool((got == 512 * 127 * 127).all())
        checks.append({"shape": [m, k, n], "bit_equal": ok,
                       "max_abs_err": err})
        run.check("int8_kernels", f"B11 M={m} K={k} N={n} bit-equal to the "
                  "plain version", ok, max_abs_err=err)
    extra = int8_extra_checks(run, torch, gen)
    # the main path's operands: the store's int8 artifact
    rec = ModelStore(store_root).get(MOE_ARCH)
    cfg = ArchConfig(**rec.load_spec()["arch"])
    q = rec.load_params(dequantize=False)
    lq = q["layers"]
    lp = {key: (v.dequantize()[0] if hasattr(v, "dequantize") else v[0])
          .to(dev) for key, v in lq.items()
          if key in ("ln1", "ln2", "wq", "wk", "wv", "wo")}
    embed = q["embed"].dequantize().to(dev)
    weights = {"wq": (lq["wq"].q[0], lq["wq"].scale),
               "we_gate": (lq["we_gate"].q[0, 0], lq["we_gate"].scale),
               "we_down": (lq["we_down"].q[0, 0], lq["we_down"].scale)}
    weights = {key: (w.contiguous().to(dev), s.to(dev))
               for key, (w, s) in weights.items()}
    wu = lq["we_up"].dequantize()[0, 0].to(dev)
    wg = weights["we_gate"][0].float() * weights["we_gate"][1]
    toks_rng = np.random.default_rng(SEED + 111)
    operands = []
    with torch.inference_mode():
        for m in INT8_ROWS:
            toks = torch.from_numpy(toks_rng.integers(
                1, cfg.vocab_size, (1, m))).to(dev)
            x = embed[toks]
            xn1 = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)[0]
            y = x + tfm.attn(cfg, lp, x, backend="ref")[0]
            xn2 = cm.rms_norm(y, lp["ln2"], cfg.norm_eps)[0]
            h = torch.nn.functional.silu(xn2 @ wg) * (xn2 @ wu)
            for key, act in (("wq", xn1), ("we_gate", xn2), ("we_down", h)):
                aq = quantize(act.contiguous(), axis=0)      # per row
                operands.append((key, m, aq.q.contiguous(), aq.scale,
                                 *weights[key]))
    del embed, lp, wu, wg
    kops.reset_launches()                            # the main path starts
    outs = [kops.int8_matmul(a, b, sa, sb) for _, _, a, sa, b, sb in operands]
    torch.cuda.synchronize()
    launches = kops.launches()["int8_matmul"]        # read just after
    run.check("int8_kernels", f"the artifact path launched B11 "
              f"{len(operands)} times", launches == len(operands),
              launches=launches)
    real = []
    for (key, m, a, sa, b, sb), got in zip(operands, outs):
        want = ref.int8_matmul_ref(a, b, sa, sb)
        err = float((got - want).abs().max())
        ok = torch.equal(got, want) and bool(torch.isfinite(got).all())
        real.append({"weight": key, "shape": [m, *b.shape], "bit_equal": ok,
                     "max_abs_err": err})
        run.max_err["int8_matmul"] = max(run.max_err.get("int8_matmul", 0.0),
                                         err)
        run.check("int8_kernels", f"B11 on the artifact's {key}, M={m} "
                  f"({a.shape[0]} x {a.shape[1]} @ {b.shape[0]} x "
                  f"{b.shape[1]}): bit-equal", ok, max_abs_err=err)
    times = {}
    for key, m in (("wq", INT8_ROWS[0]), ("wq", INT8_ROWS[1]),
                   ("we_gate", INT8_ROWS[2]), ("we_down", INT8_ROWS[2])):
        _, _, a, sa, b, sb = next(o for o in operands
                                  if o[0] == key and o[1] == m)
        a_lib = a if m > 16 else torch.cat([a, a.new_zeros(32 - m,
                                                           a.shape[1])])
        lib_err = float((_int8_library(torch, a_lib, b, sa, sb)
                         - kops.int8_matmul(a, b, sa, sb)).abs().max())
        b_s, o_s = int8_bound(*a.shape, b.shape[1])
        times[f"{m}x{a.shape[1]}x{b.shape[1]}"] = {
            "weight": key, "headline": (key, m) == ("wq", INT8_ROWS[1]),
            "ms": time_ms(torch, lambda: kops.int8_matmul(a, b, sa, sb)),
            "plain_ms": time_ms(torch,
                                lambda: ref.int8_matmul_ref(a, b, sa, sb)),
            "library_ms": time_ms(torch, lambda: _int8_library(
                torch, a_lib, b, sa, sb)),
            "library_rows": a_lib.shape[0],
            "device_us": device_us(torch, lambda: kops.int8_matmul(
                a, b, sa, sb)),
            "library_device_us": device_us(torch, lambda: _int8_library(
                torch, a_lib, b, sa, sb))[0],
            "library_vs_kernel_max_abs": lib_err,
            "bound_ms": 1e3 * max(b_s, o_s),
            "bound_by": "bytes" if b_s >= o_s else "operations",
            "plan": i8.plan(a.shape[0], b.shape[1], a.shape[1],
                            _build.sm_count(0))._asdict(),
            "vector_route": i8.vector_route(a, b)}
        t = times[f"{m}x{a.shape[1]}x{b.shape[1]}"]
        t["share_of_bound"] = t["device_us"][0] and \
            t["bound_ms"] * 1e3 / t["device_us"][0]
    emit({"phase": "int8_kernels", "card": card["nvidia_smi"],
          "synthetic": checks, "extra_checks": extra, "artifact": real,
          "launches": launches, "times": times})
    return {"launches": launches, "times": times}


def int8_extra_checks(run, torch, gen):
    """B11's routes, each bit-equal to the plain version: byte loads where
    K or N is not a multiple of 16 or a base is not 16-byte aligned (A,
    B and both), M 8 split over K, all-127 operands at K 133,144 (the
    largest K whose int32 sum is exact) through the plan's split, and a
    rerun; the split workspace is left at 0."""
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ref
    dev = torch.device(DEVICE)
    checks = []

    def operands(m, k, n, shift_a=0, shift_b=0):
        a = torch.randint(-127, 128, (m * k + shift_a,), generator=gen,
                          dtype=torch.int8).to(dev)[shift_a:].view(m, k)
        b = torch.randint(-127, 128, (k * n + shift_b,), generator=gen,
                          dtype=torch.int8).to(dev)[shift_b:].view(k, n)
        sa = (torch.rand(m, generator=gen) + 0.01).to(dev)
        sb = (torch.rand(n, generator=gen) + 0.01).to(dev)
        return [a, b, sa, sb]

    def check(what, got, want, **info):
        ok = torch.equal(got, want)
        checks.append({"check": what, "bit_equal": ok, **info})
        run.check("int8_kernels", f"B11 {what}: bit-equal", ok, **info)
    for m, k, n, sa_, sb_ in ((37, 130, 75, 0, 0), (64, 512, 256, 1, 0),
                              (64, 512, 256, 0, 3), (300, 1536, 1536, 5, 7)):
        args = operands(m, k, n, sa_, sb_)
        route = i8.vector_route(args[0], args[1])
        check(f"M={m} K={k} N={n}, bases +{sa_}/+{sb_} (vec {route})",
              i8.launch(*args), ref.int8_matmul_ref(*args), route=route)
    args = operands(8, 1536, 1536)
    split = i8.launch(*args)
    check("M=8 K=1536 N=1536 split over K "
          f"({i8.plan(8, 1536, 1536, 132).splits} ways on 132 SMs)", split,
          ref.int8_matmul_ref(*args))
    check("M=8 rerun", i8.launch(*args), split)
    for n in (24, 32):
        k = 133_144
        a = torch.full((5, k), 127, dtype=torch.int8, device=dev)
        a[2] = -127
        b = torch.full((k, n), 127, dtype=torch.int8, device=dev)
        ones = torch.ones(5, device=dev), torch.ones(n, device=dev)
        want = torch.full((5, n), float(127 * 127 * k), device=dev)
        want[2] = -want[2]
        check(f"all-127 at K={k} N={n}, "
              f"{i8.plan(5, n, k, 132).splits} splits on 132 SMs",
              i8.launch(a, b, *ones), want)
    torch.cuda.synchronize()
    left = [bool((w == 0).all()) for ws in i8._workspaces.values()
            for w in ws]
    run.check("int8_kernels", "B11 split workspaces left at 0", all(left),
              tensors=len(left))
    return checks


# ---------------------------------------------------------------------------
# slice 12: RecurrentGemma-9B (Griffin: RG-LRU blocks + local MQA)
# ---------------------------------------------------------------------------

HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_TOL = 1e-4       # a layer's prefill output and state on the same input
HYBRID_CACHE_LEN = 2048  # the ring is the whole local window
HYBRID_LONG = 2100      # a prompt that prefills past the window (the roll)
HYBRID_REC_PART = "recurrent blocks (RG-LRU, gates, conv, their matmuls)"


def device_weights_chunked(np, torch, cfg, seed):
    """:func:`numpy_weights_chunked`'s numbers, straight onto the card:
    every leaf is allocated there, each of its chunks is drawn on the
    host from its own generator (``SeedSequence(seed, spawn_key=(i,
    j))``) by a pool of threads and copied in, so the host holds a chunk
    per thread, not the model."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.models import param_template
    from repro_torch.models.common import map_template
    drawn = []

    def leaf(p):
        if p.init in ("zeros", "ones"):
            return (torch.zeros if p.init == "zeros" else torch.ones)(
                p.shape, device=DEVICE)
        x = torch.empty(p.shape, device=DEVICE)
        drawn.append((x.view(-1), np.float32(p.std)))
        return x
    tree = map_template(leaf, param_template(cfg))

    def fill(job):
        i, j = job
        flat, std = drawn[i]
        n = min(WEIGHT_CHUNK, flat.numel() - j * WEIGHT_CHUNK)
        part = np.empty(n, np.float32)
        rng = np.random.default_rng(np.random.SeedSequence(seed,
                                                           spawn_key=(i, j)))
        rng.standard_normal(out=part, dtype=np.float32)
        part *= std
        flat[j * WEIGHT_CHUNK:j * WEIGHT_CHUNK + n].copy_(
            torch.from_numpy(part))
    jobs = [(i, j) for i, (x, _) in enumerate(drawn)
            for j in range(-(-x.numel() // WEIGHT_CHUNK))]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(fill, jobs))
    return tree


def hybrid_requests(np, cfg, seed, n=None):
    """serve_requests' greedy requests (prompts 5..300, two sharing a
    64-token prefix) and, third in the queue, one of HYBRID_LONG tokens
    that prefills past the window."""
    from repro_torch.runtime.scheduler import Request
    reqs = serve_requests(np, cfg, seed, n=n)
    long = np.random.default_rng(seed + 1).integers(1, cfg.vocab_size,
                                                    HYBRID_LONG).tolist()
    reqs.insert(2, Request(uid=len(reqs), prompt=long,
                           max_new_tokens=reqs[0].max_new_tokens))
    return reqs


def _rec_block_fp64(cfg, lp, x):
    """The recurrent block evaluated in fp64 (weights and input cast up;
    the recurrence as a sequential loop): (output, conv state, h)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import rglru as rg
    p = {k: v.double() for k, v in lp.items()}
    x = x.double()
    xn = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + cfg.norm_eps) \
        * (1.0 + p["ln1"])
    a = F.gelu(xn @ p["w_a"], approximate="tanh")
    bconv, conv = rg.causal_conv(p, xn @ p["w_b"])
    r = torch.sigmoid(bconv @ p["gate_a_w"] + p["gate_a_b"])
    gate = torch.sigmoid(bconv @ p["gate_x_w"] + p["gate_x_b"])
    decay = torch.exp(rg.LRU_C * r * F.logsigmoid(p["lam"]))
    gated = torch.sqrt(torch.clamp(1.0 - decay.square(), 1e-12, 1.0)) \
        * (gate * bconv)
    h = torch.zeros_like(gated[:, 0])
    hs = []
    for t in range(gated.shape[1]):
        h = decay[:, t] * h + gated[:, t]
        hs.append(h)
    return (a * torch.stack(hs, 1)) @ p["w_out"], conv, h


def _hybrid_prefill_layerwise(torch, cfg, params, toks):
    """One prompt's prefill layer by layer on the ``ref`` trajectory, each
    layer from the same input: a local-attention layer on the kernels (B8)
    and on ``ref`` (its attention output and the whole layer's); a
    recurrent block, which runs no kernel, on the card in fp32 against an
    fp64 evaluation (its output, conv state and h).  The K/V window of the
    first attention layer from ``rglru.prefill`` on the kernels, against
    the keys and values of the prompt's last window put where the ring
    holds them (slot t % wlen).  Per part: (max abs error, count outside
    HYBRID_TOL)."""
    from repro_torch.models import rglru as rg
    from repro_torch.models import transformer as tfm
    out = {}

    def add(part, got, want):
        err, bad = compare(torch, got, want, HYBRID_TOL, HYBRID_TOL)
        e0, b0 = out.get(part, (0.0, 0))
        out[part] = (max(e0, err), b0 + bad)
    s = toks.shape[1]
    wlen = min(HYBRID_CACHE_LEN, cfg.local_window)
    first_kv = None
    with torch.inference_mode():
        x = params["embed"][toks]
        for kind, i, li in rg._layers(cfg):
            mp = rg._slice(params["mlp"], li)
            if kind == "rec":
                lp = rg._slice(params["rec"], i)
                a, conv, h = rg.rec_block(cfg, lp, x)
                a64, conv64, h64 = _rec_block_fp64(cfg, lp, x)
                add("rec_out vs fp64", a, a64)
                add("conv state vs fp64", conv, conv64)
                add("h vs fp64", h, h64)
                x = x + a
            else:
                lp = rg._slice(params["attn"], i)
                a_c, (k, v) = tfm.attn(cfg, lp, x, window=cfg.local_window)
                a_r = tfm.attn(cfg, lp, x, window=cfg.local_window,
                               backend="ref")[0]
                add("attn_out cuda vs ref", a_c, a_r)
                y_c = x + a_c + tfm.mlp(cfg, mp, x + a_c)
                if first_kv is None:
                    first_kv = (k, v)
                x = x + a_r
            y = x + tfm.mlp(cfg, mp, x)
            if kind == "attn":
                add("layer_out cuda vs ref", y_c, y)
            x = y
        _, cache = rg.prefill(cfg, params, toks, HYBRID_CACHE_LEN,
                              cache_dtype=torch.float32)
        keep = min(s, wlen)
        slots = torch.arange(s - keep, s, device=toks.device) % wlen
        for name, kv in zip(("k", "v"), first_kv):
            add("K/V window (the roll)", cache[name][0, 0][:, slots],
                kv[0, s - keep:].transpose(0, 1))
    return {k: {"max_abs_err": e, "mismatches": b} for k, (e, b) in out.items()}


def _hybrid_scan_fp64(torch, cfg, params, toks):
    """The doubling scan (``rglru.linear_scan``) on the first recurrent
    layer's decays and gated inputs for this prompt (T x lru_width),
    against a sequential fp64 recurrence on the same values: max and rms
    error, and the largest |h|."""
    from repro_torch.models import common as cm
    from repro_torch.models import rglru as rg
    with torch.inference_mode():
        lp = rg._slice(params["rec"], 0)
        xn = cm.rms_norm(params["embed"][toks], lp["ln1"], cfg.norm_eps)
        bconv, _ = rg.causal_conv(lp, xn @ lp["w_b"])
        log_a, gate = rg._log_a(lp, bconv)
        a = torch.exp(log_a)
        b = rg._gated(a, gate, bconv)
        got = rg.linear_scan(a, b)
        h = torch.zeros_like(b[:, 0], dtype=torch.float64)
        want = []
        for t in range(b.shape[1]):
            h = a[:, t].double() * h + b[:, t].double()
            want.append(h)
        err = got.double() - torch.stack(want, 1)
    return {"T": int(b.shape[1]), "width": int(b.shape[2]),
            "max_abs_err": float(err.abs().max()),
            "rms_err": float(err.square().mean().sqrt()),
            "max_abs_h": float(got.abs().max()),
            "min_decay": float(a.min())}


def _hybrid_prefill_end_to_end(torch, cfg, params, toks):
    """The full prefill's logits and every state leaf, cuda against ref,
    as relative distances, beside two ``ref`` prefills whose embeddings
    differ by a relative 1e-7 (the model's own sensitivity at full
    depth, which a kernel cannot undercut)."""
    from repro_torch.models import rglru as rg

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 114)
    noisy = {**params, "embed": params["embed"] * (1 + 1e-7 * torch.randn(
        params["embed"].shape[1], generator=gen, device=DEVICE))}
    runs = {}
    with torch.inference_mode():
        for name, p, backend in (("cuda", params, None),
                                 ("ref", params, "ref"),
                                 ("noisy", noisy, "ref")):
            lg, cache = rg.prefill(cfg, p, toks, HYBRID_CACHE_LEN,
                                   cache_dtype=torch.float32,
                                   backend=backend)
            runs[name] = {"logits": lg[0, -1], **cache}
    del noisy
    return {f"{key}_rel_{a}_vs_ref": rel(runs[a][key], runs["ref"][key])
            for key in runs["ref"] for a in ("cuda", "noisy")}


def hybrid_prefill_profile(torch, cfg, params, toks):
    """One prompt's full prefill (``rglru.prefill`` on the kernels, under
    inference mode): device ms by part, B8 (kernels named ``flash_fwd``)
    and the cuBLAS products beside the rest, traced as :func:`device_us`
    traces (a warm call first, then the counted ones)."""
    from repro_torch.models import rglru as rg

    def call():
        with torch.inference_mode():
            rg.prefill(cfg, params, toks, HYBRID_CACHE_LEN,
                       cache_dtype=torch.float32)
    parts = device_us_by(torch, call, ("flash_fwd", "gemm", "Gemm", ""),
                         n=2, warm=1)
    if parts is None:
        return None
    mm = parts["gemm"] + parts["Gemm"]
    return {"prompt": int(toks.shape[1]), "device_ms": parts[""] / 1e3,
            "b8_ms": parts["flash_fwd"] / 1e3, "matmul_ms": mm / 1e3,
            "other_ms": (parts[""] - parts["flash_fwd"] - mm) / 1e3}


def _hybrid_steady(run, torch, np, cfg, params, name):
    """One cache form with 8 live lanes, the long request among them (its
    ring wrapped): a replayed decode step (graph_step_record), then
    eagerly a decode step's device time by part and the idle share over 4
    ticks, and B6 or B7 per launch at the live lanes against the bound,
    the plain version and SDPA (_time_decode_kernel)."""
    from repro_torch.core.jit import disable_graphs
    from repro_torch.models import rglru as rg
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, max_batch=8, cache_len=HYBRID_CACHE_LEN,
                        device=DEVICE, **MOE_CONFIGS[name])
    sched = eng.scheduler(max_new_cap=SERVE_MAX_NEW)
    for r in hybrid_requests(np, cfg, SEED + 113, n=7):
        sched.submit(r)
    sched.tick()                                     # admits all 8
    for _ in range(4):
        sched.tick()
    graph = graph_step_record(run, torch, "serve_hybrid", name, sched)
    with disable_graphs():               # the ranges run only eagerly
        sched.tick()
        profile = _profile_ranged_ticks(
            torch, sched, 4, rg, {"rec_block_step": ("rec_block",
                                                     HYBRID_REC_PART)})
    kernel = _time_decode_kernel(torch, cfg, sched, "int8" in name,
                                 "paged" in name, long=False)
    sched.run()
    return {"config": name, "step_profile": {"mode": "eager", **profile},
            "graph_step_profile": graph, "kernel": kernel}


def phase_serve_hybrid(run, torch, np, card):
    """RecurrentGemma-9B at full width and depth (38 layers: 26 RG-LRU
    blocks and 12 local-attention layers, d 4096, 16/1 heads of 256,
    window 2048, vocab 256000, 10.44 B parameters, 41.8 GB in fp32)
    through ServingEngine at batch 8, cache 2048 (the ring is the whole
    window): the 16 greedy requests of serve_requests and one of 2100
    tokens that prefills past the window and decodes on a wrapped ring,
    on the kernels and on ``ref``, in ring fp32 and paged int8; tokens
    equal ``ref`` (streams part only at near-ties, fp32 logit gap <=
    MOE_GAP); B8 12 x full prefills and B6/B7 12 x decode steps, none on
    ``ref``; 8 ticks under sync debug mode "error"; paged lanes own their
    window (full allocation, no prefix sharing).  Three prompts (the
    2100-token one among them) layer by layer on the same input within
    HYBRID_TOL (_hybrid_prefill_layerwise), the doubling scan at T 2100 x
    4096 against a sequential fp64 recurrence, and the end-to-end prefill
    beside the model's own sensitivity.  A warm run's decode tokens/s and
    TTFT; per cache form a decode step by part and B6/B7 at the live
    lanes; B6 at 8 lanes of 32, 512 and 2048 valid slots; B8 at the 1 x
    300 and 1 x 2100 prefills beside SDPA; the device ms of a 300- and a
    2100-token prefill by part.  Every run replays the captured decode
    step; each form's kernels run is held to the same requests under
    ``disable_graphs()`` (graph_against_eager), ring fp32's to 8
    requests sampled at GRAPH_TEMP, a replayed step is profiled per form,
    and after the replays every B6/B7 workspace's counters read 0, the
    wide route's (G 16) among them: its replays needed no reset.  The
    graph engine is freed before each eager one; the phase's peak device
    memory is reported."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dattn
    from repro_torch.kernels import ops as kops
    from repro_torch.models import rglru as rg
    from repro_torch.serving.engine import ServingEngine
    set_fp32_exact(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(HYBRID_ARCH)
    n_attn = kernel_layers(cfg)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = device_weights_chunked(np, torch, cfg, SEED + 6)
    torch.cuda.synchronize()
    emit({"phase": "serve_hybrid", "model": cfg.name,
          "params": cfg.param_count(), "layers": rg.layer_kinds(cfg),
          "weights_s": time.perf_counter() - t0,
          "device_memory_allocated_before": before,
          "device_memory_allocated": torch.cuda.memory_allocated()})
    graph_runs = {}
    kops.reset_launches()                            # the main path starts
    for name, opts in MOE_CONFIGS.items():
        outs = {}
        for backend in (None, "ref"):
            window = sync_window(torch) if backend is None else None
            eng = ServingEngine(cfg, params, max_batch=8,
                                cache_len=HYBRID_CACHE_LEN,
                                attn_backend=backend, faults=window,
                                device=DEVICE, **opts)
            reqs = hybrid_requests(np, cfg, SEED + 110)
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
            tag = f"{name}/{backend or 'cuda'}"
            launched = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            prefills = full_prefills(sched, len(reqs))
            dec = "decode_attention_paged_q8" if "paged" in name \
                else "decode_attention"
            want = {"flash_attention": n_attn * prefills,
                    dec: n_attn * sched.decode_steps} if backend is None \
                else {}
            run.check("serve_hybrid", f"{tag}: B8 {n_attn} x full prefills, "
                      f"B6/B7 {n_attn} x decode steps, nothing else",
                      launched == want, launches=launched,
                      prefills=prefills, steps=sched.decode_steps)
            run.check("serve_hybrid", f"{tag}: host_syncs == retired "
                      "requests", sched.host_syncs == len(reqs),
                      host_syncs=sched.host_syncs)
            run.check("serve_hybrid", f"{tag}: the decode step was "
                      "captured", sched._graph is not None)
            run.check("serve_hybrid", f"{tag}: every request generated "
                      f"{SERVE_MAX_NEW} tokens", all(
                          len(r.output) == SERVE_MAX_NEW and r.done
                          and all(0 <= x < cfg.vocab_size for x in r.output)
                          for r in reqs))
            rec = {"phase": "serve_hybrid", "config": tag, "mode": "graph",
                   "wall_s": wall, "graph_captured": sched._graph is not None,
                   "launches": launched, "decode_steps": sched.decode_steps,
                   "host_syncs": sched.host_syncs,
                   "full_prefills": prefills, "tokens": stats.tokens_out,
                   "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
                   "decode_tokens_per_s": stats.tok_per_s}
            if backend is None:
                rec["sync_window"] = {"start_tick": window.start,
                                      "ok": window.done}
                run.check("serve_hybrid", f"{tag}: 8 ticks under sync debug "
                          "mode 'error' with no retirement", window.done,
                          start=window.start)
            if sched._paged:
                run.check("serve_hybrid", f"{tag}: full allocation, no "
                          "prefix sharing", sched._alloc_mode == "full"
                          and not sched.prefix_sharing
                          and sched.prefix_hits == 0)
                sched.audit_pages()
            emit(rec)
            outs[backend or "cuda"] = [r.output for r in reqs]
            if backend is None:
                graph_runs[name] = (rec, outs["cuda"])
            del eng, sched
        ok, equal, gaps = _tokens_or_near_ties(torch, cfg, params, reqs,
                                               outs["cuda"], outs["ref"])
        run.check("serve_hybrid", f"{name}: greedy tokens on cuda equal ref, "
                  f"streams parting only at near-ties (gap <= {MOE_GAP})",
                  ok, requests_equal=equal, gaps=gaps)
        emit({"phase": "serve_hybrid", "config": name,
              "tokens_equal_ref": outs["cuda"] == outs["ref"],
              "requests_equal": f"{equal}/{len(reqs)}",
              "long_request_equal": outs["cuda"][2] == outs["ref"][2],
              "divergence_logit_gaps": gaps})
        torch.cuda.empty_cache()
    counts = kops.launches()                         # read just after
    path = {"flash_attention": counts["flash_attention"],
            "decode_attention": counts["decode_attention"],
            "decode_attention_paged": counts["decode_attention_paged_q8"]}
    emit({"phase": "serve_hybrid", "main_path_launches": path})
    eager = graph_against_eager(
        run, torch, np, kops, "serve_hybrid", cfg, graph_runs,
        lambda form, seed: ServingEngine(
            cfg, params, max_batch=8, cache_len=HYBRID_CACHE_LEN,
            device=DEVICE, seed=seed, **MOE_CONFIGS[form]),
        lambda: hybrid_requests(np, cfg, SEED + 110))
    serving_peak = torch.cuda.max_memory_allocated()
    bucketed_against_eager(
        run, torch, np, kops, "serve_hybrid", cfg,
        lambda form, buckets: ServingEngine(
            cfg, params, max_batch=8, cache_len=HYBRID_CACHE_LEN,
            device=DEVICE, prefill_buckets=buckets, **MOE_CONFIGS[form]),
        ("paged-int8",), SEED + 118)
    # three prompts layer by layer on the same input, the long one first
    reqs = hybrid_requests(np, cfg, SEED + 110)
    layerwise = []
    for r in (reqs[2], reqs[0], reqs[3]):
        toks = torch.tensor([r.prompt], device=DEVICE)
        res = _hybrid_prefill_layerwise(torch, cfg, params, toks)
        layerwise.append({"prompt": len(r.prompt), **res})
        for part, v in res.items():
            run.check("serve_hybrid", f"prefill of {len(r.prompt)} tokens, "
                      f"every layer on the same input: {part} (rtol/atol "
                      f"{HYBRID_TOL})", v["mismatches"] == 0, **v)
    emit({"phase": "serve_hybrid", "prefill_layerwise": layerwise})
    long_toks = torch.tensor([reqs[2].prompt], device=DEVICE)
    scan = _hybrid_scan_fp64(torch, cfg, params, long_toks)
    run.check("serve_hybrid", f"the doubling scan at T {scan['T']} x "
              f"{scan['width']} vs a sequential fp64 recurrence (atol "
              f"{HYBRID_TOL} x max(1, max |h|))", scan["max_abs_err"]
              <= HYBRID_TOL * max(1.0, scan["max_abs_h"]), **scan)
    e2e = _hybrid_prefill_end_to_end(torch, cfg, params, long_toks)
    emit({"phase": "serve_hybrid", "scan_fp64": scan,
          "prefill_end_to_end": {"prompt": HYBRID_LONG, **e2e}})
    # a warm run: decode tokens/s and TTFT from the scheduler's counters
    eng = ServingEngine(cfg, params, max_batch=8, cache_len=HYBRID_CACHE_LEN,
                        device=DEVICE)
    eng.generate_batch(serve_requests(np, cfg, SEED + 111, n=8, hi=50))
    sched = eng.scheduler()
    sched.metrics.reset()
    stats = eng.generate_batch(hybrid_requests(np, cfg, SEED + 112))
    ttft = sched.metrics.histogram("req.ttft_s").snapshot()
    del eng, sched
    steady = {name: _hybrid_steady(run, torch, np, cfg, params, name)
              for name in MOE_CONFIGS}
    counters = ticket_counters(torch)
    wide = {k: v for k, v in counters.items() if k[3] == 16}
    run.check("serve_hybrid", "after the replays every B6/B7 workspace's "
              "counters read 0, the wide route's (G 16) among them: its "
              "replays needed no reset", bool(wide)
              and not any(counters.values()),
              counters={str(k): v for k, v in counters.items()})
    prefill = [hybrid_prefill_profile(torch, cfg, params, torch.tensor(
        [r.prompt[:n]], device=DEVICE)) for r, n in
        ((reqs[2], PREFILL_SEQ), (reqs[2], HYBRID_LONG))]
    gen = torch.Generator().manual_seed(SEED + 115)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(DEVICE)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b8 = {f"1x{sq}": _b8_prefill_times(torch, randn, h, kvh, d, sq=sq,
                                       window=cfg.local_window)
          for sq in (PREFILL_SEQ, HYBRID_LONG)}
    for shape, t in b8.items():
        run.check("serve_hybrid", f"B8 at the {shape} prefill: SDPA "
                  "computes the kernel's function (atol 1e-4)",
                  t["library_vs_kernel_max_abs"] <= 1e-4,
                  err=t["library_vs_kernel_max_abs"])
    # B6 at 8 lanes of one valid length on 12 synthetic layers: how its
    # time grows with the splits a lane fills (the last CTA merges them)
    by_valid = {}
    for v in (32, 512, HYBRID_CACHE_LEN):
        cases = [decode_case(torch, gen, DEVICE, b=8, kvh=kvh, g=h // kvh,
                             dtype="float32", layout="bksd", paged=False,
                             s=HYBRID_CACHE_LEN, d=d, valid=[v] * 8)
                 for _ in range(n_attn)]
        rec = decode_launch_record(torch, cases, h, d, plain=False)
        by_valid[v] = {k: rec[k] for k in ("device_us", "bound_ms",
                                           "share_of_bound",
                                           "max_abs_err_fp64")}
        by_valid[v]["splits_used"] = dattn.splits_used(dattn.plan(
            8, kvh, h // kvh, d, 4, slots=HYBRID_CACHE_LEN), v)
        del cases
    for name, st in steady.items():
        run.check("serve_hybrid", f"{name} at the live lanes: SDPA computes "
                  "the kernel's function (atol 1e-4)",
                  st["kernel"]["library_vs_kernel_max_abs"] <= 1e-4,
                  err=st["kernel"]["library_vs_kernel_max_abs"])
    emit({"phase": "serve_hybrid", "card": card["nvidia_smi"], "warm": True,
          "requests": SERVE_REQUESTS + 1, "max_new": SERVE_MAX_NEW,
          "decode_tokens_per_s": stats.tok_per_s, "decode_s": stats.decode_s,
          "prefill_s": stats.prefill_s, "ttft_s": ttft, "steady": steady,
          "graph_decode_tokens_per_s": {
              n: graph_runs[n][0]["decode_tokens_per_s"] for n in graph_runs},
          "eager_decode_tokens_per_s": {
              n: e["decode_tokens_per_s"] for n, e in eager.items()},
          "b8_prefill": b8, "b6_by_valid_len": by_valid,
          "prefill_profile": prefill,
          "serving_max_memory_allocated": serving_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del params
    torch.cuda.empty_cache()
    return {"launches": path, "b8_prefill": b8,
            "decode": {name: st["kernel"] for name, st in steady.items()}}


AUDIO_ARCH = "whisper-medium"
AUDIO_TOL = 1e-4         # a layer's output on the same input, cuda vs ref
AUDIO_CACHE_LEN = 448    # Whisper's published decoder context
AUDIO_PROMPT = 300       # the layer-by-layer prompt, with random frames
AUDIO_CROSS_PART = "cross-attention decode (B6, bskd, 1500 frames)"


def audio_want(cfg, prefills, steps, paged):
    """The launches of Whisper's main path: B8 for every encoder layer and
    for each decoder layer's self- and cross-attention per full prefill;
    per decode step B6 for each layer's cross-attention and B6 (ring fp32)
    or B7 (paged int8) for its self-attention."""
    L, E = cfg.num_layers, cfg.encoder_layers
    want = {"flash_attention": (E + 2 * L) * prefills,
            "decode_attention": L * steps}
    dec = "decode_attention_paged_q8" if paged else "decode_attention"
    want[dec] = want.get(dec, 0) + L * steps
    return want


def _audio_layerwise(torch, cfg, params, toks, frames):
    """One prompt with random frames, layer by layer on the ``ref``
    trajectory, each layer from the same input: every encoder layer (B8
    at 1500 x 1500, non-causal) and, per decoder layer, its causal
    self-attention (B8), its cross-attention (B8, the prompt against the
    1500 encoder outputs) and the whole layer with its MLP (which runs no
    kernel), cuda against ref.  Per part: (max abs error, count outside
    AUDIO_TOL)."""
    from repro_torch.models import common as cm
    from repro_torch.models import encdec as ed
    out = {}

    def add(part, got, want):
        err, bad = compare(torch, got, want, AUDIO_TOL, AUDIO_TOL)
        e0, b0 = out.get(part, (0.0, 0))
        out[part] = (max(e0, err), b0 + bad)
    with torch.inference_mode():
        x = frames + ed.sinusoid(frames.shape[1], cfg.d_model, frames.device)
        for lp in ed._layers(params["enc"]):
            y = ed.enc_layer(cfg, lp, x, "ref")
            add("encoder layer", ed.enc_layer(cfg, lp, x), y)
            x = y
        enc_out = cm.layer_norm(x, params["enc_final_ln_w"],
                                params["enc_final_ln_b"])
        x = params["embed"][toks]
        for lp in ed._layers(params["dec"]):
            a_r = ed._self_attn(cfg, lp, x, backend="ref")[0]
            add("decoder self-attention", ed._self_attn(cfg, lp, x)[0], a_r)
            ax_r = ed._cross_attn(cfg, lp, x + a_r, enc_out, "ref")[0]
            add("cross-attention",
                ed._cross_attn(cfg, lp, x + a_r, enc_out)[0], ax_r)
            y = ed._dec_layer(cfg, lp, x, enc_out, backend="ref")[0]
            add("decoder layer (with its MLP)",
                ed._dec_layer(cfg, lp, x, enc_out)[0], y)
            x = y
    return {k: {"max_abs_err": e, "mismatches": b} for k, (e, b) in out.items()}


def audio_prefill_profile(torch, cfg, params, toks):
    """One admission's prefill (``encdec.prefill`` on the kernels, zero
    frames, under inference mode): device ms by part, B8 and the cuBLAS
    products beside the rest (:func:`device_us_by`)."""
    from repro_torch.models import encdec as ed

    def call():
        with torch.inference_mode():
            ed.prefill(cfg, params, toks, AUDIO_CACHE_LEN,
                       cache_dtype=torch.float32)
    parts = device_us_by(torch, call, ("flash_fwd", "gemm", "Gemm", ""),
                         n=2, warm=1)
    if parts is None:
        return None
    mm = parts["gemm"] + parts["Gemm"]
    return {"prompt": int(toks.shape[1]), "device_ms": parts[""] / 1e3,
            "b8_ms": parts["flash_fwd"] / 1e3, "matmul_ms": mm / 1e3,
            "other_ms": (parts[""] - parts["flash_fwd"] - mm) / 1e3}


def _time_cross_decode(torch, cfg, sched):
    """B6 on the cross-attention's 'bskd' caches of the live lanes (8 x
    1500 frames, every lane's valid length the encoder's, each decoder
    layer's xk/xv in turn) against the bound, the plain version, fp64 and
    SDPA (decode_launch_record, decode_library_record)."""
    cache = sched.state["cache"]
    b, h, d = sched.max_slots, cfg.num_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(SEED + 124)
    q = torch.randn(b, h, d, generator=gen).to(DEVICE)
    valid = torch.full((b,), cfg.encoder_seq, dtype=torch.int32,
                       device=DEVICE)
    cases = [{"q": q, "k": cache["xk"][l], "v": cache["xv"][l],
              "scales": None, "valid": valid}
             for l in range(cache["xk"].shape[0])]
    return {**decode_launch_record(torch, cases, h, d, layout="bskd"),
            **decode_library_record(torch, cases, "bskd"),
            "batch": b, "heads": h, "kv_heads": cfg.num_kv_heads,
            "head_dim": d, "slots": cfg.encoder_seq, "layout": "bskd"}


def _audio_steady(run, torch, np, cfg, params, name):
    """One cache form with 8 live lanes: a replayed decode step
    (graph_step_record), then eagerly a decode step's device time by part
    (the cross-attention's B6 apart from the self-attention's B6/B7) and
    the idle share over 4 ticks; the self-attention's B6 or B7 at the
    live lanes and, ring fp32, the cross-attention's B6 at 8 x 1500,
    beside the bound, the plain version and SDPA."""
    from repro_torch.core.jit import disable_graphs
    from repro_torch.models import encdec as ed
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, max_batch=8, cache_len=AUDIO_CACHE_LEN,
                        device=DEVICE, **MOE_CONFIGS[name])
    sched = eng.scheduler(max_new_cap=SERVE_MAX_NEW)
    for r in serve_requests(np, cfg, SEED + 123, n=8):
        sched.submit(r)
    sched.tick()                                     # admits all 8
    for _ in range(4):
        sched.tick()
    graph = graph_step_record(run, torch, "serve_audio", name, sched)
    with disable_graphs():               # the ranges run only eagerly
        sched.tick()
        profile = _profile_ranged_ticks(
            torch, sched, 4, ed, {"cross_decode_attention": (
                "cross_attn", AUDIO_CROSS_PART)})
    rec = {"config": name, "step_profile": {"mode": "eager", **profile},
           "graph_step_profile": graph,
           "kernel": _time_decode_kernel(torch, cfg, sched, "int8" in name,
                                         "paged" in name, long=False,
                                         layout="bskd")}
    if "paged" not in name:
        rec["cross"] = _time_cross_decode(torch, cfg, sched)
    sched.run()
    return rec


def phase_serve_audio(run, torch, np, card):
    """Whisper-medium at full width and depth (24 encoder + 24 decoder
    layers, d 1024, 16/16 heads of 64, 1500 frames, vocab 51865; 758.5 M
    parameters, 3.03 GB fp32) through ServingEngine at batch 8, cache 448
    (Whisper's decoder context): serve_requests' 16 greedy requests (5 to
    300 tokens, zero frames as the scheduler passes none), 48 new tokens,
    on the kernels and on ``ref``, in ring fp32 and paged int8; tokens
    equal ``ref`` (streams part only at near-ties, fp32 logit gap <=
    MOE_GAP, the parted lane's logits logged); exactly audio_want's
    launches, none on ``ref``; one host sync per request; 8 ticks under
    sync debug mode "error"; paged lanes allocate incrementally with no
    prefix sharing.  A 300-token prompt with random frames layer by layer
    on the same input within AUDIO_TOL (_audio_layerwise).  A warm run's
    decode tokens/s and TTFT; per cache form a decode step by part and
    B6/B7 at the live lanes; B6 at 8 x 1500 'bskd' (cross); B8 at the 1 x
    1500 encoder, the 1 x 300 x 1500 cross and the 1 x 300 decoder
    shapes beside SDPA; one admission's prefill by part.  Every run
    replays the captured decode step; each form's kernels run is held to
    the same requests under ``disable_graphs()``
    (graph_against_eager), ring fp32's to 8 requests sampled at
    GRAPH_TEMP, a replayed step is profiled per form, and B6/B7's ticket
    counters read 0 after the replays."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.engine import ServingEngine
    set_fp32_exact(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(AUDIO_ARCH)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = device_weights_chunked(np, torch, cfg, SEED + 7)
    torch.cuda.synchronize()
    emit({"phase": "serve_audio", "model": cfg.name,
          "params": cfg.param_count(), "weights_s": time.perf_counter() - t0,
          "device_memory_allocated_before": before,
          "device_memory_allocated": torch.cuda.memory_allocated()})

    def make_requests():
        return serve_requests(np, cfg, SEED + 120)
    graph_runs = {}
    kops.reset_launches()                            # the main path starts
    for name, opts in MOE_CONFIGS.items():
        outs = {}
        for backend in (None, "ref"):
            window = sync_window(torch) if backend is None else None
            eng = ServingEngine(cfg, params, max_batch=8,
                                cache_len=AUDIO_CACHE_LEN,
                                attn_backend=backend, faults=window,
                                device=DEVICE, **opts)
            reqs = make_requests()
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
            tag = f"{name}/{backend or 'cuda'}"
            launched = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            prefills = full_prefills(sched, len(reqs))
            want = audio_want(cfg, prefills, sched.decode_steps,
                              sched._paged) if backend is None else {}
            run.check("serve_audio", f"{tag}: B8 (24 + 2 x 24) x full "
                      "prefills, B6 (cross) and B6/B7 (self) 24 x decode "
                      "steps each, nothing else", launched == want,
                      launches=launched, want=want, prefills=prefills,
                      steps=sched.decode_steps)
            run.check("serve_audio", f"{tag}: host_syncs == retired "
                      "requests", sched.host_syncs == len(reqs),
                      host_syncs=sched.host_syncs)
            run.check("serve_audio", f"{tag}: the decode step was "
                      "captured", sched._graph is not None)
            run.check("serve_audio", f"{tag}: every request generated "
                      f"{SERVE_MAX_NEW} tokens", all(
                          len(r.output) == SERVE_MAX_NEW and r.done
                          and all(0 <= x < cfg.vocab_size for x in r.output)
                          for r in reqs))
            rec = {"phase": "serve_audio", "config": tag, "mode": "graph",
                   "wall_s": wall, "graph_captured": sched._graph is not None,
                   "launches": launched, "decode_steps": sched.decode_steps,
                   "host_syncs": sched.host_syncs,
                   "full_prefills": prefills, "tokens": stats.tokens_out,
                   "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
                   "decode_tokens_per_s": stats.tok_per_s}
            if backend is None:
                rec["sync_window"] = {"start_tick": window.start,
                                      "ok": window.done}
                run.check("serve_audio", f"{tag}: 8 ticks under sync debug "
                          "mode 'error' with no retirement", window.done,
                          start=window.start)
            if sched._paged:
                run.check("serve_audio", f"{tag}: incremental allocation, "
                          "no prefix sharing", sched._alloc_mode ==
                          "incremental" and not sched.prefix_sharing
                          and sched.prefix_hits == 0)
                sched.audit_pages()
            emit(rec)
            outs[backend or "cuda"] = [r.output for r in reqs]
            if backend is None:
                graph_runs[name] = (rec, outs["cuda"])
            del eng, sched
        ok, equal, gaps = _tokens_or_near_ties(torch, cfg, params, reqs,
                                               outs["cuda"], outs["ref"])
        run.check("serve_audio", f"{name}: greedy tokens on cuda equal ref, "
                  f"streams parting only at near-ties (gap <= {MOE_GAP})",
                  ok, requests_equal=equal, gaps=gaps)
        rec = {"phase": "serve_audio", "config": name,
               "tokens_equal_ref": outs["cuda"] == outs["ref"],
               "requests_equal": f"{equal}/{len(reqs)}",
               "divergence_logit_gaps": gaps}
        if outs["cuda"] != outs["ref"]:
            rec["parted_lane_logits"] = parted_lane_logits(
                torch, kops, cfg, params, opts, make_requests, outs["cuda"],
                outs["ref"], cache_len=AUDIO_CACHE_LEN)
        emit(rec)
        torch.cuda.empty_cache()
    counts = kops.launches()                         # read just after
    path = {"flash_attention": counts["flash_attention"],
            "decode_attention": counts["decode_attention"],
            "decode_attention_paged": counts["decode_attention_paged_q8"]}
    emit({"phase": "serve_audio", "main_path_launches": path})
    eager = graph_against_eager(
        run, torch, np, kops, "serve_audio", cfg, graph_runs,
        lambda form, seed: ServingEngine(
            cfg, params, max_batch=8, cache_len=AUDIO_CACHE_LEN,
            device=DEVICE, seed=seed, **MOE_CONFIGS[form]), make_requests)
    bucketed_against_eager(
        run, torch, np, kops, "serve_audio", cfg,
        lambda form, buckets: ServingEngine(
            cfg, params, max_batch=8, cache_len=AUDIO_CACHE_LEN,
            device=DEVICE, prefill_buckets=buckets, **MOE_CONFIGS[form]),
        ("paged-int8",), SEED + 128)
    # a 300-token prompt with random frames, layer by layer
    gen = torch.Generator().manual_seed(SEED + 121)
    frames = torch.randn(1, cfg.encoder_seq, cfg.d_model,
                         generator=gen).to(DEVICE)
    toks = torch.tensor([np.random.default_rng(SEED + 122).integers(
        1, cfg.vocab_size, AUDIO_PROMPT).tolist()], device=DEVICE)
    layerwise = _audio_layerwise(torch, cfg, params, toks, frames)
    for part, v in layerwise.items():
        run.check("serve_audio", f"prompt of {AUDIO_PROMPT} tokens, random "
                  f"frames, every layer on the same input: {part} "
                  f"(rtol/atol {AUDIO_TOL})", v["mismatches"] == 0, **v)
    emit({"phase": "serve_audio", "prefill_layerwise": layerwise})
    # a warm run (the runs above warmed the kernels and cuBLAS): decode
    # tokens/s and TTFT from the scheduler's counters
    eng = ServingEngine(cfg, params, max_batch=8, cache_len=AUDIO_CACHE_LEN,
                        device=DEVICE)
    sched = eng.scheduler(max_new_cap=SERVE_MAX_NEW)
    stats = eng.generate_batch(serve_requests(np, cfg, SEED + 126))
    ttft = sched.metrics.histogram("req.ttft_s").snapshot()
    roofline = {k: v for k, v in sched.roofline_stats().items()
                if k in ("bytes_per_token", "mbu", "mfu",
                         "roofline_tok_per_s")}
    del eng, sched
    steady = {name: _audio_steady(run, torch, np, cfg, params, name)
              for name in MOE_CONFIGS}
    counters = ticket_counters(torch)
    run.check("serve_audio", "B6/B7 ticket counters at 0 after the replays",
              bool(counters) and not any(counters.values()),
              counters={str(k): v for k, v in counters.items()})
    prefill = audio_prefill_profile(torch, cfg, params, toks)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(DEVICE)
    b8 = {"encoder 1x1500": _b8_prefill_times(
              torch, randn, h, kvh, d, sq=cfg.encoder_seq, causal=False),
          "cross 1x300x1500": _b8_prefill_times(
              torch, randn, h, kvh, d, sq=PREFILL_SEQ, sk=cfg.encoder_seq,
              causal=False),
          "decoder 1x300": _b8_prefill_times(torch, randn, h, kvh, d)}
    for shape, t in b8.items():
        run.check("serve_audio", f"B8 at the {shape} shape: SDPA computes "
                  "the kernel's function (atol 1e-4)",
                  t["library_vs_kernel_max_abs"] <= 1e-4,
                  err=t["library_vs_kernel_max_abs"])
    for name, st in steady.items():
        for what, k in (("self-attention", st["kernel"]),
                        ("cross-attention", st.get("cross"))):
            if k is not None:
                run.check("serve_audio", f"{name} {what} at the live lanes: "
                          "SDPA computes the kernel's function (atol 1e-4)",
                          k["library_vs_kernel_max_abs"] <= 1e-4,
                          err=k["library_vs_kernel_max_abs"])
    emit({"phase": "serve_audio", "card": card["nvidia_smi"], "warm": True,
          "requests": SERVE_REQUESTS, "max_new": SERVE_MAX_NEW,
          "decode_tokens_per_s": stats.tok_per_s, "decode_s": stats.decode_s,
          "prefill_s": stats.prefill_s, "ttft_s": ttft, "roofline": roofline,
          "graph_decode_tokens_per_s": {
              n: graph_runs[n][0]["decode_tokens_per_s"] for n in graph_runs},
          "eager_decode_tokens_per_s": {
              n: e["decode_tokens_per_s"] for n, e in eager.items()},
          "steady": steady, "b8": b8, "prefill_profile": prefill,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del params
    torch.cuda.empty_cache()
    return {"launches": path, "b8": b8,
            "decode": {name: st["kernel"] for name, st in steady.items()},
            "cross": steady["ring-fp32"]["cross"]}


# ---------------------------------------------------------------------------
# slice 14: the launch tooling -- the sharded step on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

# the four torch examples the examples phase runs, and the models
# serve_batched_torch's selector must pick, one a location
EXAMPLES = ("quickstart_torch", "compress_models_torch",
            "train_publish_serve_torch", "serve_batched_torch")
EXAMPLE_MODELS = ("tinyllama-1.1b", "qwen3-0.6b", "rwkv6-3b")


def _example(name):
    """examples/<name>.py as a module (its command line not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(torch, kops, name, fn):
    """``fn()`` with its printed lines kept: (its result, the kernel
    launches it made, its seconds, the lines)."""
    before = kops.launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        res = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = kops.launches()
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    emit({"phase": "examples", "example": name, "seconds": seconds,
          "launches": launched, "printed": buf.getvalue().splitlines()})
    return res, launched


def phase_examples(run, torch, np):
    """The four torch examples (examples/*_torch.py), each one's function
    called in this process on the card at its defaults, its printed
    lines and kernel launches recorded: quickstart_torch's class ids
    equal ``ref``'s on the weights its int8 artifact holds (its default
    draws, passed in), on the kernels; compress_models_torch's int8
    ratio, agreement and stage report finite; train_publish_serve_torch
    (150 steps) drops its loss by more than 0.3 (its own check) and
    serves 3 requests of 12 tokens from the store; serve_batched_torch's
    6 rounds pick each location's model, 3 requests of 8 tokens each."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import dequantize_tree, quantize_tree
    from repro_torch.kernels import ops as kops
    from repro_torch.models import cnn
    set_fp32_exact(torch)
    mods = {name: _example(name) for name in EXAMPLES}
    graph = cnn.graph_for(get_config("nin-cifar10"))
    params = graph.init_params(torch.Generator().manual_seed(0))
    images = torch.randn((8, 3, 32, 32),
                         generator=torch.Generator().manual_seed(1))
    preds, launched = _run_example(
        torch, kops, "quickstart_torch", lambda: mods["quickstart_torch"].run(
            DEVICE, params={k: {n: t.numpy() for n, t in v.items()}
                            for k, v in params.items()},
            images=images.numpy()))
    with torch.no_grad():
        stored = {k: {n: t.to(DEVICE) for n, t in v.items()}
                  for k, v in dequantize_tree(quantize_tree(params)).items()}
        want = graph.apply(stored, images.to(DEVICE),
                           backend="ref").argmax(-1).tolist()
    run.check("examples", "quickstart_torch: class ids equal ref's on the "
              "int8 artifact's weights", preds == want, got=preds, ref=want)
    run.check("examples", "quickstart_torch: NIN ran on the kernels",
              launched.get("conv2d", 0) > 0, launches=launched)
    rep, launched = _run_example(
        torch, kops, "compress_models_torch",
        lambda: mods["compress_models_torch"].run(DEVICE))
    numbers = [rep["ratio"], rep["agree"], rep["max_dprob"]] + [
        rep["report"][k][f] for k in ("int8", "pruned", "lowrank",
                                      "lowrank+int8")
        for f in ("ratio", "error")]
    run.check("examples", "compress_models_torch: int8 ratio > 1, agreement "
              "in [0, 1], the stage report finite, NIN on the kernels",
              rep["ratio"] > 1 and 0 <= rep["agree"] <= 1
              and all(math.isfinite(x) for x in numbers)
              and launched.get("conv2d", 0) > 0,
              ratio=rep["ratio"], agree=rep["agree"], launches=launched)
    (losses, reqs), launched = _run_example(
        torch, kops, "train_publish_serve_torch",
        lambda: mods["train_publish_serve_torch"].run(DEVICE))
    drop = losses[0] - losses[-1]
    run.check("examples", "train_publish_serve_torch: loss drop > 0.3, 3 "
              "requests of 12 tokens served from the store, B9 and B8 "
              "launched", drop > 0.3 and [len(r.output) for r in reqs]
              == [12] * 3 and launched.get("flash_attention_dq", 0) > 0
              and launched.get("flash_attention", 0) > 0,
              drop=drop, steps=len(losses), launches=launched)
    served, launched = _run_example(
        torch, kops, "serve_batched_torch",
        lambda: mods["serve_batched_torch"].run(DEVICE))
    picks = [m for _, m, _ in served]
    run.check("examples", "serve_batched_torch: every round picks its "
              "location's model, every request 8 tokens",
              picks == [EXAMPLE_MODELS[loc] for loc, _, _ in served]
              and len(served) == 6 and all(
                  len(t) == 8 for _, _, toks in served for t in toks),
              picks=picks, launches=launched)


MESH_LAYERS = 2                  # depth of both models of the mesh phase
MESH_TRAIN = dict(batch=4, seq=2048)
MESH_MOE_TOKENS = (4, 512)
MESH_MOE_TOL = 1e-5              # max |logit diff| vs the eager forward
FLASH_KERNELS = ("flash_attention", "flash_attention_fwd",
                 "flash_attention_dq", "flash_attention_dkv")


def _flash_counts(kops):
    return {k: v for k, v in kops.launches().items() if k in FLASH_KERNELS}


def _mesh_train(run, torch, np, mesh, tiny_np):
    """TinyLlama at full width, 2 layers, one step of dryrun.build_step
    on DTensors against the eager make_train_step and step-1 grads."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim.adamw import (AdamW, cosine_schedule, tree_items,
                                         tree_map)
    from repro_torch.sharding_hints import axis_rules
    cfg, np_params = cut_depth(get_config("tinyllama-1.1b"), tiny_np,
                               MESH_LAYERS)
    b, s = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
    batch0 = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                    global_batch=b, seed=SEED)).batch(0)
    # eager: the trainer's step (loss, launches), then step-1 grads
    params = params_from_numpy(np_params, DEVICE, cfg=cfg)
    for _, x in tree_items(params):
        x.requires_grad_()
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
    kops.reset_launches()
    _, _, metrics = make_train_step(cfg, opt)(params, opt.init(params),
                                              to_device(batch0, DEVICE))
    loss_eager = float(metrics["loss"])
    eager_counts = _flash_counts(kops)
    del params, metrics
    _, g_eager = _step1_grads(torch, cfg, np_params, batch0, None)
    # sharded: the dry run's step on real DTensors
    rules = shd.rules_for("train")
    with axis_rules(rules, mesh):
        step, _, shardings = build_step(cfg, ShapeSpec("mesh_train", s, b,
                                                       "train"),
                                        rules, mesh, dtype=torch.float32)
        params = params_from_numpy(np_params, DEVICE, cfg=cfg)
        zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)
        state = {"step": torch.zeros((), dtype=torch.int32, device=DEVICE),
                 "m": tree_map(zeros, params), "v": tree_map(zeros, params)}
        args = [shd.distribute(t, p, mesh) for t, p in
                zip((params, state, to_device(batch0, DEVICE)), shardings)]
        torch.cuda.synchronize()
        kops.reset_launches()                        # the main path starts
        t0 = time.perf_counter()
        _, _, loss, grads = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mesh_counts = _flash_counts(kops)            # read just after
    loss_mesh = float(loss.full_tensor())
    rel, bit_equal = {}, loss_mesh == loss_eager
    for path, g in tree_items(grads):
        key = "/".join(path)
        gl, ge = g.full_tensor(), g_eager[key]
        rel[key] = float((gl - ge).norm() / ge.norm().clamp_min(1e-30))
        bit_equal &= bool(torch.equal(gl, ge))
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_mesh - loss_eager) / abs(loss_eager)
    run.check("mesh", f"train: loss vs eager (rtol {TRAIN_LOSS_RTOL})",
              loss_rel <= TRAIN_LOSS_RTOL, mesh=loss_mesh, eager=loss_eager)
    run.check("mesh", f"train: step-1 grads vs eager, per leaf ||dg|| / "
              f"||g|| <= {TRAIN_GRAD_REL}",
              rel[worst] <= TRAIN_GRAD_REL, worst=worst, rel=rel[worst])
    L = cfg.num_layers
    want = {"flash_attention_fwd": 2 * L, "flash_attention_dq": L,
            "flash_attention_dkv": L}
    run.check("mesh", "train: B9 launches equal the eager step's "
              f"(forward 2 x {L}, dq and dk/dv {L})",
              mesh_counts == eager_counts and
              all(mesh_counts[k] == v for k, v in want.items()),
              mesh=mesh_counts, eager=eager_counts)
    return {"model": cfg.name, "layers": L, "batch": b, "seq": s,
            "loss": {"mesh": loss_mesh, "eager": loss_eager},
            "loss_rel": loss_rel, "grad_rel_worst": {worst: rel[worst]},
            "bit_equal": bit_equal, "launches": mesh_counts,
            "eager_launches": eager_counts, "step_s": wall}


def _mesh_moe(run, torch, np, mesh):
    """Granite-MoE at full width, 2 layers: one forward per moe_impl on
    DTensors against the eager forward."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import sharding as shd
    from repro_torch.models import moe, param_template
    from repro_torch.sharding_hints import axis_rules
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MESH_LAYERS)
    np_params = numpy_weights_chunked(np, cfg, SEED + 140)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 141).integers(
        0, cfg.vocab_size, MESH_MOE_TOKENS)).to(DEVICE)
    params = params_from_numpy(np_params, DEVICE, cfg=cfg)
    with torch.no_grad():
        kops.reset_launches()
        want, _ = moe.forward(cfg, params, tokens)
        eager_counts = _flash_counts(kops)
    out = {}
    for impl, extra in (("dense", {}), ("a2a", {"tp_ff": None}),
                        ("local", {"experts": None, "tp_ff": None})):
        rules = shd.rules_for("train", overrides={"moe_impl": impl, **extra})
        with axis_rules(rules, mesh), torch.no_grad():
            dparams = shd.shard_params(params, param_template(cfg), rules,
                                       mesh)
            tok = shd.distribute(tokens, shd.struct_shardings(
                tokens, ("batch", None), rules, mesh), mesh)
            kops.reset_launches()                    # the main path starts
            t0 = time.perf_counter()
            got, aux = moe.forward(cfg, dparams, tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _flash_counts(kops)             # read just after
        got = got.full_tensor()
        err = float((got - want).abs().max())
        run.check("mesh", f"moe/{impl}: logits vs eager (max |d| <= "
                  f"{MESH_MOE_TOL})", err <= MESH_MOE_TOL and
                  bool(torch.isfinite(got).all()), err=err)
        run.check("mesh", f"moe/{impl}: B8 launches equal the eager "
                  f"forward's ({MESH_LAYERS})", counts == eager_counts and
                  counts["flash_attention"] == MESH_LAYERS, launches=counts)
        out[impl] = {"max_abs_err": err, "bit_equal": bool(
            torch.equal(got, want)), "launches": counts, "forward_s": wall}
    return {"model": cfg.name, "layers": MESH_LAYERS,
            "tokens": list(MESH_MOE_TOKENS), "impls": out}


def _mesh_dryrun(run):
    """The full-size Granite prefill_32k dry run (optimized: (32, 8) fake
    mesh, a2a) in a subprocess, as a user runs it."""
    out = ROOT / "build" / "dryrun_chip"
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           MOE_ARCH, "--shape", "prefill_32k", "--optimized", "--out",
           str(out)]
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env, cwd=ROOT)
    wall = time.perf_counter() - t0
    files = sorted(out.glob("*.json"))
    res = json.loads(files[0].read_text()) if files else {}
    roof = res.get("roofline", {})
    terms = {k: roof.get(k, 0.0) for k in ("compute_s", "memory_s",
                                           "collective_s")}
    run.check("mesh", "dryrun: exit 0, one result, every term > 0",
              r.returncode == 0 and len(files) == 1 and
              all(v > 0 for v in terms.values()) and res.get("mesh") ==
              "32x8", rc=r.returncode, stderr=r.stderr[-1500:])
    return {"cmd": " ".join(cmd[1:]), "wall_s": wall, "mesh":
            res.get("mesh"), "hw": res.get("hw"), **terms,
            "bottleneck": roof.get("bottleneck"),
            "useful_flops_ratio": roof.get("useful_flops_ratio"),
            "flops_per_device": res.get("flops_per_device"),
            "bytes_per_device": res.get("bytes_per_device"),
            "wire_bytes_per_device": res.get("wire_bytes_per_device"),
            "collectives": res.get("collectives"), "run_s": res.get("run_s")}


# the memory check: six steps of dryrun.build_step at full width and
# MESH_LAYERS deep in fp32, (name, arch, kind, batch, seq, the pair whose
# rules the step takes, or None for rules_for(kind)); Granite's prefill
# twice, through the a2a body (the pair's overrides) and the dense body
# (the base rules: at MESH_MOE_TOKENS its expert products contract d),
# and its train step through the dense body (4 x 2048 tokens gather the
# weights) with its backward
MESH_MEMORY_STEPS = (
    ("train", "tinyllama-1.1b", "train", MESH_TRAIN["batch"],
     MESH_TRAIN["seq"], None),
    ("prefill", "tinyllama-1.1b", "prefill", 4, 2048, None),
    ("decode", "tinyllama-1.1b", "decode", 8, 2048, None),
    ("moe_prefill", MOE_ARCH, "prefill", *MESH_MOE_TOKENS, "prefill_32k"),
    ("moe_dense_prefill", MOE_ARCH, "prefill", *MESH_MOE_TOKENS, None),
    ("moe_dense_train", MOE_ARCH, "train", 4, 2048, None),
)
MESH_MEMORY_TOL = 0.10           # |counted - measured peak| / measured
# a tighter reading printed beside the bar (not a gate): a count that
# drifts from the allocator by more shows here first
MESH_MEMORY_WATCH = 0.01
# a position that has wrapped a 2048-slot ring (the decode checks)
MESH_WRAPPED_POS = 2048 + 517
# kernel launches of each step on the card (L = MESH_LAYERS)
MESH_MEMORY_LAUNCHES = {
    "train": {"flash_attention_fwd": 2, "flash_attention_dq": 1,
              "flash_attention_dkv": 1},
    "prefill": {"flash_attention": 1},
    "decode": {"decode_attention": 1},
    "moe_prefill": {"flash_attention": 1},
    "moe_dense_prefill": {"flash_attention": 1},
    "moe_dense_train": {"flash_attention_fwd": 2, "flash_attention_dq": 1,
                        "flash_attention_dkv": 1},
}
MEMORY_COUNT = """
import dataclasses, json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
dryrun.init_fake_group(1)
mesh = make_production_mesh(shape=(1, 1))
out = {}
for name, arch, kind, b, s, layers, rules in json.loads(sys.argv[1]):
    rules = {k: tuple(v) if isinstance(v, list) else v
             for k, v in rules.items()}
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    _, out[name] = dryrun.count_step(cfg, ShapeSpec(name, s, b, kind), rules,
                                     mesh, torch.float32)
print("RESULT " + json.dumps(out))
"""


def _memory_rules(arch, kind, pair):
    from repro_torch.launch import sharding as shd
    rules = shd.rules_for_pair(arch, pair, kind, optimized=True) if pair \
        else shd.rules_for(kind)
    rules.pop("_mesh_shape", None)
    return rules


def _start_memory_count():
    """The dry run's count of MESH_MEMORY_STEPS on meta tensors, in a
    subprocess with a one-rank fake group (it runs while the card
    measures)."""
    steps = [(name, arch, kind, b, s, MESH_LAYERS,
              _memory_rules(arch, kind, pair))
             for name, arch, kind, b, s, pair in MESH_MEMORY_STEPS]
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", MEMORY_COUNT,
                             json.dumps(steps)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)


def _on_card(torch, struct):
    """A card tensor of a meta struct's shape and dtype, filled in place
    (no temporary): small positive floats, ints below every vocab."""
    t = torch.empty(struct.shape, dtype=struct.dtype, device=DEVICE)
    return t.uniform_(0.0, 0.02) if t.is_floating_point() \
        else t.random_(0, 1000)


def _mesh_memory_step(torch, mesh, name, arch, kind, b, s, pair):
    """One step of build_step on the card: the argument bytes and the
    peak of a second call, both over memory_allocated() before the
    arguments were made, and the second call's kernel launches.  The
    arguments' bytes are also read as the allocator's requested bytes:
    a block the allocator hands out whole, not split, because less than
    1 MiB of a cached free block would be left (a cache that earlier
    phases left in pieces) counts more allocated bytes than were asked
    for, which the count, by design, does not model."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.dryrun import build_step
    from repro_torch.sharding_hints import axis_rules
    from torch.utils._pytree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch), num_layers=MESH_LAYERS)
    rules = _memory_rules(arch, kind, pair)
    gc.collect()
    torch.cuda.synchronize()
    with axis_rules(rules, mesh):
        step, structs, placements = build_step(
            cfg, ShapeSpec(name, s, b, kind), rules, mesh,
            dtype=torch.float32)
        base = torch.cuda.memory_allocated()
        stats = torch.cuda.memory_stats()
        blocks = stats["allocation.all.current"]
        requested = stats["requested_bytes.all.current"]
        args = tuple(shd.distribute(tree_map(lambda t: _on_card(torch, t),
                                             st), p, mesh)
                     for st, p in zip(structs, placements))
        gc.collect()
        measured_args = torch.cuda.memory_allocated() - base
        stats = torch.cuda.memory_stats()
        requested = stats["requested_bytes.all.current"] - requested
        n_args = len(tree_leaves(structs))
        # allocator blocks alive beside one a leaf: where to look when
        # the argument bytes disagree
        blocks = stats["allocation.all.current"] - blocks - n_args
        out = step(*args)                        # warm: kept workspaces
        del out
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launches()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = {k: v for k, v in kops.launches().items() if v}
        del out
        held = sum(-(-t.to_local().untyped_storage().nbytes() // 512) * 512
                   for t in tree_leaves(args))
        rec = {"measured_args": measured_args, "requested_args": requested,
               "unsplit_bytes": measured_args - held, "measured_peak": peak,
               "arg_tensors": n_args, "other_blocks": blocks,
               "launches": launches, "step_s": wall}
        if kind == "decode":
            rec["against_ref"] = _decode_step_against_ref(torch, step, args)
        del args
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _decode_step_against_ref(torch, step, args):
    """The decode step's attention on the one-rank mesh, whose rank holds
    the whole ring, runs B6 (``cache_attend_sharded``'s 'cuda' route):
    its logits against the same step with the einsum route ('ref'), on
    the same params, token and caches, at the drawn position (below the
    2048 slots) and at one that has wrapped the ring; B6 launched once a
    layer on the first route and never on the second.  Each pair of runs
    writes the same token to the same slot, so both read one cache."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import common as cm
    attend = cm.cache_attend_sharded
    pos = _local(args[3])
    rec = {}

    def run_step():
        kops.reset_launches()
        logits = _local(step(*args)[0]).clone()
        torch.cuda.synchronize()
        return logits, kops.launches()["decode_attention"]

    for label, p in (("below", int(pos.item())), ("wrapped",
                                                 MESH_WRAPPED_POS)):
        pos.fill_(p)
        got, b6 = run_step()
        cm.cache_attend_sharded = functools.partial(attend, backend="ref")
        try:
            want, b6_ref = run_step()
        finally:
            cm.cache_attend_sharded = attend
        rtol, atol = DECODE_TOL
        rec[label] = {"pos": p, "max_abs_err": (got - want).abs().max()
                      .item(), "scale": want.abs().max().item(),
                      "b6_launches": [b6, b6_ref],
                      "ok": bool(torch.isfinite(got).all() and
                                 torch.allclose(got, want, rtol=rtol,
                                                atol=atol) and
                                 [b6, b6_ref] == [MESH_LAYERS, 0])}
    return rec


def _mesh_ring_against_ref(run, torch, mesh):
    """``cache_attend_sharded`` on the one-rank mesh at TinyLlama's decode
    widths (8 lanes, 32 q heads over 4 kv heads of 64, 2048 slots, fp32):
    its B6 route ('cuda') against its einsum route ('ref') on copies of
    the same caches, at a position below the slots and one that has
    wrapped the ring, in both cache layouts, and the cross form (nothing
    written, every slot valid): outputs at DECODE_TOL, the written
    caches equal."""
    from repro_torch.launch import sharding as shd
    from repro_torch.sharding_hints import axis_rules, zeros
    from repro_torch.models import common as cm
    b, kv, h, s, d = 8, 4, 32, 2048, 64
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    rtol, atol = DECODE_TOL
    out = {}
    with axis_rules(shd.rules_for("decode"), mesh):
        def filled(shape, *axes, like=None):
            t = zeros(shape, torch.float32, DEVICE, *axes)
            if like is None:
                _local(t).normal_(generator=gen)
            else:
                _local(t).copy_(_local(like))
            return t

        q = filled((b, 1, h, d), "batch", None, "heads", None)
        for layout in ("bksd", "bskd"):
            cshape = (b, kv, s, d) if layout == "bksd" else (b, s, kv, d)
            caxes = ("batch", "tp_kv", "cache_seq", None) \
                if layout == "bksd" else ("batch", "cache_seq", "tp_kv", None)
            nshape = tuple(1 if n == s else n for n in cshape)
            naxes = tuple(None if a == "cache_seq" else a for a in caxes)
            ck0, cv0 = filled(cshape, *caxes), filled(cshape, *caxes)
            kn, vn = filled(nshape, *naxes), filled(nshape, *naxes)
            for pos in (s // 2 - 1, MESH_WRAPPED_POS, None):
                got = []
                for backend in ("cuda", "ref"):
                    ck = filled(cshape, *caxes, like=ck0)
                    cv = filled(cshape, *caxes, like=cv0)
                    new = (None, None, None) if pos is None else (
                        kn, vn, torch.tensor(pos, device=DEVICE))
                    o = cm.cache_attend_sharded(q, new[0], new[1], ck, cv,
                                                new[2], layout=layout,
                                                backend=backend)
                    got.append((_local(o), _local(ck), _local(cv)))
                (o1, k1, v1), (o2, k2, v2) = got
                key = f"{layout}/{'cross' if pos is None else pos}"
                out[key] = {"max_abs_err": (o1 - o2).abs().max().item()}
                run.check("mesh", f"ring/{key}: B6 route against the einsum "
                          f"route at DECODE_TOL, caches written alike",
                          bool(torch.isfinite(o1).all() and
                               torch.allclose(o1, o2, rtol=rtol, atol=atol)
                               and torch.equal(k1, k2) and
                               torch.equal(v1, v2)), **out[key])
    return out


def _mesh_memory(run, torch, mesh, counting):
    """The dry run's memory count held against the caching allocator:
    each step of MESH_MEMORY_STEPS measured on the card, then counted on
    meta tensors by the same dryrun.count_step (``counting``, started
    before)."""
    from repro_torch.launch.memory import ROUND
    got = {step[0]: _mesh_memory_step(torch, mesh, *step)
           for step in MESH_MEMORY_STEPS}
    try:
        stdout, stderr = counting.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        counting.kill()
        stdout, stderr = counting.communicate()
    lines = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
    counted = json.loads(lines[-1][len("RESULT "):]) if lines else {}
    run.check("mesh", "memory: the count ran", counting.returncode == 0 and
              bool(lines), rc=counting.returncode, stderr=stderr[-1500:])
    for name, m in got.items():
        c = counted.get(name, {})
        m["counted"] = c
        args, peak = c.get("argument_bytes"), c.get("peak_bytes")
        slack = ROUND * m["arg_tensors"]
        m["args_ok"] = args is not None and \
            0 <= args - m["requested_args"] < slack
        m["peak_rel"] = abs(peak - m["measured_peak"]) / m["measured_peak"] \
            if peak is not None and m["measured_peak"] > 0 else None
        m["peak_within_watch"] = m["peak_rel"] is not None and \
            m["peak_rel"] <= MESH_MEMORY_WATCH
        run.check("mesh", f"memory/{name}: argument bytes equal the "
                  f"bytes the arguments requested to the allocator's "
                  f"rounding (< {ROUND} B a tensor)", m["args_ok"],
                  requested=m["requested_args"], counted=args,
                  measured=m["measured_args"],
                  unsplit=m["unsplit_bytes"], other_blocks=m["other_blocks"])
        run.check("mesh", f"memory/{name}: counted peak within "
                  f"{MESH_MEMORY_TOL:.0%} of max_memory_allocated() - base",
                  m["peak_rel"] is not None and
                  m["peak_rel"] <= MESH_MEMORY_TOL,
                  measured=m["measured_peak"], counted=peak)
        want = {k: v * MESH_LAYERS
                for k, v in MESH_MEMORY_LAUNCHES[name].items()}
        run.check("mesh", f"memory/{name}: the step's kernel launches",
                  m["launches"] == want, launches=m["launches"], want=want)
        for label, r in m.get("against_ref", {}).items():
            run.check("mesh", f"memory/{name}: logits through B6 against the "
                      f"einsum route at DECODE_TOL, position {label}",
                      r["ok"], pos=r["pos"], max_abs_err=r["max_abs_err"],
                      scale=r["scale"], b6_launches=r["b6_launches"])
    print(f"mesh memory: counted peak within {MESH_MEMORY_WATCH:.0%} "
          f"(a watch, not a gate): " + ", ".join(
              f"{n} {m['peak_within_watch']}" for n, m in got.items()),
          flush=True)
    return got


def phase_mesh(run, torch, np, tiny_np, card):
    """The launch tooling on a 1 x 1 NCCL mesh (``make_host_mesh``): the
    sharded train step of ``dryrun.build_step`` (TinyLlama) and the MoE
    forward per ``moe_impl`` (Granite) on DTensors, their attention on
    the local shards through B8/B9, against the eager paths; the dry
    run's memory count of five build_step steps against the caching
    allocator, the decode step's B6 route against its einsum route; then
    the full-size Granite dry run on the H100 row."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    set_fp32_exact(torch)
    counting = _start_memory_count()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        rec = {"phase": "mesh", "card": card["nvidia_smi"],
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "device_type": mesh.device_type}
        rec["train"] = _mesh_train(run, torch, np, mesh, tiny_np)
        gc.collect()
        torch.cuda.empty_cache()
        rec["moe"] = _mesh_moe(run, torch, np, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec["memory"] = _mesh_memory(run, torch, mesh, counting)
        rec["memory_s"] = time.perf_counter() - t0
        rec["ring"] = _mesh_ring_against_ref(run, torch, mesh)
    finally:
        if counting.poll() is None:
            counting.kill()
            counting.communicate()
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    rec["dryrun"] = _mesh_dryrun(run)
    emit(rec)
    return rec


def _decode_row(t):
    """The fields of a B6/B7 row from a _time_decode_kernel (or
    _time_cross_decode) record of the hybrid's or Whisper's serve path."""
    t = t or {}
    return {k: t.get(k) for k in (
        "ms", "device_us", "bound_ms", "bound_by", "share_of_bound",
        "plain_ms", "library_ms", "library_device_us", "max_abs_err_fp64",
        "rms_err_fp64", "valid_len", "heads", "kv_heads", "head_dim")}


def kernel_rows(totals, b2, dec, flash, wkv, cnn_launches, serve_launches,
                train_launches, rwkv_launches, int8, host, max_err,
                hybrid=None, audio=None):
    """The ``{"kernels": [...]}`` entries: slice 1's kernels timed over one
    NIN forward at batch 8 (B2 from b2_times, with device µs; B1, which
    NIN no longer runs, over LeNet's two dense layers at batch 8), their
    launches from the NIN path (B1's from the LeNet path); B6 and B7 per
    launch at the serving path's batch-8 shapes; B8 and B9's three
    kernels per launch at the train shapes, B8's launches from the serve
    path's prefills and B9's from the train path; B10 per launch at the
    RWKV-6 prefill's shape, its launches from the RWKV-6 serve path; B11
    per launch at a prompt's wq product (300 x 1536 x 1536) of the
    Granite-MoE int8 artifact, its launches from the artifact path, the
    other three shapes beside it.  B6, B7 and B8 also count the launches
    of the RecurrentGemma-9B serve path and carry its times (``hybrid``:
    B6/B7 at its live lanes, D 256, G 16; B8 at its 1 x 300 and 1 x 2100
    prefills, window 2048); and those of the Whisper-medium serve path
    (``audio``: B6/B7 at its live lanes, 'bskd', D 64, G 1, the cross
    attention's B6 at 8 x 1500; B8 at its 1 x 1500 encoder, 1 x 300 x 1500
    cross and 1 x 300 decoder shapes).  Each row also carries the
    wrapper's host µs per launch from launch_path."""
    hyb_launches = (hybrid or {}).get("launches") or {}
    aud_launches = (audio or {}).get("launches") or {}
    rows = []
    nin, lenet = (cnn_launches or {}).get("nin-cifar10") or {}, \
        (cnn_launches or {}).get("lenet-mnist") or {}
    for name, (source, replaces) in SOURCES.items():
        t = (b2 if name == "conv2d" else (totals or {}).get(name)) or {}
        b_s, o_s = t.get("bytes_s", 0.0), t.get("ops_s", 0.0)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (lenet if name == "matmul" else nin).get(name, 0),
            "launches_on": "lenet-mnist" if name == "matmul"
            else "nin-cifar10",
            "max_abs_err": max_err.get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": 1e3 * t["bound_s"] if t else None,
            "bound_by": "bytes" if b_s >= o_s else "operations",
            "library_ms": t.get("library_ms"),
            "device_us": t.get("device_us"),
            "library_device_us": t.get("library_device_us"),
            **{k: t[k] for k in ("inplace_ms", "library_inplace_ms",
                                 "inplace_device_us",
                                 "library_inplace_device_us") if k in t},
            "layers": t.get("layers"),
            "ms_per": "LeNet's 2 dense layers at batch 8" if name == "matmul"
            else "NIN's 9 convs at batch 8 (one launch each)"
            if name == "conv2d" else "one NIN forward at batch 8"})
    for name, (source, replaces) in DECODE_SOURCES.items():
        t = (dec or {}).get("paged-int8" if "paged" in name else "ring-fp32",
                            {})
        config = "paged-int8" if "paged" in name else "ring-fp32"
        by_path = {"serve (TinyLlama)": (serve_launches or {}).get(name, 0),
                   "serve_hybrid": hyb_launches.get(name, 0),
                   "serve_audio": aud_launches.get(name, 0)}
        audio_dec = ((audio or {}).get("decode") or {}).get(config)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_err.get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
            "device_us": t.get("device_us"),
            "library_device_us": t.get("library_device_us"),
            "share_of_bound": t.get("share_of_bound"),
            "rms_err_fp64": t.get("rms_err_fp64"),
            "long": {k: t.get("long", {}).get(k) for k in (
                "valid_len", "ms", "device_us", "bound_ms", "share_of_bound",
                "library_ms", "library_device_us", "max_abs_err_fp64",
                "rms_err_fp64")},
            "kernel_routes": DECODE_ROUTES,
            "hybrid": _decode_row(
                ((hybrid or {}).get("decode") or {}).get(config)),
            "audio_self": _decode_row(audio_dec),
            **({"audio_cross": _decode_row((audio or {}).get("cross"))}
               if "paged" not in name else {}),
            "ms_per": "one launch (one layer of a decode step), TinyLlama, "
                      "batch 8, " + ("paged int8" if "paged" in name
                                     else "ring fp32")})
    for name, (source, replaces) in FLASH_SOURCES.items():
        t = (flash or {}).get(name, {})
        b8 = name == "flash_attention"
        by_path = {"serve (TinyLlama)": (serve_launches or {}).get(name, 0),
                   "serve_hybrid": hyb_launches.get(name, 0),
                   "serve_audio": aud_launches.get(name, 0)} if b8 \
            else {"train": (train_launches or {}).get(name, 0)}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_on": "serve (prefill)" if b8 else "train",
            "max_abs_err": max_err.get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
            "library_call": t.get("library_call"),
            "library_fwd_bwd_ms": t.get("library_fwd_bwd_ms"),
            "device_us": t.get("device_us"),
            "library_device_us": t.get("library_device_us"),
            "bound_unit": t.get("bound_unit"),
            "bound_ffma_ms": t.get("bound_ffma_ms"),
            "kernel_routes": FLASH_ROUTES["fwd" if name in (
                "flash_attention", "flash_attention_fwd") else "bwd"],
            **({"prefill": t["prefill"]} if "prefill" in t else {}),
            **({"hybrid_prefill": (hybrid or {}).get("b8_prefill"),
                "audio_prefill": (audio or {}).get("b8")} if b8 else {}),
            "ms_per": "one launch (one layer), TinyLlama heads, batch 4 x "
                      "2048, fp32, causal"})
    t = (wkv or {}).get("1x300x40x64", {})
    rows.append({
        "name": "rwkv6_chunked", "route": "cuda", "source": WKV_SOURCE[0],
        "replaces": WKV_SOURCE[1],
        "launches": (rwkv_launches or {}).get("rwkv6_chunked", 0),
        "launches_on": "serve_rwkv6 (prefill)",
        "max_abs_err": max_err.get("rwkv6_chunked"),
        "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
        "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the WKV",
        **{k: t.get(k) for k in ("device_us", "device_us_by_pass",
                                 "share_of_bound", "ctas", "mb")},
        "long": {k: (wkv or {}).get("8x2048x40x64", {}).get(k) for k in (
            "ms", "device_us", "device_us_by_pass", "bound_ms",
            "share_of_bound", "ctas")},
        "bf16_fp32_decay": {shape: {k: (wkv or {}).get(
            shape + "_bf16_w32", {}).get(k) for k in (
                "ms", "plain_ms", "device_us", "device_us_by_pass",
                "bound_ms", "share_of_bound")}
            for shape in ("1x300x40x64", "8x2048x40x64")},
        "ms_per": "one launch (one layer; both passes), RWKV-6 3B prefill, "
                  "1 x 300 x 40 x 64, fp32"})
    times = (int8 or {}).get("times", {})
    t = next((v for v in times.values() if v["headline"]), {})
    rows.append({
        "name": "int8_matmul", "route": "cuda", "source": INT8_SOURCE[0],
        "replaces": INT8_SOURCE[1],
        "launches": (int8 or {}).get("launches", 0),
        "launches_on": "int8_kernels (the Granite-MoE int8 artifact's wq, "
                       "we_gate, we_down at M 8, 300, 2048)",
        "max_abs_err": max_err.get("int8_matmul"),
        "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
        "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
        "library_ms": t.get("library_ms"),
        "library_call": "torch._int_mm (cuBLASLt) + the epilogue",
        "device_us": (t.get("device_us") or [None])[0],
        "library_device_us": t.get("library_device_us"),
        "share_of_bound": t.get("share_of_bound"), "plan": t.get("plan"),
        "ms_per": "one launch, 300 x 1536 @ 1536 x 1536 (a prompt's wq), "
                  "int8 -> fp32",
        "other_shapes": {k: v for k, v in times.items()
                         if not v["headline"]}})
    for row in rows:
        case = (host or {}).get({"decode_attention_paged":
                                 "decode_attention_paged_q8"}.get(
                                     row["name"], row["name"]))
        row["host_us_per_launch"] = case and {
            k: case[k] for k in ("shape", "host_us", "device_us",
                                 "library_host_us")}
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
        _, lenet_launches = timed(
            "lenet", phase_model, run, torch, np, "lenet-mnist",
            graphs["lenet-mnist"], pathlib.Path(store_root)) or (None, None)
        cnn_launches = {"nin-cifar10": nin_launches,
                        "lenet-mnist": lenet_launches}
        if engine is not None:
            totals = timed("times", phase_times, run, torch, np,
                           graphs["nin-cifar10"], graphs["lenet-mnist"],
                           engine, card)
            timed("profile", phase_profile, torch, np, engine, card)
        b2 = timed("b2_times", phase_b2_times, run, torch,
                   graphs["nin-cifar10"], card)
        timed("fft_conv", phase_fft_conv, run, torch, np,
              graphs["nin-cifar10"], card)
    del engine
    host = timed("launch_path", phase_launch_path, run, torch, card)
    # slice 2: TinyLlama / Qwen3 through ServingEngine and MultiModelServer
    timed("decode_kernels", phase_decode_kernels, run, torch)
    timed("flash_kernels", phase_flash_kernels, run, torch)
    # the serve and train command lines with their defaults (reduced
    # configs, head_dim 32)
    timed("cli", phase_cli, run, torch, np)
    served = timed("serve", phase_serve, run, torch, np, card)
    serve_launches = dec = tiny_np = None
    if served is not None:
        cfg, tiny_np, params, engines, serve_launches, serve_tokens = served
        del engines
        dec = timed("serve_times", phase_serve_times, run, torch, np, cfg,
                    params, card)
        # the twin of jax.jit: CUDA graphs against the eager steps
        timed("graphs", phase_graphs, run, torch, np, cfg, params,
              serve_tokens, graphs, card)
        del params
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as store_root:
            timed("multimodel", phase_multimodel, run, torch, np, tiny_np,
                  pathlib.Path(store_root))
    # slice 3: TinyLlama / Qwen3 training through launch.train, then the
    # trained TinyLlama published and served
    torch.cuda.empty_cache()
    if tiny_np is None:
        tiny_np = numpy_weights(np, get_config("tinyllama-1.1b"), SEED)
    train_launches = flash = None
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store_root:
        train_launches = timed("train", phase_train, run, torch, np, tiny_np,
                               store_root)
        if train_launches is not None:
            timed("train_publish_serve", phase_train_publish_serve, run,
                  torch, np, tiny_np, store_root)
    flash = timed("train_times", phase_train_times, run, torch, np, tiny_np,
                  card)
    # slice 4: RWKV-6 Finch 3B served on B10, then the three families
    # behind the meta-selector
    torch.cuda.empty_cache()
    timed("wkv_kernels", phase_wkv_kernels, run, torch)
    wkv = timed("wkv_times", phase_wkv_times, run, torch, card)
    served_rwkv = timed("serve_rwkv6", phase_serve_rwkv6, run, torch, np,
                        card)
    rwkv_launches = None
    if served_rwkv is not None:
        rwkv_params, rwkv_launches = served_rwkv
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as store_root:
            timed("selector", phase_selector, run, torch, np, tiny_np,
                  rwkv_params, store_root)
        del rwkv_params
    # slice 5: Granite-MoE 3B on B8 and B6/B7, its int8 artifact through
    # MultiModelServer, and B11 on that artifact's QTensors
    torch.cuda.empty_cache()
    int8 = None
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store_root:
        if timed("serve_moe", phase_serve_moe, run, torch, np, card,
                 store_root) is not None:
            int8 = timed("int8_kernels", phase_int8_kernels, run, torch, np,
                         store_root, card)
    # slice 12: RecurrentGemma-9B on B8 and B6/B7, once Granite is freed
    # (and whatever earlier phases left in reference cycles)
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = timed("serve_hybrid", phase_serve_hybrid, run, torch, np, card)
    # slice 13: Whisper-medium on B8 and B6/B7, once the hybrid is freed
    gc.collect()
    torch.cuda.empty_cache()
    audio = timed("serve_audio", phase_serve_audio, run, torch, np, card)
    # slice 21: the four torch examples at their defaults
    gc.collect()
    torch.cuda.empty_cache()
    timed("examples", phase_examples, run, torch, np)
    # slice 14: the sharded step and the MoE bodies on a one-rank NCCL
    # mesh, and the analytic dry run on the H100 row
    gc.collect()
    torch.cuda.empty_cache()
    timed("mesh", phase_mesh, run, torch, np, tiny_np, card)
    kernels = kernel_rows(totals, b2, dec, flash, wkv, cnn_launches,
                          serve_launches, train_launches, rwkv_launches,
                          int8, host, run.max_err, hybrid, audio)
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
