// The flash forward (B8, B9's forward) on one CUDA card, at TinyLlama's
// train shape (4 x 2048, 32/4 heads of 64, causal) and at the serving
// prefill (1 x 300, the same heads), in fp32 and bf16:
//
//   shipped  csrc/flash_attention.cu's flash_fwd_tc as the library
//            launches it (3xTF32 on wgmma, the probabilities in registers,
//            a cp.async K/V ring, the wgmma operands in shared memory in
//            csrc/sm90.cuh's 128-byte swizzle)
//
// with and without the logsumexp (B9's forward and B8).  A design to be
// weighed against it goes in beside it as another variant; the FFMA
// forward it replaced is no longer built (CHANGES.md keeps its times).
//
// Build and run on the machine with the card, from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/flash_fwd_variants benchmarks/flash_fwd_variants.cu
//   build/flash_fwd_variants
//
// Prints one JSON line per case: ms per launch (CUDA events over 20
// back-to-back launches, the best of 5); each variant's largest
// difference from the shipped kernel's output and lse (with the
// logsumexp), with whether it is within the port's tolerance (fp32 rtol
// 1e-4 / atol 1e-5, bf16 2e-2 / 3e-2; lse 1e-4 / 1e-5); and o's error
// against a reference in fp64 on the same (fp32 or bf16-rounded) inputs:
// the largest and the rms difference, and the slope of o against it less
// 1 (a systematic shrink or growth of o).
#include <cmath>
#include <cstdio>
#include <vector>

#include "../src/repro_torch/kernels/csrc/flash_attention.cu"

namespace {

#define CHECK(x)                                                            \
  do {                                                                      \
    cudaError_t e_ = (x);                                                   \
    if (e_ != cudaSuccess) {                                                \
      fprintf(stderr, "%s: %s\n", #x, cudaGetErrorString(e_));              \
      exit(1);                                                              \
    }                                                                       \
  } while (0)

struct Case {
  const char* name;
  int B, S, H, KV;
};

float host_f32(float x) { return x; }
float host_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
void host_set(float& x, float f) { x = f; }
void host_set(__nv_bfloat16& x, float f) { x = __float2bfloat16(f); }

template <typename T, bool LSE>
int launch_shipped(const T* q, const T* k, const T* v, T* o, float* lse, int B,
                   const Shape& sh) {
  return launch_fwd<64, T, LSE>(q, k, v, o, lse, B, sh, nullptr);
}

// o in fp64, causal: one thread a (batch, head, query row), two passes
// over its keys (the row max, then the sum and p.v)
template <typename T>
__global__ void reference64(const T* q, const T* k, const T* v, double* o,
                            int B, int S, int H, int KV) {
  constexpr int D = 64;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * H * S) return;
  const int r = static_cast<int>(t % S), h = static_cast<int>((t / S) % H);
  const int b = static_cast<int>(t / (static_cast<long long>(S) * H)), kvh = h / (H / KV);
  const T* qr = q + ((static_cast<long long>(b) * S + r) * H + h) * D;
  const double scale = 1.0 / sqrt(static_cast<double>(D));
  auto score = [&](int j) {
    const T* kr = k + ((static_cast<long long>(b) * S + j) * KV + kvh) * D;
    double s = 0.0;
    for (int d = 0; d < D; ++d) s += static_cast<double>(to_f32(qr[d])) * to_f32(kr[d]);
    return s * scale;
  };
  double mx = -1e300;
  for (int j = 0; j <= r; ++j) mx = fmax(mx, score(j));
  double acc[D], l = 0.0;
  for (int d = 0; d < D; ++d) acc[d] = 0.0;
  for (int j = 0; j <= r; ++j) {
    const double p = exp(score(j) - mx);
    const T* vr = v + ((static_cast<long long>(b) * S + j) * KV + kvh) * D;
    l += p;
    for (int d = 0; d < D; ++d) acc[d] += p * to_f32(vr[d]);
  }
  double* orow = o + ((static_cast<long long>(b) * S + r) * H + h) * D;
  for (int d = 0; d < D; ++d) orow[d] = acc[d] / l;
}

template <typename F>
float time_ms(F&& launch) {
  cudaEvent_t a, b;
  CHECK(cudaEventCreate(&a));
  CHECK(cudaEventCreate(&b));
  float best = 1e30f;
  for (int rep = 0; rep < 6; ++rep) {        // the first is a warm-up
    CHECK(cudaEventRecord(a));
    for (int i = 0; i < 20; ++i) launch();
    CHECK(cudaEventRecord(b));
    CHECK(cudaEventSynchronize(b));
    float ms = 0.0f;
    CHECK(cudaEventElapsedTime(&ms, a, b));
    if (rep) best = std::min(best, ms / 20);
  }
  CHECK(cudaEventDestroy(a));
  CHECK(cudaEventDestroy(b));
  return best;
}

// max |x - y| and whether every element is within atol + rtol |y|
template <typename T>
void compare(const std::vector<T>& x, const std::vector<T>& y, double rtol,
             double atol, double& err, bool& ok) {
  err = 0.0;
  ok = true;
  for (size_t i = 0; i < x.size(); ++i) {
    const double a = host_f32(x[i]), b = host_f32(y[i]), d = std::fabs(a - b);
    err = std::max(err, d);
    if (!(d <= atol + rtol * std::fabs(b))) ok = false;
  }
}

template <typename T>
void run_case(const Case& c, const char* dtype, double rtol, double atol) {
  const int D = 64;
  const size_t nq = static_cast<size_t>(c.B) * c.S * c.H * D;
  const size_t nk = static_cast<size_t>(c.B) * c.S * c.KV * D;
  const size_t nl = static_cast<size_t>(c.B) * c.H * c.S;
  std::vector<T> hq(nq), hk(nk), hv(nk);
  uint32_t state = 12345u;
  auto rnd = [&]() {                         // uniform in [-2, 2)
    state = state * 1664525u + 1013904223u;
    return static_cast<float>(state >> 8) / 4194304.0f - 2.0f;
  };
  for (auto* h : {&hq, &hk, &hv})
    for (auto& x : *h) host_set(x, rnd());
  T *q, *k, *v, *o;
  float* lse;
  CHECK(cudaMalloc(&q, nq * sizeof(T)));
  CHECK(cudaMalloc(&k, nk * sizeof(T)));
  CHECK(cudaMalloc(&v, nk * sizeof(T)));
  CHECK(cudaMalloc(&o, nq * sizeof(T)));
  CHECK(cudaMalloc(&lse, nl * sizeof(float)));
  CHECK(cudaMemcpy(q, hq.data(), nq * sizeof(T), cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(k, hk.data(), nk * sizeof(T), cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(v, hv.data(), nk * sizeof(T), cudaMemcpyHostToDevice));
  const Shape sh = make_shape(c.S, c.S, c.H, c.KV, D, 1, 0);
  std::vector<double> exact(nq);
  {
    double* o64;
    CHECK(cudaMalloc(&o64, nq * sizeof(double)));
    const long long rows = static_cast<long long>(c.B) * c.H * c.S;
    reference64<T><<<static_cast<unsigned>((rows + 127) / 128), 128>>>(q, k, v, o64, c.B, c.S,
                                                                      c.H, c.KV);
    CHECK(cudaGetLastError());
    CHECK(cudaMemcpy(exact.data(), o64, nq * sizeof(double), cudaMemcpyDeviceToHost));
    CHECK(cudaFree(o64));
  }

  auto outputs = [&](std::vector<T>& ho, std::vector<float>& hl) {
    CHECK(cudaDeviceSynchronize());
    ho.resize(nq);
    hl.resize(nl);
    CHECK(cudaMemcpy(ho.data(), o, nq * sizeof(T), cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(hl.data(), lse, nl * sizeof(float), cudaMemcpyDeviceToHost));
  };
  std::vector<T> want_o;
  std::vector<float> want_l;
  CHECK(static_cast<cudaError_t>(launch_shipped<T, true>(q, k, v, o, lse, c.B, sh)));
  outputs(want_o, want_l);

  struct Variant {
    const char* name;
    bool lse;
    int (*fn)(const T*, const T*, const T*, T*, float*, int, const Shape&);
  };
  const Variant variants[] = {
      {"shipped", true, launch_shipped<T, true>},
      {"shipped", false, launch_shipped<T, false>},
  };
  for (const Variant& var : variants) {
    CHECK(cudaMemset(o, 0, nq * sizeof(T)));
    CHECK(cudaMemset(lse, 0, nl * sizeof(float)));
    CHECK(static_cast<cudaError_t>(var.fn(q, k, v, o, lse, c.B, sh)));
    std::vector<T> got_o;
    std::vector<float> got_l;
    outputs(got_o, got_l);
    double err_o, err_l = 0.0;
    bool ok_o, ok_l = true;
    compare(got_o, want_o, rtol, atol, err_o, ok_o);
    if (var.lse) compare(got_l, want_l, 1e-4, 1e-5, err_l, ok_l);
    double worst = 0.0, sq = 0.0, gw = 0.0, ww = 0.0;
    for (size_t i = 0; i < nq; ++i) {
      const double g = host_f32(got_o[i]), w = exact[i], d = std::fabs(g - w);
      worst = std::max(worst, d);
      sq += d * d;
      gw += g * w;
      ww += w * w;
    }
    const float ms = time_ms([&] { var.fn(q, k, v, o, lse, c.B, sh); });
    CHECK(cudaGetLastError());
    printf("{\"case\": \"%s\", \"shape\": [%d, %d, %d, %d, %d], \"dtype\": \"%s\", "
           "\"variant\": \"%s\", \"lse\": %s, \"ms\": %.5f, "
           "\"o_max_abs_diff_vs_shipped\": %.3g, \"lse_max_abs_diff_vs_shipped\": %.3g, "
           "\"within_tolerance\": %s, \"o_max_abs_vs_fp64\": %.3g, "
           "\"o_rms_vs_fp64\": %.3g, \"o_slope_vs_fp64_minus_1\": %.3g}\n",
           c.name, c.B, c.S, c.H, c.KV, D, dtype, var.name, var.lse ? "true" : "false",
           ms, err_o, err_l, ok_o && ok_l ? "true" : "false", worst,
           std::sqrt(sq / nq), gw / ww - 1.0);
  }
  CHECK(cudaFree(q));
  CHECK(cudaFree(k));
  CHECK(cudaFree(v));
  CHECK(cudaFree(o));
  CHECK(cudaFree(lse));
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  printf("{\"device\": \"%s\", \"sms\": %d}\n", prop.name, prop.multiProcessorCount);
  const Case cases[] = {{"train", 4, 2048, 32, 4}, {"prefill", 1, 300, 32, 4}};
  for (const Case& c : cases) {
    run_case<float>(c, "float32", 1e-4, 1e-5);
    run_case<__nv_bfloat16>(c, "bfloat16", 2e-2, 3e-2);
  }
  return 0;
}
