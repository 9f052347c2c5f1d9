// Fused pseudo-label pass over channel-major logits.
//
// Replaces the Pallas kernel mspl_tpu/ops/pallas_pseudo_cm.py::fused_pseudo_cm
// (body `_kernel`).  Per pixel, over N logit stacks [B, C_m, H, W]: softmax,
// conversion into T+1 target columns through the [C_m, T+1] tables, soft
// fusion (mean of the converted maps, argmax/max or normalized anti-entropy)
// or hard fusion (per-model argmax over T+1, one-hot votes over T,
// top >= min_agree, votes/N or vote entropy), then conf >= kc[label] else
// ignore.
//
// Bound: bytes.  Each pixel reads sum(C_m) logits (35 bf16 planes on the
// main path) and writes 8 bytes; the arithmetic is ~10 flops per logit.
// Design: one thread per pixel; consecutive threads take consecutive W, so
// every channel plane (stride H*W) is read with coalesced loads and nothing
// is staged.  A model's C_m logits sit in registers, loaded all at once
// (unconditional loads into a register array of 8, 16 or 32, see
// model_probs): a first version that loaded each channel under a guard ran
// latency-bound at ~200 GB/s.  The small
// tables and kc are staged in shared memory, where all threads read the same
// word (a broadcast).  The tables enter as a weighted sum, so tables that
// are not 0/1 stay exact.  Argmaxes use strict '>' so ties go to the first
// maximum, as the JAX kernel's `_running_argmax`.  There is no H % 8
// restriction: the tail of the last block is masked.
#include "common.cuh"

#define MAX_MODELS 4
#define MAX_C 32
#define MAX_T1 8

struct PseudoArgs {
  const void* logits[MAX_MODELS];
  int c[MAX_MODELS];
  int n_models;
  int t;           // target classes T; the tables have T+1 columns
  int64_t hw;      // pixels per plane
  int64_t total;   // B*H*W
  float min_agree;
  int ignore;
  float inv_log;   // 1 / ln(T+1)
  float inv_n;     // 1 / N
  const float* tables;  // per model [C_m, T+1], concatenated in model order
  const float* kc;      // [T]
  int32_t* out_label;
  float* out_conf;
};

__device__ __forceinline__ float xlogx(float p) {
  return p > 0.f ? p * logf(fmaxf(p, 1e-30f)) : 0.f;
}

// Softmax numerators of one model's pixel, pooled into the T+1 target
// columns: q[t] = sum_c exp(x_c - max) * tab[c, t]; returns 1 / sum_c exp.
// CM >= cm is the register width: all CM loads are unconditional (addresses
// past cm repeat the last plane and hit L1) so they issue back to back and
// their latencies overlap; only the cm real channels enter the sums.
template <int CM, typename T>
__device__ __forceinline__ float model_probs(const T* __restrict__ base,
                                             int64_t hw, int cm,
                                             const float* tab, int t1,
                                             float q[MAX_T1]) {
  float v[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) v[c] = to_f32(base[(int64_t)min(c, cm - 1) * hw]);
  float mx = v[0];
#pragma unroll
  for (int c = 1; c < CM; ++c)
    if (c < cm) mx = fmaxf(mx, v[c]);
#pragma unroll
  for (int t = 0; t < MAX_T1; ++t) q[t] = 0.f;
  float tot = 0.f;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    if (c < cm) {
      const float e = expf(v[c] - mx);
      tot += e;
      const float* row = tab + c * t1;
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t)
        if (t < t1) q[t] += e * row[t];
    }
  }
  return 1.f / tot;
}

template <typename T, bool HARD, bool ENTROPY>
__global__ void __launch_bounds__(256)
pseudo_cm_kernel(PseudoArgs a) {
  __shared__ float s_tab[MAX_MODELS * MAX_C * MAX_T1];
  __shared__ float s_kc[MAX_T1];
  const int t1 = a.t + 1;
  int ntab = 0;
  for (int m = 0; m < a.n_models; ++m) ntab += a.c[m] * t1;
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_tab[i] = a.tables[i];
  if (threadIdx.x < a.t) s_kc[threadIdx.x] = a.kc[threadIdx.x];
  __syncthreads();

  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.total) return;
  const int64_t b = p / a.hw;
  const int64_t r = p - b * a.hw;

  float acc[MAX_T1];  // soft: summed target probs; hard: votes
#pragma unroll
  for (int t = 0; t < MAX_T1; ++t) acc[t] = 0.f;

  int toff = 0;
  for (int m = 0; m < a.n_models; ++m) {
    const int cm = a.c[m];
    const T* base = reinterpret_cast<const T*>(a.logits[m]) + b * cm * a.hw + r;
    float q[MAX_T1];
    float inv;
    if (cm <= 8) inv = model_probs<8>(base, a.hw, cm, s_tab + toff, t1, q);
    else if (cm <= 16) inv = model_probs<16>(base, a.hw, cm, s_tab + toff, t1, q);
    else inv = model_probs<MAX_C>(base, a.hw, cm, s_tab + toff, t1, q);
    if (HARD) {
      float best = q[0] * inv;
      int lab = 0;
#pragma unroll
      for (int t = 1; t < MAX_T1; ++t) {
        if (t < t1) {
          const float qt = q[t] * inv;
          if (qt > best) { best = qt; lab = t; }
        }
      }
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t)
        if (t < a.t && lab == t) acc[t] += 1.f;  // lab == T: ignore column
    } else {
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t)
        if (t < a.t) acc[t] += q[t] * inv;
    }
    toff += cm * t1;
  }

  float conf, top = 0.f;
  int lbl = 0;
  if (HARD) {
    top = acc[0];
#pragma unroll
    for (int t = 1; t < MAX_T1; ++t)
      if (t < a.t && acc[t] > top) { top = acc[t]; lbl = t; }
    if (ENTROPY) {
      float tot = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t) if (t < a.t) tot += acc[t];
      float s = xlogx(((float)a.n_models - tot) * a.inv_n);
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t) if (t < a.t) s += xlogx(acc[t] * a.inv_n);
      conf = 1.f + s * a.inv_log;
    } else {
      conf = top * a.inv_n;
    }
    if (!(top >= a.min_agree)) lbl = a.ignore;
  } else {
#pragma unroll
    for (int t = 0; t < MAX_T1; ++t) acc[t] *= a.inv_n;
    float best = acc[0];
#pragma unroll
    for (int t = 1; t < MAX_T1; ++t)
      if (t < a.t && acc[t] > best) { best = acc[t]; lbl = t; }
    if (ENTROPY) {
      float tot = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t) if (t < a.t) tot += acc[t];
      float s = xlogx(fmaxf(1.f - tot, 0.f));
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t) if (t < a.t) s += xlogx(acc[t]);
      conf = 1.f + s * a.inv_log;
    } else {
      conf = best;
    }
  }
  const float thr = (lbl >= 0 && lbl < a.t) ? s_kc[lbl] : 0.f;
  if (!(conf >= thr)) lbl = a.ignore;
  a.out_label[p] = lbl;
  a.out_conf[p] = conf;
}

template <typename T>
static void launch_typed(const PseudoArgs& a, int hard, int entropy,
                         cudaStream_t st) {
  const unsigned int grid = mspl_blocks(a.total, 256);
  if (hard && entropy) pseudo_cm_kernel<T, true, true><<<grid, 256, 0, st>>>(a);
  else if (hard) pseudo_cm_kernel<T, true, false><<<grid, 256, 0, st>>>(a);
  else if (entropy) pseudo_cm_kernel<T, false, true><<<grid, 256, 0, st>>>(a);
  else pseudo_cm_kernel<T, false, false><<<grid, 256, 0, st>>>(a);
}

extern "C" int pseudo_cm_launch(
    const void* l0, const void* l1, const void* l2, const void* l3,
    int c0, int c1, int c2, int c3, int n_models,
    const float* tables, const float* kc, int t, long long hw,
    long long total, int dtype, int hard, int entropy, float min_agree,
    int ignore, float inv_log, void* out_label, void* out_conf,
    void* stream) {
  PseudoArgs a;
  const void* ls[MAX_MODELS] = {l0, l1, l2, l3};
  const int cs[MAX_MODELS] = {c0, c1, c2, c3};
  for (int m = 0; m < MAX_MODELS; ++m) {
    a.logits[m] = ls[m];
    a.c[m] = cs[m];
  }
  a.n_models = n_models;
  a.t = t;
  a.hw = hw;
  a.total = total;
  a.min_agree = min_agree;
  a.ignore = ignore;
  a.inv_log = inv_log;
  a.inv_n = 1.f / (float)n_models;
  a.tables = tables;
  a.kc = kc;
  a.out_label = reinterpret_cast<int32_t*>(out_label);
  a.out_conf = reinterpret_cast<float*>(out_conf);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == MSPL_BF16) launch_typed<__nv_bfloat16>(a, hard, entropy, st);
    else launch_typed<float>(a, hard, entropy, st);
  }
  return (int)cudaGetLastError();
}
