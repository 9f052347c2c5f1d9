// Fused pseudo-label pass over pixel-major (NHWC) logits.
//
// Replaces the Pallas kernel mspl_tpu/ops/pallas_pseudo.py::
// fused_pseudo_pass_pallas, the [P, C_m]-rows form of the fused pass for
// sources that emit NHWC logits.  Per pixel, over N logit tensors
// [B, H, W, C_m]: softmax, conversion into T+1 target columns through the
// [C_m, T+1] tables, then soft fusion (mean of the converted maps over all
// T+1 columns; label = first argmax over the T target columns; conf = that
// max, or 1 - H/ln(T+1) of the full T+1 map) or hard fusion (each model's
// first argmax over T+1 votes one-hot over T, the ignore column votes for
// nothing; label = first argmax of the votes, ignore below min_agree; conf =
// votes/N, or the entropy of [votes, abstentions]/N).  With kc, conf >=
// kc[label] else ignore; without kc nothing is thresholded (unlike the
// channel-major kernel, which thresholds against 0).
//
// Bound: bytes.  Each pixel reads its sum(C_m) logits (35 bf16 values on
// the main shape) and writes 8 bytes; ~10 flops per logit.
// Design: one thread per pixel.  A pixel's C_m logits of one model are
// contiguous, so consecutive threads read consecutive runs of C_m values
// and a warp's loads cover whole cache lines between them (staging each
// block's run through shared memory with 16-byte loads was slower in a
// trial on the H100).  The C_m values sit in a register array of 8, 16 or 32,
// loaded unconditionally (indices past C_m repeat the last one and hit L1)
// so the loads issue back to back.  The tables and kc are staged in shared
// memory (broadcast reads).  Probabilities, not numerators, enter the
// weighted sums of the tables, each exp times one reciprocal of the sum:
// an IEEE division per channel takes its slow path on the tiny
// exponentials of confident logits (several times slower on model logits
// in a trial on the H100; see PERF.md for the kernel's time in the route).
// The arguments are __grid_constant__, so the per-model pointers and widths
// indexed at run time are read in place, not copied to local memory.
// Each model's logits are f32 or bf16 on their own, as the JAX kernel
// casts each model's block to f32 (a self-training round ensembles bf16
// sources with an f32 target model): a bit per model says which, and the
// model loop, uniform across the grid, takes that model's load.
#include "common.cuh"

#define MAX_MODELS 4
#define MAX_C 32
#define MAX_T1 8

struct PmArgs {
  const void* logits[MAX_MODELS];
  int c[MAX_MODELS];
  int n_models;
  int bf16;        // bit m set: model m's logits are bf16, else f32
  int t;           // target classes T; the tables have T+1 columns
  int64_t total;   // B*H*W
  int min_agree;
  int ignore;
  int has_kc;
  float inv_log;   // 1 / ln(T+1)
  const float* tables;  // per model [C_m, T+1], concatenated in model order
  const float* kc;      // [T]
  int32_t* out_label;
  float* out_conf;
};

__device__ __forceinline__ float xlogx(float p) {
  return p > 0.f ? p * logf(fmaxf(p, 1e-30f)) : 0.f;
}

// q[t] = sum_c softmax(x)_c * tab[c, t] over the T+1 columns.
template <int CM, typename T>
__device__ __forceinline__ void model_probs(const T* __restrict__ row, int cm,
                                            const float* tab, int t1,
                                            float q[MAX_T1]) {
  float v[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) v[c] = to_f32(row[min(c, cm - 1)]);
  float mx = v[0];
#pragma unroll
  for (int c = 1; c < CM; ++c)
    if (c < cm) mx = fmaxf(mx, v[c]);
  float tot = 0.f;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    v[c] = c < cm ? expf(v[c] - mx) : 0.f;
    tot += v[c];
  }
  const float inv = 1.f / tot;
#pragma unroll
  for (int t = 0; t < MAX_T1; ++t) q[t] = 0.f;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    if (c < cm) {
      const float p = v[c] * inv;
      const float* tr = tab + c * t1;
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t)
        if (t < t1) q[t] += p * tr[t];
    }
  }
}

// One model's q at pixel p: its row read as T, its register width 8, 16
// or 32.
template <typename T>
__device__ __forceinline__ void model_at(const void* logits, int64_t p,
                                         int cm, const float* tab, int t1,
                                         float q[MAX_T1]) {
  const T* row = reinterpret_cast<const T*>(logits) + p * cm;
  if (cm <= 8) model_probs<8>(row, cm, tab, t1, q);
  else if (cm <= 16) model_probs<16>(row, cm, tab, t1, q);
  else model_probs<MAX_C>(row, cm, tab, t1, q);
}

template <bool HARD, bool ENTROPY>
__global__ void __launch_bounds__(256)
pseudo_pm_kernel(const __grid_constant__ PmArgs a) {
  __shared__ float s_tab[MAX_MODELS * MAX_C * MAX_T1];
  __shared__ float s_kc[MAX_T1];
  const int t1 = a.t + 1;
  int ntab = 0;
  for (int m = 0; m < a.n_models; ++m) ntab += a.c[m] * t1;
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_tab[i] = a.tables[i];
  if (a.has_kc && threadIdx.x < a.t) s_kc[threadIdx.x] = a.kc[threadIdx.x];
  __syncthreads();

  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.total) return;
  float acc[MAX_T1];  // soft: summed probabilities (T+1); hard: votes (T)
#pragma unroll
  for (int t = 0; t < MAX_T1; ++t) acc[t] = 0.f;
  int toff = 0;
  for (int m = 0; m < a.n_models; ++m) {
    const int cm = a.c[m];
    float q[MAX_T1];
    if ((a.bf16 >> m) & 1)
      model_at<__nv_bfloat16>(a.logits[m], p, cm, s_tab + toff, t1, q);
    else
      model_at<float>(a.logits[m], p, cm, s_tab + toff, t1, q);
    if (HARD) {
      float best = q[0];
      int lab = 0;
#pragma unroll
      for (int t = 1; t < MAX_T1; ++t)
        if (t < t1 && q[t] > best) { best = q[t]; lab = t; }
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t)
        if (t < a.t && lab == t) acc[t] += 1.f;  // lab == T votes for nothing
    } else {
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t)
        if (t < t1) acc[t] += q[t];
    }
    toff += cm * t1;
  }

  const float n = (float)a.n_models;
  float conf;
  int lbl = 0;
  if (HARD) {
    float top = acc[0];
#pragma unroll
    for (int t = 1; t < MAX_T1; ++t)
      if (t < a.t && acc[t] > top) { top = acc[t]; lbl = t; }
    if (ENTROPY) {
      float tot = 0.f, s = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t)
        if (t < a.t) { tot += acc[t]; s += xlogx(acc[t] / n); }
      s += xlogx((n - tot) / n);
      conf = 1.f + s * a.inv_log;
    } else {
      conf = top / n;
    }
    if (!(top >= (float)a.min_agree)) lbl = a.ignore;
  } else {
#pragma unroll
    for (int t = 0; t < MAX_T1; ++t) acc[t] = acc[t] / n;
    float best = acc[0];
#pragma unroll
    for (int t = 1; t < MAX_T1; ++t)
      if (t < a.t && acc[t] > best) { best = acc[t]; lbl = t; }
    if (ENTROPY) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_T1; ++t)
        if (t < t1) s += xlogx(acc[t]);
      conf = 1.f + s * a.inv_log;
    } else {
      conf = best;
    }
  }
  if (a.has_kc) {
    const float thr = (lbl >= 0 && lbl < a.t) ? s_kc[lbl] : s_kc[0];
    if (!(conf >= thr)) lbl = a.ignore;
  }
  a.out_label[p] = lbl;
  a.out_conf[p] = conf;
}

static void launch(const PmArgs& a, int hard, int entropy, cudaStream_t st) {
  const unsigned int grid = mspl_blocks(a.total, 256);
  if (hard && entropy) pseudo_pm_kernel<true, true><<<grid, 256, 0, st>>>(a);
  else if (hard) pseudo_pm_kernel<true, false><<<grid, 256, 0, st>>>(a);
  else if (entropy) pseudo_pm_kernel<false, true><<<grid, 256, 0, st>>>(a);
  else pseudo_pm_kernel<false, false><<<grid, 256, 0, st>>>(a);
}

// logits l0..l3 [B, H, W, C_m] (n_models of them; bit m of bf16_mask set:
// model m's are bf16, else f32), c0..c3 their channels.
extern "C" int pseudo_pm_launch(
    const void* l0, const void* l1, const void* l2, const void* l3,
    int c0, int c1, int c2, int c3, int n_models, const float* tables,
    const float* kc, int has_kc, int t, long long total, int bf16_mask,
    int hard, int entropy, int min_agree, int ignore, float inv_log,
    void* out_label, void* out_conf, void* stream) {
  PmArgs a;
  const void* ls[MAX_MODELS] = {l0, l1, l2, l3};
  const int cs[MAX_MODELS] = {c0, c1, c2, c3};
  for (int m = 0; m < MAX_MODELS; ++m) {
    a.logits[m] = ls[m];
    a.c[m] = cs[m];
  }
  a.n_models = n_models;
  a.bf16 = bf16_mask;
  a.t = t;
  a.total = total;
  a.min_agree = min_agree;
  a.ignore = ignore;
  a.has_kc = has_kc;
  a.inv_log = inv_log;
  a.tables = tables;
  a.kc = kc;
  a.out_label = reinterpret_cast<int32_t*>(out_label);
  a.out_conf = reinterpret_cast<float*>(out_conf);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (total > 0) launch(a, hard, entropy, st);
  return (int)cudaGetLastError();
}
