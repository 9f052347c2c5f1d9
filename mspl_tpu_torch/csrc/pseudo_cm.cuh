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
// main path, 1.10 GB a batch of 128) and writes 8 bytes; the arithmetic is
// ~10 flops per logit.  Design: a streaming kernel.  A thread takes VP = 4
// consecutive pixels of one image and reads each channel's 4 values with
// one 8-byte (bf16) or 16-byte (f32) load, so a warp's load instruction
// moves 256 or 512 contiguous bytes; the grid walks (pixel chunk, image),
// so no index is divided.  A model's channels sit in registers, loaded all
// at once so that the loads issue back to back: the register width is the
// model's channel count rounded up to 4 (the wrapper's plan), picked by one
// switch a model; loads past C_m repeat its last plane and hit L1.  Then,
// in the plain version's order, each pixel's max, exp(x - max), the tables'
// weighted sums and one reciprocal.  The exponential is __expf (ex2.approx
// of (x - max) log2 e, two instructions against expf's ~8; relative error
// ~1e-6 at |x - max| <= 20, inside the fp32 check's 1e-5 on confidences):
// at ~15 instructions a logit the kernel issues near its memory time.  The
// arguments are __grid_constant__,
// so a model's pointer and width, indexed at run time, are read from the
// parameter bank in place (by value the struct went to local memory); the
// model loop is not unrolled, which would copy the width instances once per
// model.  The tables, padded to T1 columns (4 or 8, a template instance),
// and kc sit in shared memory, where all threads read the same words.  The
// tables enter as a weighted sum, so tables that are not 0/1 stay exact.
// Argmaxes use strict '>' so ties go to the first maximum, as the JAX
// kernel's `_running_argmax`.  Each model's logits are f32 or bf16 on
// their own, as the JAX kernel reads each model's ref in its dtype (a
// self-training round ensembles bf16 sources with an f32 target model): a
// bit per model says which, and the model loop, uniform across a warp,
// takes that model's load.  The instance is picked per launch (DT): all
// f32, all bf16, or mixed; only the mixed one holds both loads, so the
// single-dtype ensembles keep their registers (the mixed instance took
// 1.6x the bf16 one's time on the main path's call on an H100, measured
// by tools/torch_pseudo_dtypes.py).  The single-dtype and the
// mixed instances are two libraries (pseudo_cm.cu, pseudo_cm_mixed.cu),
// compiled side by side: the mixed ones hold twice the code.  Where a
// plane's pixel count is not a multiple of 4, its planes do not start on
// an 8-byte word: the VEC=false instance loads and stores element by
// element and masks the plane's end.  An ensemble holds up to MAX_MODELS =
// 8 models (the JAX kernel takes any number): the host passes the models'
// pointers, channels and widths as arrays, and the tables of 8 models of 32
// classes fill 8 KB of static shared memory at 8 columns.
#pragma once

#include "common.cuh"

#define MAX_MODELS 8
#define MAX_C 32
#define MAX_T1 8
#define PC_NT 256  // threads of a block
#define VP 4       // pixels of a thread
// the dtypes of a launch's models (template DT)
#define DT_F32 0
#define DT_BF16 1
#define DT_MIXED 2

struct PseudoArgs {
  const void* logits[MAX_MODELS];
  int c[MAX_MODELS];       // channels of each model
  int width[MAX_MODELS];   // their register widths: multiples of 4, <= 32
  int n_models;
  int bf16;        // bit m set: model m's logits are bf16, else f32
  int t;           // target classes T; the tables have T+1 columns
  int hard, entropy;
  int64_t hw;      // pixels per plane
  float min_agree;
  int ignore;
  float inv_log;   // 1 / ln(T+1)
  float inv_n;     // 1 / N
  const float* tables;  // per model [C_m, T+1], concatenated in model order
  const float* kc;      // [T]
  int32_t* out_label;
  float* out_conf;
};

// Four consecutive pixels of one channel plane.
template <typename T>
struct Pix4;
template <>
struct Pix4<__nv_bfloat16> {
  uint2 u;
  __device__ __forceinline__ float operator[](int j) const {
    const unsigned int w = j < 2 ? u.x : u.y;
    return __uint_as_float(j & 1 ? w & 0xffff0000u : w << 16);
  }
};
template <>
struct Pix4<float> {
  float4 f;
  __device__ __forceinline__ float operator[](int j) const {
    return j == 0 ? f.x : j == 1 ? f.y : j == 2 ? f.z : f.w;
  }
};

// Pixels p .. p+3 of a plane: one 8- or 16-byte load (VEC), or element by
// element with 0 past the plane's end (nv pixels left).
template <typename T, bool VEC>
__device__ __forceinline__ Pix4<T> load4(const T* p, int nv);
template <>
__device__ __forceinline__ Pix4<__nv_bfloat16> load4<__nv_bfloat16, true>(
    const __nv_bfloat16* p, int) {
  return {__ldg(reinterpret_cast<const uint2*>(p))};
}
template <>
__device__ __forceinline__ Pix4<__nv_bfloat16> load4<__nv_bfloat16, false>(
    const __nv_bfloat16* p, int nv) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned int e[VP];
#pragma unroll
  for (int j = 0; j < VP; ++j) e[j] = j < nv ? __ldg(q + j) : 0u;
  return {make_uint2(e[0] | e[1] << 16, e[2] | e[3] << 16)};
}
template <>
__device__ __forceinline__ Pix4<float> load4<float, true>(const float* p,
                                                          int) {
  return {__ldg(reinterpret_cast<const float4*>(p))};
}
template <>
__device__ __forceinline__ Pix4<float> load4<float, false>(const float* p,
                                                           int nv) {
  float e[VP];
#pragma unroll
  for (int j = 0; j < VP; ++j) e[j] = j < nv ? __ldg(p + j) : 0.f;
  return {make_float4(e[0], e[1], e[2], e[3])};
}

__device__ __forceinline__ float xlogx(float p) {
  return p > 0.f ? p * logf(fmaxf(p, 1e-30f)) : 0.f;
}

// Softmax numerators of one model's 4 pixels, pooled into the target
// columns: q[t][j] = sum_c exp(x_c - max) * tab[c][t]; inv[j] = 1 / sum_c
// exp(...).  CM >= cm is the register width; tab is the model's table
// padded to T1 columns.
template <int CM, int T1, typename T, bool VEC>
__device__ __forceinline__ void model_probs(const T* __restrict__ base,
                                            int64_t hw, int cm, int nv,
                                            const float* tab,
                                            float q[T1][VP], float inv[VP]) {
  Pix4<T> v[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c)
    v[c] = load4<T, VEC>(base + (int64_t)min(c, cm - 1) * hw, nv);
  float mx[VP], tot[VP];
#pragma unroll
  for (int j = 0; j < VP; ++j) {
    mx[j] = v[0][j];
    tot[j] = 0.f;
  }
#pragma unroll
  for (int c = 1; c < CM; ++c) {
    if (c < cm) {
#pragma unroll
      for (int j = 0; j < VP; ++j) mx[j] = fmaxf(mx[j], v[c][j]);
    }
  }
#pragma unroll
  for (int t = 0; t < T1; ++t)
#pragma unroll
    for (int j = 0; j < VP; ++j) q[t][j] = 0.f;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    if (c < cm) {
      float tr[T1];
#pragma unroll
      for (int t = 0; t < T1; t += 4) {
        const float4 t4 = reinterpret_cast<const float4*>(tab + c * T1)[t / 4];
        tr[t] = t4.x; tr[t + 1] = t4.y; tr[t + 2] = t4.z; tr[t + 3] = t4.w;
      }
#pragma unroll
      for (int j = 0; j < VP; ++j) {
        const float e = __expf(v[c][j] - mx[j]);
        tot[j] += e;
#pragma unroll
        for (int t = 0; t < T1; ++t) q[t][j] += e * tr[t];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VP; ++j) inv[j] = 1.f / tot[j];
}

// One model's q and inv at image b, pixels p0..: its logits read as T,
// its register width picked by one switch.
template <int T1, typename T, bool VEC>
__device__ __forceinline__ void model_at(const void* logits, int64_t b,
                                         int64_t p0, int64_t hw, int cm,
                                         int width, int nv, const float* tab,
                                         float q[T1][VP], float inv[VP]) {
  const T* base = reinterpret_cast<const T*>(logits) + b * cm * hw + p0;
  switch (width / 4) {
    case 1: model_probs<4, T1, T, VEC>(base, hw, cm, nv, tab, q, inv); break;
    case 2: model_probs<8, T1, T, VEC>(base, hw, cm, nv, tab, q, inv); break;
    case 3: model_probs<12, T1, T, VEC>(base, hw, cm, nv, tab, q, inv); break;
    case 4: model_probs<16, T1, T, VEC>(base, hw, cm, nv, tab, q, inv); break;
    case 5: model_probs<20, T1, T, VEC>(base, hw, cm, nv, tab, q, inv); break;
    case 6: model_probs<24, T1, T, VEC>(base, hw, cm, nv, tab, q, inv); break;
    case 7: model_probs<28, T1, T, VEC>(base, hw, cm, nv, tab, q, inv); break;
    default: model_probs<32, T1, T, VEC>(base, hw, cm, nv, tab, q, inv);
             break;
  }
}

// grid (pixel chunks of PC_NT * VP, B), block PC_NT.
template <int DT, int T1, bool VEC>
__global__ void __launch_bounds__(PC_NT)
pseudo_cm_kernel(const __grid_constant__ PseudoArgs a) {
  __shared__ __align__(16) float s_tab[MAX_MODELS * MAX_C * T1];
  __shared__ float s_kc[MAX_T1];
  const int t1 = a.t + 1;
  {
    int src = 0;
    for (int m = 0; m < a.n_models; ++m) {
      const int n = a.c[m] * T1;
      for (int i = threadIdx.x; i < n; i += PC_NT) {
        const int c = i / T1, t = i - c * T1;
        s_tab[m * MAX_C * T1 + i] = t < t1 ? a.tables[src + c * t1 + t] : 0.f;
      }
      src += a.c[m] * t1;
    }
  }
  if (threadIdx.x < a.t) s_kc[threadIdx.x] = a.kc[threadIdx.x];
  __syncthreads();

  const int64_t p0 = ((int64_t)blockIdx.x * PC_NT + threadIdx.x) * VP;
  if (p0 >= a.hw) return;
  const int nv = a.hw - p0 < VP ? (int)(a.hw - p0) : VP;
  const int64_t b = blockIdx.y;

  float acc[T1][VP];  // soft: summed target probs; hard: votes
#pragma unroll
  for (int t = 0; t < T1; ++t)
#pragma unroll
    for (int j = 0; j < VP; ++j) acc[t][j] = 0.f;

  for (int m = 0; m < a.n_models; ++m) {
    const int cm = a.c[m];
    const float* tab = s_tab + m * MAX_C * T1;
    float q[T1][VP], inv[VP];
    const bool bf = DT == DT_MIXED ? (a.bf16 >> m) & 1 : DT == DT_BF16;
    if (bf)
      model_at<T1, __nv_bfloat16, VEC>(a.logits[m], b, p0, a.hw, cm,
                                       a.width[m], nv, tab, q, inv);
    else
      model_at<T1, float, VEC>(a.logits[m], b, p0, a.hw, cm, a.width[m], nv,
                               tab, q, inv);
    if (a.hard) {
#pragma unroll
      for (int j = 0; j < VP; ++j) {
        float best = q[0][j] * inv[j];
        int lab = 0;
#pragma unroll
        for (int t = 1; t < T1; ++t) {
          if (t < t1) {
            const float qt = q[t][j] * inv[j];
            if (qt > best) { best = qt; lab = t; }
          }
        }
#pragma unroll
        for (int t = 0; t < T1; ++t)
          if (t < a.t && lab == t) acc[t][j] += 1.f;  // T: ignore column
      }
    } else {
#pragma unroll
      for (int t = 0; t < T1; ++t)
#pragma unroll
        for (int j = 0; j < VP; ++j)
          if (t < a.t) acc[t][j] += q[t][j] * inv[j];
    }
  }

  int lbl[VP];
  float conf[VP];
#pragma unroll
  for (int j = 0; j < VP; ++j) {
    float cf, top = 0.f;
    int lb = 0;
    if (a.hard) {
      top = acc[0][j];
#pragma unroll
      for (int t = 1; t < T1; ++t)
        if (t < a.t && acc[t][j] > top) { top = acc[t][j]; lb = t; }
      if (a.entropy) {
        float tot = 0.f;
#pragma unroll
        for (int t = 0; t < T1; ++t) if (t < a.t) tot += acc[t][j];
        float s = xlogx(((float)a.n_models - tot) * a.inv_n);
#pragma unroll
        for (int t = 0; t < T1; ++t)
          if (t < a.t) s += xlogx(acc[t][j] * a.inv_n);
        cf = 1.f + s * a.inv_log;
      } else {
        cf = top * a.inv_n;
      }
      if (!(top >= a.min_agree)) lb = a.ignore;
    } else {
      float f[T1];
#pragma unroll
      for (int t = 0; t < T1; ++t) f[t] = acc[t][j] * a.inv_n;
      float best = f[0];
#pragma unroll
      for (int t = 1; t < T1; ++t)
        if (t < a.t && f[t] > best) { best = f[t]; lb = t; }
      if (a.entropy) {
        float tot = 0.f;
#pragma unroll
        for (int t = 0; t < T1; ++t) if (t < a.t) tot += f[t];
        float s = xlogx(fmaxf(1.f - tot, 0.f));
#pragma unroll
        for (int t = 0; t < T1; ++t) if (t < a.t) s += xlogx(f[t]);
        cf = 1.f + s * a.inv_log;
      } else {
        cf = best;
      }
    }
    const float thr = (lb >= 0 && lb < a.t) ? s_kc[lb] : 0.f;
    if (!(cf >= thr)) lb = a.ignore;
    lbl[j] = lb;
    conf[j] = cf;
  }
  const int64_t o = b * a.hw + p0;
  if constexpr (VEC) {
    *reinterpret_cast<int4*>(a.out_label + o) =
        make_int4(lbl[0], lbl[1], lbl[2], lbl[3]);
    *reinterpret_cast<float4*>(a.out_conf + o) =
        make_float4(conf[0], conf[1], conf[2], conf[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VP; ++j)
      if (j < nv) {
        a.out_label[o + j] = lbl[j];
        a.out_conf[o + j] = conf[j];
      }
  }
}

template <int DT, int T1>
static void launch_typed(const PseudoArgs& a, int b, int vec,
                         cudaStream_t st) {
  const dim3 grid(mspl_blocks(a.hw, PC_NT * VP), b);
  if (vec) pseudo_cm_kernel<DT, T1, true><<<grid, PC_NT, 0, st>>>(a);
  else pseudo_cm_kernel<DT, T1, false><<<grid, PC_NT, 0, st>>>(a);
}

template <int DT>
static void launch_dt(const PseudoArgs& a, int b, int t1_inst, int vec,
                      cudaStream_t st) {
  if (t1_inst == 4) launch_typed<DT, 4>(a, b, vec, st);
  else launch_typed<DT, 8>(a, b, vec, st);
}

// The C interface of both libraries (pseudo_cm.cu for single-dtype
// ensembles, pseudo_cm_mixed.cu for mixed ones): logits[0..n_models)
// [B, C_m, H, W] (bit m of bf16_mask set: model m's are bf16, else f32),
// cs their channels and ws their register widths (multiples of 4 from C_m
// up to 32), host arrays of n_models entries; tables and kc as above,
// hw = H*W; t1_inst the tables' padded width (4 or 8, >= T+1); vec: one
// vector load a channel (hw a multiple of 4, every pointer on a 16-byte
// word).  Writes label int32 and conf f32 [B, H, W].
#define PSEUDO_CM_PARAMS                                                     \
  const void *const *logits, const int *cs, const int *ws, int n_models,    \
      const float *tables, const float *kc, int t, long long hw, int b,      \
      int bf16_mask, int hard, int entropy, float min_agree, int ignore,     \
      float inv_log, int t1_inst, int vec, void *out_label, void *out_conf, \
      void *stream

// The arguments checked and packed into `a`; returns a CUDA error code, 0
// when the entry may launch.
static int pack_args(PseudoArgs& a, PSEUDO_CM_PARAMS) {
  if (n_models < 1 || n_models > MAX_MODELS || b > 65535 ||
      (t1_inst != 4 && t1_inst != 8) || t + 1 > t1_inst ||
      (vec && hw % VP != 0))
    return (int)cudaErrorInvalidValue;
  for (int m = 0; m < MAX_MODELS; ++m) {
    const bool in = m < n_models;
    a.logits[m] = in ? logits[m] : nullptr;
    a.c[m] = in ? cs[m] : 0;
    a.width[m] = in ? ws[m] : 0;
    if (in && (cs[m] < 1 || ws[m] < cs[m] || ws[m] % 4 != 0 ||
               ws[m] > MAX_C))
      return (int)cudaErrorInvalidValue;
  }
  a.n_models = n_models;
  a.bf16 = bf16_mask & ((1 << n_models) - 1);
  a.t = t;
  a.hard = hard;
  a.entropy = entropy;
  a.hw = hw;
  a.min_agree = min_agree;
  a.ignore = ignore;
  a.inv_log = inv_log;
  a.inv_n = 1.f / (float)n_models;
  a.tables = tables;
  a.kc = kc;
  a.out_label = reinterpret_cast<int32_t*>(out_label);
  a.out_conf = reinterpret_cast<float*>(out_conf);
  return 0;
}

#define PSEUDO_CM_ARGS                                                       \
  logits, cs, ws, n_models, tables, kc, t, hw, b, bf16_mask, hard, entropy,  \
      min_agree, ignore, inv_log, t1_inst, vec, out_label, out_conf, stream
