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
// Bound: bytes.  Each pixel reads its sum(C_m) logits (35 bf16 values on the
// main shape) and writes 8 bytes; ~10 flops per logit. Design: the
// channel-major pass's streaming design (pseudo_cm.cuh: 4 pixels a thread,
// __expf, one reciprocal a pixel and model, tables padded to a 4- or 8-column
// instance in shared memory, __grid_constant__ arguments, a per-model dtype
// bit), over rows of C_m values.  A warp takes a run of 128 consecutive pixels;
// of each model the run is 128 * C_m contiguous values, which the warp copies
// into its own stage in shared memory with 16-byte cp.async copies (a warp's
// copy instruction moves 512 contiguous bytes; all models' copies are in flight
// at once, while the block stages the tables), then waits for its own copies
// and syncs the warp only: no block barrier stands between a warp's loads and
// its arithmetic.  Lane l then takes pixels l, l + 32, l + 64 and l + 96 of the
// run, whose channel c sits at value (l + 32 j) * C_m + c of the stage: lanes
// 32 pixels apart read words C_m apart, no bank conflict for odd C_m in f32 and
// at most 2-way in bf16, and a warp writes 32 consecutive labels and
// confidences per store.  Per pixel and model, in the plain version's order:
// the max over the model's channels, then exp(x - max) through __expf, the
// tables' weighted sums and one reciprocal.  The channel loop runs to the
// model's C_m at run time (the values are in shared memory, so no register
// width is padded: the earlier thread-a-pixel design's register widths 8/16/32
// issued 32 loads for Cityscapes' 19 channels).  Where a logit tensor is not on
// a 16-byte word, the VEC=false instance copies element by element; a run past
// the last pixel copies what is there (cp.async fills the rest of a 16-byte
// chunk with zeros) and masks its stores, so any pixel count takes the vector
// path.  The stage's bytes a warp, and so the warps a block, come from the
// wrapper's plan (ops/pseudo.py pm_plan).  One instance serves every
// ensemble's dtypes: each model's dtype bit is read in the model loop.  All-f32
// and all-bf16 instances beside it read no faster (H100 80GB HBM3 at 700 W, bf16
// batch 128: 0.5265 and 0.5242 ms against its 0.5266 and 0.5302, in turns in
// one run of tools/torch_route_kernels.py), so there are none: 4 instances
// (table width 4 or 8, VEC or not).
// On the H100 the main path's call (bf16, batch 128) takes ~0.53 ms, 1.44x its
// bound (the thread-a-pixel design: 1.68; tools/torch_route_kernels.py,
// PERF.md).  The other candidate, each thread's 4 consecutive pixels loaded
// straight into registers with C_m fixed at compile time (one instance for
// every channel count), read 0.548 ms against this design's 0.527 in the same
// run, and was dropped.  An ensemble holds up to MAX_MODELS = 8 models (the
// JAX kernel takes any number), passed as arrays: 8 f32 models of 32
// classes stage 128 KB a warp, and the plan then takes one warp a block.
#include "common.cuh"

#define MAX_MODELS 8
#define MAX_C 32
#define MAX_T1 8
#define PM_RUN 128  // pixels a warp
#define VP 4        // pixels a lane: l + 32 j
#define MAX_WARPS 4

struct PmArgs {
  const void* logits[MAX_MODELS];
  int c[MAX_MODELS];
  int soff[MAX_MODELS];  // byte offset of model m's run in a warp's stage
  int wbytes;            // stage bytes a warp
  int n_models;
  int bf16;        // bit m set: model m's logits are bf16, else f32
  int t;           // target classes T; the tables have T+1 columns
  int hard, entropy, has_kc;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// A warp's run of one model, npx pixels of c values of `es` bytes, into
// its stage: 16-byte copies (VEC) or element by element.
template <bool VEC>
__device__ __forceinline__ void stage_run(unsigned char* dst,
                                          const unsigned char* src,
                                          int nbytes, int es, int lane) {
  if (VEC) {
    for (int i = lane * 16; i < nbytes; i += 32 * 16)
      cp_async16(dst + i, src + i, min(16, nbytes - i));
  } else if (es == 2) {
    for (int i = lane; i < nbytes / 2; i += 32)
      reinterpret_cast<unsigned short*>(dst)[i] =
          reinterpret_cast<const unsigned short*>(src)[i];
  } else {
    for (int i = lane; i < nbytes / 4; i += 32)
      reinterpret_cast<float*>(dst)[i] = reinterpret_cast<const float*>(src)[i];
  }
}

// Softmax numerators of one model's 4 pixels of a lane, pooled into the
// target columns: q[t][j] = sum_c exp(x_c - max) * tab[c][t]; inv[j] =
// 1 / sum_c exp(...).  s: the model's staged run; tab: its table padded to
// T1 columns.
template <int T1, typename T>
__device__ __forceinline__ void model_probs(const T* s, int cm, int lane,
                                            const float* tab, float q[T1][VP],
                                            float inv[VP]) {
  const T* px[VP];
  float mx[VP], tot[VP];
#pragma unroll
  for (int j = 0; j < VP; ++j) {
    px[j] = s + (lane + 32 * j) * cm;
    mx[j] = to_f32(px[j][0]);
    tot[j] = 0.f;
  }
  for (int c = 1; c < cm; ++c)
#pragma unroll
    for (int j = 0; j < VP; ++j) mx[j] = fmaxf(mx[j], to_f32(px[j][c]));
#pragma unroll
  for (int t = 0; t < T1; ++t)
#pragma unroll
    for (int j = 0; j < VP; ++j) q[t][j] = 0.f;
  for (int c = 0; c < cm; ++c) {
    float tr[T1];
#pragma unroll
    for (int t = 0; t < T1; t += 4) {
      const float4 t4 = reinterpret_cast<const float4*>(tab + c * T1)[t / 4];
      tr[t] = t4.x; tr[t + 1] = t4.y; tr[t + 2] = t4.z; tr[t + 3] = t4.w;
    }
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      const float e = __expf(to_f32(px[j][c]) - mx[j]);
      tot[j] += e;
#pragma unroll
      for (int t = 0; t < T1; ++t) q[t][j] += e * tr[t];
    }
  }
#pragma unroll
  for (int j = 0; j < VP; ++j) inv[j] = 1.f / tot[j];
}

// The tables, padded to T1 columns, and kc into shared memory (the caller
// syncs the block).
template <int T1>
__device__ __forceinline__ void stage_tables(const PmArgs& a, float* s_tab,
                                             float* s_kc) {
  const int t1 = a.t + 1;
  int src = 0;
  for (int m = 0; m < a.n_models; ++m) {
    const int n = a.c[m] * T1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = i / T1, t = i - c * T1;
      s_tab[m * MAX_C * T1 + i] = t < t1 ? a.tables[src + c * t1 + t] : 0.f;
    }
    src += a.c[m] * t1;
  }
  if (a.has_kc && threadIdx.x < a.t) s_kc[threadIdx.x] = a.kc[threadIdx.x];
}

// One model's q and inv into the 4 pixels' sums: soft, the T+1 columns'
// probabilities; hard, a vote for the first argmax over T+1 (T, the
// ignore column, votes for nothing).
template <int T1>
__device__ __forceinline__ void accumulate(const PmArgs& a,
                                           const float q[T1][VP],
                                           const float inv[VP],
                                           float acc[T1][VP]) {
  const int t1 = a.t + 1;
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
        if (t < a.t && lab == t) acc[t][j] += 1.f;
    }
  } else {
#pragma unroll
    for (int t = 0; t < T1; ++t)
#pragma unroll
      for (int j = 0; j < VP; ++j)
        if (t < t1) acc[t][j] += q[t][j] * inv[j];
  }
}

// Pixel j's label and confidence from the models' sums.
template <int T1>
__device__ __forceinline__ void decide(const PmArgs& a, const float acc[T1][VP],
                                       int j, const float* s_kc, int& lbl,
                                       float& conf) {
  const int t1 = a.t + 1;
  float cf, top;
  int lb = 0;
  if (a.hard) {
    top = acc[0][j];
#pragma unroll
    for (int t = 1; t < T1; ++t)
      if (t < a.t && acc[t][j] > top) { top = acc[t][j]; lb = t; }
    if (a.entropy) {
      float tot = 0.f, s = 0.f;
#pragma unroll
      for (int t = 0; t < T1; ++t)
        if (t < a.t) { tot += acc[t][j]; s += xlogx(acc[t][j] * a.inv_n); }
      s += xlogx(((float)a.n_models - tot) * a.inv_n);
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
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < T1; ++t)
        if (t < t1) s += xlogx(f[t]);
      cf = 1.f + s * a.inv_log;
    } else {
      cf = best;
    }
  }
  if (a.has_kc) {
    const float thr = (lb >= 0 && lb < a.t) ? s_kc[lb] : s_kc[0];
    if (!(cf >= thr)) lb = a.ignore;
  }
  lbl = lb;
  conf = cf;
}

// grid: runs of 128 pixels, `warps` a block; block 32 * warps threads;
// dynamic shared memory warps * wbytes.
template <int T1, bool VEC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
pseudo_pm_kernel(const __grid_constant__ PmArgs a) {
  extern __shared__ __align__(16) unsigned char s_stage[];
  __shared__ __align__(16) float s_tab[MAX_MODELS * MAX_C * T1];
  __shared__ float s_kc[MAX_T1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t pix0 =
      ((int64_t)blockIdx.x * (blockDim.x >> 5) + warp) * PM_RUN;
  const int npx = (int)min((int64_t)PM_RUN, a.total - pix0);
  unsigned char* stage = s_stage + warp * a.wbytes;
  if (npx > 0) {
    for (int m = 0; m < a.n_models; ++m) {
      const bool bf = (a.bf16 >> m) & 1;
      const int es = bf ? 2 : 4, row = a.c[m] * es;
      stage_run<VEC>(stage + a.soff[m],
                     reinterpret_cast<const unsigned char*>(a.logits[m]) +
                         pix0 * row,
                     npx * row, es, lane);
    }
    if (VEC) asm volatile("cp.async.commit_group;\n" ::);
  }
  stage_tables<T1>(a, s_tab, s_kc);
  __syncthreads();
  if (npx <= 0) return;
  if (VEC) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  float acc[T1][VP];  // soft: summed probabilities (T+1); hard: votes (T)
#pragma unroll
  for (int t = 0; t < T1; ++t)
#pragma unroll
    for (int j = 0; j < VP; ++j) acc[t][j] = 0.f;
  for (int m = 0; m < a.n_models; ++m) {
    const float* tab = s_tab + m * MAX_C * T1;
    float q[T1][VP], inv[VP];
    const bool bf = (a.bf16 >> m) & 1;
    if (bf)
      model_probs<T1>(reinterpret_cast<const __nv_bfloat16*>(stage +
                                                             a.soff[m]),
                      a.c[m], lane, tab, q, inv);
    else
      model_probs<T1>(reinterpret_cast<const float*>(stage + a.soff[m]),
                      a.c[m], lane, tab, q, inv);
    accumulate<T1>(a, q, inv, acc);
  }
#pragma unroll
  for (int j = 0; j < VP; ++j) {
    int lb;
    float cf;
    decide<T1>(a, acc, j, s_kc, lb, cf);
    const int p = lane + 32 * j;
    if (p < npx) {
      a.out_label[pix0 + p] = lb;
      a.out_conf[pix0 + p] = cf;
    }
  }
}

template <int T1>
static int launch_typed(const PmArgs& a, int warps, int vec,
                        cudaStream_t st) {
  const int smem = warps * a.wbytes;
  const unsigned int grid = mspl_blocks(a.total, warps * PM_RUN);
  auto kern = vec ? pseudo_pm_kernel<T1, true> : pseudo_pm_kernel<T1, false>;
  // always opt in: the default 48 KB covers the static tables too, so a
  // stage just under 48 KB would be refused without it
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, warps * 32, smem, st>>>(a);
  return 0;
}

// logits[0..n_models) [B, H, W, C_m] (bit m of bf16_mask set: model m's
// are bf16, else f32), cs their channels; the plan (ops/pseudo.py pm_plan):
// offs each model's byte offset in a warp's stage (cs and offs host arrays
// of n_models entries), wbytes the stage's bytes, warps a block, t1_inst
// the tables' padded width (4 or 8, >= T+1), vec: 16-byte copies (every
// logit tensor on a 16-byte word).  Writes label int32 and conf f32
// [B, H, W].  The block's shared memory, the stages and the static tables
// of MAX_MODELS models, stays within the card's 227 KB: 8 f32 models of 32
// classes stage 128 KB a warp, at one warp a block.
extern "C" int pseudo_pm_launch(
    const void* const* logits, const int* cs, int n_models,
    const float* tables, const float* kc, int has_kc, int t, long long total,
    int bf16_mask, int hard, int entropy, float min_agree, int ignore,
    float inv_log, const int* offs, int wbytes, int warps, int t1_inst,
    int vec, void* out_label, void* out_conf, void* stream) {
  PmArgs a;
  if (n_models < 1 || n_models > MAX_MODELS || warps < 1 ||
      warps > MAX_WARPS || (t1_inst != 4 && t1_inst != 8) ||
      t + 1 > t1_inst || wbytes % 16 ||
      (int64_t)warps * wbytes + 4 * (MAX_MODELS * MAX_C * t1_inst + MAX_T1) >
          227 * 1024)
    return (int)cudaErrorInvalidValue;
  a.bf16 = bf16_mask & ((1 << n_models) - 1);
  for (int m = 0; m < MAX_MODELS; ++m) {
    const bool in = m < n_models;
    a.logits[m] = in ? logits[m] : nullptr;
    a.c[m] = in ? cs[m] : 0;
    a.soff[m] = in ? offs[m] : 0;
    if (in) {
      const int es = (a.bf16 >> m) & 1 ? 2 : 4;
      if (cs[m] < 1 || cs[m] > MAX_C || offs[m] % 16 ||
          offs[m] + PM_RUN * cs[m] * es > wbytes)
        return (int)cudaErrorInvalidValue;
    }
  }
  a.wbytes = wbytes;
  a.n_models = n_models;
  a.t = t;
  a.hard = hard;
  a.entropy = entropy;
  a.has_kc = has_kc;
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
  int err = 0;
  if (total > 0)
    err = t1_inst == 4 ? launch_typed<4>(a, warps, vec, st)
                       : launch_typed<8>(a, warps, vec, st);
  return err ? err : (int)cudaGetLastError();
}
