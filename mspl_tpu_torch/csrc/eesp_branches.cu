// EESP branch stacks: K dilated depthwise 3x3 branches with hierarchical
// feature fusion, stride 1 (an EESP unit) or stride 2 (a DownSampler front,
// with the 3x3/s2 average pool of the block input beside it).
//
// Replaces the Pallas kernels
//   * mspl_tpu/ops/pallas_eesp.py::eesp_branches_pallas (stride 1): out
//     channel ki*n + c = sum_{j <= ki} dwconv_{d_j}(proj)[c], padding = d_j;
//   * mspl_tpu/ops/pallas_downsampler.py::down_front_pallas (stride 2): the
//     same branch stack at stride 2 (output (H-1)//2+1) and AvgPool2d(3, 2,
//     padding 1, count_include_pad=True) of the block input x.
//
// Bound: bytes.  Each output element costs 19 flops (9 multiply-adds and one
// HFF add), while K outputs are written for every input read: at the main
// path's shapes the branch stack moves ~0.16 GB per level3 call and needs
// ~1.2 GFLOP, ~6x under the card's flop/byte balance in f32.
// Design: one block per (plane, 16x32 output tile); a plane is one channel
// of one image, either a proj channel (the K branches) or, for the
// DownSampler front, a channel of x (the pool).  The block stages the input
// region its tile reads, halo of max(d) (or 1 for the pool) included, in
// shared memory as f32, zero outside the image, so every tap of every
// dilation is a shared-memory read and the input plane is read from device
// memory about once.  Each thread owns one output column of two rows (in a
// trial on the H100, 16x32 tiles beat 8x32 and matched 32x32): it
// accumulates the 9 taps of each branch and the HFF running sum in f32 and
// rounds each of its K outputs once; a warp writes 32 consecutive pixels of
// one row.  The arguments are __grid_constant__: the dilations are indexed
// at run time, which otherwise copies the whole argument block to local
// memory in every thread (2.4x slower, PERF.md).
// Deliberate difference: the TPU kernel of the stride-1 stack multiplies in
// the input dtype (bf16 on the main path); this one computes in f32 and
// rounds once, as does the plain version beside it (ops/eesp_branches.py).
#include "common.cuh"

#define MAX_K 8
#define RPT 2  // output rows per thread
#define OTW 32
#define NT 256
#define OTH (NT / OTW * RPT)

struct BranchArgs {
  const void* proj;    // [B, n, H, W]
  const void* x;       // pool input [B, nin, H, W] (stride 2 only)
  void* out;           // [B, K*n, Ho, Wo]
  void* pool;          // [B, nin, Ho, Wo] (stride 2 only)
  const float* taps;   // [K, 3, 3, n]
  int b, n, nin, h, w, ho, wo, k, dmax;
  int dil[MAX_K];
};

template <typename T, int S>
__global__ void __launch_bounds__(NT)
branches_kernel(const __grid_constant__ BranchArgs a) {
  extern __shared__ float s_in[];
  __shared__ float s_taps[MAX_K * 9];
  const int64_t plane = blockIdx.x;
  const int64_t n_br = (int64_t)a.b * a.n;
  const bool is_pool = plane >= n_br;
  const int halo = is_pool ? 1 : a.dmax;
  const int oy0 = blockIdx.y * OTH, ox0 = blockIdx.z * OTW;
  const int iy0 = oy0 * S - halo, ix0 = ox0 * S - halo;
  const int rows = (OTH - 1) * S + 1 + 2 * halo;
  const int cols = (OTW - 1) * S + 1 + 2 * halo;
  const int64_t hw = (int64_t)a.h * a.w;
  const T* src = is_pool ? reinterpret_cast<const T*>(a.x) + (plane - n_br) * hw
                         : reinterpret_cast<const T*>(a.proj) + plane * hw;
  for (int i = threadIdx.x; i < rows * cols; i += NT) {
    const int ry = i / cols, rx = i - ry * cols;
    const int gy = iy0 + ry, gx = ix0 + rx;
    s_in[i] = (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
                  ? to_f32(src[(int64_t)gy * a.w + gx]) : 0.f;
  }
  const int c = is_pool ? 0 : (int)(plane % a.n);
  if (!is_pool && threadIdx.x < a.k * 9)
    s_taps[threadIdx.x] = a.taps[(int64_t)threadIdx.x * a.n + c];
  __syncthreads();

  const int64_t plane_o = (int64_t)a.ho * a.wo;
  const int tx = threadIdx.x % OTW, ox = ox0 + tx;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int ty = threadIdx.x / OTW + r * (NT / OTW);
    const int oy = oy0 + ty;
    if (oy >= a.ho || ox >= a.wo) continue;
    const int64_t off = (int64_t)oy * a.wo + ox;
    const int cy = ty * S + halo, cx = tx * S + halo;  // centre in s_in
    if (is_pool) {
      float s = 0.f;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) s += s_in[(cy + dy) * cols + cx + dx];
      reinterpret_cast<T*>(a.pool)[(plane - n_br) * plane_o + off] =
          from_f32<T>(s / 9.f);
      continue;
    }
    const int64_t bi = plane / a.n;
    T* dst = reinterpret_cast<T*>(a.out) + (bi * a.k * a.n + c) * plane_o + off;
    float hff = 0.f;
    for (int kk = 0; kk < a.k; ++kk) {
      const int d = a.dil[kk];
      const float* tk = s_taps + kk * 9;
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* row = s_in + (cy + (ky - 1) * d) * cols + cx;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) acc += tk[ky * 3 + kx] * row[(kx - 1) * d];
      }
      hff += acc;
      dst[(int64_t)kk * a.n * plane_o] = from_f32<T>(hff);
    }
  }
}

template <typename T, int S>
static void launch_typed(const BranchArgs& a, cudaStream_t st) {
  const int halo = a.dmax > 1 ? a.dmax : 1;
  const int rows = (OTH - 1) * S + 1 + 2 * halo;
  const int cols = (OTW - 1) * S + 1 + 2 * halo;
  const size_t smem = (size_t)rows * cols * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(branches_kernel<T, S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const int64_t planes = (int64_t)a.b * a.n + (S == 2 ? (int64_t)a.b * a.nin : 0);
  dim3 grid((unsigned int)planes, (a.ho + OTH - 1) / OTH, (a.wo + OTW - 1) / OTW);
  branches_kernel<T, S><<<grid, NT, smem, st>>>(a);
}

// stride 1 or 2; x/pool are read only at stride 2 (nin pool planes)
extern "C" int eesp_branches_launch(
    const void* proj, const void* x, void* out, void* pool, const float* taps,
    int dtype, int stride, int b, int n, int nin, int h, int w, int k,
    const int* dil, void* stream) {
  if (k < 1 || k > MAX_K || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  BranchArgs a;
  a.proj = proj;
  a.x = x;
  a.out = out;
  a.pool = pool;
  a.taps = taps;
  a.b = b;
  a.n = n;
  a.nin = stride == 2 ? nin : 0;
  a.h = h;
  a.w = w;
  a.ho = (h - 1) / stride + 1;
  a.wo = (w - 1) / stride + 1;
  a.k = k;
  a.dmax = 0;
  for (int i = 0; i < MAX_K; ++i) {
    a.dil[i] = i < k ? dil[i] : 0;
    if (i < k && dil[i] > a.dmax) a.dmax = dil[i];
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if ((int64_t)b * (n + a.nin) > 0 && h > 0 && w > 0) {
    if (dtype == MSPL_BF16) {
      if (stride == 2) launch_typed<__nv_bfloat16, 2>(a, st);
      else launch_typed<__nv_bfloat16, 1>(a, st);
    } else {
      if (stride == 2) launch_typed<float, 2>(a, st);
      else launch_typed<float, 1>(a, st);
    }
  }
  return (int)cudaGetLastError();
}
