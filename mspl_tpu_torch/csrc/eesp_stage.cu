// One eval EESP unit fused into one kernel; a stage of U units is U
// launches (ops/eesp_stage.py chains them through two buffers).
//
// Replaces the Pallas kernel mspl_tpu/ops/pallas_eesp_stage.py::
// eesp_stage_fused_eval, which runs a chain of stride-1 eval EESP units per
// image in VMEM: grouped 1x1 proj (BN scale folded into the weights) + bias
// + PReLU -> K dilated depthwise 3x3 + HFF -> BR affine + PReLU -> grouped
// (or dense) 1x1 expand (BN scale folded) + bias -> residual add -> PReLU.
//
// Bound: at the main path's shapes (level3 [128, 256, 32, 60], level4
// [128, 512, 16, 30], bf16) a unit's two 1x1 products are ~10 GFLOP, its
// taps, HFF, affines and activations ~1-2 GFLOP of f32 work, and its input
// and output ~0.1-0.25 GB.  On the tensor cores the products would take
// less than the f32 work or the bytes; this kernel computes them with f32
// FMAs, so the products bound it (see PERF.md for its time beside the
// bound).
// Design: one image plane of a stage does not fit a block's 227 KB of
// shared memory (level3 is 983 KB in bf16), and the dilated taps need a
// halo of max(d) rows of the proj output.  So a block takes one image and a
// band of `th` full-width output rows, and recomputes the proj over the
// band plus its halo rows (1x at level4, where the band is the whole image;
// 1.25x at level3 in bf16), keeping the proj output y in shared memory in
// the working dtype (the point where this kernel and the plain version
// round).  The band's output pixels are then taken in chunks of `pc`: the
// block computes each chunk's K*n branch values with their HFF sums, the BR
// affine and PReLU in f32 into shared memory (zero padding of y is an
// explicit bounds test, so dilations that reach past a tiny plane read
// exact zeros), then the expand product, bias, residual (read from the
// unit's input) and PReLU, rounding each output once.  The products are
// register-tiled 4 output channels x 4 pixels per thread with the weights
// (f32, BN folded, a few hundred KB) read through L1/L2 as float4: a warp
// shares one channel quad (broadcast loads) over 32 pixel quads, and the 16
// warps of one proj step cover every channel quad of the same 128 pixels,
// so the input band is read from L2 about once per step.  The proj uses
// only its group's inputs (g_proj groups), the grouped expand only its
// branch's n inputs.  The product loops are unrolled four deep so several
// loads are in flight per thread: one block of 16 warps fills an SM's
// shared memory, so there are few warps to hide latency with (in a trial
// on the H100 the unroll helped, and 8- or 16-byte accesses of the 4-pixel
// rows did not, so they are not used).  In a trial that left out one phase
// at a time, each of the three took about a third of the time, all far
// under the card's rates: the next step is tensor-core products and more
// warps per SM, not another tweak.  The
// arguments are __grid_constant__, so the dilations indexed at run time are
// read in place, not copied to local memory.
#include "common.cuh"

#define MAX_K 8
#define NT 512

struct StageArgs {
  const void* x;     // unit input [B, C, H, W]
  void* out;         // unit output [B, C, H, W] (not x)
  const float* prm;  // packed: pw [C, n] | pb [n] | pa [n] | taps [K*9, n]
                     // | ca [C] | cb [C] | cal [C] | ew [K, n, n] or [C, C]
                     // | eb [C] | alpha [C]
  int b, c, n, k, h, w;
  int g_proj;        // proj groups
  int grouped;       // expand: 1 = per-branch [K, n, n], 0 = dense [C, C]
  int th;            // output rows per block
  int pc;            // output pixels per chunk (a multiple of 4)
  int ys_cap;        // pixels per channel of the staged proj output
  int dmax;
  int dil[MAX_K];
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
eesp_unit_kernel(const __grid_constant__ StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);                 // [C][pc]
  T* ys = reinterpret_cast<T*>(zs + (size_t)a.c * a.pc);      // [n][ys_cap]
  const int C = a.c, n = a.n, K = a.k, W = a.w, H = a.h;
  const int r0 = blockIdx.x * a.th;
  const int r1 = min(H, r0 + a.th);
  const int h0 = max(0, r0 - a.dmax), h1 = min(H, r1 + a.dmax);
  const int ph = (h1 - h0) * W;  // halo band pixels
  const int po = (r1 - r0) * W;  // output band pixels
  const int64_t hw = (int64_t)H * W;
  const T* xb = reinterpret_cast<const T*>(a.x) + (int64_t)blockIdx.y * C * hw;
  T* ob = reinterpret_cast<T*>(a.out) + (int64_t)blockIdx.y * C * hw;
  const float* pw = a.prm;
  const float* pb = pw + (size_t)C * n;
  const float* pa = pb + n;
  const float* taps = pa + n;
  const float* ca = taps + (size_t)K * 9 * n;
  const float* cb = ca + C;
  const float* cal = cb + C;
  const float* ew = cal + C;
  const float* eb = ew + (a.grouped ? (size_t)K * n * n : (size_t)C * C);
  const float* alpha = eb + C;

  // 1. proj over the halo band: ys[o][p] = PReLU(sum_i x[i][p] pw[i][o] + pb)
  {
    const int no4 = n / 4, p4n = (ph + 3) / 4;
    const int cin_g = C / a.g_proj, cout_g = n / a.g_proj;
    const int per_win = no4 * 32;  // items of one 128-pixel window
    const int total = per_win * ((p4n + 31) / 32);
    const T* xs = xb + (int64_t)h0 * W;
    for (int item = threadIdx.x; item < total; item += NT) {
      const int win = item / per_win, rem = item - win * per_win;
      const int o0 = (rem / 32) * 4;
      const int p0 = (win * 32 + (rem & 31)) * 4;
      if (p0 >= ph) continue;
      const int i0 = (o0 / cout_g) * cin_g;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
      const bool full = p0 + 4 <= ph;
#pragma unroll 4
      for (int i = i0; i < i0 + cin_g; ++i) {
        const float4 wv =
            *reinterpret_cast<const float4*>(pw + (size_t)i * n + o0);
        const T* xr = xs + (int64_t)i * hw + p0;
        float xv[4];
#pragma unroll
        for (int v = 0; v < 4; ++v)
          xv[v] = (full || p0 + v < ph) ? to_f32(xr[v]) : 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[0][v] += wv.x * xv[v];
          acc[1][v] += wv.y * xv[v];
          acc[2][v] += wv.z * xv[v];
          acc[3][v] += wv.w * xv[v];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = o0 + u;
        const float bias = pb[o], al = pa[o];
        T* yo = ys + (size_t)o * a.ys_cap + p0;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (p0 + v < ph) yo[v] = from_f32<T>(prelu(acc[u][v] + bias, al));
      }
    }
  }
  __syncthreads();

  const int j4n = a.pc / 4;
  for (int q0 = 0; q0 < po; q0 += a.pc) {
    // 2. branches + HFF + BR affine + PReLU of pixels q0..q0+pc-1 -> zs (f32)
    for (int item = threadIdx.x; item < n * a.pc; item += NT) {
      const int ch = item / a.pc, j = item - ch * a.pc;
      const int q = q0 + j;
      if (q >= po) {
        for (int kk = 0; kk < K; ++kk) zs[(size_t)(kk * n + ch) * a.pc + j] = 0.f;
        continue;
      }
      const int yy = r0 + q / W, xx = q % W;
      const T* yc = ys + (size_t)ch * a.ys_cap;
      float hff = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const int d = a.dil[kk];
        const float* tk = taps + (size_t)kk * 9 * n + ch;
        float acc = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int sy = yy + (ky - 1) * d;
          if (sy < 0 || sy >= H) continue;
          const T* yrow = yc + (sy - h0) * W;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int sx = xx + (kx - 1) * d;
            if (sx < 0 || sx >= W) continue;
            acc += tk[(ky * 3 + kx) * n] * to_f32(yrow[sx]);
          }
        }
        hff += acc;
        const int co = kk * n + ch;
        zs[(size_t)co * a.pc + j] = prelu(hff * ca[co] + cb[co], cal[co]);
      }
    }
    __syncthreads();

    // 3. expand + bias + residual + PReLU, rounded once per output
    for (int item = threadIdx.x; item < (C / 4) * j4n; item += NT) {
      const int o0 = (item / j4n) * 4, j0 = (item - (item / j4n) * j4n) * 4;
      int i0, ni, ldw;
      const float* wrow;
      if (a.grouped) {
        const int g = o0 / n;
        i0 = g * n;
        ni = n;
        ldw = n;
        wrow = ew + (size_t)g * n * n + (o0 - g * n);
      } else {
        i0 = 0;
        ni = C;
        ldw = C;
        wrow = ew + o0;
      }
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
      const float* zrow = zs + (size_t)i0 * a.pc + j0;
#pragma unroll 4
      for (int i = 0; i < ni; ++i) {
        const float4 wv = *reinterpret_cast<const float4*>(wrow + (size_t)i * ldw);
        const float4 zv = *reinterpret_cast<const float4*>(zrow + (size_t)i * a.pc);
        const float zz[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[0][v] += wv.x * zz[v];
          acc[1][v] += wv.y * zz[v];
          acc[2][v] += wv.z * zz[v];
          acc[3][v] += wv.w * zz[v];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = o0 + u;
        const float bias = eb[o], al = alpha[o];
        const int64_t base = (int64_t)o * hw + (int64_t)r0 * W + q0 + j0;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (q0 + j0 + v < po) {
            const float s = acc[u][v] + bias + to_f32(xb[base + v]);
            ob[base + v] = from_f32<T>(prelu(s, al));
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
static int launch_typed(const StageArgs& a, cudaStream_t st) {
  const size_t smem = (size_t)a.c * a.pc * sizeof(float) +
                      (size_t)a.n * a.ys_cap * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      eesp_unit_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.h + a.th - 1) / a.th, a.b);
  eesp_unit_kernel<T><<<grid, NT, smem, st>>>(a);
  return 0;
}

extern "C" int eesp_unit_launch(
    const void* x, void* out, const float* prm, int dtype, int b, int c,
    int n, int k, int h, int w, int g_proj, int grouped, int th, int pc,
    int ys_cap, const int* dil, void* stream) {
  if (k < 1 || k > MAX_K || n % 4 || c != n * k || pc % 4 || pc < 4 ||
      g_proj < 1 || c % g_proj || (n / g_proj) % 4 || th < 1)
    return (int)cudaErrorInvalidValue;
  StageArgs a;
  a.x = x;
  a.out = out;
  a.prm = prm;
  a.b = b;
  a.c = c;
  a.n = n;
  a.k = k;
  a.h = h;
  a.w = w;
  a.g_proj = g_proj;
  a.grouped = grouped;
  a.th = th;
  a.pc = pc;
  a.ys_cap = ys_cap;
  a.dmax = 0;
  for (int i = 0; i < MAX_K; ++i) {
    a.dil[i] = i < k ? dil[i] : 0;
    if (i < k && dil[i] > a.dmax) a.dmax = dil[i];
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (b > 0 && h > 0 && w > 0) {
    const int e = dtype == MSPL_BF16 ? launch_typed<__nv_bfloat16>(a, st)
                                     : launch_typed<float>(a, st);
    if (e) return e;
  }
  return (int)cudaGetLastError();
}
