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
//
// Stride 1 (eesp_stack_kernel, the `use_pallas` route's kernel): whole planes a
// block.  A plane is one proj channel of one image (32x60 at level3, 16x30 at
// level4 on the main path); a block of 128 threads takes `pb` whole planes (1
// at level3, 2 at level4: ~120 runs a block), or, for a plane too large for
// shared memory, a band of its rows.  It stages each plane once into
// zero-padded f32 rows of shared memory with 16-byte loads (the planes start on
// 16-byte words whenever H*W*size is a multiple of 16; else element by element)
// and 16- or 8-byte shared stores, zeroing only the pads beside them, so no
// input element is read twice and one barrier stands between the loads and the
// arithmetic.  Each thread takes a run of 8 outputs down one column: for each
// column offset dx in {0, +-d} it loads the column window the run's taps read
// (8 + 2*reach values, lanes on consecutive columns, so every shared load is
// one conflict-free wavefront) and adds its taps into the K branches' sums in
// registers: 120 shared loads for 32 outputs at (1,2,3,4), against 36 an output
// in the tiled design below.  A warp stores 32 consecutive outputs of a row per
// instruction (64 contiguous bytes in bf16).  The taps come packed by the host
// as [n, K*9] f32 (one 144-byte read a plane, cached per unit by the route,
// ops/eesp_branches.py pack_taps).  The model's two schedules, (1,2,3,4) and
// (1,1,2,3) with K = 4, are template instances whose offsets unroll; every
// other K <= 8 and dilation set runs the run-time-dilation instance of the same
// kernel, which reads its taps' values straight from shared memory.  The launch
// plan (planes a block, band rows, shared bytes) is the wrapper's `stack_plan`,
// checked on the CPU.  On the H100 the route's 30 calls of a batch take ~2.2 ms
// (2.4x the bound, against 5.0 tiled; tools/torch_route_kernels.py, PERF.md).
// Slower in trials there: persistent blocks that fetch the next planes with
// cp.async while computing (128 registers, 3.2 ms), 16-row runs (145-189
// registers, 3.9 ms), 256-thread blocks (2.6 ms).  Trial builds that leave out
// the loads, the tap arithmetic or the stores save 0.4, 0.4 and 0.1 ms of the
// 2.2: the rest is each block's fixed work and the instructions a run issues
// (~750 by a count of this source, 288 of them the taps' FMAs).
//
// Stride 2 (branches_kernel<T, 2>, the DownSampler front; on no route): the
// port's first design, kept until its own redesign (the next kernel in line),
// and the stride-1 stack's until the whole-plane kernel above. One block per
// (plane, 16x32 output tile); a plane is one channel of one image, either a
// proj channel (the K branches) or a channel of x (the pool).  The block stages
// the input region its tile reads, halo of max(d) (or 1 for the pool) included,
// in shared memory as f32, zero outside the image, so every tap of every
// dilation is a shared-memory read and the input plane is read from device
// memory about once.  Each thread owns one output column of two rows (in a
// trial on the H100, 16x32 tiles beat 8x32 and matched 32x32): it accumulates
// the 9 taps of each branch and the HFF running sum in f32 and rounds each of
// its K outputs once; a warp writes 32 consecutive pixels of one row.  The
// arguments are __grid_constant__: the dilations are indexed at run time, which
// otherwise copies the whole argument block to local memory in every thread
// (2.4x slower, PERF.md).
//
// Deliberate difference: the TPU kernel of the stride-1 stack multiplies in
// the input dtype (bf16 on the main path); these compute in f32 and round
// once, as does the plain version beside them (ops/eesp_branches.py).
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

// The DownSampler front (stride 2): x [B, nin, H, W] pooled beside the
// branch stack of proj [B, n, H, W]; taps [K, 3, 3, n].
extern "C" int eesp_branches_launch(
    const void* proj, const void* x, void* out, void* pool, const float* taps,
    int dtype, int b, int n, int nin, int h, int w, int k, const int* dil,
    void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  BranchArgs a;
  a.proj = proj;
  a.x = x;
  a.out = out;
  a.pool = pool;
  a.taps = taps;
  a.b = b;
  a.n = n;
  a.nin = nin;
  a.h = h;
  a.w = w;
  a.ho = (h - 1) / 2 + 1;
  a.wo = (w - 1) / 2 + 1;
  a.k = k;
  a.dmax = 0;
  for (int i = 0; i < MAX_K; ++i) {
    a.dil[i] = i < k ? dil[i] : 0;
    if (i < k && dil[i] > a.dmax) a.dmax = dil[i];
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if ((int64_t)b * (n + a.nin) > 0 && h > 0 && w > 0) {
    if (dtype == MSPL_BF16) launch_typed<__nv_bfloat16, 2>(a, st);
    else launch_typed<float, 2>(a, st);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Stride 1: whole planes a block, 8-output column runs
// ---------------------------------------------------------------------------

#define ST_NT 128   // threads a block
#define ST_RUN 8    // outputs of a column a thread
#define SCHED_RUNTIME 2

struct StackArgs {
  const void* proj;    // [B, n, H, W]
  void* out;           // [B, K*n, H, W]
  const float* taps;   // [n, K*9]: channel c's taps k*9 + ky*3 + kx
  int b, n, h, w, k;
  int dil[MAX_K];
  int dmax;
  int lpad, sw, rows;  // a plane in shared memory: rows of sw floats, image
                       // row y0 + r - dmax at row r, column x at lpad + x
  int pb, bh;          // planes a block, output rows a band
  int vec;             // stage with 16-byte loads
};

// The model's two dilation schedules, K = 4.
template <int SCHED>
struct Sched;
template <>
struct Sched<0> {  // (1, 2, 3, 4): level3 at r_lim 9
  static constexpr int K = 4, DMAX = 4;
  __device__ static constexpr int d(int k) { return k + 1; }
};
template <>
struct Sched<1> {  // (1, 1, 2, 3): level4 at r_lim 7
  static constexpr int K = 4, DMAX = 3;
  __device__ static constexpr int d(int k) { return k < 2 ? 1 : k; }
};

template <int SCHED>
__device__ constexpr bool reads_column(int k, int dx) {
  return dx == 0 || Sched<SCHED>::d(k) == dx || Sched<SCHED>::d(k) == -dx;
}

// One run at a fixed schedule: col points at the run's first output in
// shared memory; the K branches' running HFF sums go to dst + k*kstride,
// rows i < nv.
template <typename T, int SCHED>
__device__ __forceinline__ void run_fixed(const float* col, int sw,
                                          const float* tp, T* dst,
                                          int64_t kstride, int w, int nv) {
  using S = Sched<SCHED>;
  constexpr int K = S::K, DM = S::DMAX, R = ST_RUN;
  float acc[K][R];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[k][i] = 0.f;
#pragma unroll
  for (int dx = -DM; dx <= DM; ++dx) {
    int reach = -1;  // rows above and below the run that column dx needs
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (reads_column<SCHED>(k, dx) && S::d(k) > reach) reach = S::d(k);
    if (reach < 0) continue;
    float win[R + 2 * DM];
#pragma unroll
    for (int r = 0; r < R + 2 * DM; ++r)
      if (r >= DM - reach && r < DM + R + reach)
        win[r] = col[(r - DM) * sw + dx];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!reads_column<SCHED>(k, dx)) continue;
      const int d = S::d(k);
      const int kx = dx == 0 ? 1 : (dx < 0 ? 0 : 2);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float t = tp[k * 9 + ky * 3 + kx];
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[k][i] = fmaf(t, win[DM + i + (ky - 1) * d], acc[k][i]);
      }
    }
  }
  float hff[R];
#pragma unroll
  for (int i = 0; i < R; ++i) hff[i] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      hff[i] += acc[k][i];
      if (i < nv) dst[k * kstride + (int64_t)i * w] = from_f32<T>(hff[i]);
    }
}

// One run at run-time dilations (any K <= MAX_K): each tap's column read
// from shared memory as it is used.
template <typename T>
__device__ __forceinline__ void run_runtime(const StackArgs& a,
                                            const float* col,
                                            const float* tp, T* dst,
                                            int64_t kstride, int nv) {
  constexpr int R = ST_RUN;
  float hff[R];
#pragma unroll
  for (int i = 0; i < R; ++i) hff[i] = 0.f;
  for (int k = 0; k < a.k; ++k) {
    const int d = a.dil[k];
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float t = tp[k * 9 + ky * 3 + kx];
        const float* s = col + (ky - 1) * d * a.sw + (kx - 1) * d;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = fmaf(t, s[i * a.sw], acc[i]);
      }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      hff[i] += acc[i];
      if (i < nv) dst[k * kstride + (int64_t)i * a.w] = from_f32<T>(hff[i]);
    }
  }
}

// 16 bytes of T as f32.
__device__ __forceinline__ void unpack16(uint4 raw, float v[8],
                                         const __nv_bfloat16*) {
  const unsigned int u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(u[q] << 16);
    v[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(uint4 raw, float v[4],
                                         const float*) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

// grid (groups of pb planes, bands of bh rows), block ST_NT.
template <typename T, int SCHED>
__global__ void __launch_bounds__(ST_NT)
eesp_stack_kernel(const __grid_constant__ StackArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int k9 = a.k * 9;
  float* s_taps = smem;
  float* s_in = smem + ((a.pb * k9 + 3) & ~3);
  const int plane_f = a.rows * a.sw;  // floats a plane, a multiple of 4
  const int p0 = blockIdx.x * a.pb;   // planes < 2^31 (the launch checks)
  const int np = min(a.pb, a.b * a.n - p0);
  const int y0 = blockIdx.y * a.bh, y1 = min(a.h, y0 + a.bh);
  const int hw = a.h * a.w;           // a plane fits shared memory
  const int fa = max(0, y0 - a.dmax) * a.w;  // the rows staged
  const int fb = min(a.h, y1 + a.dmax) * a.w;

  for (int i = threadIdx.x; i < np * k9; i += ST_NT) {
    const int pp = i / k9;
    s_taps[i] = a.taps[(p0 + pp) % a.n * k9 + (i - pp * k9)];
  }
  const int row0 = a.dmax - y0;  // shared row of image row y: y + row0
  {
    // Zero the pads: the rows not staged, and the columns beside the image
    // in the staged ones.  The staging writes every other value, so no
    // barrier stands between the two.
    const int ra = fa / a.w + row0, rb = fb / a.w + row0;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < np * a.rows; i += ST_NT) {
      float* row = s_in + i * a.sw;  // the planes' rows are contiguous
      const int r = i % a.rows;
      float4* r4 = reinterpret_cast<float4*>(row);
      if (r < ra || r >= rb) {
        for (int q = 0; q < a.sw / 4; ++q) r4[q] = z;
      } else {
        for (int q = 0; q < a.lpad / 4; ++q) r4[q] = z;
        for (int q = a.lpad + a.w; q < a.sw; ++q) row[q] = 0.f;
      }
    }
  }

  const T* src = reinterpret_cast<const T*>(a.proj) + (int64_t)p0 * hw;
  if (a.vec) {
    constexpr int V = 16 / sizeof(T);
    const int ca = fa / V * V;  // the planes start on 16-byte words
    const int nch = (fb - ca + V - 1) / V;
    // values a shared store: 4 where every row starts on a 16-byte word
    // of shared memory (W a multiple of 4), 2 where on an 8-byte one
    const int g = (a.w & 3) == 0 ? 4 : ((a.w & 1) == 0 ? 2 : 1);
    for (int i = threadIdx.x; i < np * nch; i += ST_NT) {
      const int pp = i / nch;
      const int f = ca + (i - pp * nch) * V;
      float v[V];
      unpack16(__ldg(reinterpret_cast<const uint4*>(
                   src + (int64_t)pp * hw + f)), v, src);
      int y = f / a.w, x = f - y * a.w;
      float* dp = s_in + pp * plane_f + a.lpad;
      if (g == 4) {
#pragma unroll
        for (int j = 0; j < V; j += 4) {  // a group lies in one row
          if (f + j >= fa && f + j < fb)
            *reinterpret_cast<float4*>(dp + (y + row0) * a.sw + x) =
                make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
          if ((x += 4) >= a.w) {
            x -= a.w;
            ++y;
          }
        }
      } else if (g == 2) {
#pragma unroll
        for (int j = 0; j < V; j += 2) {
          if (f + j >= fa && f + j < fb)
            *reinterpret_cast<float2*>(dp + (y + row0) * a.sw + x) =
                make_float2(v[j], v[j + 1]);
          if ((x += 2) >= a.w) {
            x -= a.w;
            ++y;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (f + j >= fa && f + j < fb) dp[(y + row0) * a.sw + x] = v[j];
          if (++x == a.w) {
            x = 0;
            ++y;
          }
        }
      }
    }
  } else {
    const int n_el = fb - fa;
    for (int i = threadIdx.x; i < np * n_el; i += ST_NT) {
      const int pp = i / n_el;
      const int f = fa + (i - pp * n_el);
      const int y = f / a.w, x = f - y * a.w;
      s_in[pp * plane_f + (y + row0) * a.sw + a.lpad + x] =
          to_f32(src[(int64_t)pp * hw + f]);
    }
  }
  __syncthreads();

  const int nry = (y1 - y0 + ST_RUN - 1) / ST_RUN;  // runs down a column
  const int upp = nry * a.w;                         // runs a plane
  const int64_t kstride = (int64_t)a.n * hw;  // one branch's channels
  for (int u = threadIdx.x; u < np * upp; u += ST_NT) {
    const int pp = u / upp, r = u - pp * upp;
    const int ry = r / a.w, x = r - ry * a.w;
    const int yo = y0 + ry * ST_RUN;
    const int nv = min(ST_RUN, y1 - yo);
    const float* col = s_in + pp * plane_f + (yo + row0) * a.sw + a.lpad + x;
    const float* tp = s_taps + pp * k9;
    const int plane = p0 + pp, bi = plane / a.n;
    T* dst = reinterpret_cast<T*>(a.out) +
             ((int64_t)bi * a.k * a.n + (plane - bi * a.n)) * hw + yo * a.w +
             x;
    if constexpr (SCHED == SCHED_RUNTIME)
      run_runtime<T>(a, col, tp, dst, kstride, nv);
    else
      run_fixed<T, SCHED>(col, a.sw, tp, dst, kstride, a.w, nv);
  }
}

template <typename T, int SCHED>
static int launch_stack(const StackArgs& a, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        eesp_stack_kernel<T, SCHED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t groups = ((int64_t)a.b * a.n + a.pb - 1) / a.pb;
  const dim3 grid((unsigned int)groups, (a.h + a.bh - 1) / a.bh);
  eesp_stack_kernel<T, SCHED><<<grid, ST_NT, smem, st>>>(a);
  return 0;
}

// The stride-1 stack: proj [B, n, H, W] -> out [B, K*n, H, W], taps packed
// [n, K*9] f32; dilations dil[0..k).  sched: 0 for (1,2,3,4), 1 for
// (1,1,2,3), 2 (run-time dilations) for any other; pb, bh, lpad, sw, rows,
// vec and smem (bytes) from the wrapper's plan (ops/eesp_branches.py
// stack_plan), checked here against the same formulas.
extern "C" int eesp_stack_launch(
    const void* proj, void* out, const float* taps, int dtype, int b, int n,
    int h, int w, int k, const int* dil, int sched, int pb, int bh, int lpad,
    int sw, int rows, int vec, int smem, void* stream) {
  if (k < 1 || k > MAX_K || sched < 0 || sched > SCHED_RUNTIME || pb < 1 ||
      bh < 1 || b < 1 || n < 1 || h <= 0 || w <= 0 ||
      (int64_t)b * n > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  StackArgs a;
  a.proj = proj;
  a.out = out;
  a.taps = taps;
  a.b = b;
  a.n = n;
  a.h = h;
  a.w = w;
  a.k = k;
  a.dmax = 0;
  for (int i = 0; i < MAX_K; ++i) {
    a.dil[i] = i < k ? dil[i] : 0;
    if (i < k && (dil[i] < 1)) return (int)cudaErrorInvalidValue;
    if (i < k && dil[i] > a.dmax) a.dmax = dil[i];
  }
  const int fixed[2][4] = {{1, 2, 3, 4}, {1, 1, 2, 3}};
  if (sched < SCHED_RUNTIME) {
    if (k != 4) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 4; ++i)
      if (dil[i] != fixed[sched][i]) return (int)cudaErrorInvalidValue;
  }
  a.lpad = lpad;
  a.sw = sw;
  a.rows = rows;
  a.pb = pb;
  a.bh = bh;
  a.vec = vec;
  const int runs_down = (bh + ST_RUN - 1) / ST_RUN;
  const int64_t want = 4 * (((int64_t)pb * k * 9 + 3) / 4 * 4 +
                            (int64_t)pb * rows * sw);
  if (lpad < a.dmax || lpad % 4 || sw % 4 || sw < lpad + w + a.dmax ||
      rows != runs_down * ST_RUN + 2 * a.dmax || smem != want ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int err;
  if (dtype == MSPL_BF16) {
    if (sched == 0) err = launch_stack<__nv_bfloat16, 0>(a, smem, st);
    else if (sched == 1) err = launch_stack<__nv_bfloat16, 1>(a, smem, st);
    else err = launch_stack<__nv_bfloat16, SCHED_RUNTIME>(a, smem, st);
  } else {
    if (sched == 0) err = launch_stack<float, 0>(a, smem, st);
    else if (sched == 1) err = launch_stack<float, 1>(a, smem, st);
    else err = launch_stack<float, SCHED_RUNTIME>(a, smem, st);
  }
  return err ? err : (int)cudaGetLastError();
}
