// EESP branch stacks: K dilated depthwise 3x3 branches with hierarchical
// feature fusion, stride 1 (an EESP unit) or stride 2 (a DownSampler front,
// with the 3x3/s2 average pool of the block input beside it).  The stride-1
// kernel is described first; the stride-2 pair follows it in this file.
//
// Replaces the Pallas kernels
//   * mspl_tpu/ops/pallas_eesp.py::eesp_branches_pallas (stride 1): out
//     channel ki*n + c = sum_{j <= ki} dwconv_{d_j}(proj)[c], padding = d_j;
//   * mspl_tpu/ops/pallas_downsampler.py::down_front_pallas (stride 2): the
//     same branch stack at stride 2 (output (H-1)//2+1) and AvgPool2d(3, 2,
//     padding 1, count_include_pad=True) of the block input x.
//
// Bound: bytes.  Each output element costs 19 flops (9 multiply-adds and one
// HFF add), while K outputs are written for every input read (K/4 at
// stride 2): at the main path's shapes the stride-1 stack moves ~0.16 GB
// per level3 call and needs ~1.2 GFLOP, ~6x under the card's flop/byte
// balance in f32.
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
// in the 16x32-tile design it replaced.  A warp stores 32 consecutive outputs
// of a row per instruction (64 contiguous bytes in bf16).  The taps come packed by the host
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
// Stride 2 (the DownSampler front, on no route, as in the JAX package): two
// kernels launched by one C entry, down_front_launch.  Bound: bytes; at the
// main path's 9 calls a batch (bf16, batch 128) the pool moves 2.36 GB (x
// read once, the pool written once) and the branch stack 1.70 GB, 1.21 ms
// at 3.35 TB/s in all.
//  * front_stack_kernel, the K strided branches with HFF: ⑤'s whole-plane
//    design at stride 2.  A block of 128 threads stages a plane (or, where a
//    plane passes the plan's 32 KB, a band of output rows: level1's 128x240
//    planes in bands of 8, which beat 48 KB bands of 16 by 6% on the H100)
//    once into zero-padded f32 rows of shared memory with 16-byte loads,
//    the even image columns in one half of a row and the odd ones in the
//    other: output column ox reads image column 2*ox + dx at word
//    lpad + ox + (dx >> 1) of half (dx & 1), so lanes on consecutive output
//    columns read consecutive words (no 2-way bank conflict of a stride-2
//    read).  Each thread sums a run of 4 outputs down one output column for
//    all K branches, reading image rows 2*oy + (ky - 1)*d: per column offset
//    a window of 2*4 - 1 + 2*reach values in registers.  The schedule
//    (1,2,3,4) is a template instance whose offsets unroll (56 registers;
//    runs of 8 took 134 and read 1.60 ms against 1.26 for the 9 calls); any
//    other K <= 8 runs the run-time-dilation instance.  Taps come packed
//    [n, K*9] f32, as ⑤'s.
//  * front_pool_kernel, the 3x3/s2 average pool (count_include_pad): a
//    streaming pass with no shared memory.  A thread takes a strip of 8
//    input columns (4 where W is a multiple of 4 but not of 8: level3's 60
//    columns would otherwise cut a strip in each row) and walks down 16
//    output rows, reading each input row once with 16- or 8-byte loads,
//    keeping the shared odd row's horizontal sums in registers and taking
//    its left neighbour column from the lane before by a shuffle; it stores
//    its outputs with one vector store where Wo allows, element by element
//    at the tails.
// Both compute in f32 and round each output once, as the plain version
// does.  On the H100 the 9 calls take ~2.3-2.4 ms (PR 2's 16x32-tile kernel:
// 4.76), ~1.25 of it the stack and ~1.08 the pool (tools/
// torch_route_kernels.py, PERF.md).  The launch plan (bands, planes a
// block, shared bytes, vector staging, the pool's strips, loads and
// stores) is the wrapper's `front_plan`, checked on the CPU and again by
// the C entry.
//
// Deliberate difference: the TPU kernel of the stride-1 stack multiplies in
// the input dtype (bf16 on the main path); these compute in f32 and round
// once, as does the plain version beside them (ops/eesp_branches.py).
#include "common.cuh"

#define MAX_K 8

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

// ---------------------------------------------------------------------------
// Stride 2: the DownSampler front.  Two kernels, launched one after the
// other by one C entry: the branch stack (whole planes a block, 8-output
// column runs over de-interleaved columns) and the 3x3/s2 average pool (a
// streaming pass, no shared memory).
// ---------------------------------------------------------------------------

#define FR_NT 128   // branch-stack threads a block
#define FR_RUN 4    // outputs of a column a thread
#define FR_RUNTIME 1
#define FP_NT 256   // pool threads a block
#define FP_SEG 16   // pool output rows a thread walks down

struct FrontArgs {
  const void* proj;    // [B, n, H, W]
  void* out;           // [B, K*n, Ho, Wo]
  const float* taps;   // [n, K*9]: channel c's taps k*9 + ky*3 + kx
  int b, n, h, w, ho, wo, k;
  int dil[MAX_K];
  int dmax;
  int lpad, half, rows;  // a plane in shared memory: rows of 2 * half
                         // floats, image row 2 * oy0 - dmax + r at row r;
                         // even column 2i at lpad + i, odd column 2i + 1 at
                         // half + lpad + i
  int pb, bh, nbands;    // planes a block, output rows a band, bands a plane
  int vec;               // stage with 16-byte loads
};

// The front's one templated schedule: (1, 2, 3, 4), K = 4.
__device__ constexpr int front_d(int k) { return k + 1; }
__device__ constexpr bool front_reads(int k, int dx) {
  return dx == 0 || front_d(k) == dx || front_d(k) == -dx;
}

// One run at (1, 2, 3, 4): cen points at the shared even-half word of the
// run's first output (image row 2*yo, column 2*ox); the K branches' running
// HFF sums go to dst + k*kstride, rows i < nv.  Output i reads image rows
// 2*(yo + i) + (ky - 1)*d: a column offset's window holds 2*R - 1 + 2*reach
// rows, and lanes on consecutive output columns read consecutive words of
// one half.
template <typename T>
__device__ __forceinline__ void front_run_fixed(const float* cen, int sw,
                                                int half, const float* tp,
                                                T* dst, int64_t kstride,
                                                int wo, int nv) {
  constexpr int K = 4, DM = 4, R = FR_RUN, NW = 2 * R - 1 + 2 * DM;
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
      if (front_reads(k, dx) && front_d(k) > reach) reach = front_d(k);
    if (reach < 0) continue;
    // image column 2*ox + dx: even dx in the even half, odd in the odd one
    const float* col = cen + ((dx & 1) ? half : 0) + (dx >> 1);
    float win[NW];
#pragma unroll
    for (int r = 0; r < NW; ++r)
      if (r >= DM - reach && r < DM + 2 * R - 1 + reach)
        win[r] = col[(r - DM) * sw];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!front_reads(k, dx)) continue;
      const int d = front_d(k);
      const int kx = dx == 0 ? 1 : (dx < 0 ? 0 : 2);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float t = tp[k * 9 + ky * 3 + kx];
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[k][i] = fmaf(t, win[DM + 2 * i + (ky - 1) * d], acc[k][i]);
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
      if (i < nv) dst[k * kstride + (int64_t)i * wo] = from_f32<T>(hff[i]);
    }
}

// One run at run-time dilations (any K <= MAX_K): each tap read from
// shared memory as it is used.
template <typename T>
__device__ __forceinline__ void front_run_runtime(const FrontArgs& a,
                                                  const float* cen, int sw,
                                                  const float* tp, T* dst,
                                                  int64_t kstride, int nv) {
  constexpr int R = FR_RUN;
  float hff[R];
#pragma unroll
  for (int i = 0; i < R; ++i) hff[i] = 0.f;
  for (int k = 0; k < a.k; ++k) {
    const int d = a.dil[k];
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int dx = (kx - 1) * d;
      const float* col = cen + ((dx & 1) ? a.half : 0) + (dx >> 1);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float t = tp[k * 9 + ky * 3 + kx];
        const float* s = col + (ky - 1) * d * sw;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = fmaf(t, s[2 * i * sw], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      hff[i] += acc[i];
      if (i < nv) dst[k * kstride + (int64_t)i * a.wo] = from_f32<T>(hff[i]);
    }
  }
}

// G values from image column x (even when G > 1) of one row into the
// de-interleaved shared row `row`: evens at lpad + x/2.., odds at half +
// lpad + x/2...
template <int G>
__device__ __forceinline__ void stage_group(float* row, int lpad, int half,
                                            int x, const float* v) {
  float* ev = row + lpad + (x >> 1);
  float* od = row + half + lpad + (x >> 1);
  if constexpr (G == 8) {
    *reinterpret_cast<float4*>(ev) = make_float4(v[0], v[2], v[4], v[6]);
    *reinterpret_cast<float4*>(od) = make_float4(v[1], v[3], v[5], v[7]);
  } else if constexpr (G == 4) {
    *reinterpret_cast<float2*>(ev) = make_float2(v[0], v[2]);
    *reinterpret_cast<float2*>(od) = make_float2(v[1], v[3]);
  } else if constexpr (G == 2) {
    ev[0] = v[0];
    od[0] = v[1];
  } else {
    ((x & 1) ? od : ev)[0] = v[0];
  }
}

// The V values of one 16-byte load at flat offset f (image row y, column
// x) into shared memory, G at a time (G values lie in one image row), those
// inside the staged range [fa, fb).
template <int V, int G>
__device__ __forceinline__ void stage_load(float* dp, int sw, int lpad,
                                           int half, int row0, int w, int f,
                                           int fa, int fb, const float* v) {
  int y = f / w, x = f - y * w;
#pragma unroll
  for (int j = 0; j < V; j += G) {
    if (f + j >= fa && f + j < fb)
      stage_group<G>(dp + (y + row0) * sw, lpad, half, x, v + j);
    if ((x += G) >= w) {
      x -= w;
      ++y;
    }
  }
}

// grid (groups of pb planes) x (bands), band fastest; block FR_NT.
template <typename T, int SCHED>
__global__ void __launch_bounds__(FR_NT)
front_stack_kernel(const __grid_constant__ FrontArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int k9 = a.k * 9, sw = 2 * a.half;
  float* s_taps = smem;
  float* s_in = smem + ((a.pb * k9 + 3) & ~3);
  const int plane_f = a.rows * sw;  // floats a plane, a multiple of 8
  const int grp = blockIdx.x / a.nbands, band = blockIdx.x - grp * a.nbands;
  const int p0 = grp * a.pb;        // planes < 2^31 (the launch checks)
  const int np = min(a.pb, a.b * a.n - p0);
  const int oy0 = band * a.bh, oy1 = min(a.ho, oy0 + a.bh);
  const int hw = a.h * a.w;         // a band fits shared memory
  // the image rows staged: those the band's taps read
  const int fa = max(0, 2 * oy0 - a.dmax) * a.w;
  const int fb = min(a.h, 2 * oy1 - 1 + a.dmax) * a.w;
  const int row0 = a.dmax - 2 * oy0;  // shared row of image row y: y + row0

  for (int i = threadIdx.x; i < np * k9; i += FR_NT) {
    const int pp = i / k9;
    s_taps[i] = a.taps[(p0 + pp) % a.n * k9 + (i - pp * k9)];
  }
  {
    // Zero the pads: the rows not staged, and in the staged ones the
    // columns of each half beside the image's.  The staging writes every
    // other value, so no barrier stands between the two.
    const int ra = fa / a.w + row0, rb = fb / a.w + row0;
    const int ne = (a.w + 1) >> 1, no = a.w >> 1;  // even, odd columns
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < np * a.rows; i += FR_NT) {
      float* row = s_in + i * sw;  // the planes' rows are contiguous
      const int r = i % a.rows;
      float4* r4 = reinterpret_cast<float4*>(row);
      if (r < ra || r >= rb) {
        for (int q = 0; q < sw / 4; ++q) r4[q] = z;
      } else {
        for (int q = 0; q < a.lpad / 4; ++q) {
          r4[q] = z;
          r4[(a.half >> 2) + q] = z;
        }
        for (int q = a.lpad + ne; q < a.half; ++q) row[q] = 0.f;
        for (int q = a.lpad + no; q < a.half; ++q) row[a.half + q] = 0.f;
      }
    }
  }

  const T* src = reinterpret_cast<const T*>(a.proj) + (int64_t)p0 * hw;
  if (a.vec) {
    constexpr int V = 16 / sizeof(T);
    const int ca = fa / V * V;  // the planes start on 16-byte words
    const int nch = (fb - ca + V - 1) / V;
    // values of a load that lie in one image row: W's largest power-of-2
    // divisor up to V (a group then starts on an even column)
    const int g = (a.w % V) == 0 ? V : ((a.w & 3) == 0 ? 4
                                        : ((a.w & 1) == 0 ? 2 : 1));
    for (int i = threadIdx.x; i < np * nch; i += FR_NT) {
      const int pp = i / nch;
      const int f = ca + (i - pp * nch) * V;
      float v[V];
      unpack16(__ldg(reinterpret_cast<const uint4*>(
                   src + (int64_t)pp * hw + f)), v, src);
      float* dp = s_in + pp * plane_f;
      if (g == V)
        stage_load<V, V>(dp, sw, a.lpad, a.half, row0, a.w, f, fa, fb, v);
      else if (g == 4)
        stage_load<V, 4>(dp, sw, a.lpad, a.half, row0, a.w, f, fa, fb, v);
      else if (g == 2)
        stage_load<V, 2>(dp, sw, a.lpad, a.half, row0, a.w, f, fa, fb, v);
      else
        stage_load<V, 1>(dp, sw, a.lpad, a.half, row0, a.w, f, fa, fb, v);
    }
  } else {
    const int n_el = fb - fa;
    for (int i = threadIdx.x; i < np * n_el; i += FR_NT) {
      const int pp = i / n_el;
      const int f = fa + (i - pp * n_el);
      const int y = f / a.w, x = f - y * a.w;
      s_in[pp * plane_f + (y + row0) * sw + ((x & 1) ? a.half : 0) + a.lpad +
           (x >> 1)] = to_f32(src[(int64_t)pp * hw + f]);
    }
  }
  __syncthreads();

  const int nry = (oy1 - oy0 + FR_RUN - 1) / FR_RUN;  // runs down a column
  const int upp = nry * a.wo;                          // runs a plane
  const int64_t ohw = (int64_t)a.ho * a.wo;
  const int64_t kstride = (int64_t)a.n * ohw;  // one branch's channels
  for (int u = threadIdx.x; u < np * upp; u += FR_NT) {
    const int pp = u / upp, r = u - pp * upp;
    const int ry = r / a.wo, ox = r - ry * a.wo;
    const int yo = oy0 + ry * FR_RUN;
    const int nv = min(FR_RUN, oy1 - yo);
    const float* cen =
        s_in + pp * plane_f + (2 * yo + row0) * sw + a.lpad + ox;
    const float* tp = s_taps + pp * k9;
    const int plane = p0 + pp, bi = plane / a.n;
    T* dst = reinterpret_cast<T*>(a.out) +
             ((int64_t)bi * a.k * a.n + (plane - bi * a.n)) * ohw +
             (int64_t)yo * a.wo + ox;
    if constexpr (SCHED == FR_RUNTIME)
      front_run_runtime<T>(a, cen, sw, tp, dst, kstride, nv);
    else
      front_run_fixed<T>(cen, sw, a.half, tp, dst, kstride, a.wo, nv);
  }
}

struct PoolArgs {
  const void* x;   // [B, nin, H, W]
  void* pool;      // [B, nin, Ho, Wo]
  int64_t planes;  // B * nin
  int h, w, ho, wo;
  int nstrips;     // strips of SC input columns a row: ceil(W / SC)
  int nseg;        // segments of FP_SEG output rows a plane
  int lb;          // bytes a load: 16 or 8, or 0 (element by element)
  int sg;          // outputs a store: 4, 2 or 1
};

// 8 bytes of T as f32.
__device__ __forceinline__ void unpack8(uint2 raw, float v[4],
                                        const __nv_bfloat16*) {
  v[0] = __uint_as_float(raw.x << 16);
  v[1] = __uint_as_float(raw.x & 0xffff0000u);
  v[2] = __uint_as_float(raw.y << 16);
  v[3] = __uint_as_float(raw.y & 0xffff0000u);
}
__device__ __forceinline__ void unpack8(uint2 raw, float v[2],
                                        const float*) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
}

// Columns x0 .. x0+SC-1 of an image row as f32, 0 past the row's end or
// where !ok: 16- or 8-byte loads for a whole strip where the rows start on
// such words (lb), else element by element.
template <typename T, int SC>
__device__ __forceinline__ void load_strip(const T* row, int x0, int w,
                                           int lb, bool ok, float v[SC]) {
  constexpr int BYTES = SC * sizeof(T);
  if (BYTES >= 16 && ok && lb == 16 && x0 + SC <= w) {
    if constexpr (BYTES >= 16) {
      constexpr int V = 16 / sizeof(T);
#pragma unroll
      for (int q = 0; q < SC / V; ++q)
        unpack16(__ldg(reinterpret_cast<const uint4*>(row + x0) + q),
                 v + q * V, row);
    }
  } else if (ok && lb == 8 && x0 + SC <= w) {
    constexpr int V = 8 / sizeof(T);
#pragma unroll
    for (int q = 0; q < SC / V; ++q)
      unpack8(__ldg(reinterpret_cast<const uint2*>(row + x0) + q), v + q * V,
              row);
  } else {
#pragma unroll
    for (int j = 0; j < SC; ++j)
      v[j] = ok && x0 + j < w ? to_f32(row[x0 + j]) : 0.f;
  }
}

// Outputs o[0..g) to d, one store of g values.
__device__ __forceinline__ void store_group(float* d, const float* o, int g) {
  if (g == 4) *reinterpret_cast<float4*>(d) = make_float4(o[0], o[1], o[2], o[3]);
  else *reinterpret_cast<float2*>(d) = make_float2(o[0], o[1]);
}
__device__ __forceinline__ void store_group(__nv_bfloat16* d, const float* o,
                                            int g) {
  const unsigned int lo =
      __bfloat16_as_ushort(__float2bfloat16_rn(o[0])) |
      (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(o[1])) << 16;
  if (g == 4) {
    const unsigned int hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(o[2])) |
        (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(o[3])) << 16;
    *reinterpret_cast<uint2*>(d) = make_uint2(lo, hi);
  } else {
    *reinterpret_cast<unsigned int*>(d) = lo;
  }
}

// A thread takes a strip of SC input columns (SC/2 outputs; 8, or 4 where
// W is a multiple of 4 but not of 8, so no strip of a row is cut) and walks
// down FP_SEG output rows: each input row is read once (the odd row that
// two outputs share is kept as its horizontal sums), its left neighbour
// column comes from the lane before by a shuffle.  Lanes take consecutive
// strips of one row, so a warp's load reads contiguous bytes.  Every lane
// runs the same FP_SEG steps (the shuffle needs the whole warp); steps
// past the plane's rows and lanes past the last plane store nothing.
template <typename T, int SC>
__global__ void __launch_bounds__(FP_NT)
front_pool_kernel(const __grid_constant__ PoolArgs a) {
  constexpr int NO = SC / 2;  // outputs a strip
  const int64_t t = (int64_t)blockIdx.x * FP_NT + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int s = (int)(t % a.nstrips);
  const int64_t rest = t / a.nstrips;
  const int seg = (int)(rest % a.nseg);
  const int64_t plane = rest / a.nseg;
  const bool live = plane < a.planes;
  const int x0 = SC * s, ox0 = NO * s;
  const T* src = reinterpret_cast<const T*>(a.x) +
                 (live ? plane : 0) * ((int64_t)a.h * a.w);
  T* dst = reinterpret_cast<T*>(a.pool) +
           (live ? plane : 0) * ((int64_t)a.ho * a.wo);

  // horizontal 3-sums of image row y at the strip's outputs: columns
  // 2*ox - 1, 2*ox, 2*ox + 1
  auto hsum = [&](int y, float h[NO]) {
    const bool ok = live && y >= 0 && y < a.h;
    const T* row = src + (int64_t)(ok ? y : 0) * a.w;
    float v[SC];
    load_strip<T, SC>(row, x0, a.w, a.lb, ok, v);
    float left = __shfl_up_sync(0xffffffffu, v[SC - 1], 1);
    if (lane == 0) left = ok && s > 0 ? to_f32(row[x0 - 1]) : 0.f;
    if (s == 0) left = 0.f;
    h[0] = left + v[0] + v[1];
#pragma unroll
    for (int j = 1; j < NO; ++j) h[j] = v[2 * j - 1] + v[2 * j] + v[2 * j + 1];
  };

  const int oy0 = seg * FP_SEG;
  float hp[NO];
  hsum(2 * oy0 - 1, hp);
#pragma unroll 2
  for (int i = 0; i < FP_SEG; ++i) {
    const int oy = oy0 + i;
    float h0[NO], h1[NO];
    hsum(2 * oy, h0);
    hsum(2 * oy + 1, h1);
    if (live && oy < a.ho) {
      float o[NO];
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] = (hp[j] + h0[j] + h1[j]) / 9.f;
      T* d = dst + (int64_t)oy * a.wo + ox0;
      if (ox0 + NO <= a.wo && a.sg > 1) {
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          if (a.sg == NO) {
            if (j == 0) store_group(d, o, NO);
          } else {
            store_group(d + j, o + j, 2);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NO; ++j)
          if (ox0 + j < a.wo) d[j] = from_f32<T>(o[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) hp[j] = h1[j];
  }
}

template <typename T>
static int launch_front_typed(const FrontArgs& f, const PoolArgs& p, int sched,
                              int smem, int pool_strip, cudaStream_t st) {
  if ((int64_t)f.b * f.n > 0) {
    auto kern = sched == 0 ? front_stack_kernel<T, 0>
                           : front_stack_kernel<T, FR_RUNTIME>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int64_t groups = ((int64_t)f.b * f.n + f.pb - 1) / f.pb;
    kern<<<(unsigned int)(groups * f.nbands), FR_NT, smem, st>>>(f);
  }
  if (p.planes > 0) {
    const int64_t threads = p.planes * p.nseg * p.nstrips;
    const unsigned int blocks = mspl_blocks(threads, FP_NT);
    if (pool_strip == 4) front_pool_kernel<T, 4><<<blocks, FP_NT, 0, st>>>(p);
    else front_pool_kernel<T, 8><<<blocks, FP_NT, 0, st>>>(p);
  }
  return 0;
}

// The DownSampler front: proj [B, n, H, W] -> out [B, K*n, Ho, Wo] (taps
// packed [n, K*9] f32, dilations dil[0..k)) and x [B, nin, H, W] -> pool
// [B, nin, Ho, Wo], Ho = (H-1)/2 + 1, Wo = (W-1)/2 + 1.  sched: 0 for
// (1,2,3,4), 1 (run-time dilations) for any other; pb, bh, lpad, half,
// rows, vec, smem, pool_strip, pool_load and pool_store from the wrapper's
// plan
// (ops/eesp_branches.py front_plan), checked here against the same
// formulas and the pointers' words.
extern "C" int down_front_launch(
    const void* proj, const void* x, void* out, void* pool, const float* taps,
    int dtype, int b, int n, int nin, int h, int w, int k, const int* dil,
    int sched, int pb, int bh, int lpad, int half, int rows, int vec,
    int smem, int pool_strip, int pool_load, int pool_store, void* stream) {
  if (k < 1 || k > MAX_K || sched < 0 || sched > FR_RUNTIME || pb < 1 ||
      bh < 1 || b < 1 || n < 1 || nin < 0 || h <= 0 || w <= 0 ||
      (int64_t)b * n > INT32_MAX || (int64_t)h * w > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  FrontArgs f;
  f.proj = proj;
  f.out = out;
  f.taps = taps;
  f.b = b;
  f.n = n;
  f.h = h;
  f.w = w;
  f.ho = (h - 1) / 2 + 1;
  f.wo = (w - 1) / 2 + 1;
  f.k = k;
  f.dmax = 0;
  for (int i = 0; i < MAX_K; ++i) {
    f.dil[i] = i < k ? dil[i] : 0;
    if (i < k && dil[i] < 1) return (int)cudaErrorInvalidValue;
    if (i < k && dil[i] > f.dmax) f.dmax = dil[i];
  }
  if (sched == 0) {
    if (k != 4) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 4; ++i)
      if (dil[i] != i + 1) return (int)cudaErrorInvalidValue;
  }
  f.lpad = lpad;
  f.half = half;
  f.rows = rows;
  f.pb = pb;
  f.bh = bh;
  f.nbands = (f.ho + bh - 1) / bh;
  f.vec = vec;
  const int reach = (f.dmax + 1) / 2;  // columns of a half beside the image
  const int runs_down = (bh + FR_RUN - 1) / FR_RUN;
  const int64_t want = 4 * (((int64_t)pb * k * 9 + 3) / 4 * 4 +
                            (int64_t)pb * rows * 2 * half);
  if (lpad < reach || lpad % 4 || half % 4 || half < lpad + f.wo + reach ||
      rows != 2 * runs_down * FR_RUN + 2 * f.dmax || smem != want ||
      smem > 227 * 1024 || (f.nbands > 1 && pb != 1))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == MSPL_BF16 ? 2 : 4;
  if (vec && ((uintptr_t)proj % 16 || ((int64_t)h * w * es) % 16))
    return (int)cudaErrorInvalidValue;
  PoolArgs p;
  p.x = x;
  p.pool = pool;
  p.planes = (int64_t)b * nin;
  p.h = h;
  p.w = w;
  p.ho = f.ho;
  p.wo = f.wo;
  p.nstrips = (w + pool_strip - 1) / max(pool_strip, 1);
  p.nseg = (f.ho + FP_SEG - 1) / FP_SEG;
  p.lb = pool_load;
  p.sg = pool_store;
  if ((pool_strip != 4 && pool_strip != 8) ||
      (pool_load != 0 && pool_load != 8 && pool_load != 16) ||
      pool_load > pool_strip * es ||
      (pool_load && ((uintptr_t)x % pool_load || (w * es) % pool_load)) ||
      (pool_store != 1 && pool_store != 2 && pool_store != 4) ||
      2 * pool_store > pool_strip || f.wo % pool_store ||
      (uintptr_t)pool % (pool_store * es))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int err = dtype == MSPL_BF16
                      ? launch_front_typed<__nv_bfloat16>(f, p, sched, smem,
                                                          pool_strip, st)
                      : launch_front_typed<float>(f, p, sched, smem,
                                                  pool_strip, st);
  return err ? err : (int)cudaGetLastError();
}
