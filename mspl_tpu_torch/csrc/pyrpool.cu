// Pyramid-pool decoder kernels: the five-scale branch stack, and the fused
// eval tail of the classifier stage.
//
// Replaces the Pallas kernels of mspl_tpu/ops/pallas_pyrpool.py:
//   * pyr_branches_pallas (_pyr_branches_impl / _pyr_branches_impl_v2): per
//     (image, channel, scale) resample the plane to the branch size (bilinear
//     up, align_corners=True, or adaptive-average down), depthwise 3x3 with
//     zero 'same' padding, resample back (bilinear); channel si*P + c of the
//     output;
//   * pyr_pool_fused_eval_v3 (and its v2/v1 fallbacks, one contract): the
//     same branch stack, then BN-affine + PReLU, channel shuffle, the grouped
//     3x3 merge with BN-affine + PReLU, and the 1x1 classifier with bias and
//     a last affine + PReLU, emitting channel-major logits.
//
// Both kernels apply each branch at source resolution.  For an identity or
// up scale the branch is exactly
//     branch = sum_{ey,ex} tap[ey,ex] * M_h[ey] @ x @ M_w[ex]^T
// with M[e] = back @ S_e @ to (S_e for the identity scale), S_e the shift
// by the tap offset e = -1, 0, 1 at branch resolution.  Each row of M[e] is
// non-zero on a short band at every offset together (3 or 4 at the main
// path's scales), so the branch value at (y, x) is a position-dependent
// K x K stencil on x:
//     v = sum_k sum_ey rw[y][ey][k] * sum_l B[ey][l] * x[rs[y]+k][cs[x]+l],
//     B[ey][l] = sum_ex tap[ey,ex] * cw[x][ex][l],
// with (rs, rw) and (cs, cw) the band tables (ops/pyrpool.py scale_bands,
// f64 products rounded once to f32).  Nothing at branch resolution is
// staged.  A down scale's plane is small (64x120 and 13x24 for the tail,
// 32x60 and 7x12 at most for the branch stack), so one pre-pass computes
// its adaptive average and the depthwise 3x3 of that at branch resolution,
// and the kernels apply the bilinear resample back alone, a 2 x 2 stencil.
// Both keep all arithmetic in f32 and round each output once to the output
// dtype.  The TPU kernel's own form of the same idea is _composed_up_mats.
#include "common.cuh"

#define MAX_S 8
#define MAX_P 16

enum { KIND_ID = 0, KIND_UP = 1, KIND_DOWN = 2 };

// Allow `kernel` `smem` bytes of dynamic shared memory (above 48 KB only
// on request).
template <typename K>
static cudaError_t launch_smem(K kernel, size_t smem) {
  return smem > 48 * 1024
      ? cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem)
      : cudaSuccess;
}

// ---------------------------------------------------------------------------
// The down scales' pre-pass, shared by both kernels
// ---------------------------------------------------------------------------

struct DownScale {
  int si;                   // the scale's index (its depthwise taps)
  int hs, ws;               // its branch plane
  const int* hb;            // adaptive-average bins [hs, 2] ([lo, hi)) and
  const float* hbw;         // their weights, of the rows
  const int* wb;            // and [ws, 2] of the columns
  const float* wbw;
  float* d;                 // the depthwise planes [B*P, hs, ws] (f32), or
                            // null: the kernel resamples them back itself
  const int* rs;            // then the resample back's bands: row starts
  const float* rw;          // [H] and weights [H][2], column starts [W]
  const int* cs;            // and weights [W][2]
  const float* cw;
};

struct DownArgs {
  const void* x;            // [B, P, H, W]
  const float* taps;        // [S, 3, 3, P]
  void* out;                // the branch stack [B, S*P, H, W], or null
  DownScale sc[MAX_S];
  int n, s_n, p, h, w;      // n down scales of the S
  int pool;                 // floats of the largest pooled plane
};

// The down scales of a launch, from the packed host tables (per down scale
// in order: its row bins then its column bins, two entries a bin) and one
// scratch buffer per scale (null for the others; or no scratch at all).
static DownArgs down_args(const void* x, const float* taps, int p, int h,
                          int w, int s_n, const int* kinds, const int* hs,
                          const int* ws, const int* itab, const float* ftab,
                          void* const* scratch) {
  DownArgs d = {};
  d.x = x; d.taps = taps; d.s_n = s_n; d.p = p; d.h = h; d.w = w;
  int64_t off = 0;
  for (int si = 0; si < s_n; ++si) {
    if (kinds[si] != KIND_DOWN) continue;
    DownScale& s = d.sc[d.n++];
    s.si = si; s.hs = hs[si]; s.ws = ws[si];
    s.hb = itab + off;          s.hbw = ftab + off;
    s.wb = s.hb + 2 * s.hs;     s.wbw = s.hbw + 2 * s.hs;
    s.d = scratch ? reinterpret_cast<float*>(scratch[si]) : nullptr;
    off += 2 * ((int64_t)s.hs + s.ws);
    if (s.hs * s.ws > d.pool) d.pool = s.hs * s.ws;
  }
  return d;
}

// Outputs x0 .. x0+m-1 of a row at dst: one 16-byte store where the 8 fill
// whole aligned words, else the widest aligned stores, else one by one.
template <typename T>
__device__ __forceinline__ void store_run(T* dst, const float v[8], int m) {
  const uintptr_t ad = reinterpret_cast<uintptr_t>(dst);
  if constexpr (sizeof(T) == 2) {
    if (m == 8 && (ad & 3) == 0) {
      uint4 u;
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      if ((ad & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = u;
      } else if ((ad & 7) == 0) {
        reinterpret_cast<uint2*>(dst)[0] = make_uint2(u.x, u.y);
        reinterpret_cast<uint2*>(dst)[1] = make_uint2(u.z, u.w);
      } else {
        unsigned int* d4 = reinterpret_cast<unsigned int*>(dst);
        d4[0] = u.x; d4[1] = u.y; d4[2] = u.z; d4[3] = u.w;
      }
      return;
    }
  } else {
    if (m == 8 && (ad & 15) == 0) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < m) dst[j] = from_f32<T>(v[j]);
}

// For every down scale, the adaptive average of each [H, W] plane to
// [hs, ws] (H bins first, then W, as the plain version multiplies) and the
// depthwise 3x3 of that (zero 'same' padding, channel c's taps).  A block
// takes one plane and every down scale in turn: each warp pools whole rows
// (the lanes read x's rows coalesced, the H bin's sum kept in a per-warp
// row, then the row's W bins) and the block holds the pooled plane in
// shared memory.  The tail's pre-pass (BACK false) writes the depthwise
// plane to the scale's D planes, which the tail kernel resamples.  The
// branch stack's blocks of it (BACK true) keep it in shared memory and
// write the branch itself: the bilinear resample back to [H, W] through
// the bands, 8 outputs a thread from the 2 x 2 taps, with 16-byte stores
// where a row's alignment allows, channel si*P + c of the output.  A block
// of PP_WARPS warps; sm holds the pooled plane (BACK: and its depthwise)
// and a row of H sums a warp.
template <typename T, bool BACK, int PP_WARPS>
__device__ __forceinline__ void down_plane(const DownArgs& a, int64_t plane,
                                           float* sm) {
  float* pooled = sm;                            // [hs][ws]
  float* dp = sm + a.pool;                       // BACK: its depthwise
  float* row = sm + (BACK ? 2 : 1) * a.pool + (threadIdx.x / 32) * a.w;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = (int)(plane % a.p);
  const T* src = reinterpret_cast<const T*>(a.x) + plane * a.h * a.w;
  for (int i = 0; i < a.n; ++i) {
    const DownScale& s = a.sc[i];
    const int hs = s.hs, ws = s.ws;
    for (int r = warp; r < hs; r += PP_WARPS) {
      const int y0 = s.hb[2 * r], y1 = s.hb[2 * r + 1];
      const float wy = s.hbw[2 * r];
      // eight columns a lane at a time, their loads in flight together
      for (int x0 = lane; x0 < a.w; x0 += 8 * 32) {
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 4
        for (int y = y0; y < y1; ++y) {
          const T* in = src + y * a.w;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (x0 + 32 * j < a.w) acc[j] += wy * to_f32(in[x0 + 32 * j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (x0 + 32 * j < a.w) row[x0 + 32 * j] = acc[j];
      }
      __syncwarp();
      for (int q = lane; q < ws; q += 32) {
        const int x0 = s.wb[2 * q], x1 = s.wb[2 * q + 1];
        const float wx = s.wbw[2 * q];
        float v = 0.f;
        for (int x = x0; x < x1; ++x) v += wx * row[x];
        pooled[r * ws + q] = v;
      }
      __syncwarp();
    }
    __syncthreads();
    const float* tk = a.taps + s.si * 9 * a.p + c;
    float* d = BACK ? dp : s.d + plane * hs * ws;
    for (int r = warp; r < hs; r += PP_WARPS)
      for (int q = lane; q < ws; q += 32) {
        float acc = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int yy = r + ky - 1;
          if (yy < 0 || yy >= hs) continue;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int xx = q + kx - 1;
            if (xx < 0 || xx >= ws) continue;
            acc += tk[(ky * 3 + kx) * a.p] * pooled[yy * ws + xx];
          }
        }
        d[r * ws + q] = acc;
      }
    if (BACK) {
      // a thread keeps one chunk of 8 columns (their taps in registers)
      // and walks every groups-th row
      __syncthreads();
      const int w = a.w, chunks = (w + 7) / 8;
      const int groups = max(1, PP_WARPS * 32 / chunks);
      T* out = reinterpret_cast<T*>(a.out) +
               ((plane - c) * a.s_n + (int64_t)s.si * a.p + c) * a.h * w;
      for (int it = threadIdx.x; it < chunks * groups; it += PP_WARPS * 32) {
        const int g = it / chunks, x0 = (it - g * chunks) * 8;
        const int m = min(8, w - x0);
        int qa[8], qb[8];
        float wa[8], wb[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int x = min(x0 + j, w - 1);
          qa[j] = s.cs[x];
          qb[j] = min(qa[j] + 1, ws - 1);
          wa[j] = s.cw[2 * x];
          wb[j] = s.cw[2 * x + 1];
        }
        for (int y = g; y < a.h; y += groups) {
          const int r = s.rs[y];
          const float* ra = dp + r * ws;
          const float* rn = dp + min(r + 1, hs - 1) * ws;
          const float2 wr = reinterpret_cast<const float2*>(s.rw)[y];
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = wr.x * (wa[j] * ra[qa[j]] + wb[j] * ra[qb[j]]) +
                   wr.y * (wa[j] * rn[qa[j]] + wb[j] * rn[qb[j]]);
          store_run<T>(out + (int64_t)y * w + x0, v, m);
        }
      }
    }
    __syncthreads();  // before the next scale overwrites the pooled plane
  }
}

// The tail's pre-pass: a block a plane.
#define TAIL_PP_WARPS 8
template <typename T>
__global__ void __launch_bounds__(TAIL_PP_WARPS * 32)
down_prepass_kernel(const __grid_constant__ DownArgs a) {
  extern __shared__ float sm[];
  down_plane<T, false, TAIL_PP_WARPS>(a, blockIdx.x, sm);
}

// Launch the tail's pre-pass over `planes` planes (nothing without down
// scales).
template <typename T>
static cudaError_t launch_prepass(const DownArgs& d, int64_t planes,
                                  cudaStream_t st) {
  if (!d.n || !planes) return cudaSuccess;
  const size_t smem = sizeof(float) * ((size_t)d.pool + TAIL_PP_WARPS * d.w);
  const cudaError_t e = launch_smem(down_prepass_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  down_prepass_kernel<T><<<(unsigned)planes, TAIL_PP_WARPS * 32, smem, st>>>(
      d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Branch stack: every branch as banded stencils over full-width row bands
// ---------------------------------------------------------------------------
//
// Bound: bytes.  The output is S times the input (0.387 GB a main-path
// batch in bf16), against ~75 f32 multiply-adds an output pixel and channel
// over the five scales.  One launch, two kinds of block: the first B*P
// blocks each write the down scales' branches of one plane whole
// (down_plane), the others the identity and up scales' branches of a band;
// nothing passes between them, so the pooling's latency overlaps the bands'
// work.  A band block takes `rb` output rows of one (image, channel) plane
// across its whole width.  It first copies the
// rows of x that the bands read into shared memory, as f32 with eight loads
// in flight a thread: a contiguous run of the plane, staged flat (zero past
// the plane's end and in a pad after it, where the bands' weights are 0
// too).  A thread then takes one output column and a run of `rsub` rows.
// Per scale it folds the channel's taps into its column's weights,
// B[ey][l] (3K registers), keeps the column sums u[k][ey] = sum_l B[ey][l]
// x[r+k][cs+l] of the K source rows that the current row's band covers as
// a window in registers, slid down as the row starts advance (they are
// non-decreasing), and forms each output as sum_k sum_ey rw[y][ey][k]
// u[k][ey]: 3K multiply-adds a source row and 3K an output, the row weights
// read as 16-byte words, no division.  Each scale's outputs go to shared
// memory; after the last scale the block writes each scale's span of rb x W
// contiguous elements with 16-byte stores (element by element where a span
// does not start on a 16-byte word or does not fill whole words).  The grid
// gives 2048 to 5760 blocks of 4 warps at the main path's planes.  The
// host packs the launch into one int record (ops/pyrpool.py
// _branch_record), so a call costs one short ctypes call.
#define BR_NT 128  // threads of a branch-stack block

struct BranchScale {
  int k;                    // band width (3, 4 or 6; 2 for a down scale)
  int down;                 // a down scale: the pre-pass writes its branch
  const int* rs;            // [H] row starts in the source plane
  const float* rw;          // [H][rwp] row weights [E][K] (rwp = E*K, x-
                            // sourced scales padded to a multiple of 4)
  const int* cs;            // [W] column starts
  const float* cw;          // [W][E*K] column weights [E][K]
};

struct BranchArgs {
  const void* x;            // [B, P, H, W]
  void* out;                // [B, S*P, H, W]
  const float* taps;        // [S, 3, 3, P]
  BranchScale sc[MAX_S];
  DownArgs down;            // the down scales (their blocks come first)
  int down_blocks;          // B*P with down scales, else 0
  int bands;                // bands a plane
  int p, h, w, s_n;
  int rb;                   // output rows of a band
  int nsub, rsub;           // row runs a column is cut into, rows a run
  int out_cap;              // elements of a scale's staged outputs (whole
                            // 16-byte words)
};

// Elements [e0, e0 + n) of a plane of `total` elements into dst[0 .. n) as
// f32, zero past the plane's end; eight loads in flight a thread.
template <typename S>
__device__ __forceinline__ void stage_run(const S* __restrict__ src,
                                          int64_t total, int64_t e0, int n,
                                          float* dst, int tid) {
  for (int i0 = tid; i0 < n; i0 += 8 * BR_NT) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * BR_NT;
      v[u] = i < n && e0 + i < total ? to_f32(src[e0 + i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * BR_NT < n) dst[i0 + u * BR_NT] = v[u];
  }
}

// The 3 column sums of one source row: u[e] = sum_l bl[e][l] * q[l].
template <int K>
__device__ __forceinline__ void col_sums(const float* q, float bl[3][K],
                                         float u[3]) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float v = q[l];
    a0 += bl[0][l] * v;
    a1 += bl[1][l] * v;
    a2 += bl[2][l] * v;
  }
  u[0] = a0; u[1] = a1; u[2] = a2;
}

// An identity or up scale's outputs of column x, rows ya .. yb-1 of the
// band at y0, into o[yy * w], from the staged x rows (source row r at
// s_x + (r - r0) * w); tk points at the channel's taps (P apart).
template <int K, typename T>
__device__ __forceinline__ void branch_x(const BranchScale& s,
                                         const float* tk, int p,
                                         const float* s_x, int r0, int x,
                                         int y0, int ya, int yb, T* o,
                                         int w) {
  constexpr int RWP = (3 * K + 3) & ~3;
  float bl[3][K];
  {
    const float* cw = s.cw + x * 3 * K;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float t0 = tk[(3 * e) * p], t1 = tk[(3 * e + 1) * p],
                  t2 = tk[(3 * e + 2) * p];
#pragma unroll
      for (int l = 0; l < K; ++l)
        bl[e][l] = t0 * cw[l] + t1 * cw[K + l] + t2 * cw[2 * K + l];
    }
  }
  const float* col = s_x + s.cs[x];
  int cur = s.rs[y0 + ya];
  float u[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k)
    col_sums<K>(col + (cur + k - r0) * w, bl, u[k]);
  for (int yy = ya; yy < yb; ++yy) {
    const int y = y0 + yy;
    const int r = s.rs[y];
    while (cur < r) {  // slide the window down one source row
#pragma unroll
      for (int k = 0; k + 1 < K; ++k) {
        u[k][0] = u[k + 1][0];
        u[k][1] = u[k + 1][1];
        u[k][2] = u[k + 1][2];
      }
      ++cur;
      col_sums<K>(col + (cur + K - 1 - r0) * w, bl, u[K - 1]);
    }
    float wr[RWP];  // the row's weights [3][K], as 16-byte loads
#pragma unroll
    for (int q = 0; q < RWP / 4; ++q) {
      const float4 t4 = reinterpret_cast<const float4*>(s.rw + y * RWP)[q];
      wr[4 * q] = t4.x; wr[4 * q + 1] = t4.y;
      wr[4 * q + 2] = t4.z; wr[4 * q + 3] = t4.w;
    }
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      v += wr[k] * u[k][0] + wr[K + k] * u[k][1] + wr[2 * K + k] * u[k][2];
    o[yy * w] = from_f32<T>(v);
  }
}

// grid (down_blocks + bands * B * P), block BR_NT; KMAX is the widest band
// of the launch's x-sourced scales (4 or 6): an instance holds only the
// widths up to it.
template <typename T, int KMAX>
__global__ void __launch_bounds__(BR_NT)
pyr_branches_kernel(const __grid_constant__ BranchArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if ((int)blockIdx.x < a.down_blocks) {
    down_plane<T, true, BR_NT / 32>(a.down, blockIdx.x,
                                    reinterpret_cast<float*>(smem_raw));
    return;
  }
  T* s_out = reinterpret_cast<T*>(smem_raw);   // [x-sourced scales][out_cap]
  const int tid = threadIdx.x, p = a.p, w = a.w;
  const int64_t item = blockIdx.x - a.down_blocks;
  const int64_t plane = item / a.bands;
  const int c = (int)(plane % p), b = (int)(plane / p);
  const int y0 = (int)(item - plane * a.bands) * a.rb;
  const int nrows = min(a.rb, a.h - y0);
  const int64_t hw = (int64_t)a.h * w;
  // the rows of x that the bands of this band read, and how many scales
  int r0 = a.h, r1 = 0, n_x = 0;
  for (int si = 0; si < a.s_n; ++si) {
    const BranchScale& s = a.sc[si];
    if (s.down) continue;
    r0 = min(r0, s.rs[y0]);
    r1 = max(r1, s.rs[y0 + nrows - 1] + s.k);
    ++n_x;
  }
  float* s_x = reinterpret_cast<float*>(s_out + n_x * a.out_cap);
  if (r1 > r0)  // and the pad after them: the bands' overhang, weight 0
    stage_run<T>(reinterpret_cast<const T*>(a.x) + plane * hw, hw,
                 (int64_t)r0 * w, (r1 - r0) * w + KMAX, s_x, tid);
  __syncthreads();
  for (int si = 0, j = 0; si < a.s_n; ++si) {
    const BranchScale& s = a.sc[si];
    if (s.down) continue;
    const float* tk = a.taps + si * 9 * p + c;
    T* so = s_out + j++ * a.out_cap;
    for (int it = tid; it < w * a.nsub; it += BR_NT) {
      const int sub = it / w, x = it - sub * w;
      const int ya = sub * a.rsub, yb = min(ya + a.rsub, nrows);
      if (ya >= yb) continue;
      switch (s.k) {
        case 3: branch_x<3, T>(s, tk, p, s_x, r0, x, y0, ya, yb, so + x, w);
                break;
        case 4: branch_x<4, T>(s, tk, p, s_x, r0, x, y0, ya, yb, so + x, w);
                break;
        default:
          if constexpr (KMAX > 4)
            branch_x<KMAX, T>(s, tk, p, s_x, r0, x, y0, ya, yb, so + x, w);
          break;
      }
    }
  }
  __syncthreads();
  // each scale's span of nrows x W contiguous outputs
  const int n = nrows * w;
  const bool whole = (n * sizeof(T)) % 16 == 0;
  for (int si = 0, j = 0; si < a.s_n; ++si) {
    if (a.sc[si].down) continue;
    T* dst = reinterpret_cast<T*>(a.out) +
             (((int64_t)b * a.s_n + si) * p + c) * hw + (int64_t)y0 * w;
    const T* sv = s_out + j++ * a.out_cap;
    if (whole && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      const int n16 = n * (int)sizeof(T) / 16;
      for (int i = tid; i < n16; i += BR_NT)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(sv)[i];
    } else {
      for (int i = tid; i < n; i += BR_NT) dst[i] = sv[i];
    }
  }
}

template <typename T, int KMAX>
static int branches_typed(const BranchArgs& a, int64_t blocks, size_t smem,
                          cudaStream_t st) {
  const cudaError_t e = launch_smem(pyr_branches_kernel<T, KMAX>, smem);
  if (e != cudaSuccess) return (int)e;
  pyr_branches_kernel<T, KMAX><<<(unsigned)blocks, BR_NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The launch record `cfg` (ints, ops/pyrpool.py _branch_record): dtype, B,
// P, H, W, S, rb, nsub, rsub, the staged x floats (rows and pad), then per
// scale its kind, branch size (hs, ws), band width K, and the offsets of
// its row starts and column starts in the int tables and of its row and
// column weights in the float tables.  tabs: the down scales'
// adaptive-average bins (ints, floats; down_args) and the band tables
// (ints, floats).  x [B, P, H, W] (dtype), taps [S, 3, 3, P] f32 ->
// out [B, S*P, H, W] (dtype).
#define BR_HEAD 10
#define BR_SCALE 8
extern "C" int pyr_branches_launch(const int* cfg, void* const* tabs,
                                   const void* x, const float* taps,
                                   void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int dtype = cfg[0], b = cfg[1], p = cfg[2], h = cfg[3], w = cfg[4];
  const int s_n = cfg[5];
  if ((int64_t)b * p * h * w == 0) return (int)cudaGetLastError();
  if (s_n > MAX_S || cfg[6] < 1 || cfg[7] < 1 || cfg[8] * cfg[7] < cfg[6])
    return (int)cudaErrorInvalidValue;
  const int* bt_i = static_cast<const int*>(tabs[2]);
  const float* bt_f = static_cast<const float*>(tabs[3]);
  BranchArgs a = {};
  a.x = x; a.out = out; a.taps = taps;
  a.p = p; a.h = h; a.w = w; a.s_n = s_n;
  a.rb = cfg[6]; a.nsub = cfg[7]; a.rsub = cfg[8];
  const int esize = dtype == MSPL_BF16 ? 2 : 4;
  a.out_cap = (a.rb * w * esize + 15) / 16 * 16 / esize;
  int kinds[MAX_S], hs[MAX_S], ws[MAX_S], kmax = 0, n_x = 0;
  for (int si = 0; si < s_n; ++si) {
    const int* l = cfg + BR_HEAD + BR_SCALE * si;
    BranchScale& s = a.sc[si];
    kinds[si] = l[0]; hs[si] = l[1]; ws[si] = l[2];
    s.k = l[3];
    s.rs = bt_i + l[4]; s.cs = bt_i + l[5];
    s.rw = bt_f + l[6]; s.cw = bt_f + l[7];
    s.down = kinds[si] == KIND_DOWN;
    if (s.down ? s.k != 2 : s.k != 3 && s.k != 4 && s.k != 6)
      return (int)cudaErrorInvalidValue;
    if (!s.down) {
      if (s.k > kmax) kmax = s.k;
      ++n_x;
    }
  }
  DownArgs& d = a.down;
  d = down_args(x, taps, p, h, w, s_n, kinds, hs, ws,
                static_cast<const int*>(tabs[0]),
                static_cast<const float*>(tabs[1]), nullptr);
  d.out = out;
  for (int i = 0; i < d.n; ++i) {
    const BranchScale& s = a.sc[d.sc[i].si];
    d.sc[i].rs = s.rs; d.sc[i].rw = s.rw;
    d.sc[i].cs = s.cs; d.sc[i].cw = s.cw;
  }
  const int64_t planes = (int64_t)b * p;
  a.down_blocks = d.n ? (int)planes : 0;
  a.bands = (h + a.rb - 1) / a.rb;
  const int64_t blocks = a.down_blocks + (n_x ? planes * a.bands : 0);
  if (!blocks) return (int)cudaGetLastError();
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)n_x * a.out_cap * esize +
                sizeof(float) * (size_t)cfg[9];
  const size_t down_smem =
      sizeof(float) * (2 * (size_t)d.pool + (BR_NT / 32) * (size_t)w);
  if (d.n && down_smem > smem) smem = down_smem;
  if (dtype == MSPL_BF16)
    return kmax > 4 ? branches_typed<__nv_bfloat16, 6>(a, blocks, smem, st)
                    : branches_typed<__nv_bfloat16, 4>(a, blocks, smem, st);
  return kmax > 4 ? branches_typed<float, 6>(a, blocks, smem, st)
                  : branches_typed<float, 4>(a, blocks, smem, st);
}

// ---------------------------------------------------------------------------
// Fused tail: every branch as composed banded operators at source resolution
// ---------------------------------------------------------------------------
//
// Each branch as the composed banded stencils of the file's head note, the
// down scales through the shared pre-pass and a 2 x 2 resample back.
//
// Bound: operations (f32); on this card first the instructions of the
// stencils, the merge and the classifier, and the latency of staging.  A
// block of 32 x 16 threads takes a 16 x 30 output tile and its one-pixel
// merge halo: 18 x 32 branch positions, one lane a branch column (the merge
// halo is recomputed by the neighbouring tiles).  The host lays out, per
// tile, each scale's band tables for the tile's rows and columns and the
// source regions they read (ops/pyrpool.py _tail_plan), so a block starts
// with flat copies: parameters, taps, its tile's tables.  Per channel group
// it stages the region of x that the x-sourced scales read (f32, zero past
// the plane's end, where the bands' weights are 0 too) and each down
// scale's region of its depthwise plane, eight channels' loads in flight at
// a time.  Per scale, each warp takes an even share of the (channel, branch
// row) items (B kept in registers while the channel stays), writes the
// branch values with their affine + PReLU to one of two buffers, and after
// the scale's one barrier adds the merge taps to its pixel's sums in smem.
// The epilogue applies the merge affine + PReLU and the classifier (16-byte
// weight loads) and rounds once.  64 registers a thread, so that two blocks
// (32 warps) share an SM.
#define BTH 16              // output rows of a tile
#define BTW 30              // output columns of a tile
#define BBW 32              // branch columns: the tile and its merge halo
#define BBH (BTH + 2)       // branch rows
#define BNT (BBW * BTH)     // threads of a block
#define TILE_INTS (4 + BBH + BBW)  // a scale's ints in a tile's table

struct BandScale {
  int k;                    // band width (a template instance)
  int src_h, src_w;         // the plane the bands index
  const float* rg;          // down scales: the depthwise planes [B*P,
                            // src_h, src_w] the pre-pass fills; else null
};

struct TailArgs {
  const void* x;            // [B, P, H, W]
  void* out;                // [B, O, H, W]
  const float* taps;        // [S, 3, 3, P]
  const float* params;      // aff1 (3,S*P) | merge (3,3,S,P) | aff2 (3,P)
                            // | cls_w (P,O) | cls_b (O) | aff3 (3,O)
  const float* tab_f;       // per tile: per scale cw [3K][32], rw [18][3K]
                            // (padded to a multiple of 4; a down scale's
                            // cw [2][32], rw [18][2])
  const int* tab_i;         // per tile: per scale region (r0, q0, rows,
                            // pitch), row starts [18], column starts [32];
                            // then the x region
  BandScale sc[MAX_S];
  int b, p, h, w, s_n, o_n;
  int tiles_x;
  int g;                    // channels staged together
  int tile_f, tile_i;       // a tile's floats and ints in tab_f and tab_i
  int x_cap, d_cap;         // smem floats of one channel's x region and of
                            // a down scale's region
};

// dst[i] = src[i] for i < n, four loads in flight a thread.
template <typename V>
__device__ __forceinline__ void copy_block(V* dst, const V* __restrict__ src,
                                           int n, int tid) {
  for (int i = tid; i < n; i += 4 * BNT) {
    V v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * BNT < n) v[u] = src[i + u * BNT];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * BNT < n) dst[i + u * BNT] = v[u];
  }
}

// Stage region rg = (r0, q0, rows, pitch) of nc source planes (`plane`
// elements apart, zero past src_h x src_w) into dst[g * cap + ...] as f32,
// eight channels' loads in flight at a time.
template <typename S>
__device__ __forceinline__ void stage_region(const S* __restrict__ src,
                                             int64_t plane, int nc, int src_h,
                                             int src_w, const int* rg,
                                             float* dst, int cap, int tid) {
  const int r0 = rg[0], q0 = rg[1], pitch = rg[3], n = rg[2] * pitch;
  for (int idx = tid; idx < n; idx += BNT) {
    const int i = idx / pitch, j = idx - i * pitch;
    const int sy = r0 + i, sx = q0 + j;
    const bool ok = sy < src_h && sx < src_w;
    const S* q = src + (ok ? (int64_t)sy * src_w + sx : 0);
    float* d = dst + idx;
    for (int g = 0; g < nc; g += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = ok && g + u < nc ? to_f32(q[(g + u) * plane]) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (g + u < nc) d[(g + u) * cap] = v[u];
    }
  }
}

// Down scale si's branch values (after its affine + PReLU; 0 outside the
// image) of channels c0 .. c0+nc-1 at the tile's branch positions, into
// bv[g][18][32]: the bilinear resample back of the staged depthwise planes
// src_s[g * cap + ...] (row pitch `pitch`), H first, through the tile's
// tables cwt [2][32], rwt [18][2], rb [18] and col [32].  Ends
// synchronized.
__device__ __forceinline__ void band_down(
    int si, int c0, int nc, const TailArgs& a, const float* aff1,
    const float* cwt, const float* rwt, const int* rb, const int* col,
    const float* src_s, int cap, int pitch, float* bv, int y0, int x0, int tx,
    int ty) {
  const int h = a.h, w = a.w, p = a.p, sp_n = a.s_n * p;
  const bool col_in = x0 - 1 + tx >= 0 && x0 - 1 + tx < w;
  const int c_off = col[tx];
  const float wa = cwt[tx], wb = cwt[BBW + tx];
  const int n = nc * BBH, i0 = ty * n / BTH, i1 = (ty + 1) * n / BTH;
  for (int it = i0; it < i1; ++it) {
    const int g = it / BBH, rr = it - g * BBH;
    const int gy = y0 - 1 + rr;
    float v = 0.f;
    if (col_in && gy >= 0 && gy < h) {
      const float* sp = src_s + g * cap + rb[rr] + c_off;
      const float ya = rwt[2 * rr], yb = rwt[2 * rr + 1];
      v = wa * (ya * sp[0] + yb * sp[pitch]) +
          wb * (ya * sp[1] + yb * sp[pitch + 1]);
      const int ch = si * p + c0 + g;
      v = prelu(v * aff1[ch] + aff1[sp_n + ch], aff1[2 * sp_n + ch]);
    }
    bv[it * BBW + tx] = v;
  }
  __syncthreads();
}

// Scale si's branch values (after its affine + PReLU; 0 outside the image)
// of channels c0 .. c0+nc-1 at the tile's 18 x 32 branch positions, into
// bv[g][18][32], from the staged regions src_s[g * cap + ...] (row pitch
// `pitch`) through the tile's tables of the scale: cwt [3K][32], rwt
// [18][RWP] (3K weights a row, padded to whole 16-byte words), row starts
// rb [18] (staged elements) and column starts col [32].  Ends synchronized.
template <int K>
__device__ __forceinline__ void band_scale(
    int si, int c0, int nc, const TailArgs& a, const float* aff1,
    const float* s_taps, const float* cwt, const float* rwt, const int* rb,
    const int* col, const float* src_s, int cap, int pitch, float* bv, int y0,
    int x0, int tx, int ty) {
  constexpr int RWP = (3 * K + 3) & ~3;
  const int h = a.h, w = a.w, p = a.p, sp_n = a.s_n * p;
  const bool col_in = x0 - 1 + tx >= 0 && x0 - 1 + tx < w;
  const int c_off = col[tx];
  const float* cr = cwt + tx;  // [3][K] of this lane's column, 32 apart
  // this warp's share of the (channel, row) items, channel-major
  const int n = nc * BBH, i0 = ty * n / BTH, i1 = (ty + 1) * n / BTH;
  float bl[3][K];
  int g_prev = -1;
  for (int it = i0; it < i1; ++it) {
    const int g = it / BBH, rr = it - g * BBH;
    if (g != g_prev) {
      g_prev = g;
      const float* tk = s_taps + si * 9 * p + c0 + g;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float t0 = tk[(3 * e) * p], t1 = tk[(3 * e + 1) * p],
                    t2 = tk[(3 * e + 2) * p];
#pragma unroll
        for (int l = 0; l < K; ++l)
          bl[e][l] = t0 * cr[l * BBW] + t1 * cr[(K + l) * BBW] +
                     t2 * cr[(2 * K + l) * BBW];
      }
    }
    const int gy = y0 - 1 + rr;
    float v = 0.f;
    if (col_in && gy >= 0 && gy < h) {
      const float* sp = src_s + g * cap + rb[rr] + c_off;
      float wr[RWP];  // the row's band weights [3][K], as 16-byte loads
#pragma unroll
      for (int q = 0; q < RWP / 4; ++q) {
        const float4 t4 = reinterpret_cast<const float4*>(rwt + rr * RWP)[q];
        wr[4 * q] = t4.x; wr[4 * q + 1] = t4.y;
        wr[4 * q + 2] = t4.z; wr[4 * q + 3] = t4.w;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float u0 = 0.f, u1 = 0.f, u2 = 0.f;
#pragma unroll
        for (int l = 0; l < K; ++l) {
          const float sv = sp[k * pitch + l];
          u0 += bl[0][l] * sv;
          u1 += bl[1][l] * sv;
          u2 += bl[2][l] * sv;
        }
        v += wr[k] * u0 + wr[K + k] * u1 + wr[2 * K + k] * u2;
      }
      const int ch = si * p + c0 + g;
      v = prelu(v * aff1[ch] + aff1[sp_n + ch], aff1[2 * sp_n + ch]);
    }
    bv[it * BBW + tx] = v;
  }
  __syncthreads();
}

// grid (tiles, B), block (32, 16); out [B, O, H, W].  KMAX is the widest
// band of the launch's x-sourced scales: an instance holds only the band
// widths up to it, since the widest one sets every path's registers.
template <typename T, int KMAX>
__global__ void __launch_bounds__(BNT, 2)
pyr_tail_kernel(const __grid_constant__ TailArgs a) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BBW + tx;
  const int p = a.p, s_n = a.s_n, o_n = a.o_n, sp_n = s_n * p, G = a.g;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int y0 = (tile / a.tiles_x) * BTH, x0 = (tile % a.tiles_x) * BTW;
  // Each region starts on a 16-byte word: the two affines ahead of the
  // merge, the taps, the merge taps in rows of 12, the classifier in rows
  // of P rounded up to 4 beside (bias, last affine) rows, for 16-byte loads.
  const int p4 = (p + 3) & ~3;
  float* par = smem;                    // aff1 [3, S*P] | aff2 [3, P]
  float* s_taps = par + ((3 * sp_n + 3 * p + 3) & ~3);  // [S, 3, 3, P]
  float* mw12 = s_taps + ((9 * sp_n + 3) & ~3); // [S*P][12] merge taps
  float* cls = mw12 + 12 * sp_n;                // [O][p4] classifier
  float* cb4 = cls + o_n * p4;                  // [O][4] bias, last affine
  float* mrg = cb4 + 4 * o_n;                   // [P][BNT] merge sums
  float* tf = mrg + p * BNT;                    // the tile's float tables
  int* ti = reinterpret_cast<int*>(tf + a.tile_f);  // and its int tables
  float* s_x = reinterpret_cast<float*>(ti + a.tile_i);  // [G][x_cap]
  int n_down = 0;
  for (int si = 0; si < s_n; ++si) n_down += a.sc[si].rg != nullptr;
  float* s_d = s_x + G * a.x_cap;               // [down scales][G][d_cap]
  float* bvs = s_d + n_down * G * a.d_cap;      // 2 x [G][18][32]
  copy_block(par, a.params, 3 * sp_n, tid);
  copy_block(par + 3 * sp_n, a.params + 12 * sp_n, 3 * p, tid);
  copy_block(s_taps, a.taps, 9 * sp_n, tid);
  copy_block(tf, a.tab_f + (int64_t)tile * a.tile_f, a.tile_f, tid);
  copy_block(ti, a.tab_i + (int64_t)tile * a.tile_i, a.tile_i, tid);
  for (int i = tid; i < 12 * sp_n; i += BNT) {
    const int k = i % 12;
    mw12[i] = k < 9 ? a.params[(3 + k) * sp_n + i / 12] : 0.f;
  }
  {
    const float* clsw = a.params + 12 * sp_n + 3 * p;  // [P, O]
    const float* clsb = clsw + p * o_n;                // [O]
    const float* aff3 = clsb + o_n;                    // [3, O]
    for (int i = tid; i < o_n * p4; i += BNT) {
      const int o = i / p4, c = i - o * p4;
      cls[i] = c < p ? clsw[c * o_n + o] : 0.f;
    }
    for (int o = tid; o < o_n; o += BNT) {
      cb4[4 * o] = clsb[o];
      cb4[4 * o + 1] = aff3[o];
      cb4[4 * o + 2] = aff3[o_n + o];
      cb4[4 * o + 3] = aff3[2 * o_n + o];
    }
  }
  for (int c = 0; c < p; ++c) mrg[c * BNT + tid] = 0.f;
  __syncthreads();
  const float* aff1 = par;               // [3, S*P]
  const float* aff2 = aff1 + 3 * sp_n;   // [3, P]
  const int* x_reg = ti + s_n * TILE_INTS;

  const int oy = y0 + ty, ox = x0 + tx;
  const bool valid = tx < BTW && oy < a.h && ox < a.w;
  const int64_t hw = (int64_t)a.h * a.w;
  const int64_t plane0 = (int64_t)b * p;
  const T* img = reinterpret_cast<const T*>(a.x) + plane0 * hw;
  int step = 0;
  for (int c0 = 0; c0 < p; c0 += G) {
    const int nc = min(G, p - c0);
    // the x region and each down scale's, their loads in flight together
    // (every read of the staging areas came before the last scale's
    // barrier)
    stage_region<T>(img + c0 * hw, hw, nc, a.h, a.w, x_reg, s_x, a.x_cap,
                    tid);
    for (int si = 0, d = 0; si < s_n; ++si) {
      const BandScale& s = a.sc[si];
      if (!s.rg) continue;
      const int64_t n = (int64_t)s.src_h * s.src_w;
      stage_region<float>(s.rg + (plane0 + c0) * n, n, nc, s.src_h, s.src_w,
                          ti + si * TILE_INTS, s_d + d++ * G * a.d_cap,
                          a.d_cap, tid);
    }
    __syncthreads();
    const float* f = tf;
    for (int si = 0, d = 0; si < s_n; ++si, ++step) {
      const BandScale& s = a.sc[si];
      const int k = s.k;
      const int ek = s.rg ? k : 3 * k;      // offsets x band width
      const int rwp = s.rg ? k : (ek + 3) & ~3;  // a row's padded weights
      const float* cwt = f;
      const float* rwt = f + ek * BBW;
      f = rwt + BBH * rwp;
      const int* reg = ti + si * TILE_INTS;
      // two buffers: a scale writes the one whose last reads (the merge
      // two scales back) every thread finished before the last barrier
      float* bv = bvs + (step & 1) * G * BBH * BBW;
      if (s.rg) {
        band_down(si, c0, nc, a, aff1, cwt, rwt, reg + 4, reg + 4 + BBH,
                  s_d + d++ * G * a.d_cap, a.d_cap, reg[3], bv, y0, x0, tx,
                  ty);
      } else switch (k) {
        case 3: band_scale<3>(si, c0, nc, a, aff1, s_taps, cwt, rwt, reg + 4,
                              reg + 4 + BBH, s_x, a.x_cap, reg[3], bv, y0,
                              x0, tx, ty); break;
        case 4: band_scale<4>(si, c0, nc, a, aff1, s_taps, cwt, rwt, reg + 4,
                              reg + 4 + BBH, s_x, a.x_cap, reg[3], bv, y0,
                              x0, tx, ty); break;
        default:
          if constexpr (KMAX > 4)
            band_scale<KMAX>(si, c0, nc, a, aff1, s_taps, cwt, rwt, reg + 4,
                             reg + 4 + BBH, s_x, a.x_cap, reg[3], bv, y0,
                             x0, tx, ty);
          break;
      }
      if (!valid) continue;
      for (int g = 0; g < nc; ++g) {
        const float* v = bv + g * BBH * BBW + ty * BBW + tx;
        const float4* m4 =
            reinterpret_cast<const float4*>(mw12 + (si * p + c0 + g) * 12);
        const float4 m0 = m4[0], m1 = m4[1], m2 = m4[2];
        float part = m0.x * v[0];
        part += m0.y * v[1];
        part += m0.z * v[2];
        part += m0.w * v[BBW];
        part += m1.x * v[BBW + 1];
        part += m1.y * v[BBW + 2];
        part += m1.z * v[2 * BBW];
        part += m1.w * v[2 * BBW + 1];
        part += m2.x * v[2 * BBW + 2];
        mrg[(c0 + g) * BNT + tid] += part;
      }
    }
  }
  if (!valid) return;
  float merged[MAX_P];
#pragma unroll
  for (int c = 0; c < MAX_P; ++c)
    merged[c] = c < p ? prelu(mrg[c * BNT + tid] * aff2[c] + aff2[p + c],
                              aff2[2 * p + c])
                      : 0.f;
  T* out = reinterpret_cast<T*>(a.out);
  for (int o = 0; o < o_n; ++o) {
    const float4* w4 = reinterpret_cast<const float4*>(cls + o * p4);
    float v = 0.f;  // channel by channel, as the plain version sums
#pragma unroll
    for (int q = 0; q < MAX_P / 4; ++q) {
      if (4 * q >= p) break;
      const float4 t4 = w4[q];
      v += merged[4 * q] * t4.x;
      v += merged[4 * q + 1] * t4.y;
      v += merged[4 * q + 2] * t4.z;
      v += merged[4 * q + 3] * t4.w;
    }
    const float4 e = reinterpret_cast<const float4*>(cb4)[o];
    v += e.x;
    out[((int64_t)b * o_n + o) * hw + (int64_t)oy * a.w + ox] =
        from_f32<T>(prelu(v * e.y + e.z, e.w));
  }
}

template <typename T, int KMAX>
static int tail_typed(const TailArgs& t, const DownArgs& d, size_t smem,
                      cudaStream_t st) {
  cudaError_t e = launch_prepass<T>(d, (int64_t)t.b * t.p, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(t.tiles_x * ((t.h + BTH - 1) / BTH), t.b);
  if ((e = launch_smem(pyr_tail_kernel<T, KMAX>, smem)) != cudaSuccess)
    return (int)e;
  pyr_tail_kernel<T, KMAX><<<grid, dim3(BBW, BTH), smem, st>>>(t);
  return (int)cudaGetLastError();
}

// x [B, P, H, W] (dtype), taps [S, 3, 3, P] f32, params f32 packed as
// [aff1 (3,S*P) | merge (3,3,S,P) | aff2 (3,P) | cls_w (P,O) | cls_b (O) |
//  aff3 (3,O)] -> out [B, O, H, W] (dtype); P <= 16.  kinds/hs/ws: each
// scale's kind and branch size (host arrays of S); itab/ftab: the down
// scales' adaptive-average bins (down_args); scratch holds a [B*P, hs, ws]
// f32 buffer for each down scale, which the pre-pass fills with its
// depthwise planes; band_k
// [S] the band width of each scale (3, 4 or 6; 2 for a down scale);
// tab_f/tab_i the tiles' tables (tile_f floats and tile_i ints a tile,
// laid out as TailArgs says); g channels are staged together, each in x_cap
// floats of x region and d_cap floats of each down scale's region (the
// wrapper sizes all of them).
extern "C" int pyr_tail_launch(const void* x, int dtype, int b, int p, int h,
                               int w, int s_n, const int* kinds, const int* hs,
                               const int* ws, const int* itab,
                               const float* ftab, const float* taps,
                               const float* params, int o_n, int g,
                               const int* band_k, const float* tab_f,
                               const int* tab_i, int tile_f, int tile_i,
                               void* const* scratch, int x_cap, int d_cap,
                               void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if ((int64_t)b * h * w == 0) return (int)cudaGetLastError();
  if (s_n > MAX_S || p > MAX_P || g < 1) return (int)cudaErrorInvalidValue;
  TailArgs t = {};
  t.x = x; t.out = out; t.taps = taps; t.params = params;
  t.tab_f = tab_f; t.tab_i = tab_i; t.tile_f = tile_f; t.tile_i = tile_i;
  t.b = b; t.p = p; t.h = h; t.w = w; t.s_n = s_n; t.o_n = o_n;
  t.tiles_x = (w + BTW - 1) / BTW;
  t.g = g; t.x_cap = x_cap; t.d_cap = d_cap;
  int n_down = 0, kmax = 0;
  for (int si = 0; si < s_n; ++si) {
    BandScale& s = t.sc[si];
    s.k = band_k[si];
    const bool down = kinds[si] == KIND_DOWN;
    if (down ? s.k != 2 : s.k != 3 && s.k != 4 && s.k != 6)
      return (int)cudaErrorInvalidValue;
    s.src_h = down ? hs[si] : h;
    s.src_w = down ? ws[si] : w;
    if (down) {
      s.rg = reinterpret_cast<float*>(scratch[si]);
      ++n_down;
    } else if (s.k > kmax) {
      kmax = s.k;
    }
  }
  const DownArgs d = down_args(x, taps, p, h, w, s_n, kinds, hs, ws, itab,
                               ftab, scratch);
  const size_t smem = sizeof(float) *
      ((size_t)((3 * s_n * p + 3 * p + 3) & ~3) +
       ((9 * s_n * p + 3) & ~3) + 12 * s_n * p +
       (size_t)o_n * (((p + 3) & ~3) + 4) + (size_t)p * BNT + tile_f +
       tile_i +
       (size_t)g * (x_cap + (size_t)n_down * d_cap + 2 * BBH * BBW));
  if (dtype == MSPL_BF16)
    return kmax > 4 ? tail_typed<__nv_bfloat16, 6>(t, d, smem, st)
                    : tail_typed<__nv_bfloat16, 4>(t, d, smem, st);
  return kmax > 4 ? tail_typed<float, 6>(t, d, smem, st)
                  : tail_typed<float, 4>(t, d, smem, st);
}

// Blocks of the tail kernel's instance for bands up to kmax (4 or 6) one SM
// holds with `smem` bytes of dynamic shared memory each, into *blocks.
extern "C" int pyr_tail_occupancy(int dtype, int kmax, int smem,
                                  int* blocks) {
  const void* kernel =
      dtype == MSPL_BF16
          ? (kmax > 4 ? (const void*)pyr_tail_kernel<__nv_bfloat16, 6>
                      : (const void*)pyr_tail_kernel<__nv_bfloat16, 4>)
          : (kmax > 4 ? (const void*)pyr_tail_kernel<float, 6>
                      : (const void*)pyr_tail_kernel<float, 4>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, BNT,
                                                      (size_t)smem);
  return (int)e;
}
