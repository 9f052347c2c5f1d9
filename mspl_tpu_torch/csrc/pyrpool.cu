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
// Bound: operations for the tail, bytes for the branch stack: what has to
// move is only the P-channel input and the output, but every output pixel
// needs a few hundred multiply-adds across the five branches and the merge.
// The largest branch (scale 2.0 of the classifier stage, 256x480 per plane)
// does not fit a block's shared memory.
//
// Branch stack design: the output is cut into 16x32 tiles, one block of
// 512 threads per tile and image, which takes the channels in groups of as
// many as shared memory holds.  The kernel is bound by its instruction
// count, so each staging loop works out a position's indices and resample
// taps once for the whole group.  For each scale the block stages in shared
// memory only the part of the branch-resolution plane its tile needs: the
// resampled plane R (computed from x through L1 for the up scales; read from
// a small global scratch for the down scales, which a pre-pass fills once
// per plane because an adaptive-average bin can span ~10x10 inputs), the
// depthwise 3x3 of it D, and the bilinear resample of D back to the tile.
// Nothing of branch resolution goes to device memory for the up scales.
// Resampling uses the (index, weight) form of the JAX package's own
// interpolation and adaptive-average matrices.
//
// The fused tail (its own section below) composes each branch into banded
// operators at source resolution instead, which the TPU kernel applies as
// dense matrix products; it shares the down scales' pre-pass.  Both keep all
// arithmetic in f32 and round each output once to the output dtype.
#include "common.cuh"

#define MAX_S 8
#define MAX_P 16
#define TH 16
#define TW 32
#define NT (TH * TW)

enum { KIND_ID = 0, KIND_UP = 1, KIND_DOWN = 2 };

struct Scale {
  int kind, hs, ws;
  const int* to_hi;  const float* to_hw;  // [hs, 2]: UP taps, DOWN [lo, hi) bins
  const int* to_wi;  const float* to_ww;  // [ws, 2]
  const int* bk_hi;  const float* bk_hw;  // [H, 2]: bilinear taps back
  const int* bk_wi;  const float* bk_ww;  // [W, 2]
  const float* rg;   // DOWN: the resampled planes [B*P, hs, ws] (f32)
};

struct PyrArgs {
  const void* x;        // [B, P, H, W]
  void* out;            // branches [B, S*P, H, W]
  const float* taps;    // depthwise taps [S, 3, 3, P]
  Scale sc[MAX_S];
  int b, p, h, w, s_n;
  int tiles_x;
  int r_cap, d_cap;     // shared-memory floats of one channel's R and D
  int g;                // channels staged together
};

template <typename S>
__device__ __forceinline__ float dw3x3(const S* __restrict__ src, int h, int w,
                                       int y, int x, const float tk[9]) {
  float acc = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int yy = y + ky - 1;
    if (yy < 0 || yy >= h) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int xx = x + kx - 1;
      if (xx < 0 || xx >= w) continue;
      acc += tk[ky * 3 + kx] * to_f32(src[yy * w + xx]);
    }
  }
  return acc;
}

// The two (index, weight) taps of row i of a packed resample table.
struct Taps {
  int a, b;
  float wa, wb;
};

__device__ __forceinline__ Taps taps_at(const int* idx, const float* wgt,
                                        int i) {
  return {idx[2 * i], idx[2 * i + 1], wgt[2 * i], wgt[2 * i + 1]};
}

// Scale s's branch of channels c0 .. c0+nc-1 of one image at the tile
// (y0, x0) and its halo, into bv[g * BH*BW + i]: back(dw3x3(to(plane))),
// with channel c's affine + PReLU from aff1 (concat channel si*P + c) when
// aff1 is given, and 0 outside the image.  The group's depthwise taps are
// staged in s_tk; the R and D regions of channel g sit at g * r_cap and
// g * d_cap.  Every loop runs over positions and, inside, over the group's
// channels, so a position's index arithmetic and resample taps are worked
// out once for all of them.  Ends synchronized.
template <typename T, int HALO>
__device__ void branch_group(const T* __restrict__ img, int64_t plane0,
                             int c0, int nc, int si, int p, const Scale& s,
                             const float* __restrict__ taps, float* s_tk,
                             int y0, int x0, int h, int w, float* bv,
                             float* sr, int r_cap, float* sd, int d_cap,
                             const float* aff1, int sp_n, int tid) {
  constexpr int BH = TH + 2 * HALO, BW = TW + 2 * HALO, BN = BH * BW;
  const int64_t hw = (int64_t)h * w;
  const T* src = img + c0 * hw;
  for (int k = tid; k < nc * 9; k += NT)
    s_tk[k] = taps[(si * 9 + k % 9) * p + c0 + k / 9];
  if (s.kind == KIND_ID) {
    __syncthreads();
    for (int j = tid; j < BN; j += NT) {
      const int gy = y0 - HALO + j / BW, gx = x0 - HALO + j % BW;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      for (int g = 0; g < nc; ++g) {
        float v = 0.f;
        if (in) {
          v = dw3x3(src + g * hw, h, w, gy, gx, s_tk + g * 9);
          if (aff1) {
            const int ch = si * p + c0 + g;
            v = prelu(v * aff1[ch] + aff1[sp_n + ch], aff1[2 * sp_n + ch]);
          }
        }
        bv[g * BN + j] = v;
      }
    }
    __syncthreads();
    return;
  }
  // the branch-resolution footprint of the region's in-image pixels (the
  // tap tables are monotone, so the end rows/columns bound it)
  const int oy0 = max(y0 - HALO, 0), oy1 = min(y0 + TH - 1 + HALO, h - 1);
  const int ox0 = max(x0 - HALO, 0), ox1 = min(x0 + TW - 1 + HALO, w - 1);
  const int dy0 = s.bk_hi[2 * oy0], dy1 = s.bk_hi[2 * oy1 + 1];
  const int dx0 = s.bk_wi[2 * ox0], dx1 = s.bk_wi[2 * ox1 + 1];
  const int ry0 = max(dy0 - 1, 0), ry1 = min(dy1 + 1, s.hs - 1);
  const int rx0 = max(dx0 - 1, 0), rx1 = min(dx1 + 1, s.ws - 1);
  const int rw = rx1 - rx0 + 1, rn = (ry1 - ry0 + 1) * rw;
  for (int j = tid; j < rn; j += NT) {
    const int ry = ry0 + j / rw, rx = rx0 + j % rw;
    if (s.kind == KIND_UP) {
      // bilinear up-resample at branch position (ry, rx), H first
      const Taps ty = taps_at(s.to_hi, s.to_hw, ry);
      const Taps tx = taps_at(s.to_wi, s.to_ww, rx);
      for (int g = 0; g < nc; ++g) {
        const T* x = src + g * hw;
        const float ca = ty.wa * to_f32(x[ty.a * w + tx.a]) +
                         ty.wb * to_f32(x[ty.b * w + tx.a]);
        const float cb = ty.wa * to_f32(x[ty.a * w + tx.b]) +
                         ty.wb * to_f32(x[ty.b * w + tx.b]);
        sr[g * r_cap + j] = tx.wa * ca + tx.wb * cb;
      }
    } else {
      const float* rg = s.rg + ((plane0 + c0) * s.hs + ry) * s.ws + rx;
      for (int g = 0; g < nc; ++g) sr[g * r_cap + j] = rg[(int64_t)g * s.hs * s.ws];
    }
  }
  __syncthreads();
  const int dwid = dx1 - dx0 + 1, dn = (dy1 - dy0 + 1) * dwid;
  for (int j = tid; j < dn; j += NT) {
    const int gy = dy0 + j / dwid, gx = dx0 + j % dwid;
    // the 3x3 window's top-left in R, and which of its rows and columns
    // lie inside the branch plane (zero 'same' padding)
    const int r0 = (gy - 1 - ry0) * rw + (gx - 1 - rx0);
    bool vy[3], vx[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      vy[k] = gy + k - 1 >= 0 && gy + k - 1 < s.hs;
      vx[k] = gx + k - 1 >= 0 && gx + k - 1 < s.ws;
    }
    for (int g = 0; g < nc; ++g) {
      const float* r = sr + g * r_cap + r0;
      const float* tk = s_tk + g * 9;
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        if (!vy[ky]) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          if (vx[kx]) acc += tk[ky * 3 + kx] * r[ky * rw + kx];
      }
      sd[g * d_cap + j] = acc;
    }
  }
  __syncthreads();
  for (int j = tid; j < BN; j += NT) {
    const int gy = y0 - HALO + j / BW, gx = x0 - HALO + j % BW;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    Taps ty = {0, 0, 0.f, 0.f}, tx = ty;
    if (in) {
      ty = taps_at(s.bk_hi, s.bk_hw, gy);
      tx = taps_at(s.bk_wi, s.bk_ww, gx);
    }
    const int ya = (ty.a - dy0) * dwid, yb = (ty.b - dy0) * dwid;
    const int xa = tx.a - dx0, xb = tx.b - dx0;
    for (int g = 0; g < nc; ++g) {
      float v = 0.f;
      if (in) {
        const float* d = sd + g * d_cap;
        v = tx.wa * (ty.wa * d[ya + xa] + ty.wb * d[yb + xa]) +
            tx.wb * (ty.wa * d[ya + xb] + ty.wb * d[yb + xb]);
        if (aff1) {
          const int ch = si * p + c0 + g;
          v = prelu(v * aff1[ch] + aff1[sp_n + ch], aff1[2 * sp_n + ch]);
        }
      }
      bv[g * BN + j] = v;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void load_scales(const PyrArgs& a, Scale* s_sc,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < MAX_S; ++i)
    if (tid == i) s_sc[i] = a.sc[i];
}

// Branch stack: grid (tiles, B); channels are staged a.g at a time; out
// [B, S*P, H, W].
template <typename T>
__global__ void __launch_bounds__(NT) pyr_branches_kernel(PyrArgs a) {
  extern __shared__ float smem[];
  __shared__ Scale s_sc[MAX_S];
  const int tid = threadIdx.y * TW + threadIdx.x;
  load_scales(a, s_sc, tid);
  __syncthreads();
  const int p = a.p, G = a.g;
  float* s_tk = smem;
  float* bv = s_tk + 9 * G;
  float* sr = bv + G * NT;
  float* sd = sr + G * a.r_cap;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / a.tiles_x) * TH, x0 = (blockIdx.x % a.tiles_x) * TW;
  const int oy = y0 + threadIdx.y, ox = x0 + threadIdx.x;
  const bool valid = oy < a.h && ox < a.w;
  const int64_t hw = (int64_t)a.h * a.w;
  const int64_t plane0 = (int64_t)b * p;
  const T* img = reinterpret_cast<const T*>(a.x) + plane0 * hw;
  T* out = reinterpret_cast<T*>(a.out) + (int64_t)b * a.s_n * p * hw +
           (int64_t)oy * a.w + ox;
  for (int si = 0; si < a.s_n; ++si) {
    for (int c0 = 0; c0 < p; c0 += G) {
      const int nc = min(G, p - c0);
      // the next group writes bv only after a barrier that every thread
      // reaches after its stores below
      branch_group<T, 0>(img, plane0, c0, nc, si, p, s_sc[si], a.taps, s_tk,
                         y0, x0, a.h, a.w, bv, sr, a.r_cap, sd, a.d_cap,
                         nullptr, 0, tid);
      if (valid)
        for (int g = 0; g < nc; ++g)
          out[(int64_t)(si * p + c0 + g) * hw] = from_f32<T>(bv[g * NT + tid]);
    }
  }
}

// Adaptive-average resample of every [H, W] plane to [hs, ws] (f32), the
// down scales' pre-pass: one thread per branch-resolution element.
template <typename T>
__global__ void __launch_bounds__(256)
down_scale_kernel(const T* __restrict__ x, float* __restrict__ r,
                  int64_t total, int h, int w, int hs, int ws,
                  const int* __restrict__ hidx, const float* __restrict__ hwgt,
                  const int* __restrict__ widx, const float* __restrict__ wwgt) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int rx = (int)(i % ws);
  const int64_t t = i / ws;
  const int ry = (int)(t % hs);
  const T* src = x + (t / hs) * h * w;
  const int ylo = hidx[2 * ry], yhi = hidx[2 * ry + 1];
  const int xlo = widx[2 * rx], xhi = widx[2 * rx + 1];
  const float wy = hwgt[2 * ry], wx = wwgt[2 * rx];
  float v = 0.f;
  for (int xx = xlo; xx < xhi; ++xx) {
    float col = 0.f;
    for (int yy = ylo; yy < yhi; ++yy) col += wy * to_f32(src[yy * w + xx]);
    v += wx * col;
  }
  r[i] = v;
}

// Fill the scale table from the packed host tables: per non-identity scale,
// in order, the to-scale H and W tables then the back H and W tables, two
// entries per row; launch the down scales' pre-pass into `scratch`.
template <typename T>
static int prepare(PyrArgs& a, const int* kinds, const int* hs, const int* ws,
                   const int* itab, const float* ftab, float* const* scratch,
                   cudaStream_t st) {
  int64_t off = 0;
  for (int si = 0; si < a.s_n; ++si) {
    Scale& s = a.sc[si];
    s.kind = kinds[si];
    s.hs = hs[si];
    s.ws = ws[si];
    s.rg = nullptr;
    if (s.kind == KIND_ID) continue;
    s.to_hi = itab + off;            s.to_hw = ftab + off;
    s.to_wi = s.to_hi + 2 * s.hs;    s.to_ww = s.to_hw + 2 * s.hs;
    s.bk_hi = s.to_wi + 2 * s.ws;    s.bk_hw = s.to_ww + 2 * s.ws;
    s.bk_wi = s.bk_hi + 2 * a.h;     s.bk_ww = s.bk_hw + 2 * a.h;
    off += 2 * ((int64_t)s.hs + s.ws + a.h + a.w);
    if (s.kind == KIND_DOWN) {
      s.rg = scratch[si];
      const int64_t n = (int64_t)a.b * a.p * s.hs * s.ws;
      down_scale_kernel<T><<<mspl_blocks(n, 256), 256, 0, st>>>(
          reinterpret_cast<const T*>(a.x), scratch[si], n, a.h, a.w, s.hs,
          s.ws, s.to_hi, s.to_hw, s.to_wi, s.to_ww);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

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

template <typename K>
static int launch(K kernel, dim3 grid, size_t smem, cudaStream_t st,
                  const PyrArgs& a) {
  const cudaError_t e = launch_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, dim3(TW, TH), smem, st>>>(a);
  return (int)cudaGetLastError();
}

// x [B, P, H, W] (dtype), taps [S, 3, 3, P] f32 -> out [B, S*P, H, W]
// (dtype).  kinds/hs/ws/scratch are host arrays of length S (scratch holds
// a [B*P, hs, ws] f32 buffer for each down scale); r_cap/d_cap bound the
// shared-memory R and D regions of one channel in any tile, and g channels
// are staged together (both computed by the wrapper).
extern "C" int pyr_branches_launch(const void* x, int dtype, int b, int p,
                                   int h, int w, int s_n, const int* kinds,
                                   const int* hs, const int* ws,
                                   const int* itab, const float* ftab,
                                   const float* taps, int g,
                                   void* const* scratch, int r_cap, int d_cap,
                                   void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if ((int64_t)b * p * h * w == 0) return (int)cudaGetLastError();
  if (s_n > MAX_S || g < 1) return (int)cudaErrorInvalidValue;
  PyrArgs a = {};
  a.x = x; a.out = out; a.taps = taps;
  a.b = b; a.p = p; a.h = h; a.w = w; a.s_n = s_n;
  a.tiles_x = (w + TW - 1) / TW;
  a.r_cap = r_cap; a.d_cap = d_cap; a.g = g;
  float* const* scr = reinterpret_cast<float* const*>(scratch);
  const dim3 grid(a.tiles_x * ((h + TH - 1) / TH), b);
  const size_t smem = sizeof(float) * (size_t)g * (9 + NT + r_cap + d_cap);
  int e;
  if (dtype == MSPL_BF16) {
    if ((e = prepare<__nv_bfloat16>(a, kinds, hs, ws, itab, ftab, scr, st))) return e;
    return launch(pyr_branches_kernel<__nv_bfloat16>, grid, smem, st, a);
  }
  if ((e = prepare<float>(a, kinds, hs, ws, itab, ftab, scr, st))) return e;
  return launch(pyr_branches_kernel<float>, grid, smem, st, a);
}

// ---------------------------------------------------------------------------
// Fused tail: every branch as composed banded operators at source resolution
// ---------------------------------------------------------------------------
//
// A branch is resample -> depthwise 3x3 (zero 'same' padding) -> resample
// back.  For the identity and up scales it is exactly
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
// staged.  A down scale's plane is small (64x120 and 13x24 at the main
// path), so two pre-passes compute its adaptive average and the depthwise
// 3x3 of that at branch resolution, and the tail applies the bilinear
// resample back alone, a 2 x 2 stencil.
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
  const int* hb;            // down scales: adaptive-average bins [hs, 2]
  const float* hbw;         // ([lo, hi) and weight) of the rows
  const int* wb;            // and [ws, 2] of the columns
  const float* wbw;
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

// The tail's pre-pass: for every down scale, the adaptive average of each
// [H, W] plane to [hs, ws] (H bins first, then W, as the plain version
// multiplies) and the depthwise 3x3 of that (zero 'same' padding, channel
// c's taps), into the scale's D planes [B*P, hs, ws] (f32).  A block takes
// one plane and every down scale in turn: each warp pools whole rows (the
// lanes read x's rows coalesced, the H bin's sum kept in a per-warp row,
// then the row's W bins), the block holds the pooled plane in shared
// memory, then writes its depthwise 3x3.  `pool` (floats) holds the
// largest pooled plane.
#define PP_WARPS 8
template <typename T>
__global__ void __launch_bounds__(PP_WARPS * 32)
down_prepass_kernel(const __grid_constant__ TailArgs a, int pool) {
  extern __shared__ float sm[];
  float* pooled = sm;                            // [hs][ws]
  float* row = sm + pool + (threadIdx.x / 32) * a.w;  // this warp's H sums
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t plane = blockIdx.x;
  const int c = (int)(plane % a.p);
  const T* src = reinterpret_cast<const T*>(a.x) + plane * a.h * a.w;
  for (int si = 0; si < a.s_n; ++si) {
    const BandScale& s = a.sc[si];
    if (!s.rg) continue;
    const int hs = s.src_h, ws = s.src_w;
    for (int r = warp; r < hs; r += PP_WARPS) {
      const int y0 = s.hb[2 * r], y1 = s.hb[2 * r + 1];
      const float wy = s.hbw[2 * r];
      // eight columns a lane at a time, their loads in flight together
      for (int x0 = lane; x0 < a.w; x0 += 8 * 32) {
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
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
    const float* tk = a.taps + si * 9 * a.p + c;
    float* d = const_cast<float*>(s.rg) + plane * hs * ws;
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
    __syncthreads();  // before the next scale overwrites the pooled plane
  }
}

template <typename T, int KMAX>
static int tail_typed(const TailArgs& t, int n_down, int pool, size_t smem,
                      cudaStream_t st) {
  cudaError_t e;
  if (n_down) {
    const size_t pre = sizeof(float) * ((size_t)pool + PP_WARPS * t.w);
    if ((e = launch_smem(down_prepass_kernel<T>, pre)) != cudaSuccess)
      return (int)e;
    down_prepass_kernel<T><<<t.b * t.p, PP_WARPS * 32, pre, st>>>(t, pool);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const dim3 grid(t.tiles_x * ((t.h + BTH - 1) / BTH), t.b);
  if ((e = launch_smem(pyr_tail_kernel<T, KMAX>, smem)) != cudaSuccess)
    return (int)e;
  pyr_tail_kernel<T, KMAX><<<grid, dim3(BBW, BTH), smem, st>>>(t);
  return (int)cudaGetLastError();
}

// x [B, P, H, W] (dtype), taps [S, 3, 3, P] f32, params f32 packed as
// [aff1 (3,S*P) | merge (3,3,S,P) | aff2 (3,P) | cls_w (P,O) | cls_b (O) |
//  aff3 (3,O)] -> out [B, O, H, W] (dtype); P <= 16.  kinds/hs/ws/itab/
// ftab as for pyr_branches_launch (the down scales' adaptive-average bins
// are read from them); scratch holds a [B*P, hs, ws] f32 buffer for each
// down scale, which the pre-pass fills with its depthwise planes; band_k
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
  int n_down = 0, kmax = 0, pool = 0;
  int64_t off = 0;  // a non-identity scale's tables in itab/ftab (prepare)
  for (int si = 0; si < s_n; ++si) {
    BandScale& s = t.sc[si];
    s.k = band_k[si];
    const bool down = kinds[si] == KIND_DOWN;
    if (down ? s.k != 2 : s.k != 3 && s.k != 4 && s.k != 6)
      return (int)cudaErrorInvalidValue;
    s.src_h = down ? hs[si] : h;
    s.src_w = down ? ws[si] : w;
    if (down) {
      s.hb = itab + off;            s.hbw = ftab + off;
      s.wb = s.hb + 2 * hs[si];     s.wbw = s.hbw + 2 * hs[si];
      s.rg = reinterpret_cast<float*>(scratch[si]);
      ++n_down;
      if (hs[si] * ws[si] > pool) pool = hs[si] * ws[si];
    } else if (s.k > kmax) {
      kmax = s.k;
    }
    if (kinds[si] != KIND_ID) off += 2 * ((int64_t)hs[si] + ws[si] + h + w);
  }
  const size_t smem = sizeof(float) *
      ((size_t)((3 * s_n * p + 3 * p + 3) & ~3) +
       ((9 * s_n * p + 3) & ~3) + 12 * s_n * p +
       (size_t)o_n * (((p + 3) & ~3) + 4) + (size_t)p * BNT + tile_f +
       tile_i +
       (size_t)g * (x_cap + (size_t)n_down * d_cap + 2 * BBH * BBW));
  if (dtype == MSPL_BF16)
    return kmax > 4 ? tail_typed<__nv_bfloat16, 6>(t, n_down, pool, smem, st)
                    : tail_typed<__nv_bfloat16, 4>(t, n_down, pool, smem, st);
  return kmax > 4 ? tail_typed<float, 6>(t, n_down, pool, smem, st)
                  : tail_typed<float, 4>(t, n_down, pool, smem, st);
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
