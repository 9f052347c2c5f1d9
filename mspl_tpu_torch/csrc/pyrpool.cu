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
// Design: the output is cut into 16x32 tiles, one block of 512 threads per
// tile and image, which takes the channels in groups of as many as shared
// memory holds.  The kernels are bound by their instruction count, so each
// staging loop works out a position's indices and resample taps once for
// the whole group.  For each scale the block
// stages in shared memory only the part of the branch-resolution plane its
// tile needs: the resampled plane R (computed from x through L1 for the up
// scales; read from a small global scratch for the down scales, which a
// pre-pass fills once per plane because an adaptive-average bin can span
// ~10x10 inputs), the depthwise 3x3 of it D, and the bilinear resample of D
// back to the tile.  Nothing of branch resolution goes to device memory for
// the up scales.  The fused tail keeps a one-pixel halo of each branch after
// its BN-affine + PReLU (zero outside the image: the merge conv pads the
// post-PReLU tensor), sums the merge taps of channel p's S branches, applies
// the merge affine + PReLU, and accumulates all O classifier outputs in
// registers across the P channels.  Resampling uses the (index, weight) form
// of the JAX package's own interpolation and adaptive-average matrices.  All
// arithmetic is f32; each output is rounded once to the output dtype.
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
  void* out;            // branches [B, S*P, H, W] or logits [B, O, H, W]
  const float* taps;    // depthwise taps [S, 3, 3, P]
  const float* params;  // tail: aff1 (3,S*P) | merge (3,3,S,P) | aff2 (3,P)
                        //       | cls_w (P,O) | cls_b (O) | aff3 (3,O)
  Scale sc[MAX_S];
  int b, p, h, w, s_n, o_n;
  int tiles_x;
  int r_cap, d_cap;     // shared-memory floats of one channel's R and D
  int g;                // tail: channels staged together
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

// Fused tail: grid (tiles, B); out [B, O, H, W].  Channels are staged a.g
// at a time; each thread keeps its pixel's P merge sums in registers.
template <typename T>
__global__ void __launch_bounds__(NT) pyr_tail_kernel(PyrArgs a) {
  constexpr int BW = TW + 2, BN = (TH + 2) * BW;
  extern __shared__ float smem[];
  __shared__ Scale s_sc[MAX_S];
  const int tid = threadIdx.y * TW + threadIdx.x;
  load_scales(a, s_sc, tid);
  const int p = a.p, s_n = a.s_n, o_n = a.o_n, sp_n = s_n * p, G = a.g;
  const int n_params = 12 * sp_n + 3 * p + p * o_n + 4 * o_n;
  float* par = smem;
  for (int k = tid; k < n_params; k += NT) par[k] = a.params[k];
  float* s_tk = par + n_params;
  float* bv = s_tk + 9 * G;
  float* sr = bv + G * BN;
  float* sd = sr + G * a.r_cap;
  __syncthreads();
  const float* aff1 = par;               // [3, S*P]
  const float* mw = aff1 + 3 * sp_n;     // [3, 3, S, P]
  const float* aff2 = mw + 9 * sp_n;     // [3, P]
  const float* clsw = aff2 + 3 * p;      // [P, O]
  const float* clsb = clsw + p * o_n;    // [O]
  const float* aff3 = clsb + o_n;        // [3, O]

  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / a.tiles_x) * TH, x0 = (blockIdx.x % a.tiles_x) * TW;
  const int oy = y0 + threadIdx.y, ox = x0 + threadIdx.x;
  const bool valid = oy < a.h && ox < a.w;
  const int64_t hw = (int64_t)a.h * a.w;
  const int64_t plane0 = (int64_t)b * p;
  const T* img = reinterpret_cast<const T*>(a.x) + plane0 * hw;
  float merged[MAX_P];
#pragma unroll
  for (int c = 0; c < MAX_P; ++c) merged[c] = 0.f;

  for (int si = 0; si < s_n; ++si) {
    for (int c0 = 0; c0 < p; c0 += G) {
      const int nc = min(G, p - c0);
      // the next group writes bv only after a barrier that every thread
      // reaches after its merge reads below
      branch_group<T, 1>(img, plane0, c0, nc, si, p, s_sc[si], a.taps, s_tk,
                         y0, x0, a.h, a.w, bv, sr, a.r_cap, sd, a.d_cap,
                         aff1, sp_n, tid);
      if (!valid) continue;
#pragma unroll
      for (int c = 0; c < MAX_P; ++c) {
        if (c < c0 || c >= c0 + nc) continue;
        const float* v = bv + (c - c0) * BN;
        float part = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            part += mw[((ky * 3 + kx) * s_n + si) * p + c] *
                    v[(threadIdx.y + ky) * BW + threadIdx.x + kx];
        merged[c] += part;
      }
    }
  }
  if (!valid) return;
#pragma unroll
  for (int c = 0; c < MAX_P; ++c)
    if (c < p)
      merged[c] = prelu(merged[c] * aff2[c] + aff2[p + c], aff2[2 * p + c]);
  T* out = reinterpret_cast<T*>(a.out);
  for (int o = 0; o < o_n; ++o) {
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_P; ++c)
      if (c < p) v += merged[c] * clsw[c * o_n + o];
    v += clsb[o];
    out[((int64_t)b * o_n + o) * hw + (int64_t)oy * a.w + ox] =
        from_f32<T>(prelu(v * aff3[o] + aff3[o_n + o], aff3[2 * o_n + o]));
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

template <typename K>
static int launch(K kernel, dim3 grid, size_t smem, cudaStream_t st,
                  const PyrArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, dim3(TW, TH), smem, st>>>(a);
  return (int)cudaGetLastError();
}

static PyrArgs make_args(const void* x, void* out, const float* taps,
                         const float* params, int b, int p, int h, int w,
                         int s_n, int o_n, int r_cap, int d_cap, int g) {
  PyrArgs a = {};
  a.g = g;
  a.x = x; a.out = out; a.taps = taps; a.params = params;
  a.b = b; a.p = p; a.h = h; a.w = w; a.s_n = s_n; a.o_n = o_n;
  a.tiles_x = (w + TW - 1) / TW;
  a.r_cap = r_cap; a.d_cap = d_cap;
  return a;
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
  PyrArgs a = make_args(x, out, taps, nullptr, b, p, h, w, s_n, 0, r_cap, d_cap, g);
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

template <typename T>
static int tail_typed(PyrArgs& a, const int* kinds, const int* hs,
                      const int* ws, const int* itab, const float* ftab,
                      float* const* scr, cudaStream_t st) {
  const int e = prepare<T>(a, kinds, hs, ws, itab, ftab, scr, st);
  if (e) return e;
  const dim3 grid(a.tiles_x * ((a.h + TH - 1) / TH), a.b);
  const int sp_n = a.s_n * a.p;
  const size_t smem = sizeof(float) *
      ((size_t)12 * sp_n + 3 * a.p + a.p * a.o_n + 4 * a.o_n +
       (size_t)a.g * (9 + (TH + 2) * (TW + 2) + a.r_cap + a.d_cap));
  return launch(pyr_tail_kernel<T>, grid, smem, st, a);
}

// x [B, P, H, W] (dtype), taps [S, 3, 3, P] f32, params f32 packed as
// [aff1 (3,S*P) | merge (3,3,S,P) | aff2 (3,P) | cls_w (P,O) | cls_b (O) |
//  aff3 (3,O)] -> out [B, O, H, W] (dtype); P <= 16.  g channels are
// staged in shared memory together (the wrapper sizes it).  Other arguments
// as for pyr_branches_launch.
extern "C" int pyr_tail_launch(const void* x, int dtype, int b, int p, int h,
                               int w, int s_n, const int* kinds, const int* hs,
                               const int* ws, const int* itab,
                               const float* ftab, const float* taps,
                               const float* params, int o_n, int g,
                               void* const* scratch, int r_cap, int d_cap,
                               void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if ((int64_t)b * h * w == 0) return (int)cudaGetLastError();
  if (s_n > MAX_S || p > MAX_P || g < 1) return (int)cudaErrorInvalidValue;
  PyrArgs a = make_args(x, out, taps, params, b, p, h, w, s_n, o_n, r_cap, d_cap, g);
  float* const* scr = reinterpret_cast<float* const*>(scratch);
  if (dtype == MSPL_BF16)
    return tail_typed<__nv_bfloat16>(a, kinds, hs, ws, itab, ftab, scr, st);
  return tail_typed<float>(a, kinds, hs, ws, itab, ftab, scr, st);
}
