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
// and output ~0.1-0.25 GB; the function's bound is its f32 work
// (chip_smoke.py stage_work).  What holds this kernel back is latency, not
// a rate: one 16-warp block an SM (its shared memory is mostly y) runs
// phases split by block barriers, each a chain of dependent loads with few
// warps to hide them.  In trials that leave one phase out
// (tools/torch_stage_breakdown.py --skip; PERF.md) the scalar f32 taps
// take about half the time and the expand's products and epilogue most of
// the rest.
//
// Numerics: the port computes in f32 and rounds only the proj output and
// each unit's output (the TPU kernel rounds every dot's operands and
// result to bf16; the port does not copy that).  The products run on the
// tensor cores all the same, as split bf16: each operand a is held as
// hi = bf16(a) and lo = bf16(a - hi), and a product is hi.hi + lo.hi +
// hi.lo with f32 accumulation (the dropped lo.lo and the split's own
// rounding are ~2^-17 relative, under the f32 checks and far under one
// bf16 rounding of the output).  A bf16 input has lo = 0, so the main
// path's proj takes two passes and the expand three; the split triples
// the tensor work (~2.8x the function's products), still far under the
// f32 FMAs it replaces.  The weights' hi and lo are packed on the host,
// output-major and zero-padded to 16x16 tiles per group; the activations
// are split as they are staged into shared memory.
//
// Design: one image plane of a stage does not fit a block's 227 KB of
// shared memory (level3 is 983 KB in bf16), and the dilated taps need a
// halo of max(d) rows of the proj output.  So a block takes one image and a
// band of `th` full-width output rows, and recomputes the proj over the
// band plus its halo rows, keeping the proj output y in shared memory in
// the working dtype (the point where this kernel and the plain version
// round).  Where not even one full-width row band fits (planes of 128
// columns and more in f32, 256 in bf16: a 512x1024 image's level3 and
// level4), a block takes th x tw outputs (grid z: column bands) and its
// halo band carries dmax columns each side too; the wrapper's `_tiling`
// picks the bands, full width wherever that fits.  Shared memory: [z hi | z lo] bf16 [zrows][pc + 8] | one 16x16
// f32 scratch tile a warp | y [n][ys_cap] in the working dtype.
//  1. proj: the halo band is taken in windows of `pp` pixels; each window
//     of x is staged (16-byte loads where aligned) into the z region as
//     bf16 hi (and lo for f32), a group's input rows padded to a multiple
//     of 16 with zeros; warp products (nvcuda::wmma m16n16k16, bf16 in,
//     f32 accumulators) of 16 output channels by up to NB pixel tiles, A
//     read from the packed weights through L1/L2; each accumulator tile
//     goes through the warp's scratch for bias, PReLU and the rounding
//     into y.
//  2. taps: the band's output pixels in chunks of `pc` (a multiple of 16):
//     each chunk's K*n branch values with their HFF sums, the BR affine
//     and PReLU in f32 (zero padding of y is an explicit bounds test, so
//     dilations that reach past a tiny plane read exact zeros), stored as z
//     hi and lo, zeros past the band's last pixel.
//  3. expand: warp products of the chunk's z as in 1, then bias, the
//     residual (read from the unit's input) and PReLU, one rounding an
//     output.
// The rows of z past a group's true width are zeroed once after the proj
// (zeros, not stale values: the padded weights are 0, and 0 x NaN = NaN).
// What is left: the tap phase (its arithmetic unchanged here) and
// occupancy (more warps an SM), then mma.sync with ldmatrix in place of
// wmma if the scratch round trip of the epilogues still shows.  The
// arguments are __grid_constant__, so the dilations indexed at run time
// are read in place, not copied to local memory.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

#define MAX_K 8
#define NT 512
#define NWARP (NT / 32)
#define NB 4         // pixel tiles of 16 a warp task keeps in accumulators
#define LD_PAD 8     // bf16 elements past each staged row (a 16-byte skew)
#define SU 4         // staged 8-pixel items a thread loads, then stores
// Trial builds only (tools/torch_stage_breakdown.py --skip): leave out the
// proj's staging (1), the proj's products and epilogue (2), the taps (4),
// the expand's products and epilogue (8).  The output is then wrong.
#ifndef EESP_SKIP
#define EESP_SKIP 0
#endif

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct StageArgs {
  const void* x;     // unit input [B, C, H, W]
  void* out;         // unit output [B, C, H, W] (not x)
  const float* prm;  // pb [n] | pa [n] | taps [K*9, n] | ca [C] | cb [C]
                     // | cal [C] | eb [C] | alpha [C]
  const bf16* mma;   // proj A hi | lo [g_proj][pad16(n/g)][pad16(C/g)],
                     // expand A hi | lo [K][pad16(n)][pad16(n)] (grouped)
                     // or [1][pad16(C)][pad16(C)] (dense)
  int b, c, n, k, h, w;
  int g_proj;        // proj groups
  int grouped;       // expand: 1 = per-branch n -> n, 0 = dense C -> C
  int th;            // output rows per block
  int tw;            // output columns per block (W: full-width bands)
  int pc;            // output pixels per chunk (a multiple of 16)
  int pp;            // halo-band pixels per proj window (a multiple of 16)
  int ys_cap;        // pixels per channel of the staged proj output
  int zrows;         // rows of the z region
  int dmax;
  int dil[MAX_K];
};

__host__ __device__ __forceinline__ int pad16(int v) { return (v + 15) & ~15; }

// One product phase on the tensor cores: for each of ng groups, out [mp x
// 16 nt] = A [mp x kp] . B [kp x 16 nt], A (hi, lo) [ng][mp][kp] in global
// memory, B (hi, lo) group g's rows at g * kp of [.][ldb] in shared memory,
// all padded to 16.  Split bf16: lo.hi (+ hi.lo when B has a lo part) +
// hi.hi, accumulated in f32 by m16n16k16 warp products.  A warp task is up
// to MB M tiles of one group (sharing each B fragment) by up to NBT pixel
// tiles (sharing each A fragment).  Each accumulator tile is read back
// through the warp's 16x16 f32 scratch `scr` (its register layout is
// opaque): f(g, row0, pixel0, v) then gets the tile's origin and the
// lane's 8 values, v[u] at row row0 + lane / 16 + 2u, pixel pixel0 + lane
// % 16, so it can issue all 8 of a lane's global loads before its stores.
template <int MB, int NBT, bool BLO, typename F>
__device__ __forceinline__ void product_phase(
    int ng, int mp, int kp, int nt, const bf16* a_hi, const bf16* a_lo,
    const bf16* b_hi, const bf16* b_lo, int ldb, float* scr, F f) {
  const int mtg = mp / 16, mb = min(MB, mtg);
  // as many pixel tiles a task as spread the tiles over the block's warps
  const int nb = MB > 1 ? min(nt, NBT)
      : max(1, min(min((ng * mtg * nt + NWARP - 1) / NWARP, nt), NBT));
  const int mblk = (mtg + mb - 1) / mb, nblk = (nt + nb - 1) / nb;
  const int lane = threadIdx.x & 31;
  for (int task = threadIdx.x >> 5; task < ng * mblk * nblk; task += NWARP) {
    const int g = task / (mblk * nblk), rem = task - g * mblk * nblk;
    const int mi0 = (rem / nblk) * mb, t0 = (rem % nblk) * nb;
    const int cm = min(mb, mtg - mi0), cn = min(nb, nt - t0);
    const bf16* ah_g = a_hi + ((size_t)g * mp + mi0 * 16) * kp;
    const bf16* al_g = a_lo + ((size_t)g * mp + mi0 * 16) * kp;
    const size_t bo = (size_t)g * kp * ldb + t0 * 16;
    FragC acc[MB][NBT];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < NBT; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < kp; k0 += 16) {
      FragA ah[MB], al[MB];
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        if (i < cm) {
          wmma::load_matrix_sync(ah[i], ah_g + (size_t)i * 16 * kp + k0, kp);
          wmma::load_matrix_sync(al[i], al_g + (size_t)i * 16 * kp + k0, kp);
        }
      }
#pragma unroll
      for (int j = 0; j < NBT; ++j) {
        if (j < cn) {
          const size_t off = bo + (size_t)k0 * ldb + j * 16;
          FragB bh, bl;
          wmma::load_matrix_sync(bh, b_hi + off, ldb);
          if constexpr (BLO) wmma::load_matrix_sync(bl, b_lo + off, ldb);
#pragma unroll
          for (int i = 0; i < MB; ++i) {
            if (i < cm) {
              wmma::mma_sync(acc[i][j], al[i], bh, acc[i][j]);
              if constexpr (BLO)
                wmma::mma_sync(acc[i][j], ah[i], bl, acc[i][j]);
              wmma::mma_sync(acc[i][j], ah[i], bh, acc[i][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MB; ++i) {
#pragma unroll
      for (int j = 0; j < NBT; ++j) {
        if (i < cm && j < cn) {
          wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
          __syncwarp();
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = scr[lane + 32 * u];
          __syncwarp();
          f(g, (mi0 + i) * 16, (t0 + j) * 16, v);
        }
      }
    }
  }
}

// Narrow chunks (at most 2 pixel tiles) share B over 2 M tiles; wider ones
// share A over up to 4 pixel tiles.
template <bool BLO, typename F>
__device__ __forceinline__ void products(
    int ng, int mp, int kp, int nt, const bf16* a_hi, const bf16* a_lo,
    const bf16* b_hi, const bf16* b_lo, int ldb, float* scr, F f) {
  if (nt <= 2 && mp >= 32)
    product_phase<2, 2, BLO>(ng, mp, kp, nt, a_hi, a_lo, b_hi, b_lo, ldb, scr,
                             f);
  else
    product_phase<1, NB, BLO>(ng, mp, kp, nt, a_hi, a_lo, b_hi, b_lo, ldb,
                              scr, f);
}

// 8 consecutive values of T, as loaded: one 16-byte word of bf16, two of
// f32.
template <typename T>
union Pix8 {
  static constexpr int NQ = sizeof(T) / 2;
  uint4 q[NQ];
  T t[8];
};

__device__ __forceinline__ void split_store(bf16* hi, bf16* lo, float v) {
  const bf16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
eesp_unit_kernel(const __grid_constant__ StageArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool SPLIT_X = sizeof(T) == 4;  // an f32 input has a lo part
  const int C = a.c, n = a.n, K = a.k, W = a.w, H = a.h;
  const int ldz = a.pc + LD_PAD;
  bf16* z_hi = reinterpret_cast<bf16*>(smem);  // [zrows][ldz]
  bf16* z_lo = z_hi + (size_t)a.zrows * ldz;
  float* scratch = reinterpret_cast<float*>(z_lo + (size_t)a.zrows * ldz);
  T* ys = reinterpret_cast<T*>(scratch + NWARP * 256);  // [n][ys_cap]
  float* scr = scratch + (threadIdx.x >> 5) * 256;
  // the block's outputs: rows r0..r1, columns c0..c1; its halo band:
  // rows h0..h1, columns x0..x0+bw (dmax each side, cut at the edges)
  const int r0 = blockIdx.x * a.th, r1 = min(H, r0 + a.th);
  const int c0 = blockIdx.z * a.tw, c1 = min(W, c0 + a.tw);
  const int h0 = max(0, r0 - a.dmax), h1 = min(H, r1 + a.dmax);
  const int x0 = max(0, c0 - a.dmax), bw = min(W, c1 + a.dmax) - x0;
  const int ow = c1 - c0;
  const int ph = (h1 - h0) * bw;  // halo band pixels
  const int po = (r1 - r0) * ow;  // output band pixels
  const int64_t hw = (int64_t)H * W;
  const T* xb = reinterpret_cast<const T*>(a.x) + (int64_t)blockIdx.y * C * hw;
  T* ob = reinterpret_cast<T*>(a.out) + (int64_t)blockIdx.y * C * hw;
  const float* pb = a.prm;
  const float* pa = pb + n;
  const float* taps = pa + n;
  const float* ca = taps + (size_t)K * 9 * n;
  const float* cb = ca + C;
  const float* cal = cb + C;
  const float* eb = cal + C;
  const float* alpha = eb + C;
  // the products' geometry: proj g_proj groups cin_g -> cout_g, expand ge
  // groups ni -> ni, each padded to 16
  const int gp = a.g_proj, cin_g = C / gp, cout_g = n / gp;
  const int cin_p = pad16(cin_g), cout_p = pad16(cout_g);
  const int ge = a.grouped ? K : 1, ni = a.grouped ? n : C;
  const int ni_p = pad16(ni);
  const bf16* pw_hi = a.mma;
  const bf16* pw_lo = pw_hi + (size_t)gp * cout_p * cin_p;
  const bf16* ew_hi = pw_lo + (size_t)gp * cout_p * cin_p;
  const bf16* ew_lo = ew_hi + (size_t)ge * ni_p * ni_p;

  // 1. proj over the halo band, a window of pp pixels at a time:
  //    ys[o][p] = PReLU(sum_i x[i][p] pw[i][o] + pb)
  {
    const int ldp = a.pp + LD_PAD, prows = gp * cin_p;
    bf16* s_hi = z_hi;  // [prows][ldp], aliasing the z region
    bf16* s_lo = s_hi + (size_t)prows * ldp;
    const T* xs = xb + (int64_t)h0 * W + x0;
    // halo-band pixel p's offset from xs: p itself where the band takes
    // full rows of the plane
    auto band_off = [&](int p) -> int64_t {
      if (bw == W) return p;
      const int py = p / bw;
      return (int64_t)py * W + (p - py * bw);
    };
    const int per_row = a.pp / 8, items = prows * per_row;
    const int lane = threadIdx.x & 31;
    for (int w0 = 0; w0 < ph; w0 += a.pp) {
      const int wn = min(a.pp, ph - w0);
      if (!(EESP_SKIP & 1)) {
        // 8 consecutive pixels of one staged row an item, each thread's SU
        // items loaded (16-byte loads where aligned) before they are stored
        for (int e0 = threadIdx.x; e0 < items; e0 += NT * SU) {
          Pix8<T> raw[SU];
#pragma unroll
          for (int u = 0; u < SU; ++u) {
            const int e = e0 + u * NT, r = e / per_row;
            const int j = (e - r * per_row) * 8, g = r / cin_p;
            const int i = r - g * cin_p;
            const T* xc = xs + (int64_t)(g * cin_g + i) * hw;
            const int p = w0 + j;
            const T* src = xc + band_off(p);
            // the 8 pixels lie in one band row where the band is narrower
            const bool row = bw == W || p % bw + 8 <= bw;
            if (e < items && i < cin_g && j + 8 <= wn && row &&
                !(reinterpret_cast<uintptr_t>(src) & 15)) {
#pragma unroll
              for (int h = 0; h < Pix8<T>::NQ; ++h)
                raw[u].q[h] = __ldg(reinterpret_cast<const uint4*>(src) + h);
            } else {
#pragma unroll
              for (int m = 0; m < 8; ++m)
                raw[u].t[m] = (e < items && i < cin_g && j + m < wn)
                    ? xc[band_off(p + m)] : from_f32<T>(0.f);
            }
          }
#pragma unroll
          for (int u = 0; u < SU; ++u) {
            const int e = e0 + u * NT, r = e / per_row;
            if (e >= items) break;
            const size_t at = (size_t)r * ldp + (e - r * per_row) * 8;
            if constexpr (SPLIT_X) {
              Pix8<bf16> hi, lo;
#pragma unroll
              for (int m = 0; m < 8; ++m) {
                hi.t[m] = __float2bfloat16_rn(to_f32(raw[u].t[m]));
                lo.t[m] = __float2bfloat16_rn(to_f32(raw[u].t[m]) -
                                              __bfloat162float(hi.t[m]));
              }
              *reinterpret_cast<uint4*>(s_hi + at) = hi.q[0];
              *reinterpret_cast<uint4*>(s_lo + at) = lo.q[0];
            } else {
              *reinterpret_cast<uint4*>(s_hi + at) = raw[u].q[0];
            }
          }
        }
      }
      __syncthreads();
      if (!(EESP_SKIP & 2))
        products<SPLIT_X>(
            gp, cout_p, cin_p, (wn + 15) / 16, pw_hi, pw_lo, s_hi, s_lo,
            ldp, scr, [&](int g, int m0, int j0, const float* v) {
              const int p = w0 + j0 + (lane & 15);
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                const int rl = m0 + (lane >> 4) + 2 * u;
                if (rl < cout_g && p < ph) {
                  const int o = g * cout_g + rl;
                  ys[(size_t)o * a.ys_cap + p] =
                      from_f32<T>(prelu(v[u] + pb[o], pa[o]));
                }
              }
            });
      __syncthreads();
    }
  }

  // rows of z past a group's true width stay zero for every chunk
  for (int e = threadIdx.x; e < ge * ni_p * a.pc; e += NT) {
    const int r = e / a.pc, j = e - r * a.pc;
    if (r % ni_p >= ni) {
      z_hi[(size_t)r * ldz + j] = __float2bfloat16_rn(0.f);
      z_lo[(size_t)r * ldz + j] = __float2bfloat16_rn(0.f);
    }
  }

  for (int q0 = 0; q0 < po; q0 += a.pc) {
    // 2. branches + HFF + BR affine + PReLU of pixels q0..q0+pc-1 -> z
    for (int item = threadIdx.x; item < (EESP_SKIP & 4 ? 0 : n * a.pc);
         item += NT) {
      const int ch = item / a.pc, j = item - ch * a.pc;
      const int q = q0 + j;
      if (q >= po) {
        for (int kk = 0; kk < K; ++kk) {
          const int zr = a.grouped ? kk * ni_p + ch : kk * n + ch;
          z_hi[(size_t)zr * ldz + j] = __float2bfloat16_rn(0.f);
          z_lo[(size_t)zr * ldz + j] = __float2bfloat16_rn(0.f);
        }
        continue;
      }
      const int yy = r0 + q / ow, xx = c0 + q % ow;
      const T* yc = ys + (size_t)ch * a.ys_cap;
      float hff = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const int d = a.dil[kk];
        const float* tk = taps + (size_t)kk * 9 * n + ch;
        float s = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int sy = yy + (ky - 1) * d;
          if (sy < 0 || sy >= H) continue;
          const T* yrow = yc + (sy - h0) * bw;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int sx = xx + (kx - 1) * d;
            if (sx < 0 || sx >= W) continue;
            s += tk[(ky * 3 + kx) * n] * to_f32(yrow[sx - x0]);
          }
        }
        hff += s;
        const int co = kk * n + ch;
        const int zr = a.grouped ? kk * ni_p + ch : co;
        split_store(z_hi + (size_t)zr * ldz + j, z_lo + (size_t)zr * ldz + j,
                    prelu(hff * ca[co] + cb[co], cal[co]));
      }
    }
    __syncthreads();

    // 3. expand + bias + residual + PReLU, rounded once per output
    if (!(EESP_SKIP & 8))
      products<true>(
          ge, ni_p, ni_p, (min(a.pc, po - q0) + 15) / 16, ew_hi, ew_lo, z_hi,
          z_lo, ldz, scr, [&](int g, int m0, int j0, const float* v) {
            const int lane = threadIdx.x & 31, q = q0 + j0 + (lane & 15);
            const int64_t at0 =
                ow == W ? (int64_t)r0 * W + q
                        : (int64_t)(r0 + q / ow) * W + c0 + q % ow;
            float res[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int rl = m0 + (lane >> 4) + 2 * u;
              res[u] = (rl < ni && q < po)
                  ? to_f32(xb[(int64_t)(g * ni + rl) * hw + at0]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int rl = m0 + (lane >> 4) + 2 * u, o = g * ni + rl;
              if (rl < ni && q < po)
                ob[(int64_t)o * hw + at0] =
                    from_f32<T>(prelu(v[u] + eb[o] + res[u], alpha[o]));
            }
          });
    __syncthreads();
  }
}

template <typename T>
static int launch_typed(const StageArgs& a, int smem, cudaStream_t st) {
  // the layout the kernel reads; ops/eesp_stage.py::_smem_bytes models it
  const int prows = a.g_proj * pad16(a.c / a.g_proj);
  const int erows = a.grouped ? a.k * pad16(a.n) : pad16(a.c);
  const size_t zbytes = (size_t)a.zrows * (a.pc + LD_PAD) * 4;
  const size_t need = zbytes + NWARP * 256 * sizeof(float) +
                      (size_t)a.n * a.ys_cap * sizeof(T);
  const size_t stage = (size_t)prows * (a.pp + LD_PAD) * 2 *
                       (sizeof(T) == 4 ? 2 : 1);
  if (a.zrows < prows || a.zrows < erows || stage > zbytes ||
      (size_t)smem < need)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      eesp_unit_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.h + a.th - 1) / a.th, a.b, (a.w + a.tw - 1) / a.tw);
  eesp_unit_kernel<T><<<grid, NT, smem, st>>>(a);
  return 0;
}

extern "C" int eesp_unit_launch(
    const void* x, void* out, const float* prm, const void* mma, int dtype,
    int b, int c, int n, int k, int h, int w, int g_proj, int grouped,
    int th, int tw, int pc, int pp, int ys_cap, int zrows, int smem,
    const int* dil, void* stream) {
  if (k < 1 || k > MAX_K || c != n * k || g_proj < 1 || c % g_proj ||
      n % g_proj || pc < 16 || pc % 16 || pp < 16 || pp % 16 || th < 1 ||
      tw < 1 || tw > w)
    return (int)cudaErrorInvalidValue;
  StageArgs a;
  a.x = x;
  a.out = out;
  a.prm = prm;
  a.mma = reinterpret_cast<const bf16*>(mma);
  a.b = b;
  a.c = c;
  a.n = n;
  a.k = k;
  a.h = h;
  a.w = w;
  a.g_proj = g_proj;
  a.grouped = grouped;
  a.th = th;
  a.tw = tw;
  a.pc = pc;
  a.pp = pp;
  a.ys_cap = ys_cap;
  a.zrows = zrows;
  a.dmax = 0;
  for (int i = 0; i < MAX_K; ++i) {
    a.dil[i] = i < k ? dil[i] : 0;
    if (i < k && dil[i] > a.dmax) a.dmax = dil[i];
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (b > 0 && h > 0 && w > 0) {
    const int e = dtype == MSPL_BF16
                      ? launch_typed<__nv_bfloat16>(a, smem, st)
                      : launch_typed<float>(a, smem, st);
    if (e) return e;
  }
  return (int)cudaGetLastError();
}
