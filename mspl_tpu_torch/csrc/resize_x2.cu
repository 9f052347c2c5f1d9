// Bilinear resize (align_corners=True) of channel-major logits.
//
// Replaces the Pallas kernel mspl_tpu/ops/pallas_resize.py::resize_x2_cm_pallas
// (the x2 upsample of the classifier stage's [B, C, H/2, W/2] logits to the
// input resolution).  The TPU kernel runs it as two interpolation matmuls
// because the MXU is the TPU's fast path; here each output gathers its four
// taps directly, with the (index, weight) pairs read off the same
// interpolation matrices as the JAX path (ops/resize.py::interp_taps).
//
// Bound: bytes (the input once, the output once: at x2 the output is four
// fifths of them).  What is left to avoid is instructions and narrow
// transactions.  Design: a block takes one plane (blockIdx.y) and a band of
// `rb` output rows (blockIdx.x), so no index is divided at run time.  It
// copies the input rows the band reads, which lie contiguous in memory, into
// shared memory with 16-byte loads, and the band's row taps beside them.
// Each thread then owns chunks of 8 consecutive output columns: it reads
// their column taps once into registers (from a chunk-major table, so that
// a warp's reads are consecutive words) and, for each of its rows, forms
// the 8 outputs from shared memory and writes them with one 16-byte store
// (bf16; two for f32).  A chunk cut by the row's end, or a row that does not
// start 16-byte aligned, is stored element by element.  f32 accumulation, H
// contraction first as the JAX path orders its matmuls, one rounding to the
// output dtype.  Any input and output size is taken; the wrapper picks `rb`
// so that the staged rows fit.
#include "common.cuh"

#define RS_TX 32
#define RS_TY 8
#define RS_MAX_ROWS 32

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float v[8]);
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      const float v[8]) {
  uint4 u;
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}
template <>
__device__ __forceinline__ void store8<float>(float* dst, const float v[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// grid (row bands, planes), block (32, 8).  Shared memory: the staged input
// rows (in_cap elements of T, 16-byte padded), then the band's row taps.
// ctab_i/ctab_w hold the column taps chunk-major, [2, 8, chunks] (lo then
// hi index; their weights), so that a warp's lanes read consecutive words.
template <typename T>
__global__ void __launch_bounds__(RS_TX * RS_TY)
resize_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int hi,
                   int wi, int ho, int wo, int rb, int in_cap, int vec_in,
                   int vec_out, const int* __restrict__ hidx,
                   const float* __restrict__ hwgt,
                   const int* __restrict__ ctab_i,
                   const float* __restrict__ ctab_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_in = reinterpret_cast<T*>(smem_raw);
  int* s_ry = reinterpret_cast<int*>(
      smem_raw + (((size_t)in_cap * sizeof(T) + 15) & ~(size_t)15));
  float* s_rw = reinterpret_cast<float*>(s_ry + 2 * RS_MAX_ROWS);
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * RS_TX + tx;
  const int nt = RS_TX * RS_TY;
  const int64_t plane = blockIdx.y;
  const int oy0 = blockIdx.x * rb, nrows = min(rb, ho - oy0);
  const int r0 = hidx[2 * oy0], r1 = hidx[2 * (oy0 + nrows - 1) + 1];
  const int n = (r1 - r0 + 1) * wi;
  const T* src = x + (plane * hi + r0) * wi;
  if (vec_in) {  // the band's rows are contiguous and 16-byte aligned
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(s_in);
    const int n4 = n * (int)sizeof(T) / 16;
    for (int i = tid; i < n4; i += nt) d4[i] = s4[i];
  } else {
    for (int i = tid; i < n; i += nt) s_in[i] = src[i];
  }
  if (tid < 2 * nrows) {
    s_ry[tid] = (hidx[2 * oy0 + tid] - r0) * wi;
    s_rw[tid] = hwgt[2 * oy0 + tid];
  }
  __syncthreads();
  T* dst_plane = out + (plane * ho + oy0) * wo;
  const int chunks = (wo + 7) / 8;
  for (int cc = tx; cc < chunks; cc += RS_TX) {
    const int ox0 = cc * 8, m = min(8, wo - ox0);
    int xa[8], xb[8];
    float wa[8], wb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xa[j] = ctab_i[j * chunks + cc];
      xb[j] = ctab_i[(8 + j) * chunks + cc];
      wa[j] = ctab_w[j * chunks + cc];
      wb[j] = ctab_w[(8 + j) * chunks + cc];
    }
    for (int r = ty; r < nrows; r += RS_TY) {
      const T* ra = s_in + s_ry[2 * r];
      const T* rb_ = s_in + s_ry[2 * r + 1];
      const float wya = s_rw[2 * r], wyb = s_rw[2 * r + 1];
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float c0 = wya * to_f32(ra[xa[j]]) + wyb * to_f32(rb_[xa[j]]);
        const float c1 = wya * to_f32(ra[xb[j]]) + wyb * to_f32(rb_[xb[j]]);
        v[j] = wa[j] * c0 + wb[j] * c1;
      }
      T* dst = dst_plane + (int64_t)r * wo + ox0;
      if (vec_out && m == 8) {
        store8<T>(dst, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < m) dst[j] = from_f32<T>(v[j]);
      }
    }
  }
}

// x [planes, hi, wi] -> out [planes, ho, wo] (dtype); hidx/hwgt [ho, 2]
// the row taps of interp_taps, ctab_i/ctab_w its column taps chunk-major
// [2, 8, ceil(wo / 8)] (0 past wo); rb output rows a block, whose
// input rows fit in_cap elements (the wrapper computes both); vec_in and
// vec_out say whether the input's and the output's rows start 16-byte
// aligned.
extern "C" int resize_bilinear_launch(const void* x, void* out, int dtype,
                                      long long planes, int hi, int wi,
                                      int ho, int wo, int rb, int in_cap,
                                      int vec_in, int vec_out,
                                      const int* hidx, const float* hwgt,
                                      const int* ctab_i, const float* ctab_w,
                                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (rb < 1 || rb > RS_MAX_ROWS) return (int)cudaErrorInvalidValue;
  const int esize = dtype == MSPL_BF16 ? 2 : 4;
  const size_t smem = (((size_t)in_cap * esize + 15) & ~(size_t)15) +
                      16 * RS_MAX_ROWS;
  const void* k = dtype == MSPL_BF16
      ? (const void*)resize_rows_kernel<__nv_bfloat16>
      : (const void*)resize_rows_kernel<float>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // gridDim.y holds at most 65535 planes a launch
  for (long long p0 = 0; p0 < planes && (int64_t)ho * wo > 0; p0 += 65535) {
    const long long np = planes - p0 < 65535 ? planes - p0 : 65535;
    const dim3 grid((ho + rb - 1) / rb, (unsigned)np);
    const int64_t in_off = p0 * hi * wi, out_off = p0 * ho * wo;
    if (dtype == MSPL_BF16)
      resize_rows_kernel<__nv_bfloat16><<<grid, dim3(RS_TX, RS_TY), smem, st>>>(
          reinterpret_cast<const __nv_bfloat16*>(x) + in_off,
          reinterpret_cast<__nv_bfloat16*>(out) + out_off, hi, wi, ho, wo, rb,
          in_cap, vec_in, vec_out, hidx, hwgt, ctab_i, ctab_w);
    else
      resize_rows_kernel<float><<<grid, dim3(RS_TX, RS_TY), smem, st>>>(
          reinterpret_cast<const float*>(x) + in_off,
          reinterpret_cast<float*>(out) + out_off, hi, wi, ho, wo, rb, in_cap,
          vec_in, vec_out, hidx, hwgt, ctab_i, ctab_w);
  }
  return (int)cudaGetLastError();
}
