// Bilinear resize (align_corners=True) of channel-major logits.
//
// Replaces the Pallas kernel mspl_tpu/ops/pallas_resize.py::resize_x2_cm_pallas
// (the x2 upsample of the classifier stage's [B, C, H/2, W/2] logits to the
// input resolution).  The TPU kernel runs it as two interpolation matmuls
// because the MXU is the TPU's fast path; here each output pixel gathers its
// four taps directly, with the (index, weight) pairs read off the same
// interpolation matrices as the JAX path (ops/resize.py::interp_taps).
//
// Bound: bytes.  Each output element costs 4 reads that hit L1/L2 (input is a
// quarter of the output) and one write.  Design: one thread per output
// element, consecutive threads on consecutive output W, so the stores and the
// gathers coalesce; f32 accumulation, one rounding to the output dtype.  Any
// input/output size is accepted (the x2 case is the main path's).
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(256)
resize_bilinear_kernel(const T* __restrict__ x, T* __restrict__ out,
                       int64_t total, int hi, int wi, int ho, int wo,
                       const int* __restrict__ hidx,
                       const float* __restrict__ hwgt,
                       const int* __restrict__ widx,
                       const float* __restrict__ wwgt) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ox = (int)(i % wo);
  const int64_t t = i / wo;
  const int oy = (int)(t % ho);
  const int64_t plane = t / ho;
  const T* src = x + plane * hi * wi;
  const int y0 = hidx[2 * oy], y1 = hidx[2 * oy + 1];
  const float wy0 = hwgt[2 * oy], wy1 = hwgt[2 * oy + 1];
  const int x0 = widx[2 * ox], x1 = widx[2 * ox + 1];
  const float wx0 = wwgt[2 * ox], wx1 = wwgt[2 * ox + 1];
  // H contraction first, then W, as the JAX path orders its two matmuls
  const float c0 = wy0 * to_f32(src[y0 * wi + x0]) + wy1 * to_f32(src[y1 * wi + x0]);
  const float c1 = wy0 * to_f32(src[y0 * wi + x1]) + wy1 * to_f32(src[y1 * wi + x1]);
  out[i] = from_f32<T>(wx0 * c0 + wx1 * c1);
}

extern "C" int resize_bilinear_launch(const void* x, void* out, int dtype,
                                      long long planes, int hi, int wi,
                                      int ho, int wo, const int* hidx,
                                      const float* hwgt, const int* widx,
                                      const float* wwgt, void* stream) {
  const int64_t total = (int64_t)planes * ho * wo;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (total > 0) {
    const unsigned int grid = mspl_blocks(total, 256);
    if (dtype == MSPL_BF16)
      resize_bilinear_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
          reinterpret_cast<const __nv_bfloat16*>(x),
          reinterpret_cast<__nv_bfloat16*>(out), total, hi, wi, ho, wo, hidx,
          hwgt, widx, wwgt);
    else
      resize_bilinear_kernel<float><<<grid, 256, 0, st>>>(
          reinterpret_cast<const float*>(x), reinterpret_cast<float*>(out),
          total, hi, wi, ho, wo, hidx, hwgt, widx, wwgt);
  }
  return (int)cudaGetLastError();
}
