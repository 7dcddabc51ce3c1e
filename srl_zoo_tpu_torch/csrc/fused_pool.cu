// Fused relu + 3x3 stride-2 max-pool over NHWC, with an optional int8
// argmax plane.
//
// Replaces srl_zoo_tpu/ops/fused_pool.py _fwd_pallas (_fwd_kernel).
//
//   y[b, oh, ow, c]   = max(0, max over the 3x3 window of x)
//   idx[b, oh, ow, c] = raster position 0..8 of the first window maximum,
//                       or 9 when that maximum is <= 0 (relu kills it)
//
// Bound on the H100: bytes. Each output reads nine inputs that its
// neighbours share, so the kernel moves about one read of x and one write
// of y (plus one byte per output for idx); ~10 compares per output are
// nothing next to 3.35 TB/s. Design: one thread per output element with
// the channel fastest, so a warp reads 32 consecutive channels of one
// pixel (coalesced), and the overlapping windows of neighbouring outputs
// are served by L1/L2 rather than device memory. The TPU kernel packed the
// argmax into mantissa bits because the v5e VPU has no 16-bit compares;
// here the index is a plain register compared with '>' (first match wins)
// and stored directly. Positions outside the image are skipped, which is
// the -inf padding of the XLA pool.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: v is one of the inputs, or 0
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

template <typename T>
__global__ void relu_max_pool_fwd_kernel(const T* __restrict__ x,
                                         T* __restrict__ y,
                                         int8_t* __restrict__ idx,
                                         int H, int W, int C, int OH, int OW,
                                         int pad_top, int pad_left,
                                         long long total) {
  long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int c = (int)(o % C);
  long long p = o / C;
  int ow = (int)(p % OW);
  p /= OW;
  int oh = (int)(p % OH);
  long long b = p / OH;

  const T* xb = x + b * (long long)H * W * C + c;
  float m = -INFINITY;
  int arg = 9;
  int h0 = oh * 2 - pad_top;
  int w0 = ow * 2 - pad_left;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    int ih = h0 + dy;
    if (ih < 0 || ih >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      int iw = w0 + dx;
      if (iw < 0 || iw >= W) continue;
      float v = to_f(xb[((long long)ih * W + iw) * C]);
      if (v > m) {
        m = v;
        arg = dy * 3 + dx;
      }
    }
  }
  bool pos = m > 0.0f;
  y[o] = from_f<T>(pos ? m : 0.0f);
  if (idx != nullptr) idx[o] = (int8_t)(pos ? arg : 9);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. idx may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int srl_relu_max_pool_fwd(const void* x, void* y, void* idx,
                                     int dtype, int B, int H, int W, int C,
                                     int OH, int OW, int pad_top,
                                     int pad_left, void* stream) {
  long long total = (long long)B * OH * OW * C;
  if (total == 0) return 0;
  const int threads = 256;
  unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  int8_t* ip = (int8_t*)idx;
  switch (dtype) {
    case 0:
      relu_max_pool_fwd_kernel<float><<<blocks, threads, 0, s>>>(
          (const float*)x, (float*)y, ip, H, W, C, OH, OW, pad_top, pad_left,
          total);
      break;
    case 1:
      relu_max_pool_fwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
          (const __nv_bfloat16*)x, (__nv_bfloat16*)y, ip, H, W, C, OH, OW,
          pad_top, pad_left, total);
      break;
    case 2:
      relu_max_pool_fwd_kernel<__half><<<blocks, threads, 0, s>>>(
          (const __half*)x, (__half*)y, ip, H, W, C, OH, OW, pad_top,
          pad_left, total);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
