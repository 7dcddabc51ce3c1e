// Backward of the fused relu + 3x3 stride-2 max-pool over NHWC: route each
// output gradient to its window's argmax, read from the forward's int8
// plane.
//
// Replaces srl_zoo_tpu/ops/fused_pool.py _bwd_pallas (_bwd_kernel).
//
//   dx[b, ih, iw, c] = sum over the outputs (oh, ow) whose window holds
//                      (ih, iw) at raster position k = 3*dy + dx, and whose
//                      idx[b, oh, ow, c] == k, of g[b, oh, ow, c]
//
// idx 9 (the window maximum was <= 0, relu killed it) matches no position,
// so those outputs route nothing. This is XLA's select-and-scatter gradient
// of max_pool(relu(x)): ties go to the first maximum in raster order, which
// the forward already chose.
//
// Bound on the H100: bytes. Per output it reads g (4 B in f32) and idx
// (1 B); per input it writes dx (4 B); a handful of compares and adds per
// input are nothing next to 3.35 TB/s. Design: a gather, with one thread
// per INPUT element and the channel fastest, so a warp reads 32
// consecutive channels of one output pixel (coalesced) and writes 32
// consecutive channels of dx. Each thread visits the <= 2x2 outputs whose
// windows cover it, adds the matching gradients in a fixed order in f32
// and writes dx once: no atomics, no zero-fill pass, and the same result on
// every run. The outputs' g and idx are read by up to four inputs each;
// L1/L2 serve the repeats. The TPU kernel packed the four (row, column)
// parities into lanes because Mosaic cannot stride-slice; here the parity
// is just integer arithmetic on the thread's own coordinates, so any H, W
// and pads in [0, 2] work, including the odd 7x7 pool.

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
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// I is the index type: 32-bit whenever the tensors allow it, because 64-bit
// division is a long instruction sequence and this kernel divides three
// times per element.
template <typename T, typename I>
__global__ void relu_max_pool_bwd_kernel(const T* __restrict__ g,
                                         const int8_t* __restrict__ idx,
                                         T* __restrict__ dx,
                                         int H, int W, int C, int OH, int OW,
                                         int pad_top, int pad_left,
                                         I total) {
  I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int c = (int)(i % C);
  I p = i / C;
  int iw = (int)(p % W);
  p /= W;
  int ih = (int)(p % H);
  I b = p / H;

  // padded coordinates; output oh covers padded rows 2*oh .. 2*oh + 2
  int ph = ih + pad_top;
  int pw = iw + pad_left;
  I gb = b * (I)OH * OW * C + c;
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    int r = ph - dy;
    if (r < 0 || (r & 1)) continue;
    int oh = r >> 1;
    if (oh >= OH) continue;
#pragma unroll
    for (int dxp = 0; dxp < 3; ++dxp) {
      int s = pw - dxp;
      if (s < 0 || (s & 1)) continue;
      int ow = s >> 1;
      if (ow >= OW) continue;
      I o = gb + ((I)oh * OW + ow) * C;
      // both loads issue before the compare: no load waits on another,
      // so a thread pays one memory latency, not one per output; adding
      // 0 to the f32 sum leaves it as it is
      int k = idx[o];
      float v = to_f(g[o]);
      acc += (k == dy * 3 + dxp) ? v : 0.0f;
    }
  }
  dx[i] = from_f<T>(acc);
}

template <typename T, typename I>
void launch(const void* g, const int8_t* idx, void* dx, int H, int W, int C,
            int OH, int OW, int pad_top, int pad_left, long long total,
            cudaStream_t s) {
  const int threads = 256;
  unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  relu_max_pool_bwd_kernel<T, I><<<blocks, threads, 0, s>>>(
      (const T*)g, idx, (T*)dx, H, W, C, OH, OW, pad_top, pad_left,
      (I)total);
}

template <typename T>
void launch_any(const void* g, const int8_t* idx, void* dx, int B, int H,
                int W, int C, int OH, int OW, int pad_top, int pad_left,
                long long total, cudaStream_t s) {
  // both dx and g must be indexable in 32 bits
  long long outs = (long long)B * OH * OW * C;
  if (total < (1LL << 31) && outs < (1LL << 31))
    launch<T, int>(g, idx, dx, H, W, C, OH, OW, pad_top, pad_left, total, s);
  else
    launch<T, long long>(g, idx, dx, H, W, C, OH, OW, pad_top, pad_left,
                         total, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (of g and dx).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int srl_relu_max_pool_bwd(const void* g, const void* idx, void* dx,
                                     int dtype, int B, int H, int W, int C,
                                     int OH, int OW, int pad_top,
                                     int pad_left, void* stream) {
  long long total = (long long)B * H * W * C;
  if (total == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* ip = (const int8_t*)idx;
  switch (dtype) {
    case 0:
      launch_any<float>(g, ip, dx, B, H, W, C, OH, OW, pad_top, pad_left,
                        total, s);
      break;
    case 1:
      launch_any<__nv_bfloat16>(g, ip, dx, B, H, W, C, OH, OW, pad_top,
                                pad_left, total, s);
      break;
    case 2:
      launch_any<__half>(g, ip, dx, B, H, W, C, OH, OW, pad_top, pad_left,
                         total, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
