// Gather uint8 frames by index from a resident store and normalize to f32.
//
// Replaces srl_zoo_tpu/ops/gather_norm.py _gather_norm_pallas (_kernel).
//
//   out[b, f] = frames[idx[b], f] * scale[f % C] + offset[f % C]
//
// with per-channel (scale, offset): "tf" is (2/255, -1) on every channel,
// "image_net" is (1/(255 std), -mean/std), so both modes take this kernel.
//
// Bound on the H100: bytes, one uint8 read and one f32 write per element
// (5 bytes per element, ~193 MB for 256 frames of 224x224x3). Design:
// grid.x is the batch row, and each block reads its row's index itself
// (no scalar prefetch as on the TPU); each thread moves 16 bytes of input
// with one 128-bit load and writes four 128-bit stores, so a warp touches
// 512 contiguous input bytes and 2 KB of contiguous output. Rows whose
// frame size is not a multiple of 16 bytes (or a store that is not 16-byte
// aligned) take the same kernel one byte per thread. An index outside
// [0, N) sets *bad and leaves its row unwritten; the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

#define SRL_MAX_CHANNELS 8

struct NormParams {
  float scale[SRL_MAX_CHANNELS];
  float offset[SRL_MAX_CHANNELS];
};

namespace {

template <bool VEC>
__global__ void gather_norm_kernel(const uint8_t* __restrict__ frames,
                                   const int64_t* __restrict__ idx,
                                   float* __restrict__ out,
                                   int* __restrict__ bad, long long n,
                                   long long f, int c, NormParams p) {
  const int row = blockIdx.x;
  const long long src_row = idx[row];
  if (src_row < 0 || src_row >= n) {
    if (blockIdx.y == 0 && threadIdx.x == 0) atomicOr(bad, 1);
    return;
  }
  const uint8_t* src = frames + src_row * f;
  float* dst = out + (long long)row * f;
  long long t = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (VEC) {
    long long e0 = t * 16;
    if (e0 >= f) return;
    uint4 raw = *reinterpret_cast<const uint4*>(src + e0);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    int ch = (int)(e0 % c);
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      v[j] = fmaf((float)b[j], p.scale[ch], p.offset[ch]);
      ch = (ch + 1 == c) ? 0 : ch + 1;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + e0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d4[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
    if (t >= f) return;
    int ch = (int)(t % c);
    dst[t] = fmaf((float)src[t], p.scale[ch], p.offset[ch]);
  }
}

}  // namespace

// frames: (n, f) uint8; idx: (b,) int64; out: (b, f) float32; bad: one int,
// zeroed by the caller. scale/offset: c host floats each (c <= 8).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int srl_gather_normalize(const void* frames, const void* idx,
                                    void* out, void* bad, long long n,
                                    long long b, long long f, int c,
                                    const float* scale, const float* offset,
                                    void* stream) {
  if (b == 0 || f == 0) return 0;
  if (c < 1 || c > SRL_MAX_CHANNELS) return (int)cudaErrorInvalidValue;
  NormParams p;
  for (int i = 0; i < SRL_MAX_CHANNELS; ++i) {
    p.scale[i] = i < c ? scale[i] : 0.0f;
    p.offset[i] = i < c ? offset[i] : 0.0f;
  }
  const int threads = 256;
  bool vec = (f % 16 == 0) && ((uintptr_t)frames % 16 == 0) &&
             ((uintptr_t)out % 16 == 0);
  long long per_row = vec ? f / 16 : f;
  long long chunks = (per_row + threads - 1) / threads;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)b, (unsigned int)chunks);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    gather_norm_kernel<true><<<grid, threads, 0, s>>>(
        (const uint8_t*)frames, (const int64_t*)idx, (float*)out, (int*)bad,
        n, f, c, p);
  else
    gather_norm_kernel<false><<<grid, threads, 0, s>>>(
        (const uint8_t*)frames, (const int64_t*)idx, (float*)out, (int*)bad,
        n, f, c, p);
  return (int)cudaGetLastError();
}
