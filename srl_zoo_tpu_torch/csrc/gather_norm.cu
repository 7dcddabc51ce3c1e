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
// (5 bytes per element: 24.1 MB for 32 frames of 224x224x3, 0.0072 ms at
// 3.35 TB/s; 193 MB and 0.0575 ms for 256). Four fifths of the bytes are
// the f32 output, so the design is built around whole, coalesced stores:
//   * vector path: a thread moves one 4-byte group of a row, a uchar4 load
//     and one float4 store, so a warp's load covers 128 contiguous bytes
//     and its store 512 contiguous bytes (full 32-byte sectors). A 16-byte
//     load would need a shuffle or a shared-memory transpose to keep the
//     stores contiguous; four uchar4 loads in flight per thread move the
//     same bytes without one.
//   * memory-level parallelism: grid.x is the batch row, grid.y a few
//     blocks per row, sized by the wrapper to about two blocks of 256
//     threads per SM in all (one per row at the export batch, 8 at the
//     training batch); each thread strides through its row and keeps four
//     loads in flight before it stores. Measured on the H100, fewer and
//     longer threads beat a full wave of 8 resident blocks per SM: at 32
//     rows 0.008 against 0.015 ms (PERF.md).
//   * the row's index, source and destination pointers are computed once
//     per thread (64-bit); offsets inside a row are 32-bit (the wrapper
//     refuses rows of 2^31 bytes or more), and the channel of the next
//     group advances by a constant instead of a division per element.
//   * stores keep the default cache policy: at 32 rows the 19.3 MB output
//     fits in the 50 MB L2 that the first convolution reads next.
// The scalar path (a frame size that is not a multiple of 4 bytes, or a
// store slice that starts unaligned) is the same loop one byte per thread.
// The wrapper checks the index range on the host before the launch; as a
// safety check, an index outside [0, N) never reads the store (its row is
// left unwritten).

#include <cuda_runtime.h>
#include <stdint.h>

#define SRL_MAX_CHANNELS 8

struct NormParams {
  float scale[SRL_MAX_CHANNELS];
  float offset[SRL_MAX_CHANNELS];
};

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ int next_channel(int ch, int c) {
  return ch + 1 == c ? 0 : ch + 1;
}

__device__ __forceinline__ int advance(int ch, int step, int c) {
  ch += step;
  return ch >= c ? ch - c : ch;
}

__device__ __forceinline__ float4 affine4(uchar4 v, int ch, int c,
                                          const float* sc, const float* of) {
  float4 o;
  o.x = fmaf((float)v.x, sc[ch], of[ch]);
  ch = next_channel(ch, c);
  o.y = fmaf((float)v.y, sc[ch], of[ch]);
  ch = next_channel(ch, c);
  o.z = fmaf((float)v.z, sc[ch], of[ch]);
  ch = next_channel(ch, c);
  o.w = fmaf((float)v.w, sc[ch], of[ch]);
  return o;
}

// units: 4-byte groups (VEC) or bytes of one row; unit u of the row starts
// at element u * (VEC ? 4 : 1).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 8)
gather_norm_kernel(const uint8_t* __restrict__ frames,
                   const int64_t* __restrict__ idx, float* __restrict__ out,
                   long long n, unsigned units, int c, NormParams p) {
  constexpr unsigned PER = VEC ? 4 : 1;
  const long long src_row = idx[blockIdx.x];
  if (src_row < 0 || src_row >= n) return;
  // the lanes of a warp read different channels: from shared memory that
  // is one access, from the parameter bank one per distinct channel
  __shared__ float sc[SRL_MAX_CHANNELS], of[SRL_MAX_CHANNELS];
  // constant indices: a parameter indexed by the thread would be copied
  // to a local-memory stack frame first
#pragma unroll
  for (int i = 0; i < SRL_MAX_CHANNELS; ++i) {
    if (threadIdx.x == i) {
      sc[i] = p.scale[i];
      of[i] = p.offset[i];
    }
  }
  __syncthreads();
  const unsigned long long f = (unsigned long long)units * PER;
  const uint8_t* src = frames + (unsigned long long)src_row * f;
  float* dst = out + (unsigned long long)blockIdx.x * f;
  const unsigned stride = gridDim.y * THREADS;
  unsigned u = blockIdx.y * THREADS + threadIdx.x;
  int ch = (int)((u * PER) % (unsigned)c);
  const int step = (int)(((unsigned long long)stride * PER) % (unsigned)c);
  if (VEC) {
    const uchar4* s4 = reinterpret_cast<const uchar4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (; u + (UNROLL - 1) * stride < units; u += UNROLL * stride) {
      uchar4 v[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) v[j] = s4[u + j * stride];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        d4[u + j * stride] = affine4(v[j], ch, c, sc, of);
        ch = advance(ch, step, c);
      }
    }
    for (; u < units; u += stride) {
      d4[u] = affine4(s4[u], ch, c, sc, of);
      ch = advance(ch, step, c);
    }
  } else {
    for (; u + (UNROLL - 1) * stride < units; u += UNROLL * stride) {
      uint8_t v[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) v[j] = src[u + j * stride];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        dst[u + j * stride] = fmaf((float)v[j], sc[ch], of[ch]);
        ch = advance(ch, step, c);
      }
    }
    for (; u < units; u += stride) {
      dst[u] = fmaf((float)src[u], sc[ch], of[ch]);
      ch = advance(ch, step, c);
    }
  }
}

}  // namespace

// frames: (n, f) uint8; idx: (b,) int64 on the device; out: (b, f) float32.
// idx is in [0, n): the caller checked it.
// scale/offset: c host floats each (c <= 8). vector: take the 4-byte path,
// which needs f % 4 == 0, frames 4-byte and out 16-byte aligned (refused
// otherwise). per_row: blocks per row (the wrapper sizes it to the card).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int srl_gather_normalize(const void* frames, const void* idx,
                                    void* out, long long n,
                                    long long b, long long f, int c,
                                    const float* scale, const float* offset,
                                    int vector, int per_row, void* stream) {
  if (b == 0 || f == 0) return 0;
  if (c < 1 || c > SRL_MAX_CHANNELS || f >= (1LL << 31) ||
      b >= (1LL << 31) || per_row < 1 || per_row > 65535)
    return (int)cudaErrorInvalidValue;
  if (vector && (f % 4 != 0 || (uintptr_t)frames % 4 != 0 ||
                 (uintptr_t)out % 16 != 0))
    return (int)cudaErrorInvalidValue;
  NormParams p;
  for (int i = 0; i < SRL_MAX_CHANNELS; ++i) {
    p.scale[i] = i < c ? scale[i] : 0.0f;
    p.offset[i] = i < c ? offset[i] : 0.0f;
  }
  dim3 grid((unsigned)b, (unsigned)per_row);
  cudaStream_t s = (cudaStream_t)stream;
  if (vector)
    gather_norm_kernel<true><<<grid, THREADS, 0, s>>>(
        (const uint8_t*)frames, (const int64_t*)idx, (float*)out, n,
        (unsigned)(f / 4), c, p);
  else
    gather_norm_kernel<false><<<grid, THREADS, 0, s>>>(
        (const uint8_t*)frames, (const int64_t*)idx, (float*)out, n,
        (unsigned)f, c, p);
  return (int)cudaGetLastError();
}
