// Pairwise squared L2 distances (K4).
//
// Replaces srl_zoo_tpu/ops/pairwise.py _pairwise_pallas (_pairwise_kernel).
//
//   out[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)     (N, M) float32
//
// Bound on the H100: operations. 2*N*M*D f32 multiply-adds outside the
// tensor cores (32.8 GFLOP at N=4096, M=20000, D=200: 0.49 ms at
// 67 TFLOP/s) against 347 MB moved (the (N, M) output dominates: 0.10 ms at
// 3.35 TB/s). Design:
//   * a block owns a 128 x 128 output tile; x and y strips go through shared
//     memory in chunks of 16 features, transposed so that each of the 256
//     threads reads its operands as float4s; each thread accumulates an 8x8
//     micro-tile of dot products (64 FMAs per 4 shared loads).
//   * |x|^2 and |y|^2 are accumulated from the same staged chunks (threads
//     0..127 own a row of x, 128..255 a row of y), so the norms cost no
//     second read of the inputs.
//   * edges are masked, not padded: rows past N or M and features past D
//     load as 0 and are never stored, so D = 200 and M = 20000 need no
//     padded copies (the TPU wrapper padded N, M to 256 and D to 128).
//   * the epilogue writes each row's 4 consecutive columns as one float4
//     (when M % 4 == 0) with streaming stores: the matrix is written once
//     and nothing here reads it back. Output offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // rows of x per block
constexpr int BN = 128;     // rows of y per block
constexpr int TD = 16;      // features per staged chunk
constexpr int LD = BM + 4;  // padded row of a transposed chunk, 16-B aligned
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS, 2)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int n, int m, int d) {
  __shared__ __align__(16) float Xs[TD][LD];
  __shared__ __align__(16) float Ys[TD][LD];
  __shared__ float xxS[BM];
  __shared__ float yyS[BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float sq = 0.0f;

  for (int d0 = 0; d0 < d; d0 += TD) {
#pragma unroll
    for (int k = 0; k < (BM * TD) / THREADS; ++k) {
      const int e = tid + THREADS * k;
      const int r = e / TD, c = e % TD;
      const int f = d0 + c;
      const int xi = row0 + r, yi = col0 + r;
      Xs[c][r] = (xi < n && f < d) ? x[(long long)xi * d + f] : 0.0f;
      Ys[c][r] = (yi < m && f < d) ? y[(long long)yi * d + f] : 0.0f;
    }
    __syncthreads();
    if (tid < BM) {
#pragma unroll
      for (int dd = 0; dd < TD; ++dd) sq = fmaf(Xs[dd][tid], Xs[dd][tid], sq);
    } else {
      const int t = tid - BM;
#pragma unroll
      for (int dd = 0; dd < TD; ++dd) sq = fmaf(Ys[dd][t], Ys[dd][t], sq);
    }
#pragma unroll
    for (int dd = 0; dd < TD; ++dd) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[dd][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xs[dd][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ys[dd][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ys[dd][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < BM)
    xxS[tid] = sq;
  else
    yyS[tid - BM] = sq;
  __syncthreads();

  const bool vec = (m & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rl = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    const int r = row0 + rl;
    if (r >= n) continue;
    const float xr = xxS[rl];
    float* orow = out + (long long)r * m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cl = h * 64 + tx * 4;
      const int c = col0 + cl;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = fmaxf(xr + yyS[cl + j] - 2.0f * acc[i][h * 4 + j], 0.0f);
      if (vec && c + 3 < m) {
        __stcs(reinterpret_cast<float4*>(orow + c),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < m) __stcs(orow + c + j, v[j]);
      }
    }
  }
}

}  // namespace

// x: (n, d) f32, y: (m, d) f32, both row-major contiguous; out: (n, m) f32,
// contiguous and 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int srl_pairwise_sqdist(const void* x, const void* y, void* out,
                                   int n, int m, int d, void* stream) {
  if (n < 0 || m < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return 0;
  const int row_tiles = (n + BM - 1) / BM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((m + BN - 1) / BN, row_tiles);
  pairwise_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)out, n, m, d);
  return (int)cudaGetLastError();
}
