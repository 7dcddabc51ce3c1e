// Fused squared-L2 distance + streaming top-k (k nearest references).
//
// Replaces srl_zoo_tpu/ops/knn_topk.py _topk_pallas_t (_knn_kernel_t) and
// _topk_pallas (_knn_kernel); one kernel covers both (they differ only in
// TPU vector layout).
//
//   d2[q, j] = max(|q|^2 + |r_j|^2 - 2 q.r_j, 0)
//   out[q]   = the k smallest (d2, j), ascending, ties to the lowest j
//
// Bound on the H100: operations. 2*Q*N*D f32 multiply-adds outside the
// tensor cores (about 33 GFLOP at Q=4096, N=20000, D=200, ~0.5 ms at
// 67 TFLOP/s) against a few tens of MB of input. Design:
//   * pass 1: a block owns 64 queries and a contiguous range of 64-wide
//     reference tiles (grid.y splits N so that Q/64 x splits blocks fill
//     the 132 SMs). Query and reference chunks of 16 features go through
//     shared memory; each of the 256 threads accumulates a 4x4 block of
//     dot products from float4 shared loads (16 FMAs per 2 loads). The
//     squared norms are accumulated from the same shared chunks. The
//     64x64 distance tile is staged in shared memory only: the (Q, N)
//     matrix never reaches device memory.
//   * four threads share each query; each keeps a private sorted best-KMAX
//     list in registers (compile-time KMAX, fully unrolled insertion) and
//     scans a quarter of every tile. The four lists are merged with warp
//     shuffles and the block writes its split's best k.
//   * pass 2 merges the splits' lists per query (blocks run in no order,
//     so nothing is carried between them).
// Reference rows past N are never read into a list, so padding never wins.
// The order (d, j) is total, so the result does not depend on the order in
// which blocks or threads see the candidates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int TQ = 64;
constexpr int TR = 64;
constexpr int TD = 16;
constexpr int LD = 68;  // padded row of the transposed chunks (16-byte aligned)
constexpr int THREADS = 256;

__device__ __forceinline__ bool better(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

template <int KMAX>
__device__ __forceinline__ void insert(float (&bd)[KMAX], int (&bi)[KMAX],
                                       float d, int i) {
  if (!better(d, i, bd[KMAX - 1], bi[KMAX - 1])) return;
  bd[KMAX - 1] = d;
  bi[KMAX - 1] = i;
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (better(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
      float td = bd[s];
      bd[s] = bd[s - 1];
      bd[s - 1] = td;
      int ti = bi[s];
      bi[s] = bi[s - 1];
      bi[s - 1] = ti;
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(THREADS)
knn_partial_kernel(const float* __restrict__ q, const float* __restrict__ r,
                   float* __restrict__ part_d, int* __restrict__ part_i,
                   int nq, int n, int d, int k, int tiles_per_split,
                   int splits) {
  __shared__ __align__(16) float Qs[TD][LD];
  __shared__ __align__(16) float Rs[TD][LD];
  __shared__ float Ds[TQ][TR + 1];
  __shared__ float qqS[TQ];
  __shared__ float rrS[TR];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int n_tiles = (n + TR - 1) / TR;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  const int my_q = tid >> 2, part = tid & 3;

  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    bd[s] = INFINITY;
    bi[s] = INT_MAX;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int r0 = tile * TR;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    float sq = 0.0f;

    for (int d0 = 0; d0 < d; d0 += TD) {
#pragma unroll
      for (int m = 0; m < (TQ * TD) / THREADS; ++m) {
        int e = tid + THREADS * m;
        int row = e >> 4, col = e & 15;
        int f = d0 + col;
        int qi = q0 + row, ri = r0 + row;
        Qs[col][row] = (qi < nq && f < d) ? q[(long long)qi * d + f] : 0.0f;
        Rs[col][row] = (ri < n && f < d) ? r[(long long)ri * d + f] : 0.0f;
      }
      __syncthreads();
      if (tid < TR) {
#pragma unroll
        for (int dd = 0; dd < TD; ++dd) sq = fmaf(Rs[dd][tid], Rs[dd][tid], sq);
      } else if (tid < TR + TQ) {
        int t = tid - TR;
#pragma unroll
        for (int dd = 0; dd < TD; ++dd) sq = fmaf(Qs[dd][t], Qs[dd][t], sq);
      }
#pragma unroll
      for (int dd = 0; dd < TD; ++dd) {
        float4 a = *reinterpret_cast<const float4*>(&Qs[dd][ty * 4]);
        float4 b = *reinterpret_cast<const float4*>(&Rs[dd][tx * 4]);
        float av[4] = {a.x, a.y, a.z, a.w};
        float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < TR)
      rrS[tid] = sq;
    else if (tid < TR + TQ)
      qqS[tid - TR] = sq;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int ql = ty * 4 + i, rl = tx * 4 + j;
        Ds[ql][rl] = fmaxf(qqS[ql] + rrS[rl] - 2.0f * acc[i][j], 0.0f);
      }
    __syncthreads();
#pragma unroll 4
    for (int m = 0; m < TR / 4; ++m) {
      int rl = part + 4 * m;
      int j = r0 + rl;
      if (j < n) insert<KMAX>(bd, bi, Ds[my_q][rl], j);
    }
    __syncthreads();
  }

  // merge the four lists of each query: lanes 4t..4t+3 of one warp
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    float od[KMAX];
    int oi[KMAX];
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      od[s] = __shfl_xor_sync(0xffffffffu, bd[s], off);
      oi[s] = __shfl_xor_sync(0xffffffffu, bi[s], off);
    }
#pragma unroll
    for (int s = 0; s < KMAX; ++s) insert<KMAX>(bd, bi, od[s], oi[s]);
  }

  const int qg = q0 + my_q;
  if (part == 0 && qg < nq) {
    long long base = ((long long)qg * splits + split) * k;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < k) {
        part_d[base + s] = bd[s];
        part_i[base + s] = bi[s];
      }
    }
  }
}

template <int KMAX>
__global__ void knn_merge_kernel(const float* __restrict__ part_d,
                                 const int* __restrict__ part_i,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_i, int nq, int k,
                                 int splits) {
  int qg = blockIdx.x * blockDim.x + threadIdx.x;
  if (qg >= nq) return;
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    bd[s] = INFINITY;
    bi[s] = INT_MAX;
  }
  long long base = (long long)qg * splits * k;
  for (int j = 0; j < splits * k; ++j)
    insert<KMAX>(bd, bi, part_d[base + j], part_i[base + j]);
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) {
      out_d[(long long)qg * k + s] = bd[s];
      out_i[(long long)qg * k + s] = bi[s];
    }
  }
}

template <int KMAX>
int launch(const float* q, const float* r, float* part_d, int* part_i,
           float* out_d, int* out_i, int nq, int n, int d, int k, int splits,
           cudaStream_t s) {
  int n_tiles = (n + TR - 1) / TR;
  int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((nq + TQ - 1) / TQ, splits);
  knn_partial_kernel<KMAX><<<grid, THREADS, 0, s>>>(
      q, r, part_d, part_i, nq, n, d, k, tiles_per_split, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_merge_kernel<KMAX><<<(nq + 127) / 128, 128, 0, s>>>(
      part_d, part_i, out_d, out_i, nq, k, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (nq, d) f32, r: (n, d) f32, both row-major contiguous. part_d/part_i:
// (nq, splits, k) scratch; out_d/out_i: (nq, k). 1 <= k <= min(64, n), and
// splits must not exceed the number of 64-wide reference tiles.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int srl_knn_topk(const void* q, const void* r, void* part_d,
                            void* part_i, void* out_d, void* out_i, int nq,
                            int n, int d, int k, int splits, void* stream) {
  if (nq == 0) return 0;
  if (k < 1 || k > 64 || k > n || d < 1 || splits < 1 ||
      splits > (n + TR - 1) / TR || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* qp = (const float*)q;
  const float* rp = (const float*)r;
  float* pd = (float*)part_d;
  int* pi = (int*)part_i;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  if (k <= 8) return launch<8>(qp, rp, pd, pi, od, oi, nq, n, d, k, splits, s);
  if (k <= 16) return launch<16>(qp, rp, pd, pi, od, oi, nq, n, d, k, splits, s);
  if (k <= 32) return launch<32>(qp, rp, pd, pi, od, oi, nq, n, d, k, splits, s);
  return launch<64>(qp, rp, pd, pi, od, oi, nq, n, d, k, splits, s);
}
