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
// tensor cores (32.8 GFLOP at Q=4096, N=20000, D=200: 0.49 ms at
// 67 TFLOP/s) against 19.6 MB of input (0.006 ms at 3.35 TB/s). So the
// design keeps the FMA pipes fed and everything else off them:
//   * pass 0 (knn_norms_kernel): |q|^2 and |r|^2 once per call, into a
//     scratch vector padded with zeros to whole tiles, each summed in the
//     dot products' order so that a point's distance to itself is 0.
//   * pass 1 (knn_partial_kernel): a block owns 64 queries and a range of
//     256-wide reference tiles (grid.y splits N). The block's query rows
//     stay in dynamic shared memory for the whole range, transposed so
//     that a thread reads 4 queries as one float4 (D padded to 16: 56.6 KB
//     at D=200). Reference chunks of 16 features go through a double-
//     buffered cp.async ring: chunk c+1 is copied while chunk c is
//     multiplied, with one barrier per chunk. Each of the 256 threads
//     accumulates an 8x8 register micro-tile (8 queries x 8 references,
//     64 FMAs per four shared float4 loads, the query loads a broadcast
//     within the warp). For D > 512 the query tile no longer fits beside
//     the ring and goes through the ring with the references instead.
//   * selection: each warp owns 8 query rows for the whole range, and a
//     row's 256 candidates of a tile all sit in that warp (8 per lane).
//     Each row keeps its sorted best-k list in shared memory; its k-th
//     entry is the threshold. A split's first tile fills the empty list
//     with its best k by k rounds of a warp-wide arg-min. After that a
//     candidate that does not beat the threshold is dropped in registers,
//     so almost nothing else happens; survivors are inserted one at a
//     time by the whole warp (each lane moves its list entries up by one,
//     no search), and the threshold is re-read after each. No distance
//     tile is staged in shared memory.
//   * pass 2 (knn_merge_kernel) merges the splits' lists per query:
//     blocks run in no order, so nothing is carried between them.
//   * the grid: the wrapper sizes the splits from the occupancy that the
//     CUDA runtime reports for this instantiation (registers and shared
//     memory): as many splits as let the Q/64 x splits blocks fill one
//     wave of the card's resident slots. nvcc -Xptxas -v (CUDA 12.8, sm_90a): the
//     partial kernel takes 125-128 registers (launch bounds: 256 threads,
//     2 blocks), no spills; its dynamic shared memory at D = 200 is
//     91.8 KB for k <= 8 (2 blocks per SM, 264 slots on 132 SMs: the main
//     path's 64 query tiles x 4 splits of 20 tiles are 256 blocks, one
//     wave) and 122.6 KB for k > 32 (1 block per SM).
// Reference rows past N are never inserted, so padding never wins. The
// order (d, j) is total, so the result does not depend on the order in
// which blocks, warps or lanes see the candidates.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;       // queries per block
constexpr int TR = 256;      // references per tile
constexpr int TD = 16;       // features per staged chunk
constexpr int LDQ = TQ + 4;  // padded row of a transposed query chunk
constexpr int LDR = TR + 4;  // padded row of a transposed reference chunk
constexpr int THREADS = 256;
constexpr int NORM_THREADS = 128;
constexpr int DRES = 512;    // widest padded D whose query tile stays resident
constexpr unsigned FULL = 0xffffffffu;

constexpr int STAGE_R = TD * LDR;  // floats of a ring stage's references
constexpr int STAGE_Q = TD * LDQ;  // floats of a ring stage's queries

__device__ __forceinline__ bool better(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

// 4-byte asynchronous copy; src_size 0 fills the word with zero (edges)
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ constexpr int padded_d(int d) {
  return (d + TD - 1) / TD * TD;
}

template <int KMAX, bool RES>
__host__ __device__ constexpr int smem_floats(int dp) {
  return (RES ? dp * LDQ : 0) + 2 * (STAGE_R + (RES ? 0 : STAGE_Q)) +
         2 * TQ * KMAX;
}

// column (reference offset in the tile) of a lane's j-th candidate
__device__ __forceinline__ int col_of(int lane, int j) {
  return (j < 4 ? 0 : 128) + lane * 4 + (j & 3);
}

// row (query offset in the block) of a warp's i-th row
__device__ __forceinline__ int row_of(int warp, int i) {
  return (i < 4 ? 0 : 32) + warp * 4 + (i & 3);
}

// Insert (cd, ci), which beats the list's last entry, into the sorted list
// (ld, li) of KMAX entries; all 32 lanes of the warp take part.
template <int KMAX>
__device__ __forceinline__ void insert_warp(float* ld, int* li, float cd,
                                            int ci, int lane) {
  constexpr int PER = (KMAX + 31) / 32;
  float nd[PER];
  int ni[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = lane + 32 * m;
    if (e < KMAX) {
      const float od = ld[e];
      const int oi = li[e];
      if (better(od, oi, cd, ci)) {
        nd[m] = od;
        ni[m] = oi;
      } else if (e == 0 || better(ld[e - 1], li[e - 1], cd, ci)) {
        nd[m] = cd;
        ni[m] = ci;
      } else {
        nd[m] = ld[e - 1];
        ni[m] = li[e - 1];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = lane + 32 * m;
    if (e < KMAX) {
      ld[e] = nd[m];
      li[e] = ni[m];
    }
  }
  __syncwarp();
}

// An empty list (a split's first tile) takes the tile's best k directly,
// in k rounds of a warp-wide arg-min over the lanes' candidates: far
// fewer steps than inserting the ~k ln(256/k) candidates that beat a
// still-infinite threshold one at a time. Fewer than k valid candidates
// leave the rest of the list empty.
__device__ __forceinline__ void fill_empty(const float (&dv)[8], int r0,
                                           int n, int k, float* ld, int* li,
                                           int lane) {
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (r0 + col_of(lane, j) < n) live |= 1u << j;
  for (int s = 0; s < k; ++s) {
    float bd = INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = r0 + col_of(lane, j);
      if (((live >> j) & 1u) && better(dv[j], c, bd, bi)) {
        bd = dv[j];
        bi = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, bd, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (better(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    if (bi == INT_MAX) break;  // every lane holds the same winner
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (r0 + col_of(lane, j) == bi) live &= ~(1u << j);
    if (lane == 0) {
      ld[s] = bd;
      li[s] = bi;
    }
  }
  __syncwarp();
}

// One tile's candidates of the warp's 8 rows into the rows' lists.
template <int KMAX>
__device__ __forceinline__ void select_tile(const float (&acc)[8][8],
                                            const float* __restrict__ qn,
                                            const float* __restrict__ rn,
                                            int q0, int r0, int n, int k,
                                            float* Ld, int* Li, int warp,
                                            int lane) {
  const float4 ra = *reinterpret_cast<const float4*>(rn + r0 + lane * 4);
  const float4 rb =
      *reinterpret_cast<const float4*>(rn + r0 + 128 + lane * 4);
  const float rr[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ql = row_of(warp, i);
    const float qq = qn[q0 + ql];
    float* ld = Ld + ql * KMAX;
    int* li = Li + ql * KMAX;
    float dv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dv[j] = fmaxf(qq + rr[j] - 2.0f * acc[i][j], 0.0f);
    if (li[0] == INT_MAX) {  // the same row in every lane: uniform
      fill_empty(dv, r0, n, k, ld, li, lane);
      continue;
    }
    float td = ld[k - 1];
    int ti = li[k - 1];
    unsigned surv = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = r0 + col_of(lane, j);
      if (col < n && better(dv[j], col, td, ti)) surv |= 1u << j;
    }
    while (__any_sync(FULL, surv != 0)) {
      const int leader = __ffs(__ballot_sync(FULL, surv != 0)) - 1;
      float cd = 0.0f;
      int ci = 0;
      if (lane == leader) {
        const int s = __ffs(surv) - 1;
        surv &= surv - 1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j == s) {
            cd = dv[j];
            ci = r0 + col_of(lane, j);
          }
        }
      }
      cd = __shfl_sync(FULL, cd, leader);
      ci = __shfl_sync(FULL, ci, leader);
      insert_warp<KMAX>(ld, li, cd, ci, lane);
      td = ld[k - 1];
      ti = li[k - 1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (((surv >> j) & 1u) &&
            !better(dv[j], r0 + col_of(lane, j), td, ti))
          surv &= ~(1u << j);
      }
    }
  }
}

// rows [0, nq_pad) of the output are |q|^2 (0 past nq), rows
// [nq_pad, nq_pad + n_pad) are |r|^2 (0 past n). Each sum runs over the
// features in order, one fmaf at a time from 0, as the partial kernel's
// dot products do: a point's distance to itself is then exactly 0, and
// the distances are K4's (pairwise.cu) bit for bit. A warp stages 32
// rows x 32 features at a time (coalesced) and lane l sums row l.
__global__ void __launch_bounds__(NORM_THREADS)
knn_norms_kernel(const float* __restrict__ q, const float* __restrict__ r,
                 float* __restrict__ norms, int nq, int nq_pad, int n,
                 int n_pad, int d) {
  __shared__ float tile[NORM_THREADS / 32][32][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * (NORM_THREADS / 32) + warp) * 32;
  if (row0 >= nq_pad + n_pad) return;
  float(*t)[33] = tile[warp];
  float s = 0.0f;
  for (int f0 = 0; f0 < d; f0 += 32) {
#pragma unroll  // 32 loads in flight per lane
    for (int j = 0; j < 32; ++j) {
      // nq_pad is a multiple of 32: a warp's rows are all q or all r
      const int row = row0 + j;
      const bool is_q = row < nq_pad;
      const int i = is_q ? row : row - nq_pad;
      const bool ok = i < (is_q ? nq : n) && f0 + lane < d;
      t[j][lane] =
          ok ? (is_q ? q : r)[(long long)i * d + f0 + lane] : 0.0f;
    }
    __syncwarp();
#pragma unroll
    for (int f = 0; f < 32; ++f) s = fmaf(t[lane][f], t[lane][f], s);
    __syncwarp();
  }
  if (row0 + lane < nq_pad + n_pad) norms[row0 + lane] = s;
}

template <int KMAX, bool RES>
__global__ void __launch_bounds__(THREADS, 2)
knn_partial_kernel(const float* __restrict__ q, const float* __restrict__ r,
                   const float* __restrict__ qn, const float* __restrict__ rn,
                   float* __restrict__ part_d, int* __restrict__ part_i,
                   int nq, int n, int d, int k, int tiles_per_split,
                   int splits) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = padded_d(d);
  const int nchunks = dp / TD;
  constexpr int STAGE = STAGE_R + (RES ? 0 : STAGE_Q);
  float* Qres = smem;
  float* ring = smem + (RES ? dp * LDQ : 0);
  float* Ld = ring + 2 * STAGE;
  int* Li = reinterpret_cast<int*>(Ld + TQ * KMAX);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int n_tiles = (n + TR - 1) / TR;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);

  for (int e = tid; e < TQ * KMAX; e += THREADS) {
    Ld[e] = INFINITY;
    Li[e] = INT_MAX;
  }

  // chunk (tile, dc) of the references (and, without a resident query
  // tile, of the queries) into ring stage buf
  auto stage = [&](int tile, int dc, int buf) {
    // a thread copies one feature (col) of 16 rows, 16 rows apart: a
    // warp reads two rows' 64 contiguous bytes per copy
    const int col = tid % TD, row0 = tid / TD;
    const int f = dc * TD + col;
    const bool f_ok = f < d;
    float* Rs = ring + buf * STAGE;
    {
      const int r_row = tile * TR + row0;
      const float* src = r + (long long)r_row * d + f;
      float* dst = Rs + col * LDR + row0;
#pragma unroll
      for (int m = 0; m < TR / (THREADS / TD); ++m) {
        const bool ok = f_ok && r_row + m * (THREADS / TD) < n;
        cp_async4(dst + m * (THREADS / TD),
                  ok ? src + (long long)m * (THREADS / TD) * d : r, ok);
      }
    }
    if (!RES) {
      const int q_row = q0 + row0;
      const float* src = q + (long long)q_row * d + f;
      float* dst = Rs + STAGE_R + col * LDQ + row0;
#pragma unroll
      for (int m = 0; m < TQ / (THREADS / TD); ++m) {
        const bool ok = f_ok && q_row + m * (THREADS / TD) < nq;
        cp_async4(dst + m * (THREADS / TD),
                  ok ? src + (long long)m * (THREADS / TD) * d : q, ok);
      }
    }
    cp_async_commit();
  };

  if (RES) {  // the block's queries, once, for the whole reference range
    for (int e = tid; e < TQ * dp; e += THREADS) {
      const int row = e / dp, col = e - row * dp;
      const int qi = q0 + row;
      const bool ok = qi < nq && col < d;
      cp_async4(&Qres[col * LDQ + row], ok ? q + (long long)qi * d + col : q,
                ok);
    }
    cp_async_commit();
  }

  int cur_tile = tile_begin, cur_dc = 0;  // the chunk being multiplied
  int nxt_tile = tile_begin, nxt_dc = 0;  // the next chunk to stage
  int buf = 0;
  if (nxt_tile < tile_end) {
    stage(nxt_tile, nxt_dc, 0);
    if (++nxt_dc == nchunks) {
      nxt_dc = 0;
      ++nxt_tile;
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  while (cur_tile < tile_end) {
    cp_async_wait_all();
    __syncthreads();  // chunk cur is in; every warp is done with buf ^ 1
    if (nxt_tile < tile_end) {
      stage(nxt_tile, nxt_dc, buf ^ 1);
      if (++nxt_dc == nchunks) {
        nxt_dc = 0;
        ++nxt_tile;
      }
    }
    const float* Rs = ring + buf * STAGE;
    const float* Qs = RES ? Qres + cur_dc * TD * LDQ : Rs + STAGE_R;
#pragma unroll
    for (int dd = 0; dd < TD; ++dd) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&Qs[dd * LDQ + warp * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&Qs[dd * LDQ + 32 + warp * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&Rs[dd * LDR + lane * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Rs[dd * LDR + 128 + lane * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    buf ^= 1;
    if (++cur_dc == nchunks) {
      select_tile<KMAX>(acc, qn, rn, q0, cur_tile * TR, n, k, Ld, Li, warp,
                        lane);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      cur_dc = 0;
      ++cur_tile;
    }
  }

  __syncthreads();  // every row's list is final
  for (int e = tid; e < TQ * k; e += THREADS) {
    const int row = e / k, s = e - row * k;
    const int qg = q0 + row;
    if (qg < nq) {
      const long long o = ((long long)qg * splits + split) * k + s;
      part_d[o] = Ld[row * KMAX + s];
      part_i[o] = Li[row * KMAX + s];
    }
  }
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

template <int KMAX, bool RES>
int blocks_per_sm(int d) {
  const size_t bytes = sizeof(float) * smem_floats<KMAX, RES>(padded_d(d));
  cudaError_t err = cudaFuncSetAttribute(
      knn_partial_kernel<KMAX, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return -(int)err;
  int nb = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, knn_partial_kernel<KMAX, RES>, THREADS, bytes);
  if (err != cudaSuccess) return -(int)err;
  return nb;
}

template <int KMAX, bool RES>
int launch(const float* q, const float* r, float* norms, float* part_d,
           int* part_i, float* out_d, int* out_i, int nq, int n, int d, int k,
           int splits, int tiles_per_split, cudaStream_t s) {
  const int q_tiles = (nq + TQ - 1) / TQ;
  const int nq_pad = q_tiles * TQ;
  const int n_pad = (n + TR - 1) / TR * TR;
  const int rows_per_block = NORM_THREADS;  // 32 rows a warp
  knn_norms_kernel<<<(nq_pad + n_pad + rows_per_block - 1) / rows_per_block,
                     NORM_THREADS, 0, s>>>(q, r, norms, nq, nq_pad, n, n_pad,
                                           d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = sizeof(float) * smem_floats<KMAX, RES>(padded_d(d));
  err = cudaFuncSetAttribute(knn_partial_kernel<KMAX, RES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  knn_partial_kernel<KMAX, RES><<<dim3(q_tiles, splits), THREADS, bytes, s>>>(
      q, r, norms, norms + nq_pad, part_d, part_i, nq, n, d, k,
      tiles_per_split, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_merge_kernel<KMAX><<<(nq + 127) / 128, 128, 0, s>>>(
      part_d, part_i, out_d, out_i, nq, k, splits);
  return (int)cudaGetLastError();
}

template <bool RES>
int dispatch(const float* q, const float* r, float* norms, float* pd,
             int* pi, float* od, int* oi, int nq, int n, int d, int k,
             int splits, int tps, cudaStream_t s) {
  if (k <= 8)
    return launch<8, RES>(q, r, norms, pd, pi, od, oi, nq, n, d, k, splits,
                          tps, s);
  if (k <= 16)
    return launch<16, RES>(q, r, norms, pd, pi, od, oi, nq, n, d, k, splits,
                           tps, s);
  if (k <= 32)
    return launch<32, RES>(q, r, norms, pd, pi, od, oi, nq, n, d, k, splits,
                           tps, s);
  return launch<64, RES>(q, r, norms, pd, pi, od, oi, nq, n, d, k, splits,
                         tps, s);
}

}  // namespace

// Resident blocks per SM of the partial kernel that (d, k) selects, from
// its registers and shared memory; a negative CUDA error code on failure.
extern "C" int srl_knn_blocks_per_sm(int d, int k) {
  if (d < 1 || k < 1 || k > 64) return -(int)cudaErrorInvalidValue;
  const bool res = padded_d(d) <= DRES;
  if (k <= 8)
    return res ? blocks_per_sm<8, true>(d) : blocks_per_sm<8, false>(d);
  if (k <= 16)
    return res ? blocks_per_sm<16, true>(d) : blocks_per_sm<16, false>(d);
  if (k <= 32)
    return res ? blocks_per_sm<32, true>(d) : blocks_per_sm<32, false>(d);
  return res ? blocks_per_sm<64, true>(d) : blocks_per_sm<64, false>(d);
}

// q: (nq, d) f32, r: (n, d) f32, both row-major contiguous. norms: scratch
// of ceil(nq/64)*64 + ceil(n/256)*256 floats; part_d/part_i: (nq, splits,
// k) scratch; out_d/out_i: (nq, k). 1 <= k <= min(64, n); the splits cover
// the ceil(n/256) reference tiles with tiles_per_split each, none empty.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int srl_knn_topk(const void* q, const void* r, void* norms,
                            void* part_d, void* part_i, void* out_d,
                            void* out_i, int nq, int n, int d, int k,
                            int splits, int tiles_per_split, void* stream) {
  if (nq == 0) return 0;
  const int n_tiles = (n + TR - 1) / TR;
  if (nq < 0 || k < 1 || k > 64 || k > n || d < 1 || splits < 1 ||
      tiles_per_split < 1 || splits > 65535 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* qp = (const float*)q;
  const float* rp = (const float*)r;
  float* np_ = (float*)norms;
  float* pd = (float*)part_d;
  int* pi = (int*)part_i;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  if (padded_d(d) <= DRES)
    return dispatch<true>(qp, rp, np_, pd, pi, od, oi, nq, n, d, k, splits,
                          tiles_per_split, s);
  return dispatch<false>(qp, rp, np_, pd, pi, od, oi, nq, n, d, k, splits,
                         tiles_per_split, s);
}
