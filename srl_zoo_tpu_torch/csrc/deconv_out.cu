// The CNN decoder's last deconvolution with its bias and tanh (K5), forward
// and backward, over NHWC float32.
//
// Replaces no TPU kernel: the JAX package leaves ConvTranspose and tanh to
// XLA. Here cuDNN ran the deconvolution in generic engines between layout
// transposes, and tanh and its backward made two more passes over the
// reconstruction; this source does each direction in one pass.
//
//   y  = tanh(conv_transpose2d(x, W, b, stride 2, padding 1))
//        x (B, H, W, Cin) -> y (B, 2H, 2W, C), W torch's (Cin, C, 4, 4)
//   Along each axis output o = 2 i - 1 + k, so output quad (2m + pi, 2n + pj)
//   reads x rows m - 1 (k 3), m (k 1) for pi = 0 and m (k 2), m + 1 (k 0)
//   for pi = 1, and the same of columns for pj: a 3 x 3 neighbourhood of
//   x and its parity's 2 x 2 taps.
//   gp = g (1 - y^2), the gradient before the tanh, never stored;
//   dx[m, n]       = sum over c, kh, kw of
//                    gp[2m - 1 + kh, 2n - 1 + kw, c] W[.., c, kh, kw]
//   dW[.., kh, kw] = sum over b, m, n of x[m, n] gp[2m - 1 + kh, 2n - 1 + kw]
//   db[c]          = sum of gp[.., c]
//
// Bound on the H100: bytes, with the multiply-adds close behind. At the
// decoder's last layer of a 224 px config-1 step (B 32, 112^2 x 16 -> 224^2
// x 3) the forward reads x (25.7 MB) and writes y (19.3 MB), 13.4 us at
// 3.35 TB/s, against 308 M multiply-adds, 9.2 us of the card's f32 rate; the
// backward reads g, y and x and writes dx (89.9 MB, 26.8 us) against 616 M.
// W is read from shared memory as broadcast 16-byte vectors into
// registers, and each thread keeps several outputs' sums so that a staged
// value feeds many multiply-adds. Measured on the H100 (PERF.md): a
// uniform 16-byte shared read costs two shared-memory cycles of the SM, a
// scalar one one, so at 4 quads a thread the weight and x reads take about
// as many SM cycles as the multiply-adds; and staging x one 4-byte copy a
// channel with its own index arithmetic cost more issue slots than the
// multiply-adds, so a thread keeps one channel and walks whole rows.
//
// Forward (deconv_out_tanh_fwd): a fixed grid (as many blocks as fit on
// the card) walks 16 x 16 tiles of input positions of one image (the
// decoder's input sides are multiples of 16, so its tiles are whole). A
// block stages a tile's x with a one-position halo, 18 x 18 x Cin,
// channel-planar in shared memory, zeros outside the image (the transposed
// convolution's padding), with cp.async copies into one of two buffers
// while it computes the tile before. Each of its 64 threads owns 4 input
// rows of one column: 4 output quads, 16 C sums. Per input channel it
// takes the channel's 16 C taps into registers, then walks the 6 x rows
// it needs top to bottom, 3 scalar reads a row, each row feeding the quads
// above, at and below it. Output channels go in chunks of at most 4 (C up
// to 8) to bound the sums. The epilogue adds the bias, takes tanhf and
// stores y; no pre-activation is stored.
//
// Backward (deconv_out_tanh_bwd): a fixed grid of blocks (as many as fit
// on the card, which the caller asks srl_deconv_out_grid for) walks the
// tiles in a fixed order, block k taking tiles k, k + grid, ... For a tile
// it stages x (16 x 16 x Cin, no halo) and the raw g and y of the tile's
// outputs with a one-output halo, (2 x 16 + 2)^2 x C, then turns them into
// gp planes, zeros outside the image. The next tile's g and y are copied
// while this tile's dW is computed, its x while this tile's dx is.
// - dW: a thread owns one (4 input channels, kh, output channel chunk)
//   block of dW, 16 x chunk sums, and one of 128 / units position groups
//   of the tile; per position it reads 4 x values and a 4-wide gp row per
//   channel. Its sums run on over the block's tiles.
// - dx: each of 128 threads owns 2 input rows of one column; per output
//   channel it reads the 6 x 4 gp window those rows need (8-byte reads),
//   then per input channel the 16 taps, and writes dx 8 channels at a time
//   as 16-byte stores.
// - db: each thread adds the gp values it turns that are the tile's own
//   outputs (not the halo), so every output counts once.
// After the walk a block adds its threads' sums in a tree in shared
// memory and writes one row of partials, [Cin4][CP][16] then [CP], to the
// caller's workspace (taken from torch's allocator, so a captured graph
// keeps it in its pool). deconv_out_tanh_reduce then adds the rows, 8
// strided slices a column in registers and a tree of the 8: no float
// atomics, every sum in a fixed order, so a replay equals an eager call
// bit for bit, and no sum runs over more than a few hundred terms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 16;  // input rows of a tile
constexpr int TC = 16;  // input columns of a tile

// the output channels in NCH chunks of CK (the sums a thread keeps), CP
// of them with the padding that the staged weights carry as zeros
template <int C>
struct Chunks {
  static constexpr int NCH = (C + 3) / 4;
  static constexpr int CK = (C + NCH - 1) / NCH;
  static constexpr int CP = NCH * CK;
};

// forward
constexpr int FP = 4;                    // input rows (quads) a thread owns
constexpr int F_THREADS = TR / FP * TC;  // 64
constexpr int XR = TR + 2;               // staged x rows, with the halo
constexpr int XC = TC + 2;
constexpr int XRS = 20;  // row stride of a staged x plane: the two thread
                         // rows of a warp read 16 banks apart
constexpr int XPL = XR * XRS + 1;  // plane stride (odd: the 16 channels of
                                   // a warp's staging copies spread over
                                   // the banks)

// backward
constexpr int BP = 2;                    // dx rows a thread owns
constexpr int B_THREADS = TR / BP * TC;  // 128
constexpr int GR = 2 * TR + 2;           // staged gp rows, with the halo
constexpr int GC = 2 * TC + 2;
constexpr int GRS = 36;  // row stride of a staged gp plane (8-byte reads;
                         // the four kh rows of a warp fall 4 banks apart)
constexpr int GPL = GR * GRS;
constexpr int CI_CHUNK = 8;  // dx channels a thread sums at once

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// 4 or 16 bytes from gmem to smem without a register round trip; zeros
// instead where valid is false (gmem is then not read)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for every copy this thread has in flight
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// ws[(ci * CP + c) * 16 + k] = w[(ci * C + c) * 16 + k] for ci < Cin16 (a
// multiple of 16), zeros for the padding channels (copies in flight)
__device__ __forceinline__ void stage_weights(float* ws,
                                              const float* __restrict__ w,
                                              int Cin, int Cin16, int C,
                                              int CP) {
  for (int e = threadIdx.x; e < Cin16 * CP * 16; e += blockDim.x) {
    const int k = e & 15, c = (e >> 4) % CP, ci = (e >> 4) / CP;
    const bool valid = ci < Cin && c < C;
    cp_async4(ws + e, valid ? w + (ci * C + c) * 16 + k : w, valid);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// one x row (a, bb, d = columns n - 1, n, n + 1) at kernel row kh into the
// two outputs (pj = 0, 1) of one output row of a quad
template <int CK>
__device__ __forceinline__ void fwd_row(float (&o)[2][CK],
                                        const float (&wr)[CK][16], int kh,
                                        float a, float bb, float d) {
#pragma unroll
  for (int c = 0; c < CK; ++c) {
    o[0][c] = fmaf(a, wr[c][kh * 4 + 3], o[0][c]);
    o[0][c] = fmaf(bb, wr[c][kh * 4 + 1], o[0][c]);
    o[1][c] = fmaf(bb, wr[c][kh * 4 + 2], o[1][c]);
    o[1][c] = fmaf(d, wr[c][kh * 4 + 0], o[1][c]);
  }
}

// the image and first input row and column of a tile
__device__ __forceinline__ void tile_origin(int tile, int n_tr, int n_tc,
                                            int& b, int& m0, int& n0) {
  n0 = tile % n_tc * TC;
  tile /= n_tc;
  m0 = tile % n_tr * TR;
  b = tile / n_tr;
}

// x rows m0 - 1 .. m0 + TR, columns n0 - 1 .. n0 + TC into Cin4 planes,
// zeros outside the image and past Cin (copies in flight). A copy moves
// one channel of a position, channel fastest across threads (a warp reads
// 2 x 64 contiguous bytes a copy); a thread keeps its channel and walks
// whole rows, so a copy costs an address step and a bounds test.
__device__ __forceinline__ void stage_x_halo(float* xs,
                                             const float* __restrict__ x,
                                             int b, int m0, int n0, int H,
                                             int W, int Cin, int Cin4) {
  if (F_THREADS % Cin4 == 0) {
    const int ci = threadIdx.x % Cin4;
    for (int r = threadIdx.x / Cin4; r < XR; r += F_THREADS / Cin4) {
      const int m = m0 - 1 + r;
      const bool row = m >= 0 && m < H && ci < Cin;
      const float* src =
          x + (((long long)b * H + (row ? m : 0)) * W + n0 - 1) * Cin + ci;
      float* dst = xs + ci * XPL + r * XRS;
#pragma unroll
      for (int c = 0; c < XC; ++c) {
        const int n = n0 - 1 + c;
        const bool in = row && n >= 0 && n < W;
        cp_async4(dst + c, in ? src + c * Cin : x, in);
      }
    }
  } else {
    for (int e = threadIdx.x; e < XR * XC * Cin4; e += F_THREADS) {
      const int p = e / Cin4, ci = e - p * Cin4;
      const int r = p / XC, c = p - r * XC;
      const int m = m0 - 1 + r, n = n0 - 1 + c;
      const bool in = m >= 0 && m < H && n >= 0 && n < W && ci < Cin;
      cp_async4(xs + ci * XPL + r * XRS + c,
                in ? x + (((long long)b * H + m) * W + n) * Cin + ci : x, in);
    }
  }
  cp_async_commit();
}

template <int C>
__global__ void __launch_bounds__(F_THREADS)
    deconv_out_tanh_fwd(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ y,
                        int H, int W, int Cin, int n_tr, int n_tc,
                        int n_tiles) {
  using K = Chunks<C>;
  constexpr int CK = K::CK, CP = K::CP;
  const int Cin4 = round_up(Cin, 4), Cin16 = round_up(Cin, 16);
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [Cin16][CP][16]
  float* bs = ws + Cin16 * CP * 16;             // [8]
  float* xb = bs + 8;                           // [2][Cin4][XPL]

  stage_weights(ws, w, Cin, Cin16, C, CP);
  if (threadIdx.x < 8)
    bs[threadIdx.x] = threadIdx.x < C ? bias[threadIdx.x] : 0.0f;
  int b, m0, n0;
  if (blockIdx.x < n_tiles) {
    tile_origin(blockIdx.x, n_tr, n_tc, b, m0, n0);
    stage_x_halo(xb, x, b, m0, n0, H, W, Cin, Cin4);
  }

  const int tx = threadIdx.x % TC;  // the column: x columns tx .. tx + 2 staged
  const int ty = threadIdx.x / TC;  // rows ty FP .. ty FP + FP - 1
  const int OH = 2 * H, OW = 2 * W;
#pragma unroll 1
  for (int tile = blockIdx.x, i = 0; tile < n_tiles;
       tile += gridDim.x, ++i) {
    tile_origin(tile, n_tr, n_tc, b, m0, n0);
    const float* xs = xb + (i & 1) * Cin4 * XPL;
    cp_async_wait_all();
    // this tile's x has landed, and the last tile's readers are done with
    // the other buffer: copy the next tile's x into it while computing
    __syncthreads();
    if (tile + (int)gridDim.x < n_tiles) {
      int nb, nm0, nn0;
      tile_origin(tile + gridDim.x, n_tr, n_tc, nb, nm0, nn0);
      stage_x_halo(xb + ((i + 1) & 1) * Cin4 * XPL, x, nb, nm0, nn0, H, W,
                   Cin, Cin4);
    }
    const int n = n0 + tx;
#pragma unroll 1
    for (int k = 0; k < K::NCH; ++k) {
      float acc[FP][2][2][CK];  // [quad][pi][pj][channel]
#pragma unroll
      for (int q = 0; q < FP; ++q)
#pragma unroll
        for (int pi = 0; pi < 2; ++pi)
#pragma unroll
          for (int pj = 0; pj < 2; ++pj)
#pragma unroll
            for (int c = 0; c < CK; ++c) acc[q][pi][pj][c] = 0.0f;
#pragma unroll 2
      for (int ci = 0; ci < Cin; ++ci) {
        float wr[CK][16];
        const float4* wp =
            reinterpret_cast<const float4*>(ws + (ci * CP + k * CK) * 16);
#pragma unroll
        for (int c = 0; c < CK; ++c)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 t = wp[c * 4 + v];
            wr[c][4 * v] = t.x;
            wr[c][4 * v + 1] = t.y;
            wr[c][4 * v + 2] = t.z;
            wr[c][4 * v + 3] = t.w;
          }
        const float* xp = xs + ci * XPL + ty * FP * XRS + tx;
        // staged row r is x row m - 1 of quad r (kh 3 into pi 0), row m of
        // quad r - 1 (kh 1 into pi 0, kh 2 into pi 1) and row m + 1 of
        // quad r - 2 (kh 0 into pi 1)
#pragma unroll
        for (int r = 0; r < FP + 2; ++r) {
          const float a = xp[r * XRS], bb = xp[r * XRS + 1],
                      d = xp[r * XRS + 2];
          if (r < FP) fwd_row<CK>(acc[r][0], wr, 3, a, bb, d);
          if (r >= 1 && r <= FP) {
            fwd_row<CK>(acc[r - 1][0], wr, 1, a, bb, d);
            fwd_row<CK>(acc[r - 1][1], wr, 2, a, bb, d);
          }
          if (r >= 2) fwd_row<CK>(acc[r - 2][1], wr, 0, a, bb, d);
        }
      }
      if (n < W) {
#pragma unroll
        for (int q = 0; q < FP; ++q) {
          const int m = m0 + ty * FP + q;
          if (m >= H) break;
#pragma unroll
          for (int pi = 0; pi < 2; ++pi) {
            float* yp = y + (((long long)b * OH + 2 * m + pi) * OW + 2 * n) *
                                C + k * CK;
#pragma unroll
            for (int pj = 0; pj < 2; ++pj)
#pragma unroll
              for (int c = 0; c < CK; ++c)
                if (k * CK + c < C)
                  yp[pj * C + c] = tanhf(acc[q][pi][pj][c] + bs[k * CK + c]);
          }
        }
      }
    }
  }
}

// one tile's x (16 x 16 x Cin4 positions, copies in flight): 16-byte
// copies where Cin and the tensor allow them, else 4-byte ones; zeros
// outside the image and past Cin
__device__ __forceinline__ void stage_x_tile(float* xs,
                                             const float* __restrict__ x,
                                             int b, int m0, int n0, int H,
                                             int W, int Cin, int Cin4, int XS,
                                             bool vec) {
  const int t = threadIdx.x;
  const int ng = Cin4 >> 2;
  auto at = [&](int p) {  // position p of the tile, or -1 outside
    const int m = m0 + p / TC, n = n0 + p % TC;
    return m < H && n < W ? ((long long)b * H + m) * W + n : -1LL;
  };
  if (vec && B_THREADS % ng == 0) {
    const int q = t % ng;
    for (int p = t / ng; p < TR * TC; p += B_THREADS / ng) {
      const long long o = at(p);
      cp_async16(xs + p * XS + 4 * q, o >= 0 ? x + o * Cin + 4 * q : x,
                 o >= 0);
    }
  } else {
    for (int e = t; e < TR * TC * Cin4; e += B_THREADS) {
      const int p = e / Cin4, ci = e - p * Cin4;
      const long long o = at(p);
      const bool in = o >= 0 && ci < Cin;
      cp_async4(xs + p * XS + ci, in ? x + o * Cin + ci : x, in);
    }
  }
  cp_async_commit();
}

// one tile's raw g and y (copies in flight): its outputs with a one-output
// halo, rows 2 m0 - 1 .. 2 (m0 + TR) of C GC contiguous floats, a warp a
// row; zeros outside the image
template <int C>
__device__ __forceinline__ void stage_gy_tile(float* rg, float* ry,
                                              const float* __restrict__ g,
                                              const float* __restrict__ y,
                                              int b, int m0, int n0, int H,
                                              int W) {
  constexpr int ROW = GC * C;
  const int lane = threadIdx.x & 31;
  const int OH = 2 * H, OW = 2 * W;
  for (int r = threadIdx.x >> 5; r < GR; r += B_THREADS / 32) {
    const int oy = 2 * m0 - 1 + r;
    const bool row = oy >= 0 && oy < OH;
    const long long o =
        (((long long)b * OH + (row ? oy : 0)) * OW + 2 * n0 - 1) * C;
#pragma unroll
    for (int e = lane; e < ROW; e += 32) {
      const int ox = 2 * n0 - 1 + e / C;
      const bool in = row && ox >= 0 && ox < OW;
      cp_async4(rg + r * ROW + e, in ? g + o + e : g, in);
      cp_async4(ry + r * ROW + e, in ? y + o + e : y, in);
    }
  }
  cp_async_commit();
}

template <int C>
__global__ void __launch_bounds__(B_THREADS, 3)
    deconv_out_tanh_bwd(const float* __restrict__ g,
                        const float* __restrict__ y,
                        const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ dx,
                        float* __restrict__ part, int H, int W, int Cin,
                        int n_tr, int n_tc, int n_tiles) {
  using K = Chunks<C>;
  constexpr int CK = K::CK, CP = K::CP;
  constexpr int NW = 16 * CK;  // a thread's dW sums
  constexpr int ROW = GC * C;  // raw floats of an output row of g (and y)
  const int Cin4 = round_up(Cin, 4), Cin16 = round_up(Cin, 16);
  const int XS = Cin4 + 4;  // staged x position stride (16-byte reads)
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [Cin16][CP][16]
  float* gs = ws + Cin16 * CP * 16;             // [CP][GPL]
  float* rg = gs + CP * GPL;                    // [GR][GC][C]
  float* ry = rg + round_up(GR * ROW, 4);       // [GR][GC][C]
  float* xs = ry + round_up(GR * ROW, 4);       // [TR * TC][XS]
  const int t = threadIdx.x;
  const bool vec = (Cin & 3) == 0 && aligned16(x);
  const bool vec_dx = (Cin & 3) == 0 && aligned16(dx);

  stage_weights(ws, w, Cin, Cin16, C, CP);
  for (int e = C * GPL + t; e < CP * GPL; e += B_THREADS) gs[e] = 0.0f;
  int b, m0, n0;
  if (blockIdx.x < n_tiles) {
    tile_origin(blockIdx.x, n_tr, n_tc, b, m0, n0);
    stage_x_tile(xs, x, b, m0, n0, H, W, Cin, Cin4, XS, vec);
    stage_gy_tile<C>(rg, ry, g, y, b, m0, n0, H, W);
  }

  // this thread's block of dW: unit u = (cg, kh, chunk), position group grp
  const int ng = Cin4 >> 2;
  const int nu = ng * 4 * K::NCH;  // <= 128: Cin <= 64, C <= 8
  const int kg = B_THREADS / nu;
  const int u = t % nu, grp = t / nu;
  const int cg = u % ng, kh = (u / ng) & 3, ck = u / (ng * 4);
  const bool dw_on = grp < kg;
  float dw[4][CK][4];  // [input channel of the group][channel][kw]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < CK; ++c)
#pragma unroll
      for (int kw = 0; kw < 4; ++kw) dw[j][c][kw] = 0.0f;
  float db[C];
#pragma unroll
  for (int c = 0; c < C; ++c) db[c] = 0.0f;

  const int tx = t % TC, ty = t / TC;  // dx: column tx, rows ty BP ..
  const int lane = t & 31;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    tile_origin(tile, n_tr, n_tc, b, m0, n0);
    const int next = tile + gridDim.x;
    int nb, nm0, nn0;
    tile_origin(next, n_tr, n_tc, nb, nm0, nn0);
    cp_async_wait_all();
    __syncthreads();  // the tile's inputs have landed; gs is free
    // gp = g (1 - y^2) into planes, a warp a row; db takes the tile's own
    // outputs (not the halo)
    for (int r = t >> 5; r < GR; r += B_THREADS / 32) {
      const bool own = r >= 1 && r <= 2 * TR;
#pragma unroll
      for (int e = lane; e < ROW; e += 32) {
        const int cc = e / C, c = e - cc * C;
        const float yv = ry[r * ROW + e];
        const float v = rg[r * ROW + e] * (1.0f - yv * yv);
        if (own && cc >= 1 && cc <= 2 * TC) {
#pragma unroll
          for (int k = 0; k < C; ++k)
            if (k == c) db[k] += v;
        }
        gs[c * GPL + r * GRS + cc] = v;
      }
    }
    __syncthreads();  // gp is staged; the raw buffers are free
    if (next < n_tiles) stage_gy_tile<C>(rg, ry, g, y, nb, nm0, nn0, H, W);

    // dW: positions grp, grp + kg, ... of the tile
    if (dw_on) {
#pragma unroll 2
      for (int p = grp; p < TR * TC; p += kg) {
        const int ml = p / TC, nl = p % TC;
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + p * XS + 4 * cg);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          const float* gp =
              gs + (ck * CK + c) * GPL + (2 * ml + kh) * GRS + 2 * nl;
          const float2 lo = *reinterpret_cast<const float2*>(gp);
          const float2 hi = *reinterpret_cast<const float2*>(gp + 2);
          const float gv[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int kw = 0; kw < 4; ++kw)
              dw[j][c][kw] = fmaf(xa[j], gv[kw], dw[j][c][kw]);
        }
      }
    }
    __syncthreads();  // x is read: copy the next tile's
    if (next < n_tiles)
      stage_x_tile(xs, x, nb, nm0, nn0, H, W, Cin, Cin4, XS, vec);

    // dx of positions (m0 + ty BP + p, n0 + tx): staged gp rows
    // 2 (ty BP + p) + kh, columns 2 tx + kw
#pragma unroll 1
    for (int ci0 = 0; ci0 < Cin4; ci0 += CI_CHUNK) {
      float acc[BP][CI_CHUNK];
#pragma unroll
      for (int p = 0; p < BP; ++p)
#pragma unroll
        for (int j = 0; j < CI_CHUNK; ++j) acc[p][j] = 0.0f;
#pragma unroll 1
      for (int c = 0; c < C; ++c) {
        float gw[2 * BP + 2][4];
        const float* gp = gs + c * GPL + 2 * BP * ty * GRS + 2 * tx;
#pragma unroll
        for (int r = 0; r < 2 * BP + 2; ++r) {
          const float2 lo = *reinterpret_cast<const float2*>(gp + r * GRS);
          const float2 hi =
              *reinterpret_cast<const float2*>(gp + r * GRS + 2);
          gw[r][0] = lo.x;
          gw[r][1] = lo.y;
          gw[r][2] = hi.x;
          gw[r][3] = hi.y;
        }
#pragma unroll
        for (int j = 0; j < CI_CHUNK; ++j) {
          const float4* wp =
              reinterpret_cast<const float4*>(ws + ((ci0 + j) * CP + c) * 16);
          float wr[16];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 q = wp[v];
            wr[4 * v] = q.x;
            wr[4 * v + 1] = q.y;
            wr[4 * v + 2] = q.z;
            wr[4 * v + 3] = q.w;
          }
#pragma unroll
          for (int p = 0; p < BP; ++p)
#pragma unroll
            for (int kr = 0; kr < 4; ++kr)
#pragma unroll
              for (int kw = 0; kw < 4; ++kw)
                acc[p][j] =
                    fmaf(gw[2 * p + kr][kw], wr[kr * 4 + kw], acc[p][j]);
        }
      }
      const int n = n0 + tx;
#pragma unroll
      for (int p = 0; p < BP; ++p) {
        const int m = m0 + ty * BP + p;
        if (m >= H || n >= W) continue;
        float* dp = dx + (((long long)b * H + m) * W + n) * Cin + ci0;
        if (vec_dx && ci0 + CI_CHUNK <= Cin) {
#pragma unroll
          for (int v = 0; v < CI_CHUNK / 4; ++v)
            reinterpret_cast<float4*>(dp)[v] =
                make_float4(acc[p][4 * v], acc[p][4 * v + 1],
                            acc[p][4 * v + 2], acc[p][4 * v + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < CI_CHUNK; ++j)
            if (ci0 + j < Cin) dp[j] = acc[p][j];
        }
      }
    }
  }

  // the block's sums: a tree over the position groups of each unit, and
  // one over all threads for db, in the staging area
  __syncthreads();
  float* rw = gs;                   // [B_THREADS][NW]
  float* rb = gs + B_THREADS * NW;  // [B_THREADS][C]
  if (dw_on) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < CK; ++c)
#pragma unroll
        for (int kw = 0; kw < 4; ++kw)
          rw[t * NW + (j * CK + c) * 4 + kw] = dw[j][c][kw];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) rb[t * C + c] = db[c];
  __syncthreads();
  for (int s = 1; s < B_THREADS; s *= 2) {
    if (dw_on && grp % (2 * s) == 0 && grp + s < kg) {
      for (int i = 0; i < NW; ++i) rw[t * NW + i] += rw[(t + s * nu) * NW + i];
    }
    if (t % (2 * s) == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) rb[t * C + c] += rb[(t + s) * C + c];
    }
    __syncthreads();
  }
  const int row = Cin4 * CP * 16 + CP;
  float* out = part + (long long)blockIdx.x * row;
  if (dw_on && grp == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < CK; ++c)
#pragma unroll
        for (int kw = 0; kw < 4; ++kw)
          out[(((4 * cg + j) * CP + ck * CK + c) * 4 + kh) * 4 + kw] =
              rw[t * NW + (j * CK + c) * 4 + kw];
  }
  if (t < CP) out[Cin4 * CP * 16 + t] = t < C ? rb[t] : 0.0f;
}

// dW (Cin, C, 4, 4) and db (C) from the rows of partials: a block sums 32
// columns, each in 8 strided slices and a tree of the slices
__global__ void __launch_bounds__(256)
    deconv_out_tanh_reduce(const float* __restrict__ part,
                           float* __restrict__ dw, float* __restrict__ db,
                           int rows, int Cin, int C, int CP) {
  __shared__ float s[8][33];
  const int Cin4 = round_up(Cin, 4);
  const int row = Cin4 * CP * 16 + CP;
  const int e = blockIdx.x * 32 + threadIdx.x;
  float a = 0.0f;
  if (e < row)
    for (int r = threadIdx.y; r < rows; r += 8)
      a += part[(long long)r * row + e];
  s[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  for (int h = 4; h > 0; h >>= 1) {
    if (threadIdx.y < h)
      s[threadIdx.y][threadIdx.x] += s[threadIdx.y + h][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y != 0 || e >= row) return;
  const float v = s[0][threadIdx.x];
  if (e < Cin4 * CP * 16) {
    const int k = e & 15, c = (e >> 4) % CP, ci = (e >> 4) / CP;
    if (ci < Cin && c < C) dw[(ci * C + c) * 16 + k] = v;
  } else if (e - Cin4 * CP * 16 < C) {
    db[e - Cin4 * CP * 16] = v;
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int C>
size_t fwd_smem(int Cin) {
  constexpr int CP = Chunks<C>::CP;
  return sizeof(float) * ((size_t)round_up(Cin, 16) * CP * 16 + 8 +
                          2 * (size_t)round_up(Cin, 4) * XPL);
}

template <int C>
size_t bwd_smem(int Cin) {
  constexpr int CK = Chunks<C>::CK, CP = Chunks<C>::CP;
  const size_t stage = (size_t)CP * GPL + 2 * (size_t)round_up(GR * GC * C, 4) +
                       (size_t)TR * TC * (round_up(Cin, 4) + 4);
  const size_t reduce = (size_t)B_THREADS * (16 * CK + C);
  return sizeof(float) * ((size_t)round_up(Cin, 16) * CP * 16 +
                          (stage > reduce ? stage : reduce));
}

// a grid of as many blocks of kernel as fit on the device's sms SMs at
// once, at most one a tile; a negative CUDA error code on failure
template <typename Kernel>
int grid_of(Kernel kernel, int threads, size_t smem, long long tiles,
            int sms) {
  int err = allow_smem(kernel, smem);
  int per_sm = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem);
  if (err) return -err;
  const long long grid = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  return (int)(tiles < grid ? tiles : grid);
}

template <int C>
int launch_grid(int B, int H, int W, int Cin, int sms, int backward) {
  const long long tiles =
      (long long)B * ((H + TR - 1) / TR) * ((W + TC - 1) / TC);
  if (tiles >= (1LL << 31)) return -(int)cudaErrorInvalidConfiguration;
  if (backward)
    return grid_of(deconv_out_tanh_bwd<C>, B_THREADS, bwd_smem<C>(Cin), tiles,
                   sms);
  return grid_of(deconv_out_tanh_fwd<C>, F_THREADS, fwd_smem<C>(Cin), tiles,
                 sms);
}

template <int C>
int launch_fwd(const float* x, const float* w, const float* b, float* y,
               int B, int H, int W, int Cin, int grid, cudaStream_t s) {
  const int n_tr = (H + TR - 1) / TR, n_tc = (W + TC - 1) / TC;
  const long long tiles = (long long)B * n_tr * n_tc;
  if (tiles >= (1LL << 31) || grid < 1)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = fwd_smem<C>(Cin);
  const int err = allow_smem(deconv_out_tanh_fwd<C>, smem);
  if (err) return err;
  deconv_out_tanh_fwd<C><<<grid, F_THREADS, smem, s>>>(
      x, w, b, y, H, W, Cin, n_tr, n_tc, (int)tiles);
  return (int)cudaGetLastError();
}

template <int C>
int launch_bwd(const float* g, const float* y, const float* x,
               const float* w, float* dx, float* part, float* dw, float* db,
               int B, int H, int W, int Cin, int grid, cudaStream_t s) {
  constexpr int CP = Chunks<C>::CP;
  const int n_tr = (H + TR - 1) / TR, n_tc = (W + TC - 1) / TC;
  const long long tiles = (long long)B * n_tr * n_tc;
  if (tiles >= (1LL << 31) || grid < 1)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = bwd_smem<C>(Cin);
  const int err = allow_smem(deconv_out_tanh_bwd<C>, smem);
  if (err) return err;
  deconv_out_tanh_bwd<C><<<grid, B_THREADS, smem, s>>>(
      g, y, x, w, dx, part, H, W, Cin, n_tr, n_tc, (int)tiles);
  const int launched = (int)cudaGetLastError();
  if (launched) return launched;
  const int row = round_up(Cin, 4) * CP * 16 + CP;
  deconv_out_tanh_reduce<<<(row + 31) / 32, dim3(32, 8), 0, s>>>(
      part, dw, db, grid, Cin, C, CP);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward: x (B, H, W, Cin) and y (B, 2H, 2W, C) contiguous float32,
// w (Cin, C, 4, 4), b (C); 1 <= C <= 8, 1 <= Cin <= 64; grid >= 1 blocks
// walk the tiles (srl_deconv_out_grid's). Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int srl_deconv_out_tanh_fwd(const void* x, const void* w,
                                       const void* b, void* y, int B, int H,
                                       int W, int Cin, int C, int grid,
                                       void* stream) {
  if (Cin < 1 || Cin > 64 || C < 1 || C > 8 || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)b;
  float* yf = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
#define SRL_FWD(K) launch_fwd<K>(xf, wf, bf, yf, B, H, W, Cin, grid, s)
  switch (C) {
    case 1: return SRL_FWD(1);
    case 2: return SRL_FWD(2);
    case 3: return SRL_FWD(3);
    case 4: return SRL_FWD(4);
    case 5: return SRL_FWD(5);
    case 6: return SRL_FWD(6);
    case 7: return SRL_FWD(7);
    default: return SRL_FWD(8);
  }
#undef SRL_FWD
}

// The backward: g and y (B, 2H, 2W, C), x and dx (B, H, W, Cin), all
// contiguous float32; w (Cin, C, 4, 4); dw (Cin, C, 4, 4) and db (C) are
// written whole. part is a workspace of grid rows of
// srl_deconv_out_partials(Cin, C) floats; grid (srl_deconv_out_grid's, or
// any count >= 1: the sums' order follows it) blocks walk the tiles. Two
// launches (the tile walk, then the sum of the partials); returns
// cudaGetLastError() after the last (0 on success).
extern "C" int srl_deconv_out_tanh_bwd(const void* g, const void* y,
                                       const void* x, const void* w, void* dx,
                                       void* part, void* dw, void* db, int B,
                                       int H, int W, int Cin, int C, int grid,
                                       void* stream) {
  if (Cin < 1 || Cin > 64 || C < 1 || C > 8 || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const float* gf = (const float*)g;
  const float* yf = (const float*)y;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  float* dxf = (float*)dx;
  float* pf = (float*)part;
  float* dwf = (float*)dw;
  float* dbf = (float*)db;
  cudaStream_t s = (cudaStream_t)stream;
#define SRL_BWD(K) \
  launch_bwd<K>(gf, yf, xf, wf, dxf, pf, dwf, dbf, B, H, W, Cin, grid, s)
  switch (C) {
    case 1: return SRL_BWD(1);
    case 2: return SRL_BWD(2);
    case 3: return SRL_BWD(3);
    case 4: return SRL_BWD(4);
    case 5: return SRL_BWD(5);
    case 6: return SRL_BWD(6);
    case 7: return SRL_BWD(7);
    default: return SRL_BWD(8);
  }
#undef SRL_BWD
}

// The grid of the forward (backward 0) or the backward (1) at these shapes
// on the current device, which has sms SMs: as many blocks as fit on it at
// once, at most one a tile; a negative CUDA error code on failure.
extern "C" int srl_deconv_out_grid(int B, int H, int W, int Cin, int C,
                                   int sms, int backward) {
  if (Cin < 1 || Cin > 64 || C < 1 || C > 8 || B < 1 || H < 1 || W < 1 ||
      sms < 1)
    return -(int)cudaErrorInvalidValue;
  switch (C) {
    case 1: return launch_grid<1>(B, H, W, Cin, sms, backward);
    case 2: return launch_grid<2>(B, H, W, Cin, sms, backward);
    case 3: return launch_grid<3>(B, H, W, Cin, sms, backward);
    case 4: return launch_grid<4>(B, H, W, Cin, sms, backward);
    case 5: return launch_grid<5>(B, H, W, Cin, sms, backward);
    case 6: return launch_grid<6>(B, H, W, Cin, sms, backward);
    case 7: return launch_grid<7>(B, H, W, Cin, sms, backward);
    default: return launch_grid<8>(B, H, W, Cin, sms, backward);
  }
}

// The floats of one row of the backward's partials: [Cin4][CP][16], [CP].
extern "C" int srl_deconv_out_partials(int Cin, int C) {
  if (Cin < 1 || Cin > 64 || C < 1 || C > 8) return -1;
  const int nch = (C + 3) / 4, cp = nch * ((C + nch - 1) / nch);
  return round_up(Cin, 4) * cp * 16 + cp;
}
