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
// neighbours share, so the least traffic is one read of x and one write
// of y (plus one byte per output for idx); ten compares per output are
// nothing next to 3.35 TB/s. A first kernel with one thread per output
// element reached 45% of that bound in f32 and 22% in bf16: its per-element
// 64-bit index decode, nine scalar 2- or 4-byte loads and scalar stores cost
// instructions, not bytes, and neighbouring output rows re-read their shared
// input row through L2.
//
// Vector path (C * sizeof(T) a multiple of 16 bytes, x and y 16-byte
// aligned, idx aligned to its packed width):
// - A block owns a tile of TH = 4 output rows x TW output columns x CB
//   16-byte channel vectors of one image. It stages the tile's input window,
//   (2 TH + 1) x (2 TW + 1) pixels x CB vectors, into shared memory with
//   16-byte cp.async copies; positions outside the image are stored as -inf
//   (the XLA pool's padding), so the compare loop has no branches on
//   geometry. Each input byte then comes from device memory about once: the
//   halo is one row in 2 TH + 1 and one column in 2 TW + 1, and the
//   neighbouring tiles that share it run at the same time, so L2 serves it.
// - A thread owns one 16-byte vector of channels (4 f32, 8 bf16/f16) of two
//   neighbouring outputs along W (NW = 2). It reads the 3 x 5 staged
//   vectors they need (the shared column 2 ow + 2 stays in registers), and
//   writes y as 16-byte stores and idx as one packed 4- or 8-byte store.
// - Index math is 32-bit and done once per block and per thread; only the
//   base offsets of the staged copies and of the stores are 64-bit.
// - Tile sizes: 256 threads = TH x (TW / 2) x CB, so TW = 128 / CB, with CB
//   the least power of two >= C / vector width, at most 16 (wider channel
//   dimensions take several chunks of 16 vectors, one per block). Shared
//   memory per block is 9 x (2 TW + 1) x CB x 16 B, 37.0-39.2 KB for every
//   CB (C = 64: f32 CB = 16, TW = 8, 39,168 B; bf16 CB = 8, TW = 16,
//   38,016 B). That stays under the 48 KB a block may take without opting
//   in, and lets five blocks (1,280 threads) share an SM's 227 KB, so the
//   copies of one block overlap the compares and stores of the others: one
//   tile per block needs no ring of buffers. At most 4 output columns (the
//   7x7 pool, 4 x 4 outputs) take a narrow tile instead: TW = 4 and one
//   output per thread (4 x 4 x CB threads, 9 x 9 x CB x 16 B = 20.7 KB at
//   f32 C = 64). The wide tile would stage 9 x 17 pixels for a 7 x 7 image,
//   mostly -inf, and there the kernel takes a few microseconds, set by each
//   block's chain of copy, wait and compares rather than by bytes. At the
//   three pools of a 224 px config-1 forward at batch 32, f32: 3,136, 256
//   and 32 blocks on 132 SMs.
//
// Scalar path (any other C or alignment, e.g. C = 3, or a slice of a larger
// tensor at an odd storage offset): one thread per output element with the
// channel fastest, 32-bit index math where the tensors allow it.
//
// Argmax: a strict '>' in raster order, so the first window maximum wins,
// and sentinel 9 at a maximum <= 0. The TPU kernel packed the argmax into
// mantissa bits because the v5e VPU has no 16-bit compares; here the index
// is a register. Compares run in f32, which holds bf16 and f16 exactly, and
// y is one of the inputs or 0, so y and idx equal the plain version's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 4;  // TH, output rows of a vector-path tile

template <typename T>
struct alignas(16) Vec {
  T v[16 / sizeof(T)];
};

template <int V>
struct alignas(V) Idx {
  uint32_t w[V / 4];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: v is one of the inputs, 0 or -inf
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <typename T, int V>
__device__ __forceinline__ void store_out(T* y, int8_t* idx, long long o,
                                          const float (&m)[V],
                                          const int (&arg)[V]) {
  Vec<T> out;
  Idx<V> packed;
#pragma unroll
  for (int w = 0; w < V / 4; ++w) packed.w[w] = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    bool pos = m[j] > 0.0f;
    out.v[j] = from_f<T>(pos ? m[j] : 0.0f);
    packed.w[j >> 2] |= (uint32_t)(pos ? arg[j] : 9) << (8 * (j & 3));
  }
  *reinterpret_cast<Vec<T>*>(y + o) = out;
  if (idx != nullptr) *reinterpret_cast<Idx<V>*>(idx + o) = packed;
}

// CB channel vectors, TW output columns, NW outputs along W per thread
template <typename T, int CB, int TW, int NW>
__global__ void __launch_bounds__(kTileRows * (TW / NW) * CB)
    relu_max_pool_fwd_vec(const T* __restrict__ x, T* __restrict__ y,
                          int8_t* __restrict__ idx, int H, int W, int C,
                          int OH, int OW, int pad_top, int pad_left, int n_ct,
                          int n_rt, int n_ch) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kThr = kTileRows * (TW / NW) * CB;
  constexpr int SR = 2 * kTileRows + 1;
  constexpr int SC = 2 * TW + 1;
  extern __shared__ uint4 smem_raw[];
  Vec<T>* tile = reinterpret_cast<Vec<T>*>(smem_raw);  // [SR][SC][CB]

  const int cvec = C / V;
  int blk = blockIdx.x;
  const int ct = blk % n_ct;
  blk /= n_ct;
  const int rt = blk % n_rt;
  blk /= n_rt;
  const int ch = blk % n_ch;
  const int b = blk / n_ch;
  const int oh0 = rt * kTileRows, ow0 = ct * TW, cv0 = ch * CB;
  const int ih0 = 2 * oh0 - pad_top, iw0 = 2 * ow0 - pad_left;
  const T* xb = x + (long long)b * H * W * C + cv0 * V;

  Vec<T> ninf;
#pragma unroll
  for (int j = 0; j < V; ++j) ninf.v[j] = from_f<T>(-INFINITY);
  for (int i = threadIdx.x; i < SR * SC * CB; i += kThr) {
    const int cv = i % CB, p = i / CB;
    const int r = p / SC, c = p - r * SC;
    const int ih = ih0 + r, iw = iw0 + c;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W && cv0 + cv < cvec)
      cp_async16(&tile[i], xb + ((long long)ih * W + iw) * C + cv * V);
    else
      tile[i] = ninf;
  }
  cp_async_wait_all();
  __syncthreads();

  const int cv = threadIdx.x % CB;
  const int rest = threadIdx.x / CB;
  const int pc = rest % (TW / NW);  // the thread's NW columns of the tile
  const int r = rest / (TW / NW);   // output row of the tile
  const int oh = oh0 + r, ow = ow0 + NW * pc;
  if (oh >= OH || ow >= OW || cv0 + cv >= cvec) return;

  float m[NW][V];
  int a[NW][V];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[n][j] = -INFINITY;
      a[n][j] = 9;
    }
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const Vec<T>* row = tile + ((2 * r + dy) * SC + 2 * NW * pc) * CB + cv;
    Vec<T> v[2 * NW + 1];  // output n reads columns 2n .. 2n + 2
#pragma unroll
    for (int q = 0; q < 2 * NW + 1; ++q) v[q] = row[q * CB];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_f(v[2 * n + dx].v[j]);
          if (f > m[n][j]) {
            m[n][j] = f;
            a[n][j] = dy * 3 + dx;
          }
        }
  }
  const long long o =
      (((long long)b * OH + oh) * OW + ow) * C + (cv0 + cv) * V;
#pragma unroll
  for (int n = 0; n < NW; ++n)
    if (ow + n < OW) store_out<T, V>(y, idx, o + n * C, m[n], a[n]);
}

// I is the index type: 32-bit whenever the tensors allow it, because 64-bit
// division is a long instruction sequence and this kernel divides three
// times per element.
template <typename T, typename I>
__global__ void relu_max_pool_fwd_scalar(const T* __restrict__ x,
                                         T* __restrict__ y,
                                         int8_t* __restrict__ idx, int H,
                                         int W, int C, int OH, int OW,
                                         int pad_top, int pad_left,
                                         I total) {
  I o = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int c = (int)(o % C);
  I p = o / C;
  int ow = (int)(p % OW);
  p /= OW;
  int oh = (int)(p % OH);
  long long b = (long long)(p / OH);

  const T* xb = x + b * H * W * C + c;
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

template <typename T, int CB, int TW, int NW>
int launch_vec(const T* x, T* y, int8_t* idx, int B, int H, int W, int C,
               int OH, int OW, int pad_top, int pad_left, cudaStream_t s) {
  constexpr int threads = kTileRows * (TW / NW) * CB;
  const int cvec = C / (16 / (int)sizeof(T));
  const int n_ct = (OW + TW - 1) / TW;
  const int n_rt = (OH + kTileRows - 1) / kTileRows;
  const int n_ch = (cvec + CB - 1) / CB;
  const long long blocks = (long long)n_ct * n_rt * n_ch * B;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)(2 * kTileRows + 1) * (2 * TW + 1) * CB * 16;
  relu_max_pool_fwd_vec<T, CB, TW, NW>
      <<<(unsigned)blocks, threads, smem, s>>>(x, y, idx, H, W, C, OH, OW,
                                               pad_top, pad_left, n_ct, n_rt,
                                               n_ch);
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int launch_cb(const T* x, T* y, int8_t* idx, int B, int H, int W, int C,
              int OH, int OW, int pad_top, int pad_left, cudaStream_t s) {
  // at most 4 output columns (the 7x7 pool): a 4 x 4 tile with one output
  // per thread, so a block stages the 9 x 9 pixels it reads and no wide
  // window mostly outside the image, and each thread's chain of compares
  // is half as long
  if (OW <= 4)
    return launch_vec<T, CB, 4, 1>(x, y, idx, B, H, W, C, OH, OW, pad_top,
                                   pad_left, s);
  return launch_vec<T, CB, 2 * kThreads / (kTileRows * CB), 2>(
      x, y, idx, B, H, W, C, OH, OW, pad_top, pad_left, s);
}

bool misaligned(const void* p, int bytes) {
  return ((uintptr_t)p) % bytes != 0;
}

template <typename T>
int launch(const void* xv, void* yv, void* idxv, int B, int H, int W, int C,
           int OH, int OW, int pad_top, int pad_left, int vector,
           cudaStream_t s) {
  const T* x = (const T*)xv;
  T* y = (T*)yv;
  int8_t* idx = (int8_t*)idxv;
  constexpr int V = 16 / sizeof(T);
  if (vector) {
    // the caller asked for the vector path: refuse what it cannot read
    if (C % V != 0 || misaligned(x, 16) || misaligned(y, 16) ||
        (idx != nullptr && misaligned(idx, V)))
      return (int)cudaErrorInvalidValue;
    const int cvec = C / V;
    int cb = 1;
    while (cb < cvec && cb < 16) cb *= 2;
    switch (cb) {
      case 1:
        return launch_cb<T, 1>(x, y, idx, B, H, W, C, OH, OW, pad_top,
                               pad_left, s);
      case 2:
        return launch_cb<T, 2>(x, y, idx, B, H, W, C, OH, OW, pad_top,
                               pad_left, s);
      case 4:
        return launch_cb<T, 4>(x, y, idx, B, H, W, C, OH, OW, pad_top,
                               pad_left, s);
      case 8:
        return launch_cb<T, 8>(x, y, idx, B, H, W, C, OH, OW, pad_top,
                               pad_left, s);
      default:
        return launch_cb<T, 16>(x, y, idx, B, H, W, C, OH, OW, pad_top,
                                pad_left, s);
    }
  }
  const long long total = (long long)B * OH * OW * C;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (total < (1LL << 31))
    relu_max_pool_fwd_scalar<T, int><<<blocks, kThreads, 0, s>>>(
        x, y, idx, H, W, C, OH, OW, pad_top, pad_left, (int)total);
  else
    relu_max_pool_fwd_scalar<T, long long><<<blocks, kThreads, 0, s>>>(
        x, y, idx, H, W, C, OH, OW, pad_top, pad_left, total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. idx may be null. vector:
// 1 takes the vector path (C * element size a multiple of 16 bytes, x and y
// 16-byte aligned, idx aligned to 16 / element size; else the call returns
// cudaErrorInvalidValue and launches nothing), 0 the scalar path.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int srl_relu_max_pool_fwd(const void* x, void* y, void* idx,
                                     int dtype, int B, int H, int W, int C,
                                     int OH, int OW, int pad_top,
                                     int pad_left, int vector, void* stream) {
  if ((long long)B * OH * OW * C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, y, idx, B, H, W, C, OH, OW, pad_top, pad_left,
                           vector, s);
    case 1:
      return launch<__nv_bfloat16>(x, y, idx, B, H, W, C, OH, OW, pad_top,
                                   pad_left, vector, s);
    case 2:
      return launch<__half>(x, y, idx, B, H, W, C, OH, OW, pad_top, pad_left,
                            vector, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
