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
// (1 B); per input it writes dx (4 B), four times the outputs' count, so
// the dx stores are three quarters of the traffic; a handful of compares
// and adds per input are nothing next to 3.35 TB/s. A first kernel with one
// thread per input element reached 23% of that bound at 112^2: three 32-bit
// divisions per element, up to four gathers of a 1-byte idx and a scalar g,
// one scalar store, and every output's g and idx read by up to four threads
// through L2.
//
// Vector path (C * sizeof(T) a multiple of 16 bytes, g and dx 16-byte
// aligned, idx aligned to 16 / sizeof(T)):
// - Quads. In padded coordinates, output oh covers rows 2 oh .. 2 oh + 2, so
//   the outputs that cover rows 2i and 2i + 1 are exactly oh = i - 1 and i,
//   and likewise for columns. A thread owns a 2x2 quad of input positions
//   (padded rows 2i, 2i + 1, columns 2j, 2j + 1) for one 16-byte vector of
//   channels (4 f32, 8 bf16/f16), reads the g vectors and packed idx
//   vectors of outputs (i-1, i) x (j-1, j), and writes four 16-byte dx
//   vectors. Odd pads shift the quad grid by one row or column; positions
//   outside the image are masked at the store, not copied.
// - Tiles. A block owns 8 quad rows x TQW quad columns x CB channel vectors
//   of one image, and stages the (8 + 1) x (TQW + 1) outputs they read, g
//   and idx, into shared memory with cp.async (16 bytes of g, 4 or 8 of
//   idx); outputs outside the plane are staged as idx -1 (matches nothing).
//   So each g and idx byte comes from device memory about once, not up to
//   four times through L2. Each thread walks 4 quad rows down one quad
//   column, and the lower outputs of one quad are the upper outputs of the
//   next, kept in registers.
// - Sums. Each input's contributions are added in f32 in ascending window
//   position k (raster order), from 0, as the plain version does, so dx
//   equals it bit for bit: (2i, 2j) takes k = 0, 2, 6, 8 from outputs
//   (i, j), (i, j-1), (i-1, j), (i-1, j-1); (2i, 2j+1) k = 1, 7 from (i, j),
//   (i-1, j); (2i+1, 2j) k = 3, 5 from (i, j), (i, j-1); (2i+1, 2j+1) k = 4
//   from (i, j). Every input position is written once: no atomics and no
//   zero-fill pass.
// - Tile sizes: 256 threads = 2 x TQW x CB, so TQW = 128 / CB, with CB the
//   least power of two >= C / vector width, at most 16. Shared memory per
//   block is 9 x (TQW + 1) x CB x (16 + vector width) B, 23.2-29.4 KB for
//   every CB (C = 64: f32 CB = 16, TQW = 8, 25,920 B; bf16 CB = 8,
//   TQW = 16, 29,376 B), under the 48 KB a block may take without opting in;
//   seven blocks fit an SM, and their copies overlap one another's stores.
//   At most 4 quad columns (the 7x7 pool) take a narrow tile instead: 4 x 4
//   quads, one per thread (16 x CB threads; 5 x 5 x CB x 20 B = 8 KB at f32
//   C = 64), because the wide tile would stage 9 x 9 outputs for 4 x 4 and
//   leave half its threads idle while the others walk four quads alone.
//   At the three pools of a 224 px config-1 step at batch 32, f32: 1,568,
//   128 and 32 blocks.
//
// Scalar path (any other C or alignment): one thread per input element
// with the channel fastest, gathering over the <= 2x2 covering outputs in
// the same order; 32-bit index math where the tensors allow it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// window position of lane j in a packed idx vector (-1 for a staged pad)
template <int V>
__device__ __forceinline__ int lane(const Idx<V>& k, int j) {
  return (int)(int8_t)(k.w[j >> 2] >> (8 * (j & 3)));
}

// CB channel vectors, TQW quad columns, RG thread rows that each walk QR
// quad rows down
template <typename T, int CB, int TQW, int RG, int QR>
__global__ void __launch_bounds__(RG * TQW * CB)
    relu_max_pool_bwd_vec(const T* __restrict__ g,
                          const int8_t* __restrict__ idx, T* __restrict__ dx,
                          int H, int W, int C, int OH, int OW, int pad_top,
                          int pad_left, int n_ct, int n_rt, int n_ch) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kThr = RG * TQW * CB;
  constexpr int TQH = RG * QR;
  constexpr int SC = TQW + 1;
  constexpr int N = (TQH + 1) * SC * CB;
  extern __shared__ uint4 smem_raw[];
  Vec<T>* gs = reinterpret_cast<Vec<T>*>(smem_raw);  // [TQH + 1][SC][CB]
  Idx<V>* ks = reinterpret_cast<Idx<V>*>(gs + N);    // the same, of idx

  const int cvec = C / V;
  int blk = blockIdx.x;
  const int ct = blk % n_ct;
  blk /= n_ct;
  const int rt = blk % n_rt;
  blk /= n_rt;
  const int ch = blk % n_ch;
  const int b = blk / n_ch;
  const int cv0 = ch * CB;
  // first quad row and column of the tile; staged output (sr, sc) is
  // output (i0 - 1 + sr, j0 - 1 + sc)
  const int i0 = (pad_top >> 1) + rt * TQH;
  const int j0 = (pad_left >> 1) + ct * TQW;
  const long long gbase = (long long)b * OH * OW * C + cv0 * V;

  Vec<T> zero;
#pragma unroll
  for (int j = 0; j < V; ++j) zero.v[j] = from_f<T>(0.0f);
  Idx<V> none;
#pragma unroll
  for (int w = 0; w < V / 4; ++w) none.w[w] = 0xffffffffu;
  for (int e = threadIdx.x; e < N; e += kThr) {
    const int cv = e % CB, p = e / CB;
    const int sr = p / SC, sc = p - sr * SC;
    const int oh = i0 - 1 + sr, ow = j0 - 1 + sc;
    if (oh >= 0 && oh < OH && ow >= 0 && ow < OW && cv0 + cv < cvec) {
      const long long o = gbase + ((long long)oh * OW + ow) * C + cv * V;
      cp_async16(&gs[e], g + o);
      cp_async_ca<V>(&ks[e], idx + o);
    } else {
      gs[e] = zero;
      ks[e] = none;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int cv = threadIdx.x % CB;
  const int rest = threadIdx.x / CB;
  const int tq = rest % TQW;  // quad column of the tile
  const int rg = rest / TQW;  // thread row: quad rows rg*QR .. rg*QR + QR-1
  if (cv0 + cv >= cvec) return;
  const int iw = 2 * (j0 + tq) - pad_left;  // the quad's left column
  const bool col0 = iw >= 0 && iw < W, col1 = iw + 1 < W;
  const long long db = (long long)b * H * W * C + (cv0 + cv) * V;

  // outputs (i-1, j-1), (i-1, j) = staged (s, tq), (s, tq + 1);
  // (i, j-1), (i, j) = staged (s + 1, tq), (s + 1, tq + 1)
  int s = rg * QR;
  Vec<T> ga = gs[(s * SC + tq) * CB + cv];
  Vec<T> gb = gs[(s * SC + tq + 1) * CB + cv];
  Idx<V> ka = ks[(s * SC + tq) * CB + cv];
  Idx<V> kb = ks[(s * SC + tq + 1) * CB + cv];
#pragma unroll
  for (int t = 0; t < QR; ++t, ++s) {
    const Vec<T> gc = gs[((s + 1) * SC + tq) * CB + cv];
    const Vec<T> gd = gs[((s + 1) * SC + tq + 1) * CB + cv];
    const Idx<V> kc = ks[((s + 1) * SC + tq) * CB + cv];
    const Idx<V> kd = ks[((s + 1) * SC + tq + 1) * CB + cv];
    const int ih = 2 * (i0 + s) - pad_top;  // the quad's upper row
    if (ih >= H) break;
    Vec<T> d00, d01, d10, d11;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float va = to_f(ga.v[j]), vb = to_f(gb.v[j]);
      const float vc = to_f(gc.v[j]), vd = to_f(gd.v[j]);
      const int a = lane(ka, j), bb = lane(kb, j);
      const int c = lane(kc, j), d = lane(kd, j);
      float p00 = 0.0f, p01 = 0.0f, p10 = 0.0f, p11 = 0.0f;
      p00 += d == 0 ? vd : 0.0f;
      p00 += c == 2 ? vc : 0.0f;
      p00 += bb == 6 ? vb : 0.0f;
      p00 += a == 8 ? va : 0.0f;
      p01 += d == 1 ? vd : 0.0f;
      p01 += bb == 7 ? vb : 0.0f;
      p10 += d == 3 ? vd : 0.0f;
      p10 += c == 5 ? vc : 0.0f;
      p11 += d == 4 ? vd : 0.0f;
      d00.v[j] = from_f<T>(p00);
      d01.v[j] = from_f<T>(p01);
      d10.v[j] = from_f<T>(p10);
      d11.v[j] = from_f<T>(p11);
    }
    if (ih >= 0) {
      const long long o = db + ((long long)ih * W + iw) * C;
      if (col0) *reinterpret_cast<Vec<T>*>(dx + o) = d00;
      if (col1) *reinterpret_cast<Vec<T>*>(dx + o + C) = d01;
    }
    if (ih + 1 < H) {
      const long long o = db + ((long long)(ih + 1) * W + iw) * C;
      if (col0) *reinterpret_cast<Vec<T>*>(dx + o) = d10;
      if (col1) *reinterpret_cast<Vec<T>*>(dx + o + C) = d11;
    }
    ga = gc;
    gb = gd;
    ka = kc;
    kb = kd;
  }
}

// I is the index type: 32-bit whenever the tensors allow it, because 64-bit
// division is a long instruction sequence and this kernel divides three
// times per element.
template <typename T, typename I>
__global__ void relu_max_pool_bwd_scalar(const T* __restrict__ g,
                                         const int8_t* __restrict__ idx,
                                         T* __restrict__ dx, int H, int W,
                                         int C, int OH, int OW, int pad_top,
                                         int pad_left, I total) {
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

template <typename T, int CB, int TQW, int RG, int QR>
int launch_vec(const T* g, const int8_t* idx, T* dx, int B, int H, int W,
               int C, int OH, int OW, int pad_top, int pad_left, int n_qh,
               int n_qw, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  constexpr int TQH = RG * QR;
  const int cvec = C / V;
  const int n_ct = (n_qw + TQW - 1) / TQW;
  const int n_rt = (n_qh + TQH - 1) / TQH;
  const int n_ch = (cvec + CB - 1) / CB;
  const long long blocks = (long long)n_ct * n_rt * n_ch * B;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)(TQH + 1) * (TQW + 1) * CB * (16 + V);
  relu_max_pool_bwd_vec<T, CB, TQW, RG, QR>
      <<<(unsigned)blocks, RG * TQW * CB, smem, s>>>(
          g, idx, dx, H, W, C, OH, OW, pad_top, pad_left, n_ct, n_rt, n_ch);
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int launch_cb(const T* g, const int8_t* idx, T* dx, int B, int H, int W,
              int C, int OH, int OW, int pad_top, int pad_left,
              cudaStream_t s) {
  const int n_qh = ((pad_top + H - 1) >> 1) - (pad_top >> 1) + 1;
  const int n_qw = ((pad_left + W - 1) >> 1) - (pad_left >> 1) + 1;
  // at most 4 quad columns (the 7x7 pool): a 4 x 4 tile of quads, one per
  // thread, so a block stages the 5 x 5 outputs it reads and no wide tile
  // mostly outside the plane, and no thread walks quad rows alone
  if (n_qw <= 4)
    return launch_vec<T, CB, 4, 4, 1>(g, idx, dx, B, H, W, C, OH, OW,
                                      pad_top, pad_left, n_qh, n_qw, s);
  return launch_vec<T, CB, kThreads / (2 * CB), 2, 4>(
      g, idx, dx, B, H, W, C, OH, OW, pad_top, pad_left, n_qh, n_qw, s);
}

bool misaligned(const void* p, int bytes) {
  return ((uintptr_t)p) % bytes != 0;
}

template <typename T>
int launch(const void* gv, const void* idxv, void* dxv, int B, int H, int W,
           int C, int OH, int OW, int pad_top, int pad_left, int vector,
           cudaStream_t s) {
  const T* g = (const T*)gv;
  const int8_t* idx = (const int8_t*)idxv;
  T* dx = (T*)dxv;
  constexpr int V = 16 / sizeof(T);
  if (vector) {
    // the caller asked for the vector path: refuse what it cannot read
    if (C % V != 0 || misaligned(g, 16) || misaligned(dx, 16) ||
        misaligned(idx, V))
      return (int)cudaErrorInvalidValue;
    const int cvec = C / V;
    int cb = 1;
    while (cb < cvec && cb < 16) cb *= 2;
    switch (cb) {
      case 1:
        return launch_cb<T, 1>(g, idx, dx, B, H, W, C, OH, OW, pad_top,
                               pad_left, s);
      case 2:
        return launch_cb<T, 2>(g, idx, dx, B, H, W, C, OH, OW, pad_top,
                               pad_left, s);
      case 4:
        return launch_cb<T, 4>(g, idx, dx, B, H, W, C, OH, OW, pad_top,
                               pad_left, s);
      case 8:
        return launch_cb<T, 8>(g, idx, dx, B, H, W, C, OH, OW, pad_top,
                               pad_left, s);
      default:
        return launch_cb<T, 16>(g, idx, dx, B, H, W, C, OH, OW, pad_top,
                                pad_left, s);
    }
  }
  // both dx and g must be indexable in 32 bits
  const long long total = (long long)B * H * W * C;
  const long long outs = (long long)B * OH * OW * C;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (total < (1LL << 31) && outs < (1LL << 31))
    relu_max_pool_bwd_scalar<T, int><<<blocks, kThreads, 0, s>>>(
        g, idx, dx, H, W, C, OH, OW, pad_top, pad_left, (int)total);
  else
    relu_max_pool_bwd_scalar<T, long long><<<blocks, kThreads, 0, s>>>(
        g, idx, dx, H, W, C, OH, OW, pad_top, pad_left, total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (of g and dx). vector: 1
// takes the vector path (C * element size a multiple of 16 bytes, g and dx
// 16-byte aligned, idx aligned to 16 / element size; else the call returns
// cudaErrorInvalidValue and launches nothing), 0 the scalar path.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int srl_relu_max_pool_bwd(const void* g, const void* idx, void* dx,
                                     int dtype, int B, int H, int W, int C,
                                     int OH, int OW, int pad_top,
                                     int pad_left, int vector, void* stream) {
  if ((long long)B * H * W * C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(g, idx, dx, B, H, W, C, OH, OW, pad_top, pad_left,
                           vector, s);
    case 1:
      return launch<__nv_bfloat16>(g, idx, dx, B, H, W, C, OH, OW, pad_top,
                                   pad_left, vector, s);
    case 2:
      return launch<__half>(g, idx, dx, B, H, W, C, OH, OW, pad_top,
                            pad_left, vector, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
