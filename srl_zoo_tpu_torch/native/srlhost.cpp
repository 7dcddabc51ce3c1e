// srlhost: the port's native host runtime for the data path (a copy of
// the JAX package's native/srlhost.cpp; the two build from the same code).
//
// One C call per batch, no Python in the inner loop:
//
//   * batch_gather_u8          gather frames from the mmapped uint8 frame
//                              store into a contiguous batch buffer (the
//                              pinned staging buffer of a streamed batch).
//   * batch_resize_bilinear_u8 NHWC uint8 batch resize (half-pixel centres).
//   * batch_decode_jpeg        decode and resize a batch of JPEG files into a
//                              preallocated RGB buffer with a std::thread
//                              pool (libjpeg, with its DCT scaling).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 srlhost.cpp -ljpeg -lpthread
// (srl_zoo_tpu_torch/native/__init__.py does it on first use, into
// build/srl_zoo_tpu_torch/, and binds it with ctypes). On a host without
// libjpeg's headers it is built with -DSRLHOST_NO_JPEG: the gather and the
// resize only, and JPEG files are decoded by cv2.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#ifndef SRLHOST_NO_JPEG
#include <jpeglib.h>
#include <csetjmp>
#endif

extern "C" {

// Gather n_idx frames of frame_bytes each: dst[k] = src[idx[k]].
// Returns 0 on success, -1 on out-of-range index.
int batch_gather_u8(const uint8_t* src, int64_t n_src, const int32_t* idx,
                    int64_t n_idx, int64_t frame_bytes, uint8_t* dst) {
  for (int64_t k = 0; k < n_idx; ++k) {
    const int64_t i = idx[k];
    if (i < 0 || i >= n_src) return -1;
    std::memcpy(dst + k * frame_bytes, src + i * frame_bytes,
                static_cast<size_t>(frame_bytes));
  }
  return 0;
}

static void resize_one(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
  // half-pixel-center convention (matches cv2/TF bilinear)
  const float ry = static_cast<float>(sh) / dh;
  const float rx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ry - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    const int y1 = y0 + 1 < sh ? y0 + 1 : y0;
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * rx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > sw - 1) x0 = sw - 1;
      const int x1 = x0 + 1 < sw ? x0 + 1 : x0;
      const float wx = fx - x0;
      const uint8_t* p00 = src + (y0 * sw + x0) * c;
      const uint8_t* p01 = src + (y0 * sw + x1) * c;
      const uint8_t* p10 = src + (y1 * sw + x0) * c;
      const uint8_t* p11 = src + (y1 * sw + x1) * c;
      uint8_t* out = dst + (y * dw + x) * c;
      for (int ch = 0; ch < c; ++ch) {
        const float top = p00[ch] + (p01[ch] - p00[ch]) * wx;
        const float bot = p10[ch] + (p11[ch] - p10[ch]) * wx;
        out[ch] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

// Bilinear-resize n NHWC uint8 images (sh, sw, c) -> (dh, dw, c).
int batch_resize_bilinear_u8(const uint8_t* src, int n, int sh, int sw,
                             int c, uint8_t* dst, int dh, int dw) {
  if (n < 0 || sh <= 0 || sw <= 0 || c <= 0 || dh <= 0 || dw <= 0) return -1;
  const int64_t s_stride = static_cast<int64_t>(sh) * sw * c;
  const int64_t d_stride = static_cast<int64_t>(dh) * dw * c;
  for (int i = 0; i < n; ++i)
    resize_one(src + i * s_stride, sh, sw, c, dst + i * d_stride, dh, dw);
  return 0;
}

#ifndef SRLHOST_NO_JPEG
// --- JPEG decode -------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG file to RGB and bilinear-resize into dst (dh, dw, 3).
// Returns 0 on success.
static int decode_one(const char* path, uint8_t* dst, int dh, int dw,
                      std::vector<uint8_t>& scratch) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // libjpeg DCT scaling: pick the smallest 1/1..1/8 scale still >= target
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom >= 1; --denom) {
    if (static_cast<int>(cinfo.image_width) / denom >= dw &&
        static_cast<int>(cinfo.image_height) / denom >= dh) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width;
  const int sh = cinfo.output_height;
  const int c = cinfo.output_components;  // 3 (RGB)
  scratch.resize(static_cast<size_t>(sh) * sw * c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = scratch.data() +
        static_cast<size_t>(cinfo.output_scanline) * sw * c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  if (c != 3) return -3;
  if (sh == dh && sw == dw) {
    std::memcpy(dst, scratch.data(), static_cast<size_t>(dh) * dw * 3);
  } else {
    resize_one(scratch.data(), sh, sw, 3, dst, dh, dw);
  }
  return 0;
}

// Decode n JPEG files into dst (n, dh, dw, 3) with a thread pool.
// Returns 0 on success, or (1 + index) of the first file that failed.
int batch_decode_jpeg(const char** paths, int n, int dh, int dw,
                      uint8_t* dst, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);  // 0 = ok, else 1 + index
  const int64_t stride = static_cast<int64_t>(dh) * dw * 3;

  auto worker = [&]() {
    std::vector<uint8_t> scratch;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n || failed.load()) break;
      if (decode_one(paths[i], dst + i * stride, dh, dw, scratch) != 0) {
        int expected = 0;
        failed.compare_exchange_strong(expected, 1 + i);
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}
#endif  // SRLHOST_NO_JPEG

}  // extern "C"
