// Native host-ingest library: JPEG decode + bit-exact PIL-style preprocess.
//
// The reference delegates host ingest to native dependency code (PIL's C
// JPEG decoder + torchvision transforms executed in DataLoader worker
// processes, reference: debias_clip/measuring_bias.py:142,
// debias_clip/datasets.py:122).  This is the TPU-framework equivalent: a
// small C++ runtime for the host side of the pipeline — decode, fixed-point
// bicubic resize, center-crop, normalize — with an internal thread pool, so
// a single-core host can saturate the device ingest link without Python or
// numpy in the per-image loop.
//
// Bit-exactness contract (tested against vision/preprocess.py, which is
// itself 0-LSB-tested against PIL on the reference figures):
//   * resize: Pillow Resample.c uint8 path — coefficients quantized to
//     int32 fixed point with PRECISION_BITS=22 (half-away-from-zero),
//     per-pass int accumulation, clip8((sum + 2^21) >> 22), horizontal
//     pass then vertical pass, each through uint8.
//   * output size: torchvision _compute_resized_output_size — short side ->
//     n_px, long side TRUNCATED int(n_px * long / short).
//   * crop: torchvision CenterCrop — top = round_half_even((size-crop)/2).
//   * normalize: float32 ops in torchvision order: u8/255 - mean, / std.
//
// Build: g++ -O2 -shared -fPIC ingest.cc -ljpeg -lpthread -o libdvl_ingest.so
// (see native/__init__.py::ensure_built).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr int kPrecisionBits = 22;  // Pillow: 32 - 8 - 2

// Keys bicubic kernel, a = -0.5 (PIL BICUBIC), support 2.
double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct CoeffRow {
  int xmin;
  std::vector<int32_t> k;  // quantized coefficients
};

// Replica of vision/preprocess.py::resize_weights_pil_fixed (itself a
// replica of Pillow precompute_coeffs + normalize_coeffs_8bpc): double
// kernel evaluation, sequential normalizer accumulation, fixed-point
// quantization half-away-from-zero with C truncation.
std::vector<CoeffRow> precompute_coeffs(int in_size, int out_size) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;
  const double inv = 1.0 / filterscale;
  const double one = static_cast<double>(1 << kPrecisionBits);

  std::vector<CoeffRow> rows(out_size);
  std::vector<double> ks;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    ks.assign(n, 0.0);
    double ww = 0.0;
    for (int i = 0; i < n; ++i) {
      ks[i] = bicubic_filter((i + xmin - center + 0.5) * inv);
      ww += ks[i];
    }
    rows[xx].xmin = xmin;
    rows[xx].k.resize(n);
    for (int i = 0; i < n; ++i) {
      double k = ks[i];
      if (ww != 0.0) k = k / ww;
      rows[xx].k[i] = static_cast<int32_t>(k >= 0 ? k * one + 0.5
                                                  : k * one - 0.5);
    }
  }
  return rows;
}

inline uint8_t clip8(int64_t ss) {
  // Pillow clip8 on the (sum + 2^21) value: <=0 -> 0, >= 2^30 -> 255,
  // else >> PRECISION_BITS.  (vision/preprocess.py::_clip8 clamps to
  // [0, 2^30-1] then shifts — identical mapping.)
  if (ss <= 0) return 0;
  if (ss >= (int64_t{1} << 30)) return 255;
  return static_cast<uint8_t>(ss >> kPrecisionBits);
}

// One fixed-point resample pass along the width axis.
// in: [h, w, c] uint8 -> out: [h, ow, c]
void resample_horizontal(const uint8_t* in, int h, int w, int c,
                         uint8_t* out, int ow,
                         const std::vector<CoeffRow>& coeffs) {
  const int64_t half = int64_t{1} << (kPrecisionBits - 1);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * c;
    uint8_t* orow = out + static_cast<size_t>(y) * ow * c;
    for (int x = 0; x < ow; ++x) {
      const CoeffRow& cr = coeffs[x];
      const int n = static_cast<int>(cr.k.size());
      for (int ch = 0; ch < c; ++ch) {
        int64_t ss = half;
        const uint8_t* p = row + static_cast<size_t>(cr.xmin) * c + ch;
        for (int i = 0; i < n; ++i) ss += int64_t{cr.k[i]} * p[i * c];
        orow[x * c + ch] = clip8(ss);
      }
    }
  }
}

// One fixed-point resample pass along the height axis.
// in: [h, w, c] uint8 -> out: [oh, w, c]
void resample_vertical(const uint8_t* in, int h, int w, int c,
                       uint8_t* out, int oh,
                       const std::vector<CoeffRow>& coeffs) {
  const int64_t half = int64_t{1} << (kPrecisionBits - 1);
  const size_t stride = static_cast<size_t>(w) * c;
  for (int y = 0; y < oh; ++y) {
    const CoeffRow& cr = coeffs[y];
    const int n = static_cast<int>(cr.k.size());
    uint8_t* orow = out + static_cast<size_t>(y) * stride;
    for (size_t xc = 0; xc < stride; ++xc) {
      int64_t ss = half;
      const uint8_t* p = in + static_cast<size_t>(cr.xmin) * stride + xc;
      for (int i = 0; i < n; ++i) ss += int64_t{cr.k[i]} * p[i * stride];
      orow[xc] = clip8(ss);
    }
  }
}

// torchvision Resize(int) output size: short side -> n_px, long side
// truncates (vision/preprocess.py::resize_output_size).
void resize_output_size(int h, int w, int n_px, int* rh, int* rw) {
  if (h <= w) {
    if (h == n_px) { *rh = h; *rw = w; return; }
    int lw = static_cast<int>(static_cast<double>(n_px) * w / h);
    *rh = n_px; *rw = lw < 1 ? 1 : lw;
    return;
  }
  if (w == n_px) { *rh = h; *rw = w; return; }
  int lh = static_cast<int>(static_cast<double>(n_px) * h / w);
  *rh = lh < 1 ? 1 : lh; *rw = n_px;
}

// Python round() (banker's) of (size - crop) / 2 for size >= 0, crop >= 0.
int center_crop_top(int size, int crop) {
  const int d = size - crop;
  if (d % 2 == 0) return d / 2;
  const int k = d / 2;  // d odd, value is k + 0.5 -> round half to even
  return (k % 2 == 0) ? k : k + 1;
}

// --------------------------------------------------------------------------
// libjpeg decode with longjmp error handling
// --------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode a JPEG byte buffer into RGB8 [h, w, 3].  Returns 0 on success.
int decode_jpeg_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                    int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale/CMYK upconverted like PIL "RGB"
  jpeg_start_decompress(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  const size_t stride = static_cast<size_t>(*w) * 3;
  out->resize(static_cast<size_t>(*h) * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW rowptr = out->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// --------------------------------------------------------------------------
// libpng decode (files in the wild carry .jpg names with PNG bytes — the
// reference's own figures do; PIL sniffs magic bytes, so do we)
// --------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "read past end");
    return;
  }
  std::memcpy(out, st->data + st->pos, n);
  st->pos += n;
}

// Decode a PNG byte buffer into RGB8 [h, w, 3] (alpha dropped, palette and
// grayscale expanded, 16-bit stripped — PIL convert("RGB") semantics).
int decode_png_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                   int* h, int* w) {
  if (len < 8 || png_sig_cmp(buf, 0, 8) != 0) return 2;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);

  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_16(png);
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);  // PIL convert("RGB") drops alpha, no blending
  png_read_update_info(png, info);

  *h = static_cast<int>(png_get_image_height(png, info));
  *w = static_cast<int>(png_get_image_width(png, info));
  const size_t stride = static_cast<size_t>(*w) * 3;
  if (png_get_rowbytes(png, info) != stride) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  out->resize(static_cast<size_t>(*h) * stride);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y) rows[y] = out->data() + y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// Magic-byte dispatch: JPEG (ff d8) or PNG (89 50 4e 47).
int decode_image_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                     int* h, int* w) {
  if (len >= 2 && buf[0] == 0xff && buf[1] == 0xd8)
    return decode_jpeg_rgb(buf, len, out, h, w);
  if (len >= 8 && png_sig_cmp(buf, 0, 8) == 0)
    return decode_png_rgb(buf, len, out, h, w);
  return 2;
}

// --------------------------------------------------------------------------
// Preprocess chain (uint8 HWC in, float32 HWC out)
// --------------------------------------------------------------------------

constexpr float kMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
constexpr float kStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};

// Full reference chain: Resize(n_px, BICUBIC) -> CenterCrop(n_px) ->
// ToTensor -> Normalize.  Mirrors vision/preprocess.py::preprocess_host_exact.
int preprocess_u8(const uint8_t* img, int h, int w, int n_px, float* out) {
  if (h <= 0 || w <= 0 || n_px <= 0) return 1;
  int rh, rw;
  resize_output_size(h, w, n_px, &rh, &rw);

  std::vector<uint8_t> buf_a, buf_b;
  const uint8_t* cur = img;
  int ch = h, cw = w;
  if (cw != rw) {  // horizontal pass first (Pillow order)
    auto coeffs = precompute_coeffs(cw, rw);
    buf_a.resize(static_cast<size_t>(ch) * rw * 3);
    resample_horizontal(cur, ch, cw, 3, buf_a.data(), rw, coeffs);
    cur = buf_a.data();
    cw = rw;
  }
  if (ch != rh) {
    auto coeffs = precompute_coeffs(ch, rh);
    buf_b.resize(static_cast<size_t>(rh) * cw * 3);
    resample_vertical(cur, ch, cw, 3, buf_b.data(), rh, coeffs);
    cur = buf_b.data();
    ch = rh;
  }

  // CenterCrop pads when smaller (torchvision: extra pixel right/bottom).
  std::vector<uint8_t> padded;
  if (ch < n_px || cw < n_px) {
    const int ph = ch < n_px ? n_px - ch : 0;
    const int pw = cw < n_px ? n_px - cw : 0;
    const int nh = ch + ph, nw = cw + pw;
    padded.assign(static_cast<size_t>(nh) * nw * 3, 0);
    const int top = ph / 2, left = pw / 2;
    for (int y = 0; y < ch; ++y)
      std::memcpy(padded.data() + (static_cast<size_t>(y + top) * nw + left) * 3,
                  cur + static_cast<size_t>(y) * cw * 3,
                  static_cast<size_t>(cw) * 3);
    cur = padded.data();
    ch = nh; cw = nw;
  }

  const int top = center_crop_top(ch, n_px);
  const int left = center_crop_top(cw, n_px);
  for (int y = 0; y < n_px; ++y) {
    const uint8_t* row = cur + (static_cast<size_t>(y + top) * cw + left) * 3;
    float* orow = out + static_cast<size_t>(y) * n_px * 3;
    for (int x = 0; x < n_px; ++x) {
      for (int c = 0; c < 3; ++c) {
        // float32 op order: /255, -mean, /std (torchvision ToTensor+Normalize)
        float v = static_cast<float>(row[x * 3 + c]) / 255.0f;
        v = v - kMean[c];
        v = v / kStd[c];
        orow[x * 3 + c] = v;
      }
    }
  }
  return 0;
}

// --------------------------------------------------------------------------
// Thread pool for batch work
// --------------------------------------------------------------------------

void parallel_for(int n, int nthreads, const std::function<void(int)>& fn) {
  if (nthreads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> threads;
  const int nt = nthreads < n ? nthreads : n;
  threads.reserve(nt - 1);
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> data;
  FILE* f = std::fopen(path, "rb");
  if (!f) return data;
  std::fseek(f, 0, SEEK_END);
  const long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz > 0) {
    data.resize(static_cast<size_t>(sz));
    if (std::fread(data.data(), 1, data.size(), f) != data.size()) data.clear();
  }
  std::fclose(f);
  return data;
}

}  // namespace

extern "C" {

// Decode a JPEG/PNG buffer (magic-byte sniffed); writes dims to *h/*w.
// out must hold cap bytes.
// Returns 0 ok, 1 decode error, 2 header/format error, 3 out too small.
int dvl_decode_jpeg(const uint8_t* buf, size_t len, uint8_t* out,
                    size_t cap, int* h, int* w) {
  std::vector<uint8_t> rgb;
  const int rc = decode_image_rgb(buf, len, &rgb, h, w);
  if (rc != 0) return rc;
  if (rgb.size() > cap) return 3;
  std::memcpy(out, rgb.data(), rgb.size());
  return 0;
}

// Header-only peek at image dims (for output buffer sizing); JPEG or PNG.
int dvl_jpeg_dims(const uint8_t* buf, size_t len, int* h, int* w) {
  if (len >= 24 && png_sig_cmp(buf, 0, 8) == 0) {  // PNG IHDR, big-endian
    *w = (buf[16] << 24) | (buf[17] << 16) | (buf[18] << 8) | buf[19];
    *h = (buf[20] << 24) | (buf[21] << 16) | (buf[22] << 8) | buf[23];
    return 0;
  }
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Bit-exact PIL fixed-point bicubic resize, uint8 [h,w,c] -> [oh,ow,c].
int dvl_resize_bicubic_u8(const uint8_t* in, int h, int w, int c,
                          uint8_t* out, int oh, int ow) {
  if (h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) return 1;
  std::vector<uint8_t> tmp;
  const uint8_t* cur = in;
  int ch = h, cw = w;
  if (cw != ow) {
    auto coeffs = precompute_coeffs(cw, ow);
    tmp.resize(static_cast<size_t>(ch) * ow * c);
    resample_horizontal(cur, ch, cw, c, tmp.data(), ow, coeffs);
    cur = tmp.data();
    cw = ow;
  }
  if (ch != oh) {
    auto coeffs = precompute_coeffs(ch, oh);
    std::vector<uint8_t> tmp2(static_cast<size_t>(oh) * cw * c);
    resample_vertical(cur, ch, cw, c, tmp2.data(), oh, coeffs);
    std::memcpy(out, tmp2.data(), tmp2.size());
    return 0;
  }
  std::memcpy(out, cur, static_cast<size_t>(ch) * cw * c);
  return 0;
}

// Full preprocess of one decoded uint8 HWC image -> float32 [n_px,n_px,3].
int dvl_preprocess_u8(const uint8_t* img, int h, int w, int n_px, float* out) {
  return preprocess_u8(img, h, w, n_px, out);
}

// Batch preprocess of raw uint8 images (same dims), threaded.
// imgs: n pointers to [h,w,3]; out: [n, n_px, n_px, 3].  Returns #failures.
int dvl_preprocess_batch_u8(const uint8_t* const* imgs, const int* hs,
                            const int* ws, int n, int n_px, float* out,
                            int nthreads) {
  std::atomic<int> failures{0};
  const size_t per = static_cast<size_t>(n_px) * n_px * 3;
  parallel_for(n, nthreads, [&](int i) {
    if (preprocess_u8(imgs[i], hs[i], ws[i], n_px, out + per * i) != 0)
      failures.fetch_add(1);
  });
  return failures.load();
}

// Batch: read + decode + preprocess JPEG files, threaded.
// paths: n C strings; out: [n, n_px, n_px, 3] float32; ok: n int flags.
// Returns #failures (failed entries are zero-filled with ok[i]=0).
int dvl_preprocess_batch_files(const char* const* paths, int n, int n_px,
                               float* out, int* ok, int nthreads) {
  std::atomic<int> failures{0};
  const size_t per = static_cast<size_t>(n_px) * n_px * 3;
  parallel_for(n, nthreads, [&](int i) {
    float* dst = out + per * i;
    auto data = read_file(paths[i]);
    std::vector<uint8_t> rgb;
    int h = 0, w = 0;
    if (data.empty() || decode_image_rgb(data.data(), data.size(), &rgb, &h, &w)
        || preprocess_u8(rgb.data(), h, w, n_px, dst) != 0) {
      std::memset(dst, 0, per * sizeof(float));
      ok[i] = 0;
      failures.fetch_add(1);
    } else {
      ok[i] = 1;
    }
  });
  return failures.load();
}

// Shared flow for the uint8 staging variants: decode + PIL-exact resize of
// the SHORT side to n_px + pad + center crop, from an in-memory encoded
// buffer.  Writes the cropped rows through `write_row(y, row_ptr)` so
// callers pick the output layout.  `max_pixels` > 0 rejects oversized
// images from the HEADER dims before any pixel decode (decoded-memory cap
// for untrusted buffers — e.g. serving request bodies).
static int ingest_one_mem_u8(const uint8_t* buf, size_t len, int n_px,
                             long long max_pixels,
                             const std::function<void(int, const uint8_t*)>&
                                 write_row) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (buf == nullptr || len == 0) return 1;
  if (max_pixels > 0) {
    if (dvl_jpeg_dims(buf, len, &h, &w) != 0) return 1;
    if (static_cast<long long>(h) * w > max_pixels) return 2;
  }
  if (decode_image_rgb(buf, len, &rgb, &h, &w)) return 1;
  int rh, rw;
  resize_output_size(h, w, n_px, &rh, &rw);
  std::vector<uint8_t> resized(static_cast<size_t>(rh) * rw * 3);
  if (dvl_resize_bicubic_u8(rgb.data(), h, w, 3, resized.data(), rh, rw))
    return 1;
  // pad if smaller, then center crop (same conventions as preprocess_u8)
  const uint8_t* cur = resized.data();
  int ch = rh, cw = rw;
  std::vector<uint8_t> padded;
  if (ch < n_px || cw < n_px) {
    const int ph = ch < n_px ? n_px - ch : 0;
    const int pw = cw < n_px ? n_px - cw : 0;
    const int nh = ch + ph, nw = cw + pw;
    padded.assign(static_cast<size_t>(nh) * nw * 3, 0);
    const int top = ph / 2, left = pw / 2;
    for (int y = 0; y < ch; ++y)
      std::memcpy(padded.data() + (static_cast<size_t>(y + top) * nw + left) * 3,
                  cur + static_cast<size_t>(y) * cw * 3,
                  static_cast<size_t>(cw) * 3);
    cur = padded.data();
    ch = nh; cw = nw;
  }
  const int top = center_crop_top(ch, n_px);
  const int left = center_crop_top(cw, n_px);
  for (int y = 0; y < n_px; ++y)
    write_row(y, cur + (static_cast<size_t>(y + top) * cw + left) * 3);
  return 0;
}

// File-path wrapper: read, then run the in-memory staging chain.
static int ingest_one_u8(const char* path, int n_px,
                         const std::function<void(int, const uint8_t*)>&
                             write_row) {
  auto data = read_file(path);
  return ingest_one_mem_u8(data.data(), data.size(), n_px, 0, write_row);
}

// Row writers shared by the canvas ([n_px, n_px, 3]) and patch-contiguous
// ([(n_px/patch)^2, patch*patch*3]) output layouts.
static void write_row_canvas(uint8_t* dst, int n_px, int y,
                             const uint8_t* row) {
  std::memcpy(dst + static_cast<size_t>(y) * n_px * 3, row,
              static_cast<size_t>(n_px) * 3);
}

static void write_row_patches(uint8_t* dst, int n_px, int patch, int y,
                              const uint8_t* row) {
  const int gw = n_px / patch;
  const size_t seg = static_cast<size_t>(patch) * 3;
  const size_t per_patch = static_cast<size_t>(patch) * seg;
  const int pr = y / patch, wr = y % patch;
  uint8_t* base = dst + static_cast<size_t>(pr) * gw * per_patch
                  + static_cast<size_t>(wr) * seg;
  for (int gx = 0; gx < gw; ++gx)
    std::memcpy(base + static_cast<size_t>(gx) * per_patch,
                row + static_cast<size_t>(gx) * seg, seg);
}

// Batch: decode IN-MEMORY encoded images (JPEG/PNG) to fixed-size uint8
// canvases after PIL-exact short-side resize + center crop — the serving
// raw-JPEG request path (decode+resize+crop for a whole request in one
// threaded native call instead of per-record Python round trips).
// bufs/lens: n encoded buffers; max_pixels > 0 caps HEADER h*w per image
// (rc 2 -> ok=0).  Returns #failures; failed entries zero-filled.
int dvl_ingest_batch_mem_u8(const uint8_t* const* bufs, const size_t* lens,
                            int n, int n_px, long long max_pixels,
                            uint8_t* out, int* ok, int nthreads) {
  std::atomic<int> failures{0};
  const size_t per = static_cast<size_t>(n_px) * n_px * 3;
  parallel_for(n, nthreads, [&](int i) {
    uint8_t* dst = out + per * i;
    if (ingest_one_mem_u8(bufs[i], lens[i], n_px, max_pixels,
                          [&](int y, const uint8_t* row) {
                            write_row_canvas(dst, n_px, y, row);
                          }) != 0) {
      std::memset(dst, 0, per);
      ok[i] = 0;
      failures.fetch_add(1);
    } else {
      ok[i] = 1;
    }
  });
  return failures.load();
}

// Same, written PATCH-CONTIGUOUSLY: out [n, (n_px/patch)^2, patch*patch*3]
// — the exact staging the int8/bf16 relayout-free stems consume
// (ops/quant.py::patch_embed_q_p8), produced directly at decode time so
// the serving path needs no host relayout at all.
int dvl_ingest_batch_mem_u8p(const uint8_t* const* bufs, const size_t* lens,
                             int n, int n_px, int patch,
                             long long max_pixels, uint8_t* out, int* ok,
                             int nthreads) {
  if (patch <= 0 || n_px % patch != 0) return -1;
  std::atomic<int> failures{0};
  const int gw = n_px / patch;
  const size_t per = static_cast<size_t>(gw) * gw * patch * patch * 3;
  parallel_for(n, nthreads, [&](int i) {
    uint8_t* dst = out + per * i;
    if (ingest_one_mem_u8(bufs[i], lens[i], n_px, max_pixels,
                          [&](int y, const uint8_t* row) {
                            write_row_patches(dst, n_px, patch, y, row);
                          }) != 0) {
      std::memset(dst, 0, per);
      ok[i] = 0;
      failures.fetch_add(1);
    } else {
      ok[i] = 1;
    }
  });
  return failures.load();
}

// Batch: decode JPEG files to a fixed-size uint8 canvas after PIL-exact
// resize of the SHORT side to n_px + center crop — the uint8 staging variant
// used when the normalize happens on-device (4x less H2D traffic than f32).
int dvl_ingest_batch_files_u8(const char* const* paths, int n, int n_px,
                              uint8_t* out, int* ok, int nthreads) {
  std::atomic<int> failures{0};
  const size_t per = static_cast<size_t>(n_px) * n_px * 3;
  parallel_for(n, nthreads, [&](int i) {
    uint8_t* dst = out + per * i;
    if (ingest_one_u8(paths[i], n_px, [&](int y, const uint8_t* row) {
          write_row_canvas(dst, n_px, y, row);
        }) != 0) {
      std::memset(dst, 0, per);
      ok[i] = 0;
      failures.fetch_add(1);
    } else {
      ok[i] = 1;
    }
  });
  return failures.load();
}

// Batch: same ingest chain, but the crop is written PATCH-CONTIGUOUSLY:
// out is [n, (n_px/patch)^2, patch*patch*3] uint8 — the exact bytes the ViT
// patchify reads, so the device stem is one relayout-free int8 matmul
// (ops/quant.py::patch_embed_q_p8).  Same byte count as the HWC canvas;
// the rearrangement is free here (each output row scatters gw patch-row
// segments instead of one memcpy).  n_px must be divisible by patch.
int dvl_ingest_batch_files_u8p(const char* const* paths, int n, int n_px,
                               int patch, uint8_t* out, int* ok,
                               int nthreads) {
  if (patch <= 0 || n_px % patch != 0) return -1;
  std::atomic<int> failures{0};
  const int gw = n_px / patch;
  const size_t per = static_cast<size_t>(gw) * gw * patch * patch * 3;
  parallel_for(n, nthreads, [&](int i) {
    uint8_t* dst = out + per * i;
    if (ingest_one_u8(paths[i], n_px, [&](int y, const uint8_t* row) {
          write_row_patches(dst, n_px, patch, y, row);
        }) != 0) {
      std::memset(dst, 0, per);
      ok[i] = 0;
      failures.fetch_add(1);
    } else {
      ok[i] = 1;
    }
  });
  return failures.load();
}

int dvl_version() { return 3; }

}  // extern "C"
