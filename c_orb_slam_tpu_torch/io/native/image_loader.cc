// Native image decode + multithreaded prefetch for dataset feeding.
//
// The reference's dataset drivers block the tracking thread on
// cv::imread for every frame (reference: Examples/Stereo/stereo_kitti.cc:85,
// Examples/Monocular/mono_tum.cc:78). The tracking step is queued on the
// GPU asynchronously, so frame decode would become the serial bottleneck.
// This loader decodes images to float32 in a C++ worker pool that stays N
// frames ahead of the consumer, delivering frames in order.
//
// Decoders: PNM (P5 gray / P6 rgb, 8- or 16-bit) always; PNG and JPEG only
// where the compiler finds <png.h> / <jpeglib.h> (and the build does not
// define COSL_NO_PNG / COSL_NO_JPEG). cosl_decoders() says which.
//
// Two value modes:
//   gray  (raw = 0): luma in [0, 255]; 16-bit input is rescaled by 255/max.
//   raw   (raw = 1): the stored values as they are, 16-bit included: the
//                    read for depth maps (TUM depth PNGs hold 5000 per
//                    metre, which the [0, 255] mode would truncate).
//
// C API (ctypes-friendly):
//   cosl_decoders()                                  -> bitmask 1 PNM, 2 PNG, 4 JPEG
//   cosl_decode(path, raw, out, cap, &w, &h)          one-shot decode, 0 on success
//   cosl_prefetch_create(paths, n, threads, ahead, raw) -> handle
//   cosl_prefetch_next(handle, out, cap, &w, &h)      -> index, -1 at end, -2 on failure
//   cosl_prefetch_destroy(handle)

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#if !defined(COSL_NO_PNG) && __has_include(<png.h>)
#define COSL_HAVE_PNG 1
#include <png.h>
#endif
#if !defined(COSL_NO_JPEG) && __has_include(<jpeglib.h>)
#define COSL_HAVE_JPEG 1
#include <jpeglib.h>
#endif

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<float> gray;  // h*w
  bool ok = false;
};

// Rec.601 luma, matching cv::cvtColor(BGR2GRAY) coefficients (reference
// converts with cvtColor, Tracking.cc:172-197).
inline float luma(float r, float g, float b) { return 0.299f * r + 0.587f * g + 0.114f * b; }

// ---------------------------------------------------------------------------
// Decoders
// ---------------------------------------------------------------------------

#ifdef COSL_HAVE_PNG
bool decode_png(FILE* f, Image* out, bool raw) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  bool wide = depth == 16;
  if (wide) {
    const uint16_t probe = 1;
    if (*reinterpret_cast<const uint8_t*>(&probe) == 1) png_set_swap(png);  // host order
  }
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  color = png_get_color_type(png, info);
  int channels = (color == PNG_COLOR_TYPE_RGB) ? 3 : 1;
  int bytes = wide ? 2 : 1;
  float scale = (wide && !raw) ? 255.0f / 65535.0f : 1.0f;

  std::vector<uint8_t> row((size_t)w * channels * bytes);
  out->w = (int)w;
  out->h = (int)h;
  out->gray.resize((size_t)w * h);
  for (png_uint_32 y = 0; y < h; y++) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->gray.data() + (size_t)y * w;
    for (png_uint_32 x = 0; x < w; x++) {
      float v[3];
      for (int c = 0; c < channels; c++) {
        size_t i = (size_t)x * channels + c;
        v[c] = wide ? (float)reinterpret_cast<const uint16_t*>(row.data())[i] : (float)row[i];
      }
      dst[x] = scale * (channels == 1 ? v[0] : luma(v[0], v[1], v[2]));
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  out->ok = true;
  return true;
}
#endif

#ifdef COSL_HAVE_JPEG
bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;  // libjpeg does the luma conversion
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->gray.resize((size_t)out->w * out->h);
  std::vector<uint8_t> row(out->w);
  uint8_t* rowp = row.data();
  while ((int)cinfo.output_scanline < out->h) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out->gray.data() + (size_t)y * out->w;
    for (int x = 0; x < out->w; x++) dst[x] = (float)row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out->ok = true;
  return true;
}
#endif

bool decode_pnm(FILE* f, Image* out, bool raw) {
  // P5 (gray) / P6 (rgb), 8-bit or 16-bit big-endian.
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1) return false;
  int channels = 0;
  if (strcmp(magic, "P5") == 0) channels = 1;
  else if (strcmp(magic, "P6") == 0) channels = 3;
  else return false;
  int vals[3], got = 0;
  while (got < 3) {
    int c = fgetc(f);
    if (c == '#') {  // comment to end of line
      while (c != '\n' && c != EOF) c = fgetc(f);
    } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      continue;
    } else if (c == EOF) {
      return false;
    } else {
      ungetc(c, f);
      if (fscanf(f, "%d", &vals[got]) != 1) return false;
      got++;
    }
  }
  fgetc(f);  // single whitespace after maxval
  int w = vals[0], h = vals[1], maxv = vals[2];
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 65535) return false;
  int bytes = maxv > 255 ? 2 : 1;
  std::vector<uint8_t> buf((size_t)w * channels * bytes);
  out->w = w;
  out->h = h;
  out->gray.resize((size_t)w * h);
  float scale = raw ? 1.0f : 255.0f / (float)maxv;
  for (int y = 0; y < h; y++) {
    if (fread(buf.data(), 1, buf.size(), f) != buf.size()) return false;
    float* dst = out->gray.data() + (size_t)y * w;
    for (int x = 0; x < w; x++) {
      float v[3];
      for (int c = 0; c < channels; c++) {
        const uint8_t* p = &buf[((size_t)x * channels + c) * bytes];
        v[c] = bytes == 2 ? (float)((p[0] << 8) | p[1]) : (float)p[0];
      }
      dst[x] = scale * (channels == 1 ? v[0] : luma(v[0], v[1], v[2]));
    }
  }
  out->ok = true;
  return true;
}

bool decode_any(const char* path, bool raw, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t sig[8] = {0};
  size_t n = fread(sig, 1, 8, f);
  rewind(f);
  bool ok = false;
  static const uint8_t kPng[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n >= 8 && memcmp(sig, kPng, 8) == 0) {
#ifdef COSL_HAVE_PNG
    ok = decode_png(f, out, raw);
#endif
  } else if (n >= 2 && sig[0] == 0xFF && sig[1] == 0xD8) {
#ifdef COSL_HAVE_JPEG
    ok = decode_jpeg(f, out);
#endif
  } else if (n >= 2 && sig[0] == 'P' && (sig[1] == '5' || sig[1] == '6')) {
    ok = decode_pnm(f, out, raw);
  }
  fclose(f);
  return ok && out->ok;
}

// ---------------------------------------------------------------------------
// Ordered prefetcher: workers decode ahead, consumer pops in order.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  int ahead;
  bool raw;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_ready;
  std::map<int, Image> done;  // decoded, waiting for consumer
  int next_to_decode = 0;
  int next_to_consume = 0;
  bool stop = false;

  Prefetcher(std::vector<std::string> p, int n_threads, int ahead_, bool raw_)
      : paths(std::move(p)), ahead(ahead_), raw(raw_) {
    for (int t = 0; t < n_threads; t++) {
      workers.emplace_back([this] { this->work(); });
    }
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_work.notify_all();
    cv_ready.notify_all();
    for (auto& w : workers) w.join();
  }

  void work() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> l(mu);
        cv_work.wait(l, [this] {
          return stop || (next_to_decode < (int)paths.size() &&
                          next_to_decode < next_to_consume + ahead);
        });
        if (stop) return;
        idx = next_to_decode++;
      }
      Image img;
      decode_any(paths[idx].c_str(), raw, &img);
      {
        std::lock_guard<std::mutex> l(mu);
        done[idx] = std::move(img);
      }
      cv_ready.notify_all();
    }
  }

  // Returns frame index, or -1 past end, or -2 on decode failure.
  int next(float* out, int64_t cap, int* w, int* h) {
    int idx;
    Image img;
    {
      std::unique_lock<std::mutex> l(mu);
      if (next_to_consume >= (int)paths.size()) return -1;
      idx = next_to_consume;
      cv_ready.wait(l, [this, idx] { return stop || done.count(idx); });
      if (stop) return -1;
      img = std::move(done[idx]);
      done.erase(idx);
      next_to_consume++;
    }
    cv_work.notify_all();
    if (!img.ok) return -2;
    int64_t n = (int64_t)img.w * img.h;
    if (n > cap) return -2;
    *w = img.w;
    *h = img.h;
    memcpy(out, img.gray.data(), n * sizeof(float));
    return idx;
  }
};

}  // namespace

extern "C" {

int cosl_decoders() {
  int mask = 1;
#ifdef COSL_HAVE_PNG
  mask |= 2;
#endif
#ifdef COSL_HAVE_JPEG
  mask |= 4;
#endif
  return mask;
}

int cosl_decode(const char* path, int raw, float* out, int64_t cap, int* w, int* h) {
  Image img;
  if (!decode_any(path, raw != 0, &img)) return -1;
  int64_t n = (int64_t)img.w * img.h;
  if (n > cap) return -1;
  *w = img.w;
  *h = img.h;
  memcpy(out, img.gray.data(), n * sizeof(float));
  return 0;
}

void* cosl_prefetch_create(const char** paths, int n, int n_threads, int ahead, int raw) {
  std::vector<std::string> p(paths, paths + n);
  return new Prefetcher(std::move(p), n_threads > 0 ? n_threads : 2, ahead > 0 ? ahead : 8,
                        raw != 0);
}

int cosl_prefetch_next(void* handle, float* out, int64_t cap, int* w, int* h) {
  return static_cast<Prefetcher*>(handle)->next(out, cap, w, h);
}

void cosl_prefetch_destroy(void* handle) { delete static_cast<Prefetcher*>(handle); }

}  // extern "C"
