// Native frame loader: PNG/JPEG -> f32 grayscale decode + a multithreaded
// prefetch ring buffer.
//
// Role in the framework: the host-side data plane. The reference pays a
// synchronous cv2.imread per frame inside its driver loop
// (reference src/vo/primitives/loader.py:184-198, called from main.py:248);
// here decode runs on a C++ thread pool that stays ahead of the device,
// so the jitted VO step never waits on image IO. Python binds via ctypes
// (vo_tpu/data/native_loader.py) — no pybind11 dependency.
//
// Grayscale conversion matches PIL's `convert("L")` exactly for 8-bit PNGs
// (ITU-R 601-2 fixed point: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16) so
// the Python fallback path and the native path produce identical tensors.
// 16-bit PNGs are DECLINED (decode returns an error) because the two
// libraries narrow 16->8 bits differently; callers fall back to PIL there.
// JPEG decode delegates grayscale conversion to libjpeg (same BT.601 weights,
// its own fixed-point rounding — parity within +/-1 LSB).

#include <cstdio>  // jpeglib.h needs FILE declared first

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kErr = -1;

bool has_suffix(const std::string& s, const char* suf) {
  std::string t = s;
  for (auto& c : t) c = static_cast<char>(tolower(c));
  std::string u(suf);
  return t.size() >= u.size() && t.compare(t.size() - u.size(), u.size(), u) == 0;
}

inline float luma601(uint8_t r, uint8_t g, uint8_t b) {
  // PIL ImagingConvert L24: exact integer formula.
  return static_cast<float>(
      (r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

int png_dims(FILE* fp, int* h, int* w) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErr;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kErr;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErr;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int png_decode_gray(FILE* fp, float* out, int h, int w) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErr;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kErr;
  }
  std::vector<uint8_t> row;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErr;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  if (static_cast<int>(png_get_image_height(png, info)) != h ||
      static_cast<int>(png_get_image_width(png, info)) != w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErr;
  }
  // Normalize every input to 8-bit gray or RGB. 16-bit inputs are declined:
  // libpng's strip-16 (keep high byte) and PIL's convert("L") (clamp at 255)
  // narrow differently, so the parity contract with the Python fallback
  // cannot hold — callers fall back to PIL for those.
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErr;
  }
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) {
    png_set_tRNS_to_alpha(png);
    png_set_strip_alpha(png);
  }
  png_read_update_info(png, info);
  const int ch = static_cast<int>(png_get_channels(png, info));
  if (ch != 1 && ch != 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErr;
  }
  row.resize(static_cast<size_t>(w) * ch);
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out + static_cast<size_t>(y) * w;
    if (ch == 1) {
      for (int x = 0; x < w; ++x) dst[x] = static_cast<float>(row[x]);
    } else {
      for (int x = 0; x < w; ++x)
        dst[x] = luma601(row[3 * x], row[3 * x + 1], row[3 * x + 2]);
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

int jpeg_dims(FILE* fp, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kErr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_decode_gray(FILE* fp, float* out, int h, int w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  std::vector<uint8_t> row;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kErr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;  // BT.601 conversion inside libjpeg
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 1) {
    jpeg_destroy_decompress(&cinfo);
    return kErr;
  }
  row.resize(static_cast<size_t>(w));
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = static_cast<int>(cinfo.output_scanline);
    uint8_t* rp = row.data();
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = out + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) dst[x] = static_cast<float>(row[x]);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_gray_path(const std::string& path, float* out, int h, int w) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) return kErr;
  int rc;
  if (has_suffix(path, ".png"))
    rc = png_decode_gray(fp, out, h, w);
  else
    rc = jpeg_decode_gray(fp, out, h, w);
  fclose(fp);
  return rc;
}

// ---------------------------------------------------------------------------
// Prefetch ring
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  int h = 0, w = 0;
  int ring = 0;
  std::vector<float> slots;        // ring * h * w
  std::vector<int> slot_state;     // 0 empty, 1 ready, 2 failed
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;    // consumer waits on slot ready
  std::condition_variable cv_space;    // workers wait for ring space
  int next_fetch = 0;    // next index a worker may claim
  int consumed = 0;      // frames handed to the consumer
  bool stop = false;

  float* slot_ptr(int idx) {
    return slots.data() + static_cast<size_t>(idx % ring) * h * w;
  }

  void worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop ||
                 (next_fetch < static_cast<int>(paths.size()) &&
                  next_fetch < consumed + ring);
        });
        if (stop) return;
        idx = next_fetch++;
      }
      const int rc = decode_gray_path(paths[idx], slot_ptr(idx), h, w);
      {
        std::lock_guard<std::mutex> lk(mu);
        slot_state[idx % ring] = (rc == 0) ? 1 : 2;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Peek image dimensions without a full decode. Returns 0 on success.
int vo_image_size(const char* path, int* h, int* w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return kErr;
  int rc;
  if (has_suffix(path, ".png"))
    rc = png_dims(fp, h, w);
  else
    rc = jpeg_dims(fp, h, w);
  fclose(fp);
  return rc;
}

// Decode one image into the caller's (h, w) float32 buffer. Returns 0 on OK.
int vo_decode_gray(const char* path, float* out, int h, int w) {
  return decode_gray_path(path, out, h, w);
}

// Create a prefetcher over `n` frame paths of identical (h, w).
void* vo_prefetch_create(const char** paths, int n, int h, int w,
                         int n_threads, int ring) {
  if (n <= 0 || h <= 0 || w <= 0) return nullptr;
  if (ring < 2) ring = 2;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > ring) n_threads = ring;
  auto* p = new Prefetcher();
  p->paths.reserve(n);
  for (int i = 0; i < n; ++i) p->paths.emplace_back(paths[i]);
  p->h = h;
  p->w = w;
  p->ring = ring;
  p->slots.resize(static_cast<size_t>(ring) * h * w);
  p->slot_state.assign(ring, 0);
  for (int i = 0; i < n_threads; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocking in-order get of frame `idx` (must equal the number of prior gets).
// Copies into `out` (h*w floats). Returns 0 OK, -1 decode failure/misuse.
int vo_prefetch_get(void* handle, int idx, float* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (!p || idx != p->consumed || idx >= static_cast<int>(p->paths.size()))
    return kErr;
  int state;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_ready.wait(lk, [&] { return p->slot_state[idx % p->ring] != 0; });
    state = p->slot_state[idx % p->ring];
  }
  if (state == 1)
    std::memcpy(out, p->slot_ptr(idx),
                sizeof(float) * static_cast<size_t>(p->h) * p->w);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->slot_state[idx % p->ring] = 0;
    p->consumed = idx + 1;
  }
  p->cv_space.notify_all();
  return state == 1 ? 0 : kErr;
}

void vo_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (!p) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_space.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
