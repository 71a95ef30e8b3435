// nkbx native data path: threaded image decode + crop + resize + pad.
//
// TPU-native replacement for the reference's per-sample cv2.imread +
// albumentations geometry inside torch DataLoader worker *processes*
// (reference dataset.py:222-223, 612-628). One C++ thread pool decodes
// JPEG (libjpeg) / PNG (libpng), optionally crops a bbox (YOLO-crop datasets),
// applies LongestMaxSize (bilinear, cv2 INTER_LINEAR half-pixel convention)
// and center-pads straight into the caller's preallocated uint8 NHWC batch
// buffer — no Python objects, no IPC, no copies.
//
// C ABI (ctypes):
//   void* nkbx_pool_create(int n_threads);
//   void  nkbx_pool_destroy(void* pool);
//   void  nkbx_decode_batch(void* pool, const char** paths, int n,
//                           const int* crops,   // nullable; n*4 xyxy, -1 = no crop
//                           int out_h, int out_w,
//                           int mode,           // 0 longest+pad, 1 stretch resize
//                           unsigned char* out, // n*out_h*out_w*3, zero-filled pad
//                           int* status);       // 0 ok, <0 error
//   const char* nkbx_version();

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <cmath>
#include <functional>
#include <mutex>
#include <queue>
#include <unordered_map>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- thread pool

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { loop(); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      q_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> f;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        f = std::move(q_.front());
        q_.pop();
      }
      f();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

// ---------------------------------------------------------------- decoding

struct Image {
  std::vector<uint8_t> data;  // RGB HWC
  int h = 0, w = 0;
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, Image* out) {
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
  png_set_expand(png);          // palette/gray->8bit
  png_set_strip_16(png);        // 16 -> 8 bit
  png_set_strip_alpha(png);     // drop alpha
  png_set_gray_to_rgb(png);     // gray -> RGB
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->data.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  fseek(f, 0, SEEK_SET);
  bool ok = false;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (got >= 8 && !memcmp(magic, "\x89PNG\r\n\x1a\n", 8)) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok;
}

// ----------------------------------------------------- resize (cv2 INTER_LINEAR)

void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw,
                     int dst_stride /*bytes per dst row*/) {
  const float sy = float(sh) / dh, sx = float(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(floorf(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) { y0 = 0; y1 = 0; wy = 0.f; }
    if (y1 >= sh) { y1 = sh - 1; if (y0 >= sh) y0 = sh - 1; }
    uint8_t* drow = dst + size_t(y) * dst_stride;
    const uint8_t* r0 = src + size_t(y0) * sw * 3;
    const uint8_t* r1 = src + size_t(y1) * sw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = int(floorf(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) { x0 = 0; x1 = 0; wx = 0.f; }
      if (x1 >= sw) { x1 = sw - 1; if (x0 >= sw) x0 = sw - 1; }
      for (int c = 0; c < 3; ++c) {
        float top = r0[x0 * 3 + c] * (1.f - wx) + r0[x1 * 3 + c] * wx;
        float bot = r1[x0 * 3 + c] * (1.f - wx) + r1[x1 * 3 + c] * wx;
        float v = top * (1.f - wy) + bot * wy;
        drow[x * 3 + c] = uint8_t(v + 0.5f);
      }
    }
  }
}

// crop -> geometry -> write into batch slot (image already decoded; one
// decode serves EVERY crop of the same file in a batch — YOLO-crop datasets
// carry several boxes per image and the reference re-decodes per crop)
int process_decoded(const Image& img, const int* crop, int out_h, int out_w,
                    int mode, uint8_t* out_slot) {
  const uint8_t* src = img.data.data();
  int sh = img.h, sw = img.w;
  std::vector<uint8_t> cropped;
  if (crop && crop[0] >= 0) {
    int x0 = crop[0], y0 = crop[1], x1 = crop[2], y1 = crop[3];
    if (x0 < 0 || y0 < 0 || x1 > sw || y1 > sh || x1 <= x0 || y1 <= y0) return -2;
    int ch = y1 - y0, cw = x1 - x0;
    cropped.resize(size_t(ch) * cw * 3);
    for (int y = 0; y < ch; ++y)
      memcpy(cropped.data() + size_t(y) * cw * 3,
             src + (size_t(y0 + y) * sw + x0) * 3, size_t(cw) * 3);
    src = cropped.data();
    sh = ch;
    sw = cw;
  }

  const size_t slot_bytes = size_t(out_h) * out_w * 3;
  if (mode == 1) {  // stretch resize
    resize_bilinear(src, sh, sw, out_slot, out_h, out_w, out_w * 3);
    return 0;
  }
  // mode 0: LongestMaxSize(max(out_h,out_w) respecting aspect) + center pad.
  // Scale so the image fits inside (out_h, out_w); python round() convention
  // (round-half-even) matches albumentations' py3round.
  float scale = std::min(float(out_h) / sh, float(out_w) / sw);
  auto py3round = [](float v) {
    float fl = floorf(v), diff = v - fl;
    if (diff > 0.5f) return fl + 1.f;
    if (diff < 0.5f) return fl;
    return (fmodf(fl, 2.f) == 0.f) ? fl : fl + 1.f;
  };
  int rh = std::max(1, int(py3round(sh * scale)));
  int rw = std::max(1, int(py3round(sw * scale)));
  if (rh > out_h) rh = out_h;
  if (rw > out_w) rw = out_w;
  memset(out_slot, 0, slot_bytes);
  int pad_top = (out_h - rh) / 2;
  int pad_left = (out_w - rw) / 2;
  uint8_t* dst = out_slot + (size_t(pad_top) * out_w + pad_left) * 3;
  resize_bilinear(src, sh, sw, dst, rh, rw, out_w * 3);
  return 0;
}

struct Pool {
  ThreadPool tp;
  explicit Pool(int n) : tp(n) {}
};

}  // namespace

extern "C" {

void* nkbx_pool_create(int n_threads) {
  return new Pool(n_threads > 0 ? n_threads : int(std::thread::hardware_concurrency()));
}

void nkbx_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

void nkbx_decode_batch(void* pool, const char** paths, int n, const int* crops,
                       int out_h, int out_w, int mode, unsigned char* out,
                       int* status) {
  Pool* p = static_cast<Pool*>(pool);
  // group batch slots by file: each unique file is decoded ONCE and serves
  // all of its crops (one task per file keeps the pool's decode parallelism)
  std::vector<std::pair<std::string, std::vector<int>>> groups;
  {
    std::unordered_map<std::string, size_t> index;
    for (int i = 0; i < n; ++i) {
      auto it = index.find(paths[i]);
      if (it == index.end()) {
        index.emplace(paths[i], groups.size());
        groups.emplace_back(paths[i], std::vector<int>{i});
      } else {
        groups[it->second].second.push_back(i);
      }
    }
  }
  std::atomic<int> remaining(int(groups.size()));
  std::mutex done_mu;
  std::condition_variable done_cv;
  const size_t slot = size_t(out_h) * out_w * 3;
  for (const auto& g : groups) {
    const auto* gp = &g;  // stable: this function outlives the tasks
    p->tp.submit([=, &remaining, &done_mu, &done_cv] {
      Image img;
      const bool ok = decode_file(gp->first.c_str(), &img);
      for (int i : gp->second) {
        status[i] = ok ? process_decoded(img, crops ? crops + 4 * i : nullptr,
                                         out_h, out_w, mode, out + slot * i)
                       : -1;
      }
      if (remaining.fetch_sub(1) == 1) {
        std::unique_lock<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
}

const char* nkbx_version() { return "nkbx-native 0.2.0"; }

}  // extern "C"
