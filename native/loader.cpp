// svo_tpu native runtime: asynchronous stereo PNG prefetcher.
//
// Role model: the reference's AsyncImageLoader (include/async_image_loader.h)
// — a producer thread decoding PNG pairs ahead of the consumer through a
// lock-free SPSC queue. This implementation generalizes it to N decoder
// threads filling a bounded, *ordered* ring (frames are handed to the
// consumer strictly in sequence, whatever order decodes finish), because a
// GPU host wants several cores decoding while the device computes.
//
// Layout contract (reference: async_image_loader.h:55-66): frames live at
// <left_dir>/%06d.png and <right_dir>/%06d.png. Color PNGs are converted to
// grayscale with the BT.601 luma weights cv::cvtColor uses
// (reference: async_image_loader.h:67-69).
//
// C API (ctypes-friendly), exported below:
//   svo_loader_create(left_dir, right_dir, start, end, capacity, threads,
//                     width, height)
//   svo_loader_next(handle, left_out, right_out)  -> frame index or <0
//   svo_loader_destroy(handle)
//
// Images are emitted as uint8 grayscale, cropped/zero-padded to the fixed
// (height, width) the pipeline's static shapes need.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> left, right;
  int index = -1;
  bool ok = false;
  bool ready = false;
};

// Decode one PNG to grayscale uint8 at fixed (out_h, out_w); returns false on
// any error (missing frame ends the stream, like the reference's loop exit,
// tracking.cpp:63-67).
bool decode_png_gray(const std::string& path, int out_h, int out_w,
                     uint8_t* out) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  color = png_get_color_type(png, info);

  const int channels = (color == PNG_COLOR_TYPE_RGB) ? 3 : 1;
  std::vector<uint8_t> row(w * channels);

  std::memset(out, 0, size_t(out_h) * out_w);
  const int copy_h = (int(h) < out_h) ? int(h) : out_h;
  const int copy_w = (int(w) < out_w) ? int(w) : out_w;

  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    if (int(y) >= copy_h) continue;
    uint8_t* dst = out + size_t(y) * out_w;
    if (channels == 1) {
      std::memcpy(dst, row.data(), copy_w);
    } else {
      // BT.601 luma, matching cv::cvtColor(BGR2GRAY): 0.299 R + 0.587 G +
      // 0.114 B (PNG rows are RGB order). Fixed-point as OpenCV does.
      for (int x = 0; x < copy_w; ++x) {
        const uint8_t r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
        dst[x] = uint8_t((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

struct Loader {
  std::string left_dir, right_dir;
  int start, end, capacity, width, height;
  std::vector<Frame> ring;
  std::atomic<int> next_to_decode;
  int next_to_consume;
  std::atomic<bool> stop{false};
  std::atomic<int> first_bad{1 << 30};  // earliest failed index: stream end
  std::mutex m;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;

  Loader(const char* ld, const char* rd, int s, int e, int cap, int threads,
         int w, int h)
      : left_dir(ld),
        right_dir(rd),
        start(s),
        end(e),
        capacity(cap),
        width(w),
        height(h),
        ring(cap),
        next_to_decode(s),
        next_to_consume(s) {
    const size_t sz = size_t(w) * h;
    for (auto& f : ring) {
      f.left.resize(sz);
      f.right.resize(sz);
    }
    for (int t = 0; t < threads; ++t)
      workers.emplace_back([this] { this->work(); });
  }

  static std::string frame_path(const std::string& dir, int idx) {
    char name[32];
    std::snprintf(name, sizeof(name), "%06d.png", idx);
    std::string p = dir;
    if (!p.empty() && p.back() != '/') p.push_back('/');
    return p + name;
  }

  void work() {
    for (;;) {
      const int idx = next_to_decode.fetch_add(1);
      if (idx >= end || stop.load()) return;
      Frame* slot = &ring[idx % capacity];
      {
        // wait until the consumer has drained the slot's previous occupant
        std::unique_lock<std::mutex> lk(m);
        cv_space.wait(lk, [&] {
          return stop.load() || (!slot->ready && idx < next_to_consume + capacity);
        });
        if (stop.load()) return;
      }
      const bool ok =
          decode_png_gray(frame_path(left_dir, idx), height, width,
                          slot->left.data()) &&
          decode_png_gray(frame_path(right_dir, idx), height, width,
                          slot->right.data());
      {
        std::lock_guard<std::mutex> lk(m);
        slot->index = idx;
        slot->ok = ok;
        slot->ready = true;
        if (!ok) {
          int cur = first_bad.load();
          while (idx < cur && !first_bad.compare_exchange_weak(cur, idx)) {
          }
        }
      }
      cv_ready.notify_all();
    }
  }

  // Returns the frame index, or -1 when the stream ends.
  int next(uint8_t* left_out, uint8_t* right_out) {
    const int idx = next_to_consume;
    if (idx >= end || idx >= first_bad.load()) return -1;
    Frame* slot = &ring[idx % capacity];
    std::unique_lock<std::mutex> lk(m);
    cv_ready.wait(lk, [&] {
      return (slot->ready && slot->index == idx) || idx >= first_bad.load();
    });
    if (idx >= first_bad.load() && !(slot->ready && slot->index == idx && slot->ok))
      return -1;
    if (!slot->ok) return -1;
    const size_t sz = size_t(width) * height;
    std::memcpy(left_out, slot->left.data(), sz);
    std::memcpy(right_out, slot->right.data(), sz);
    slot->ready = false;
    slot->index = -1;
    next_to_consume = idx + 1;
    lk.unlock();
    cv_space.notify_all();
    return idx;
  }

  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* svo_loader_create(const char* left_dir, const char* right_dir, int start,
                        int end, int capacity, int threads, int width,
                        int height) {
  if (capacity < threads + 1) capacity = threads + 1;
  return new Loader(left_dir, right_dir, start, end, capacity, threads, width,
                    height);
}

int svo_loader_next(void* handle, uint8_t* left_out, uint8_t* right_out) {
  return static_cast<Loader*>(handle)->next(left_out, right_out);
}

void svo_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
