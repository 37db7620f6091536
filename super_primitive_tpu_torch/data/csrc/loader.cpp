// Prefetching image loader of the PyTorch port: PNG and JPEG decoded on a
// pool of C++ threads ahead of the consumer, the fr1 undistort remap applied
// on the same threads, behind a plain C ABI for ctypes.
//
// The port's own copy of the JAX package's csrc/loader.cpp, adapted:
//   - PNG is decoded here, on zlib alone: chunks, inflate, and the five row
//     filters undone row by row (the machines the port runs on need not have
//     libpng). 8- and 16-bit gray, gray + alpha, RGB and RGBA, as stored;
//     16-bit samples big-endian on disk, native-endian out. Palette,
//     interlaced and sub-8-bit files are refused, as data/image_io.py
//     refuses them.
//   - JPEG goes through libjpeg when the build found jpeglib.h
//     (-DSP_HAVE_JPEG); without it a JPEG fails with a message naming the
//     missing header. libjpeg errors unwind with longjmp instead of exiting.
//   - every failure carries a message back to the caller.
//
// Build (data/native_loader.py does it at first use):
//   g++ -O2 -std=c++17 -shared -fPIC -ffp-contract=off -pthread loader.cpp
//       -lz [-DSP_HAVE_JPEG -ljpeg]
//
// Semantics:
//   handle = sp_loader_open(paths, n, num_threads, lookahead)
//   sp_loader_get(handle, idx, out, cap, &h, &w, &c, &bpc, err, err_cap)
//     - blocks until image idx is decoded; copies it into out (row-major,
//       channels interleaved); returns 0 on success, the byte count needed
//       when cap is too small, -1 on a decode error (message in err).
//     - a capacity miss keeps the decoded image cached: a retry with a
//       buffer of the returned size copies without decoding again.
//     - getting idx schedules the prefetch of [idx+1, idx+lookahead].
//   sp_loader_close(handle)
//
// Concurrency contract: each index has a single consumer. A successful get
// consumes the cached image; two threads blocking on the same index would
// leave the loser waiting for a decode it never scheduled. The Python
// wrapper calls from one consumer thread.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#ifdef SP_HAVE_JPEG
#include <jpeglib.h>
#endif

namespace {

struct Image {
  int height = 0, width = 0, channels = 0, bytes_per_channel = 1;
  std::vector<uint8_t> data;
  bool ok = false;
  std::string error;
};

Image fail(const std::string& path, const std::string& why) {
  Image img;
  img.error = path + ": " + why;
  return img;
}

bool read_file(const std::string& path, std::vector<uint8_t>* out) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) return false;
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof buf, fp)) > 0) out->insert(out->end(), buf, buf + n);
  bool ok = !ferror(fp);
  fclose(fp);
  return ok;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the row filters: `rows` holds height x (1 + rowbytes)
// bytes, a filter type before each row; the unfiltered rows go to `out`.
bool unfilter(const uint8_t* rows, int height, size_t rowbytes, int bpp,
              uint8_t* out, std::string* why) {
  std::vector<uint8_t> zero(rowbytes, 0);
  for (int r = 0; r < height; r++) {
    const uint8_t type = rows[r * (rowbytes + 1)];
    const uint8_t* f = rows + r * (rowbytes + 1) + 1;
    uint8_t* x = out + r * rowbytes;
    const uint8_t* up = r ? out + (r - 1) * rowbytes : zero.data();
    switch (type) {
      case 0:
        memcpy(x, f, rowbytes);
        break;
      case 1:
        for (size_t i = 0; i < rowbytes; i++)
          x[i] = uint8_t(f[i] + (i >= size_t(bpp) ? x[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; i++) x[i] = uint8_t(f[i] + up[i]);
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; i++) {
          const int a = i >= size_t(bpp) ? x[i - bpp] : 0;
          x[i] = uint8_t(f[i] + ((a + up[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; i++) {
          const int a = i >= size_t(bpp) ? x[i - bpp] : 0;
          const int c = i >= size_t(bpp) ? up[i - bpp] : 0;
          x[i] = uint8_t(f[i] + paeth(a, up[i], c));
        }
        break;
      default:
        *why = "unknown PNG filter type " + std::to_string(type);
        return false;
    }
  }
  return true;
}

Image decode_png(const std::string& path, const std::vector<uint8_t>& file) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (file.size() < 8 || memcmp(file.data(), kSig, 8) != 0) return fail(path, "not a PNG file");
  uint32_t W = 0, H = 0;
  int depth = 0, color = -1, interlace = 0;
  bool have_ihdr = false, have_iend = false;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= file.size()) {
    const uint32_t len = be32(&file[pos]);
    if (len > file.size() - pos - 12) return fail(path, "truncated PNG chunk");
    const uint8_t* kind = &file[pos + 4];
    const uint8_t* body = &file[pos + 8];
    const uint32_t crc = uint32_t(crc32(0L, kind, 4 + len));
    if (crc != be32(body + len)) return fail(path, "PNG chunk CRC mismatch");
    if (!memcmp(kind, "IHDR", 4)) {
      if (len < 13) return fail(path, "short IHDR chunk");
      W = be32(body);
      H = be32(body + 4);
      depth = body[8];
      color = body[9];
      interlace = body[12];
      have_ihdr = true;
    } else if (!memcmp(kind, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(kind, "IEND", 4)) {
      have_iend = true;
      break;
    }
    pos += 12 + len;
  }
  if (!have_ihdr) return fail(path, "PNG without an IHDR chunk");
  if (!have_iend) return fail(path, "truncated PNG (no IEND chunk)");
  int channels;
  switch (color) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    case 3: return fail(path, "palette PNG files are not supported");
    default: return fail(path, "unknown PNG colour type " + std::to_string(color));
  }
  if (depth != 8 && depth != 16)
    return fail(path, std::to_string(depth) +
                          "-bit PNG files are not supported (8 or 16 bits only)");
  if (interlace) return fail(path, "interlaced PNG files are not supported");
  if (W == 0 || H == 0 || W > (1u << 16) || H > (1u << 16))
    return fail(path, "PNG size out of range");
  const int bpp = channels * depth / 8;
  const size_t rowbytes = size_t(W) * bpp;
  const size_t want = size_t(H) * (rowbytes + 1);

  std::vector<uint8_t> raw(want);
  z_stream zs;
  memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) return fail(path, "zlib inflateInit failed");
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(want);
  const int rc = inflate(&zs, Z_FINISH);
  const size_t got = want - zs.avail_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END && !(rc == Z_BUF_ERROR && got == want))
    return fail(path, "corrupt PNG image data (zlib error " + std::to_string(rc) + ")");
  if (got < want)
    return fail(path, "PNG image data holds " + std::to_string(got) + " bytes, " +
                          std::to_string(want) + " expected");

  Image img;
  img.height = int(H);
  img.width = int(W);
  img.channels = channels;
  img.bytes_per_channel = depth / 8;
  img.data.resize(size_t(H) * rowbytes);
  std::string why;
  if (!unfilter(raw.data(), int(H), rowbytes, bpp, img.data.data(), &why)) return fail(path, why);
  if (depth == 16) {  // big-endian on disk -> native uint16
    uint8_t* p = img.data.data();
    for (size_t i = 0; i + 1 < img.data.size(); i += 2) {
      const uint16_t v = uint16_t((p[i] << 8) | p[i + 1]);
      memcpy(p + i, &v, 2);
    }
  }
  img.ok = true;
  return img;
}

#ifdef SP_HAVE_JPEG
struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
  char message[JMSG_LENGTH_MAX];
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegError* err = reinterpret_cast<JpegError*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->jump, 1);
}

void jpeg_no_output(j_common_ptr) {}

Image decode_jpeg(const std::string& path, const std::vector<uint8_t>& file) {
  Image img;
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  jerr.mgr.output_message = jpeg_no_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return fail(path, std::string("JPEG decode failed: ") + jerr.message);
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(file.data()), (unsigned long)file.size());
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);
  img.height = int(cinfo.output_height);
  img.width = int(cinfo.output_width);
  img.channels = cinfo.output_components;
  img.bytes_per_channel = 1;
  const size_t row = size_t(img.width) * img.channels;
  img.data.resize(row * img.height);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* ptr = img.data.data() + size_t(cinfo.output_scanline) * row;
    jpeg_read_scanlines(&cinfo, &ptr, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img.ok = true;
  return img;
}
#else
Image decode_jpeg(const std::string& path, const std::vector<uint8_t>&) {
  return fail(path,
              "JPEG decoding is not built in: the compiler found no jpeglib.h "
              "(libjpeg's header) on this machine");
}
#endif

Image decode_any(const std::string& path) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return fail(path, "cannot read the file");
  if (file.size() >= 3 && file[0] == 0xff && file[1] == 0xd8 && file[2] == 0xff)
    return decode_jpeg(path, file);
  return decode_png(path, file);
}

// Plumb-bob (OpenCV) forward distortion -> undistort remap tables, the math
// of cv2.initUndistortRectifyMap with the new camera matrix equal to K.
void undistort_maps(const double* K, const double* dist, int h, int w, float* map_x,
                    float* map_y) {
  const double fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const double k1 = dist[0], k2 = dist[1], p1 = dist[2], p2 = dist[3], k3 = dist[4];
  for (int v = 0; v < h; v++) {
    const double y = (v - cy) / fy;
    for (int u = 0; u < w; u++) {
      const double x = (u - cx) / fx;
      const double r2 = x * x + y * y;
      const double rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3));
      const double xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x);
      const double yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y;
      map_x[size_t(v) * w + u] = float(xd * fx + cx);
      map_y[size_t(v) * w + u] = float(yd * fy + cy);
    }
  }
}

// Bilinear remap with a constant-zero border (cv2.remap's default), weights
// in float32, rounded half up.
void remap_u8(const uint8_t* src, int h, int w, int c, const float* map_x, const float* map_y,
              uint8_t* dst) {
  for (int v = 0; v < h; v++) {
    for (int u = 0; u < w; u++) {
      const float sx = map_x[size_t(v) * w + u];
      const float sy = map_y[size_t(v) * w + u];
      const int x0 = int(std::floor(sx));
      const int y0 = int(std::floor(sy));
      const float ax = sx - x0, ay = sy - y0;
      const float w00 = (1 - ax) * (1 - ay), w01 = ax * (1 - ay);
      const float w10 = (1 - ax) * ay, w11 = ax * ay;
      const bool in00 = x0 >= 0 && x0 < w && y0 >= 0 && y0 < h;
      const bool in01 = x0 + 1 >= 0 && x0 + 1 < w && y0 >= 0 && y0 < h;
      const bool in10 = x0 >= 0 && x0 < w && y0 + 1 >= 0 && y0 + 1 < h;
      const bool in11 = x0 + 1 >= 0 && x0 + 1 < w && y0 + 1 >= 0 && y0 + 1 < h;
      for (int ch = 0; ch < c; ch++) {
        float acc = 0.f;
        if (in00) acc += w00 * src[(size_t(y0) * w + x0) * c + ch];
        if (in01) acc += w01 * src[(size_t(y0) * w + x0 + 1) * c + ch];
        if (in10) acc += w10 * src[(size_t(y0 + 1) * w + x0) * c + ch];
        if (in11) acc += w11 * src[(size_t(y0 + 1) * w + x0 + 1) * c + ch];
        dst[(size_t(v) * w + u) * c + ch] = uint8_t(acc + 0.5f);
      }
    }
  }
}

class Loader {
 public:
  Loader(std::vector<std::string> paths, int num_threads, int lookahead)
      : paths_(std::move(paths)), lookahead_(std::max(1, lookahead)) {
    num_threads = std::max(1, num_threads);
    for (int i = 0; i < num_threads; i++) workers_.emplace_back([this] { work(); });
    schedule_range(0, lookahead_);
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    for (auto& t : workers_) t.join();
  }

  long get_into(int idx, unsigned char* out, long capacity, int* height, int* width,
                int* channels, int* bytes_per_channel, char* err, int err_cap) {
    if (idx < 0 || idx >= int(paths_.size())) {
      snprintf(err, size_t(err_cap), "index %d out of range (%zu images)", idx, paths_.size());
      return -1;
    }
    {
      // marked as awaited before scheduling, so eviction never drops it
      std::lock_guard<std::mutex> lk(mu_);
      waiting_.insert(idx);
    }
    schedule_range(idx, idx + lookahead_);
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [&] { return done_.count(idx) > 0; });
    Image& img = done_[idx];
    if (!img.ok) {
      snprintf(err, size_t(err_cap), "%s", img.error.c_str());
      done_.erase(idx);
      scheduled_.erase(idx);
      waiting_.erase(idx);
      return -1;
    }
    *height = img.height;
    *width = img.width;
    *channels = img.channels;
    *bytes_per_channel = img.bytes_per_channel;
    const long need = long(img.data.size());
    if (need > capacity) return need;  // stays cached (and awaited) for a retry
    memcpy(out, img.data.data(), size_t(need));
    done_.erase(idx);
    scheduled_.erase(idx);  // a later request of idx decodes it again
    waiting_.erase(idx);
    return 0;
  }

  // Remap the 8-bit images of size (h, w) decoded from now on. Images
  // decoded under the previous maps and not awaited are dropped, so they
  // decode again; a decode in flight is caught by the generation check.
  void set_undistort(const float* map_x, const float* map_y, int h, int w) {
    std::lock_guard<std::mutex> lk(mu_);
    umap_x_.assign(map_x, map_x + size_t(h) * w);
    umap_y_.assign(map_y, map_y + size_t(h) * w);
    u_h_ = h;
    u_w_ = w;
    ugen_++;
    for (auto it = done_.begin(); it != done_.end();) {
      if (waiting_.count(it->first)) {
        ++it;
        continue;
      }
      scheduled_.erase(it->first);
      it = done_.erase(it);
    }
  }

 private:
  void schedule_range(int lo, int hi) {
    std::lock_guard<std::mutex> lk(mu_);
    for (int i = std::max(lo, 0); i <= hi && i < int(paths_.size()); i++) {
      if (done_.count(i) || scheduled_.count(i)) continue;
      scheduled_.insert(i);
      queue_.push_back(i);
    }
    cv_work_.notify_all();
  }

  void work() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_) return;
        idx = queue_.front();
        queue_.pop_front();
      }
      // The generation check and the store happen under one hold of mu_: a
      // set_undistort between the map read and the store makes this image
      // decode again with the new maps instead of caching a stale remap.
      for (;;) {
        Image img = decode_any(paths_[idx]);
        const int gen_used = maybe_undistort(img);
        {
          std::lock_guard<std::mutex> lk(mu_);
          if (gen_used != ugen_) continue;
          done_[idx] = std::move(img);
          // bound the cache: drop entries nobody waits on (and unmark them
          // as scheduled, so a later request decodes again); an awaited
          // index is never evicted, or its blocked get would wait forever
          const size_t cap = size_t(4 * lookahead_ + 8);
          for (auto it = done_.begin(); it != done_.end() && done_.size() > cap;) {
            if (waiting_.count(it->first)) {
              ++it;
              continue;
            }
            scheduled_.erase(it->first);
            it = done_.erase(it);
          }
        }
        break;
      }
      cv_done_.notify_all();
    }
  }

  // The undistort on this decode thread: 8-bit images of the maps' size
  // only (16-bit depth passes through). Returns the map generation used.
  int maybe_undistort(Image& img) {
    std::vector<float> mx, my;
    int uh, uw, gen;
    {
      std::lock_guard<std::mutex> lk(mu_);
      gen = ugen_;
      if (umap_x_.empty() || !img.ok || img.bytes_per_channel != 1 || img.height != u_h_ ||
          img.width != u_w_)
        return gen;
      mx = umap_x_;  // copies, so the remap runs outside the lock
      my = umap_y_;
      uh = u_h_;
      uw = u_w_;
    }
    std::vector<uint8_t> out(img.data.size());
    remap_u8(img.data.data(), uh, uw, img.channels, mx.data(), my.data(), out.data());
    img.data = std::move(out);
    return gen;
  }

  std::vector<float> umap_x_, umap_y_;
  int u_h_ = 0, u_w_ = 0;
  int ugen_ = 0;

  std::vector<std::string> paths_;
  int lookahead_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  std::deque<int> queue_;
  std::map<int, Image> done_;
  std::set<int> scheduled_;
  std::set<int> waiting_;
  bool stop_ = false;
};

}  // namespace

extern "C" {

int sp_has_jpeg() {
#ifdef SP_HAVE_JPEG
  return 1;
#else
  return 0;
#endif
}

void* sp_loader_open(const char** paths, int n, int num_threads, int lookahead) {
  std::vector<std::string> v(paths, paths + n);
  return new Loader(std::move(v), num_threads, lookahead);
}

long sp_loader_get(void* handle, int idx, unsigned char* out, long capacity, int* height,
                   int* width, int* channels, int* bytes_per_channel, char* err, int err_cap) {
  return static_cast<Loader*>(handle)->get_into(idx, out, capacity, height, width, channels,
                                                bytes_per_channel, err, err_cap);
}

void sp_loader_close(void* handle) { delete static_cast<Loader*>(handle); }

void sp_loader_set_undistort(void* handle, const float* map_x, const float* map_y, int h,
                             int w) {
  static_cast<Loader*>(handle)->set_undistort(map_x, map_y, h, w);
}

void sp_undistort_maps(const double* K, const double* dist, int h, int w, float* map_x,
                       float* map_y) {
  undistort_maps(K, dist, h, w, map_x, map_y);
}

void sp_remap_u8(const unsigned char* src, int h, int w, int c, const float* map_x,
                 const float* map_y, unsigned char* dst) {
  remap_u8(src, h, w, c, map_x, map_y, dst);
}

}  // extern "C"
