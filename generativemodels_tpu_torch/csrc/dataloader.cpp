// Host data loader of the port: NIfTI-1 and PNG/JPEG readers and a threaded
// prefetch loader that hands volumes to the consumer in file order.
//
// Counterpart of native/dataloader.cpp (the JAX package's loader), with two
// differences:
//   * Order. Workers decode ahead, but the consumer receives the volumes in
//     the order of the path list. Each worker claims the next index, decodes
//     the file and files the volume in a reorder buffer keyed by that index;
//     the consumer takes index after index from it. A worker claims an index
//     only while it lies within max_queue of the consumer's, so at most
//     max_queue volumes are decoded or decoding ahead of it. (The JAX loader
//     queues volumes as they finish, so an epoch comes out in completion
//     order.)
//   * Decoders. The PNG decoder is compiled only with GMTPU_HAVE_PNG (libpng's
//     png.h), the JPEG decoder only with GMTPU_HAVE_JPEG (libjpeg's
//     jpeglib.h); generativemodels_tpu_torch/data/native.py defines each when
//     the compiler finds the header. A file of a family whose decoder was not
//     built fails with an error that names the missing header.
// NIfTI needs zlib only (gzopen reads plain and gzipped files alike).
//
// Plain C interface, loaded with ctypes. Build (native.py does it at first
// use, into generativemodels_tpu_torch/_build/):
//   g++ -O2 -fPIC -std=c++17 -shared [-DGMTPU_HAVE_PNG] [-DGMTPU_HAVE_JPEG] \
//       dataloader.cpp -lz [-lpng] [-ljpeg] -lpthread -o libdataloader.so

#include <zlib.h>

#ifdef GMTPU_HAVE_JPEG
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#endif
#ifdef GMTPU_HAVE_PNG
#include <png.h>
#endif

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// NIfTI-1 reading
// ---------------------------------------------------------------------------

#pragma pack(push, 1)
struct Nifti1Header {
  int32_t sizeof_hdr;  // must be 348
  char unused1[36];
  int16_t dim[8];  // dim[0] = ndim, dim[1..7] = sizes
  char unused2[14];
  int16_t datatype;  // NIfTI datatype code
  int16_t bitpix;
  char unused3[2];
  float pixdim[8];
  float vox_offset;  // byte offset to data
  float scl_slope;
  float scl_inter;
  char unused4[224];
  char magic[4];  // "n+1\0" or "ni1\0"
};
#pragma pack(pop)

static_assert(sizeof(Nifti1Header) == 348, "NIfTI-1 header must be 348 bytes");

enum NiftiType : int16_t {
  DT_UINT8 = 2,
  DT_INT16 = 4,
  DT_INT32 = 8,
  DT_FLOAT32 = 16,
  DT_FLOAT64 = 64,
  DT_INT8 = 256,
  DT_UINT16 = 512,
  DT_UINT32 = 768,
};

bool read_file_maybe_gz(const std::string& path, std::vector<uint8_t>& out) {
  gzFile f = gzopen(path.c_str(), "rb");  // handles both plain and gzip
  if (!f) return false;
  constexpr size_t kChunk = 1 << 20;
  size_t used = 0;
  for (;;) {
    out.resize(used + kChunk);
    int n = gzread(f, out.data() + used, kChunk);
    if (n < 0) {
      gzclose(f);
      return false;
    }
    used += static_cast<size_t>(n);
    if (static_cast<size_t>(n) < kChunk) break;
  }
  out.resize(used);
  gzclose(f);
  return true;
}

template <typename T>
void convert_to_float(const uint8_t* src, size_t count, float slope, float inter, float* dst) {
  if (slope == 0.0f) slope = 1.0f;
  for (size_t i = 0; i < count; ++i) {
    T value;
    std::memcpy(&value, src + i * sizeof(T), sizeof(T));  // the data may be unaligned
    dst[i] = static_cast<float>(value) * slope + inter;
  }
}

struct Volume {
  std::vector<int64_t> shape;  // row-major (dim[ndim] .. dim[1]) => C order
  std::vector<float> data;
  std::string error;
  bool ok = false;
};

Volume read_nifti(const std::string& path) {
  Volume vol;
  std::vector<uint8_t> raw;
  if (!read_file_maybe_gz(path, raw)) {
    vol.error = "cannot open or decompress: " + path;
    return vol;
  }
  if (raw.size() < sizeof(Nifti1Header)) {
    vol.error = "file too small for a NIfTI-1 header: " + path;
    return vol;
  }
  Nifti1Header hdr;
  std::memcpy(&hdr, raw.data(), sizeof(hdr));
  if (hdr.sizeof_hdr != 348) {
    vol.error = "not a NIfTI-1 file (sizeof_hdr != 348): " + path;
    return vol;
  }
  int ndim = hdr.dim[0];
  if (ndim < 1 || ndim > 7) {
    vol.error = "invalid NIfTI ndim: " + path;
    return vol;
  }
  size_t count = 1;
  for (int i = ndim; i >= 1; --i) {
    vol.shape.push_back(hdr.dim[i]);
    count *= static_cast<size_t>(hdr.dim[i]);
  }
  size_t offset = static_cast<size_t>(hdr.vox_offset);
  if (offset < sizeof(Nifti1Header)) offset = 352;
  size_t elem = static_cast<size_t>(hdr.bitpix) / 8;
  if (raw.size() < offset + count * elem) {
    vol.error = "truncated NIfTI data section: " + path;
    return vol;
  }
  vol.data.resize(count);
  const uint8_t* src = raw.data() + offset;
  float s = hdr.scl_slope, b = hdr.scl_inter;
  float* dst = vol.data.data();
  switch (hdr.datatype) {
    case DT_UINT8: convert_to_float<uint8_t>(src, count, s, b, dst); break;
    case DT_INT8: convert_to_float<int8_t>(src, count, s, b, dst); break;
    case DT_INT16: convert_to_float<int16_t>(src, count, s, b, dst); break;
    case DT_UINT16: convert_to_float<uint16_t>(src, count, s, b, dst); break;
    case DT_INT32: convert_to_float<int32_t>(src, count, s, b, dst); break;
    case DT_UINT32: convert_to_float<uint32_t>(src, count, s, b, dst); break;
    case DT_FLOAT32: convert_to_float<float>(src, count, s, b, dst); break;
    case DT_FLOAT64: convert_to_float<double>(src, count, s, b, dst); break;
    default:
      vol.error = "unsupported NIfTI datatype " + std::to_string(hdr.datatype) + ": " + path;
      return vol;
  }
  vol.ok = true;
  return vol;
}

// ---------------------------------------------------------------------------
// PNG reading (libpng: no gamma or colour transforms; samples scaled to
// [0, 1] by the source bit depth, or kept as they are with `raw`)
// ---------------------------------------------------------------------------

Volume read_png(const std::string& path, bool raw) {
  Volume vol;
#ifdef GMTPU_HAVE_PNG
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) {
    vol.error = "cannot open: " + path;
    return vol;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    vol.error = "libpng init failed";
    return vol;
  }
  std::vector<png_bytep> rows;  // declared before setjmp: destroyed on error
  std::vector<uint8_t> buf;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    vol.error = "libpng decode error: " + path;
    vol.ok = false;
    return vol;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // raw PNG is big-endian
  png_read_update_info(png, info);

  bit_depth = png_get_bit_depth(png, info);
  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  buf.resize(rowbytes * height);
  rows.resize(height);
  for (png_uint_32 y = 0; y < height; ++y) rows[y] = buf.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  size_t count = static_cast<size_t>(width) * height * channels;
  vol.data.resize(count);
  if (bit_depth == 16) {
    const float scale = raw ? 1.0f : 1.0f / 65535.0f;
    const uint16_t* src = reinterpret_cast<const uint16_t*>(buf.data());
    for (size_t i = 0; i < count; ++i) vol.data[i] = src[i] * scale;
  } else {
    const float scale = raw ? 1.0f : 1.0f / 255.0f;
    const uint8_t* src = buf.data();
    for (size_t i = 0; i < count; ++i) vol.data[i] = src[i] * scale;
  }
  vol.shape = {static_cast<int64_t>(height), static_cast<int64_t>(width)};
  if (channels > 1) vol.shape.push_back(channels);
  vol.ok = true;
#else
  (void)raw;
  vol.error = "this loader was built without a PNG decoder (png.h, libpng's header, was not "
              "found when it was built): " + path;
#endif
  return vol;
}

// ---------------------------------------------------------------------------
// JPEG reading (libjpeg; 8-bit gray/RGB)
// ---------------------------------------------------------------------------

#ifdef GMTPU_HAVE_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(err->jmp, 1);
}
#endif

Volume read_jpeg(const std::string& path, bool raw) {
  Volume vol;
#ifdef GMTPU_HAVE_JPEG
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) {
    vol.error = "cannot open: " + path;
    return vol;
  }
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    vol.error = "libjpeg decode error: " + path;
    vol.ok = false;
    vol.data.clear();
    return vol;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);

  size_t width = cinfo.output_width;
  size_t height = cinfo.output_height;
  size_t channels = cinfo.output_components;
  const float scale = raw ? 1.0f : 1.0f / 255.0f;
  std::vector<uint8_t> row(width * channels);
  vol.data.resize(width * height * channels);
  uint8_t* rp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    size_t y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = vol.data.data() + y * width * channels;
    for (size_t i = 0; i < width * channels; ++i) dst[i] = row[i] * scale;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);

  vol.shape = {static_cast<int64_t>(height), static_cast<int64_t>(width)};
  if (channels > 1) vol.shape.push_back(static_cast<int64_t>(channels));
  vol.ok = true;
#else
  (void)raw;
  vol.error = "this loader was built without a JPEG decoder (jpeglib.h, libjpeg's header, was "
              "not found when it was built): " + path;
#endif
  return vol;
}

bool ends_with(const std::string& s, const char* suffix) {
  size_t n = std::strlen(suffix);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; ++i) {
    char a = s[s.size() - n + i], b = suffix[i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != b) return false;
  }
  return true;
}

Volume read_any(const std::string& path, bool raw) {
  if (ends_with(path, ".png")) return read_png(path, raw);
  if (ends_with(path, ".jpg") || ends_with(path, ".jpeg")) return read_jpeg(path, raw);
  return read_nifti(path);
}

// ---------------------------------------------------------------------------
// Threaded prefetch loader, in file order
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> files;
  std::vector<std::thread> workers;
  std::map<size_t, Volume> ready;  // the reorder buffer, keyed by claim index
  std::mutex mu;
  std::condition_variable cv_ready;  // a volume was filed, or a worker ended
  std::condition_variable cv_space;  // the consumer moved on, or stop
  size_t next_claim = 0;  // the next index a worker takes (under mu)
  size_t next_emit = 0;   // the index the consumer waits for (under mu)
  size_t end = 0;         // files.size(), or no end when looping
  size_t max_queue = 1;
  size_t consecutive_failures = 0;  // the consumer's, in emit order
  int active_workers = 0;
  bool loop = false;
  bool stop = false;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_space.wait(lock, [&] {
          return stop || next_claim >= end || next_claim < next_emit + max_queue;
        });
        if (stop || next_claim >= end) break;
        idx = next_claim++;
      }
      Volume v = read_any(files[idx % files.size()], false);
      std::lock_guard<std::mutex> lock(mu);
      ready.emplace(idx, std::move(v));
      cv_ready.notify_all();
    }
    std::lock_guard<std::mutex> lock(mu);
    --active_workers;
    cv_ready.notify_all();
  }

  // The next readable volume in order, or nullptr at the end of the list
  // (never, when looping, unless every file of a whole pass failed).
  Volume* next() {
    std::unique_lock<std::mutex> lock(mu);
    while (next_emit < end) {
      cv_ready.wait(lock, [&] {
        return stop || ready.count(next_emit) > 0 || active_workers == 0;
      });
      auto it = ready.find(next_emit);
      if (it == ready.end()) return nullptr;  // stopped
      Volume v = std::move(it->second);
      ready.erase(it);
      ++next_emit;
      cv_space.notify_all();
      if (v.ok) {
        consecutive_failures = 0;
        return new Volume(std::move(v));
      }
      // skip unreadable files rather than emit garbage; a whole pass of
      // failures while looping would spin forever, so it ends the stream
      std::fprintf(stderr, "[gmtpu_data] skipping: %s\n", v.error.c_str());
      if (++consecutive_failures >= files.size() && loop) {
        stop = true;
        cv_space.notify_all();
        return nullptr;
      }
    }
    return nullptr;
  }
};

void copy_error(const std::string& msg, char* err, int err_len) {
  if (err == nullptr || err_len <= 0) return;
  std::snprintf(err, static_cast<size_t>(err_len), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Bit 0: the PNG decoder was built; bit 1: the JPEG decoder was built.
int gmtpu_decoders() {
  int mask = 0;
#ifdef GMTPU_HAVE_PNG
  mask |= 1;
#endif
#ifdef GMTPU_HAVE_JPEG
  mask |= 2;
#endif
  return mask;
}

// Reads one file by extension (PNG, JPEG, else NIfTI); image samples are
// scaled to [0, 1] by the source bit depth unless `raw`. Returns a Volume*
// handle, or nullptr with the reason in `err`.
void* gmtpu_read(const char* path, int raw, char* err, int err_len) {
  Volume* v = new Volume(read_any(path, raw != 0));
  if (!v->ok) {
    copy_error(v->error, err, err_len);
    delete v;
    return nullptr;
  }
  return v;
}

int gmtpu_volume_ndim(void* handle) {
  return static_cast<int>(static_cast<Volume*>(handle)->shape.size());
}

void gmtpu_volume_shape(void* handle, int64_t* out) {
  Volume* v = static_cast<Volume*>(handle);
  std::memcpy(out, v->shape.data(), v->shape.size() * sizeof(int64_t));
}

const float* gmtpu_volume_data(void* handle) {
  return static_cast<Volume*>(handle)->data.data();
}

void gmtpu_volume_free(void* handle) { delete static_cast<Volume*>(handle); }

void* gmtpu_loader_create(const char** paths, int num_paths, int num_workers, int max_queue,
                          int loop) {
  Loader* loader = new Loader();
  loader->files.assign(paths, paths + num_paths);
  loader->loop = loop != 0;
  loader->end = loader->loop ? std::numeric_limits<size_t>::max() : loader->files.size();
  loader->max_queue = static_cast<size_t>(max_queue > 0 ? max_queue : 1);
  loader->active_workers = num_workers;
  for (int i = 0; i < num_workers; ++i) loader->workers.emplace_back(&Loader::worker, loader);
  return loader;
}

// Blocks until the next volume in order is decoded; returns a Volume*
// handle, or nullptr when the (non-looping) list is exhausted.
void* gmtpu_loader_next(void* handle) { return static_cast<Loader*>(handle)->next(); }

void gmtpu_loader_destroy(void* handle) {
  Loader* loader = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(loader->mu);
    loader->stop = true;
  }
  loader->cv_space.notify_all();
  loader->cv_ready.notify_all();
  for (auto& t : loader->workers) {
    if (t.joinable()) t.join();
  }
  delete loader;
}

}  // extern "C"
