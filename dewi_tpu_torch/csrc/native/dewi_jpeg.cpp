// dewi_tpu_torch native runtime: GIL-free JPEG decode pool (the port's copy
// of the reference's native/dewi_jpeg.cpp).
//
// The Python ingest path (dewi_tpu_torch/io/images.py) decodes with PIL, whose C
// core releases the GIL — but the surrounding Python (open/draft/convert/
// asarray) still serializes on it, so thread scaling tops out well below
// core count on hot ingest.  This pool does the whole batch in C++:
// read file -> libjpeg decode at the best DCT scale (the same draft-mode
// trick PIL uses: scale_denom picks the smallest 1/2^k image still >= the
// target, so an oversized JPEG never gets fully decoded) -> bilinear
// resize to [size, size, 3] uint8, fanned out over std::thread workers
// with no Python in the loop.
//
// Compiled only when <jpeglib.h> is present (the build probes; the binding
// checks dewi_has_jpeg() and falls back to PIL otherwise).  Per-image
// failures (non-JPEG bytes, CMYK sources, truncated files) set ok[i]=0 and
// leave the caller to decode those few via PIL — never abort the batch.

#include <cstdint>
#include <cstdio>
#include <cstring>

#ifdef DEWI_HAVE_JPEG

#include <atomic>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// libjpeg's default error handler exit()s the process; route fatal decode
// errors to a longjmp so one bad file only fails its own slot.
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_emit_message(j_common_ptr, int) {}  // silence warnings

// Bilinear resize [h, w, 3] uint8 -> [size, size, 3] uint8 (center-aligned
// sample points, clamped edges — the same mapping as io/images.resize_f32).
void resize_bilinear_u8(const uint8_t* src, int h, int w, int size,
                        uint8_t* dst) {
  if (h == size && w == size) {
    memcpy(dst, src, static_cast<size_t>(size) * size * 3);
    return;
  }
  std::vector<int> y0(size), y1(size), x0(size), x1(size);
  std::vector<float> wy(size), wx(size);
  for (int i = 0; i < size; ++i) {
    float y = (i + 0.5f) * h / size - 0.5f;
    float fy = y < 0 ? 0 : y;
    int yi = static_cast<int>(fy);
    y0[i] = yi < h - 1 ? yi : h - 1;
    y1[i] = y0[i] + 1 < h ? y0[i] + 1 : h - 1;
    wy[i] = y < 0 ? 0.0f : (fy - y0[i] > 1.0f ? 1.0f : fy - y0[i]);
    float x = (i + 0.5f) * w / size - 0.5f;
    float fx = x < 0 ? 0 : x;
    int xi = static_cast<int>(fx);
    x0[i] = xi < w - 1 ? xi : w - 1;
    x1[i] = x0[i] + 1 < w ? x0[i] + 1 : w - 1;
    wx[i] = x < 0 ? 0.0f : (fx - x0[i] > 1.0f ? 1.0f : fx - x0[i]);
  }
  for (int i = 0; i < size; ++i) {
    const uint8_t* rt = src + static_cast<size_t>(y0[i]) * w * 3;
    const uint8_t* rb = src + static_cast<size_t>(y1[i]) * w * 3;
    float vy = wy[i];
    uint8_t* out = dst + static_cast<size_t>(i) * size * 3;
    for (int j = 0; j < size; ++j) {
      float vx = wx[j];
      const uint8_t* tl = rt + x0[j] * 3;
      const uint8_t* tr = rt + x1[j] * 3;
      const uint8_t* bl = rb + x0[j] * 3;
      const uint8_t* br = rb + x1[j] * 3;
      for (int c = 0; c < 3; ++c) {
        float top = tl[c] * (1.0f - vx) + tr[c] * vx;
        float bot = bl[c] * (1.0f - vx) + br[c] * vx;
        float v = top * (1.0f - vy) + bot * vy;
        out[j * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Decode one JPEG file to [size, size, 3] uint8.  Returns false on any
// failure (missing file, non-JPEG bytes, unsupported color space, ...).
bool decode_one(const char* path, int size, uint8_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize <= 0) {
    fclose(f);
    return false;
  }
  std::vector<uint8_t> bytes(static_cast<size_t>(fsize));
  size_t got = fread(bytes.data(), 1, bytes.size(), f);
  fclose(f);
  if (got != bytes.size()) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  jerr.pub.emit_message = jpeg_emit_message;
  std::vector<uint8_t> pixels;  // declared before setjmp: cleanup is safe
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, bytes.data(), bytes.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // Draft mode: largest power-of-two denominator whose scaled dims still
  // cover the target square (same policy as PIL Image.draft).
  int denom = 1;
  while (denom < 8 &&
         static_cast<int>(cinfo.image_width) / (denom * 2) >= size &&
         static_cast<int>(cinfo.image_height) / (denom * 2) >= size) {
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = static_cast<unsigned>(denom);
  cinfo.out_color_space = JCS_RGB;  // YCbCr + grayscale convert; CMYK errors
  jpeg_start_decompress(&cinfo);
  int w = static_cast<int>(cinfo.output_width);
  int h = static_cast<int>(cinfo.output_height);
  if (w <= 0 || h <= 0 || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  pixels.resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  resize_bilinear_u8(pixels.data(), h, w, size, out);
  return true;
}

}  // namespace

extern "C" {

// paths_nl: '\n'-joined file paths (n of them).
// out:      [n, size, size, 3] uint8, caller-allocated.
// ok:       [n] uint8 — 1 where the slot decoded, 0 where the caller must
//           fall back (slot bytes are untouched on failure).
// threads:  worker count (clamped to [1, n]).
// Returns the number of successful decodes.
int64_t dewi_decode_jpeg_batch(const char* paths_nl, int64_t n, int32_t size,
                               int32_t threads, uint8_t* out, uint8_t* ok) {
  std::vector<std::string> paths;
  paths.reserve(static_cast<size_t>(n));
  const char* p = paths_nl;
  for (int64_t i = 0; i < n; ++i) {
    const char* nl = strchr(p, '\n');
    if (nl) {
      paths.emplace_back(p, nl - p);
      p = nl + 1;
    } else {
      paths.emplace_back(p);
      p += paths.back().size();
    }
  }
  const size_t stride = static_cast<size_t>(size) * size * 3;
  int nthreads = threads < 1 ? 1 : threads;
  if (static_cast<int64_t>(nthreads) > n) nthreads = static_cast<int>(n);
  std::atomic<int64_t> next(0), succeeded(0);
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      bool good = decode_one(paths[static_cast<size_t>(i)].c_str(), size,
                             out + static_cast<size_t>(i) * stride);
      ok[i] = good ? 1 : 0;
      if (good) succeeded.fetch_add(1);
    }
  };
  if (nthreads <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(nthreads));
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return succeeded.load();
}

int32_t dewi_has_jpeg() { return 1; }

}  // extern "C"

#else  // !DEWI_HAVE_JPEG

extern "C" {

int64_t dewi_decode_jpeg_batch(const char*, int64_t, int32_t, int32_t,
                               uint8_t*, uint8_t*) {
  return -1;
}

int32_t dewi_has_jpeg() { return 0; }

}  // extern "C"

#endif  // DEWI_HAVE_JPEG
