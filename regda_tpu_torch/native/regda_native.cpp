// Native tile-loading + fused-augmentation pipeline for regda_tpu_torch (the
// port's copy of native/regda_native.cpp).
//
// Replaces the role of the reference's torch DataLoader worker processes +
// albumentations (regda/datasets/daLoader.py:53 num_workers=4,
// configs/ToVaihingen.py:44-55): per sample, decode the PNG tile and mask
// and apply crop/flip/rot90/normalize in ONE fused pass (no intermediate
// buffers), multi-threaded across the batch. Exposed as a C ABI consumed
// via ctypes (regda_tpu_torch/native/__init__.py); geometry parameters are drawn
// by the Python RNG so the native and pure-Python paths are bit-identical.
//
// Build: g++ -O3 -shared -fPIC regda_native.cpp -lpng -lz -pthread

#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG decode (libpng, 8-bit, gray or RGB; palette/RGBA normalized)
// ---------------------------------------------------------------------------

struct Png {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // h * w * c
};

bool decode_png_file(const char* path, Png* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->h = png_get_image_height(png, info);
  out->w = png_get_image_width(png, info);
  out->c = png_get_channels(png, info);
  out->data.resize(size_t(out->h) * out->w * out->c);
  std::vector<png_bytep> rows(out->h);
  size_t stride = size_t(out->w) * out->c;
  for (int y = 0; y < out->h; ++y) rows[y] = out->data.data() + y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

// ---------------------------------------------------------------------------
// Fused geometry: output (i, j) -> source pixel through the inverse of
// crop -> hflip? -> vflip? -> rot90^k (numpy rot90(axes=(0,1)) semantics)
// ---------------------------------------------------------------------------

struct Geo {
  int x0, y0, crop, hflip, vflip, rotk;
  inline void src(int i, int j, int* sy, int* sx) const {
    int s = crop, y, x;
    switch (rotk & 3) {  // out[i,j] = g[...]  (g = flipped crop)
      case 0: y = i; x = j; break;
      case 1: y = j; x = s - 1 - i; break;
      case 2: y = s - 1 - i; x = s - 1 - j; break;
      default: y = s - 1 - j; x = i; break;
    }
    if (vflip) y = s - 1 - y;
    if (hflip) x = s - 1 - x;
    *sy = y0 + y;
    *sx = x0 + x;
  }
};

}  // namespace

extern "C" {

int rn_png_info(const char* path, int* h, int* w, int* c) {
  Png p;  // full decode; info-only probing is not on the hot path
  if (!decode_png_file(path, &p)) return -1;
  *h = p.h; *w = p.w; *c = p.c;
  return 0;
}

int rn_decode_png(const char* path, uint8_t* out, int64_t cap,
                  int* h, int* w, int* c) {
  Png p;
  if (!decode_png_file(path, &p)) return -1;
  if ((int64_t)p.data.size() > cap) return -2;
  std::memcpy(out, p.data.data(), p.data.size());
  *h = p.h; *w = p.w; *c = p.c;
  return (int)p.data.size();
}

// One sample: decode image (+ optional mask) PNGs, fused geometry +
// normalize. sup_in (optional, pre-decoded int32 region map) shares the
// geometry. Mask ids get +offset then >= num_classes -> ignore_label
// (regda/datasets/basedata.py:86-91 semantics).
int rn_load_sample(const char* img_path, const char* mask_path,
                   const int32_t* sup_in,
                   int x0, int y0, int crop, int hflip, int vflip, int rotk,
                   const float* mean, const float* stdv, float clamp_max,
                   int offset, int num_classes, int ignore_label,
                   float* out_img, int32_t* out_mask, int32_t* out_sup) {
  Png img;
  if (!decode_png_file(img_path, &img) || img.c < 3) return -1;
  if (x0 < 0 || y0 < 0 || x0 + crop > img.w || y0 + crop > img.h) return -3;

  Png mask;
  bool has_mask = mask_path && out_mask;
  if (has_mask) {
    if (!decode_png_file(mask_path, &mask) || mask.c != 1 ||
        mask.h != img.h || mask.w != img.w)
      return -4;
  }

  Geo g{x0, y0, crop, hflip, vflip, rotk};
  const bool do_clamp = clamp_max > -1e30f;
  for (int i = 0; i < crop; ++i) {
    float* orow = out_img + size_t(i) * crop * 3;
    for (int j = 0; j < crop; ++j) {
      int sy, sx;
      g.src(i, j, &sy, &sx);
      const uint8_t* px = img.data.data() + (size_t(sy) * img.w + sx) * img.c;
      for (int k = 0; k < 3; ++k) {
        // divide (not reciprocal-multiply) to stay bit-identical with the
        // numpy float32 path
        float v = (float(px[k]) - mean[k]) / stdv[k];
        orow[j * 3 + k] = do_clamp && v > clamp_max ? clamp_max : v;
      }
      if (has_mask) {
        int m = int(mask.data[size_t(sy) * mask.w + sx]) + offset;
        out_mask[size_t(i) * crop + j] =
            (m >= num_classes) ? ignore_label : m;
      }
      if (sup_in && out_sup)
        out_sup[size_t(i) * crop + j] = sup_in[size_t(sy) * img.w + sx];
    }
  }
  return 0;
}

// Threaded batch: params is n x 6 ints (x0, y0, crop, hflip, vflip, rotk).
// sups: array of n pointers (each img-sized int32 map or null). Returns 0
// on success, else the first per-sample error code.
int rn_load_batch(int n, const char** img_paths, const char** mask_paths,
                  const int32_t** sups, const int* params,
                  const float* mean, const float* stdv, float clamp_max,
                  int offset, int num_classes, int ignore_label, int crop,
                  float* out_img, int32_t* out_mask, int32_t* out_sup,
                  int nthreads) {
  std::atomic<int> next(0), err(0);
  auto work = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      const int* p = params + i * 6;
      int rc = rn_load_sample(
          img_paths[i], mask_paths ? mask_paths[i] : nullptr,
          sups ? sups[i] : nullptr, p[0], p[1], p[2], p[3], p[4], p[5],
          mean, stdv, clamp_max, offset, num_classes, ignore_label,
          out_img + size_t(i) * crop * crop * 3,
          out_mask ? out_mask + size_t(i) * crop * crop : nullptr,
          out_sup ? out_sup + size_t(i) * crop * crop : nullptr);
      if (rc != 0) {
        int zero = 0;
        err.compare_exchange_strong(zero, rc);
      }
    }
  };
  int nt = nthreads > 0 ? nthreads : 1;
  if (nt == 1 || n == 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt && t < n; ++t) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return err.load();
}

}  // extern "C"
