// Native mask/data-loading kernels for the host-side pipeline.
//
// The reference leans on external native code (panopticapi C speedups,
// pycocotools' C RLE/polygon rasterisation, torchvision decode) for its
// per-sample CPU work (SURVEY.md section 2.7).  This is the PyTorch port's
// copy of flmm_tpu/runtime/maskops.cpp, with the same arithmetic:
//   * panoptic RGB -> segment-id decode (reference png.py:89-96)
//   * multi-segment union masks (png.py:152-156)
//   * COCO uncompressed-RLE decode (column-major)
//   * polygon scanline rasterisation (pycocotools frPoly semantics:
//     even-odd fill over pixel centres)
//   * nearest-neighbour mask resize with torch indexing (floor(i*in/out))
//
// Built at first use by flmm_tpu_torch/runtime/__init__.py (g++ -O3
// -shared -fPIC, with image_decode.cpp) and bound with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// RGB (H, W, 3 uint8) -> ids (H, W int32): R + 256*G + 65536*B
void rgb2id(const uint8_t* rgb, int32_t* ids, int64_t n_pixels) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    const uint8_t* p = rgb + 3 * i;
    ids[i] = (int32_t)p[0] + 256 * (int32_t)p[1] + 65536 * (int32_t)p[2];
  }
}

// union of segment ids -> uint8 mask
void segment_union(const int32_t* ids, int64_t n_pixels,
                   const int32_t* wanted, int n_wanted, uint8_t* out) {
  std::memset(out, 0, n_pixels);
  for (int64_t i = 0; i < n_pixels; ++i) {
    int32_t v = ids[i];
    for (int k = 0; k < n_wanted; ++k) {
      if (v == wanted[k]) { out[i] = 1; break; }
    }
  }
}

// COCO uncompressed RLE (column-major counts) -> uint8 (h, w) row-major
void rle_decode(const int32_t* counts, int n_counts, int h, int w,
                uint8_t* out) {
  std::vector<uint8_t> flat((size_t)h * w, 0);
  int64_t pos = 0;
  uint8_t val = 0;
  for (int i = 0; i < n_counts; ++i) {
    int64_t c = counts[i];
    if (val) std::fill(flat.begin() + pos, flat.begin() + std::min<int64_t>(pos + c, (int64_t)h * w), 1);
    pos += c;
    val ^= 1;
  }
  // column-major -> row-major
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      out[(int64_t)y * w + x] = flat[(int64_t)x * h + y];
}

// even-odd scanline polygon fill over pixel centres (x+0.5, y+0.5)
void polygon_fill(const double* xy, int n_points, int h, int w,
                  uint8_t* out /* preset by caller; OR-accumulated */) {
  if (n_points < 3) return;
  std::vector<double> xs;
  for (int y = 0; y < h; ++y) {
    double py = y + 0.5;
    xs.clear();
    for (int i = 0; i < n_points; ++i) {
      int j = (i + 1) % n_points;
      double y0 = xy[2 * i + 1], y1 = xy[2 * j + 1];
      double x0 = xy[2 * i], x1 = xy[2 * j];
      if ((y0 <= py && y1 > py) || (y1 <= py && y0 > py)) {
        double t = (py - y0) / (y1 - y0);
        xs.push_back(x0 + t * (x1 - x0));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      int xa = (int)std::ceil(xs[k] - 0.5);
      int xb = (int)std::floor(xs[k + 1] - 0.5);
      xa = std::max(xa, 0);
      xb = std::min(xb, w - 1);
      for (int x = xa; x <= xb; ++x) out[(int64_t)y * w + x] = 1;
    }
  }
}

// torch-style nearest resize of a uint8 mask
void nearest_resize_u8(const uint8_t* in, int ih, int iw,
                       uint8_t* out, int oh, int ow) {
  std::vector<int> cols(ow);
  for (int x = 0; x < ow; ++x) cols[x] = (int)((int64_t)x * iw / ow);
  for (int y = 0; y < oh; ++y) {
    int sy = (int)((int64_t)y * ih / oh);
    const uint8_t* row = in + (int64_t)sy * iw;
    uint8_t* orow = out + (int64_t)y * ow;
    for (int x = 0; x < ow; ++x) orow[x] = row[cols[x]];
  }
}

}  // extern "C"
