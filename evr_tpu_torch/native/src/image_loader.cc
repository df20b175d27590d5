// Frame staging on the host: shortest-side resize → centre crop → RGB uint8.
//
// Counterpart of the JAX package's native stager (its resize, copied
// arithmetic for arithmetic). The decode is not here: the caller hands in a
// decoded 8-bit 3-channel image (cv2's, whose bundled libjpeg-turbo is the
// same on every machine the port runs on, where a system libjpeg may be
// absent), so one route serves every host.
//
// Resize semantics: Pillow's bicubic (Catmull-Rom, a = -0.5), separable in
// two passes, the kernel widened by the scale when downscaling (antialias),
// and a uint8 intermediate between the horizontal and the vertical pass, as
// in Pillow's Resample.c. The channels are resized independently, so a BGR
// input is swapped to RGB in the crop's copy.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Catmull-Rom bicubic kernel (a = -0.5), support 2.0: Pillow's BICUBIC.
inline double bicubic_kernel(double x) {
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Filter taps for one output axis, Resample.c semantics: filterscale =
// max(in/out, 1) antialiases a downscale; weights normalised per output.
struct FilterTaps {
  std::vector<int> bounds;      // per out pixel: first source index
  std::vector<int> counts;      // per out pixel: number of taps
  std::vector<double> weights;  // taps, ksize per out pixel
  int ksize = 0;
};

FilterTaps compute_taps(int in_size, int out_size) {
  FilterTaps taps;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  taps.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  taps.bounds.resize(out_size);
  taps.counts.resize(out_size);
  taps.weights.assign(static_cast<size_t>(out_size) * taps.ksize, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double* k = taps.weights.data() + static_cast<size_t>(xx) * taps.ksize;
    double ww = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      const double w = bicubic_kernel((x - center + 0.5) / filterscale);
      k[x - xmin] = w;
      ww += w;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax - xmin; ++x) k[x] /= ww;
    }
    taps.bounds[xx] = xmin;
    taps.counts[xx] = xmax - xmin;
  }
  return taps;
}

inline uint8_t clip8(double v) {
  return static_cast<uint8_t>(std::clamp(std::lround(v), 0L, 255L));
}

// Separable bicubic resize of a 3-channel uint8 image with row stride
// src_stride bytes: the horizontal pass into a uint8 intermediate (Pillow's
// per-pass rounding), then the vertical pass.
void resize3(const uint8_t* src, int sw, int sh, size_t src_stride, uint8_t* dst,
             int dw, int dh) {
  const FilterTaps hx = compute_taps(sw, dw);
  const FilterTaps vy = compute_taps(sh, dh);

  std::vector<uint8_t> tmp(static_cast<size_t>(dw) * sh * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * src_stride;
    uint8_t* out_row = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const double* k = hx.weights.data() + static_cast<size_t>(x) * hx.ksize;
      const int x0 = hx.bounds[x];
      double acc[3] = {0.0, 0.0, 0.0};
      for (int t = 0; t < hx.counts[x]; ++t) {
        const uint8_t* p = row + (static_cast<size_t>(x0) + t) * 3;
        acc[0] += p[0] * k[t];
        acc[1] += p[1] * k[t];
        acc[2] += p[2] * k[t];
      }
      out_row[x * 3] = clip8(acc[0]);
      out_row[x * 3 + 1] = clip8(acc[1]);
      out_row[x * 3 + 2] = clip8(acc[2]);
    }
  }

  for (int y = 0; y < dh; ++y) {
    const double* k = vy.weights.data() + static_cast<size_t>(y) * vy.ksize;
    const int y0 = vy.bounds[y];
    uint8_t* out_row = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      double acc[3] = {0.0, 0.0, 0.0};
      for (int t = 0; t < vy.counts[y]; ++t) {
        const uint8_t* p =
            tmp.data() + ((static_cast<size_t>(y0) + t) * dw + x) * 3;
        acc[0] += p[0] * k[t];
        acc[1] += p[1] * k[t];
        acc[2] += p[2] * k[t];
      }
      out_row[x * 3] = clip8(acc[0]);
      out_row[x * 3 + 1] = clip8(acc[1]);
      out_row[x * 3 + 2] = clip8(acc[2]);
    }
  }
}

}  // namespace

extern "C" {

// Stage one decoded image (h rows of w pixels, 3 channels, row stride
// `stride` bytes; BGR when bgr != 0, else RGB) into out[target][target][3]
// RGB: the shortest side resized to target, then the centre crop. Returns 0,
// or 2 for an empty image.
int evr_stage_pixels(const uint8_t* src, int w, int h, long stride, int bgr,
                     uint8_t* out, int target) {
  if (w <= 0 || h <= 0 || target <= 0) return 2;

  const double scale = static_cast<double>(target) / std::min(w, h);
  const int rw = std::max(target, static_cast<int>(std::lround(w * scale)));
  const int rh = std::max(target, static_cast<int>(std::lround(h * scale)));

  std::vector<uint8_t> resized(static_cast<size_t>(rw) * rh * 3);
  resize3(src, w, h, static_cast<size_t>(stride), resized.data(), rw, rh);

  const int left = (rw - target) / 2;
  const int top = (rh - target) / 2;
  for (int y = 0; y < target; ++y) {
    const uint8_t* row =
        resized.data() + ((static_cast<size_t>(top + y) * rw) + left) * 3;
    uint8_t* dst = out + static_cast<size_t>(y) * target * 3;
    if (!bgr) {
      std::memcpy(dst, row, static_cast<size_t>(target) * 3);
      continue;
    }
    for (int x = 0; x < target; ++x) {
      dst[x * 3] = row[x * 3 + 2];
      dst[x * 3 + 1] = row[x * 3 + 1];
      dst[x * 3 + 2] = row[x * 3];
    }
  }
  return 0;
}

}  // extern "C"
