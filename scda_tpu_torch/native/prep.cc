// Native host-side input preparation for scda_tpu_torch.
//
// The reference's data layer leans on OpenCV's C++ kernels
// (ref lib/model/utils/blob.py:~40 prep_im_for_blob -> cv2.resize
// INTER_LINEAR) for the per-image hot path: bilinear resize, mean
// subtraction, canvas padding, horizontal flip.  This library is the
// rebuild's native equivalent, driven from Python via ctypes
// (scda_tpu_torch/native/__init__.py); a numpy implementation of the exact
// same math is the portable fallback and the test oracle.
//
// Conventions:
//   * images are float32 HWC, BGR (caffe lineage);
//   * resize uses classic half-pixel bilinear (cv2 INTER_LINEAR):
//       src = (dst + 0.5) * (src_size / dst_size) - 0.5, clamped;
//   * output canvas is (canvas_h, canvas_w, 3), zero outside the
//     resized extent, mean-subtracted inside it.
//
// Build: g++ -O3 -shared -fPIC -fopenmp prep.cc -o libscda_prep.so

#include <algorithm>
#include <cstdint>
#include <cstring>

// Resize (sh, sw, 3) -> (out_h, out_w, 3) into a zeroed
// (canvas_h, canvas_w, 3) canvas, subtracting mean[3]; optional
// horizontal flip of the SOURCE before resampling.  Templated on the
// source element type so the decoded uint8 image feeds straight in
// (fused convert+resample — the f32 staging copy costs ~10 ms/frame on
// Cityscapes-size images).
template <typename T>
static void prep_image_impl(const T* src, int sh, int sw,
                            float* canvas, int canvas_h, int canvas_w,
                            int out_h, int out_w,
                            const float* mean, int flip) {
  // Zero only the PADDING (right margin + bottom rows), not the whole
  // canvas — the content region is overwritten below anyway (~6 MB of
  // redundant writes per Cityscapes frame otherwise).
  if (out_w < canvas_w) {
#pragma omp parallel for schedule(static)
    for (int y = 0; y < out_h; ++y) {
      std::memset(canvas + (static_cast<long>(y) * canvas_w + out_w) * 3,
                  0, sizeof(float) * (canvas_w - out_w) * 3);
    }
  }
  if (out_h < canvas_h) {
    std::memset(canvas + static_cast<long>(out_h) * canvas_w * 3, 0,
                sizeof(float) * (canvas_h - out_h) * canvas_w * 3);
  }

  // Identity resize (the disk canvas cache stores pre-resized images):
  // the half-pixel map degenerates to src=dst exactly, so this fast
  // path is bit-identical to the general one — just fused
  // convert+mean-subtract (+flip) without the bilinear arithmetic.
  if (out_h == sh && out_w == sw) {
#pragma omp parallel for schedule(static)
    for (int y = 0; y < out_h; ++y) {
      float* dst_row = canvas + static_cast<long>(y) * canvas_w * 3;
      const T* srow = src + static_cast<long>(y) * sw * 3;
      for (int x = 0; x < out_w; ++x) {
        const int xs = flip ? (sw - 1 - x) : x;
        for (int c = 0; c < 3; ++c) {
          dst_row[x * 3 + c] =
              static_cast<float>(srow[xs * 3 + c]) - mean[c];
        }
      }
    }
    return;
  }

  const float sy = static_cast<float>(sh) / out_h;
  const float sx = static_cast<float>(sw) / out_w;

#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float ly = fy - y0;
    float* dst_row = canvas + static_cast<long>(y) * canvas_w * 3;
    const T* row0 = src + static_cast<long>(y0) * sw * 3;
    const T* row1 = src + static_cast<long>(y1) * sw * 3;
    for (int x = 0; x < out_w; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
      int x0 = static_cast<int>(fx);
      int x1 = std::min(x0 + 1, sw - 1);
      const float lx = fx - x0;
      if (flip) {  // sample the mirrored source column
        x0 = sw - 1 - x0;
        x1 = sw - 1 - x1;
      }
      const float w00 = (1 - ly) * (1 - lx), w01 = (1 - ly) * lx;
      const float w10 = ly * (1 - lx), w11 = ly * lx;
      for (int c = 0; c < 3; ++c) {
        const float v =
            w00 * static_cast<float>(row0[x0 * 3 + c]) +
            w01 * static_cast<float>(row0[x1 * 3 + c]) +
            w10 * static_cast<float>(row1[x0 * 3 + c]) +
            w11 * static_cast<float>(row1[x1 * 3 + c]);
        dst_row[x * 3 + c] = v - mean[c];
      }
    }
  }
}

extern "C" {

void prep_image(const float* src, int sh, int sw,
                float* canvas, int canvas_h, int canvas_w,
                int out_h, int out_w,
                const float* mean, int flip) {
  prep_image_impl(src, sh, sw, canvas, canvas_h, canvas_w, out_h, out_w,
                  mean, flip);
}

// uint8 source (straight from the PNG/JPEG decoder / the loader cache).
void prep_image_u8(const uint8_t* src, int sh, int sw,
                   float* canvas, int canvas_h, int canvas_w,
                   int out_h, int out_w,
                   const float* mean, int flip) {
  prep_image_impl(src, sh, sw, canvas, canvas_h, canvas_w, out_h, out_w,
                  mean, flip);
}

// Pairwise IoU matrix (legacy +1 convention) for host-side eval
// (ref lib/model/utils/bbox.pyx bbox_overlaps).
void bbox_overlaps(const float* a, int n, const float* b, int m,
                   float* out) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    const float ax1 = a[i * 4], ay1 = a[i * 4 + 1];
    const float ax2 = a[i * 4 + 2], ay2 = a[i * 4 + 3];
    const float area_a = (ax2 - ax1 + 1) * (ay2 - ay1 + 1);
    for (int j = 0; j < m; ++j) {
      const float bx1 = b[j * 4], by1 = b[j * 4 + 1];
      const float bx2 = b[j * 4 + 2], by2 = b[j * 4 + 3];
      const float iw = std::min(ax2, bx2) - std::max(ax1, bx1) + 1;
      const float ih = std::min(ay2, by2) - std::max(ay1, by1) + 1;
      float iou = 0.0f;
      if (iw > 0 && ih > 0) {
        const float inter = iw * ih;
        const float area_b = (bx2 - bx1 + 1) * (by2 - by1 + 1);
        iou = inter / (area_a + area_b - inter);
      }
      out[static_cast<long>(i) * m + j] = iou;
    }
  }
}

}  // extern "C"
