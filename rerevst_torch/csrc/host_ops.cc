// Native host-side frame pre/post-processing for rerevst_torch.
//
// A copy of runtime/host_ops.cc (the JAX package's host runtime), kept by the
// port so that it builds and loads nothing of rerevst_tpu; the functions and
// their C interface are unchanged.  rerevst_torch/data/native.py builds it
// with the host C++ compiler into rerevst_torch/_build/ at first use.
//
// The reference does this per frame in Python (numpy2tensor/transform_image,
// test/framework.py:26-49, plus cv2.copyMakeBorder reflect padding,
// test/generate_real_video.py:66-83).  Here it is one fused pass per
// direction, C ABI for ctypes:
//
//   preprocess:  BGR u8 HWC -> ImageNet-normalized RGB f32, reflect-padded
//                (cv2.BORDER_REFLECT: edge-inclusive) to (out_h, out_w)
//                with the content placed at offset (pad, pad).
//   postprocess: normalized RGB f32 (padded) -> BGR u8 HWC cropped back.
//
// Single pass, no intermediate buffers; auto-vectorizes under -O3.

#include <cstdint>
#include <cstddef>

namespace {

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};  // RGB order
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

// cv2.BORDER_REFLECT index mapping (edge-inclusive): ...cba|abcd|dcb...
inline int reflect(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * n;
  int j = i % period;
  if (j < 0) j += period;
  return (j < n) ? j : period - 1 - j;
}

}  // namespace

extern "C" {

// src: [h, w, 3] BGR uint8, row stride = w*3.
// dst: [out_h, out_w, 3] float32 RGB normalized.
// The source is conceptually placed at (pad, pad); every dst pixel maps to a
// reflected source coordinate.
void rerevst_preprocess(const uint8_t* src, int h, int w, float* dst,
                        int out_h, int out_w, int pad) {
  const float inv255 = 1.0f / 255.0f;
  const float a0 = inv255 / kStd[0], b0 = -kMean[0] / kStd[0];
  const float a1 = inv255 / kStd[1], b1 = -kMean[1] / kStd[1];
  const float a2 = inv255 / kStd[2], b2 = -kMean[2] / kStd[2];
  for (int y = 0; y < out_h; ++y) {
    const int sy = reflect(y - pad, h);
    const uint8_t* srow = src + static_cast<size_t>(sy) * w * 3;
    float* drow = dst + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int sx = reflect(x - pad, w);
      const uint8_t* p = srow + sx * 3;  // B, G, R
      drow[x * 3 + 0] = p[2] * a0 + b0;  // R
      drow[x * 3 + 1] = p[1] * a1 + b1;  // G
      drow[x * 3 + 2] = p[0] * a2 + b2;  // B
    }
  }
}

// src: [in_h, in_w, 3] float32 normalized RGB (padded frame).
// dst: [h, w, 3] BGR uint8 — crop at (pad, pad), denormalize, clamp, x255.
void rerevst_postprocess(const float* src, int in_h, int in_w, int pad,
                         uint8_t* dst, int h, int w) {
  (void)in_h;
  for (int y = 0; y < h; ++y) {
    const float* srow = src + (static_cast<size_t>(y + pad) * in_w + pad) * 3;
    uint8_t* drow = dst + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < 3; ++c) {
        float v = srow[x * 3 + c] * kStd[c] + kMean[c];
        v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
        // cv2.imwrite's CV_8U conversion rounds (cvRound), so round here.
        drow[x * 3 + (2 - c)] = static_cast<uint8_t>(v * 255.0f + 0.5f);
      }
    }
  }
}

// Batched preprocess: frames [n, h, w, 3] u8 -> [n, out_h, out_w, 3] f32.
void rerevst_preprocess_batch(const uint8_t* src, int n, int h, int w,
                              float* dst, int out_h, int out_w, int pad) {
  const size_t in_stride = static_cast<size_t>(h) * w * 3;
  const size_t out_stride = static_cast<size_t>(out_h) * out_w * 3;
  for (int i = 0; i < n; ++i) {
    rerevst_preprocess(src + i * in_stride, h, w, dst + i * out_stride,
                       out_h, out_w, pad);
  }
}

}  // extern "C"
