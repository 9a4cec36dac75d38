// Native host-side image preprocessing kernel of the PyTorch port.
//
// The port's copy of the JAX package's ops/native/preprocess.cc, the same
// code: one call crops, resizes (bilinear), rotates, applies the channel
// noise and normalizes a batch of uint8 NHWC images on host threads, and
// writes NHWC float32.  The reference did this per sample with OpenCV and
// scipy in 8 worker processes (datasets/base_dataset.py:157-183).  It is not
// bit-exact with the Pillow crop of data/transforms.py; built with the same
// flags as the JAX package's, it is bit-exact with that build.
//
// Built and bound by ops/native.py (g++ -O3 -march=native -shared -fPIC).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct CropSpec {
  float center_x, center_y;  // bbox center in source pixels
  float scale;               // bbox height = 200 * scale
  int flip;                  // mirror horizontally after crop
  float noise[3];            // per-channel gain, clamped to [0, 255]
  float rot_deg;             // in-plane rotation (augmentation degrees)
};

// Bilinear sample with zero padding outside the source image.
inline float SampleBilinear(const uint8_t* src, int h, int w, int c, int ch,
                            float x, float y) {
  if (x < -1.f || y < -1.f || x > w || y > h) return 0.f;
  int x0 = static_cast<int>(std::floor(x));
  int y0 = static_cast<int>(std::floor(y));
  float fx = x - x0, fy = y - y0;
  float v = 0.f;
  for (int dy = 0; dy < 2; ++dy) {
    int yy = y0 + dy;
    if (yy < 0 || yy >= h) continue;
    float wy = dy ? fy : 1.f - fy;
    for (int dx = 0; dx < 2; ++dx) {
      int xx = x0 + dx;
      if (xx < 0 || xx >= w) continue;
      float wx = dx ? fx : 1.f - fx;
      v += wy * wx * static_cast<float>(src[(yy * w + xx) * c + ch]);
    }
  }
  return v;
}

void ProcessOne(const uint8_t* src, int src_h, int src_w, int channels,
                const CropSpec& spec, int res, const float* mean,
                const float* std_dev, float* dst) {
  const float box = 200.f * spec.scale;
  const float step = box / res;
  // Rotation path: the crop affine rotates output coordinates about the
  // crop center before the linear map (the inverse of
  // transforms.get_transform's Tc^-1 R(-rot) Tc composition), so the fast
  // lane covers the full train augmentation distribution, not just rot==0.
  const float phi = spec.rot_deg * 3.14159265358979323846f / 180.f;
  const float cs = std::cos(phi), sn = std::sin(phi);
  for (int oy = 0; oy < res; ++oy) {
    const float dv = (oy + 0.5f - 0.5f * res) * step;
    for (int ox = 0; ox < res; ++ox) {
      const int out_x = spec.flip ? (res - 1 - ox) : ox;
      const float du = (ox + 0.5f - 0.5f * res) * step;
      const float sx = spec.center_x + cs * du - sn * dv - 0.5f;
      const float sy = spec.center_y + sn * du + cs * dv - 0.5f;
      float* out_px = dst + (oy * res + out_x) * channels;
      for (int ch = 0; ch < channels; ++ch) {
        float v = SampleBilinear(src, src_h, src_w, channels, ch, sx, sy);
        v = std::min(255.f, std::max(0.f, v * spec.noise[ch < 3 ? ch : 0]));
        out_px[ch] = (v / 255.f - mean[ch]) / std_dev[ch];
      }
    }
  }
}

}  // namespace

extern "C" {

// Batch crop+resize+rotate+noise+normalize.
//  src:      B contiguous uint8 images [src_h, src_w, channels]
//  specs:    B * 8 floats (center_x, center_y, scale, flip, noise0..2, rot)
//  mean/std: per-channel normalization
//  dst:      [B, res, res, channels] float32 (caller-allocated)
void preprocess_batch(const uint8_t* src, int batch, int src_h, int src_w,
                      int channels, const float* specs, int res,
                      const float* mean, const float* std_dev, float* dst,
                      int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= batch) return;
      CropSpec spec;
      const float* s = specs + i * 8;
      spec.center_x = s[0];
      spec.center_y = s[1];
      spec.scale = s[2];
      spec.flip = static_cast<int>(s[3]);
      spec.noise[0] = s[4];
      spec.noise[1] = s[5];
      spec.noise[2] = s[6];
      spec.rot_deg = s[7];
      ProcessOne(src + static_cast<int64_t>(i) * src_h * src_w * channels,
                 src_h, src_w, channels, spec, res, mean, std_dev,
                 dst + static_cast<int64_t>(i) * res * res * channels);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads - 1; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // extern "C"
