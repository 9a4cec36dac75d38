// The one-channel output stage of the image decoders for Hopper (sm_90a):
// PixelShuffle(2), an optional eval-mode BatchNorm and a 3x3 convolution to
// one channel, from the pre-shuffle map, in one pass.
//
//   v[c, Y, X] = in[4c + 2 (Y % 2) + (X % 2), Y / 2, X / 2]
//   a[c, Y, X] = fma(gamma[c] (v - mean[c]), invstd[c], beta[c]) inside the
//                2h x 2w image, 0 outside it (the convolution's zero padding
//                comes after the BatchNorm)
//   out[Y, X]  = sum_c sum_{ky, kx} weight[c, ky, kx] a[c, Y + ky - 1, X + kx - 1] + bias
//
// for each image of the batch, in true float32 on the CUDA cores (no TF32,
// no atomics).  a is torch's eval BatchNorm on the card bit for bit (cuDNN's
// and torch's own kernel both compute that form, with invstd =
// torch.rsqrt(running_var + eps)), and each output's sum runs over c, then
// ky, then kx, in registers, as cuDNN's implicit GEMM for these shapes sums
// it: the stage's output equals the modules' (PERF.md).
//
// It replaces no Pallas kernel.  The JAX package rewrote the same projection
// for the TPU as a jnp program (inbed_pose_estimation_tpu/models/decoder.py::
// SmallOCConv3x3, a 1x1 contraction to tap channels and a shifted sum); on
// the H100 cuDNN runs Conv2d(C, 1, 3) as an implicit GEMM tiled for many
// output channels, and PixelShuffle and BatchNorm each read and write the
// whole 2h x 2w map before it.
//
// Bound on an H100 SXM: the input is read once, 4C h w floats an image (822 MB
// at B = 32, C = 128, h = w = 112: 0.245 ms at 3.35 TB/s; 411 MB and 0.123 ms
// at C = 64), against 18 C FLOP an output pixel (3.7 GFLOP, 0.055 ms at the
// 67 TFLOP/s float32 peak).  So it is bound by bytes, at ~4.5 FLOP a byte.
//
// Design, against that bound:
// - A block of 128 threads owns 8 pre-shuffle rows of one image (16 output
//   rows) and 120 pre-shuffle columns (240 output columns; one column tile
//   at w = 112), and loops over the channels.  For each channel it stages the
//   9 pre-shuffle rows of each of the 4 sub-planes that its outputs touch
//   (its 8 rows and a one-row halo, above for the odd sub-planes and below
//   for the even ones), 128 columns wide from 4 left of its first column.
//   The input is read from device memory about once: the halo rows, 1/8
//   more, are read again from L2.
// - cp.async moves each channel from device memory into a double buffer in
//   shared memory without the registers, in 16-byte pieces: with w % 4 == 0
//   and a 16-byte aligned input every row starts on a 16-byte boundary, so
//   each piece lies wholly inside or outside the image, and those outside are
//   zero-filled.  Channel c + 1's copies fly while channel c is computed.
//   Once a thread's own pieces of channel c have landed it applies the
//   BatchNorm to those inside the image, in place; then one barrier a
//   channel.  (Staging through registers, with the BatchNorm on the way,
//   held 36 loads a thread and read 62% of the bandwidth; a third buffer, or
//   more rows a block, read less; folding the BatchNorm into the weights
//   saved 4% of the time but not the modules' rounding.)
// - Each thread owns one pre-shuffle column, i.e. a 16 x 2 strip of outputs
//   in 32 accumulators, and walks the 18 shuffled rows that the strip's 3x3
//   windows cover: 4 shared-memory loads a row (conflict-free, neighbouring
//   threads on neighbouring columns) feed up to 18 FMAs.
// - 14 x 32 = 448 blocks at the decoders' shapes, four on an SM (registers
//   capped at 128 a thread, 37 KB of shared memory a block): all resident
//   at once, so no block waits for a second wave.  Any B, C and h, and any w
//   that is a multiple of 4, is taken (the decoders' w = img_res / 2 is one of
//   16, since their skip joins need img_res divisible by 32); the ragged
//   edges are masked, nothing is padded.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kLead = 4;                    // staged columns left of a block's first column
constexpr int kCols = kThreads - 2 * kLead;  // pre-shuffle columns a block computes
constexpr int kTileRows = 8;                // pre-shuffle rows a block computes
constexpr int kStages = 2;                  // channels in the shared-memory ring
constexpr int kRows = kTileRows + 1;        // rows staged for each sub-plane
constexpr int kStaged = 4 * kRows;          // rows staged for each channel
constexpr int kOutRows = 2 * kTileRows;
constexpr int kSlot = kStaged * kThreads;   // floats a channel takes in the ring

// Copies 16 bytes from device memory into shared memory without the
// registers, or zero-fills them when `inside` is false (src-size 0: nothing
// is read).
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool inside) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(inside ? 16 : 0));
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__global__ void __launch_bounds__(kThreads, 4)
shuffle_project_kernel(const float* __restrict__ in,      // [B, 4C, h, w]
                       const float* __restrict__ weight,  // [C, 3, 3]
                       const float* __restrict__ norm,    // [4, C]: mean, invstd, gamma, beta; or null
                       const float* __restrict__ bias,    // [1] or null (0)
                       float* __restrict__ out,           // [B, 1, 2h, 2w]
                       int channels, int h, int w) {
  // Ring slot [stage][r][col]: staged row r = s * kRows + j of sub-plane
  // s = 2p + q holds pre-shuffle row y0 + j - p, columns x0 - kLead ..
  // x0 + kCols + kLead - 1, as they are in the input (0 outside the image).
  __shared__ __align__(16) float ring[kStages * kSlot];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kCols;
  const int y0 = blockIdx.y * kTileRows;
  const int plane = h * w;
  const float* src = in + static_cast<size_t>(blockIdx.z) * 4 * channels * plane;

  // This thread's copies of a channel: kPer pieces of kVec floats, piece i
  // at staged row r(i) and column col (the same for each piece).
  constexpr int kVec = 4;                      // floats a piece
  constexpr int kLanes = kThreads / kVec;      // threads that cover a staged row
  constexpr int kRowStep = kThreads / kLanes;  // staged rows the block covers at once
  constexpr int kPer = kStaged / kRowStep;
  const int col = (tid % kLanes) * kVec, row0 = tid / kLanes;
  const int xs = x0 - kLead + col;
  unsigned long long inside = 0;  // bit i: piece i lies in the image
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + i * kRowStep, y = y0 + r % kRows - (r / kRows >> 1);
    if (xs >= 0 && xs < w && y >= 0 && y < h) inside |= 1ull << i;
  }

  // Issue channel c's copies into its slot (an empty group past the last
  // channel, so that every thread counts the same groups).
  auto issue = [&](int c) {
    if (c < channels) {
      float* slot = ring + (c % kStages) * kSlot + row0 * kThreads + col;
      const float* base = src + static_cast<size_t>(4 * c) * plane + static_cast<ptrdiff_t>(y0) * w + xs;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = row0 + i * kRowStep, s = r / kRows, dy = r % kRows - (s >> 1);
        const bool ok = (inside >> i) & 1;
        copy_async(slot + i * kRowStep * kThreads, ok ? base + s * plane + dy * w : in, ok);
      }
    }
    commit_copies();
  };

  float acc[kOutRows][2];
#pragma unroll
  for (int m = 0; m < kOutRows; ++m) acc[m][0] = acc[m][1] = 0.f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  for (int c = 0; c < channels; ++c) {
    float wk[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wk[t] = __ldg(weight + 9 * c + t);
    wait_copies<kStages - 2>();  // this thread's copies of channel c have landed
    if (norm != nullptr) {
      // The BatchNorm, in place on this thread's own pieces that lie in the
      // image: the zero-filled padding stays 0.
      const float mean = __ldg(norm + c), invstd = __ldg(norm + channels + c);
      const float gamma = __ldg(norm + 2 * channels + c), beta = __ldg(norm + 3 * channels + c);
      const auto bn = [&](float v) { return fmaf(__fmul_rn(gamma, __fsub_rn(v, mean)), invstd, beta); };
      float* mine = ring + (c % kStages) * kSlot + row0 * kThreads + col;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (!((inside >> i) & 1)) continue;
        float4* piece = reinterpret_cast<float4*>(mine + i * kRowStep * kThreads);
        const float4 v = *piece;
        *piece = make_float4(bn(v.x), bn(v.y), bn(v.z), bn(v.w));
      }
    }
    __syncthreads();  // channel c is in place for all; channel c - 1's slot is free
    issue(c + kStages - 1);
    if (tid < kCols) {
      // Row 2 y0 - 1 + k of the shuffled map, k = 0 .. kOutRows + 1, is
      // sub-plane row p = (k + 1) % 2, staged row k / 2.  Its columns
      // 2x - 1 .. 2x + 2 for this thread's x = x0 + tid are v0 .. v3.
      const float* slot = ring + (c % kStages) * kSlot + tid + kLead;
#pragma unroll
      for (int k = 0; k < kOutRows + 2; ++k) {
        const int p = (k + 1) & 1, j = k >> 1;
        const float* even = slot + ((2 * p) * kRows + j) * kThreads;     // q = 0
        const float* odd = slot + ((2 * p + 1) * kRows + j) * kThreads;  // q = 1
        const float v0 = odd[-1], v1 = even[0], v2 = odd[0], v3 = even[1];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int m = k - ky;  // the output row that this row enters at tap row ky
          if (m < 0 || m >= kOutRows) continue;
          acc[m][0] = fmaf(wk[3 * ky], v0, acc[m][0]);
          acc[m][0] = fmaf(wk[3 * ky + 1], v1, acc[m][0]);
          acc[m][0] = fmaf(wk[3 * ky + 2], v2, acc[m][0]);
          acc[m][1] = fmaf(wk[3 * ky], v1, acc[m][1]);
          acc[m][1] = fmaf(wk[3 * ky + 1], v2, acc[m][1]);
          acc[m][1] = fmaf(wk[3 * ky + 2], v3, acc[m][1]);
        }
      }
    }
  }
  wait_copies<0>();

  const int x = x0 + tid;
  if (tid >= kCols || x >= w) return;
  const float b = bias != nullptr ? __ldg(bias) : 0.f;
  float* dst = out + static_cast<size_t>(blockIdx.z) * 4 * plane + 2 * x;
#pragma unroll
  for (int m = 0; m < kOutRows; ++m) {
    const int Y = 2 * y0 + m;
    if (Y >= 2 * h) break;
    *reinterpret_cast<float2*>(dst + static_cast<size_t>(Y) * 2 * w) = make_float2(acc[m][0] + b, acc[m][1] + b);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = success).
// `in` is [batch, 4 channels, h, w] and `out` [batch, 1, 2h, 2w], both
// contiguous float32 (`in` 16-byte aligned with w % 4 == 0, `out` 8-byte
// aligned); `weight` [channels, 3, 3];
// `norm` is null (no BatchNorm) or [4, channels]: running mean,
// rsqrt(running var + eps), weight and bias; `bias` is null or [1].
extern "C" int shuffle_project_forward(const void* in, const void* weight, const void* norm, const void* bias,
                                       void* out, int batch, int channels, int h, int w, void* stream) {
  if (batch <= 0 || channels <= 0 || h <= 0 || w <= 0 || batch > 65535 || 4ll * channels * h * w > 0x7fffffffll ||
      w % 4 != 0 || reinterpret_cast<size_t>(in) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((w + kCols - 1) / kCols, (h + kTileRows - 1) / kTileRows, batch);
  shuffle_project_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(weight), static_cast<const float*>(norm),
      static_cast<const float*>(bias), static_cast<float*>(out), channels, h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* shuffle_project_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
