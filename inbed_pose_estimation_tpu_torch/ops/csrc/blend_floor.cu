// Yardstick for csrc/skinning.cu, not a kernel of the port: the skinning
// blend's multiply-adds with every operand already in a register.
//
// Each thread runs exactly the FFMA pattern of one skinning thread for one
// batch element, m[p][k] += w[p][j] * a[k] over 24 joints, 2 vertices and 12
// affine entries, but loads nothing: no W tile, no affines from shared memory,
// no v_posed, and it stores only when the sums take an impossible value.  A
// grid of ceil(V / 256) x B blocks of 128 threads does the skinning kernel's
// blend for (B, V) (V rounded up to whole tiles), so its time is the least
// the float32 CUDA cores take for that blend in this shape, launch included.
// chip_smoke.py times it beside the skinning kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kAffine = 12;
constexpr int kThreads = 128;
constexpr int kVertsPerThread = 2;

__global__ void __launch_bounds__(kThreads) blend_floor_kernel(float* __restrict__ sink) {
  float w[kVertsPerThread][kJoints], a[kAffine], m[kVertsPerThread][kAffine];
#pragma unroll
  for (int p = 0; p < kVertsPerThread; ++p) {
#pragma unroll
    for (int j = 0; j < kJoints; ++j) w[p][j] = __int_as_float(0x3c000000 + ((threadIdx.x * 13 + p * 7 + j) & 4095));
#pragma unroll
    for (int k = 0; k < kAffine; ++k) m[p][k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < kAffine; ++k) a[k] = __int_as_float(0x3f000000 + ((blockIdx.x * 5 + k) & 4095));
#pragma unroll
  for (int j = 0; j < kJoints; ++j)
#pragma unroll
    for (int p = 0; p < kVertsPerThread; ++p)
#pragma unroll
      for (int k = 0; k < kAffine; ++k) m[p][k] = fmaf(w[p][j], a[k], m[p][k]);
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < kVertsPerThread; ++p)
#pragma unroll
    for (int k = 0; k < kAffine; ++k) sum += m[p][k];
  if (sum == -1.f) sink[threadIdx.x] = sum;  // never true: keeps the sums live
}

}  // namespace

// Launch on `stream` for the shape (batch, num_vertices); `sink` holds at
// least 128 floats.  Returns cudaGetLastError() of the launch (0 = success).
extern "C" int blend_floor(void* sink, int batch, int num_vertices, void* stream) {
  if (batch <= 0 || num_vertices <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = (num_vertices + kThreads * kVertsPerThread - 1) / (kThreads * kVertsPerThread);
  blend_floor_kernel<<<tiles * batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}
