// SMPL linear blend skinning for Hopper (sm_90a).
//
// Replaces the TPU kernel inbed_pose_estimation_tpu/ops/pallas_lbs.py::_skin_kernel
// (launched by _skinning_fwd_impl through pl.pallas_call).  It computes
//
//   out[b, v] = (sum_j W[v, j] A_rot[b, j]) @ v_posed[b, v] + sum_j W[v, j] A_t[b, j]
//
// over the 24 SMPL joints, in float32.
//
// Bound on an H100 SXM at the eval batch (B = 32, V = 6890): the kernel must
// move v_posed in (2.65 MB) + out (2.65 MB) + W (0.66 MB) + the affines
// (37 KB), about 5.95 MB, or 1.8 us at 3.35 TB/s; it does about
// B * V * (24 * 12 + 12) * 2 = 132 MFLOP of float32 FMA, about 2 us at the
// 67 TFLOP/s non-tensor float32 peak.  So it is bound at a few microseconds
// and launch overhead dominates.
//
// Design: the TPU kernel laid vertices out as [B, 3, Vpad] so that vertices
// fill the 128-wide lane axis.  Here each thread owns one vertex of one batch
// element and reads the [B, V, 3] / [V, 24] layouts as they are: no padding,
// no transpose; the thread past V returns.  The block's 24 x 12 affines of
// batch b (1152 B) sit in shared memory and every thread reads them by
// broadcast.  A thread blends the 3 x 4 affine as sum_j w_j A_j (24 x 12 FMA)
// and applies it once.  The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kAffine = 12;  // r00..r22, t0, t1, t2
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
skin_kernel(const float* __restrict__ aff,     // [B, 24, 12]
            const float* __restrict__ v_posed, // [B, V, 3]
            const float* __restrict__ weights, // [V, 24]
            float* __restrict__ out,           // [B, V, 3]
            int num_vertices) {
  __shared__ float s_aff[kJoints * kAffine];
  const int b = blockIdx.y;
  const float* aff_b = aff + static_cast<size_t>(b) * kJoints * kAffine;
  for (int i = threadIdx.x; i < kJoints * kAffine; i += blockDim.x) {
    s_aff[i] = aff_b[i];
  }
  __syncthreads();

  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= num_vertices) return;

  const float* w = weights + static_cast<size_t>(v) * kJoints;
  float m[kAffine];
#pragma unroll
  for (int k = 0; k < kAffine; ++k) m[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    const float wj = w[j];
#pragma unroll
    for (int k = 0; k < kAffine; ++k) m[k] = fmaf(wj, s_aff[j * kAffine + k], m[k]);
  }

  const size_t base = (static_cast<size_t>(b) * num_vertices + v) * 3;
  const float x = v_posed[base + 0];
  const float y = v_posed[base + 1];
  const float z = v_posed[base + 2];
  out[base + 0] = m[0] * x + m[1] * y + m[2] * z + m[9];
  out[base + 1] = m[3] * x + m[4] * y + m[5] * z + m[10];
  out[base + 2] = m[6] * x + m[7] * y + m[8] * z + m[11];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = success).
extern "C" int skinning_forward(const void* aff, const void* v_posed, const void* weights,
                                void* out, int batch, int num_vertices, void* stream) {
  if (batch <= 0 || num_vertices <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((num_vertices + kThreads - 1) / kThreads, batch);
  skin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(aff), static_cast<const float*>(v_posed),
      static_cast<const float*>(weights), static_cast<float*>(out), num_vertices);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* skinning_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
