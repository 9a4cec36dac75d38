// SMPL linear blend skinning for Hopper (sm_90a).
//
// Replaces the TPU kernel inbed_pose_estimation_tpu/ops/pallas_lbs.py::_skin_kernel
// (launched by _skinning_fwd_impl through pl.pallas_call).  It computes
//
//   T[b, v]   = sum_j W[v, j] aff[b, j]          aff[b, j] = [A_rot[b, j] | A_t[b, j]], 3 x 4
//   out[b, v] = T[b, v] . [v_posed[b, v]; 1]
//
// over the 24 SMPL joints, in true float32 on the CUDA cores (no TF32, no
// skipped zero weights: SMPL's weights are dense enough that the bound
// counts the dense product).
//
// Bound on an H100 SXM: per (b, v) the blend is 24 x 12 FMA and the apply 12,
// so B * V * 300 FMA = 132 MFLOP at B = 32, V = 6890 (1.97 us at the
// 67 TFLOP/s float32 peak) and 265 MFLOP at B = 64 (3.95 us).  The bytes
// that must move, v_posed in + out + W + the affines, are 5.99 MB at B = 32
// (1.79 us at 3.35 TB/s) and 11.3 MB at B = 64 (3.38 us).  So the kernel is
// bound by operations, closely followed by bytes, and at these sizes the
// fixed cost of one launch (about 1 us for a graph node on this card) is
// half the bound.
//
// Design, against what that bound asks for:
// - One launch per call and nothing packed first: the kernel reads A_rot and
//   A_t in place through the element strides the wrapper passes (lbs hands
//   over the strided view world[:, :, :3, :3]) and writes only `out`.
// - The blend is the small GEMM [Vt x 24] . [24 x 12] per batch element.  A
//   block of 224 threads owns a tile of 448 vertices and a chunk of batch
//   elements; each thread owns 2 vertices, holds their 2 x 24 weights in
//   registers for the whole chunk and keeps 2 x 12 accumulators, so each
//   16-byte broadcast load of the affines from shared memory feeds 8 FMAs.
// - W is read from device memory once per batch chunk, not once per batch
//   element: the block stages its W tile (448 rows of 96 bytes, contiguous)
//   in shared memory with coalesced 16-byte loads, and the chunk's
//   [chunk, 24, 12] affines beside it, once.
// - Two blocks fit on an SM (registers and shared memory), and the wrapper
//   picks the smallest chunk whose grid fits in that one wave: at V = 6890
//   16 tiles x 16 chunks = 256 blocks at B = 32 (chunk 2) and at B = 64
//   (chunk 4), so 124 SMs run two blocks and none runs three.  B and V may
//   be ragged, the edges are masked here, nothing is padded.
// - The next batch element's v_posed is loaded before the current one's
//   blend, so its latency hides behind the FMAs.
// What still holds it at about a quarter of the bound is measured in PERF.md
// (the blend runs well below the FMA peak, and the staging does not overlap
// it).  The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kAffine = 12;  // r00 r01 r02 r10 r11 r12 r20 r21 r22 t0 t1 t2
constexpr int kThreads = 224;
constexpr int kVertsPerThread = 2;
constexpr int kTileVerts = kThreads * kVertsPerThread;
constexpr int kMaxChunk = 4;

struct AffineStrides {  // element strides: A_rot (b, j, m, n), A_t (b, j, m)
  long long rb, rj, rm, rn, tb, tj, tm;
};

__global__ void __launch_bounds__(kThreads, 2)  // two blocks per SM
skin_kernel(const float* __restrict__ a_rot, const float* __restrict__ a_t, AffineStrides s,
            const float* __restrict__ v_posed,  // [B, V, 3]
            const float* __restrict__ weights,  // [V, 24]
            float* __restrict__ out,            // [B, V, 3]
            int batch, int num_vertices, int chunk) {
  __shared__ __align__(16) float s_w[kTileVerts * kJoints];
  __shared__ __align__(16) float s_aff[kMaxChunk * kJoints * kAffine];

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * kTileVerts;
  const int b0 = blockIdx.y * chunk;
  const int nb = min(chunk, batch - b0);
  const int rows = min(kTileVerts, num_vertices - v0);

  int vert[kVertsPerThread];
  bool live[kVertsPerThread];
  float x[kVertsPerThread][3];
#pragma unroll
  for (int p = 0; p < kVertsPerThread; ++p) {
    vert[p] = v0 + tid + p * kThreads;
    live[p] = vert[p] < num_vertices;
    const float* src = v_posed + (static_cast<size_t>(b0) * num_vertices + vert[p]) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) x[p][c] = live[p] ? src[c] : 0.f;
  }

  // Stage the W tile (contiguous rows; the wrapper checks 16-byte alignment)
  // and the chunk's affines.
  const float4* w_tile = reinterpret_cast<const float4*>(weights + static_cast<size_t>(v0) * kJoints);
  for (int i = tid; i < rows * (kJoints / 4); i += kThreads) reinterpret_cast<float4*>(s_w)[i] = w_tile[i];
  for (int i = tid; i < nb * kJoints * kAffine; i += kThreads) {
    const int b = i / (kJoints * kAffine), r = i - b * (kJoints * kAffine);
    const int j = r / kAffine, k = r - j * kAffine;
    const long long bb = b0 + b;
    s_aff[i] = k < 9 ? a_rot[bb * s.rb + j * s.rj + (k / 3) * s.rm + (k % 3) * s.rn]
                     : a_t[bb * s.tb + j * s.tj + (k - 9) * s.tm];
  }
  __syncthreads();
  if (!live[0]) return;  // vert[1] > vert[0]: nothing of this thread is inside V

  float w[kVertsPerThread][kJoints];
#pragma unroll
  for (int p = 0; p < kVertsPerThread; ++p) {
#pragma unroll
    for (int q = 0; q < kJoints / 4; ++q) {
      const float4 t = live[p] ? *reinterpret_cast<const float4*>(&s_w[(tid + p * kThreads) * kJoints + 4 * q])
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      w[p][4 * q + 0] = t.x;
      w[p][4 * q + 1] = t.y;
      w[p][4 * q + 2] = t.z;
      w[p][4 * q + 3] = t.w;
    }
  }

  for (int b = 0; b < nb; ++b) {
    float nx[kVertsPerThread][3];
#pragma unroll
    for (int p = 0; p < kVertsPerThread; ++p) {
      const bool more = live[p] && b + 1 < nb;
      const float* src = v_posed + (static_cast<size_t>(b0 + b + 1) * num_vertices + vert[p]) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) nx[p][c] = more ? src[c] : 0.f;
    }

    float m[kVertsPerThread][kAffine];
#pragma unroll
    for (int p = 0; p < kVertsPerThread; ++p)
#pragma unroll
      for (int k = 0; k < kAffine; ++k) m[p][k] = 0.f;

    const float4* aff = reinterpret_cast<const float4*>(s_aff + b * kJoints * kAffine);
#pragma unroll
    for (int j = 0; j < kJoints; ++j) {
      const float4 a0 = aff[3 * j], a1 = aff[3 * j + 1], a2 = aff[3 * j + 2];
      const float a[kAffine] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
      for (int p = 0; p < kVertsPerThread; ++p)
#pragma unroll
        for (int k = 0; k < kAffine; ++k) m[p][k] = fmaf(w[p][j], a[k], m[p][k]);
    }

#pragma unroll
    for (int p = 0; p < kVertsPerThread; ++p) {
      if (!live[p]) continue;
      float* dst = out + (static_cast<size_t>(b0 + b) * num_vertices + vert[p]) * 3;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        dst[r] = m[p][3 * r] * x[p][0] + m[p][3 * r + 1] * x[p][1] + m[p][3 * r + 2] * x[p][2] + m[p][9 + r];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) x[p][c] = nx[p][c];
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = success).
// `chunk` (1..4) is the number of batch elements one block blends.
extern "C" int skinning_forward(const void* a_rot, const void* a_t, long long rb, long long rj, long long rm,
                                long long rn, long long tb, long long tj, long long tm, const void* v_posed,
                                const void* weights, void* out, int batch, int num_vertices, int chunk,
                                void* stream) {
  if (batch <= 0 || num_vertices <= 0 || chunk < 1 || chunk > kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((num_vertices + kTileVerts - 1) / kTileVerts, (batch + chunk - 1) / chunk);
  skin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_rot), static_cast<const float*>(a_t), AffineStrides{rb, rj, rm, rn, tb, tj, tm},
      static_cast<const float*>(v_posed), static_cast<const float*>(weights), static_cast<float*>(out), batch,
      num_vertices, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* skinning_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
