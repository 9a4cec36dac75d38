// The ResNet-50 trunk's eval tail after a convolution, for Hopper (sm_90a):
// eval-mode BatchNorm, an optional residual (itself optionally through a
// second eval BatchNorm) and ReLU, in one pass over the convolution's output.
//
//   bn(v)    = fma(weight[c] (v - mean[c]), invstd[c], bias[c]),
//              invstd[c] = rsqrt(running_var[c] + eps)
//   form 0   out = relu(bn(x))               ("relu": the stem, conv1, conv2)
//   form 1   out = relu(bn(x) + r)           ("add_relu": an identity block)
//   form 2   out = relu(bn(x) + bn'(r))      ("bn_add_relu": a projection block)
//   relu(v)  = v if v is NaN, else max(v, 0)
//
// over NCHW float32 maps, c the channel of the element's (n, c) plane.  Each
// step is the modules' own on the card, bit for bit: torch's eval BatchNorm
// (cuDNN's `bn_fw_inf` and torch's own kernel) computes that fma with that
// invstd, the add rounds once, and relu is torch's clamp_min(0), which keeps
// a NaN.  So the trunk's outputs do not move (PERF.md).
//
// It replaces no Pallas kernel.  On the TPU, XLA fuses BatchNorm, the add and
// ReLU into the convolution's epilogue; on the H100 eager PyTorch runs each
// as its own launch, and each reads and writes the whole map: 53 BatchNorms,
// 33 ReLUs and 16 adds a trunk pass, ~7.4 GB at B = 32, 224^2.
//
// Bound on an H100 SXM: each input is read once and the output written once,
// 8 bytes an element (12 with a residual, through a second BatchNorm or not)
// against at most 10 FLOP: bound by bytes, at 3.35 TB/s.  A trunk pass at
// B = 32 then moves ~3.2 GB, ~0.95 ms.
//
// Design, against that bound:
// - One warp owns a segment of one (n, c) plane: up to 32 * kUnroll vectors
//   of 16 bytes (4 floats) where H W % 4 == 0 and every pointer is 16-byte
//   aligned (the trunk's 112^2, 56^2, 28^2 and 14^2), of single floats
//   otherwise (7^2).  The channel's terms are loaded once a segment (one
//   broadcast load each, from L1) and sit in registers; invstd is computed
//   there, so no per-call host work or extra launch builds the terms.
// - A thread issues all its loads of the segment before its first store:
//   kUnroll 16-byte loads in flight a thread (x and r), so 8 warps a block
//   keep enough bytes in flight to cover the memory's latency.
// - kUnroll follows the plane: 4 for planes of 96 vectors or more, else 2,
//   so that a 7^2 or 14^2 plane (49 floats or vectors) does not idle three
//   quarters of its warp.
// - One warp a segment, 8 a block, no grid-stride loop: at 7x7x2048 and B = 32
//   65,536 segments make 8,192 blocks, many waves on 132 SMs.
// The kernel allocates nothing, uses no atomics and launches on the caller's
// stream.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Norm {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

struct Terms {
  float mean, invstd, gamma, beta;
};

__device__ __forceinline__ Terms load_terms(const Norm& n, int c) {
  return {__ldg(n.mean + c), rsqrtf(__fadd_rn(__ldg(n.var + c), n.eps)), __ldg(n.weight + c), __ldg(n.bias + c)};
}

__device__ __forceinline__ float bn(float v, const Terms& t) {
  return fmaf(__fmul_rn(t.gamma, __fsub_rn(v, t.mean)), t.invstd, t.beta);
}

__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

template <int kForm>
__device__ __forceinline__ float tail(float x, float r, const Terms& a, const Terms& b) {
  if constexpr (kForm == 0) {
    return relu(bn(x, a));
  } else if constexpr (kForm == 1) {
    return relu(__fadd_rn(bn(x, a), r));
  } else {
    return relu(__fadd_rn(bn(x, a), bn(r, b)));
  }
}

template <int kForm>
__device__ __forceinline__ float4 tail(const float4& x, const float4& r, const Terms& a, const Terms& b) {
  return make_float4(tail<kForm>(x.x, r.x, a, b), tail<kForm>(x.y, r.y, a, b), tail<kForm>(x.z, r.z, a, b),
                     tail<kForm>(x.w, r.w, a, b));
}

// V is float4 (16-byte vectors) or float; `plane` counts V's.
template <int kForm, typename V, int kUnroll>
__global__ void __launch_bounds__(kThreads)
batch_norm_act_kernel(const V* __restrict__ x,  // [planes, plane]
                      const V* __restrict__ r,  // [planes, plane], or null in form 0
                      V* __restrict__ out,      // [planes, plane]
                      Norm na, Norm nb, int channels, int plane, int segments, long long items) {
  constexpr int kSegment = 32 * kUnroll;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (item >= items) return;
  const long long p = item / segments;  // the (n, c) plane
  const int first = static_cast<int>(item - p * segments) * kSegment + threadIdx.x % 32;
  const size_t base = static_cast<size_t>(p) * plane;

  V xv[kUnroll], rv[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int i = first + 32 * j;
    if (i < plane) {
      xv[j] = __ldg(x + base + i);
      if constexpr (kForm != 0) rv[j] = __ldg(r + base + i);
    }
  }
  const int c = static_cast<int>(p % channels);
  const Terms a = load_terms(na, c);
  const Terms b = kForm == 2 ? load_terms(nb, c) : a;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int i = first + 32 * j;
    if (i < plane) out[base + i] = tail<kForm>(xv[j], kForm != 0 ? rv[j] : xv[j], a, b);
  }
}

template <int kForm, typename V, int kUnroll>
int launch(const void* x, const void* r, void* out, const Norm& na, const Norm& nb, int batch, int channels,
           int plane, cudaStream_t stream) {
  const int segments = (plane + 32 * kUnroll - 1) / (32 * kUnroll);
  const long long items = static_cast<long long>(batch) * channels * segments;
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  batch_norm_act_kernel<kForm, V, kUnroll><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<const V*>(r), static_cast<V*>(out), na, nb, channels, plane, segments,
      items);
  return static_cast<int>(cudaGetLastError());
}

template <int kForm, typename V>
int launch_unrolled(const void* x, const void* r, void* out, const Norm& na, const Norm& nb, int batch,
                    int channels, int plane, cudaStream_t stream) {
  if (plane >= 96) return launch<kForm, V, 4>(x, r, out, na, nb, batch, channels, plane, stream);
  return launch<kForm, V, 2>(x, r, out, na, nb, batch, channels, plane, stream);
}

template <int kForm>
int launch_form(const void* x, const void* r, void* out, const Norm& na, const Norm& nb, int batch, int channels,
                int hw, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (hw % 4 == 0 && aligned(x) && aligned(r) && aligned(out)) {
    return launch_unrolled<kForm, float4>(x, r, out, na, nb, batch, channels, hw / 4, stream);
  }
  return launch_unrolled<kForm, float>(x, r, out, na, nb, batch, channels, hw, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = success).
// `form` is 0 (relu), 1 (add_relu) or 2 (bn_add_relu).  `x`, `r` and `out` are
// contiguous float32 [batch, channels, hw] (`r` null in form 0); the first
// BatchNorm's running mean, running variance, weight and bias are float32
// [channels] and `eps` its epsilon; the second's (form 2 only, else null) the
// same for `r`.
extern "C" int batch_norm_act_forward(int form, const void* x, const void* r, void* out, const void* mean,
                                      const void* var, const void* weight, const void* bias, float eps,
                                      const void* mean2, const void* var2, const void* weight2, const void* bias2,
                                      float eps2, int batch, int channels, int hw, void* stream) {
  const Norm na{static_cast<const float*>(mean), static_cast<const float*>(var), static_cast<const float*>(weight),
                static_cast<const float*>(bias), eps};
  const Norm nb{static_cast<const float*>(mean2), static_cast<const float*>(var2),
                static_cast<const float*>(weight2), static_cast<const float*>(bias2), eps2};
  const bool first = mean && var && weight && bias && x && out;
  const bool second = mean2 && var2 && weight2 && bias2;
  if (batch <= 0 || channels <= 0 || hw <= 0 || !first || (form != 0) != (r != nullptr) || (form == 2) != second ||
      form < 0 || form > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (form == 0) return launch_form<0>(x, r, out, na, nb, batch, channels, hw, s);
  if (form == 1) return launch_form<1>(x, r, out, na, nb, batch, channels, hw, s);
  return launch_form<2>(x, r, out, na, nb, batch, channels, hw, s);
}

extern "C" const char* batch_norm_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
