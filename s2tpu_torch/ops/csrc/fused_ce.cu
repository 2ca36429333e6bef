// Fused per-pixel cross-entropy / focal loss, forward and backward, for
// Hopper (sm_90a).
//
// Per pixel i with logits l[i, 0..K) (f32, row-major (N, K)), label y[i]
// (int32), class weights cw[K] (f32):
//   lse = max_k l + log(sum_k exp(l_k - max)),  ce = lse - l_y,  w = cw[y]
//   valid = (y != ignore_index), or true without an ignore index
//   CE:    loss = valid ? ce * w : 0,                  weight = valid ? w : 0
//   focal: ce_v = valid ? ce : 0, pt = exp(-ce_v),
//          loss = w * (1 - pt)^gamma * ce_v,           weight = valid ? 1 : 0
// Backward, with the per-pixel upstream cotangent g[i]:
//   dlogits[i, k] = g[i] * scale * (softmax_k - onehot_k)
//   CE:    scale = valid ? w : 0
//   focal: scale = valid ? w * ((1-pt)^gamma + gamma (1-pt)^(gamma-1) pt ce) : 0
// A label outside [0, K) has an all-zero one-hot row, so l_y = 0 and w = 0.
// The mask is a select, not a product: the JAX kernels multiply by a 0/1
// mask, which XLA rewrites into a select, so an ignored pixel's NaN (the
// (1-pt)^(gamma-1) factor at pt = 1 when gamma < 1) never reaches its
// gradient there either.
//
// Replaces the TPU kernels s2tpu/ops/fused_ce.py::_fwd_kernel (launched from
// fused_ce_per_pixel) and ::_bwd_kernel (launched from _vjp_bwd). Those
// kernels transpose the logits to (K, N) so that pixels fill the TPU's
// 128-wide lanes; that transpose is not ported. Here the NHWC logits already
// give each thread its pixel's K contiguous values, loaded as 16-byte
// vectors where K allows (one load at K = 4), kept in registers, and looped
// over K. Rows past N are masked by the bounds check; nothing is padded.
//
// Bound: bytes. Per pixel the forward reads 4K + 4 bytes and writes 8, the
// backward reads 4K + 8 and writes 4K, against ~10K flops and K + 2
// transcendentals: far below the H100's balance point. The least time is
// those bytes over 3.35 TB/s (at N = 1,605,632 and K = 4: 0.0134 ms forward,
// 0.0192 ms backward). The design reads each byte once, coalesced, with one
// pixel per thread and many blocks in flight.
//
// Numerics: the same formula in the same order as the plain PyTorch version
// (s2tpu_torch/ops/fused_ce.py), in f32 with expf/logf/powf; they agree to
// a few f32 ulps, not bit for bit (the transcendentals differ by an ulp or
// two between CUDA's libdevice and PyTorch's implementations).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

template <int VEC>
__device__ inline void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ inline void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The shared forward pieces of one pixel: its K logits in registers (KMAX
// slots, the first K used; every index is a compile-time constant after
// unrolling), the log-sum-exp, the label logit and the class weight.
template <int KMAX, int VEC>
struct Pixel {
  float v[KMAX];
  float lse;
  float picked;
  float w;

  __device__ Pixel(const float* __restrict__ row, int K, int y, const float* __restrict__ cw) {
#pragma unroll
    for (int j = 0; j < KMAX; j += VEC)
      if (j < K) load_vec<VEC>(row + j, v + j);
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) m = fmaxf(m, v[j]);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) s += expf(v[j] - m);
    lse = m + logf(s);
    picked = 0.0f;
    w = 0.0f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K && j == y) {
        picked = v[j];
        w = cw[j];
      }
  }
};

template <int KMAX, int VEC>
__global__ void __launch_bounds__(kThreads) fused_ce_fwd(
    const float* __restrict__ logits, const int* __restrict__ labels, const float* __restrict__ cw,
    float* __restrict__ loss, float* __restrict__ weight, long long n, int K, int has_ignore,
    int ignore_index, int focal, float gamma) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int y = labels[i];
    const Pixel<KMAX, VEC> px(logits + i * K, K, y, cw);
    const float ce = px.lse - px.picked;
    const bool valid = !(has_ignore && y == ignore_index);
    if (focal) {
      const float ce_v = valid ? ce : 0.0f;
      const float pt = expf(-ce_v);
      loss[i] = px.w * powf(1.0f - pt, gamma) * ce_v;
      weight[i] = valid ? 1.0f : 0.0f;
    } else {
      loss[i] = valid ? ce * px.w : 0.0f;
      weight[i] = valid ? px.w : 0.0f;
    }
  }
}

template <int KMAX, int VEC>
__global__ void __launch_bounds__(kThreads) fused_ce_bwd(
    const float* __restrict__ logits, const int* __restrict__ labels, const float* __restrict__ cw,
    const float* __restrict__ g, float* __restrict__ dlogits, long long n, int K, int has_ignore,
    int ignore_index, int focal, float gamma) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int y = labels[i];
    Pixel<KMAX, VEC> px(logits + i * K, K, y, cw);
    const bool valid = !(has_ignore && y == ignore_index);
    float scale = 0.0f;
    if (valid && focal) {
      const float ce = px.lse - px.picked;
      const float pt = expf(-ce);
      const float one_minus = 1.0f - pt;
      scale = px.w * (powf(one_minus, gamma) + gamma * powf(one_minus, gamma - 1.0f) * pt * ce);
    } else if (valid) {
      scale = px.w;
    }
    const float gs = g[i] * scale;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) px.v[j] = gs * (expf(px.v[j] - px.lse) - (j == y ? 1.0f : 0.0f));
    float* row = dlogits + i * K;
#pragma unroll
    for (int j = 0; j < KMAX; j += VEC)
      if (j < K) store_vec<VEC>(row + j, px.v + j);
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);  // the loop strides over the rest
}

template <int KMAX, int VEC>
cudaError_t launch(bool backward, const void* logits, const void* labels, const void* cw,
                   const void* g, void* out0, void* out1, long long n, int K, int has_ignore,
                   int ignore_index, int focal, float gamma, cudaStream_t s) {
  const int grid = grid_for(n);
  if (backward) {
    fused_ce_bwd<KMAX, VEC><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<const int*>(labels),
        static_cast<const float*>(cw), static_cast<const float*>(g), static_cast<float*>(out0), n,
        K, has_ignore, ignore_index, focal, gamma);
  } else {
    fused_ce_fwd<KMAX, VEC><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<const int*>(labels),
        static_cast<const float*>(cw), static_cast<float*>(out0), static_cast<float*>(out1), n, K,
        has_ignore, ignore_index, focal, gamma);
  }
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t dispatch_vec(bool backward, const void* logits, const void* labels, const void* cw,
                         const void* g, void* out0, void* out1, long long n, int K,
                         int has_ignore, int ignore_index, int focal, float gamma,
                         cudaStream_t s) {
  // Every row starts VEC-aligned when the base does and K is a multiple of VEC.
  const auto aligned = [&](size_t bytes) {
    return reinterpret_cast<size_t>(logits) % bytes == 0 &&
           (!backward || reinterpret_cast<size_t>(out0) % bytes == 0);
  };
  if (K % 4 == 0 && aligned(16))
    return launch<KMAX, 4>(backward, logits, labels, cw, g, out0, out1, n, K, has_ignore,
                           ignore_index, focal, gamma, s);
  if (K % 2 == 0 && aligned(8))
    return launch<KMAX, 2>(backward, logits, labels, cw, g, out0, out1, n, K, has_ignore,
                           ignore_index, focal, gamma, s);
  return launch<KMAX, 1>(backward, logits, labels, cw, g, out0, out1, n, K, has_ignore,
                         ignore_index, focal, gamma, s);
}

int run(bool backward, const void* logits, const void* labels, const void* cw, const void* g,
        void* out0, void* out1, long long n, int K, int has_ignore, int ignore_index, int focal,
        float gamma, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K >= 1 && K <= 4)
    return (int)dispatch_vec<4>(backward, logits, labels, cw, g, out0, out1, n, K, has_ignore,
                                ignore_index, focal, gamma, s);
  if (K <= 8)
    return (int)dispatch_vec<8>(backward, logits, labels, cw, g, out0, out1, n, K, has_ignore,
                                ignore_index, focal, gamma, s);
  if (K <= 16)
    return (int)dispatch_vec<16>(backward, logits, labels, cw, g, out0, out1, n, K, has_ignore,
                                 ignore_index, focal, gamma, s);
  if (K <= 32)
    return (int)dispatch_vec<32>(backward, logits, labels, cw, g, out0, out1, n, K, has_ignore,
                                 ignore_index, focal, gamma, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes. logits (N, K) f32 row-major,
// labels (N,) int32, cw (K,) f32; K in [1, 32]. The forward writes loss and
// weight (N,) f32; the backward reads g (N,) f32 and writes dlogits (N, K)
// f32. Each launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). The caller validates shapes and
// allocates the outputs.
extern "C" int s2_fused_ce_fwd(const void* logits, const void* labels, const void* cw, void* loss,
                               void* weight, long long n, int K, int has_ignore, int ignore_index,
                               int focal, float gamma, int device, void* stream) {
  return run(false, logits, labels, cw, nullptr, loss, weight, n, K, has_ignore, ignore_index,
             focal, gamma, device, stream);
}

extern "C" int s2_fused_ce_bwd(const void* logits, const void* labels, const void* cw,
                               const void* g, void* dlogits, long long n, int K, int has_ignore,
                               int ignore_index, int focal, float gamma, int device,
                               void* stream) {
  return run(true, logits, labels, cw, g, dlogits, nullptr, n, K, has_ignore, ignore_index, focal,
             gamma, device, stream);
}
