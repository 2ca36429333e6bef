// Train-mode BatchNorm with its activation, for Hopper (sm_90a): five
// passes over a channels-last activation (N, H, W, C), read as M = N*H*W
// rows of C channels, C innermost.
//
//   stats     per channel f32 S = sum x and Q = sum x^2 over the M rows
//   finalize  per channel mean = S / n, var = max(Q / n - mean^2, 0) (flax),
//             invstd = rsqrt(var + eps), and, when asked, the running
//             statistics decay * running + (1 - decay) * batch (biased
//             variance) and num_batches_tracked + 1, in the same launch
//   apply     y = act(round_T((x - mean) * (invstd * gamma) + beta))
//   bwd sums  z recomputed as in apply, dz = round_T(dy * act'(z)),
//             xhat = (x - mean) * invstd; per channel f32 sum dz (= dbeta)
//             and sum dz * xhat (= dgamma)
//   bwd dx    dx = round_T(invstd * gamma * (dz - A / n - w * xhat * B / n))
//             with A, B the sums (over every rank of a data axis) and w = 0
//             where the variance's clamp bound in the forward, else 1
//
// n is the count of the statistics (M times the data axis's ranks); T is
// the activation's dtype (bf16 or f32) and round_T its rounding. act is
// none, SiLU or ReLU, each computed on the rounded z, as the model's plain
// path applies torch's activation to the bf16 output of its f32 affine.
//
// These kernels replace no TPU kernel: the JAX package leaves BatchNorm to
// XLA, which fuses it. On the card the plain path is some twenty PyTorch
// passes a layer, in f32, with f32 copies saved for the backward. Here the
// work is bound by bytes (a few flops an element): forward 2 B (stats) + 4 B
// (apply) and backward 4 B (sums) + 6 B (dx) an element in bf16, and no
// saved copy but x itself.
//
// Layout of the work: a block owns a tile of Ct channel vectors (V <= 4
// channels each: 8-byte loads of bf16, 16-byte loads of f32, where C and the
// addresses allow; the wrapper picks V) and R = blockDim.x / Ct row lanes; thread (r0, lc) keeps channel vector
// blockIdx.y * Ct + lc for good and walks rows r0, r0 + R, ... of its
// block's share (rows are dealt to the gridDim.x blocks of a tile in turn),
// so its per-channel constants and sums stay in registers, and each
// iteration of a block reads R whole rows of its tile. The two reductions
// (stats, bwd sums) add a thread's rows in order, the block's R lanes in a
// fixed tree in shared memory, then write one partial per block; the last
// block of a tile to finish (a ticket counter, no atomics on values) adds
// the tile's partials in block order and writes the sums. So the sums are
// the same bits on every run and in a CUDA graph, whatever the order in
// which the blocks ran. Every launch goes on the caller's stream; nothing
// here synchronises or allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// A block has at most kMaxThreads threads, and kMinBlocks of them fit an SM
// (at most 64 registers a thread): the wrapper's plan assumes both. Wider
// vectors (8 bf16 channels) took over 100 registers a thread in the
// backward passes and ran slower at every B5 shape on the H100.
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;
constexpr int kMaxVec = 4;

enum Act { kNone = 0, kSilu = 1, kRelu = 2 };

// The machine word of a vector of BYTES bytes, as one load or store.
template <int BYTES>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = uint32_t;
};
template <>
struct Word<2> {
  using type = uint16_t;
};

__device__ __forceinline__ uint32_t part(const uint4& w, int j) { return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w; }
__device__ __forceinline__ uint32_t part(const uint2& w, int j) { return j == 0 ? w.x : w.y; }
__device__ __forceinline__ uint32_t part(uint32_t w, int) { return w; }
__device__ __forceinline__ void set_part(uint4& w, int j, uint32_t v) {
  if (j == 0) w.x = v; else if (j == 1) w.y = v; else if (j == 2) w.z = v; else w.w = v;
}
__device__ __forceinline__ void set_part(uint2& w, int j, uint32_t v) {
  if (j == 0) w.x = v; else w.y = v;
}
__device__ __forceinline__ void set_part(uint32_t& w, int, uint32_t v) { w = v; }

__device__ __forceinline__ uint32_t bf16_bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }

// V consecutive channels of T at p, as f32 (load) or rounded to nearest
// even from f32 (store); p is aligned to V * sizeof(T).
template <typename T, int V>
struct Vec;

template <int V>
struct Vec<float, V> {
  using W = typename Word<4 * V>::type;
  __device__ static void load(const float* p, float* v) {
    const W w = *reinterpret_cast<const W*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __uint_as_float(part(w, i));
  }
  __device__ static void store(float* p, const float* v) {
    W w;
#pragma unroll
    for (int i = 0; i < V; ++i) set_part(w, i, __float_as_uint(v[i]));
    *reinterpret_cast<W*>(p) = w;
  }
};

template <int V>
struct Vec<__nv_bfloat16, V> {
  using W = typename Word<2 * V>::type;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const W w = *reinterpret_cast<const W*>(p);
    if constexpr (V == 1) {
      v[0] = __uint_as_float(static_cast<uint32_t>(w) << 16);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const uint32_t b = part(w, i / 2);
        v[i] = __uint_as_float(i % 2 ? (b & 0xffff0000u) : (b << 16));
      }
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    W w;
    if constexpr (V == 1) {
      w = static_cast<uint16_t>(bf16_bits(v[0]));
    } else {
#pragma unroll
      for (int j = 0; j < V / 2; ++j) set_part(w, j, bf16_bits(v[2 * j]) | (bf16_bits(v[2 * j + 1]) << 16));
    }
    *reinterpret_cast<W*>(p) = w;
  }
};

// f32 rounded to T and back.
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) { return __bfloat162float(__float2bfloat16_rn(v)); }
template <typename T>
__device__ __forceinline__ float round_t(float v) { return round_to(v, static_cast<T*>(nullptr)); }

// V f32 values of a partial row at p (aligned to 4 * min(V, 4) bytes),
// read through L2: other blocks wrote them.
template <int V>
__device__ __forceinline__ void load_partial(const float* p, float* v) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p + j));
      v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
    }
  } else if constexpr (V == 2) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldcg(p);
  }
}

// The affine part, each step rounded as PyTorch's separate f32 passes round
// it (no contraction): (x - mean) * mul + beta, mul = invstd * gamma.
__device__ __forceinline__ float affine(float x, float mean, float mul, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), beta);
}

template <int ACT>
__device__ __forceinline__ float activate(float z) {
  if constexpr (ACT == kSilu) return __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
  if constexpr (ACT == kRelu) return z < 0.0f ? 0.0f : z;
  return z;
}

// dy * act'(z), as torch's activation backward computes it in f32 before
// its rounding to T (SiLU: dy * s * (1 + z (1 - s)), s = sigmoid(z)).
template <int ACT>
__device__ __forceinline__ float activate_grad(float z, float dy) {
  if constexpr (ACT == kSilu) {
    const float s = __frcp_rn(__fadd_rn(1.0f, expf(-z)));  // 1 / (1 + e), correctly rounded as a division
    return __fmul_rn(__fmul_rn(dy, s), __fadd_rn(1.0f, __fmul_rn(z, __fsub_rn(1.0f, s))));
  }
  if constexpr (ACT == kRelu) return z > 0.0f ? dy : 0.0f;
  return dy;
}

// This thread's place: channel vector cv of the row (channels cv * V ...),
// row lane r0 of R, and whether cv lies inside C.
struct Lane {
  int lc, r0, R, cv;
  bool active;
};

__device__ __forceinline__ Lane lane_of(int Cv, int Ct) {
  Lane l;
  l.lc = threadIdx.x % Ct;
  l.r0 = threadIdx.x / Ct;
  l.R = blockDim.x / Ct;
  l.cv = blockIdx.y * Ct + l.lc;
  l.active = l.r0 < l.R && l.cv < Cv;
  return l;
}

// a[0..V) and b[0..V) summed over the R row lanes of each channel vector of
// the block, in a fixed tree: lane r0 < n - h adds lane r0 + h (h = ceil(n /
// 2)), until one lane is left. On return red[0 .. Ct*V) holds the a sums and
// red[R*Ct*V ..) the b sums of the tile's channels, in channel order. Every
// thread of the block calls it.
template <int V>
__device__ void block_sum(float* red, const float* a, const float* b, const Lane& l, int Ct) {
  const int span = l.R * Ct * V;
  const int idx = (l.r0 * Ct + l.lc) * V;
  if (l.r0 < l.R) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[idx + i] = a[i];
      red[span + idx + i] = b[i];
    }
  }
  __syncthreads();
  for (int n = l.R; n > 1;) {
    const int h = (n + 1) / 2;
    if (l.r0 < n - h) {
      const int other = idx + h * Ct * V;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[idx + i] += red[other + i];
        red[span + idx + i] += red[span + other + i];
      }
    }
    n = h;
    __syncthreads();
  }
}

// The end of both reductions: the block's sums (red, after block_sum) as
// partial row blockIdx.x ([gridDim.x][2][C]); then the tile's last block
// adds the tile's partials in block order into sums ([2][C]) and leaves its
// ticket at zero for the next launch.
template <int V>
__device__ void finish_sums(float* red, float* __restrict__ partial, float* __restrict__ sums,
                            unsigned int* __restrict__ tickets, const Lane& l, int C, int Ct) {
  __shared__ bool last;
  const int span = l.R * Ct * V, c_base = blockIdx.y * Ct * V;
  float* row = partial + (size_t)blockIdx.x * 2 * C;
  for (int j = threadIdx.x; j < Ct * V; j += blockDim.x) {
    if (c_base + j < C) {
      row[c_base + j] = red[j];
      row[C + c_base + j] = red[span + j];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[blockIdx.y], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = b[i] = 0.0f;
  if (l.active) {
    const int c0 = l.cv * V;
#pragma unroll 4
    for (int p = l.r0; p < (int)gridDim.x; p += l.R) {
      float pa[V], pb[V];
      load_partial<V>(partial + (size_t)p * 2 * C + c0, pa);
      load_partial<V>(partial + (size_t)p * 2 * C + C + c0, pb);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a[i] += pa[i];
        b[i] += pb[i];
      }
    }
  }
  block_sum<V>(red, a, b, l, Ct);
  for (int j = threadIdx.x; j < Ct * V; j += blockDim.x) {
    if (c_base + j < C) {
      sums[c_base + j] = red[j];
      sums[C + c_base + j] = red[span + j];
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0u;
}

constexpr int kStatsUnroll = 4;
constexpr int kUnroll = 2;

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) batchnorm_act_stats(
    const T* __restrict__ x, float* __restrict__ partial, float* __restrict__ sums,
    unsigned int* __restrict__ tickets, long long M, int C, int Ct) {
  __shared__ float red[2 * kMaxThreads * kMaxVec];
  const Lane l = lane_of(C / V, Ct);
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
  if (l.active) {
    const long long step = (long long)gridDim.x * l.R;
    const T* base = x + (size_t)l.cv * V;
    for (long long r = (long long)blockIdx.x * l.R + l.r0; r < M; r += kStatsUnroll * step) {
      float v[kStatsUnroll][V];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        const long long ru = r + u * step;
        if (ru < M) {
          Vec<T, V>::load(base + ru * C, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += v[u][i];
          q[i] = fmaf(v[u][i], v[u][i], q[i]);
        }
      }
    }
  }
  block_sum<V>(red, s, q, l, Ct);
  finish_sums<V>(red, partial, sums, tickets, l, C, Ct);
}

__global__ void batchnorm_act_finalize(const float* __restrict__ sums, float* __restrict__ saved,
                                       float* __restrict__ running_mean, float* __restrict__ running_var,
                                       long long* __restrict__ num_batches, int C, float count, float eps,
                                       float decay, float one_minus_decay, int update) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (update && num_batches != nullptr && c == 0) *num_batches += 1;
  if (c >= C) return;
  const float mean = __fdiv_rn(sums[c], count);
  const float ex2 = __fdiv_rn(sums[C + c], count);
  const float raw = __fsub_rn(ex2, __fmul_rn(mean, mean));
  const float var = raw < 0.0f ? 0.0f : raw;  // NaN stays NaN, as clamp_min keeps it
  saved[c] = mean;
  saved[C + c] = rsqrtf(__fadd_rn(var, eps));
  saved[2 * C + c] = raw >= 0.0f ? 1.0f : 0.0f;  // clamp_min's gradient mask
  if (update) {
    running_mean[c] = __fadd_rn(__fmul_rn(decay, running_mean[c]), __fmul_rn(one_minus_decay, mean));
    running_var[c] = __fadd_rn(__fmul_rn(decay, running_var[c]), __fmul_rn(one_minus_decay, var));
  }
}

// The per-channel constants of the affine for this thread's V channels.
template <int V>
__device__ __forceinline__ void channel_constants(const float* __restrict__ saved, const float* __restrict__ gamma,
                                                  const float* __restrict__ beta, int C, int c0, float* mean,
                                                  float* invstd, float* mul, float* b) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mean[i] = saved[c0 + i];
    invstd[i] = saved[C + c0 + i];
    mul[i] = __fmul_rn(invstd[i], gamma[c0 + i]);
    b[i] = beta[c0 + i];
  }
}

template <typename T, int V, int ACT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) batchnorm_act_apply(
    const T* __restrict__ x, const float* __restrict__ saved, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ y, long long M, int C, int Ct) {
  const Lane l = lane_of(C / V, Ct);
  if (!l.active) return;
  const int c0 = l.cv * V;
  float mean[V], invstd[V], mul[V], b[V];
  channel_constants<V>(saved, gamma, beta, C, c0, mean, invstd, mul, b);
  const long long step = (long long)gridDim.x * l.R;
  for (long long r = (long long)blockIdx.x * l.R + l.r0; r < M; r += kUnroll * step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * step < M) Vec<T, V>::load(x + (r + u * step) * C + c0, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step >= M) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) v[u][i] = activate<ACT>(round_t<T>(affine(v[u][i], mean[i], mul[i], b[i])));
      Vec<T, V>::store(y + (r + u * step) * C + c0, v[u]);
    }
  }
}

// dz = round_T(dy * act'(z)) and xhat of one element.
template <typename T, int ACT>
__device__ __forceinline__ void grad_parts(float xv, float dyv, float mean, float invstd, float mul, float b,
                                           float* dz, float* xhat) {
  const float z = round_t<T>(affine(xv, mean, mul, b));
  *dz = ACT == kNone ? dyv : round_t<T>(activate_grad<ACT>(z, dyv));
  *xhat = __fmul_rn(__fsub_rn(xv, mean), invstd);
}

template <typename T, int V, int ACT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) batchnorm_act_backward_sums(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ saved,
    const float* __restrict__ gamma, const float* __restrict__ beta, float* __restrict__ partial,
    float* __restrict__ sums, unsigned int* __restrict__ tickets, long long M, int C, int Ct) {
  __shared__ float red[2 * kMaxThreads * kMaxVec];
  const Lane l = lane_of(C / V, Ct);
  float sa[V], sb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sa[i] = sb[i] = 0.0f;
  if (l.active) {
    const int c0 = l.cv * V;
    float mean[V], invstd[V], mul[V], b[V];
    channel_constants<V>(saved, gamma, beta, C, c0, mean, invstd, mul, b);
    const long long step = (long long)gridDim.x * l.R;
    for (long long r = (long long)blockIdx.x * l.R + l.r0; r < M; r += kUnroll * step) {
      float xv[kUnroll][V], gv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * step < M) {
          Vec<T, V>::load(x + (r + u * step) * C + c0, xv[u]);
          Vec<T, V>::load(dy + (r + u * step) * C + c0, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * step >= M) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float dz, xhat;
          grad_parts<T, ACT>(xv[u][i], gv[u][i], mean[i], invstd[i], mul[i], b[i], &dz, &xhat);
          sa[i] += dz;
          sb[i] = fmaf(dz, xhat, sb[i]);
        }
      }
    }
  }
  block_sum<V>(red, sa, sb, l, Ct);
  finish_sums<V>(red, partial, sums, tickets, l, C, Ct);
}

template <typename T, int V, int ACT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) batchnorm_act_backward_dx(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ saved,
    const float* __restrict__ gamma, const float* __restrict__ beta, const float* __restrict__ gsums,
    T* __restrict__ dx, long long M, int C, int Ct, float count) {
  const Lane l = lane_of(C / V, Ct);
  if (!l.active) return;
  const int c0 = l.cv * V;
  float mean[V], invstd[V], mul[V], b[V], ga[V], gb[V];
  channel_constants<V>(saved, gamma, beta, C, c0, mean, invstd, mul, b);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ga[i] = __fdiv_rn(gsums[c0 + i], count);
    gb[i] = __fmul_rn(__fdiv_rn(gsums[C + c0 + i], count), saved[2 * C + c0 + i]);
  }
  const long long step = (long long)gridDim.x * l.R;
  for (long long r = (long long)blockIdx.x * l.R + l.r0; r < M; r += kUnroll * step) {
    float xv[kUnroll][V], gv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < M) {
        Vec<T, V>::load(x + (r + u * step) * C + c0, xv[u]);
        Vec<T, V>::load(dy + (r + u * step) * C + c0, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step >= M) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float dz, xhat;
        grad_parts<T, ACT>(xv[u][i], gv[u][i], mean[i], invstd[i], mul[i], b[i], &dz, &xhat);
        xv[u][i] = __fmul_rn(mul[i], __fsub_rn(__fsub_rn(dz, ga[i]), __fmul_rn(xhat, gb[i])));
      }
      Vec<T, V>::store(dx + (r + u * step) * C + c0, xv[u]);
    }
  }
}

template <typename T_, int V_>
struct Types {
  using T = T_;
  static constexpr int V = V_;
};

// f(Types<T, V>{}) for dtype (0 float32, 1 bfloat16) and a vector width of
// 1, 2 or 4; cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t with_types(int dtype, int V, F&& f) {
  if (dtype == 0) {
    switch (V) {
      case 1: return f(Types<float, 1>{});
      case 2: return f(Types<float, 2>{});
      case 4: return f(Types<float, 4>{});
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (V) {
      case 1: return f(Types<__nv_bfloat16, 1>{});
      case 2: return f(Types<__nv_bfloat16, 2>{});
      case 4: return f(Types<__nv_bfloat16, 4>{});
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t with_act(int act, F&& f) {
  switch (act) {
    case kNone: return f(std::integral_constant<int, kNone>{});
    case kSilu: return f(std::integral_constant<int, kSilu>{});
    case kRelu: return f(std::integral_constant<int, kRelu>{});
    default: return cudaErrorInvalidValue;
  }
}

// The grid of a row pass: nb blocks of R * Ct threads per channel tile;
// refuses a plan the kernels do not take.
cudaError_t grid_of(long long M, int C, int V, int Ct, int R, int nb, dim3* grid, dim3* block) {
  if (M < 1 || C < 1 || V < 1 || C % V != 0 || Ct < 1 || R < 1 || (long long)R * Ct > kMaxThreads || nb < 1)
    return cudaErrorInvalidValue;
  const long long tiles = (C / V + Ct - 1) / Ct;
  if (tiles > 65535 || (long long)nb * R > 0x7fffffffLL) return cudaErrorInvalidValue;
  *grid = dim3((unsigned)nb, (unsigned)tiles);
  *block = dim3((unsigned)(R * Ct));
  return cudaSuccess;
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 =
// bfloat16; act: 0 none, 1 SiLU, 2 ReLU. x, dy, y and dx are (M, C)
// row-major (a channels-last activation), aligned to V * sizeof(T) bytes
// with C % V == 0. The plan is the wrapper's: V channels a thread, tiles of
// Ct channel vectors, R row lanes (R * Ct <= 256 threads), nb blocks a
// tile. The reductions take f32 scratch `partial` of (nb, 2, C) and
// `tickets`, ceil(C / V / Ct) zeros that they leave at zero, and write the
// f32 (2, C) `sums`. `saved` is f32 (3, C): mean, invstd and the clamp's
// mask. Each launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).

extern "C" int s2_batchnorm_act_stats(const void* x, void* partial, void* sums, void* tickets, long long M, int C,
                                      int V, int Ct, int R, int nb, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid, block;
  if ((err = grid_of(M, C, V, Ct, R, nb, &grid, &block)) != cudaSuccess) return (int)err;
  return (int)with_types(dtype, V, [&](auto types) {
    using Ty = decltype(types);
    batchnorm_act_stats<typename Ty::T, Ty::V><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const typename Ty::T*>(x), static_cast<float*>(partial), static_cast<float*>(sums),
        static_cast<unsigned int*>(tickets), M, C, Ct);
    return cudaGetLastError();
  });
}

// `num_batches` (int64, one) may be null; with update 0 the running
// statistics and num_batches are left alone.
extern "C" int s2_batchnorm_act_finalize(const void* sums, void* saved, void* running_mean, void* running_var,
                                         void* num_batches, int C, float count, float eps, float decay,
                                         float one_minus_decay, int update, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || !(count > 0.0f)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  batchnorm_act_finalize<<<(C + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sums), static_cast<float*>(saved), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<long long*>(num_batches), C, count, eps, decay,
      one_minus_decay, update);
  return (int)cudaGetLastError();
}

extern "C" int s2_batchnorm_act_apply(const void* x, const void* saved, const void* gamma, const void* beta, void* y,
                                      long long M, int C, int V, int Ct, int R, int nb, int act, int dtype,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid, block;
  if ((err = grid_of(M, C, V, Ct, R, nb, &grid, &block)) != cudaSuccess) return (int)err;
  return (int)with_types(dtype, V, [&](auto types) {
    using Ty = decltype(types);
    using T = typename Ty::T;
    return with_act(act, [&](auto a) {
      batchnorm_act_apply<T, Ty::V, decltype(a)::value><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const float*>(saved), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), static_cast<T*>(y), M, C, Ct);
      return cudaGetLastError();
    });
  });
}

extern "C" int s2_batchnorm_act_backward_sums(const void* x, const void* dy, const void* saved, const void* gamma,
                                              const void* beta, void* partial, void* sums, void* tickets,
                                              long long M, int C, int V, int Ct, int R, int nb, int act,
                                              int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid, block;
  if ((err = grid_of(M, C, V, Ct, R, nb, &grid, &block)) != cudaSuccess) return (int)err;
  return (int)with_types(dtype, V, [&](auto types) {
    using Ty = decltype(types);
    using T = typename Ty::T;
    return with_act(act, [&](auto a) {
      batchnorm_act_backward_sums<T, Ty::V, decltype(a)::value>
          <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(saved),
              static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<float*>(partial),
              static_cast<float*>(sums), static_cast<unsigned int*>(tickets), M, C, Ct);
      return cudaGetLastError();
    });
  });
}

// `gsums` (2, C) are the backward sums over every rank; count is n.
extern "C" int s2_batchnorm_act_backward_dx(const void* x, const void* dy, const void* saved, const void* gamma,
                                            const void* beta, const void* gsums, void* dx, long long M, int C, int V,
                                            int Ct, int R, int nb, float count, int act, int dtype, int device,
                                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid, block;
  if ((err = grid_of(M, C, V, Ct, R, nb, &grid, &block)) != cudaSuccess) return (int)err;
  if (!(count > 0.0f)) return (int)cudaErrorInvalidValue;
  return (int)with_types(dtype, V, [&](auto types) {
    using Ty = decltype(types);
    using T = typename Ty::T;
    return with_act(act, [&](auto a) {
      batchnorm_act_backward_dx<T, Ty::V, decltype(a)::value>
          <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(saved),
              static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<const float*>(gsums),
              static_cast<T*>(dx), M, C, Ct, count);
      return cudaGetLastError();
    });
  });
}
