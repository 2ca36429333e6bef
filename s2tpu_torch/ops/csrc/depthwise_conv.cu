// Stride-1 SAME depthwise convolution, forward, for Hopper (sm_90a).
//
//   out[b,y,x,c] = sum_{dy,dx} w[dy,dx,c] * x_pad[b, y+dy, x+dx, c]
//
// x and out are (B, H, W, C) NHWC contiguous, w is (k, k, C). SAME padding is
// lo = (k-1)/2 before and hi = k/2 after each spatial axis; the padding is
// never materialised: taps that fall outside the image are skipped. f32 or
// bf16 in, f32 accumulation, the input dtype out.
//
// Replaces the TPU kernel s2tpu/ops/depthwise_conv.py::_fwd_kernel (launched
// from _forward). That kernel streams 128-lane channel tiles of VMEM row
// tiles through double-buffered halo DMAs; none of that carries over. What
// carries over is the arithmetic: the same k*k shifted multiply-adds per
// channel, in the same order (dy-major, dx ascending), accumulated in f32.
//
// Bound: bytes. In bf16 a k x k layer does 2k^2 FLOPs per output element
// against 4 bytes moved (one read, one write): 4.5 FLOP/byte at k=3 and
// 12.5 at k=5, far below the H100's ~295 FLOP/byte balance point. The least
// time is (x bytes + out bytes + w bytes) / 3.35 TB/s. The design therefore
// only aims at moving each byte once, coalesced:
//   * neighbouring threads own neighbouring channel groups of the same
//     pixels, so every warp load is a contiguous run of NHWC memory for any C
//     (no padding of C to a tile width);
//   * bf16 (and f32) channels are loaded in pairs where C is even;
//   * each thread computes RX consecutive outputs along W, so a row of
//     RX + k - 1 inputs feeds RX * k taps from registers;
//   * a block reads its channel tile's k*k weights into shared memory once.
// Multiplies and adds are issued separately (__fmul_rn / __fadd_rn), never
// contracted into FMAs, so the kernel rounds exactly as the plain PyTorch
// version (depthwise_conv2d_s1_reference) does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroupsPerBlock = 32;

template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

template <>
struct Pack<float, 2> {
  __device__ static void load(const float* p, float* v) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, const float* v) { *p = __float2bfloat16_rn(v[0]); }
};

template <>
struct Pack<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One thread: VEC channels x RX consecutive outputs of one row. A block:
// `groups` channel groups (blockIdx.y picks the channel tile) x
// blockDim.x / groups row runs, striding over all B*H*ceil(W/RX) runs.
// K > 0 fixes the kernel size at compile time (loops unroll, the row window
// lives in registers); K == 0 reads it from k_rt (RX is then 1).
template <typename T, int VEC, int K, int RX>
__global__ void __launch_bounds__(kThreads) depthwise_s1_fwd(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int H, int W, int C, int k_rt, int groups, long long n_runs) {
  const int k = K > 0 ? K : k_rt;
  const int lo = (k - 1) / 2;
  const int tile_c = groups * VEC;
  const int c_base = blockIdx.y * tile_c;

  extern __shared__ float w_s[];  // [k*k][tile_c]
  for (int i = threadIdx.x; i < k * k * tile_c; i += blockDim.x) {
    const int tap = i / tile_c;
    const int c = c_base + (i - tap * tile_c);
    w_s[i] = c < C ? to_float(w[(long long)tap * C + c]) : 0.0f;
  }
  __syncthreads();

  const int g_local = threadIdx.x % groups;
  const int c = c_base + g_local * VEC;
  if (c >= C) return;
  const int runs_per_block = blockDim.x / groups;
  const int n_xr = (W + RX - 1) / RX;
  const float* wt = w_s + g_local * VEC;

  for (long long run = (long long)blockIdx.x * runs_per_block + threadIdx.x / groups; run < n_runs;
       run += (long long)gridDim.x * runs_per_block) {
    const int x0 = (int)(run % n_xr) * RX;
    const long long by = run / n_xr;  // b * H + y
    const int y = (int)(by % H);

    float acc[RX][VEC];
#pragma unroll
    for (int o = 0; o < RX; ++o)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[o][e] = 0.0f;

#pragma unroll
    for (int dy = 0; dy < k; ++dy) {
      const int iy = y + dy - lo;
      if (iy < 0 || iy >= H) continue;
      const T* row = x + ((by - y + iy) * W) * (long long)C + c;
#pragma unroll
      for (int j = 0; j < RX + k - 1; ++j) {
        const int ix = x0 + j - lo;
        if (ix < 0 || ix >= W) continue;
        float v[VEC];
        Pack<T, VEC>::load(row + (long long)ix * C, v);
#pragma unroll
        for (int dx = 0; dx < k; ++dx) {
#pragma unroll
          for (int o = 0; o < RX; ++o) {
            if (j - dx != o) continue;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[o][e] = __fadd_rn(acc[o][e], __fmul_rn(v[e], wt[(dy * k + dx) * tile_c + e]));
          }
        }
      }
    }

    T* dst = out + (by * W + x0) * (long long)C + c;
#pragma unroll
    for (int o = 0; o < RX; ++o)
      if (x0 + o < W) Pack<T, VEC>::store(dst + (long long)o * C, acc[o]);
  }
}

template <typename T, int VEC, int K, int RX>
cudaError_t launch(const void* x, const void* w, void* out, int B, int H, int W, int C, int k,
                   cudaStream_t stream) {
  const int n_groups = C / VEC;
  const int groups = n_groups < kMaxGroupsPerBlock ? n_groups : kMaxGroupsPerBlock;
  const int runs_per_block = kThreads / groups;
  const long long n_runs = (long long)B * H * ((W + RX - 1) / RX);
  long long grid_x = (n_runs + runs_per_block - 1) / runs_per_block;
  if (grid_x > 0x7fffffffLL) grid_x = 0x7fffffffLL;  // the run loop strides over the rest
  const dim3 grid((unsigned)grid_x, (unsigned)((n_groups + groups - 1) / groups));
  const size_t smem = (size_t)k * k * groups * VEC * sizeof(float);
  depthwise_s1_fwd<T, VEC, K, RX><<<grid, runs_per_block * groups, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), H, W, C, k, groups,
      n_runs);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_k(const void* x, const void* w, void* out, int B, int H, int W, int C, int k,
                       cudaStream_t s) {
  switch (k) {
    case 1: return launch<T, VEC, 1, 4>(x, w, out, B, H, W, C, k, s);
    case 2: return launch<T, VEC, 2, 4>(x, w, out, B, H, W, C, k, s);
    case 3: return launch<T, VEC, 3, 4>(x, w, out, B, H, W, C, k, s);
    case 4: return launch<T, VEC, 4, 4>(x, w, out, B, H, W, C, k, s);
    case 5: return launch<T, VEC, 5, 4>(x, w, out, B, H, W, C, k, s);
    case 6: return launch<T, VEC, 6, 4>(x, w, out, B, H, W, C, k, s);
    case 7: return launch<T, VEC, 7, 4>(x, w, out, B, H, W, C, k, s);
    default: return launch<T, VEC, 0, 1>(x, w, out, B, H, W, C, k, s);
  }
}

template <typename T>
cudaError_t dispatch_vec(const void* x, const void* w, void* out, int B, int H, int W, int C, int k,
                         cudaStream_t s) {
  if (C % 2 == 0) return dispatch_k<T, 2>(x, w, out, B, H, W, C, k, s);
  return dispatch_k<T, 1>(x, w, out, B, H, W, C, k, s);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success). The caller validates shapes and allocates `out`.
extern "C" int s2_depthwise_conv2d_s1_fwd(const void* x, const void* w, void* out, int B, int H,
                                          int W, int C, int k, int dtype, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_vec<float>(x, w, out, B, H, W, C, k, s);
  if (dtype == 1) return (int)dispatch_vec<__nv_bfloat16>(x, w, out, B, H, W, C, k, s);
  return (int)cudaErrorInvalidValue;
}
