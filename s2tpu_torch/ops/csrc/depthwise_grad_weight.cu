// Stride-1 SAME depthwise convolution, filter gradient, for Hopper (sm_90a).
//
//   dw[dy,dx,c] = sum_{b,y,x} g[b,y,x,c] * x_pad[b, y+dy, x+dx, c]
//
// x and g are (B, H, W, C) NHWC contiguous, f32 or bf16. SAME padding is
// lo = (k-1)/2 before each spatial axis; taps that fall outside the image
// are skipped, never padded in memory. The kernel writes f32 partial sums
// (n_slices, k*k, C), one row per slice of B*H image rows; the caller sums
// them over slices (the JAX package also sums its per-image partials outside
// the kernel).
//
// Replaces the TPU kernel s2tpu/ops/depthwise_conv.py::_dw_kernel (launched
// from _grad_weight). That kernel carries its (k*k, 128) sum in VMEM across
// a sequential grid of row tiles, one grid cell per (image, channel tile).
// Hopper blocks run in parallel and in no order, so no block carries a sum
// to another: each block owns (a channel tile) x (a slice of B*H rows),
// accumulates k*k x VEC partial sums per thread in registers, reduces them
// across its threads through shared memory, and writes its own row of the
// partial buffer. No atomics: every run gives the same bits.
//
// Bound: bytes. Per element it reads one x and one g value and does 2k^2
// FLOPs (18 at k=3, 50 at k=5) against 4 bytes in bf16, far below the H100's
// ~295 FLOP/byte balance point. The least time is (x + g bytes + the k*k*C
// f32 result) / 3.35 TB/s. The design aims at reading each byte once,
// coalesced, with enough blocks in flight for every map size:
//   * neighbouring threads own neighbouring channel groups (pairs where C is
//     even) of the same pixels, so a warp load is a contiguous NHWC run;
//   * each thread takes runs of RX consecutive pixels of one row: RX g
//     values stay in registers while each x row window of RX + k - 1 pixels
//     feeds RX * k taps;
//   * the wrapper cuts B*H into enough row slices that small-C maps (112^2
//     at C = 24, 48) get ~8 blocks per SM from rows alone, while large-C
//     maps (7^2 at C = 3072) get them from channel tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroupsPerBlock = 32;
constexpr int kRX = 4;

template <typename T, int VEC>
struct Load;

template <>
struct Load<float, 1> {
  __device__ static void run(const float* p, float* v) { v[0] = *p; }
};

template <>
struct Load<float, 2> {
  __device__ static void run(const float* p, float* v) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
};

template <>
struct Load<__nv_bfloat16, 1> {
  __device__ static void run(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(*p); }
};

template <>
struct Load<__nv_bfloat16, 2> {
  __device__ static void run(const __nv_bfloat16* p, float* v) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
};

// One thread: VEC channels, runs of kRX pixels of one row. A block:
// `groups` channel groups (blockIdx.y picks the channel tile) x
// blockDim.x / groups threads per group, over the rows
// [blockIdx.x * rows_per_slice, + rows_per_slice) of the B*H image rows.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(kThreads) depthwise_s1_dw(
    const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial, int H, int W,
    int C, int groups, long long n_rows, int rows_per_slice) {
  constexpr int lo = (K - 1) / 2;
  const int tile_c = groups * VEC;
  const int g_local = threadIdx.x % groups;
  const int r_local = threadIdx.x / groups;
  const int runs_per_block = blockDim.x / groups;
  const int c = blockIdx.y * tile_c + g_local * VEC;
  const bool active = c < C;
  const int n_xr = (W + kRX - 1) / kRX;
  const long long row0 = (long long)blockIdx.x * rows_per_slice;
  const long long row_end = row0 + rows_per_slice < n_rows ? row0 + rows_per_slice : n_rows;
  const long long n_runs = (row_end - row0) * n_xr;

  float acc[K * K][VEC];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[t][e] = 0.0f;

  if (active) {
    for (long long run = r_local; run < n_runs; run += runs_per_block) {
      const long long row = row0 + run / n_xr;  // b * H + y
      const int x0 = (int)(run % n_xr) * kRX;
      const int y = (int)(row % H);

      float gv[kRX][VEC];
      const T* grow = g + (row * W) * (long long)C + c;
#pragma unroll
      for (int o = 0; o < kRX; ++o) {
        if (x0 + o < W) {
          Load<T, VEC>::run(grow + (long long)(x0 + o) * C, gv[o]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) gv[o][e] = 0.0f;
        }
      }

#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const int iy = y + dy - lo;
        if (iy < 0 || iy >= H) continue;
        const T* xrow = x + ((row - y + iy) * W) * (long long)C + c;
#pragma unroll
        for (int j = 0; j < kRX + K - 1; ++j) {
          const int ix = x0 + j - lo;
          if (ix < 0 || ix >= W) continue;
          float v[VEC];
          Load<T, VEC>::run(xrow + (long long)ix * C, v);
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const int o = j - dx;
            if (o < 0 || o >= kRX) continue;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[dy * K + dx][e] = fmaf(gv[o][e], v[e], acc[dy * K + dx][e]);
          }
        }
      }
    }
  }

  // Sum each tap over the block's threads of one channel group, in a fixed
  // order, then write this slice's row of the partial buffer.
  __shared__ float red[kThreads * VEC];
  float* out = partial + (long long)blockIdx.x * (K * K) * C;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[threadIdx.x * VEC + e] = acc[t][e];
    __syncthreads();
    if (r_local == 0 && active) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float s = 0.0f;
        for (int r = 0; r < runs_per_block; ++r) s += red[(r * groups + g_local) * VEC + e];
        out[(long long)t * C + c + e] = s;
      }
    }
    __syncthreads();
  }
}

template <typename T, int VEC, int K>
cudaError_t launch(const void* x, const void* g, float* partial, int B, int H, int W, int C,
                   int n_slices, int rows_per_slice, cudaStream_t stream) {
  const int n_groups = C / VEC;
  const int groups = n_groups < kMaxGroupsPerBlock ? n_groups : kMaxGroupsPerBlock;
  const int runs_per_block = kThreads / groups;
  const dim3 grid((unsigned)n_slices, (unsigned)((n_groups + groups - 1) / groups));
  depthwise_s1_dw<T, VEC, K><<<grid, runs_per_block * groups, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, H, W, C, groups,
      (long long)B * H, rows_per_slice);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_k(const void* x, const void* g, float* partial, int B, int H, int W, int C,
                       int k, int n_slices, int rows_per_slice, cudaStream_t s) {
  switch (k) {
    case 1: return launch<T, VEC, 1>(x, g, partial, B, H, W, C, n_slices, rows_per_slice, s);
    case 3: return launch<T, VEC, 3>(x, g, partial, B, H, W, C, n_slices, rows_per_slice, s);
    case 5: return launch<T, VEC, 5>(x, g, partial, B, H, W, C, n_slices, rows_per_slice, s);
    case 7: return launch<T, VEC, 7>(x, g, partial, B, H, W, C, n_slices, rows_per_slice, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_vec(const void* x, const void* g, float* partial, int B, int H, int W, int C,
                         int k, int n_slices, int rows_per_slice, cudaStream_t s) {
  if (C % 2 == 0) return dispatch_k<T, 2>(x, g, partial, B, H, W, C, k, n_slices, rows_per_slice, s);
  return dispatch_k<T, 1>(x, g, partial, B, H, W, C, k, n_slices, rows_per_slice, s);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// k must be 1, 3, 5 or 7. `partial` is f32 (n_slices, k*k, C) and every
// element of it is written; n_slices * rows_per_slice must cover B*H.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success). The caller validates shapes and allocates `partial`.
extern "C" int s2_depthwise_conv2d_s1_grad_weight(const void* x, const void* g, void* partial,
                                                  int B, int H, int W, int C, int k, int n_slices,
                                                  int rows_per_slice, int dtype, int device,
                                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (dtype == 0) return (int)dispatch_vec<float>(x, g, p, B, H, W, C, k, n_slices, rows_per_slice, s);
  if (dtype == 1)
    return (int)dispatch_vec<__nv_bfloat16>(x, g, p, B, H, W, C, k, n_slices, rows_per_slice, s);
  return (int)cudaErrorInvalidValue;
}
