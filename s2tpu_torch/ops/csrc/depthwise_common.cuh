// Pieces shared by the two depthwise kernels (depthwise_conv.cu: #1,
// depthwise_grad_weight.cu: #2): channel vectors of f32 or bf16 read as f32,
// and copies of a block's tile from global into shared memory in pieces of
// 16, 8 or 4 bytes through cp.async, or of 2 bytes by a plain load and
// store (bf16 with odd C or a 2-byte aligned pointer). The wrapper picks the
// piece: the widest that divides C * sizeof(T) and the alignment of every
// pointer the kernel copies from or to.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "depthwise_tiles.h"

namespace dwc {

// VEC consecutive channels of T at p as f32 (load) or rounded from f32 to
// nearest even (store). p is aligned to VEC * sizeof(T).
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

template <>
struct Vec<float, 2> {
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
struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, const float* v) { *p = __float2bfloat16_rn(v[0]); }
};

template <>
struct Vec<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One piece of `bytes` from global `src` to shared `dst`: cp.async for 16
// (L2 only), 8 and 4 bytes, in flight until the thread commits and waits; a
// plain 2-byte load and store otherwise (visible after the next barrier).
__device__ __forceinline__ void copy_piece(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
      break;
    default:
      *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

// Zeros over one piece of `bytes` in shared memory.
__device__ __forceinline__ void zero_piece(void* dst, int bytes) {
  switch (bytes) {
    case 16: *static_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u); break;
    case 8: *static_cast<uint2*>(dst) = make_uint2(0u, 0u); break;
    case 4: *static_cast<uint32_t*>(dst) = 0u; break;
    default: *static_cast<uint16_t*>(dst) = 0;
  }
}

// One piece of `bytes` from shared `src` to global `dst`.
__device__ __forceinline__ void store_piece(void* dst, const void* src, int bytes) {
  switch (bytes) {
    case 16: *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src); break;
    case 8: *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src); break;
    case 4: *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src); break;
    default: *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A piece of `piece` bytes tiles every pixel's channel run of a TC-channel
// tile (and of the last, narrower tile) of C channels of `elem` bytes.
__host__ inline bool piece_ok(int TC, int C, int piece, size_t elem) {
  if (piece != 16 && piece != 8 && piece != 4 && piece != 2) return false;
  return (size_t)piece >= elem && ((size_t)C * elem) % piece == 0 && ((size_t)TC * elem) % piece == 0;
}

// Shared memory a block may use on sm_90 with the opt-in attribute; above
// the default 48 KiB a launch asks for it first.
constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

template <typename Kernel>
__host__ cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// Blocks of `kernel` (threads a block, bytes of shared memory) that the
// card's SMs hold at once, all SMs together: what the wrapper sizes both
// kernels' grids from.
template <typename Kernel>
__host__ cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_shared(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) *blocks = per_sm * sms;
  return err;
}

// The element type and channels a thread owns (a pair where C is even) of
// a call: f(Types<T, VEC>{}) for dtype 0 = float32, 1 = bfloat16.
template <typename T_, int VEC_>
struct Types {
  using T = T_;
  static constexpr int VEC = VEC_;
};

template <typename F>
__host__ cudaError_t with_types(int dtype, int C, F&& f) {
  if (dtype == 0) return C % 2 == 0 ? f(Types<float, 2>{}) : f(Types<float, 1>{});
  if (dtype == 1) return C % 2 == 0 ? f(Types<__nv_bfloat16, 2>{}) : f(Types<__nv_bfloat16, 1>{});
  return cudaErrorInvalidValue;
}

}  // namespace dwc
