// Stride-1 SAME depthwise convolution, forward and input gradient, for
// Hopper (sm_90a).
//
//   out[b,y,x,c] = sum_{dy,dx} w'[dy,dx,c] * x_pad[b, y+dy, x+dx, c]
//
// with w' = w, or w'[dy,dx] = w[k-1-dy, k-1-dx] when `flip` is set: the
// input gradient of an odd-k layer is this convolution of the cotangent
// with the spatially flipped filter, and the flip is read by index here, so
// the caller makes no flipped copy. x and out are (B, H, W, C) NHWC
// contiguous, w is (k, k, C). SAME padding is lo = (k-1)/2 before and
// hi = k/2 after each spatial axis. f32 or bf16 in, f32 accumulation, the
// input dtype out.
//
// Replaces the TPU kernel s2tpu/ops/depthwise_conv.py::_fwd_kernel (launched
// from _forward). That kernel streams 128-lane channel tiles of VMEM row
// tiles through double-buffered halo DMAs; what carries over is the
// arithmetic: the same k*k shifted multiply-adds per channel, in the same
// order (dy-major, dx ascending), accumulated in f32.
//
// Bound: bytes. In bf16 a k x k layer does 2k^2 FLOPs per output element
// against 4 bytes moved (one read, one write): 4.5 FLOP/byte at k=3 and
// 12.5 at k=5, far below the H100's ~295 FLOP/byte balance point. The least
// time is (x bytes + out bytes + w bytes) / 3.35 TB/s. The design:
//   * a block keeps a channel tile of TC channels and walks tiles of TH x TW
//     outputs; it stages each tile's (TH + k - 1) x (TW + k - 1) x TC input
//     halo into shared memory once, in 16-byte cp.async pieces where C and
//     the pointers allow (narrower pieces otherwise), the next tile's copy
//     in flight while this one is summed, with the SAME padding written as
//     zeros there: no branch per tap, and a pad tap adds +-0 exactly as the
//     plain version's F.pad does;
//   * a thread owns VEC channels (a bf16 or f32 pair where C is even) and an
//     kRY x kRX patch of outputs; its k*k weights sit in registers for the
//     block's lifetime (k <= 7, unrolled at compile time), so each staged
//     value read from shared memory feeds up to kRY * k products;
//   * neighbouring lanes own neighbouring channel words of the same pixel,
//     so a warp's shared-memory reads hit distinct banks;
//   * the outputs go back through shared memory and leave in pieces as wide
//     as the copies in (16-byte stores where C and the pointers allow);
//   * the grid is the wrapper's: blocks per channel tile sized from what the
//     card holds at once (s2_depthwise_conv2d_s1_fwd_resident).
// Multiplies and adds are issued separately (__fmul_rn / __fadd_rn), never
// contracted into FMAs, and each output's taps are summed dy-major, dx
// ascending, starting from 0: the kernel rounds exactly as the plain PyTorch
// version (depthwise_conv2d_s1_reference) does. Register blocking and
// staging change where values come from, not the order of the arithmetic.

#include "depthwise_common.cuh"

namespace {

using dwc::Vec;

constexpr int kRX = DW_FWD_RX;  // outputs along W per thread
constexpr int kRY = DW_FWD_RY;  // outputs along H per thread

// grid (workers, ceil(C / TC)); block TG * PX * PY threads: TG channel
// groups of VEC channels (TC = TG * VEC) x PX x PY patches of kRY x kRX
// outputs (TH = PY * kRY, TW = PX * kRX). A block keeps one channel tile and
// walks the spatial tiles t = blockIdx.x, + workers, ... of all B images,
// the next tile's halo copy in flight while this one is summed (two halo
// buffers). K > 0 fixes k at compile time (weights in registers for the
// block's lifetime); K == 0 reads k from k_rt and the weights from global
// memory tap by tap.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(DW_MAX_THREADS) depthwise_s1_fwd(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int H, int W, int C, int k_rt,
    int TG, int PX, int PY, int tiles_x, int tiles_y, int n_tiles, int piece, int flip) {
  const int k = K > 0 ? K : k_rt;
  const int lo = (k - 1) / 2;
  const int TC = TG * VEC, TH = PY * kRY, TW = PX * kRX, SH = TH + k - 1, SW = TW + k - 1;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c0 = blockIdx.y * TC;
  const int tc = min(TC, C - c0);

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t halo_elems = (size_t)SH * SW * TC;
  T* const halo = reinterpret_cast<T*>(smem);  // two [SH][SW][TC] halo tiles
  T* const os = halo + 2 * halo_elems;         // [TH][TW][TC] outputs, stored in pieces

  // A thread copies piece q of pixels pix0, pix0 + pstride, ... (the plan
  // gives a block at least as many threads as a pixel has pieces).
  const int ppp = tc * (int)sizeof(T) / piece;  // pieces per pixel
  const int pstride = nthr / ppp, pix0 = tid / ppp, q = tid - pix0 * ppp;
  auto stage = [&](int t, T* dst) {
    const int tx = t % tiles_x, ty = t / tiles_x % tiles_y, b = t / (tiles_x * tiles_y);
    const int iy0 = ty * TH - lo, ix0 = tx * TW - lo;
    const T* xb = x + (size_t)b * H * W * C + c0;
    if (pix0 >= pstride) return;
    for (int pix = pix0; pix < SH * SW; pix += pstride) {
      const int sr = pix / SW, sc = pix - sr * SW;
      const int iy = iy0 + sr, ix = ix0 + sc;
      char* d = reinterpret_cast<char*>(dst + (size_t)pix * TC) + q * piece;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        dwc::copy_piece(d, reinterpret_cast<const char*>(xb + ((size_t)iy * W + ix) * C) + q * piece, piece);
      else
        dwc::zero_piece(d, piece);
    }
  };

  int t = blockIdx.x;
  stage(t, halo);
  dwc::cp_async_commit();

  const int grp = tid % TG, patch = tid / TG;
  const int pxi = patch % PX, pyi = patch / PX;
  const int c = c0 + grp * VEC;
  const bool active = grp * VEC < tc;

  // The weights, flipped by index for the input gradient, load while the
  // first copies are in flight.
  float wr[K > 0 ? K * K : 1][VEC];
  if constexpr (K > 0) {
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap) {
      const int src = flip ? K * K - 1 - tap : tap;
#pragma unroll
      for (int e = 0; e < VEC; ++e) wr[tap][e] = active ? dwc::to_float(w[(size_t)src * C + c + e]) : 0.0f;
    }
  }

  for (int it = 0; t < n_tiles; ++it, t += gridDim.x) {
    const T* cur = halo + (it & 1) * halo_elems;
    if (t + (int)gridDim.x < n_tiles) {  // the next tile flies while this one is summed
      stage(t + gridDim.x, halo + ((it + 1) & 1) * halo_elems);
      dwc::cp_async_commit();
      dwc::cp_async_wait<1>();
    } else {
      dwc::cp_async_wait<0>();
    }
    __syncthreads();

    float acc[kRY][kRX][VEC];
#pragma unroll
    for (int ry = 0; ry < kRY; ++ry)
#pragma unroll
      for (int rx = 0; rx < kRX; ++rx)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[ry][rx][e] = 0.0f;
    const T* base = cur + ((size_t)(pyi * kRY) * SW + pxi * kRX) * TC + grp * VEC;
    if constexpr (K > 0) {
      // Input row ir feeds output row ry through tap row dy = ir - ry, input
      // column j output column rx through dx = j - rx: over (ir, j)
      // ascending every output takes its taps dy-major, dx ascending.
#pragma unroll
      for (int ir = 0; ir < kRY + K - 1; ++ir) {
#pragma unroll
        for (int j = 0; j < kRX + K - 1; ++j) {
          float v[VEC];
          Vec<T, VEC>::load(base + ((size_t)ir * SW + j) * TC, v);
#pragma unroll
          for (int ry = 0; ry < kRY; ++ry) {
            const int dy = ir - ry;
            if (dy < 0 || dy >= K) continue;
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              const int rx = j - dx;
              if (rx < 0 || rx >= kRX) continue;
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[ry][rx][e] = __fadd_rn(acc[ry][rx][e], __fmul_rn(v[e], wr[dy * K + dx][e]));
            }
          }
        }
      }
    } else {
      for (int dy = 0; dy < k; ++dy) {
        for (int dx = 0; dx < k; ++dx) {
          const int src = flip ? k * k - 1 - (dy * k + dx) : dy * k + dx;
          float wv[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) wv[e] = active ? dwc::to_float(w[(size_t)src * C + c + e]) : 0.0f;
#pragma unroll
          for (int ry = 0; ry < kRY; ++ry)
#pragma unroll
            for (int rx = 0; rx < kRX; ++rx) {
              float v[VEC];
              Vec<T, VEC>::load(base + ((size_t)(ry + dy) * SW + rx + dx) * TC, v);
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[ry][rx][e] = __fadd_rn(acc[ry][rx][e], __fmul_rn(v[e], wv[e]));
            }
        }
      }
    }

    // Through shared memory, out in pieces of the copies' width. The
    // barrier between the two halves also keeps every thread's halo reads
    // ahead of the next tile's copies into this buffer; the one at the top
    // of the next tile keeps these reads ahead of the next tile's writes.
    if (active) {
#pragma unroll
      for (int ry = 0; ry < kRY; ++ry)
#pragma unroll
        for (int rx = 0; rx < kRX; ++rx)
          Vec<T, VEC>::store(os + ((size_t)(pyi * kRY + ry) * TW + pxi * kRX + rx) * TC + grp * VEC, acc[ry][rx]);
    }
    __syncthreads();
    const int tx = t % tiles_x, ty = t / tiles_x % tiles_y, b = t / (tiles_x * tiles_y);
    const int oy0 = ty * TH, ox0 = tx * TW;
    T* ob = out + (size_t)b * H * W * C + c0;
    if (pix0 < pstride) {
      for (int pix = pix0; pix < TH * TW; pix += pstride) {
        const int r = pix / TW, col = pix - r * TW;
        const int y = oy0 + r, xx = ox0 + col;
        if (y < H && xx < W)
          dwc::store_piece(reinterpret_cast<char*>(ob + ((size_t)y * W + xx) * C) + q * piece,
                           reinterpret_cast<const char*>(os + (size_t)pix * TC) + q * piece, piece);
      }
    }
  }
}

// Shared memory of one block: two halo tiles (the next one's copy in
// flight) and the output tile.
size_t shared_bytes(int TC, int TH, int TW, int k, size_t elem) {
  return ((size_t)2 * (TH + k - 1) * (TW + k - 1) + (size_t)TH * TW) * TC * elem;
}

// The instantiation for k: unrolled for k <= 7, k read at run time above.
template <typename T, int VEC>
auto fwd_kernel(int k) {
  switch (k) {
    case 1: return depthwise_s1_fwd<T, VEC, 1>;
    case 2: return depthwise_s1_fwd<T, VEC, 2>;
    case 3: return depthwise_s1_fwd<T, VEC, 3>;
    case 4: return depthwise_s1_fwd<T, VEC, 4>;
    case 5: return depthwise_s1_fwd<T, VEC, 5>;
    case 6: return depthwise_s1_fwd<T, VEC, 6>;
    case 7: return depthwise_s1_fwd<T, VEC, 7>;
    default: return depthwise_s1_fwd<T, VEC, 0>;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* w, void* out, int B, int H, int W, int C, int k, int TG, int PX,
                   int PY, int workers, int piece, int smem, int flip, cudaStream_t stream) {
  const int TC = TG * VEC, TH = PY * kRY, TW = PX * kRX;
  const int threads = TG * PX * PY;
  if (TG < 1 || PX < 1 || PY < 1 || threads > DW_MAX_THREADS || threads < TC * (int)sizeof(T) / piece ||
      !dwc::piece_ok(TC, C, piece, sizeof(T)) || (size_t)smem != shared_bytes(TC, TH, TW, k, sizeof(T)))
    return cudaErrorInvalidValue;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long n_tiles = (long long)B * tiles_y * tiles_x;
  const long long c_tiles = (C + TC - 1) / TC;
  if (n_tiles > 0x7fffffffLL || c_tiles > 65535 || workers < 1 || workers > n_tiles) return cudaErrorInvalidValue;
  const auto kernel = fwd_kernel<T, VEC>(k);
  cudaError_t err = dwc::allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)workers, (unsigned)c_tiles), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), H, W, C, k, TG, PX, PY, tiles_x,
      tiles_y, (int)n_tiles, piece, flip);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 =
// bfloat16. The tile plan is the wrapper's: TG channel groups (2 channels
// each where C is even, else 1), PX x PY patches of DW_FWD_RY x DW_FWD_RX
// outputs (TG * PX * PY >= TG * VEC threads), `workers` blocks per channel
// tile (1 to the number of spatial tiles), `piece` bytes per staged copy
// and store (16, 8, 4 or 2, dividing C * sizeof(T) and the alignment of x
// and out) and `smem`, the block's shared memory, which must equal the
// kernel's layout: two halo tiles and the output tile.

// Launches the convolution on `stream` without synchronising and returns
// cudaGetLastError() (0 on success); flip != 0 reads w[k-1-dy, k-1-dx] for
// tap (dy, dx). The caller validates shapes and allocates `out`.
extern "C" int s2_depthwise_conv2d_s1_fwd(const void* x, const void* w, void* out, int B, int H, int W, int C,
                                          int k, int TG, int PX, int PY, int workers, int piece, int smem,
                                          int flip, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dwc::with_types(dtype, C, [&](auto types) {
    using Types = decltype(types);
    return launch<typename Types::T, Types::VEC>(x, w, out, B, H, W, C, k, TG, PX, PY, workers, piece, smem, flip,
                                                 s);
  });
}

// *blocks = blocks of the instantiation for (dtype, C, k) with `threads`
// threads and `smem` bytes of shared memory that the card holds at once.
extern "C" int s2_depthwise_conv2d_s1_fwd_resident(int C, int k, int threads, int smem, int dtype, int device,
                                                   int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)dwc::with_types(dtype, C, [&](auto types) {
    using Types = decltype(types);
    return dwc::resident_blocks(fwd_kernel<typename Types::T, Types::VEC>(k), threads, smem, blocks);
  });
}
