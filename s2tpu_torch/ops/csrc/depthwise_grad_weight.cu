// Stride-1 SAME depthwise convolution, filter gradient, for Hopper (sm_90a).
//
//   dw[dy,dx,c] = sum_{b,y,x} g[b,y,x,c] * x_pad[b, y+dy, x+dx, c]
//
// x and g are (B, H, W, C) NHWC contiguous, f32 or bf16; k is odd, so SAME
// padding is lo = hi = (k-1)/2 on each spatial axis. dw is (k, k, C) f32.
//
// Replaces the TPU kernel s2tpu/ops/depthwise_conv.py::_dw_kernel (launched
// from _grad_weight). That kernel carries its (k*k, 128) sum in VMEM across
// a sequential grid of row tiles. Hopper blocks run in parallel and in no
// order, so a block owns (a channel tile) x (a column tile) x (a slice of
// the B*H image rows) and writes its sums as one f32 partial. The partials
// of a channel tile are added inside the kernel in two ordered levels: the
// last block to finish (a ticket counter) of each group of G consecutive
// partials adds them in order, and the last of those group sums' writers
// adds the n_g group sums in order and writes dw. No atomics on values:
// every run gives the same bits.
//
// Bound: bytes. Per element it reads one x and one g value and does 2k^2
// FLOPs (18 at k=3, 50 at k=5) against 4 bytes in bf16, far below the H100's
// ~295 FLOP/byte balance point. The least time is (x + g bytes + the k*k*C
// f32 result) / 3.35 TB/s. The design reads each byte of x and g once per
// block:
//   * the block walks its rows in groups of RC; each group's g rows and the
//     x rows they newly need are copied into shared memory (16-byte cp.async
//     pieces where C and the pointers allow, narrower otherwise) one group
//     ahead of the one being summed: x rows live in a ring of
//     kStages RC + k - 1 slots,
//     so the k - 1 halo rows two neighbouring groups share are copied once,
//     and the SAME padding columns are zeros written once per block;
//   * a thread owns one channel word (a bf16 or f32 pair where C is even),
//     one tap row dy and R2 consecutive rows of each group (S threads split
//     a group's rows): it walks a g row and the x row dy - lo below it with
//     a sliding register window of k x values, so each value read from shared
//     memory feeds k products, and its k * VEC sums stay in registers;
//   * neighbouring lanes own neighbouring channel words of the same pixel,
//     so a warp's shared-memory reads hit distinct banks;
//   * no barrier per tap: one combine of the S row splits through shared
//     memory at the end of the block, in split order.
// Longest chain of f32 additions into one result: a thread's sequential
// sum over its rows x the column tile's width (R2 * groups * WT terms), the
// combine over S splits, then G partials and n_g group sums: at most
// R2 * ceil(rows_per_slice / RC) * WT + S + G + n_g terms. The wrapper's
// plan caps the first term at 800 and G + n_g is about 2 sqrt(n_parts), so
// the chain stays below 1600 terms (1600 * 2^-24 < 1e-4, the tolerance per
// tap relative to sum |g| |x_pad|) up to ~7 * 10^4 partials; 65-416 terms at
// EfficientNet-B5's shapes.

#include "depthwise_common.cuh"

namespace {

using dwc::Vec;

// Row groups in shared memory at once: the one being summed and the one in
// flight (3 or 4 measured no faster on the H100 at B5's shapes).
constexpr int kStages = DW_GRAD_STAGES;

// dst[tap][c..c+VEC) for this thread's K taps (dy, 0..K-1) = the sum, in
// order, of rows first .. first + count - 1 of `rows` ([row][K*K][C] f32,
// written by other blocks of this launch: read from L2).
template <int VEC, int K>
__device__ __forceinline__ void sum_partials(const float* rows, int first, int count, int C, int dy, int c,
                                             float* dst) {
  float sum[K][VEC];
#pragma unroll
  for (int dx = 0; dx < K; ++dx)
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum[dx][e] = 0.0f;
#pragma unroll 4
  for (int p = first; p < first + count; ++p) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum[dx][e] += __ldcg(rows + ((size_t)p * K * K + dy * K + dx) * C + c + e);
  }
#pragma unroll
  for (int dx = 0; dx < K; ++dx) Vec<float, VEC>::store(dst + (size_t)(dy * K + dx) * C + c, sum[dx]);
}

// grid (n_slices * n_wt, ceil(C / TC)); block TG * K * S threads, thread
// (grp, dy, s) = (tid % TG, tid / TG % K, tid / (TG K)). Partial p of a
// channel tile is part = slice * n_wt + column tile; n_parts = gridDim.x,
// added in groups of G. `partial` holds n_parts + n_g rows of [K*K][C];
// `tickets` n_g + 1 counters per channel tile.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(DW_MAX_THREADS) depthwise_s1_dw(
    const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial, float* __restrict__ dw,
    unsigned int* __restrict__ tickets, int H, int W, int C, int TG, int S, int R2, int WT, int n_wt,
    int n_rows, int rows_per_slice, int G, int piece) {
  constexpr int lo = (K - 1) / 2;
  constexpr int hi = K / 2;
  const int TC = TG * VEC, RC = S * R2, NX = kStages * RC + K - 1, XW = WT + K - 1, NG = kStages * RC;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ctile = blockIdx.y, c0 = ctile * TC, tc = min(TC, C - c0);
  const int part = blockIdx.x, n_parts = gridDim.x;
  const int slice = part / n_wt, wtile = part - slice * n_wt;
  const int xc0 = wtile * WT, wt = min(WT, W - xc0);
  const int r0 = slice * rows_per_slice, r1 = min(r0 + rows_per_slice, n_rows);
  // x rows the slice reads: a contiguous run of the B*H rows, clipped to
  // the images of its first and last g rows.
  const int xlo = max(r0 - lo, r0 / H * H);
  const int xhi = min(r1 - 1 + hi, ((r1 - 1) / H + 1) * H - 1) + 1;

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [NX][XW][TC]: x row r in slot r % NX
  T* gs = xs + (size_t)NX * XW * TC;    // [kStages RC][WT][TC]: g row r in slot (r - r0) % (kStages RC)
  __shared__ bool last_block;

  // A thread copies piece pq of pixels pix0, pix0 + pstride, ... (the plan
  // gives a block at least as many threads as a pixel has pieces).
  const int ppp = tc * (int)sizeof(T) / piece;  // pieces per pixel
  const int pstride = nthr / ppp, pix0 = tid / ppp, pq = tid - pix0 * ppp;
  const bool copier = pix0 < pstride;

  // The padding columns of every x slot (left of column 0, right of W - 1).
  const int xcols = wt + K - 1;
  const int n_left = max(0, lo - xc0), right0 = max(n_left, W - xc0 + lo), n_pad = n_left + max(0, xcols - right0);
  if (copier) {
    for (int t = pix0; t < NX * n_pad; t += pstride) {
      const int slot = t / n_pad, j0 = t - slot * n_pad;
      const int j = j0 < n_left ? j0 : right0 + (j0 - n_left);
      dwc::zero_piece(reinterpret_cast<char*>(xs + ((size_t)slot * XW + j) * TC) + pq * piece, piece);
    }
  }

  // Image columns [cx0, cx1) of x rows land at slot column cx - (xc0 - lo).
  const int cx0 = max(xc0 - lo, 0), cx1 = min(xc0 + wt + hi, W), nxp = cx1 - cx0;
  auto stage = [&](int ga, int gb, int xa, int xb) {
    if (!copier) return;
    for (int t = pix0; t < (xb - xa) * nxp; t += pstride) {
      const int rr = t / nxp, p = t - rr * nxp, r = xa + rr;
      dwc::copy_piece(
          reinterpret_cast<char*>(xs + ((size_t)(r % NX) * XW + cx0 - (xc0 - lo) + p) * TC) + pq * piece,
          reinterpret_cast<const char*>(x + ((size_t)r * W + cx0 + p) * C + c0) + pq * piece, piece);
    }
    for (int t = pix0; t < (gb - ga) * wt; t += pstride) {
      const int rr = t / wt, p = t - rr * wt, r = ga + rr;
      dwc::copy_piece(reinterpret_cast<char*>(gs + ((size_t)((r - r0) % NG) * WT + p) * TC) + pq * piece,
                      reinterpret_cast<const char*>(g + ((size_t)r * W + xc0 + p) * C + c0) + pq * piece, piece);
    }
  };

  const int grp = tid % TG, dy = tid / TG % K, s = tid / (TG * K);
  const bool active = grp * VEC < tc;
  float acc[K][VEC];
#pragma unroll
  for (int dx = 0; dx < K; ++dx)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[dx][e] = 0.0f;

  // Group j's copies: its g rows and the x rows up to its last row + hi
  // that no earlier group copied. One commit per group, empty past the end,
  // so that waiting for all but kStages - 1 groups waits for group i.
  const int n_groups = (r1 - r0 + RC - 1) / RC;
  int x_end = xlo;
  auto stage_group = [&](int j) {
    if (j < n_groups) {
      const int ga = r0 + j * RC, gb = min(ga + RC, r1), xe = min(gb + hi, xhi);
      stage(ga, gb, x_end, xe);
      x_end = xe;
    }
    dwc::cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) stage_group(j);
  for (int i = 0; i < n_groups; ++i) {
    const int ga = r0 + i * RC, gb = min(ga + RC, r1);
    stage_group(i + kStages - 1);  // in flight while this group is summed
    dwc::cp_async_wait<kStages - 1>();
    __syncthreads();
    if (active) {
      for (int q = 0; q < R2; ++q) {
        const int gr = ga + s * R2 + q;
        if (gr >= gb) break;
        const int iy = gr % H + dy - lo;
        if (iy < 0 || iy >= H) continue;
        const T* xp = xs + ((size_t)((gr + dy - lo) % NX) * XW) * TC + grp * VEC;
        const T* gp = gs + ((size_t)((gr - r0) % NG) * WT) * TC + grp * VEC;
        // win[q % K] holds slot column q: columns p .. p + K - 1 at pixel p.
        // Pixel p = p0 + j with p0 a multiple of K, so every index is fixed
        // at compile time; whole blocks of K pixels run without a bound
        // check (the loads can be issued ahead), the last wt % K with one.
        float win[K][VEC];
#pragma unroll
        for (int j = 0; j < K - 1; ++j) Vec<T, VEC>::load(xp + (size_t)j * TC, win[j]);
        auto step = [&](int p, int j) {
          Vec<T, VEC>::load(xp + (size_t)(p + K - 1) * TC, win[(j + K - 1) % K]);
          float gv[VEC];
          Vec<T, VEC>::load(gp + (size_t)p * TC, gv);
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[dx][e] = fmaf(gv[e], win[(j + dx) % K][e], acc[dx][e]);
        };
        int p0 = 0;
        for (; p0 + K <= wt; p0 += K) {
#pragma unroll
          for (int j = 0; j < K; ++j) step(p0 + j, j);
        }
#pragma unroll
        for (int j = 0; j < K - 1; ++j)
          if (p0 + j < wt) step(p0 + j, j);
      }
    }
    __syncthreads();  // the slots of this group are free for the copies of group i + kStages
  }

  // One combine of the S row splits, in split order, through shared memory.
  if (S > 1) {
    float* red = reinterpret_cast<float*>(smem);  // [S][K][K][TC]
    if (active) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[((size_t)(s * K + dy) * K + dx) * TC + grp * VEC + e] = acc[dx][e];
    }
    __syncthreads();
    if (active && s == 0) {
      for (int s2 = 1; s2 < S; ++s2) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[dx][e] += red[((size_t)(s2 * K + dy) * K + dx) * TC + grp * VEC + e];
      }
    }
  }

  const bool owner = active && s == 0;
  const int c = c0 + grp * VEC;
  if (owner) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
      Vec<float, VEC>::store(partial + ((size_t)part * K * K + dy * K + dx) * C + c, acc[dx]);
  }
  // Level 1: the last block of this group of G partials to arrive adds them.
  const int n_g = (n_parts + G - 1) / G, grp_id = part / G, first = grp_id * G, count = min(G, n_parts - first);
  unsigned int* cnt = tickets + (size_t)ctile * (n_g + 1);
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(&cnt[grp_id], 1u) == (unsigned)(count - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  float* level1 = n_g == 1 ? dw : partial + (size_t)(n_parts + grp_id) * K * K * C;
  if (owner) sum_partials<VEC, K>(partial, first, count, C, dy, c, level1);
  if (tid == 0) cnt[grp_id] = 0u;  // every block of the group has taken its ticket: ready for the next call
  if (n_g == 1) return;
  // Level 2: the last group sum's writer adds the n_g group sums.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(&cnt[n_g], 1u) == (unsigned)(n_g - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (owner) sum_partials<VEC, K>(partial, n_parts, n_g, C, dy, c, dw);
  if (tid == 0) cnt[n_g] = 0u;
}

// Shared memory of one block: the x ring (kStages RC + K - 1 rows of
// WT + K - 1 pixels) and kStages g stages (RC rows of WT), or the combine of
// the S splits' sums where that is larger.
size_t shared_bytes(int TC, int S, int R2, int WT, int K, size_t elem) {
  const int RC = S * R2;
  const size_t stage = ((size_t)(kStages * RC + K - 1) * (WT + K - 1) + (size_t)kStages * RC * WT) * TC * elem;
  const size_t red = (size_t)S * K * K * TC * sizeof(float);
  return stage > red ? stage : red;
}

// The instantiation for k (1, 3, 5 or 7; nullptr otherwise).
template <typename T, int VEC>
auto dw_kernel(int k) {
  switch (k) {
    case 1: return depthwise_s1_dw<T, VEC, 1>;
    case 3: return depthwise_s1_dw<T, VEC, 3>;
    case 5: return depthwise_s1_dw<T, VEC, 5>;
    case 7: return depthwise_s1_dw<T, VEC, 7>;
    default: return static_cast<decltype(&depthwise_s1_dw<T, VEC, 1>)>(nullptr);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* g, float* partial, float* dw, unsigned int* tickets, int B, int H,
                   int W, int C, int k, int TG, int S, int R2, int WT, int n_slices, int rows_per_slice, int G,
                   int piece, int smem, cudaStream_t stream) {
  const auto kernel = dw_kernel<T, VEC>(k);
  const int TC = TG * VEC, threads = TG * k * S;
  if (kernel == nullptr || TG < 1 || S < 1 || R2 < 1 || WT < 1 || G < 1 || threads > DW_MAX_THREADS ||
      threads < TC * (int)sizeof(T) / piece || !dwc::piece_ok(TC, C, piece, sizeof(T)) ||
      (size_t)smem != shared_bytes(TC, S, R2, WT, k, sizeof(T)))
    return cudaErrorInvalidValue;
  const long long n_rows = (long long)B * H;
  // Every slice holds at least one row and together they cover B*H.
  if (n_rows > 0x7fffffffLL || n_slices < 1 || rows_per_slice < 1 || (long long)n_slices * rows_per_slice < n_rows ||
      (long long)(n_slices - 1) * rows_per_slice >= n_rows)
    return cudaErrorInvalidValue;
  const int n_wt = (W + WT - 1) / WT;
  const long long n_parts = (long long)n_slices * n_wt, c_tiles = (C + TC - 1) / TC;
  if (n_parts > 0x7fffffffLL || c_tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = dwc::allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)n_parts, (unsigned)c_tiles), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, dw, tickets, H, W, C, TG, S, R2, WT, n_wt,
      (int)n_rows, rows_per_slice, G, piece);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 =
// bfloat16; k must be 1, 3, 5 or 7. The tile plan is the wrapper's: TG
// channel groups (pairs where C is even), S row splits of R2 rows each,
// column tiles of WT, n_slices slices of rows_per_slice of the B*H rows,
// partials added in groups of G, staged copies of `piece` bytes (16, 8, 4
// or 2, dividing C * sizeof(T) and the alignment of x and g) and `smem`, the
// block's shared memory, which must equal the kernel's layout.

// dw is f32 (k, k, C) and every element of it is written. With n_parts =
// n_slices * ceil(W / WT) partials and n_g = ceil(n_parts / G) groups,
// `partial` is f32 (n_parts + n_g, k*k, C) scratch and `tickets` holds
// (n_g + 1) * ceil(C / (TG * VEC)) zeros, which the kernel leaves at zero.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success).
extern "C" int s2_depthwise_conv2d_s1_grad_weight(const void* x, const void* g, void* partial, void* dw,
                                                  void* tickets, int B, int H, int W, int C, int k, int TG, int S,
                                                  int R2, int WT, int n_slices, int rows_per_slice, int G,
                                                  int piece, int smem, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  return (int)dwc::with_types(dtype, C, [&](auto types) {
    using Types = decltype(types);
    return launch<typename Types::T, Types::VEC>(x, g, p, d, t, B, H, W, C, k, TG, S, R2, WT, n_slices,
                                                 rows_per_slice, G, piece, smem, s);
  });
}

// *blocks = blocks of the instantiation for (dtype, C, k) with `threads`
// threads and `smem` bytes of shared memory that the card holds at once.
extern "C" int s2_depthwise_conv2d_s1_grad_weight_resident(int C, int k, int threads, int smem, int dtype,
                                                           int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)dwc::with_types(dtype, C, [&](auto types) {
    using Types = decltype(types);
    const auto kernel = dw_kernel<typename Types::T, Types::VEC>(k);
    return kernel == nullptr ? cudaErrorInvalidValue : dwc::resident_blocks(kernel, threads, smem, blocks);
  });
}
