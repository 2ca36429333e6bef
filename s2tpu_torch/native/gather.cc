// Native batch gather+crop for the host input pipeline (the port's copy of
// the JAX package's s2tpu/native/gather.cc; the same entry points).
//
// The hot host-side loop of training from a packed corpus is assembling
// (B, crop, crop, C) int16 batches out of the (N, H, W, C) memmap
// (s2tpu_torch/data/pipeline.py Datamodule._gather_crops). Here it is one
// multithreaded C++ routine over the memory-mapped array: row-wise memcpy
// per crop line, one thread per slice of the batch.
//
// Built as a plain shared library with g++ at first use and driven through
// ctypes (s2tpu_torch/native/__init__.py); the Datamodule takes the numpy
// path when the library is unavailable.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// images: (n, h, w, c) int16 contiguous; out: (b, crop, crop, c)
// labels: (n, h, w) uint8 contiguous;    lout: (b, crop, crop) int32
// flip_h / flip_v: optional (b,) 0/1 flags (NULL = no flips). Vertical flips
// are free (rows read bottom-up, still row memcpy); horizontal flips copy
// pixel-by-pixel reversed -- host-side augmentation overlapped with device
// compute, so the train step itself does not flip.
void gather_crops_flips_i16_u8(
    const int16_t* images, const uint8_t* labels,
    int64_t h, int64_t w, int64_t c,
    const int64_t* indices, const int64_t* ys, const int64_t* xs,
    const uint8_t* flip_h, const uint8_t* flip_v,
    int64_t b, int64_t crop,
    int16_t* out, int32_t* lout,
    int64_t num_threads) {
  const int64_t img_stride = h * w * c;
  const int64_t lbl_stride = h * w;
  const int64_t row_elems = crop * c;

  auto work = [&](int64_t start, int64_t end) {
    for (int64_t k = start; k < end; ++k) {
      const int64_t idx = indices[k];
      const int64_t y0 = ys[k];
      const int64_t x0 = xs[k];
      const bool fh = flip_h != nullptr && flip_h[k] != 0;
      const bool fv = flip_v != nullptr && flip_v[k] != 0;
      const int16_t* src = images + idx * img_stride + (y0 * w + x0) * c;
      int16_t* dst = out + k * crop * row_elems;
      for (int64_t r = 0; r < crop; ++r) {
        const int16_t* srow = src + (fv ? (crop - 1 - r) : r) * w * c;
        int16_t* drow = dst + r * row_elems;
        if (!fh) {
          std::memcpy(drow, srow, row_elems * sizeof(int16_t));
        } else {
          for (int64_t col = 0; col < crop; ++col) {
            std::memcpy(drow + col * c, srow + (crop - 1 - col) * c, c * sizeof(int16_t));
          }
        }
      }
      const uint8_t* lsrc = labels + idx * lbl_stride + y0 * w + x0;
      int32_t* ldst = lout + k * crop * crop;
      for (int64_t r = 0; r < crop; ++r) {
        const uint8_t* lrow = lsrc + (fv ? (crop - 1 - r) : r) * w;
        int32_t* lorow = ldst + r * crop;
        if (!fh) {
          for (int64_t col = 0; col < crop; ++col) lorow[col] = lrow[col];
        } else {
          for (int64_t col = 0; col < crop; ++col) lorow[col] = lrow[crop - 1 - col];
        }
      }
    }
  };

  if (num_threads <= 1 || b < 4) {
    work(0, b);
    return;
  }
  const int64_t nt = std::min<int64_t>(num_threads, b);
  std::vector<std::thread> threads;
  const int64_t per = (b + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t s = t * per;
    const int64_t e = std::min(b, s + per);
    if (s < e) threads.emplace_back(work, s, e);
  }
  for (auto& th : threads) th.join();
}

// Backwards-compatible entry without flips.
void gather_crops_i16_u8(
    const int16_t* images, const uint8_t* labels,
    int64_t h, int64_t w, int64_t c,
    const int64_t* indices, const int64_t* ys, const int64_t* xs,
    int64_t b, int64_t crop,
    int16_t* out, int32_t* lout,
    int64_t num_threads) {
  gather_crops_flips_i16_u8(images, labels, h, w, c, indices, ys, xs,
                            nullptr, nullptr, b, crop, out, lout, num_threads);
}

}  // extern "C"
