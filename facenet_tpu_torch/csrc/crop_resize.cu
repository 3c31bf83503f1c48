// Crop-and-resize: batched, separable two-tap bilinear crops of boxes from
// images of any channel count.
//
// Replaces no Pallas TPU kernel: the JAX package's crop_and_resize
// (facenet_tpu/ops/image_ops.py) is two interpolation-matrix products that
// XLA runs. On the card those two float32 products (the plain version,
// facenet_tpu_torch/ops/image_ops.py::crop_and_resize) cost far more than
// the work: the first multiplies dense one-hot matrices whose rows hold 2
// taps of H, the second broadcasts the column weights to [B*K, S, S, W]
// (37.7 GB for the landmark alignment's 256 crops of 240 px). An output
// needs four taps.
//
// For crop n (image n / K), output pixel (i, j) and channel c, with the
// box (x_lo, y_lo, x_hi, y_hi):
//
//   y = y_lo + ((i + .5) * (1 / S)) * (y_hi - y_lo) - .5   (x likewise)
//   y0 = clamp(floor(y), 0, H - 1), y1 = clamp(floor(y) + 1, 0, H - 1)
//   out = (1 - wx) ((1 - wy) p[y0, x0] + wy p[y1, x0])
//       +      wx  ((1 - wy) p[y0, x1] + wy p[y1, x1])
//
// in float32, Y first and then X, as the two products interpolate. The
// coordinates are rounded after each operation, with no fused
// multiply-add, as the plain version's elementwise operations round them on
// the card (PyTorch multiplies by the reciprocal of a scalar divisor there):
// an error in a coordinate comes back multiplied by the image's gradient,
// up to 255 a pixel. They are clamped in float before they become indices,
// so a non-finite box (an empty slot's landmarks) reads inside the image;
// its output is unspecified.
//
// What bounds it on the card: bytes, a few flops an output. Each output is
// written once (187.6 MB for crowd-b8's crops, 0.056 ms at 3.35 TB/s) and
// the taps read the scenes, which L2 holds at a batch of 8 480x640 scenes.
// The design follows: one warp per output row (crop n, row i), whose S * C
// floats are contiguous, walked 32 at a time, one output a thread. Stores
// are whole sectors for any C, and for wide C (Faster-RCNN's feature maps)
// the four taps' channel vectors are read by neighbouring threads too. The
// row's source rows and weight are computed once a thread; an output adds
// its column's taps, and with C = 3 known when compiled, j = e / 3 is a
// multiply. (A flat index over all outputs would divide by the run-time S
// and C twice more an output.)

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;                  // output rows (warps) a block
constexpr int THREADS = 32 * ROWS;

struct Taps {
  int a, b;      // the two source indices
  float w;       // the weight of b
};

// the sample position of output index k along an axis of n source pixels,
// for the box range [lo, hi), rounded as the plain version rounds it
__device__ __forceinline__ Taps taps(float lo, float hi, int k, float inv_s,
                                     int n) {
  const float grid = __fmul_rn(__fadd_rn((float)k, 0.5f), inv_s);
  const float pos =
      __fsub_rn(__fadd_rn(lo, __fmul_rn(grid, __fsub_rn(hi, lo))), 0.5f);
  const float f = floorf(pos);
  Taps t;
  t.a = (int)fminf(fmaxf(f, 0.f), n - 1.f);   // fmaxf(NaN, 0) is 0
  t.b = (int)fminf(fmaxf(f + 1.f, 0.f), n - 1.f);
  t.w = __fsub_rn(pos, f);
  return t;
}

// C = 3: the detection crops; C = 0: any channel count `c`
template <int C>
__global__ void __launch_bounds__(THREADS)
crop_resize_kernel(const float* __restrict__ src,
                   const float* __restrict__ boxes, int k, int h, int w,
                   int c, int s, int rows, float inv_s,
                   float* __restrict__ out) {
  const int channels = C > 0 ? C : c;
  const int row = blockIdx.x * ROWS + threadIdx.y;   // crop n, row i
  if (row >= rows) return;
  const int n = row / s, i = row - n * s;
  const float* box = boxes + 4 * (long long)n;
  const Taps ty = taps(__ldg(box + 1), __ldg(box + 3), i, inv_s, h);
  const float x_lo = __ldg(box), x_hi = __ldg(box + 2);
  const float vy = 1.f - ty.w;
  const long long pitch = (long long)w * channels;
  const float* img = src + (long long)(n / k) * h * pitch;
  const float* top = img + ty.a * pitch;
  const float* bot = img + ty.b * pitch;
  float* o = out + (long long)row * s * channels;
  const int len = s * channels;
  for (int e = threadIdx.x; e < len; e += 32) {
    const int j = e / channels, ch = e - j * channels;
    const Taps tx = taps(x_lo, x_hi, j, inv_s, w);
    const int l = tx.a * channels + ch, r = tx.b * channels + ch;
    const float left = vy * __ldg(top + l) + ty.w * __ldg(bot + l);
    const float right = vy * __ldg(top + r) + ty.w * __ldg(bot + r);
    o[e] = (1.f - tx.w) * left + tx.w * right;
  }
}

}  // namespace

// src [b, h, w, channels] f32, boxes [b, k, 4] f32 (x1, y1, x2, y2) ->
// out [b, k, s, s, channels] f32. Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int crop_resize_launch(const float* src, const float* boxes,
                                  int b, int k, int h, int w, int channels,
                                  int s, float* out, void* stream) {
  if (b < 1 || k < 1 || h < 1 || w < 1 || channels < 1 || s < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = (long long)b * k * s;
  if (rows > INT_MAX - ROWS || (long long)s * channels > INT_MAX - 32 ||
      (long long)w * channels > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const float inv_s = 1.f / (float)s;
  const dim3 block(32, ROWS);
  const unsigned blocks = (unsigned)((rows + ROWS - 1) / ROWS);
  if (channels == 3) {
    crop_resize_kernel<3><<<blocks, block, 0, (cudaStream_t)stream>>>(
        src, boxes, k, h, w, channels, s, (int)rows, inv_s, out);
  } else {
    crop_resize_kernel<0><<<blocks, block, 0, (cudaStream_t)stream>>>(
        src, boxes, k, h, w, channels, s, (int)rows, inv_s, out);
  }
  return (int)cudaGetLastError();
}
