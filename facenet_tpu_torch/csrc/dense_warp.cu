// Dense affine warp (B2): batched bilinear warp of small crops of C channels.
//
// Replaces the Pallas TPU kernel facenet_tpu/ops/pallas_warp.py::_warp_kernel
// (entry dense_warp_pallas). For crop n and output pixel (x, y):
//
//   sx = clamp(m00 x + m01 y + m02, 0, W - 1)
//   sy = clamp(m10 x + m11 y + m12, 0, H - 1)
//   out[n, y, x, c] = the two-tap bilinear sample of src[n] at (sy, sx)
//
// Clamping the coords is the edge-replicate of image_ops._bilinear_sample:
// the dense weights relu(1 - |h - sy|) the TPU kernel builds against an
// iota are nonzero only on floor(sy) and floor(sy) + 1, which is what this
// kernel reads directly.
//
// What bounds it on the card: bytes. Each output pixel does ~10 flops per
// channel on 4 loads per channel that hit L1/L2 (neighbouring threads read
// neighbouring source pixels), so the floor is one read of the source
// pixels the taps touch plus one write of the crops at HBM rate. The
// design: one thread per output pixel, all B x K crops of a batch in one
// launch (a run of blocks per crop), pixels in row-major order so that a
// warp writes contiguous runs of C-float pixels. The landmark alignment
// calls it with C = 3; other channel counts take the same kernel. The TPU
// kernel rounded the source and the row weights to bf16 for its MXU
// product; the card has no such need, so this kernel samples the float32
// source in float32.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dense_warp_kernel(const float* __restrict__ src, const float* __restrict__ mats,
                  int h, int w, int channels, int oh, int ow,
                  int blocks_per_crop, float* __restrict__ out) {
  const int n = blockIdx.x / blocks_per_crop;
  const int p = (blockIdx.x % blocks_per_crop) * THREADS + threadIdx.x;
  if (p >= oh * ow) return;
  const float x = (float)(p % ow);
  const float y = (float)(p / ow);
  const float* m = mats + 6 * n;
  // explicit roundings, no fused multiply-add: the source coords are then
  // bit-identical to the plain version's, whose error they would amplify
  // by the image gradient (up to 255 per pixel)
  const float ax = __fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y));
  const float ay = __fadd_rn(__fmul_rn(m[3], x), __fmul_rn(m[4], y));
  const float sx = fminf(fmaxf(__fadd_rn(ax, m[2]), 0.f), w - 1.f);
  const float sy = fminf(fmaxf(__fadd_rn(ay, m[5]), 0.f), h - 1.f);
  const float fy = floorf(sy), fx = floorf(sx);
  const float wy = sy - fy, wx = sx - fx;
  const int y0 = (int)fy, x0 = (int)fx;
  const int y1 = min(y0 + 1, h - 1), x1 = min(x0 + 1, w - 1);

  const float* img = src + (size_t)n * h * w * channels;
  const float* r0 = img + (size_t)y0 * w * channels;
  const float* r1 = img + (size_t)y1 * w * channels;
  const int c0 = x0 * channels, c1 = x1 * channels;
  float* o = out + ((size_t)n * oh * ow + p) * channels;
  for (int c = 0; c < channels; ++c) {
    const float top = r0[c0 + c] * (1.f - wx) + r0[c1 + c] * wx;
    const float bot = r1[c0 + c] * (1.f - wx) + r1[c1 + c] * wx;
    o[c] = top * (1.f - wy) + bot * wy;
  }
}

}  // namespace

// src [n, h, w, channels] f32, mats [n, 2, 3] f32 -> out [n, oh, ow, channels]
// f32. Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).
extern "C" int dense_warp_launch(const float* src, const float* mats, int n,
                                 int h, int w, int channels, int oh, int ow,
                                 float* out, void* stream) {
  if (n < 1 || h < 1 || w < 1 || channels < 1 || oh < 1 || ow < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks_per_crop = (oh * ow + THREADS - 1) / THREADS;
  const long long blocks = (long long)blocks_per_crop * n;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dense_warp_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      src, mats, h, w, channels, oh, ow, blocks_per_crop, out);
  return (int)cudaGetLastError();
}
