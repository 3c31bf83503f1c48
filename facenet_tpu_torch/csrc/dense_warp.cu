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
// kernel reads directly. The TPU kernel rounded the source and the row
// weights to bf16 for its MXU product; the card has no such need, so this
// kernel samples the float32 source in float32.
//
// What bounds it on the card: bytes (~10 flops per channel on 4 taps): one
// read of the source pixels the taps touch and one write of the crops. At
// the landmark alignment's size (32 crops, 26 MB) a launch also pays a
// ramp: a float4 copy of the same bytes takes 1.6x the bound. The design,
// as measured on the H100 (PERF.md; tools/try_dense_warp.py):
//  - one thread per output pixel in 2-D blocks of 16 x 8 pixels, one block
//    per tile and many blocks an SM (32 registers), so that the taps of a
//    block are a compact footprint that L1 serves, and blocks at different
//    phases overlap reads with writes. Staging each tile's footprint in
//    shared memory with cp.async on a persistent grid was slower: the
//    bounding boxes of turned tiles copy ~1.8x the pixels the taps read,
//    and two items a block leave reads and writes in separate phases;
//    walking the tiles with 4 or 8 blocks an SM lost the overlap too;
//  - the block's 3-channel pixels go to shared memory and leave as whole
//    16-byte pieces of output rows, so a warp writes whole sectors (12-byte
//    scalar stores alone took 2.2x the time of float4 stores of the same
//    bytes). Other channel counts store directly, one float at a time.
// The source coords are computed with explicit roundings and no fused
// multiply-add, bit-identical to the plain version's, whose error they
// would amplify by the image gradient (up to 255 per pixel).

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 16;                 // output pixels of a block
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;   // one per output pixel
constexpr int ROW_PIECES = TILE_W * 3 / 4; // float4s in a tile row, C = 3

// m[0] x + m[1] y + m[2], rounded after each operation
__device__ __forceinline__ float source_coord(const float* m, float x,
                                              float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y)), m[2]);
}

__device__ __forceinline__ float clamp_to(float v, int n) {
  return fminf(fmaxf(v, 0.f), n - 1.f);
}

// C = 3: the landmark alignment's crops, stored through shared memory;
// C = 0: any channel count `c`, stored directly
template <int C>
__global__ void __launch_bounds__(THREADS)
dense_warp_kernel(const float* __restrict__ src,
                  const float* __restrict__ mats, int h, int w, int c,
                  int oh, int ow, int tiles_x, int per_crop,
                  float* __restrict__ out) {
  __shared__ __align__(16) float tile[C == 3 ? THREADS * 3 : 1];
  const int channels = C > 0 ? C : c;
  const int n = blockIdx.x / per_crop;
  const int rem = blockIdx.x - n * per_crop;
  const int ty = rem / tiles_x;
  const int x0 = (rem - ty * tiles_x) * TILE_W, y0 = ty * TILE_H;
  const int lx = threadIdx.x % TILE_W, ly = threadIdx.x / TILE_W;
  const int x = x0 + lx, y = y0 + ly;

  if (x < ow && y < oh) {
    float m[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) m[k] = __ldg(mats + 6 * n + k);
    const float sx = clamp_to(source_coord(m, (float)x, (float)y), w);
    const float sy = clamp_to(source_coord(m + 3, (float)x, (float)y), h);
    const float fy = floorf(sy), fx = floorf(sx);
    const float wy = sy - fy, wx = sx - fx;
    const int ya = (int)fy, xa = (int)fx;
    const int yb = min(ya + 1, h - 1), xb = min(xa + 1, w - 1);

    const float* img = src + (long long)n * h * w * channels;
    const float* p00 = img + ((long long)ya * w + xa) * channels;
    const float* p01 = img + ((long long)ya * w + xb) * channels;
    const float* p10 = img + ((long long)yb * w + xa) * channels;
    const float* p11 = img + ((long long)yb * w + xb) * channels;
    float* o = out + ((long long)(n * oh + y) * ow + x) * channels;
#pragma unroll
    for (int ch = 0; ch < channels; ++ch) {
      const float top = __ldg(p00 + ch) * (1.f - wx) + __ldg(p01 + ch) * wx;
      const float bot = __ldg(p10 + ch) * (1.f - wx) + __ldg(p11 + ch) * wx;
      const float v = top * (1.f - wy) + bot * wy;
      if (C == 3) {
        tile[threadIdx.x * 3 + ch] = v;
      } else {
        o[ch] = v;
      }
    }
  }
  if (C != 3) return;

  // the tile's rows: whole float4 pieces where the row is whole and starts
  // on 16 bytes, single floats elsewhere
  __syncthreads();
  const int pixels = min(TILE_W, ow - x0);
  for (int i = threadIdx.x; i < TILE_H * ROW_PIECES; i += THREADS) {
    const int r = i / ROW_PIECES, q = i - r * ROW_PIECES;
    if (y0 + r >= oh) break;
    const long long first = ((long long)(n * oh + y0 + r) * ow + x0) * 3;
    const float* s = tile + r * TILE_W * 3 + 4 * q;
    if (pixels == TILE_W && (first & 3) == 0) {
      *reinterpret_cast<float4*>(out + first + 4 * q) =
          make_float4(s[0], s[1], s[2], s[3]);
    } else {
      for (int k = 0; k < 4 && 4 * q + k < pixels * 3; ++k)
        out[first + 4 * q + k] = s[k];
    }
  }
}

}  // namespace

// src [n, h, w, channels] f32, mats [n, 2, 3] f32 -> out [n, oh, ow,
// channels] f32 (starting on 16 bytes). Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int dense_warp_launch(const float* src, const float* mats, int n,
                                 int h, int w, int channels, int oh, int ow,
                                 float* out, void* stream) {
  if (n < 1 || h < 1 || w < 1 || channels < 1 || oh < 1 || ow < 1 ||
      (reinterpret_cast<unsigned long long>(out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_x = (ow + TILE_W - 1) / TILE_W;
  const long long per_crop = (long long)tiles_x * ((oh + TILE_H - 1) / TILE_H);
  if (per_crop * n > 2147483647LL || (long long)n * oh * ow > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)(per_crop * n);
  if (channels == 3) {
    dense_warp_kernel<3><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        src, mats, h, w, channels, oh, ow, tiles_x, (int)per_crop, out);
  } else {
    dense_warp_kernel<0><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        src, mats, h, w, channels, oh, ow, tiles_x, (int)per_crop, out);
  }
  return (int)cudaGetLastError();
}
