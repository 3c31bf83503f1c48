// One 16x16 tile of MTCNN P-Net head cells, computed by one thread block:
// the device code shared by the whole-pyramid kernel (pnet_pyramid.cu) and
// the one-level kernels (pnet_level.cu).
//
//   conv3x3 3->10 + PReLU -> 2x2/s2 max pool (flax 'SAME': a ragged high
//   edge pools a one-element window) -> conv3x3 10->16 + PReLU ->
//   conv3x3 16->32 + PReLU -> 1x1 heads (2 logits + 4 box offsets)
//
// Arithmetic: bf16 inputs, the weights as the packed float32 vector gives
// them (the host decides whether they were rounded to bf16), float32 sums,
// float32 bias and PReLU, activations rounded to bf16 after each PReLU,
// float32 heads. The input is addressed through element strides, so a
// caller may hand in NCHW planes, planes with a row pitch wider than the
// image, or NHWC pixels; nothing at or beyond (sh, sw) is read.
//
// A block stages its 42x42x3 input patch and the packed weights in shared
// memory, computes conv1 straight into the 20x20x10 pooled tile (each
// conv1 cell belongs to exactly one pool window), then the 18x18x16 conv2
// tile (over the dead input patch), and each thread finishes one head cell
// from conv2 with its 32 conv3 sums in registers. Weights are read as
// warp-wide broadcasts. The halo costs 1.56x on the pooled tile and 1.27x
// on conv2; the CUDA cores do the work in float32, not the tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pnet {

constexpr int THREADS = 256;
constexpr int TILE = 16;                   // head cells per tile side
constexpr int C2_SIDE = TILE + 2;          // conv2 tile side (18)
constexpr int POOL_SIDE = TILE + 4;        // pooled tile side (20)
constexpr int IN_SIDE = 2 * POOL_SIDE + 2; // input patch side (42)

// packed weight layout (float32), mirrored by detectors/mtcnn/pnet.py;
// conv kernels are [ci][ky][kx][co], the heads [32][6]
constexpr int OFF_W1 = 0;       // 3*9*10 = 270
constexpr int OFF_B1 = 272;
constexpr int OFF_A1 = 284;
constexpr int OFF_W2 = 296;     // 10*9*16 = 1440
constexpr int OFF_B2 = 1736;
constexpr int OFF_A2 = 1752;
constexpr int OFF_W3 = 1768;    // 16*9*32 = 4608
constexpr int OFF_B3 = 6376;
constexpr int OFF_A3 = 6408;
constexpr int OFF_WH = 6440;    // 32*6 = 192
constexpr int OFF_BH = 6632;
constexpr int N_WEIGHTS = 6640;

constexpr int IN_FLOATS = 3 * IN_SIDE * IN_SIDE;           // 5292
constexpr int C2_FLOATS = 16 * C2_SIDE * C2_SIDE;          // 5184
constexpr int POOL_FLOATS = 10 * POOL_SIDE * POOL_SIDE;    // 4000
constexpr int A_FLOATS = IN_FLOATS > C2_FLOATS ? IN_FLOATS : C2_FLOATS;
constexpr int SMEM_BYTES = (N_WEIGHTS + A_FLOATS + POOL_FLOATS) * 4;

// One image of one level: element (c, y, x) is the bf16 at
// base[c * stride_c + y * stride_y + x * stride_x], for y < sh and x < sw.
struct TileInput {
  const unsigned short* base;
  int stride_c, stride_y, stride_x;
  int sh, sw;
};

// head grid of an (sh, sw) level: ceil((s - 2) / 2) - 4 cells a side
__host__ __device__ __forceinline__ int head_side(int s) {
  return (s - 1) / 2 - 4;
}

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float(((unsigned int)u) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float prelu(float z, float alpha) {
  return z >= 0.f ? z : alpha * z;
}

// The tile of head cells [gy0, gy0 + 16) x [gx0, gx0 + 16) of one image.
// `first_cell` is the image's first cell in the output arrays (image index
// times gh * gw). RAW = false writes the face probability (2-way softmax)
// to probs[cell] and the 4 box offsets to heads[4 * cell]; RAW = true
// writes the 6 head outputs before any softmax to heads[6 * cell].
// `smem` is SMEM_BYTES of dynamic shared memory; every thread of the block
// must call this function (it synchronizes the block).
template <bool RAW>
__device__ __forceinline__ void pnet_tile(
    float* smem, const float* __restrict__ weights, const TileInput& in,
    int gy0, int gx0, int gh, int gw, float* probs, float* heads,
    size_t first_cell) {
  float* s_w = smem;
  float* s_in = smem + N_WEIGHTS;      // [3][42][42], later s_c2 [16][18][18]
  float* s_c2 = s_in;
  float* s_pool = s_in + A_FLOATS;     // [10][20][20]

  const int sh = in.sh, sw = in.sw;
  const int h1 = sh - 2, w1 = sw - 2;            // conv1 extent
  const int hp = (h1 + 1) / 2, wp = (w1 + 1) / 2; // pooled extent
  const int tid = threadIdx.x;

  // ---- stage 0: weights and the input patch (zero beyond the level)
  for (int i = tid; i < N_WEIGHTS; i += THREADS) s_w[i] = weights[i];
  const int iy0 = 2 * gy0, ix0 = 2 * gx0;
  for (int i = tid; i < IN_FLOATS; i += THREADS) {
    const int c = i / (IN_SIDE * IN_SIDE);
    const int rem = i - c * IN_SIDE * IN_SIDE;
    const int y = iy0 + rem / IN_SIDE, x = ix0 + rem % IN_SIDE;
    s_in[i] = (y < sh && x < sw)
                  ? bf16_bits(in.base[(size_t)c * in.stride_c +
                                      (size_t)y * in.stride_y +
                                      (size_t)x * in.stride_x])
                  : 0.f;
  }
  __syncthreads();

  // ---- stage 1: conv1 + PReLU + bf16, pooled 2x2/s2 into s_pool
  for (int cell = tid; cell < POOL_SIDE * POOL_SIDE; cell += THREADS) {
    const int pr = cell / POOL_SIDE, pq = cell % POOL_SIDE;
    const int py = gy0 + pr, px = gx0 + pq;
    float pooled[10];
    if (py >= hp || px >= wp) {
#pragma unroll
      for (int o = 0; o < 10; ++o) pooled[o] = 0.f;  // feeds no valid output
    } else {
      float patch[3][4][4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int dy = 0; dy < 4; ++dy)
#pragma unroll
          for (int dx = 0; dx < 4; ++dx)
            patch[c][dy][dx] =
                s_in[(c * IN_SIDE + 2 * pr + dy) * IN_SIDE + 2 * pq + dx];
#pragma unroll
      for (int o = 0; o < 10; ++o) pooled[o] = -INFINITY;
#pragma unroll
      for (int sy = 0; sy < 2; ++sy) {
#pragma unroll
        for (int sx = 0; sx < 2; ++sx) {
          // SAME pooling pads -inf past the conv1 edge; 2py < h1 always,
          // so every pooled cell has at least its (0, 0) tap
          if (2 * py + sy >= h1 || 2 * px + sx >= w1) continue;
          float acc[10];
#pragma unroll
          for (int o = 0; o < 10; ++o) acc[o] = s_w[OFF_B1 + o];
#pragma unroll
          for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                const float v = patch[c][sy + ky][sx + kx];
                const float* w = s_w + OFF_W1 + ((c * 3 + ky) * 3 + kx) * 10;
#pragma unroll
                for (int o = 0; o < 10; ++o) acc[o] = fmaf(w[o], v, acc[o]);
              }
#pragma unroll
          for (int o = 0; o < 10; ++o)
            pooled[o] = fmaxf(pooled[o],
                              round_bf16(prelu(acc[o], s_w[OFF_A1 + o])));
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 10; ++o)
      s_pool[(o * POOL_SIDE + pr) * POOL_SIDE + pq] = pooled[o];
  }
  __syncthreads();

  // ---- stage 2: conv2 + PReLU + bf16 into s_c2 (over the dead patch)
  for (int cell = tid; cell < C2_SIDE * C2_SIDE; cell += THREADS) {
    const int r = cell / C2_SIDE, q = cell % C2_SIDE;
    float acc[16];
#pragma unroll
    for (int o = 0; o < 16; ++o) acc[o] = s_w[OFF_B2 + o];
    for (int c = 0; c < 10; ++c)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v = s_pool[(c * POOL_SIDE + r + ky) * POOL_SIDE + q + kx];
          const float4* w = reinterpret_cast<const float4*>(
              s_w + OFF_W2 + ((c * 3 + ky) * 3 + kx) * 16);
#pragma unroll
          for (int o4 = 0; o4 < 4; ++o4) {
            const float4 wv = w[o4];
            acc[4 * o4 + 0] = fmaf(wv.x, v, acc[4 * o4 + 0]);
            acc[4 * o4 + 1] = fmaf(wv.y, v, acc[4 * o4 + 1]);
            acc[4 * o4 + 2] = fmaf(wv.z, v, acc[4 * o4 + 2]);
            acc[4 * o4 + 3] = fmaf(wv.w, v, acc[4 * o4 + 3]);
          }
        }
#pragma unroll
    for (int o = 0; o < 16; ++o)
      s_c2[(o * C2_SIDE + r) * C2_SIDE + q] =
          round_bf16(prelu(acc[o], s_w[OFF_A2 + o]));
  }
  __syncthreads();

  // ---- stage 3: conv3 + PReLU + bf16, heads; one cell a thread
  const int r = tid / TILE, q = tid % TILE;
  const int gy = gy0 + r, gx = gx0 + q;
  if (gy >= gh || gx >= gw) return;
  float acc[32];
#pragma unroll
  for (int o = 0; o < 32; ++o) acc[o] = s_w[OFF_B3 + o];
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float v = s_c2[(c * C2_SIDE + r + ky) * C2_SIDE + q + kx];
        const float4* w = reinterpret_cast<const float4*>(
            s_w + OFF_W3 + ((c * 3 + ky) * 3 + kx) * 32);
#pragma unroll
        for (int o4 = 0; o4 < 8; ++o4) {
          const float4 wv = w[o4];
          acc[4 * o4 + 0] = fmaf(wv.x, v, acc[4 * o4 + 0]);
          acc[4 * o4 + 1] = fmaf(wv.y, v, acc[4 * o4 + 1]);
          acc[4 * o4 + 2] = fmaf(wv.z, v, acc[4 * o4 + 2]);
          acc[4 * o4 + 3] = fmaf(wv.w, v, acc[4 * o4 + 3]);
        }
      }
  float z[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) z[j] = s_w[OFF_BH + j];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float a = round_bf16(prelu(acc[k], s_w[OFF_A3 + k]));
#pragma unroll
    for (int j = 0; j < 6; ++j) z[j] = fmaf(s_w[OFF_WH + k * 6 + j], a, z[j]);
  }
  const size_t cell = first_cell + (size_t)gy * gw + gx;
  if constexpr (RAW) {
    float2* out = reinterpret_cast<float2*>(heads + 6 * cell);
    out[0] = make_float2(z[0], z[1]);
    out[1] = make_float2(z[2], z[3]);
    out[2] = make_float2(z[4], z[5]);
  } else {
    const float m = fmaxf(z[0], z[1]);
    const float e0 = expf(z[0] - m), e1 = expf(z[1] - m);
    probs[cell] = e1 / (e0 + e1);
    float4 box;
    box.x = z[2]; box.y = z[3]; box.z = z[4]; box.w = z[5];
    reinterpret_cast<float4*>(heads)[cell] = box;
  }
}

}  // namespace pnet
