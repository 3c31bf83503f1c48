// The geometry, input addressing and helpers of one 16x16 tile of MTCNN
// P-Net head cells, shared by the tensor-core tile (pnet_tile_mma.cuh) and
// the kernels that launch it (pnet_pyramid.cu, pnet_level.cu).
//
//   conv3x3 3->10 + PReLU -> 2x2/s2 max pool (flax 'SAME': a ragged high
//   edge pools a one-element window) -> conv3x3 10->16 + PReLU ->
//   conv3x3 16->32 + PReLU -> 1x1 heads (2 logits + 4 box offsets)
//
// A block computes the tile from a 42x42x3 input patch: the 20x20 pooled
// tile, the 18x18 conv2 tile and the 16x16 head cells (the halo costs 1.56x
// on the pooled tile and 1.27x on conv2). The input is addressed through
// element strides, so a caller may hand in NCHW planes, planes with a row
// pitch wider than the image, or NHWC pixels; nothing at or beyond (sh, sw)
// is read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pnet {

constexpr int THREADS = 256;
constexpr int TILE = 16;                   // head cells per tile side
constexpr int C2_SIDE = TILE + 2;          // conv2 tile side (18)
constexpr int POOL_SIDE = TILE + 4;        // pooled tile side (20)
constexpr int IN_SIDE = 2 * POOL_SIDE + 2; // input patch side (42)

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float prelu(float z, float alpha) {
  return z >= 0.f ? z : alpha * z;
}

}  // namespace pnet
