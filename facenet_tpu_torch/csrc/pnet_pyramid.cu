// Whole-pyramid MTCNN P-Net (B3): every pyramid level of a batch in one
// launch.
//
// Replaces the Pallas TPU kernel
// facenet_tpu/detectors/mtcnn/pallas_pnet.py::_make_v4_kernel (entry
// pnet_forward_pyramid). Per level, on bf16 NCHW planes [B, 3, sh, sw], the
// network of pnet_tile_mma.cuh followed by a 2-way softmax, into probs
// [B, gh, gw] and reg [B, gh, gw, 4] float32, gh = ceil((sh - 2) / 2) - 4.
// Arithmetic follows the TPU kernel: bf16 weights and inputs, float32 sums,
// float32 bias and PReLU, activations rounded to bf16 after each PReLU,
// float32 heads and softmax.
//
// What bounds it on the card: operations. A 480x640 pyramid is about 0.76
// GFLOP per image against 1.7 MB of bf16 planes, far above the card's
// operations-per-byte balance point. The design keeps every intermediate
// on chip: one block per (image, level, 16x16 tile of head cells), the
// tiles of all levels decoded from one linear block index through a
// per-level table passed by value (a __grid_constant__ parameter, indexed
// in place). What a block does with its tile is pnet_tile_mma.cuh: the
// convs as implicit GEMMs on the tensor cores.

#include "pnet_tile_mma.cuh"

namespace {

using namespace pnet;

constexpr int MAX_LEVELS = 24;

struct Level {
  const unsigned short* in;  // bf16 bits, [B, 3, sh, sw]
  float* probs;              // [B, gh, gw]
  float* reg;                // [B, gh, gw, 4]
  int sh, sw, gh, gw;
  int tiles_x, tiles, block_start, pad;
};

struct Pyramid {
  Level level[MAX_LEVELS];
  int n_levels;
};

__global__ void __launch_bounds__(THREADS, 3)
pnet_pyramid_kernel(const __grid_constant__ Pyramid pyr,
                    const unsigned short* __restrict__ weights) {
  extern __shared__ __align__(16) unsigned char smem[];

  // ---- which (level, image, tile) this block computes
  const int bid = blockIdx.x;
  int l = 0;
  while (l + 1 < pyr.n_levels && pyr.level[l + 1].block_start <= bid) ++l;
  const Level& lv = pyr.level[l];
  const int local = bid - lv.block_start;
  const int img = local / lv.tiles;
  const int tile = local % lv.tiles;
  const int gy0 = (tile / lv.tiles_x) * TILE;
  const int gx0 = (tile % lv.tiles_x) * TILE;

  TileInput in;
  in.base = lv.in + (size_t)img * 3 * lv.sh * lv.sw;
  in.stride_c = lv.sh * lv.sw;
  in.stride_y = lv.sw;
  in.stride_x = 1;
  in.sh = lv.sh;
  in.sw = lv.sw;
  tc::pnet_tile_mma<tc::OUT_PROBS>(smem, weights, in, gy0, gx0, lv.gh,
                                   lv.gw, lv.probs, lv.reg,
                                   (size_t)img * lv.gh * lv.gw);
}

}  // namespace

// table: n_levels rows of 7 int64 values (input pointer, probs pointer, reg
// pointer, sh, sw, gh, gw), in host memory; weights: the tensor-core tile's
// packed weights on the card (n_weights = tc::N_HALFS 16-bit values, 16-byte
// aligned). Launches on `stream`; returns the cudaError_t of the launch (0
// on success).
extern "C" int pnet_pyramid_launch(const long long* table, int n_levels,
                                   int batch, const void* weights,
                                   int n_weights, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || batch < 1 ||
      n_weights != tc::N_HALFS) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr;
  long long blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    const long long* row = table + 7 * l;
    Level& lv = pyr.level[l];
    lv.in = reinterpret_cast<const unsigned short*>(row[0]);
    lv.probs = reinterpret_cast<float*>(row[1]);
    lv.reg = reinterpret_cast<float*>(row[2]);
    lv.sh = (int)row[3];
    lv.sw = (int)row[4];
    lv.gh = (int)row[5];
    lv.gw = (int)row[6];
    if (lv.gh < 1 || lv.gw < 1 || lv.gh != head_side(lv.sh) ||
        lv.gw != head_side(lv.sw) ||
        3LL * lv.sh * lv.sw > 2147483647LL) {
      return (int)cudaErrorInvalidValue;
    }
    lv.tiles_x = (lv.gw + TILE - 1) / TILE;
    lv.tiles = lv.tiles_x * ((lv.gh + TILE - 1) / TILE);
    lv.block_start = (int)blocks;
    lv.pad = 0;
    blocks += (long long)batch * lv.tiles;
  }
  pyr.n_levels = n_levels;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;

  // the opt-in applies to the current device only, so it is set on every
  // launch (a cheap host call) rather than once per process
  const cudaError_t err = cudaFuncSetAttribute(
      pnet_pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  pnet_pyramid_kernel<<<(unsigned)blocks, THREADS, tc::SMEM_BYTES,
                        (cudaStream_t)stream>>>(
      pyr, static_cast<const unsigned short*>(weights));
  return (int)cudaGetLastError();
}
