// MTCNN P-Net on ONE pyramid level, three entry points over the tile code of
// pnet_tile.cuh (the network, its arithmetic and its shared-memory design
// are described there). One block per (image, 16x16 tile of head cells).
//
//   pnet_flat_launch (B4) replaces the Pallas TPU kernel
//     facenet_tpu/detectors/mtcnn/pallas_pnet.py::_make_v3_kernel (entry
//     pnet_forward_flat): bf16 planes [B, 3, sh * pitch] whose rows are
//     `pitch` elements apart with only the first `true_sw` of them real.
//     The kernel reads no column at or beyond true_sw, so what a caller
//     left there reaches no output. Face probability (2-way softmax) and
//     box offsets out.
//   pnet_level_launch (B6) replaces pallas_pnet.py::_make_kernel (entry
//     pnet_forward_pallas): contiguous bf16 NCHW [B, 3, sh, sw], softmax in
//     the kernel. It differs from B4 by its weights alone: the caller packs
//     them unrounded.
//   pnet_trunk_nhwc_launch (B7) replaces tools/try_pnet_v3.py::make_kernel
//     (entry pnet_v3): bf16 NHWC pixels [B, sh, sw, 3] read in place through
//     their strides, the six head outputs before any softmax out,
//     [B, gh, gw, 6] float32.
//
// What bounds them on the card: operations, as for the whole-pyramid
// kernel (a 288x384 level is 0.39 GFLOP per image against 0.66 MB of
// planes). Nothing leaves the chip between the input patch and the heads.

#include "pnet_tile.cuh"

namespace {

using namespace pnet;

struct Grid {
  int gh, gw, tiles_x, tiles;
};

__device__ __forceinline__ void block_tile(const Grid& g, int* img, int* gy0,
                                           int* gx0) {
  *img = blockIdx.x / g.tiles;
  const int tile = blockIdx.x % g.tiles;
  *gy0 = (tile / g.tiles_x) * TILE;
  *gx0 = (tile % g.tiles_x) * TILE;
}

__global__ void __launch_bounds__(THREADS)
pnet_flat_kernel(const unsigned short* __restrict__ planes, int sh, int pitch,
                 int true_sw, Grid g, const float* __restrict__ weights,
                 float* __restrict__ probs, float* __restrict__ reg) {
  extern __shared__ float smem[];
  int img, gy0, gx0;
  block_tile(g, &img, &gy0, &gx0);
  TileInput in;
  in.base = planes + (size_t)img * 3 * sh * pitch;
  in.stride_c = sh * pitch;
  in.stride_y = pitch;
  in.stride_x = 1;
  in.sh = sh;
  in.sw = true_sw;
  pnet_tile<false>(smem, weights, in, gy0, gx0, g.gh, g.gw, probs, reg,
                   (size_t)img * g.gh * g.gw);
}

__global__ void __launch_bounds__(THREADS)
pnet_level_kernel(const unsigned short* __restrict__ x, int sh, int sw, Grid g,
                  const float* __restrict__ weights,
                  float* __restrict__ probs, float* __restrict__ reg) {
  extern __shared__ float smem[];
  int img, gy0, gx0;
  block_tile(g, &img, &gy0, &gx0);
  TileInput in;
  in.base = x + (size_t)img * 3 * sh * sw;
  in.stride_c = sh * sw;
  in.stride_y = sw;
  in.stride_x = 1;
  in.sh = sh;
  in.sw = sw;
  pnet_tile<false>(smem, weights, in, gy0, gx0, g.gh, g.gw, probs, reg,
                   (size_t)img * g.gh * g.gw);
}

__global__ void __launch_bounds__(THREADS)
pnet_trunk_nhwc_kernel(const unsigned short* __restrict__ x, int sh, int sw,
                       Grid g, const float* __restrict__ weights,
                       float* __restrict__ heads) {
  extern __shared__ float smem[];
  int img, gy0, gx0;
  block_tile(g, &img, &gy0, &gx0);
  TileInput in;
  in.base = x + (size_t)img * sh * sw * 3;
  in.stride_c = 1;
  in.stride_y = sw * 3;
  in.stride_x = 3;
  in.sh = sh;
  in.sw = sw;
  pnet_tile<true>(smem, weights, in, gy0, gx0, g.gh, g.gw, nullptr, heads,
                  (size_t)img * g.gh * g.gw);
}

// The head grid and block count of a batch of (sh, sw) levels whose rows
// are `pitch` elements apart; false when the kernels do not take them.
bool plan(int batch, int sh, int sw, int pitch, int n_weights, Grid* g,
          unsigned* blocks) {
  if (batch < 1 || n_weights != N_WEIGHTS || pitch < sw) return false;
  g->gh = head_side(sh);
  g->gw = head_side(sw);
  if (g->gh < 1 || g->gw < 1) return false;
  if (3LL * sh * pitch > 2147483647LL) return false;
  g->tiles_x = (g->gw + TILE - 1) / TILE;
  g->tiles = g->tiles_x * ((g->gh + TILE - 1) / TILE);
  const long long n = (long long)batch * g->tiles;
  if (n > 2147483647LL) return false;
  *blocks = (unsigned)n;
  return true;
}

// The shared-memory opt-in applies to the current device only, so it is
// set on every launch (a cheap host call) rather than once per process.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace

// Each function launches on `stream` and returns the cudaError_t of the
// launch (0 on success); weights are the packed float32 vector on the card.

extern "C" int pnet_flat_launch(const void* planes, int batch, int sh,
                                int pitch, int true_sw, const float* weights,
                                int n_weights, float* probs, float* reg,
                                void* stream) {
  Grid g;
  unsigned blocks;
  if (!plan(batch, sh, true_sw, pitch, n_weights, &g, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = opt_in(pnet_flat_kernel);
  if (err != cudaSuccess) return (int)err;
  pnet_flat_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const unsigned short*>(planes), sh, pitch, true_sw, g,
      weights, probs, reg);
  return (int)cudaGetLastError();
}

extern "C" int pnet_level_launch(const void* x, int batch, int sh, int sw,
                                 const float* weights, int n_weights,
                                 float* probs, float* reg, void* stream) {
  Grid g;
  unsigned blocks;
  if (!plan(batch, sh, sw, sw, n_weights, &g, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = opt_in(pnet_level_kernel);
  if (err != cudaSuccess) return (int)err;
  pnet_level_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const unsigned short*>(x), sh, sw, g, weights, probs, reg);
  return (int)cudaGetLastError();
}

extern "C" int pnet_trunk_nhwc_launch(const void* x, int batch, int sh, int sw,
                                      const float* weights, int n_weights,
                                      float* heads, void* stream) {
  Grid g;
  unsigned blocks;
  if (!plan(batch, sh, sw, sw, n_weights, &g, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = opt_in(pnet_trunk_nhwc_kernel);
  if (err != cudaSuccess) return (int)err;
  pnet_trunk_nhwc_kernel<<<blocks, THREADS, SMEM_BYTES,
                           (cudaStream_t)stream>>>(
      static_cast<const unsigned short*>(x), sh, sw, g, weights, heads);
  return (int)cudaGetLastError();
}
