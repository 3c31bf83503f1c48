// MTCNN P-Net on ONE pyramid level, three entry points over the tensor-core
// tile of pnet_tile_mma.cuh (the network, its arithmetic and the
// shared-memory design are described there). One block per (image, 16x16
// tile of head cells).
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
//     the kernel. Its weights are float32 values that no one rounded to
//     bf16; the tile multiplies them exactly as three bf16 parts each (three
//     mma a depth step, each step summed from zero and added outside the
//     tensor core), so its bound is the bf16 tensor-core rate times three.
//   pnet_trunk_nhwc_launch (B7) replaces tools/try_pnet_v3.py::make_kernel
//     (entry pnet_v3): bf16 NHWC pixels [B, sh, sw, 3] read in place through
//     their strides, the six head outputs before any softmax out,
//     [B, gh, gw, 6] float32.
//
// pnet_level_sums_launch serves a measurement of B6's design only: it
// writes conv3's sums and the conv2 tiles they came from (the accuracy
// probe, with the three mma of a step chained on the accumulator or summed
// from zero, tools/try_pallas_pnet.py::conv_sum_errors).
//
// What bounds them on the card: operations, as for the whole-pyramid
// kernel (a 288x384 level is 0.39 GFLOP per image against 0.66 MB of
// planes). Nothing leaves the chip between the input patch and the heads.

#include "pnet_tile_mma.cuh"

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

__global__ void __launch_bounds__(THREADS, 3)
pnet_flat_kernel(const unsigned short* __restrict__ planes, int sh, int pitch,
                 int true_sw, Grid g,
                 const unsigned short* __restrict__ weights,
                 float* __restrict__ probs, float* __restrict__ reg) {
  extern __shared__ __align__(16) unsigned char smem[];
  int img, gy0, gx0;
  block_tile(g, &img, &gy0, &gx0);
  TileInput in;
  in.base = planes + (size_t)img * 3 * sh * pitch;
  in.stride_c = sh * pitch;
  in.stride_y = pitch;
  in.stride_x = 1;
  in.sh = sh;
  in.sw = true_sw;
  tc::pnet_tile_mma<tc::OUT_PROBS>(smem, weights, in, gy0, gx0, g.gh, g.gw,
                                   probs, reg, (size_t)img * g.gh * g.gw);
}

// One block of a contiguous NCHW level with the packed vector of PARTS
// parts (B6 and its accuracy probe).
template <int OUT, int PARTS, bool CHAINED>
__device__ __forceinline__ void level_block(
    const unsigned short* __restrict__ x, int sh, int sw, const Grid& g,
    const unsigned short* __restrict__ weights, float* probs, float* heads,
    unsigned short* c2_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int img, gy0, gx0;
  block_tile(g, &img, &gy0, &gx0);
  TileInput in;
  in.base = x + (size_t)img * 3 * sh * sw;
  in.stride_c = sh * sw;
  in.stride_y = sw;
  in.stride_x = 1;
  in.sh = sh;
  in.sw = sw;
  tc::pnet_tile_mma<OUT, PARTS, CHAINED>(
      smem, weights, in, gy0, gx0, g.gh, g.gw, probs, heads,
      (size_t)img * g.gh * g.gw, c2_out);
}

// B6: each depth step's three mma summed from zero, all three weight parts
// in shared memory, two blocks an SM (its 125 registers allow no more).
__global__ void __launch_bounds__(THREADS, 2)
pnet_level_kernel(const unsigned short* __restrict__ x, int sh, int sw, Grid g,
                  const unsigned short* __restrict__ weights,
                  float* __restrict__ probs, float* __restrict__ reg) {
  level_block<tc::OUT_PROBS, 3, false>(x, sh, sw, g, weights, probs, reg,
                                       nullptr);
}

template <bool CHAINED>
__global__ void __launch_bounds__(THREADS, 2)
pnet_level_sums_kernel(const unsigned short* __restrict__ x, int sh, int sw,
                       Grid g, const unsigned short* __restrict__ weights,
                       float* __restrict__ sums,
                       unsigned short* __restrict__ c2) {
  level_block<tc::OUT_SUMS, 3, CHAINED>(
      x, sh, sw, g, weights, nullptr, sums,
      c2 + (size_t)blockIdx.x * tc::C2_HALFS);
}

__global__ void __launch_bounds__(THREADS, 3)
pnet_trunk_nhwc_kernel(const unsigned short* __restrict__ x, int sh, int sw,
                       Grid g, const unsigned short* __restrict__ weights,
                       float* __restrict__ heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  int img, gy0, gx0;
  block_tile(g, &img, &gy0, &gx0);
  TileInput in;
  in.base = x + (size_t)img * sh * sw * 3;
  in.stride_c = 1;
  in.stride_y = sw * 3;
  in.stride_x = 3;
  in.sh = sh;
  in.sw = sw;
  tc::pnet_tile_mma<tc::OUT_RAW>(smem, weights, in, gy0, gx0, g.gh, g.gw,
                                 nullptr, heads, (size_t)img * g.gh * g.gw);
}

// The head grid and block count of a batch of (sh, sw) levels whose rows
// are `pitch` elements apart; false when the kernels do not take them
// (`n_weights` must be the `expected` size of the kernel's packed vector).
bool plan(int batch, int sh, int sw, int pitch, int n_weights, int expected,
          Grid* g, unsigned* blocks) {
  if (batch < 1 || n_weights != expected || pitch < sw) return false;
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
cudaError_t opt_in(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Each function launches on `stream` and returns the cudaError_t of the
// launch (0 on success). `weights` is the tensor-core tile's packed vector
// on the card (16-byte aligned): one part (n_weights = tc::N_HALFS 16-bit
// values) for pnet_flat_launch and pnet_trunk_nhwc_launch, three parts
// (tc::N_HALFS3) for pnet_level_launch and pnet_level_sums_launch.

extern "C" int pnet_flat_launch(const void* planes, int batch, int sh,
                                int pitch, int true_sw, const void* weights,
                                int n_weights, float* probs, float* reg,
                                void* stream) {
  Grid g;
  unsigned blocks;
  if (!plan(batch, sh, true_sw, pitch, n_weights, tc::N_HALFS, &g, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = opt_in(pnet_flat_kernel, tc::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  pnet_flat_kernel<<<blocks, THREADS, tc::SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const unsigned short*>(planes), sh, pitch, true_sw, g,
      static_cast<const unsigned short*>(weights), probs, reg);
  return (int)cudaGetLastError();
}

extern "C" int pnet_level_launch(const void* x, int batch, int sh, int sw,
                                 const void* weights, int n_weights,
                                 float* probs, float* reg, void* stream) {
  Grid g;
  unsigned blocks;
  if (!plan(batch, sh, sw, sw, n_weights, tc::N_HALFS3, &g, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = opt_in(pnet_level_kernel, tc::SMEM_BYTES3);
  if (err != cudaSuccess) return (int)err;
  pnet_level_kernel<<<blocks, THREADS, tc::SMEM_BYTES3,
                      (cudaStream_t)stream>>>(
      static_cast<const unsigned short*>(x), sh, sw, g,
      static_cast<const unsigned short*>(weights), probs, reg);
  return (int)cudaGetLastError();
}

// B6's accuracy probe: conv3's sums before its bias, sums [B, gh, gw, 32]
// float32, and each block's conv2 tile, c2 [blocks][18 * 18][16] bf16 (the
// channels in the tile's order), block = image * tiles + tile row *
// tiles_x + tile column. `chained` != 0 chains the three mma of a depth
// step on the accumulator, 0 sums them from zero as B6 does.
extern "C" int pnet_level_sums_launch(const void* x, int batch, int sh,
                                      int sw, const void* weights,
                                      int n_weights, int chained, float* sums,
                                      void* c2, void* stream) {
  Grid g;
  unsigned blocks;
  if (!plan(batch, sh, sw, sw, n_weights, tc::N_HALFS3, &g, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = chained ? pnet_level_sums_kernel<true>
                              : pnet_level_sums_kernel<false>;
  const cudaError_t err = opt_in(kernel, tc::SMEM_BYTES3);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, tc::SMEM_BYTES3, (cudaStream_t)stream>>>(
      static_cast<const unsigned short*>(x), sh, sw, g,
      static_cast<const unsigned short*>(weights), sums,
      static_cast<unsigned short*>(c2));
  return (int)cudaGetLastError();
}

extern "C" int pnet_trunk_nhwc_launch(const void* x, int batch, int sh, int sw,
                                      const void* weights, int n_weights,
                                      float* heads, void* stream) {
  Grid g;
  unsigned blocks;
  if (!plan(batch, sh, sw, sw, n_weights, tc::N_HALFS, &g, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = opt_in(pnet_trunk_nhwc_kernel, tc::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  pnet_trunk_nhwc_kernel<<<blocks, THREADS, tc::SMEM_BYTES,
                           (cudaStream_t)stream>>>(
      static_cast<const unsigned short*>(x), sh, sw, g,
      static_cast<const unsigned short*>(weights), heads);
  return (int)cudaGetLastError();
}
