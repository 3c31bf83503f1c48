// Fused Inception-ResNet-v1 stem prefix (B5): Conv2d_1a (3x3/s2), Conv2d_2a
// (3x3), Conv2d_2b (3x3) and MaxPool_3a (3x3/s2) of a 160x160 image in one
// launch.
//
// Replaces the Pallas TPU kernel
// facenet_tpu/ops/pallas_stem.py::_make_stem_kernel (entry
// stem_forward_flat). In: the normalized image, bf16 NHWC [B, 160, 160, 3],
// read in place: the space-to-depth form of the first conv
// (s2d[(dy, dx, c)][i][j] = x[2i + dy][2j + dx][c], 2x2 taps 12 -> 32) is an
// index map over the pixels, so no relayout pass runs before the kernel.
// Then conv3x3 32 -> 32 and conv3x3 32 -> 64, all VALID (80^2 cells ->
// 79^2 -> 77^2 -> 75^2), each with its folded-BN bias and ReLU, and the
// 3x3/s2 VALID max pool. Out: [B, 37, 37, 64] bf16 in memory, which the
// caller views as NCHW in channels_last. Arithmetic follows the TPU kernel:
// bf16 operands, float32 sums, float32 bias and ReLU, a rounding to bf16
// after each of the three convs.
//
// What bounds it on the card: operations (335.9 MFLOP an image against
// 0.33 MB in and out). The design keeps every intermediate on chip and
// runs the three convs on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 sums). One block per (image, 8x8 tile of pooled cells). The block
// stages its 44x44 pixel patch, then computes the 21x21x32 conv1 tile, the
// 19x19x32 conv2a tile and the 17x17x64 conv2b tile in shared memory and
// pools from there; the halo is recomputed (1.41x on conv2a, 1.13x on
// conv2b), and 37 = 4 * 8 + 5 leaves the last tile of a row 5/8 full.
//
// Each conv is an implicit GEMM: rows are the tile's cells in raster order,
// 16 to an mma tile; the depth is (tap, 16 input channels) for the 3x3
// convs and the 48 values of a cell's 4x4x3 pixel window for conv1. A warp
// takes one 16-cell tile and 32 output channels at a time. Tiles are held
// cell-major ([cell][channel], 40 halfs a cell for 32 channels, so that the
// rows of a fragment fall into different banks), and within each group of
// 16 channels the order is (0 1 8 9 | 2 3 10 11 | 4 5 12 13 | 6 7 14 15):
// the four values that one thread feeds to one mma then lie together and
// come with one 64-bit load. The weights are packed on the host in the same
// order ([depth step][output channel][16]), one conv at a time in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int IMAGE = 160;                 // input side, pixels
constexpr int OUT = 37;                    // pooled side
constexpr int P = 8;                       // pooled cells per tile side
constexpr int TILES = (OUT + P - 1) / P;   // 5 tiles a side
constexpr int C2B = 2 * P + 1;             // conv2b tile side (17)
constexpr int C2A = C2B + 2;               // conv2a tile side (19)
constexpr int C1 = C2A + 2;                // conv1 tile side (21)
constexpr int PIX = 2 * C1 + 2;            // pixel patch side (44)
constexpr int PIX_ROW = PIX * 3;           // halfs per patch row (132)
constexpr int CS = 40;                     // halfs per cell, 32 channels
constexpr int CS_OUT = 72;                 // halfs per cell, 64 channels

// packed weights, mirrored by ops/stem.py: bf16 [depth step][co][16] per
// conv (conv1: 3 steps over the 48 window values; conv2a and conv2b: 18
// steps = 9 taps x 2 groups of 16 input channels), then 128 float32 biases
constexpr int OFF_W1 = 0;                  // 3 * 32 * 16
constexpr int OFF_W2 = 1536;               // 18 * 32 * 16
constexpr int OFF_W3 = 10752;              // 18 * 64 * 16
constexpr int OFF_BIAS = 29184;            // in halfs; 128 floats follow
constexpr int N_HALFS = OFF_BIAS + 256;

constexpr int W_HALFS = 18 * 64 * 16;                   // the largest conv
constexpr int B_FLOATS = 128;
constexpr int IN_HALFS = PIX * PIX_ROW;                 // 5,808
constexpr int C1_HALFS = C1 * C1 * CS;                  // 17,640
constexpr int C2A_HALFS = C2A * C2A * CS;               // 14,440
constexpr int C2B_HALFS = C2B * C2B * CS_OUT;           // 20,808
constexpr int A_HALFS = IN_HALFS > C2A_HALFS ? IN_HALFS : C2A_HALFS;
constexpr int B_HALFS = C1_HALFS > C2B_HALFS ? C1_HALFS : C2B_HALFS;
constexpr int SMEM_BYTES = W_HALFS * 2 + B_FLOATS * 4 + (A_HALFS + B_HALFS) * 2;

static_assert(A_HALFS % 8 == 0 && B_HALFS % 8 == 0 && CS % 4 == 0,
              "shared-memory regions must keep 16-byte alignment");

typedef unsigned short bf16_t;             // bf16 bits

// D += A (16x16, row) * B (16x8, col), bf16 in, float32 sums. With g =
// lane / 4 and t = lane % 4: a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
// a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]; b0 = B[2t, 2t+1][g],
// b1 = B[2t+8, 2t+9][g]; d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// float32 bias + ReLU on two neighbouring channels, rounded to bf16 bits
// (low half: the first channel); a negative zero becomes +0
__device__ __forceinline__ unsigned relu_pack(float x0, float x1, float b0,
                                              float b1) {
  x0 += b0;
  x1 += b1;
  x0 = x0 > 0.f ? x0 : 0.f;
  x1 = x1 > 0.f ? x1 : 0.f;
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x0)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x1)) << 16);
}

__device__ __forceinline__ void stage_weights(bf16_t* s_w, const bf16_t* w,
                                              int halfs) {
  const uint4* src = reinterpret_cast<const uint4*>(w);
  uint4* dst = reinterpret_cast<uint4*>(s_w);
  for (int i = threadIdx.x; i < halfs / 8; i += THREADS) dst[i] = src[i];
}

// The epilogue of a 16-cell x 32-channel item whose output feeds another
// conv: bias, ReLU, bf16, stored cell-major in the channel order described
// at the top. acc[nt] holds channels nt * 8 + 2t, + 1 of rows g and g + 8.
__device__ __forceinline__ void store_permuted(bf16_t* s_dst,
                                               const float (&acc)[4][4],
                                               const float* s_b, int m_lo,
                                               int m_hi, int m_total, int t) {
#pragma unroll
  for (int group = 0; group < 2; ++group) {        // 16 channels each
    const int even = 2 * group, odd = even + 1;    // n-tiles of the group
    const float be0 = s_b[even * 8 + 2 * t], be1 = s_b[even * 8 + 2 * t + 1];
    const float bo0 = s_b[odd * 8 + 2 * t], bo1 = s_b[odd * 8 + 2 * t + 1];
    if (m_lo < m_total) {
      uint2 v;
      v.x = relu_pack(acc[even][0], acc[even][1], be0, be1);
      v.y = relu_pack(acc[odd][0], acc[odd][1], bo0, bo1);
      *reinterpret_cast<uint2*>(s_dst + m_lo * CS + group * 16 + 4 * t) = v;
    }
    if (m_hi < m_total) {
      uint2 v;
      v.x = relu_pack(acc[even][2], acc[even][3], be0, be1);
      v.y = relu_pack(acc[odd][2], acc[odd][3], bo0, bo1);
      *reinterpret_cast<uint2*>(s_dst + m_hi * CS + group * 16 + 4 * t) = v;
    }
  }
}

// VALID 3x3 conv over a cell-major tile: src [WI x WI cells][CS] (32
// channels, permuted order) -> WO x WO cells, WO = WI - 2, of N_OUT output
// channels with weights s_w [18][N_OUT][16] and biases s_b [N_OUT]. N_OUT =
// 32 stores permuted at CS halfs a cell (input of the next conv); N_OUT = 64
// stores the channels in their own order at CS_OUT halfs a cell.
template <int WI, int N_OUT>
__device__ __forceinline__ void conv3x3_mma(const bf16_t* s_src, bf16_t* s_dst,
                                            const bf16_t* s_w,
                                            const float* s_b) {
  constexpr int WO = WI - 2;
  constexpr int M_TOTAL = WO * WO;
  constexpr int M_TILES = (M_TOTAL + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  for (int item = warp; item < M_TILES * (N_OUT / 32); item += WARPS) {
    const int mt = item % M_TILES, nh = item / M_TILES;
    const int m_lo = mt * 16 + g, m_hi = m_lo + 8;
    // rows past the tile compute the last cell again and store nothing
    const int c_lo = min(m_lo, M_TOTAL - 1), c_hi = min(m_hi, M_TOTAL - 1);
    const bf16_t* a_lo = s_src + ((c_lo / WO) * WI + c_lo % WO) * CS + 4 * t;
    const bf16_t* a_hi = s_src + ((c_hi / WO) * WI + c_hi % WO) * CS + 4 * t;
    const bf16_t* w = s_w + (nh * 32 + g) * 16 + 4 * t;
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          const int off = (ky * WI + kx) * CS + kc * 16;
          const uint2 lo = *reinterpret_cast<const uint2*>(a_lo + off);
          const uint2 hi = *reinterpret_cast<const uint2*>(a_hi + off);
          const bf16_t* ws = w + ((ky * 3 + kx) * 2 + kc) * N_OUT * 16;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint2 b = *reinterpret_cast<const uint2*>(ws + nt * 8 * 16);
            mma_bf16(acc[nt], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
          }
        }
    if constexpr (N_OUT == 32) {
      store_permuted(s_dst, acc, s_b, m_lo, m_hi, M_TOTAL, t);
    } else {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = nh * 32 + nt * 8 + 2 * t;
        const float b0 = s_b[n], b1 = s_b[n + 1];
        if (m_lo < M_TOTAL)
          *reinterpret_cast<unsigned*>(s_dst + m_lo * CS_OUT + n) =
              relu_pack(acc[nt][0], acc[nt][1], b0, b1);
        if (m_hi < M_TOTAL)
          *reinterpret_cast<unsigned*>(s_dst + m_hi * CS_OUT + n) =
              relu_pack(acc[nt][2], acc[nt][3], b0, b1);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
stem_fused_kernel(const bf16_t* __restrict__ x,
                  const bf16_t* __restrict__ weights,
                  bf16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* s_w = reinterpret_cast<bf16_t*>(smem_raw);
  float* s_b = reinterpret_cast<float*>(s_w + W_HALFS);  // b1, b2, b3
  bf16_t* s_a = reinterpret_cast<bf16_t*>(s_b + B_FLOATS);
  bf16_t* s_bb = s_a + A_HALFS;
  bf16_t* s_in = s_a;        // [44][44 * 3] pixels, then
  bf16_t* s_c2a = s_a;       // [19 * 19][CS]
  bf16_t* s_c1 = s_bb;       // [21 * 21][CS], then
  bf16_t* s_c2b = s_bb;      // [17 * 17][CS_OUT]

  const int tid = threadIdx.x;
  const int img = blockIdx.x / (TILES * TILES);
  const int tile = blockIdx.x % (TILES * TILES);
  const int p0 = (tile / TILES) * P, q0 = (tile % TILES) * P;  // pooled
  const int y0 = 4 * p0, x0 = 4 * q0;                          // pixels

  // ---- stage 0: conv1's weights, all biases, the pixel patch (zero
  // beyond the image, which only cells beyond the valid output read)
  stage_weights(s_w, weights + OFF_W1, 3 * 32 * 16);
  if (tid < B_FLOATS)
    s_b[tid] = reinterpret_cast<const float*>(weights + OFF_BIAS)[tid];
  const bf16_t* image = x + (size_t)img * IMAGE * IMAGE * 3;
  const int row_halfs = min(PIX, IMAGE - x0) * 3;   // inside the image
  for (int i = tid; i < IN_HALFS; i += THREADS) {
    const int r = i / PIX_ROW, k = i - r * PIX_ROW;
    const int y = y0 + r;
    s_in[i] = (y < IMAGE && k < row_halfs)
                  ? image[((size_t)y * IMAGE + x0) * 3 + k]
                  : (bf16_t)0;
  }
  __syncthreads();

  // ---- stage 1: conv1 as the 2x2 taps of the space-to-depth form, i.e.
  // the 4x4 pixel window at (2i, 2j) x 3 channels (48 values, 3 depth
  // steps) -> 32 channels
  {
    constexpr int M_TOTAL = C1 * C1;
    constexpr int M_TILES = (M_TOTAL + 15) / 16;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    for (int mt = warp; mt < M_TILES; mt += WARPS) {
      const int m_lo = mt * 16 + g, m_hi = m_lo + 8;
      const int c_lo = min(m_lo, M_TOTAL - 1), c_hi = min(m_hi, M_TOTAL - 1);
      const bf16_t* a_lo = s_in + 2 * (c_lo / C1) * PIX_ROW + 6 * (c_lo % C1);
      const bf16_t* a_hi = s_in + 2 * (c_hi / C1) * PIX_ROW + 6 * (c_hi % C1);
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        // window value k = py * 12 + px * 3 + c lies at row py, half k % 12
        const int k0 = 16 * s + 2 * t, k1 = k0 + 8;
        const int o0 = (k0 / 12) * PIX_ROW + k0 % 12;
        const int o1 = (k1 / 12) * PIX_ROW + k1 % 12;
        const unsigned a0 = *reinterpret_cast<const unsigned*>(a_lo + o0);
        const unsigned a1 = *reinterpret_cast<const unsigned*>(a_hi + o0);
        const unsigned a2 = *reinterpret_cast<const unsigned*>(a_lo + o1);
        const unsigned a3 = *reinterpret_cast<const unsigned*>(a_hi + o1);
        const bf16_t* ws = s_w + (s * 32 + g) * 16 + 4 * t;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint2 b = *reinterpret_cast<const uint2*>(ws + nt * 8 * 16);
          mma_bf16(acc[nt], a0, a1, a2, a3, b.x, b.y);
        }
      }
      store_permuted(s_c1, acc, s_b, m_lo, m_hi, M_TOTAL, t);
    }
  }
  __syncthreads();

  // ---- stage 2: conv2a 32 -> 32 (over the dead pixel patch)
  stage_weights(s_w, weights + OFF_W2, 18 * 32 * 16);
  __syncthreads();
  conv3x3_mma<C1, 32>(s_c1, s_c2a, s_w, s_b + 32);
  __syncthreads();

  // ---- stage 3: conv2b 32 -> 64 (over the dead conv1 tile)
  stage_weights(s_w, weights + OFF_W3, 18 * 64 * 16);
  __syncthreads();
  conv3x3_mma<C2A, 64>(s_c2a, s_c2b, s_w, s_b + 64);
  __syncthreads();

  // ---- stage 4: 3x3/s2 VALID max pool, two channels a thread, written
  // as [b][y][x][c]. ReLU outputs are >= +0, so bf16 bits order as integers.
  for (int item = tid; item < P * P * 32; item += THREADS) {
    const int cp = item % 32, cell = item / 32;
    const int p = cell / P, q = cell - p * P;
    if (p0 + p >= OUT || q0 + q >= OUT) continue;
    const bf16_t* win = s_c2b + (2 * p * C2B + 2 * q) * CS_OUT + 2 * cp;
    unsigned best = 0;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s)
        best = __vmaxu2(best, *reinterpret_cast<const unsigned*>(
                                  win + (r * C2B + s) * CS_OUT));
    *reinterpret_cast<unsigned*>(
        out + (((size_t)img * OUT + p0 + p) * OUT + q0 + q) * 64 + 2 * cp) =
        best;
  }
}

}  // namespace

// x: bf16 [batch, 160, 160, 3]; weights: the packed vector on the card (bf16
// kernels, then float32 biases; n_halfs 16-bit values in all); out: bf16
// [batch, 37, 37, 64]. Launches on `stream`; returns the cudaError_t of the
// launch (0 on success).
extern "C" int stem_fused_launch(const void* x, int batch,
                                 const void* weights, int n_halfs, void* out,
                                 void* stream) {
  if (batch < 1 || n_halfs != N_HALFS ||
      (long long)batch * TILES * TILES > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  // the opt-in applies to the current device only, so it is set on every
  // launch (a cheap host call) rather than once per process
  const cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  stem_fused_kernel<<<(unsigned)(batch * TILES * TILES), THREADS, SMEM_BYTES,
                      (cudaStream_t)stream>>>(
      static_cast<const bf16_t*>(x), static_cast<const bf16_t*>(weights),
      static_cast<bf16_t*>(out));
  return (int)cudaGetLastError();
}
