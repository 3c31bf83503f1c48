// One 16x16 tile of MTCNN P-Net head cells on the tensor cores: the device
// code of the whole-pyramid kernel (pnet_pyramid.cu, B3) and of the
// one-level kernels of pnet_level.cu on planes (B4), on NCHW input with
// unrounded float32 weights (B6) and on NHWC pixels (B7). Geometry, input
// addressing and helpers are those of pnet_tile.cuh. Arithmetic: bf16
// inputs, float32 sums, float32 bias and PReLU, activations rounded to bf16
// after each PReLU, float32 heads.
//
// The conv weights come as PARTS bf16 parts. PARTS = 1 (B3, B4, B7): the
// weights are bf16 values. PARTS = 3 (B6): each float32 weight w is hi +
// mid + lo with hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid),
// exactly (8 significant bits each, 24 with the signs that round-to-nearest
// leaves), and a bf16 x bf16 product is exact in float32, so three mma a
// depth step multiply by the float32 weights exactly. The tensor core
// truncates its float32 sums, so B6 sums each depth step's three products
// from zero (lo, mid, hi) and adds the step into the accumulator outside
// the tensor core, rounding to nearest (CHAINED = false). CHAINED = true
// runs the three mma on the accumulator itself; only the accuracy probe
// (pnet_level_sums_launch) builds it.
//
// What bounds the tile on the card: operations (a block does 4.3 MFLOP on
// a 10.6 KB patch, B6 three times the mma). Each conv is an implicit GEMM
// on mma.sync m16n8k16 (bf16 in, float32 sums) whose rows are the tile's
// cells in raster order, 16 to an mma tile, one warp a tile:
//   conv1 + pool: a pooled cell's 4x4 pixel window x 3 channels is the
//     depth (48 = 3 steps; the patch is staged pixel-major, so a window row
//     is 12 contiguous halfs), and the columns are the four conv1 positions
//     of the pool window x 10 channels = 40, with zeros where a tap falls
//     outside a position's 3x3 (Toeplitz form). Column tiles 0..3 hold
//     channels 0..7 of positions 0..3, so a thread finds the four positions
//     of its two channels in its own registers and pools without a shuffle;
//     column tile 4 holds (position, channel 8 or 9) pairs, pooled over the
//     four threads of a quad with two shuffles. flax's SAME pool pads -inf:
//     positions at or beyond the conv1 extent are left out of the max.
//   conv2 (10 -> 16) and conv3 (16 -> 32): depth = (tap, 16 input
//     channels), 9 steps; conv2's channels 10..15 are zeros in the pooled
//     tile and in the weights. conv3 takes two cell tiles a warp, so each
//     weight fragment feeds two mma.
//   heads (32 -> 6): a thread holds 8 of a cell's 32 conv3 channels; it
//     sums its share of the six outputs in float32 and the quad adds up
//     with shuffles.
// Tiles are cell-major in shared memory, 16 halfs a cell, and the 16 are in
// the order (0 1 8 9 | 2 3 10 11 | 4 5 12 13 | 6 7 14 15): the four values
// that one thread feeds to one mma lie together and come with one 64-bit
// load, and consecutive cells are consecutive in memory, so a fragment load
// touches each bank once. The host packs the weights in the same order
// ([part][depth step][column][16], detectors/mtcnn/pnet.py::pack_mma).
// Shared memory holds every part: 42,624 B with one part (three blocks an
// SM), 77,952 B with three (two blocks an SM).

#pragma once

#include "pnet_tile.cuh"

namespace pnet {
namespace tc {

typedef unsigned short bf16_t;  // bf16 bits

// packed weights, mirrored by detectors/mtcnn/pnet.py: PARTS parts of the
// bf16 kernels in 16-bit units, then float32 values (two units each)
constexpr int OFF_W1 = 0;        // [3 steps][40 columns][16]
constexpr int OFF_W2 = 1920;     // [9 taps][16 channels][16]
constexpr int OFF_W3 = 4224;     // [9 taps][32 channels][16]
constexpr int W_HALFS = 8832;    // one part
constexpr int F_B1 = 0;          // float index after the kernels
constexpr int F_A1 = 16;
constexpr int F_B2 = 32;
constexpr int F_A2 = 48;
constexpr int F_B3 = 64;
constexpr int F_A3 = 96;
constexpr int F_WH = 128;        // [32 channels][8], 6 used
constexpr int F_BH = 384;
constexpr int N_FLOATS = 392;

// 16-bit units of the packed vector of `parts` parts
__host__ __device__ constexpr int n_halfs(int parts) {
  return parts * W_HALFS + 2 * N_FLOATS;
}
constexpr int N_HALFS = n_halfs(1);   // 9616
constexpr int N_HALFS3 = n_halfs(3);  // 27280

constexpr int WARPS = THREADS / 32;
constexpr int CELL = 16;                      // halfs per cell
constexpr int IN_ROW = 3 * IN_SIDE;           // halfs per patch row (126)
constexpr int IN_HALFS = IN_SIDE * IN_ROW;    // 5292
constexpr int C2_HALFS = C2_SIDE * C2_SIDE * CELL;        // 5184
constexpr int POOL_HALFS = POOL_SIDE * POOL_SIDE * CELL;  // 6400
constexpr int A_HALFS =
    ((IN_HALFS > C2_HALFS ? IN_HALFS : C2_HALFS) + 7) / 8 * 8;

// dynamic shared memory of a tile whose weights hold `parts` parts there
__host__ __device__ constexpr int smem_bytes(int parts) {
  return (n_halfs(parts) + A_HALFS + POOL_HALFS) * 2;
}
constexpr int SMEM_BYTES = smem_bytes(1);   // 42,624
constexpr int SMEM_BYTES3 = smem_bytes(3);  // 77,952

// what the tile writes: the face probability and box offsets, the six head
// outputs before any softmax, or (the accuracy probe) conv3's sums before
// its bias with the tile's conv2 activations
constexpr int OUT_PROBS = 0;
constexpr int OUT_RAW = 1;
constexpr int OUT_SUMS = 2;

static_assert(N_HALFS % 8 == 0 && W_HALFS % 8 == 0,
              "shared-memory regions must keep 16-byte alignment");
static_assert(POOL_SIDE * POOL_SIDE % 16 == 0 && TILE == 16,
              "conv1 and conv3 have no ragged cell tile");

// D += A (16x16, row) * B (16x8, col), bf16 in, float32 sums. With g =
// lane / 4 and t = lane % 4: a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
// a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]; b0 = B[2t, 2t+1][g],
// b1 = B[2t+8, 2t+9][g]; d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// two float32 values rounded to bf16 bits (low half: the first)
__device__ __forceinline__ unsigned pack_bf16(float x0, float x1) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x0)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x1)) << 16);
}

__device__ __forceinline__ uint2 load2(const bf16_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// acc[m] += a[m] * w for M cell tiles that share the weight fragments of
// one depth step and column tile (part 0 at `w` in shared memory, part p
// W_HALFS further on): one mma a tile with one part; with three, the step's
// products in the order lo, mid, hi, chained on acc or summed from zero and
// added outside the tensor core.
template <int PARTS, bool CHAINED, int M>
__device__ __forceinline__ void mma_step(float (&acc)[M][4],
                                         const uint4 (&a)[M],
                                         const bf16_t* w) {
  if constexpr (CHAINED) {
#pragma unroll
    for (int p = PARTS - 1; p >= 0; --p) {
      const uint2 b = load2(w + p * W_HALFS);
#pragma unroll
      for (int m = 0; m < M; ++m) mma_bf16(acc[m], a[m], b.x, b.y);
    }
  } else {
    float step[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) step[m][i] = 0.f;
#pragma unroll
    for (int p = PARTS - 1; p >= 0; --p) {
      const uint2 b = load2(w + p * W_HALFS);
#pragma unroll
      for (int m = 0; m < M; ++m) mma_bf16(step[m], a[m], b.x, b.y);
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][i] += step[m][i];
  }
}

// The tile of head cells [gy0, gy0 + 16) x [gx0, gx0 + 16) of one image.
// `first_cell` is the image's first cell in the output arrays (image index
// times gh * gw). OUT_PROBS writes the face probability (2-way softmax) to
// probs[cell] and the 4 box offsets to heads[4 * cell]; OUT_RAW the 6 head
// outputs before any softmax to heads[6 * cell]; OUT_SUMS conv3's 32 sums
// before its bias to heads[32 * cell] and the block's conv2 tile (C2_HALFS
// 16-bit values, cells in raster order, channels in the order above) to
// c2_out. `weights` is the packed vector of n_halfs(PARTS) 16-bit values on
// the card (16-byte aligned); `smem` is smem_bytes(PARTS) of dynamic shared
// memory, 16-byte aligned. Every thread of the block must call this
// function (it synchronizes the block).
template <int OUT, int PARTS = 1, bool CHAINED = (PARTS == 1)>
__device__ __forceinline__ void pnet_tile_mma(
    unsigned char* smem, const bf16_t* __restrict__ weights,
    const TileInput& in, int gy0, int gx0, int gh, int gw, float* probs,
    float* heads, size_t first_cell, bf16_t* c2_out = nullptr) {
  bf16_t* s_w = reinterpret_cast<bf16_t*>(smem);
  const float* s_f = reinterpret_cast<const float*>(s_w + PARTS * W_HALFS);
  bf16_t* s_in = s_w + n_halfs(PARTS);  // [42][42][3] pixels, later
  bf16_t* s_c2 = s_in;                 // [18 * 18 cells][16]
  bf16_t* s_pool = s_in + A_HALFS;     // [20 * 20 cells][16]

  const int sh = in.sh, sw = in.sw;
  const int h1 = sh - 2, w1 = sw - 2;             // conv1 extent
  const int hp = (h1 + 1) / 2, wp = (w1 + 1) / 2;  // pooled extent
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // ---- stage 0: weights and the input patch (zero beyond the level),
  // pixel-major
  {
    const uint4* src = reinterpret_cast<const uint4*>(weights);
    uint4* dst = reinterpret_cast<uint4*>(s_w);
    for (int i = tid; i < n_halfs(PARTS) / 8; i += THREADS) dst[i] = src[i];
  }
  const int iy0 = 2 * gy0, ix0 = 2 * gx0;
  for (int i = tid; i < IN_HALFS; i += THREADS) {
    const int c = i / (IN_SIDE * IN_SIDE);
    const int rem = i - c * IN_SIDE * IN_SIDE;
    const int py = rem / IN_SIDE, px = rem % IN_SIDE;
    const int y = iy0 + py, x = ix0 + px;
    s_in[py * IN_ROW + px * 3 + c] =
        (y < sh && x < sw) ? in.base[(size_t)c * in.stride_c +
                                     (size_t)y * in.stride_y +
                                     (size_t)x * in.stride_x]
                           : (bf16_t)0;
  }
  __syncthreads();

  // ---- stage 1: conv1 + PReLU, pooled 2x2/s2, bf16, into s_pool
  for (int mt = warp; mt < POOL_SIDE * POOL_SIDE / 16; mt += WARPS) {
    const int m_lo = mt * 16 + g, m_hi = m_lo + 8;
    const bf16_t* a_lo =
        s_in + 2 * (m_lo / POOL_SIDE) * IN_ROW + 6 * (m_lo % POOL_SIDE);
    const bf16_t* a_hi =
        s_in + 2 * (m_hi / POOL_SIDE) * IN_ROW + 6 * (m_hi % POOL_SIDE);
    float acc[5][1][4];
#pragma unroll
    for (int nt = 0; nt < 5; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][0][i] = 0.f;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      // window value k = wy * 12 + wx * 3 + c lies at patch row wy, half
      // k % 12
      const int k0 = 16 * s + 2 * t, k1 = k0 + 8;
      const int o0 = (k0 / 12) * IN_ROW + k0 % 12;
      const int o1 = (k1 / 12) * IN_ROW + k1 % 12;
      const uint4 a[1] = {make_uint4(
          *reinterpret_cast<const unsigned*>(a_lo + o0),
          *reinterpret_cast<const unsigned*>(a_hi + o0),
          *reinterpret_cast<const unsigned*>(a_lo + o1),
          *reinterpret_cast<const unsigned*>(a_hi + o1))};
      const int ws = OFF_W1 + (s * 40 + g) * 16 + 4 * t;
#pragma unroll
      for (int nt = 0; nt < 5; ++nt) {
        mma_step<PARTS, CHAINED>(acc[nt], a, s_w + ws + nt * 8 * 16);
      }
    }
    const float b_lo = s_f[F_B1 + 2 * t], b_hi = s_f[F_B1 + 2 * t + 1];
    const float s_lo = s_f[F_A1 + 2 * t], s_hi = s_f[F_A1 + 2 * t + 1];
    const float b8 = s_f[F_B1 + 8], b9 = s_f[F_B1 + 9];
    const float s8 = s_f[F_A1 + 8], s9 = s_f[F_A1 + 9];
#pragma unroll
    for (int half = 0; half < 2; ++half) {   // rows g and g + 8
      const int m = half ? m_hi : m_lo, e = 2 * half;
      const int py = gy0 + m / POOL_SIDE, px = gx0 + m % POOL_SIDE;
      const bool cell = py < hp && px < wp;  // else: feeds no valid output
      // SAME pooling pads -inf past the conv1 edge; 2 py < h1 for a pooled
      // cell, so position (0, 0) always counts
      float best0 = -INFINITY, best1 = -INFINITY;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (2 * py + p / 2 < h1 && 2 * px + p % 2 < w1) {
          best0 = fmaxf(best0, prelu(acc[p][0][e] + b_lo, s_lo));
          best1 = fmaxf(best1, prelu(acc[p][0][e + 1] + b_hi, s_hi));
        }
      }
      // channels 8 and 9: this thread holds position t, the quad the rest
      const bool mine = 2 * py + t / 2 < h1 && 2 * px + t % 2 < w1;
      float best8 = mine ? prelu(acc[4][0][e] + b8, s8) : -INFINITY;
      float best9 = mine ? prelu(acc[4][0][e + 1] + b9, s9) : -INFINITY;
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        best8 = fmaxf(best8, __shfl_xor_sync(0xffffffffu, best8, x));
        best9 = fmaxf(best9, __shfl_xor_sync(0xffffffffu, best9, x));
      }
      uint2 v = make_uint2(0u, 0u);          // channels 10..15 stay zero
      if (cell) {
        v.x = pack_bf16(best0, best1);
        if (t == 0) v.y = pack_bf16(best8, best9);
      }
      *reinterpret_cast<uint2*>(s_pool + m * CELL + 4 * t) = v;
    }
  }
  __syncthreads();

  // ---- stage 2: conv2 + PReLU + bf16 into s_c2 (over the dead patch)
  {
    constexpr int M_TOTAL = C2_SIDE * C2_SIDE;
    for (int mt = warp; mt < (M_TOTAL + 15) / 16; mt += WARPS) {
      const int m_lo = mt * 16 + g, m_hi = m_lo + 8;
      // rows past the tile compute the last cell again and store nothing
      const int c_lo = min(m_lo, M_TOTAL - 1), c_hi = min(m_hi, M_TOTAL - 1);
      const bf16_t* a_lo =
          s_pool + ((c_lo / C2_SIDE) * POOL_SIDE + c_lo % C2_SIDE) * CELL + 4 * t;
      const bf16_t* a_hi =
          s_pool + ((c_hi / C2_SIDE) * POOL_SIDE + c_hi % C2_SIDE) * CELL + 4 * t;
      float acc[2][1][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][0][i] = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3) * POOL_SIDE + tap % 3) * CELL;
        const uint2 lo = load2(a_lo + off), hi = load2(a_hi + off);
        const uint4 a[1] = {make_uint4(lo.x, hi.x, lo.y, hi.y)};
        const int ws = OFF_W2 + (tap * 16 + g) * 16 + 4 * t;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_step<PARTS, CHAINED>(acc[nt], a, s_w + ws + nt * 8 * 16);
        }
      }
      // a thread's channels 2t, 2t+1 (column tile 0) and 8+2t, 9+2t (tile
      // 1) are the four neighbours of the cell's permuted order
      float bias[4], slope[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = (i / 2) * 8 + 2 * t + i % 2;
        bias[i] = s_f[F_B2 + ch];
        slope[i] = s_f[F_A2 + ch];
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = half ? m_hi : m_lo, e = 2 * half;
        if (m >= M_TOTAL) continue;
        uint2 v;
        v.x = pack_bf16(prelu(acc[0][0][e] + bias[0], slope[0]),
                        prelu(acc[0][0][e + 1] + bias[1], slope[1]));
        v.y = pack_bf16(prelu(acc[1][0][e] + bias[2], slope[2]),
                        prelu(acc[1][0][e + 1] + bias[3], slope[3]));
        *reinterpret_cast<uint2*>(s_c2 + m * CELL + 4 * t) = v;
      }
    }
  }
  __syncthreads();
  if constexpr (OUT == OUT_SUMS) {
    const uint4* src = reinterpret_cast<const uint4*>(s_c2);
    uint4* dst = reinterpret_cast<uint4*>(c2_out);
    for (int i = tid; i < C2_HALFS / 8; i += THREADS) dst[i] = src[i];
  }

  // ---- stage 3: conv3 + PReLU + bf16 and the heads; head rows 2 warp and
  // 2 warp + 1 (a cell tile is one row of the 16x16 tile)
  float acc[4][2][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][j][i] = 0.f;
  const bf16_t* a_row = s_c2 + (2 * warp * C2_SIDE + g) * CELL + 4 * t;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const bf16_t* a = a_row + ((tap / 3) * C2_SIDE + tap % 3) * CELL;
    const uint2 lo0 = load2(a), hi0 = load2(a + 8 * CELL);
    const uint2 lo1 = load2(a + C2_SIDE * CELL);
    const uint2 hi1 = load2(a + (C2_SIDE + 8) * CELL);
    const uint4 rows[2] = {make_uint4(lo0.x, hi0.x, lo0.y, hi0.y),
                           make_uint4(lo1.x, hi1.x, lo1.y, hi1.y)};
    const int ws = OFF_W3 + (tap * 32 + g) * 16 + 4 * t;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma_step<PARTS, CHAINED>(acc[nt], rows, s_w + ws + nt * 8 * 16);
    }
  }
  if constexpr (OUT == OUT_SUMS) {
    // rows g and g + 8 of cell tile j: head cell (2 warp + j, g + 8 half)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gy = gy0 + 2 * warp + j, gx = gx0 + g + 8 * half;
        if (gy >= gh || gx >= gw) continue;
        float* dst = heads + 32 * (first_cell + (size_t)gy * gw + gx);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(dst + nt * 8 + 2 * t) = make_float2(
              acc[nt][j][2 * half], acc[nt][j][2 * half + 1]);
      }
    return;
  }
  // this thread's 8 channels of four cells: (row 2 warp + j, column g +
  // 8 half); its share of their six head sums, then the quad's total
  float z[4][6];
#pragma unroll
  for (int cell = 0; cell < 4; ++cell)
#pragma unroll
    for (int o = 0; o < 6; ++o) z[cell][o] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ch = nt * 8 + 2 * t + k;
      const float bias = s_f[F_B3 + ch], slope = s_f[F_A3 + ch];
      const float4 w03 = *reinterpret_cast<const float4*>(s_f + F_WH + ch * 8);
      const float2 w45 =
          *reinterpret_cast<const float2*>(s_f + F_WH + ch * 8 + 4);
#pragma unroll
      for (int cell = 0; cell < 4; ++cell) {
        const float a = round_bf16(
            prelu(acc[nt][cell / 2][2 * (cell % 2) + k] + bias, slope));
        z[cell][0] = fmaf(w03.x, a, z[cell][0]);
        z[cell][1] = fmaf(w03.y, a, z[cell][1]);
        z[cell][2] = fmaf(w03.z, a, z[cell][2]);
        z[cell][3] = fmaf(w03.w, a, z[cell][3]);
        z[cell][4] = fmaf(w45.x, a, z[cell][4]);
        z[cell][5] = fmaf(w45.y, a, z[cell][5]);
      }
    }
  }
#pragma unroll
  for (int cell = 0; cell < 4; ++cell)
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      z[cell][o] += __shfl_xor_sync(0xffffffffu, z[cell][o], 1);
      z[cell][o] += __shfl_xor_sync(0xffffffffu, z[cell][o], 2);
    }
  // thread t of the quad writes cell t
  float out[6];
#pragma unroll
  for (int o = 0; o < 6; ++o) {
    out[o] = t == 0 ? z[0][o] : t == 1 ? z[1][o] : t == 2 ? z[2][o] : z[3][o];
    out[o] += s_f[F_BH + o];
  }
  const int gy = gy0 + 2 * warp + t / 2, gx = gx0 + g + 8 * (t % 2);
  if (gy >= gh || gx >= gw) return;
  const size_t cell = first_cell + (size_t)gy * gw + gx;
  if constexpr (OUT == OUT_RAW) {
    float2* dst = reinterpret_cast<float2*>(heads + 6 * cell);
    dst[0] = make_float2(out[0], out[1]);
    dst[1] = make_float2(out[2], out[3]);
    dst[2] = make_float2(out[4], out[5]);
  } else {
    const float m = fmaxf(out[0], out[1]);
    const float e0 = expf(out[0] - m), e1 = expf(out[1] - m);
    probs[cell] = e1 / (e0 + e1);
    reinterpret_cast<float4*>(heads)[cell] =
        make_float4(out[2], out[3], out[4], out[5]);
  }
}

}  // namespace tc
}  // namespace pnet
