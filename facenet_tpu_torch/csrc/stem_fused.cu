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
// 0.33 MB in and out). Every intermediate stays on chip and the three convs
// run on the tensor cores (mma.sync m16n8k16, bf16 in, float32 sums). An
// item is one (image, 8x8 tile of pooled cells): from its 44x44 pixel patch
// it computes the 21x21x32 conv1 tile, the 19x19x32 conv2a tile and the
// 17x17x64 conv2b tile in shared memory and pools from there; the halo is
// recomputed (1.41x on conv2a, 1.13x on conv2b) and 37 = 4 * 8 + 5 leaves
// the last tile of a row 5/8 full.
//
// The grid is persistent: one block of 16 warps an SM, as two groups of 8
// warps that walk the items independently (group k of block b takes items
// 2 b + k, 2 b + k + 2 * gridDim.x, ...) and synchronize with their own
// named barrier. The block stages all three
// convs' weights and the biases (58,880 B) once, with cp.async, and keeps
// them; each group holds its own two activation regions. A group copies the
// next item's pixel patch with cp.async while it pools the current one.
//
// Each conv is an implicit GEMM: rows are the tile's cells in raster order,
// 16 to an mma tile; the depth is (tap, 16 input channels) for the 3x3
// convs and the 48 values of a cell's 4x4x3 pixel window for conv1. A warp
// takes MT cell tiles x NT column tiles of 8 channels at a time, so each A
// fragment feeds NT mma and each weight fragment MT: conv1 2 x 4, conv2a
// 3 x 4 (8 items, one for each warp), conv2b 2 x 4 in two whole rounds (16
// items) and its last 33 rows as six 1 x 4 items (1.02 shared loads an mma
// over the stem, 1.54 with one cell tile an item). What limits it is the
// balance of each conv's items on the 8 warps of a group, which wait for
// each other at the group's barrier: conv2b as 2 x 8 (10 items) does fewer
// loads an mma and takes 13% longer. Tiles are held cell-major, 48 halfs a
// cell for 32 channels (a 64-bit fragment load then touches each bank once:
// 24 words a cell), and within each group of 16 channels the order is
// (0 1 8 9 | 2 3 10 11 | 4 5 12 13 | 6 7 14 15): the four values that one
// thread feeds to one mma lie together and come with one 64-bit load. The
// weights are packed on the host in the same order ([depth step][output
// channel][16]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int GROUP_THREADS = 256;          // one group of 8 warps
constexpr int GROUPS = 2;
constexpr int THREADS = GROUPS * GROUP_THREADS;
constexpr int GROUP_WARPS = GROUP_THREADS / 32;
constexpr int IMAGE = 160;                 // input side, pixels
constexpr int OUT = 37;                    // pooled side
constexpr int P = 8;                       // pooled cells per tile side
constexpr int TILES = (OUT + P - 1) / P;   // 5 tiles a side
constexpr int C2B = 2 * P + 1;             // conv2b tile side (17)
constexpr int C2A = C2B + 2;               // conv2a tile side (19)
constexpr int C1 = C2A + 2;                // conv1 tile side (21)
constexpr int PIX = 2 * C1 + 2;            // pixel patch side (44)
constexpr int PIX_ROW = PIX * 3;           // halfs per patch row (132)
constexpr int CS = 48;                     // halfs per cell, 32 channels
constexpr int CS_OUT = 72;                 // halfs per cell, 64 channels

// The schedule: cell tiles (MT) and column tiles (NT) of 8 channels of a
// warp's item in each conv (conv1's and conv2a's NT is 4, all of their 32
// channels); ops/stem.py::SCHEDULE mirrors it.
constexpr int CONV1_MT = 2;
constexpr int CONV2A_MT = 3;
constexpr int CONV2B_MT = 2;
constexpr int CONV2B_NT = 4;
// conv2b's rows in whole rounds of MT x NT items on a group's warps (256 of
// 289); the rows left over run as 1 x NT items, which even out the warps'
// shares (a warp computes at most 5 cell tiles x 32 channels, not 6)
constexpr int C2B_ROWS = C2B * C2B;
constexpr int C2B_ROUND =
    GROUP_WARPS / (64 / (8 * CONV2B_NT)) * 16 * CONV2B_MT;
constexpr int C2B_WHOLE = C2B_ROWS - C2B_ROWS % C2B_ROUND;

// packed weights, mirrored by ops/stem.py: bf16 [depth step][co][16] per
// conv (conv1: 3 steps over the 48 window values; conv2a and conv2b: 18
// steps = 9 taps x 2 groups of 16 input channels), then 128 float32 biases
constexpr int OFF_W1 = 0;                  // 3 * 32 * 16
constexpr int OFF_W2 = 1536;               // 18 * 32 * 16
constexpr int OFF_W3 = 10752;              // 18 * 64 * 16
constexpr int OFF_BIAS = 29184;            // in halfs; 128 floats follow
constexpr int N_HALFS = OFF_BIAS + 256;

// a group's two regions: X holds conv1, then conv2b; Y the pixel patch,
// then conv2a, then the next item's patch
constexpr int IN_HALFS = PIX * PIX_ROW;                 // 5,808
constexpr int C1_HALFS = C1 * C1 * CS;                  // 21,168
constexpr int C2A_HALFS = C2A * C2A * CS;               // 17,328
constexpr int C2B_HALFS = C2B * C2B * CS_OUT;           // 20,808
constexpr int X_HALFS = C1_HALFS > C2B_HALFS ? C1_HALFS : C2B_HALFS;
constexpr int Y_HALFS = IN_HALFS > C2A_HALFS ? IN_HALFS : C2A_HALFS;
constexpr int GROUP_HALFS = X_HALFS + Y_HALFS;
constexpr int SMEM_BYTES = (N_HALFS + GROUPS * GROUP_HALFS) * 2;  // 212,864

static_assert(N_HALFS % 8 == 0 && X_HALFS % 8 == 0 && Y_HALFS % 8 == 0,
              "shared-memory regions must keep 16-byte alignment");
static_assert(SMEM_BYTES <= 232448, "more than a block's shared memory");
static_assert(PIX_ROW % 4 == 0 && (IMAGE * 3) % 4 == 0,
              "the patch is copied in 8-byte pieces");

typedef unsigned short bf16_t;             // bf16 bits

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

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from device memory into shared memory, asynchronously
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(shared_address(dst)), "l"(src));
}

// 8 bytes, or 8 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void copy8(void* dst, const void* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(shared_address(dst)), "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the barrier of one group of 8 warps (barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n"
               :: "r"(1 + group), "r"(GROUP_THREADS) : "memory");
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

// The pixel patch of `item` (zero beyond the image, which only cells beyond
// the valid output read), pixel-major, copied by one group asynchronously.
__device__ __forceinline__ void load_patch(bf16_t* s_in,
                                           const bf16_t* __restrict__ x,
                                           int item, int gtid) {
  const int img = item / (TILES * TILES), tile = item % (TILES * TILES);
  const int y0 = 4 * P * (tile / TILES), x0 = 4 * P * (tile % TILES);
  const bf16_t* image = x + (size_t)img * IMAGE * IMAGE * 3;
  const int row_halfs = min(PIX, IMAGE - x0) * 3;   // inside the image
  constexpr int PIECES = PIX_ROW / 4;               // 8 bytes each
  for (int i = gtid; i < PIX * PIECES; i += GROUP_THREADS) {
    const int r = i / PIECES, k = (i - r * PIECES) * 4;
    const int y = y0 + r;
    const bool inside = y < IMAGE && k < row_halfs;
    copy8(s_in + r * PIX_ROW + k,
          inside ? image + ((size_t)y * IMAGE + x0) * 3 + k : image, inside);
  }
}

// The epilogue of MT cell tiles x 32 channels whose output feeds another
// conv: bias, ReLU, bf16, stored cell-major in the channel order described
// at the top. acc[nt][m] holds channels nt * 8 + 2t, + 1 of rows g and
// g + 8 of cell tile m, whose first row is m0 + 16 m.
template <int MT>
__device__ __forceinline__ void store_permuted(bf16_t* s_dst,
                                               const float (&acc)[4][MT][4],
                                               const float* s_b, int m0,
                                               int m_total, int t) {
#pragma unroll
  for (int group = 0; group < 2; ++group) {        // 16 channels each
    const int even = 2 * group, odd = even + 1;    // n-tiles of the group
    const float be0 = s_b[even * 8 + 2 * t], be1 = s_b[even * 8 + 2 * t + 1];
    const float bo0 = s_b[odd * 8 + 2 * t], bo1 = s_b[odd * 8 + 2 * t + 1];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {       // rows g and g + 8
        const int row = m0 + 16 * m + 8 * half, e = 2 * half;
        if (row >= m_total) continue;
        uint2 v;
        v.x = relu_pack(acc[even][m][e], acc[even][m][e + 1], be0, be1);
        v.y = relu_pack(acc[odd][m][e], acc[odd][m][e + 1], bo0, bo1);
        *reinterpret_cast<uint2*>(s_dst + row * CS + group * 16 + 4 * t) = v;
      }
    }
  }
}

// conv1 as the 2x2 taps of the space-to-depth form, i.e. the 4x4 pixel
// window at (2i, 2j) x 3 channels (48 values, 3 depth steps) -> 32
// channels, on the tile's C1 x C1 conv1 cells; MT cell tiles a warp.
template <int MT>
__device__ __forceinline__ void conv1_mma(const bf16_t* s_in, bf16_t* s_c1,
                                          const bf16_t* s_w, const float* s_b,
                                          int gtid) {
  constexpr int M_TOTAL = C1 * C1;
  constexpr int ITEMS = (M_TOTAL + 16 * MT - 1) / (16 * MT);
  const int warp = gtid / 32, lane = gtid % 32;
  const int g = lane / 4, t = lane % 4;
  for (int item = warp; item < ITEMS; item += GROUP_WARPS) {
    const int m0 = item * 16 * MT + g;
    const bf16_t* a_lo[MT];
    const bf16_t* a_hi[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // rows past the tile compute the last cell again and store nothing
      const int c_lo = min(m0 + 16 * m, M_TOTAL - 1);
      const int c_hi = min(m0 + 16 * m + 8, M_TOTAL - 1);
      a_lo[m] = s_in + 2 * (c_lo / C1) * PIX_ROW + 6 * (c_lo % C1);
      a_hi[m] = s_in + 2 * (c_hi / C1) * PIX_ROW + 6 * (c_hi % C1);
    }
    float acc[4][MT][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][m][i] = 0.f;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      // window value k = py * 12 + px * 3 + c lies at row py, half k % 12
      const int k0 = 16 * s + 2 * t, k1 = k0 + 8;
      const int o0 = (k0 / 12) * PIX_ROW + k0 % 12;
      const int o1 = (k1 / 12) * PIX_ROW + k1 % 12;
      uint4 a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        a[m] = make_uint4(*reinterpret_cast<const unsigned*>(a_lo[m] + o0),
                          *reinterpret_cast<const unsigned*>(a_hi[m] + o0),
                          *reinterpret_cast<const unsigned*>(a_lo[m] + o1),
                          *reinterpret_cast<const unsigned*>(a_hi[m] + o1));
      const bf16_t* ws = s_w + (s * 32 + g) * 16 + 4 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint2 b = *reinterpret_cast<const uint2*>(ws + nt * 8 * 16);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[nt][m], a[m], b.x, b.y);
      }
    }
    store_permuted<MT>(s_c1, acc, s_b, m0, M_TOTAL, t);
  }
}

// VALID 3x3 conv over a cell-major tile: src [. x WI cells][CS] (32
// channels, permuted order) -> output rows (cells in raster order, WI - 2
// a line) [M_BEGIN, M_END) of N_OUT output channels with weights s_w
// [18][N_OUT][16] and biases s_b [N_OUT]. A warp takes MT cell tiles x NT
// column tiles. N_OUT = 32 (NT = 4) stores permuted at CS halfs a cell
// (input of the next conv); N_OUT = 64 stores the channels in their own
// order at CS_OUT halfs a cell.
template <int N_OUT, int MT, int NT, int WI, int M_BEGIN, int M_END>
__device__ __forceinline__ void conv3x3_mma(const bf16_t* s_src,
                                            bf16_t* s_dst, const bf16_t* s_w,
                                            const float* s_b, int gtid) {
  constexpr int WO = WI - 2;
  constexpr int M_TOTAL = M_END;
  constexpr int M_ITEMS = (M_END - M_BEGIN + 16 * MT - 1) / (16 * MT);
  constexpr int N_ITEMS = N_OUT / (8 * NT);
  static_assert(N_OUT != 32 || NT == 4, "a 32-channel output is one item");
  const int warp = gtid / 32, lane = gtid % 32;
  const int g = lane / 4, t = lane % 4;
  for (int item = warp; item < M_ITEMS * N_ITEMS; item += GROUP_WARPS) {
    const int mi = item % M_ITEMS, ni = item / M_ITEMS;
    const int m0 = M_BEGIN + mi * 16 * MT + g;
    const bf16_t* a_lo[MT];
    const bf16_t* a_hi[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // rows past the tile compute the last cell again and store nothing
      const int c_lo = min(m0 + 16 * m, M_TOTAL - 1);
      const int c_hi = min(m0 + 16 * m + 8, M_TOTAL - 1);
      a_lo[m] = s_src + ((c_lo / WO) * WI + c_lo % WO) * CS + 4 * t;
      a_hi[m] = s_src + ((c_hi / WO) * WI + c_hi % WO) * CS + 4 * t;
    }
    const bf16_t* w = s_w + (ni * NT * 8 + g) * 16 + 4 * t;
    float acc[NT][MT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][m][i] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          const int off = (ky * WI + kx) * CS + kc * 16;
          uint4 a[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const uint2 lo = *reinterpret_cast<const uint2*>(a_lo[m] + off);
            const uint2 hi = *reinterpret_cast<const uint2*>(a_hi[m] + off);
            a[m] = make_uint4(lo.x, hi.x, lo.y, hi.y);
          }
          const bf16_t* ws = w + ((ky * 3 + kx) * 2 + kc) * N_OUT * 16;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 b = *reinterpret_cast<const uint2*>(ws + nt * 8 * 16);
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_bf16(acc[nt][m], a[m], b.x, b.y);
          }
        }
    if constexpr (N_OUT == 32) {
      store_permuted<MT>(s_dst, acc, s_b, m0, M_TOTAL, t);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = (ni * NT + nt) * 8 + 2 * t;
        const float b0 = s_b[n], b1 = s_b[n + 1];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = m0 + 16 * m + 8 * half;
            if (row < M_TOTAL)
              *reinterpret_cast<unsigned*>(s_dst + row * CS_OUT + n) =
                  relu_pack(acc[nt][m][2 * half], acc[nt][m][2 * half + 1],
                            b0, b1);
          }
      }
    }
  }
}

// 3x3/s2 VALID max pool of one item's conv2b tile to its P x P pooled
// cells (those inside the output), two channels a thread, written as
// [b][y][x][c]. ReLU outputs are >= +0, so bf16 bits order as integers.
__device__ __forceinline__ void pool(const bf16_t* s_c2b,
                                     bf16_t* __restrict__ out, int item,
                                     int gtid) {
  const int img = item / (TILES * TILES), tile = item % (TILES * TILES);
  const int p0 = (tile / TILES) * P, q0 = (tile % TILES) * P;
  for (int i = gtid; i < P * P * 32; i += GROUP_THREADS) {
    const int cp = i % 32, cell = i / 32;
    const int p = cell / P, q = cell % P;
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

__global__ void __launch_bounds__(THREADS, 1)
stem_fused_kernel(const bf16_t* __restrict__ x,
                  const bf16_t* __restrict__ weights,
                  bf16_t* __restrict__ out, int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* s_w = reinterpret_cast<bf16_t*>(smem_raw);
  const float* s_b = reinterpret_cast<const float*>(s_w + OFF_BIAS);
  const int group = threadIdx.x / GROUP_THREADS;
  const int gtid = threadIdx.x % GROUP_THREADS;
  bf16_t* s_x = s_w + N_HALFS + group * GROUP_HALFS;  // conv1, conv2b
  bf16_t* s_y = s_x + X_HALFS;                        // patch, conv2a
  const int stride = gridDim.x * GROUPS;
  int item = blockIdx.x * GROUPS + group;

  // the weights and biases once for the block, each group's first patch
  for (int i = threadIdx.x; i < N_HALFS / 8; i += THREADS)
    copy16(s_w + 8 * i, weights + 8 * i);
  if (item < n_items) load_patch(s_y, x, item, gtid);
  copies_done();
  __syncthreads();

  for (; item < n_items; item += stride) {
    conv1_mma<CONV1_MT>(s_y, s_x, s_w + OFF_W1, s_b, gtid);
    group_sync(group);
    conv3x3_mma<32, CONV2A_MT, 4, C1, 0, C2A * C2A>(s_x, s_y, s_w + OFF_W2,
                                                    s_b + 32, gtid);
    group_sync(group);
    // conv2b: MT x NT items in whole rounds, then the rest as 1 x NT items
    // (289 rows: 16 items of 2 x 4, then 6 of 1 x 4)
    conv3x3_mma<64, CONV2B_MT, CONV2B_NT, C2A, 0, C2B_WHOLE>(
        s_y, s_x, s_w + OFF_W3, s_b + 64, gtid);
    conv3x3_mma<64, 1, CONV2B_NT, C2A, C2B_WHOLE, C2B_ROWS>(
        s_y, s_x, s_w + OFF_W3, s_b + 64, gtid);
    group_sync(group);
    // conv2a is dead: the next patch lands in its place while this item
    // pools
    if (item + stride < n_items) load_patch(s_y, x, item + stride, gtid);
    pool(s_x, out, item, gtid);
    copies_done();
    group_sync(group);
  }
}

}  // namespace

// x: bf16 [batch, 160, 160, 3]; weights: the packed vector on the card (bf16
// kernels, then float32 biases; n_halfs 16-bit values in all, 16-byte
// aligned); out: bf16 [batch, 37, 37, 64]. One block an SM of the current
// device, or fewer for a small batch. Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int stem_fused_launch(const void* x, int batch,
                                 const void* weights, int n_halfs, void* out,
                                 void* stream) {
  if (batch < 1 || n_halfs != N_HALFS ||
      (long long)batch * TILES * TILES > 2147483647LL / 2) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  // the opt-in applies to the current device only, so it is set on every
  // launch (a cheap host call) rather than once per process
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int items = batch * TILES * TILES;
  const int wanted = (items + GROUPS - 1) / GROUPS;
  const int blocks = sms < wanted ? sms : wanted;
  stem_fused_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const bf16_t*>(x), static_cast<const bf16_t*>(weights),
      static_cast<bf16_t*>(out), items);
  return (int)cudaGetLastError();
}
