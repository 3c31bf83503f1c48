// Weighted below-threshold pair counts over all unordered embedding pairs.
//
// Replaces the Pallas TPU kernel facenet_tpu/ops/pallas_stats.py::_kernel
// (pallas_call in _pair_below_counts_padded). For L2-normalized float32
// embeddings E [N, D] and int32 labels, every pair i < j gets
//     s = clip(<e_i, e_j>, -1, 1)            (float32 accuracy, see below)
//     bin = #{k : cutoffs[k] >= s}           (cutoffs non-increasing)
// and adds its weight (w_pos[i] for a same-label pair, inv_n[i] * inv_n[j]
// otherwise) to hist[side][bin], side 0 = positive, 1 = negative.
// hist is float64 [2, T + 1]; a cumulative sum over bins gives, for
// threshold k, the weight of pairs with s > cutoffs[k] (distance < t_k).
// The [N, N] similarity matrix never reaches device memory.
//
// Bound on an H100: operations. The product takes N(N-1)/2 * 2D operations
// for N*D*4 bytes read; at float32 accuracy on the tensor cores it costs
// three TF32 products (495 TFLOP/s), against 67 TFLOP/s on the FP32 pipes.
//
// Design. One block of 8 warps per upper-triangle pair of 128-row tiles
// (bi <= bj, decoded from a linear block index that walks bands of BAND row
// tiles column by column, so the blocks in flight share their tiles in the
// L2); a warp owns 64 x 32 pairs as 4 x 4 mma.sync m16n8k8 tiles.
//   Product, "3xTF32": each staged float x splits in registers into
// hi = tf32(x) and lo = tf32(x - hi); <a, b> ~ lo_a hi_b + hi_a lo_b +
// hi_a hi_b, the small terms first, which leaves out only lo_a lo_b (2^-22
// of a product). (The split's rounding runs on the integer pipe: with
// cvt.rna.tf32.f32 the kernel took 0.9 ms more at N = 23,840, with a split
// in float32 arithmetic 0.5 ms more.) The tensor core truncates its float32 sums instead of
// rounding them, and a chain of 192 mma on one accumulator drifts by more
// than float32 allows, so the three mma of one 8-deep step start from zero
// and their sum is added to the accumulator with a float32 add outside the
// tensor core (round to nearest).
//   Staging: cp.async, 16 bytes a thread, into a ring of STAGES 32-deep
// chunks of both tiles; rows are 36 floats apart so that the 8 rows x 4
// depths of a fragment load fall into 32 different banks. Rows beyond N and
// depths beyond D are zero-filled by the copy; when D is no multiple of 4
// (rows not 16-byte aligned) the copies are 4 bytes each.
//   Epilogue without a shared atomic per pair (a float64 atomicAdd on
// shared memory is a compare-and-swap loop, and the negatives of an
// embedding set crowd into a few bins): the block picks a window of WINDOW
// consecutive bins around the bin of its mean similarity, and every thread
// owns one float64 sum per bin of the window in the dead ring
// ([WINDOW][THREADS], so a warp's accesses fall into different banks
// whatever the bins). A pair is binned by bisection over the cutoffs and
// added to its thread's own sum with a plain load, add and store. Only
// positive pairs (one in a thousand) and negatives outside the window take
// a shared float64 atomicAdd. The threads' sums are then added up bin by
// bin, and at block end the block's histogram goes to the global float64
// one with atomicAdd, so no sum carries a float32 rounding.
//
// pair_similarities_launch runs the same product and writes the clipped
// [N, N] similarities, so that a test can hold the arithmetic itself
// against a float64 product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;      // rows and columns of one block tile
constexpr int KC = 32;         // D chunk of one ring stage
constexpr int PITCH = KC + 4;  // floats between staged rows
constexpr int STAGES = 3;      // ring depth
constexpr int THREADS = 256;   // 8 warps, 2 (rows) x 4 (columns)
constexpr int MAX_BINS = 128;  // T + 1 <= MAX_BINS
constexpr int WINDOW = 32;     // bins with a private sum for every thread
constexpr int BAND = 8;        // row tiles walked together
constexpr int CUT_FLOATS = MAX_BINS + WINDOW + 8;
constexpr int STAGE_FLOATS = 2 * TILE * PITCH;  // row tile, then column tile
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;

static_assert(WINDOW * THREADS * 8 + 2 * MAX_BINS * 8 + 3 * TILE * 8 +
                      CUT_FLOATS * 4 + 2 * TILE * 4 + THREADS / 32 * 4 <=
                  SMEM_BYTES,
              "the epilogue's tables reuse the ring");

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Copies of `BYTES` each: depths [k0, k0 + KC) of the row tile at row0 and
// of the column tile at col0 into one stage, zeros beyond (n, d).
template <int BYTES>
__device__ __forceinline__ void stage_copies(float* stage,
                                             const float* __restrict__ emb,
                                             int n, int d, int row0, int col0,
                                             int k0) {
  constexpr int PER = BYTES / 4;        // floats a copy
  constexpr int PER_ROW = KC / PER;     // copies a row
  for (int i = threadIdx.x; i < 2 * TILE * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * PER;
    const int gr = r < TILE ? row0 + r : col0 + r - TILE;
    const bool ok = gr < n && k0 + c < d;
    const float* src = ok ? emb + (size_t)gr * d + k0 + c : emb;
    cp_async<BYTES>(stage + r * PITCH + c, src, ok ? BYTES : 0);
  }
}

// x = hi + lo + (at most 2^-23 |x|): hi is x rounded to TF32's 11
// significant bits (half a unit of its last place added to the magnitude
// bits, the 13 bits below dropped: two operations on the integer pipe, which
// the float32 adds of the main loop leave idle), lo = x - hi exactly; the
// tensor core reads the TF32 part of lo.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// D = A (16x8, row) * B (8x8, col) + C, TF32 in, float32 sums. With g =
// lane / 4 and t = lane % 4: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; d0, d1 = D[g][2t, 2t+1],
// d2, d3 = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_tf32_from_zero(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mt][nt][i] = <e_row, e_col> for the warp's 64 x 32 pairs of the tile
// pair (row0, col0): row = row0 + wm * 64 + mt * 16 + g + 8 * (i / 2),
// col = col0 + wn * 32 + nt * 8 + 2 * t + i % 2. `smem` is SMEM_BYTES of
// dynamic shared memory, free again on return; every thread of the block
// must call this function (it synchronizes the block).
__device__ __forceinline__ void tile_product(const float* __restrict__ emb,
                                             int n, int d, int row0, int col0,
                                             bool aligned, float* smem,
                                             float (&acc)[4][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int nk = (d + KC - 1) / KC;

  auto stage_chunk = [&](int chunk) {
    float* stage = smem + (chunk % STAGES) * STAGE_FLOATS;
    if (aligned) {
      stage_copies<16>(stage, emb, n, d, row0, col0, chunk * KC);
    } else {
      stage_copies<4>(stage, emb, n, d, row0, col0, chunk * KC);
    }
  };

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage_chunk(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    // chunk kc has landed, and every warp is done with chunk kc - 1, whose
    // stage the next copies overwrite
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kc + STAGES - 1 < nk) stage_chunk(kc + STAGES - 1);
    cp_async_commit();

    const float* stage = smem + (kc % STAGES) * STAGE_FLOATS;
    const float* sa = stage + (wm * 64 + g) * PITCH + t;
    const float* sb = stage + (TILE + wn * 32 + g) * PITCH + t;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split_tf32(sb[nt * 8 * PITCH + ks], bh[nt][0], bl[nt][0]);
        split_tf32(sb[nt * 8 * PITCH + ks + 4], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* p = sa + mt * 16 * PITCH + ks;
        uint32_t ah[4], al[4];
        split_tf32(p[0], ah[0], al[0]);
        split_tf32(p[8 * PITCH], ah[1], al[1]);
        split_tf32(p[4], ah[2], al[2]);
        split_tf32(p[8 * PITCH + 4], ah[3], al[3]);
        float step[4][4];  // four independent chains of three mma
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32_from_zero(step[nt], al, bh[nt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(step[nt], ah, bl[nt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(step[nt], ah, bh[nt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], step[nt][i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the clip matters: two near-identical unit vectors can give 1.0000001,
// which would pass the t = 0 cutoff of exactly 1.0
__device__ __forceinline__ float clip_unit(float s) {
  return fminf(fmaxf(s, -1.f), 1.f);
}

// #{k : cut[k] >= s} by bisection; edge[1 + k] = cut[k], -inf from k = t on
__device__ __forceinline__ int find_bin(const float* edge, float s) {
  int bin = 0;
#pragma unroll
  for (int step = 64; step > 0; step >>= 1)
    if (!(s > edge[bin + step])) bin += step;
  return bin;
}

// linear block index -> (bi, bj), bi <= bj: bands of BAND row tiles, each
// walked column by column (column bj of the band at b0 holds the row tiles
// b0 .. min(b0 + BAND - 1, bj))
__device__ __forceinline__ void decode_block(long long lin, int nb, int* bi,
                                             int* bj) {
  int b0 = 0, h;
  for (;;) {
    h = min(BAND, nb - b0);
    const long long blocks = (long long)h * (nb - b0) - h * (h - 1) / 2;
    if (lin < blocks) break;
    lin -= blocks;
    b0 += BAND;
  }
  int rem = (int)lin, c = 0;
  const int triangle = h * (h + 1) / 2;  // the band's first h columns
  if (rem < triangle) {
    while (rem > c) rem -= ++c;
  } else {
    rem -= triangle;
    c = h + rem / h;
    rem %= h;
  }
  *bi = b0 + rem;
  *bj = b0 + c;
}

__global__ void __launch_bounds__(THREADS, 2)
pair_below_counts_kernel(const float* __restrict__ emb,
                         const int* __restrict__ labels,
                         const double* __restrict__ w_pos,
                         const double* __restrict__ inv_n,
                         const float* __restrict__ cutoffs, int n, int d,
                         int t, int nb, bool aligned,
                         double* __restrict__ hist) {
  extern __shared__ __align__(16) float smem[];
  int bi, bj;
  decode_block(blockIdx.x, nb, &bi, &bj);
  const int row0 = bi * TILE, col0 = bj * TILE;
  const int tid = threadIdx.x;

  // this thread's share of the epilogue's tables, fetched before the product
  // so that the loads are long done when it ends: row tid, or column
  // tid - TILE
  const int mine = tid < TILE ? row0 + tid : col0 + tid - TILE;
  const int my_label = mine < n ? labels[mine] : -1;
  const double my_inv_n = mine < n ? inv_n[mine] : 0.0;
  const double my_w_pos = (tid < TILE && mine < n) ? w_pos[mine] : 0.0;

  float acc[4][4][4];
  tile_product(emb, n, d, row0, col0, aligned, smem, acc);

  // ---- tables and the private sums over the dead ring
  double* priv = reinterpret_cast<double*>(smem);     // [WINDOW][THREADS]
  double* h = priv + WINDOW * THREADS;                // [2][MAX_BINS]
  double* wpos_r = h + 2 * MAX_BINS;
  double* invn_r = wpos_r + TILE;
  double* invn_c = invn_r + TILE;
  float* edge = reinterpret_cast<float*>(invn_c + TILE);  // [CUT_FLOATS]
  int* lab_r = reinterpret_cast<int*>(edge + CUT_FLOATS);
  int* lab_c = lab_r + TILE;
  float* warp_mean = reinterpret_cast<float*>(lab_c + TILE);  // [8]
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < WINDOW; ++j) priv[j * THREADS + tid] = 0.0;
  h[tid] = 0.0;
  if (tid < CUT_FLOATS)
    edge[tid] = tid == 0 ? INFINITY
                         : (tid <= t ? cutoffs[tid - 1] : -INFINITY);
  if (tid < TILE) {
    lab_r[tid] = my_label;
    wpos_r[tid] = my_w_pos;
    invn_r[tid] = my_inv_n;
  } else {
    lab_c[tid - TILE] = my_label;
    invn_c[tid - TILE] = my_inv_n;
  }
  // the block's mean similarity over 1024 samples (every row tile's first
  // element of every thread) centres its window of bins
  float mean = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) mean += clip_unit(acc[mt][0][0]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) mean += __shfl_xor_sync(0xffffffffu, mean, m);
  if (lane == 0) warp_mean[warp] = mean;
  __syncthreads();
  mean = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) mean += warp_mean[w];
  const int first =
      max(0, min(find_bin(edge, mean * (1.f / (4 * THREADS))) - WINDOW / 2 + 1,
                 t + 1 - WINDOW));

  const int wm = warp / 4, wn = warp % 4;
  const int r_base = wm * 64 + lane / 4, c_base = wn * 32 + 2 * (lane % 4);
  double* mine_sums = priv + tid;   // bin first + j at mine_sums[j * THREADS]
  int label_c[8];                   // this thread's 8 columns
  double inv_c[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    label_c[q] = lab_c[c_base + (q / 2) * 8 + q % 2];
    inv_c[q] = invn_c[c_base + (q / 2) * 8 + q % 2];
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_base + mt * 16 + 8 * half, gi = row0 + r;
      const int label = lab_r[r];
      const double inv_r = invn_r[r];
      // the row's 8 bisections first, independent of each other, then its
      // 8 sums
      int bin[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        bin[q] = find_bin(edge, clip_unit(acc[mt][q / 2][2 * half + q % 2]));
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int gj = col0 + c_base + (q / 2) * 8 + q % 2;
        const bool valid = gi < gj && gj < n;
        const bool pos = label == label_c[q];
        const double w_neg = inv_r * inv_c[q];
        const unsigned slot = (unsigned)(bin[q] - first);
        const bool inside = slot < (unsigned)WINDOW;
        // a negative pair inside the window: this thread's own sum, no
        // atomic; anything else adds zero there
        double* own = mine_sums + (inside ? slot : 0u) * THREADS;
        *own += (valid && !pos && inside) ? w_neg : 0.0;
        if (valid && (pos || !inside))
          atomicAdd(&h[(pos ? 0 : MAX_BINS) + bin[q]],
                    pos ? wpos_r[r] : w_neg);
      }
    }
  }
  __syncthreads();

  // ---- the threads' sums of one bin: added up by one warp, which alone
  // writes that bin of the block's histogram now
  for (int j = warp; j < WINDOW; j += THREADS / 32) {
    double v = 0.0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) v += priv[j * THREADS + lane + 32 * i];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (lane == 0 && first + j <= t) h[MAX_BINS + first + j] += v;
  }
  __syncthreads();
  for (int i = tid; i < 2 * (t + 1); i += THREADS) {
    const int side = i / (t + 1), bin = i % (t + 1);
    const double v = h[side * MAX_BINS + bin];
    if (v != 0.0) atomicAdd(&hist[i], v);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
pair_similarities_kernel(const float* __restrict__ emb, int n, int d,
                         bool aligned, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  float acc[4][4][4];
  tile_product(emb, n, d, row0, col0, aligned, smem, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_base = row0 + (warp / 4) * 64 + lane / 4;
  const int c_base = col0 + (warp % 4) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = r_base + mt * 16 + 8 * (i / 2);
        const int gj = c_base + nt * 8 + i % 2;
        if (gi < n && gj < n)
          out[(size_t)gi * n + gj] = clip_unit(acc[mt][nt][i]);
      }
}

// 16-byte copies need 16-byte aligned rows
bool rows_aligned(const float* emb, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
}

// The shared-memory opt-in applies to the current device only, so it is
// set on every launch (a cheap host call) rather than once per process.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// hist must be zeroed by the caller; nothing here allocates or synchronizes.
extern "C" int pair_below_counts_launch(const float* emb, const int* labels,
                                        const double* w_pos,
                                        const double* inv_n,
                                        const float* cutoffs, int n, int d,
                                        int t, double* hist, void* stream) {
  if (n < 1 || d < 1 || t < 0 || t + 1 > MAX_BINS) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nb = (n + TILE - 1) / TILE;
  const long long blocks = nb * (nb + 1) / 2;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in(pair_below_counts_kernel);
  if (err != cudaSuccess) return (int)err;
  pair_below_counts_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      emb, labels, w_pos, inv_n, cutoffs, n, d, t, (int)nb,
      rows_aligned(emb, d), hist);
  return (int)cudaGetLastError();
}

// out [n, n] float32: clip(<e_i, e_j>, -1, 1) for every i and j, by the
// product code of the counts kernel (a test's view of its arithmetic; the
// grid's second dimension bounds n at 65535 * 128 rows).
extern "C" int pair_similarities_launch(const float* emb, int n, int d,
                                        float* out, void* stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)((n + TILE - 1) / TILE);
  if (nb > 65535u) return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in(pair_similarities_kernel);
  if (err != cudaSuccess) return (int)err;
  pair_similarities_kernel<<<dim3(nb, nb), THREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      emb, n, d, rows_aligned(emb, d), out);
  return (int)cudaGetLastError();
}
