// Weighted below-threshold pair counts over all unordered embedding pairs.
//
// Replaces the Pallas TPU kernel facenet_tpu/ops/pallas_stats.py::_kernel
// (pallas_call in _pair_below_counts_padded). For L2-normalized float32
// embeddings E [N, D] and int32 labels, every pair i < j gets
//     s = clip(<e_i, e_j>, -1, 1)            (full float32 FFMA, no TF32)
//     bin = #{k : cutoffs[k] >= s}           (cutoffs non-increasing)
// and adds its weight (w_pos[i] for a same-label pair, inv_n[i] * inv_n[j]
// otherwise) to hist[side][bin], side 0 = positive, 1 = negative.
// hist is float64 [2, T + 1]; a cumulative sum over bins gives, for
// threshold k, the weight of pairs with s > cutoffs[k] (distance < t_k).
// The [N, N] similarity matrix never reaches device memory.
//
// Bound on an H100: operations. The product takes N(N-1)/2 * 2D float32
// operations (67 TFLOP/s outside the tensor cores) for N*D*4 bytes read.
// Design: one block per upper-triangle 64x64 tile pair (bi <= bj), decoded
// from a linear block index; 256 threads each hold a 4x4 register tile of
// sums; 32-wide D chunks of both tiles are staged in shared memory. The
// epilogue bins each pair by binary search over the cutoffs in shared
// memory and adds its weight to a shared float64 histogram; at block end the
// block's histogram goes to the global float64 one with atomicAdd, so the
// cross-block sum carries no float32 rounding. Tensor cores (3xTF32 or
// wgmma) and a warp-aggregated histogram are left for later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;      // rows and columns of one tile
constexpr int KC = 32;        // D chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 pairs each
constexpr int MAX_BINS = 128; // T + 1 <= MAX_BINS

__global__ void __launch_bounds__(THREADS)
pair_below_counts_kernel(const float* __restrict__ emb,
                         const int* __restrict__ labels,
                         const double* __restrict__ w_pos,
                         const double* __restrict__ inv_n,
                         const float* __restrict__ cutoffs,
                         int n, int d, int t, long long nb,
                         double* __restrict__ hist) {
  __shared__ float rows[KC][TILE + 1];
  __shared__ float cols[KC][TILE + 1];
  __shared__ float cut[MAX_BINS];
  __shared__ double h[2][MAX_BINS];
  __shared__ int lab_r[TILE], lab_c[TILE];
  __shared__ double wpos_r[TILE], invn_r[TILE], invn_c[TILE];

  // linear block index -> (bi, bj), bi <= bj; row bi starts at
  // bi * nb - bi * (bi - 1) / 2
  const long long lin = blockIdx.x;
  const double b2 = 2.0 * (double)nb + 1.0;
  long long bi = (long long)floor((b2 - sqrt(b2 * b2 - 8.0 * (double)lin)) * 0.5);
  if (bi < 0) bi = 0;
  if (bi > nb - 1) bi = nb - 1;
  while (bi > 0 && bi * nb - bi * (bi - 1) / 2 > lin) --bi;
  while (bi + 1 < nb && (bi + 1) * nb - (bi + 1) * bi / 2 <= lin) ++bi;
  const long long bj = bi + (lin - (bi * nb - bi * (bi - 1) / 2));
  const int row0 = (int)(bi * TILE);
  const int col0 = (int)(bj * TILE);

  const int tid = threadIdx.x;
  for (int i = tid; i < t; i += THREADS) cut[i] = cutoffs[i];
  for (int i = tid; i < 2 * MAX_BINS; i += THREADS) (&h[0][0])[i] = 0.0;
  if (tid < TILE) {
    const int gr = row0 + tid, gc = col0 + tid;
    lab_r[tid] = gr < n ? labels[gr] : -1;
    wpos_r[tid] = gr < n ? w_pos[gr] : 0.0;
    invn_r[tid] = gr < n ? inv_n[gr] : 0.0;
    lab_c[tid] = gc < n ? labels[gc] : -1;
    invn_c[tid] = gc < n ? inv_n[gc] : 0.0;
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KC) {
    // consecutive threads read consecutive k of one row: coalesced
    for (int idx = tid; idx < TILE * KC; idx += THREADS) {
      const int r = idx / KC, k = idx % KC, gk = k0 + k;
      const int gr = row0 + r, gc = col0 + r;
      rows[k][r] = (gr < n && gk < d) ? emb[(long long)gr * d + gk] : 0.f;
      cols[k][r] = (gc < n && gk < d) ? emb[(long long)gc * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = rows[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = cols[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, gi = row0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, gj = col0 + c;
      if (gi < gj && gj < n) {
        // the clip matters: two near-identical unit vectors can give
        // 1.0000001, which would pass the t = 0 cutoff of exactly 1.0
        const float s = fminf(fmaxf(acc[i][j], -1.f), 1.f);
        int lo = 0, hi = t;  // first k with s > cut[k]
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s > cut[mid]) hi = mid; else lo = mid + 1;
        }
        const bool pos = lab_r[r] == lab_c[c];
        const double w = pos ? wpos_r[r] : invn_r[r] * invn_c[c];
        atomicAdd(&h[pos ? 0 : 1][lo], w);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * (t + 1); i += THREADS) {
    const int side = i / (t + 1), bin = i % (t + 1);
    const double v = h[side][bin];
    if (v != 0.0) atomicAdd(&hist[i], v);
  }
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
  pair_below_counts_kernel<<<(unsigned)blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(
      emb, labels, w_pos, inv_n, cutoffs, n, d, t, nb, hist);
  return (int)cudaGetLastError();
}
