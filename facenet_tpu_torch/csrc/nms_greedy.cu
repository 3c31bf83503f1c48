// Exact greedy non-maximum suppression over score-sorted candidates, in two
// launches: a bitmask of the pairs that overlap, then a scan a frame.
//
// Replaces no Pallas TPU kernel: the JAX package's greedy NMS
// (facenet_tpu/ops/nms.py::nms_mask) is a K-step loop that XLA compiles
// into one program. On the card the same loop is K steps of small tensor
// operations, each a few launches: at RetinaFace's K = 5,000 some 20,000
// launches a batch, over 100 ms of host issue. The kernel keeps exactly
// what that loop (ops/nms.py::greedy_keep_plain) keeps.
//
// Candidates arrive sorted by descending score (ties by index), boxes
// (x1, y1, x2, y2), with a validity mask; invalid candidates are never kept
// and suppress nothing. For candidates i < j, j is suppressed by i when i is
// kept and
//
//   w = clamp(min(x2_i, x2_j) - max(x1_i, x1_j) + off, 0)   (h likewise)
//   inter = w * h
//   denom = (area_i + area_j) - inter   ('union')  |  min(area_i, area_j)
//   inter / clamp(denom, 1e-10) > threshold
//
// with area = clamp(x2 - x1 + off, 0) * clamp(y2 - y1 + off, 0), off 0 (the
// port's MTCNN and Faster-RCNN) or 1 (RetinaFace's py_cpu_nms). Every step
// is rounded as the loop's float32 tensor operations round it (no fused
// multiply-add, IEEE division), and max, min and clamp pass a NaN through
// as torch.maximum, torch.minimum and torch.clamp do, so each pair's
// verdict is the loop's.
//
// Phase 1 (nms_greedy_mask_kernel): one block of 64 threads a 64 x 64 tile
// of pairs at or above the diagonal; thread r holds candidate i = 64 * row
// + r and writes one 64-bit word: bit t set when i overlaps candidate
// 64 * col + t and that candidate comes after i. Tiles below the diagonal
// are never written nor read. The work is n(n - 1) / 2 pair tests of ~15
// float32 operations each, bound by the FP32 pipes: 1.5e9 operations for 8
// frames of 5,000, 22 us at 67 TFLOP/s.
//
// Phase 2 (nms_greedy_scan_kernel): one block a frame walks the words in
// order with a removed-bitset in shared memory. For word w, its 64 diagonal
// rows are loaded into shared memory together, one thread decides the 64
// candidates in order (kept when valid and not removed, then its row's
// diagonal word ORed into the removed word), and the block's 512 threads
// then OR the kept rows' words w' > w into the bitset (shared-memory
// atomics), every (row, word) pair a thread of its own, so that their
// loads from L2, where phase 1 left the mask, overlap. Three barriers a
// word; the serial chain of greedy decisions is 64 steps a word. The scan
// counts every kept candidate; the first `max_keep` of them are marked in
// `keep`, and the count goes to `kept`, so the caller learns how many the
// capacity lost.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;             // candidates a mask word covers
constexpr int SCAN_THREADS = 512;

typedef unsigned long long Word;

// torch.maximum / torch.minimum: a NaN operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float area(float4 b, float off) {
  const float w = clamp_lo(__fadd_rn(__fsub_rn(b.z, b.x), off), 0.f);
  const float h = clamp_lo(__fadd_rn(__fsub_rn(b.w, b.y), off), 0.f);
  return __fmul_rn(w, h);
}

// whether the earlier candidate a suppresses the later b
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float threshold,
                                         float off, bool min_mode) {
  const float x1 = nan_max(a.x, b.x), y1 = nan_max(a.y, b.y);
  const float x2 = nan_min(a.z, b.z), y2 = nan_min(a.w, b.w);
  const float w = clamp_lo(__fadd_rn(__fsub_rn(x2, x1), off), 0.f);
  const float h = clamp_lo(__fadd_rn(__fsub_rn(y2, y1), off), 0.f);
  const float inter = __fmul_rn(w, h);
  const float denom = min_mode ? nan_min(area_a, area_b)
                               : __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, clamp_lo(denom, 1e-10f)) > threshold;
}

__global__ void __launch_bounds__(TILE)
nms_greedy_mask_kernel(const float4* __restrict__ boxes, int k, int words,
                       float threshold, float off, int min_mode,
                       Word* __restrict__ mask) {
  const int col = blockIdx.x, row = blockIdx.y;
  if (col < row) return;
  __shared__ float4 cols[TILE];
  __shared__ float col_area[TILE];
  const float4* frame = boxes + (long long)blockIdx.z * k;
  const int j0 = col * TILE;
  const int n = min(k - j0, TILE);
  if (threadIdx.x < n) {
    const float4 b = frame[j0 + threadIdx.x];
    cols[threadIdx.x] = b;
    col_area[threadIdx.x] = area(b, off);
  }
  __syncthreads();
  const int i = row * TILE + threadIdx.x;
  if (i >= k) return;
  const float4 a = frame[i];
  const float area_a = area(a, off);
  Word bits = 0;
  for (int t = col == row ? threadIdx.x + 1 : 0; t < n; ++t) {
    if (overlaps(a, area_a, cols[t], col_area[t], threshold, off,
                 min_mode != 0)) {
      bits |= 1ull << t;
    }
  }
  mask[((long long)blockIdx.z * k + i) * words + col] = bits;
}

__global__ void __launch_bounds__(SCAN_THREADS)
nms_greedy_scan_kernel(const Word* __restrict__ mask,
                       const unsigned char* __restrict__ valid, int k,
                       int words, int max_keep,
                       unsigned char* __restrict__ keep,
                       int* __restrict__ kept) {
  extern __shared__ Word removed[];        // [words]
  __shared__ Word diagonal[TILE];
  __shared__ unsigned char live[TILE];
  __shared__ unsigned char rows[TILE];     // this word's kept candidates
  __shared__ Word marked_word;
  __shared__ int count, n_kept;
  const long long frame = blockIdx.x;
  const Word* m = mask + frame * k * words;
  const unsigned char* v = valid + frame * k;
  unsigned char* out = keep + frame * k;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0;
  if (threadIdx.x == 0) count = 0;
  for (int w = 0; w < words; ++w) {
    const int i0 = w * TILE;
    const int n = min(k - i0, TILE);
    if (threadIdx.x < n) {
      diagonal[threadIdx.x] = m[(long long)(i0 + threadIdx.x) * words + w];
      live[threadIdx.x] = v[i0 + threadIdx.x];
    }
    __syncthreads();                       // the tile and removed[w] ready
    if (threadIdx.x == 0) {
      Word r = removed[w], marked = 0;
      int c = count, nk = 0;
      for (int t = 0; t < n; ++t) {
        if (live[t] && !((r >> t) & 1ull)) {
          rows[nk++] = (unsigned char)t;
          if (c < max_keep) marked |= 1ull << t;
          ++c;
          r |= diagonal[t];
        }
      }
      count = c;
      n_kept = nk;
      marked_word = marked;
    }
    __syncthreads();                       // this word's verdicts ready
    if (threadIdx.x < n) {
      out[i0 + threadIdx.x] = (marked_word >> threadIdx.x) & 1ull;
    }
    // the kept rows' later words, (row, word) pairs spread over the
    // block, neighbouring threads on neighbouring words of a row
    const int span = words - w - 1;
    const int total = n_kept * span;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int r = e / span, u = w + 1 + (e - r * span);
      const Word bits = m[(long long)(i0 + rows[r]) * words + u];
      if (bits) atomicOr(&removed[u], bits);
    }
    __syncthreads();                       // before the next tile loads
  }
  if (threadIdx.x == 0) kept[frame] = count;
}

}  // namespace

// boxes [b, k, 4] f32 in descending score order, valid [b, k] bool ->
// keep [b, k] bool (the first max_keep kept candidates), kept [b] int32
// (every kept candidate), through mask, a [b, k, ceil(k / 64)] uint64
// scratch. mode_min selects the intersection over the smaller area.
// Launches on `stream`; returns the cudaError_t of the launches.
extern "C" int nms_greedy_launch(const float* boxes,
                                 const unsigned char* valid, int b, int k,
                                 float threshold, float offset, int mode_min,
                                 int max_keep, void* mask,
                                 unsigned char* keep, int* kept,
                                 void* stream) {
  if (b < 1 || k < 1 || b > 65535 || max_keep < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int words = (k + TILE - 1) / TILE;
  if (words > 65535 || (long long)words * sizeof(Word) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(words, words, b);
  nms_greedy_mask_kernel<<<grid, TILE, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), k, words, threshold, offset,
      mode_min, static_cast<Word*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_greedy_scan_kernel<<<b, SCAN_THREADS, words * sizeof(Word), s>>>(
      static_cast<const Word*>(mask), valid, k, words, max_keep, keep, kept);
  return (int)cudaGetLastError();
}
