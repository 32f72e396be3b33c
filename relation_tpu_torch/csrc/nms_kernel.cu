// Exact greedy NMS over score-sorted boxes, batched over classes.
//
// Replaces relation_tpu/ops/pallas/nms_kernel.py::nms_keep_sorted (the Pallas
// _nms_kernel), in the bitmask form of the original CUDA code
// (lib/nms/nms_kernel.cu of the reference, named in ops/nms.py):
//
//   1. nms_mask_kernel, parallel: for box i and each 64-box column block at
//      or after i's, a 64-bit word whose bit t says that i suppresses box
//      j = 64*block + t > i. Predicate of the TPU kernel, divide-free, with
//      the +1 width convention: inter > thresh * (area_i + area_j - inter).
//   2. nms_sweep_kernel, one block per class: walk the sorted boxes a 64-box
//      word at a time and keep a box unless an earlier kept box suppressed
//      it. Invalid boxes count as suppressed, so they are never kept and
//      never suppress. The sweep stops at the first `block` boundary at
//      which `max_keep` boxes are kept, as the Pallas kernel does, so the
//      keep mask is the same bit for bit.
//
// boxesT [C, 4, Np] f32, valid [C, Np] f32 -> keep [C, Np] f32 (0/1);
// scratch mask [C, Np, Np/64] u64, allocated by the caller.
//
// What bounds it on the H100: the IoU pass is about 15 flops for each of the
// pairs the greedy walk needs (at most Np^2/2: 6144^2/2 = 19 M for the RPN,
// about 4 us at 67 TFLOP/s); its input and output are a few hundred KB. The
// sweep is a serial chain over the words: its cost is latency, about one
// round of device-memory loads per 64 boxes, not throughput. The mask pass
// computes only the upper triangle; the sweep gathers each word's
// suppression bits from all kept boxes at once, so the chain has one load
// latency per word instead of one per kept box.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 64;

__device__ __forceinline__ bool suppresses(float ax1, float ay1, float ax2,
                                           float ay2, float a_area, float bx1,
                                           float by1, float bx2, float by2,
                                           float b_area, float thresh) {
  // explicit _rn intrinsics: nvcc must not contract these into FMAs, or the
  // rounding (and so an exact-threshold decision) would differ from the
  // plain version and from the TPU kernel
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 1.f), 0.f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 1.f), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(a_area, b_area), inter);
  return inter > __fmul_rn(thresh, uni);
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.f), __fadd_rn(__fsub_rn(y2, y1), 1.f));
}

__global__ void __launch_bounds__(kWord)
nms_mask_kernel(const float* __restrict__ boxesT, int np_total, int words,
                float thresh, unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (row_block > col_block) return;
  const long c = blockIdx.z;
  const float* bx = boxesT + c * 4 * np_total;

  __shared__ float s[5][kWord];
  const int t = threadIdx.x;
  const int j = col_block * kWord + t;
  if (j < np_total) {
    s[0][t] = bx[j];
    s[1][t] = bx[np_total + j];
    s[2][t] = bx[2 * np_total + j];
    s[3][t] = bx[3 * np_total + j];
    s[4][t] = box_area(s[0][t], s[1][t], s[2][t], s[3][t]);
  }
  __syncthreads();

  const int i = row_block * kWord + t;
  if (i >= np_total) return;
  const float x1 = bx[i], y1 = bx[np_total + i];
  const float x2 = bx[2 * np_total + i], y2 = bx[3 * np_total + i];
  const float area = box_area(x1, y1, x2, y2);
  const int n_cols = min(kWord, np_total - col_block * kWord);
  const int start = (row_block == col_block) ? t + 1 : 0;
  unsigned long long bits = 0;
  for (int u = start; u < n_cols; ++u) {
    if (suppresses(x1, y1, x2, y2, area, s[0][u], s[1][u], s[2][u], s[3][u],
                   s[4][u], thresh))
      bits |= 1ull << u;
  }
  mask[(c * np_total + i) * words + col_block] = bits;
}

// One block per class, serial over 64-box words. At word w the block first
// gathers, in parallel, the w-th mask word of every box kept so far (one
// round of independent loads, OR-reduced) plus the word's own 64 diagonal
// mask words; then one thread resolves the word's keep bits, visiting only
// the boxes that survive (ffs over the free bits).
constexpr int kSweepThreads = 256;

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const float* __restrict__ valid,
                 const unsigned long long* __restrict__ mask, int np_total,
                 int words, int block, int max_keep, float* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* kept_bits = smem;                          // [words]
  int* kept_idx = reinterpret_cast<int*>(smem + words);          // [words*64]
  __shared__ unsigned long long diag[kWord];
  __shared__ unsigned long long col_or;
  __shared__ unsigned int inval[2];
  __shared__ int n_kept;

  const long c = blockIdx.x;
  const int tid = threadIdx.x;
  const float* vc = valid + c * np_total;
  const unsigned long long* mc = mask + c * (long)np_total * words;

  for (int w = tid; w < words; w += kSweepThreads) kept_bits[w] = 0;
  if (tid == 0) { n_kept = 0; col_or = 0; }
  __syncthreads();

  for (int w = 0; w < words; ++w) {
    const int base = w * kWord;
    if (base % block == 0 && n_kept >= max_keep) break;   // block-uniform
    unsigned long long acc = 0;
    for (int p = tid; p < n_kept; p += kSweepThreads)
      acc |= mc[(long)kept_idx[p] * words + w];
    if (tid < kWord) {
      const int i = base + tid;
      diag[tid] = i < np_total ? mc[(long)i * words + w] : 0ull;
      const bool bad = i >= np_total || vc[i] == 0.f;
      const unsigned int bits = __ballot_sync(0xffffffffu, bad);
      if (tid % 32 == 0) inval[tid / 32] = bits;
    }
    for (int o = 16; o > 0; o /= 2) acc |= __shfl_xor_sync(0xffffffffu, acc, o);
    if (tid % 32 == 0 && acc) atomicOr(&col_or, acc);
    __syncthreads();
    if (tid == 0) {
      unsigned long long cur =
          col_or | inval[0] | ((unsigned long long)inval[1] << 32);
      unsigned long long kw = 0, cand = ~cur;
      int k = n_kept;
      while (cand) {
        const int t = __ffsll((long long)cand) - 1;
        kw |= 1ull << t;
        kept_idx[k++] = base + t;
        cur |= diag[t];
        cand = ~cur & ~((2ull << t) - 1ull);
      }
      kept_bits[w] = kw;
      n_kept = k;
      col_or = 0;
    }
    __syncthreads();
  }

  float* kc = keep + c * np_total;
  for (int i = tid; i < np_total; i += kSweepThreads)
    kc[i] = ((kept_bits[i / kWord] >> (i % kWord)) & 1ull) ? 1.f : 0.f;
}

}  // namespace

extern "C" int nms_mask(const float* boxesT, int C, int np_total, float thresh,
                        void* mask, void* stream) {
  const int words = (np_total + kWord - 1) / kWord;
  if (C == 0 || np_total == 0) return 0;
  dim3 grid(words, words, C);
  nms_mask_kernel<<<grid, kWord, 0, static_cast<cudaStream_t>(stream)>>>(
      boxesT, np_total, words, thresh,
      static_cast<unsigned long long*>(mask));
  return (int)cudaGetLastError();
}

extern "C" int nms_sweep(const float* valid, const void* mask, int C,
                         int np_total, int block, int max_keep, float* keep,
                         void* stream) {
  const int words = (np_total + kWord - 1) / kWord;
  if (C == 0 || np_total == 0) return 0;
  if (block % kWord != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = words * (sizeof(unsigned long long) + kWord * sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<C, kSweepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      valid, static_cast<const unsigned long long*>(mask), np_total, words,
      block, max_keep, keep);
  return (int)cudaGetLastError();
}
