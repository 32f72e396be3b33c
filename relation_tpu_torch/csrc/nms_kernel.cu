// Exact greedy NMS over score-sorted boxes, batched over classes: one launch.
//
// Replaces relation_tpu/ops/pallas/nms_kernel.py::nms_keep_sorted (the Pallas
// _nms_kernel). Semantics of the TPU kernel: a box is kept unless an earlier
// KEPT box suppresses it (IoU with the +1 width convention, divide-free:
// inter > thresh * (area_i + area_j - inter)); invalid boxes are never kept
// and never suppress; the walk stops at the first `block` boundary at which
// `max_keep` boxes are kept (the block in progress is finished), so the keep
// mask is the same bit for bit.
//
// boxesT [C, 4, Np] f32, valid [C, Np] f32 -> keep [C, Np] f32 (0/1). No
// scratch in device memory: the keep mask is the only output.
//
// What bounds it on the H100: the tests the greedy walk needs are few (each
// box against the boxes kept before it, and each box against the later boxes
// of its own chunk: under 1 M at the proposals' 6000 -> 300), so what costs
// is the serial chain over the chunks: per chunk one round of parallel tests,
// one exchange among the blocks of a cluster and one serial resolve.
//
// Design: a cluster of CS blocks (256 threads) a class walks the class's
// boxes in chunks of T = 64, 128 or 256 (the largest dividing `block`):
// 1. The chunk's 4 coordinate rows and its valid row are staged by cp.async,
//    one chunk ahead.
// 2. Prefix tests: each block holds its share of the class's kept list in
//    shared memory (kept box g at slot g / CS of block g % CS: coordinates
//    and area) and tests every valid box of the chunk against its share.
// 3. The chunk's own upper triangle (box i suppresses box j > i of the
//    chunk): items of 32 rows (one a lane) against 32 columns, only those on
//    or above the diagonal, dealt round-robin over the warps of the cluster.
// 4. Every block pushes its prefix bits and its triangle words into the
//    shared memory of block 0 (DSMEM); a cluster barrier.
// 5. One warp of block 0 resolves the chunk, a 64-box word at a time: the
//    word's keep set is the fixpoint of k = free & ~(OR of the rows of k),
//    each lane holding two rows, one warp-wide OR a round (rounds: the
//    longest chain of suppressions in the word, plus one; a serial walk pays
//    a load and a dozen dependent instructions a kept box); then the warp
//    ORs the word's kept rows into the later words. It pushes the chunk's
//    keep words to every block; a second cluster barrier.
// 6. Every block appends the new kept boxes of its share to its kept list.
// Block 0 reads the exchanged words between the two barriers of a chunk,
// and the blocks write them again only after the second, so one buffer of
// them is enough. (Pushing every word into every block, to resolve the
// chunk in each, costs more in DSMEM stores than the second barrier.) A
// chunk with no valid box keeps nothing and costs no barrier. CS:
// cluster_size below. The kept list holds kSlots boxes a block: CS * kSlots
// a class.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCS = 8;      // the largest portable cluster
constexpr int kSlots = 1024;   // kept boxes a block holds

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Smem {
  float box[2][5][256];          // x1, y1, x2, y2, valid of a chunk, 2 buffers
  float area[256];               // the chunk's areas
  float4 kb[kSlots];             // this block's share of the kept boxes
  float ka[kSlots];              // and their areas
  uint32_t tri[256 * 8];         // [i * H + hw]: bits j = 32 hw + t > i
  uint32_t sup[kMaxCS * kWarps]; // prefix ballots of each block's warps
  uint32_t inval[8];             // invalid boxes of the chunk
  unsigned long long kw[4];      // the chunk's keep words
};

template <int W>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxesT, const float* __restrict__ valid,
           int np_total, int block, int max_keep, float thresh, int cs,
           float* __restrict__ keep) {
  constexpr int T = 64 * W, H = 2 * W, P = kThreads / T;
  extern __shared__ float4 smem4[];
  Smem& S = *reinterpret_cast<Smem*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long c = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* bx = boxesT + c * 4 * np_total;
  const float* vc = valid + c * np_total;
  float* kc = keep + c * np_total;
  const int chunks = np_total / T;

  auto stage = [&](int t, int buf) {
    for (int e = tid; e < 5 * T / 4; e += kThreads) {
      const int f = e / (T / 4), q = e % (T / 4);
      const float* row = f < 4 ? bx + (long)f * np_total : vc;
      cp_async16(&S.box[buf][f][4 * q], row + (long)t * T + 4 * q);
    }
    cp_async_commit();
  };

  // every block of the cluster is running before the first DSMEM store
  cluster.sync();
  stage(0, 0);
  int n_kept = 0, t = 0;
  for (; t < chunks; ++t) {
    if ((t * T) % block == 0 && n_kept >= max_keep) break;   // cluster-uniform
    const int p = t & 1;
    if (t + 1 < chunks) stage(t + 1, p ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* b0 = S.box[p][0];
    const float* b1 = S.box[p][1];
    const float* b2 = S.box[p][2];
    const float* b3 = S.box[p][3];
    const float* bv = S.box[p][4];
    if (tid < T) S.area[tid] = box_area(b0[tid], b1[tid], b2[tid], b3[tid]);
    if (!__syncthreads_or(tid < T && bv[tid] > 0.f)) {
      if (r == 0 && tid < T) kc[(long)t * T + tid] = 0.f;
      continue;
    }

    // prefix: box i against this block's share of the kept list
    const int i = tid % T, part = tid / T;
    const float x1 = b0[i], y1 = b1[i], x2 = b2[i], y2 = b3[i];
    const bool vi = bv[i] > 0.f;
    bool hit = false;
    if (vi) {
      const float area = box_area(x1, y1, x2, y2);
      const int share = (n_kept - r + cs - 1) / cs;
#pragma unroll 4
      for (int s = part; s < share; s += P) {
        const float4 k4 = S.kb[s];
        hit |= suppresses(k4.x, k4.y, k4.z, k4.w, S.ka[s], x1, y1, x2, y2,
                          area, thresh);
      }
    }
    const uint32_t hits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) *cluster.map_shared_rank(&S.sup[r * kWarps + warp], 0) = hits;
    const uint32_t bad = __ballot_sync(0xffffffffu, !vi);
    if (part == 0 && lane == 0) S.inval[warp] = bad;

    // the chunk's upper triangle: item (rw, hw), hw >= rw, tests rows
    // 32 rw + lane (one a lane) against columns 32 hw .. 32 hw + 31 (read by
    // the whole warp at once); items dealt round-robin over the warps of the
    // cluster, their words stored into block 0
    constexpr int kItems = H * (H + 1) / 2;
    for (int it = r * kWarps + warp; it < kItems; it += cs * kWarps) {
      int rw = 0, rest = it;
      while (rest >= H - rw) rest -= H - rw++;
      const int hw = rw + rest, ii = 32 * rw + lane;
      const float ax1 = b0[ii], ay1 = b1[ii], ax2 = b2[ii], ay2 = b3[ii];
      const float aa = S.area[ii];
      uint32_t bits = 0u;
#pragma unroll 8
      for (int u = 0; u < 32; ++u) {
        const int j = 32 * hw + u;
        if (suppresses(ax1, ay1, ax2, ay2, aa, b0[j], b1[j], b2[j], b3[j],
                       S.area[j], thresh) && j > ii)
          bits |= 1u << u;
      }
      *cluster.map_shared_rank(&S.tri[ii * H + hw], 0) = bits;
    }
    // every block's prefix bits and triangle words have landed in block 0
    cluster.sync();

    if (r == 0 && warp == 0) {
      // the chunk's suppressed-or-invalid half words, OR-ed over the blocks
      uint32_t half[H];
#pragma unroll
      for (int h = 0; h < H; ++h) half[h] = 0u;
      for (int e = lane; e < cs * kWarps; e += 32) {
        const uint32_t v = S.sup[e];
#pragma unroll
        for (int h = 0; h < H; ++h)
          if ((e % kWarps) % H == h) half[h] |= v;
      }
      unsigned long long cw[W];
#pragma unroll
      for (int w = 0; w < W; ++w)
        cw[w] = (unsigned long long)(__reduce_or_sync(0xffffffffu, half[2 * w]) |
                                     S.inval[2 * w]) |
                ((unsigned long long)(__reduce_or_sync(0xffffffffu, half[2 * w + 1]) |
                                      S.inval[2 * w + 1]) << 32);
      const unsigned long long* tri =
          reinterpret_cast<const unsigned long long*>(S.tri);
      unsigned long long kw[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        // word w's greedy keep set as the fixpoint of k = a & ~(rows of k):
        // after n rounds its first n boxes are final, and the greedy set is
        // the only fixpoint, so at most 65 rounds, and as many as the
        // longest chain of suppressions in the word, plus one. Lane l holds
        // the row words of boxes l and l + 32, cut to bits above their box
        // (a row holds garbage at and below it).
        const unsigned long long d0 =
            tri[(64 * w + lane) * W + w] & ~((2ull << lane) - 1ull);
        const unsigned long long d1 =
            tri[(64 * w + 32 + lane) * W + w] & ~((2ull << (32 + lane)) - 1ull);
        const unsigned long long a = ~cw[w];
        unsigned long long k = a, prev;
        do {
          prev = k;
          const unsigned long long v = (((k >> lane) & 1ull) ? d0 : 0ull) |
                                       (((k >> (32 + lane)) & 1ull) ? d1 : 0ull);
          k = a & ~((unsigned long long)__reduce_or_sync(0xffffffffu, (uint32_t)v) |
                    ((unsigned long long)__reduce_or_sync(0xffffffffu,
                                                          (uint32_t)(v >> 32)) << 32));
        } while (k != prev);
        kw[w] = k;
        // the kept boxes of word w suppress into the later words: lanes take
        // boxes lane and lane + 32
#pragma unroll
        for (int w2 = w + 1; w2 < W; ++w2) {
          unsigned long long v = 0ull;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if ((k >> (32 * h + lane)) & 1ull) v |= tri[(64 * w + 32 * h + lane) * W + w2];
          cw[w2] |= (unsigned long long)__reduce_or_sync(0xffffffffu, (uint32_t)v) |
                    ((unsigned long long)__reduce_or_sync(0xffffffffu, (uint32_t)(v >> 32)) << 32);
        }
      }
      // the chunk's keep words to every block of the cluster
      if (lane < cs)
#pragma unroll
        for (int w = 0; w < W; ++w) *cluster.map_shared_rank(&S.kw[w], lane) = kw[w];
    }
    // every block has the keep words
    cluster.sync();
    // the new kept boxes of this block's share into its kept list: box i is
    // kept box n_kept + (its rank among the chunk's kept boxes)
    int cnt = 0, rank = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const unsigned long long kwv = S.kw[w];
      if (w < i / 64) rank += __popcll(kwv);
      if (w == i / 64) rank += __popcll(kwv & ((1ull << (i % 64)) - 1ull));
      cnt += __popcll(kwv);
    }
    const bool kept = part == 0 && ((S.kw[i / 64] >> (i % 64)) & 1ull);
    if (kept && (n_kept + rank) % cs == r) {
      const int slot = (n_kept + rank) / cs;
      S.kb[slot] = make_float4(x1, y1, x2, y2);
      S.ka[slot] = box_area(x1, y1, x2, y2);
    }
    if (r == 0 && part == 0) kc[(long)t * T + i] = kept ? 1.f : 0.f;
    n_kept += cnt;
  }
  // the boxes after the stop
  for (long e = (long)t * T + (long)r * kThreads + tid; e < np_total;
       e += (long)cs * kThreads)
    kc[e] = 0.f;
  cp_async_wait<0>();
}

// cluster size for C classes: the largest of 8, 4, 2 with C * CS blocks
// resident on the card at once (the SMs times the blocks an SM holds), else
// 1. One class (every proposal pass): 8, which an H100 runs 5% faster than
// 16 (tools/ablate_nms.py); 80 classes (the classic tail): 2.
int cluster_size(int C, int* cs) {
  static long slots = 0;   // blocks the card holds at once: found once
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nms_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sizeof(Smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nms_kernel<4>,
                                                          kThreads, sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    slots = (long)(per_sm > 1 ? per_sm : 1) * sms;
  }
  *cs = 1;
  for (int c = kMaxCS; c > 1; c /= 2)
    if ((long)C * c <= slots) {
      *cs = c;
      break;
    }
  return 0;
}

template <int W>
cudaError_t launch(const float* boxesT, const float* valid, float* keep, int C,
                   int np_total, int block, int max_keep, float thresh, int cs,
                   cudaStream_t stream) {
  auto kernel = nms_kernel<W>;
  static bool ready = false;   // the kernel's attribute: set once
  cudaError_t err;
  if (!ready) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * cs), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, boxesT, valid, np_total, block,
                           max_keep, thresh, cs, keep);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// block: a multiple of 64 dividing np_total. Returns a CUDA error code, or
// minus the kept list's capacity (boxes a class) when the walk could keep
// more (min(np_total, max_keep + block - 1)); nothing is launched then.
extern "C" int nms_keep(const float* boxesT, const float* valid, float* keep,
                        int C, int np_total, int block, int max_keep,
                        float thresh, void* stream) {
  if (C == 0 || np_total == 0) return 0;
  if (block % 64 != 0 || np_total % block != 0) return (int)cudaErrorInvalidValue;
  int cs = 1;
  const int err = cluster_size(C, &cs);
  if (err) return err;
  const long most = (long)cs * kSlots;
  const long need = block + (long)max_keep - 1;
  if ((need < np_total ? need : (long)np_total) > most) return -(int)most;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = block % 256 == 0 ? 4 : block % 128 == 0 ? 2 : 1;
  switch (w) {
    case 4: return (int)launch<4>(boxesT, valid, keep, C, np_total, block, max_keep, thresh, cs, s);
    case 2: return (int)launch<2>(boxesT, valid, keep, C, np_total, block, max_keep, thresh, cs, s);
    default: return (int)launch<1>(boxesT, valid, keep, C, np_total, block, max_keep, thresh, cs, s);
  }
}
