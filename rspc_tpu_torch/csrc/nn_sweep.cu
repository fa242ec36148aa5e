// The NN sweep: brute-force nearest valid target for every source point,
// one kernel for both routes of the TPU package.
//
// Replaces the TPU kernels rspc_tpu/ops/nn_pallas.py::_nn_kernel (B1,
// targets up to MAX_VMEM_TARGET) and ::_nn_kernel_hbm (B2, the
// HBM-streaming route for larger targets). On the card the two routes
// differ only in their launch plan (rspc_tpu_torch/ops/nn.py::plan); the
// wrapper's pre- and post-processing (ops/nn.py::_pack and ::_rescore)
// is the TPU wrapper's: sources recentred on the valid-target centroid
// as float4 (x, y, z, unused); targets recentred with invalid rows zeroed
// as float4 (x, y, z, |t|^2 + penalty), the penalty 1e30 for invalid
// rows. Two live bounds are reduced on the device (no host sync) and read
// here from device memory: live_hi, the highest valid target index + 1,
// and src_live, the highest valid source index + 1.
//
// What bounds it on the card: FP32 issue. Every (source, live target)
// pair costs 4 FMA-class operations for the score |t|^2 + pen - 2 s.t
// (an FMUL and two FFMAs for s.t, one FFMA for the rest; f32 only: TF32
// or bf16 would flip winners at millimetre spacing, nn_pallas.py:76-80)
// plus an FMNMX for the running minimum. An SM sub-partition issues one
// warp instruction per clock, which is also its FP32 rate, so every
// instruction that is not one of those five costs a pair's slot. What
// each design point does about that:
//
// 1. Register blocking. A thread holds kSrcPerThread sources, so one
//    shared-memory broadcast of a target (an LDS.128) feeds that many
//    pairs and as many independent minimum chains. The sweep tracks the
//    minimum score only; after each fully unrolled run of kCheck targets
//    a source whose minimum strictly fell remembers that run. At the end
//    each source rescans its one remembered run for the first target with
//    exactly its minimum (the same arithmetic gives the same bits; from
//    shared memory when the run's tile is still staged). The first
//    strict fall to the final minimum happens in the run that holds its
//    first occurrence, so this is strict < over ascending index: the
//    plain sweep's lowest-index tie rule, with no index select and no
//    divergence inside the sweep. With 6 sources a thread (4, 8, 12 and
//    16 were slower on one path or both) that is about 5.3 issue slots
//    per pair: the five above, 1/6 of an LDS, and the run bookkeeping
//    every 32 targets. __launch_bounds__ asks for 6 resident blocks per
//    SM: ptxas then takes 79-80 registers (no spills); left to itself it
//    took 72, which fits 7 blocks, and the sweep ran 14-22% slower on
//    the card at the three main-path shapes.
// 2. Asynchronous staging. The block's target share streams through a
//    ring of kStages tiles of kTile float4 rows in shared memory. One
//    thread fills it with Hopper's bulk asynchronous copy
//    (cp.async.bulk, completing on an mbarrier per stage); every thread
//    arrives on a stage's "empty" mbarrier when it is done with it, and
//    the filling thread waits on that before it refills the stage. The
//    sweep of one tile overlaps the copy of the next, with no per-thread
//    copy instructions and no block-wide barrier per tile. float4 rows
//    keep every copy 16-byte aligned at any share boundary; the ragged
//    last tile is a shorter copy.
// 3. A plan made on the device, over the live source prefix. The host
//    launches max(slots, tiles(n)) blocks, slots being the card's
//    resident slots (SMs x the resident blocks per SM that
//    rspc_nn_sweep_occupancy reports). Every block reads src_live and
//    live_hi and makes the plan ops/nn.py::plan mirrors: live_tiles =
//    ceil(src_live / kSrcTile) source tiles, splits = clamp(slots /
//    live_tiles, 1, max_splits) target splits, block b taking tile
//    b % live_tiles and split b / live_tiles; blocks past live_tiles x
//    splits exit at once. So dead source slots (a suffix, as the voxel
//    grid leaves them) are never swept, and the splits grow to fill the
//    slots the dead tiles would have held. Each split takes an even,
//    contiguous share of the LIVE target prefix (shares ascend with the
//    split), so the early pairs of a chain fill the card too and nothing
//    syncs with the host. Where the live tiles outnumber the slots, one
//    split runs in waves. With src_live == n the plan is the one the
//    host made before the plan moved here.
// 4. Splits combine without per-split scratch: the number of splits is
//    known only here, so each source's (score, index) is packed into one
//    uint64 key (pack_key: the score's bits made order-preserving, -0.0
//    as +0.0, above the index) and combined with atomicMin into one
//    uint64[n], which rspc_nn_sweep first fills with the all-ones
//    sentinel. The unsigned order of the keys is the lexicographic order
//    of (score, index): the smaller score, then the lower index (the
//    lower split; a partial of score +inf always carries index 0). Pass 2 decodes each key into
//    best_score and best_idx; a row at or past src_live still holds the
//    sentinel and decodes to (+inf, 0), the plain sweep's answer for an
//    invalid source. While the tracer records, block 0 also adds src_live
//    to a device counter (the rows the sweep covers).
//
// The per-pair arithmetic, cross = fmaf(sz, tz, fmaf(sy, ty, sx * tx))
// and score = t.w - 2 cross (see pair_score), and the tie rule are those
// of the first kernels of this port, so every plan gives the same
// (score, index) bit for bit, and the same as those kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSrcPerThread = 6;
constexpr int kSrcTile = kThreads * kSrcPerThread;  // ops/nn.py SRC_TILE
constexpr int kMinBlocks = 6;  // resident blocks per SM asked of ptxas
constexpr int kTile = 512;  // targets per staged tile (8 KB)
constexpr int kStages = 3;
constexpr int kCheck = 32;  // targets per run
constexpr int kDecode = 256;  // pass 2: sources per block
constexpr unsigned long long kSentinel = ~0ULL;  // no split wrote the row
static_assert(kTile % kCheck == 0, "a run never crosses a tile");

// |t|^2 + pen - 2 s.t. Written as one FFMA: 2 cross is exact, so this is
// t.w - 2 cross rounded once, as the port's first kernels computed it
// (where nvcc had emitted cross + cross and a subtraction: two FADDs, a
// sixth instruction per pair) wherever 2 cross is finite, that is for
// |s.t| < 2^127, every input of the contract
__device__ __forceinline__ float pair_score(float sx, float sy, float sz,
                                            const float4& t) {
  const float cross = fmaf(sz, t.z, fmaf(sy, t.y, sx * t.x));
  return fmaf(-2.0f, cross, t.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// wait until the phase of `bar` with this parity has completed; a stage
// takes microseconds, so a wait of billions of cycles is a fault: trap
// (the launch fails) rather than hang the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (bar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!bar_try_wait(a, parity))
    if (clock64() - t0 > (1LL << 33)) __trap();
}

// one thread: copy `rows` float4 rows from global to shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_load(float4* dst, const float4* src,
                                          int rows, uint64_t* bar) {
  const uint32_t bytes = static_cast<uint32_t>(rows) * sizeof(float4);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the running minima of one run of targets; a source whose minimum
// strictly fell remembers the run
template <int kCount>
__device__ __forceinline__ void sweep_run(const float4* t, int count, int run0,
                                          const float (&sx)[kSrcPerThread],
                                          const float (&sy)[kSrcPerThread],
                                          const float (&sz)[kSrcPerThread],
                                          float (&m)[kSrcPerThread],
                                          int (&run)[kSrcPerThread]) {
  float prev[kSrcPerThread];
#pragma unroll
  for (int j = 0; j < kSrcPerThread; ++j) prev[j] = m[j];
  if (kCount > 0) {
#pragma unroll
    for (int k = 0; k < kCount; ++k) {
      const float4 tk = t[k];
#pragma unroll
      for (int j = 0; j < kSrcPerThread; ++j)
        m[j] = fminf(m[j], pair_score(sx[j], sy[j], sz[j], tk));
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < count; ++k) {
      const float4 tk = t[k];
#pragma unroll
      for (int j = 0; j < kSrcPerThread; ++j)
        m[j] = fminf(m[j], pair_score(sx[j], sy[j], sz[j], tk));
    }
  }
#pragma unroll
  for (int j = 0; j < kSrcPerThread; ++j)
    if (m[j] < prev[j]) run[j] = run0;
}

// the lowest k in [0, count) with score == best (count >= 1; one exists)
__device__ __forceinline__ int first_match(const float4* t, int count,
                                           float sx, float sy, float sz,
                                           float best) {
  int found = count - 1;
#pragma unroll 8
  for (int k = kCheck - 1; k >= 0; --k)
    if (k < count && pair_score(sx, sy, sz, t[k]) == best) found = k;
  return found;
}

// (score, index) as one key whose unsigned order is the lexicographic
// order of the pair: the smaller score, then the lower index; -0.0 keys
// as +0.0
__device__ __forceinline__ unsigned long long pack_key(float score, int idx) {
  uint32_t b = __float_as_uint(score);
  if (b == 0x80000000u) b = 0u;
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (uint32_t)idx;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
nn_sweep_pass1(const float4* __restrict__ src, const float4* __restrict__ tgt,
               const int* __restrict__ src_live_p, const int* __restrict__ live_hi,
               int slots, int max_splits, unsigned long long* __restrict__ keys,
               unsigned long long* __restrict__ rows) {
  __shared__ __align__(128) float4 ring[kStages][kTile];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  const int tid = threadIdx.x;
  const int src_live = *src_live_p;
  if (rows != nullptr && blockIdx.x == 0 && tid == 0)
    atomicAdd(rows, (unsigned long long)src_live);
  // the plan over the live source prefix (ops/nn.py::plan); the product
  // is at most max(slots, tiles), so it cannot overflow
  const int tiles = (src_live + kSrcTile - 1) / kSrcTile;
  const int splits = max(1, min(max_splits, slots / max(tiles, 1)));
  if ((int)blockIdx.x >= tiles * splits) return;  // the whole block
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      bar_init(&full[st], 1);
      bar_init(&empty[st], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int live = *live_hi;
  // even share of the live prefix, contiguous and ascending with the split
  const int share = live / splits + (live % splits != 0);
  const int tile = blockIdx.x % tiles;
  const int split = blockIdx.x / tiles;
  const int lo = (int)min((long long)live, (long long)split * share);
  const int hi = min(live, lo + share);
  const int ntiles = (hi - lo + kTile - 1) / kTile;

  float sx[kSrcPerThread], sy[kSrcPerThread], sz[kSrcPerThread];
  float m[kSrcPerThread];
  int run[kSrcPerThread];  // first target of the run that set m, or -1
#pragma unroll
  for (int j = 0; j < kSrcPerThread; ++j) {
    const int i = tile * kSrcTile + j * kThreads + tid;
    const float4 p = i < src_live ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    sx[j] = p.x;
    sy[j] = p.y;
    sz[j] = p.z;
    m[j] = INFINITY;
    run[j] = -1;
  }

  if (tid == 0) {
    for (int k = 0; k < min(kStages, ntiles); ++k) {
      const int base = lo + k * kTile;
      bulk_load(ring[k], tgt + base, min(kTile, hi - base), &full[k]);
    }
  }

  uint32_t empty_par = 0;  // thread 0: next "empty" parity, one bit a stage
  for (int k = 0; k < ntiles; ++k) {
    const int st = k % kStages;
    bar_wait(&full[st], (k / kStages) & 1);
    const int base = lo + k * kTile;
    const int cnt = min(kTile, hi - base);
    const float4* t = ring[st];
    int c0 = 0;
    for (; c0 + kCheck <= cnt; c0 += kCheck)
      sweep_run<kCheck>(t + c0, kCheck, base + c0, sx, sy, sz, m, run);
    if (c0 < cnt)
      sweep_run<0>(t + c0, cnt - c0, base + c0, sx, sy, sz, m, run);
    if (k + kStages < ntiles) {  // refill this stage with tile k + kStages
      bar_arrive(&empty[st]);
      if (tid == 0) {
        bar_wait(&empty[st], (empty_par >> st) & 1);
        empty_par ^= 1u << st;
        const int nbase = base + kStages * kTile;
        bulk_load(ring[st], tgt + nbase, min(kTile, hi - nbase), &full[st]);
      }
    }
  }

  // the index: the first exact match of the minimum in its run, read
  // from the ring where the run's tile is still staged (the last kStages
  // tiles), else from device memory
#pragma unroll
  for (int j = 0; j < kSrcPerThread; ++j) {
    int k = run[j];
    if (k >= 0) {
      const int count = min(kCheck, hi - k);
      const int ti = (k - lo) / kTile;
      if (ti >= ntiles - kStages) {
        const float4* t = ring[ti % kStages] + (k - lo - ti * kTile);
        k += first_match(t, count, sx[j], sy[j], sz[j], m[j]);
      } else {
        k += first_match(tgt + k, count, sx[j], sy[j], sz[j], m[j]);
      }
    }
    const int i = tile * kSrcTile + j * kThreads + tid;
    if (i < src_live) atomicMin(&keys[i], pack_key(m[j], k < 0 ? 0 : k));
  }
}

// each source's key decoded into (best score, best index); the sentinel
// (a row past src_live) decodes to (+inf, 0)
__global__ void __launch_bounds__(kDecode)
nn_sweep_pass2(const unsigned long long* __restrict__ keys, int n,
               float* __restrict__ best_score, int* __restrict__ best_idx) {
  const int i = blockIdx.x * kDecode + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  float score = INFINITY;
  int idx = 0;
  if (key != kSentinel) {
    const uint32_t b = (uint32_t)(key >> 32);
    score = __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
    idx = (int)(uint32_t)key;
  }
  best_score[i] = score;
  best_idx[i] = idx;
}

}  // namespace

// src4: float4[n]; tgt4: float4[m]; src_live: int[1] (<= n); live_hi:
// int[1] (<= m); slots: the card's resident slots of pass 1; max_splits
// >= 1 caps the device plan's target splits (ops/nn.py::plan); scratch
// keys uint64[n]; rows: a uint64[1] counter that src_live is added to,
// or null; outputs best_score float[n], best_idx int[n]. All on the
// current device. Launches on `stream`; allocates nothing.
extern "C" int rspc_nn_sweep(const void* src4, const void* tgt4,
                             const void* src_live, const void* live_hi, int n,
                             int slots, int max_splits, void* keys, void* rows,
                             void* best_score, void* best_idx, void* stream) {
  if (n <= 0) return 0;
  if (slots < 1 || max_splits < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (int)(((long long)n + kSrcTile - 1) / kSrcTile);
  const int blocks = tiles > slots ? tiles : slots;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(keys, 0xff, (size_t)n * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  nn_sweep_pass1<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const float4*)src4, (const float4*)tgt4, (const int*)src_live,
      (const int*)live_hi, slots, max_splits, (unsigned long long*)keys,
      (unsigned long long*)rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_sweep_pass2<<<(unsigned)((n + kDecode - 1) / kDecode), kDecode, 0, st>>>(
      (const unsigned long long*)keys, n, (float*)best_score, (int*)best_idx);
  return (int)cudaGetLastError();
}

// blocks of pass 1 resident on one SM of the current device -> int*
extern "C" int rspc_nn_sweep_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, nn_sweep_pass1, kThreads, 0);
}
