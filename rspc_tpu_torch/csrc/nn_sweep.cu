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
// rows; live_hi, the highest valid target index + 1, reduced on the
// device (no host sync) and read here from device memory.
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
//    SM: ptxas then takes 80 registers (no spills); left to itself it
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
// 3. A grid that fills the card. The wrapper's plan (ops/nn.py::plan)
//    launches one block per (source tile, target split) item, block b
//    taking tile b % tiles and split b / tiles, with as many splits as
//    the card's resident slots hold (SMs x the resident blocks per SM
//    that rspc_nn_sweep_occupancy reports): one wave that leaves fewer
//    than `tiles` slots idle. Every block reads live_hi and takes its
//    split's even, contiguous share of the LIVE prefix (shares ascend
//    with the split), so the early pairs of a chain fill the card too and
//    nothing syncs with the host. A grid beyond the slots runs in waves.
// 4. Pass 2 takes, per source, the lexicographic minimum of the
//    partial (score, index) over splits: the smaller score, then the
//    lower index, which is the lower split. kReduceWays threads reduce
//    interleaved splits of one source side by side (the loads of a warp
//    are 32 consecutive sources), then combine in shared memory. With
//    one split, pass 1 writes the result itself and pass 2 does not run.
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
constexpr int kReduceSrc = 32;   // pass 2: sources per block (one warp wide)
constexpr int kReduceWays = 8;   // pass 2: splits reduced side by side
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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
nn_sweep_pass1(const float4* __restrict__ src, const float4* __restrict__ tgt,
               const int* __restrict__ live_hi, int n, int splits,
               float* __restrict__ part_score, int* __restrict__ part_idx) {
  __shared__ __align__(128) float4 ring[kStages][kTile];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  const int tid = threadIdx.x;
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
  const int tiles = (n + kSrcTile - 1) / kSrcTile;
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
    const float4 p = i < n ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
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
    if (i < n) {
      part_score[(size_t)split * n + i] = m[j];
      part_idx[(size_t)split * n + i] = k < 0 ? 0 : k;
    }
  }
}

// the lexicographic minimum of (score, index): a tie keeps the lower
// index, which is the lower split (shares ascend with the split; a
// partial of score +inf always carries index 0)
__device__ __forceinline__ void keep_min(float& best, int& bi, float v, int k) {
  if (v < best || (v == best && k < bi)) {
    best = v;
    bi = k;
  }
}

__global__ void __launch_bounds__(kReduceSrc * kReduceWays)
nn_sweep_pass2(const float* __restrict__ part_score,
               const int* __restrict__ part_idx, int n, int splits,
               float* __restrict__ best_score, int* __restrict__ best_idx) {
  __shared__ float s_score[kReduceWays][kReduceSrc];
  __shared__ int s_idx[kReduceWays][kReduceSrc];
  const int x = threadIdx.x, y = threadIdx.y;
  const int i = blockIdx.x * kReduceSrc + x;
  float best = INFINITY;
  int bi = 0;
  if (i < n) {
#pragma unroll 4
    for (int sp = y; sp < splits; sp += kReduceWays)
      keep_min(best, bi, part_score[(size_t)sp * n + i], part_idx[(size_t)sp * n + i]);
  }
  s_score[y][x] = best;
  s_idx[y][x] = bi;
  __syncthreads();
  if (y == 0 && i < n) {
    for (int w = 1; w < kReduceWays; ++w) keep_min(best, bi, s_score[w][x], s_idx[w][x]);
    best_score[i] = best;
    best_idx[i] = bi;
  }
}

}  // namespace

// src4: float4[n]; tgt4: float4[m]; live_hi: int[1] (<= m); splits >= 1
// target splits (ops/nn.py::plan), one block of pass 1 per (source
// tile, split); scratch part_score float[splits * n] and part_idx
// int[splits * n] (unused when splits == 1); outputs best_score float[n],
// best_idx int[n]. All on the current device. Launches on `stream`;
// allocates nothing.
extern "C" int rspc_nn_sweep(const void* src4, const void* tgt4,
                             const void* live_hi, int n, int splits,
                             void* part_score, void* part_idx,
                             void* best_score, void* best_idx, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (long long)((n + kSrcTile - 1) / kSrcTile) * splits;
  if (splits < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool one = splits == 1;
  nn_sweep_pass1<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const float4*)src4, (const float4*)tgt4, (const int*)live_hi, n, splits,
      (float*)(one ? best_score : part_score), (int*)(one ? best_idx : part_idx));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || one) return (int)err;
  nn_sweep_pass2<<<(n + kReduceSrc - 1) / kReduceSrc, dim3(kReduceSrc, kReduceWays),
                   0, st>>>((const float*)part_score, (const int*)part_idx, n,
                            splits, (float*)best_score, (int*)best_idx);
  return (int)cudaGetLastError();
}

// blocks of pass 1 resident on one SM of the current device -> int*
extern "C" int rspc_nn_sweep_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, nn_sweep_pass1, kThreads, 0);
}
