// Kernel B2: brute-force nearest valid target for every source point, with
// the live target split across blocks and a second pass that reduces the
// partial winners.
//
// Replaces the TPU kernel rspc_tpu/ops/nn_pallas.py::_nn_kernel_hbm, the
// route for targets above MAX_VMEM_TARGET (the incremental chain's
// multi-million-point accumulated cloud). Its wrapper's pre- and
// post-processing lives in
// rspc_tpu_torch/ops/nn.py::nearest_neighbors_stream_cuda and is kernel
// B1's, bit for bit: sources recentred on the valid-target centroid as
// float4 (x, y, z, unused); targets recentred with invalid rows zeroed as
// float4 (x, y, z, |t|^2 + penalty), the penalty 1e30 for invalid rows;
// live_hi, the highest valid target index + 1, reduced on the device (no
// host sync) and read here from device memory.
//
// Why a split. The TPU split B1/B2 exists only for a scoped-VMEM limit the
// card does not have; what the card has at B2's shape (16,384 sources
// against up to 2.76M live targets) is a fill problem: one block per 128
// sources gives 128 blocks on 132 SMs, each sweeping the whole target
// alone. Here pass 1 runs on a grid of (source tiles x target splits).
// Every block reads live_hi and takes its own even share of the LIVE
// prefix (so the early pairs of a chain, with a live prefix of 307,200 in a
// 3.07M capacity, fill the card too), stages that share through shared
// memory in tiles of kTile targets, and keeps one running best per source
// in registers (2 sources per thread, so one shared-memory broadcast feeds
// two pairs). The inner loop tracks only the running minimum score
// (fminf: 4 FMA-class operations and one min per pair, no index select);
// after each run of kCheck targets, a source whose minimum strictly
// improved remembers that run. At the end each source rescans its one
// remembered run from device memory for the first target with exactly
// its best score (the same arithmetic gives the same bits). The first
// strict improvement to the final minimum happens in the run that holds
// its first occurrence, so this is B1's strict < over ascending index and
// the winner is the same; no warp diverges inside the sweep. It writes a
// partial (score, index) per split into a [splits, n] scratch; a block
// whose share is empty writes +inf. Pass 2 takes, per source, the
// lexicographic minimum over splits: the smaller score, then the lower
// split on a tie. Shares are contiguous and ascend with the split, so this
// keeps the lowest-index tie rule of the plain sweep and of B1, and the
// per-pair arithmetic is B1's, so the result equals B1's bit for bit.
//
// Split count (the wrapper's split_count): enough (source tile, split)
// blocks for 8 blocks per SM, at most 64 splits; at 16,384 sources on 132
// SMs that is 64 tiles x 17 splits = 1,088 blocks, about 8 resident per SM
// (at least the 2 the design aims for).
//
// Arithmetic: f32 FMAs only. TF32 or bf16 would flip winners at
// millimetre spacing (rspc_tpu/ops/nn_pallas.py:76-80).
//
// What bounds it on the card: FP32 instruction throughput, 4 FMA-class
// operations per (source, live target) pair, plus the running minimum and
// half a shared-memory broadcast; the target share is read from L2/HBM
// once per source tile, and one run of kCheck targets once more per
// source. Pass 2 moves splits x n x 8 bytes, negligible.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSrcPerThread = 2;
constexpr int kSrcTile = kThreads * kSrcPerThread;
constexpr int kTile = 1024;
constexpr int kCheck = 64;
constexpr int kReduceThreads = 256;

// B1's per-pair score, |t|^2 + pen - 2 s.t, in the same f32 operations
__device__ __forceinline__ float pair_score(float sx, float sy, float sz,
                                            const float4& t) {
  const float cross = fmaf(sz, t.z, fmaf(sy, t.y, sx * t.x));
  return t.w - 2.0f * cross;
}

__global__ void __launch_bounds__(kThreads)
nn_split_pass1(const float4* __restrict__ src, const float4* __restrict__ tgt,
               const int* __restrict__ live_hi, int n, int splits,
               float* __restrict__ part_score, int* __restrict__ part_idx) {
  __shared__ float4 tile[kTile];
  const int split = blockIdx.y;
  const int live = *live_hi;
  // even share of the live prefix, rounded up to whole rounds of loads
  int share = (live + splits - 1) / splits;
  share = (share + kThreads - 1) / kThreads * kThreads;
  const int lo = min(live, split * share);
  const int hi = min(live, lo + share);

  float sx[kSrcPerThread], sy[kSrcPerThread], sz[kSrcPerThread];
  float best[kSrcPerThread];
  int run[kSrcPerThread];  // first target of the run that set best, or -1
#pragma unroll
  for (int j = 0; j < kSrcPerThread; ++j) {
    const int i = blockIdx.x * kSrcTile + j * kThreads + threadIdx.x;
    const float4 p = i < n ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    sx[j] = p.x;
    sy[j] = p.y;
    sz[j] = p.z;
    best[j] = INFINITY;
    run[j] = -1;
  }
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += kThreads) tile[k] = tgt[base + k];
    __syncthreads();
    for (int c0 = 0; c0 < cnt; c0 += kCheck) {
      const int c1 = min(cnt, c0 + kCheck);
      float m[kSrcPerThread];
#pragma unroll
      for (int j = 0; j < kSrcPerThread; ++j) m[j] = best[j];
#pragma unroll 8
      for (int k = c0; k < c1; ++k) {
        const float4 t = tile[k];
#pragma unroll
        for (int j = 0; j < kSrcPerThread; ++j)
          m[j] = fminf(m[j], pair_score(sx[j], sy[j], sz[j], t));
      }
#pragma unroll
      for (int j = 0; j < kSrcPerThread; ++j) {
        if (m[j] < best[j]) {  // a strictly better target in [c0, c1)
          best[j] = m[j];
          run[j] = base + c0;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSrcPerThread; ++j) {
    const int i = blockIdx.x * kSrcTile + j * kThreads + threadIdx.x;
    if (i < n) {
      // the first target of the remembered run with exactly the best score
      // (always found; the bound only keeps k inside the run)
      int k = run[j];
      if (k >= 0) {
        const int last = min(k + kCheck, hi) - 1;
        while (k < last && pair_score(sx[j], sy[j], sz[j], tgt[k]) != best[j]) ++k;
      }
      part_score[(size_t)split * n + i] = best[j];
      part_idx[(size_t)split * n + i] = k < 0 ? 0 : k;
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
nn_split_pass2(const float* __restrict__ part_score,
               const int* __restrict__ part_idx, int n, int splits,
               float* __restrict__ best_score, int* __restrict__ best_idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best = part_score[i];
  int bi = part_idx[i];
  for (int sp = 1; sp < splits; ++sp) {
    const float v = part_score[(size_t)sp * n + i];
    if (v < best) {  // a tie keeps the lower split: the lower index
      best = v;
      bi = part_idx[(size_t)sp * n + i];
    }
  }
  best_score[i] = best;
  best_idx[i] = bi;
}

}  // namespace

// src4: float4[n]; tgt4: float4[m]; live_hi: int[1] (<= m); splits >= 1;
// scratch part_score float[splits * n], part_idx int[splits * n]; outputs
// best_score float[n], best_idx int[n]. All on the current device.
// Launches both passes on `stream`; allocates nothing.
extern "C" int rspc_nn_sweep_split(const void* src4, const void* tgt4,
                                   const void* live_hi, int n, int splits,
                                   void* part_score, void* part_idx,
                                   void* best_score, void* best_idx,
                                   void* stream) {
  if (n <= 0) return 0;
  if (splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + kSrcTile - 1) / kSrcTile, splits);
  nn_split_pass1<<<grid, kThreads, 0, st>>>(
      (const float4*)src4, (const float4*)tgt4, (const int*)live_hi, n, splits,
      (float*)part_score, (int*)part_idx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_split_pass2<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads,
                   0, st>>>((const float*)part_score, (const int*)part_idx, n,
                            splits, (float*)best_score, (int*)best_idx);
  return (int)cudaGetLastError();
}
