// Kernel B1: brute-force nearest valid target for every source point.
//
// Replaces the TPU kernel rspc_tpu/ops/nn_pallas.py::_nn_kernel (its
// wrapper's pre- and post-processing lives in
// rspc_tpu_torch/ops/nn.py::nearest_neighbors_cuda).
//
// Inputs are prepared by the wrapper: sources recentred on the valid
// target centroid as float4 (x, y, z, unused); targets recentred with
// invalid rows zeroed as float4 (x, y, z, |t|^2 + penalty), the penalty
// 1e30 for invalid rows; and live_hi, the highest valid target index + 1,
// computed on the device (no host sync) and read here from device memory.
//
// One thread per source point keeps its running best score
// |t|^2 + pen - 2 s.t in registers (f32 FMAs: never TF32 or bf16, which
// flip winners at millimetre spacing) and updates it on strict <, so the
// lowest index wins an exact tie -- the plain sweep's order. Each block
// stages tiles of the live target prefix through shared memory; every
// thread of a warp reads the same staged target (a broadcast).
//
// What bounds it on the card: FP32 instruction throughput (4 FMA-class
// operations per pair), with the target read once per block from L2. A
// block holds only 128 sources, so small source counts leave SMs idle;
// splitting the target across blocks is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn_sweep_kernel(const float4* __restrict__ src, const float4* __restrict__ tgt,
                const int* __restrict__ live_hi, int n,
                float* __restrict__ best_score, int* __restrict__ best_idx) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float4 s = i < n ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const int m = *live_hi;
  float best = INFINITY;
  int bi = 0;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) tile[k] = tgt[base + k];
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      const float4 t = tile[k];
      const float cross = fmaf(s.z, t.z, fmaf(s.y, t.y, s.x * t.x));
      const float score = t.w - 2.0f * cross;
      if (score < best) {
        best = score;
        bi = base + k;
      }
    }
  }
  if (i < n) {
    best_score[i] = best;
    best_idx[i] = bi;
  }
}

}  // namespace

// src4: float4[n]; tgt4: float4[m]; live_hi: int[1] (<= m); outputs
// best_score float[n], best_idx int[n]. All on the current device.
// Launches on `stream`; allocates nothing.
extern "C" int rspc_nn_sweep(const void* src4, const void* tgt4,
                             const void* live_hi, int n, void* best_score,
                             void* best_idx, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  nn_sweep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)src4, (const float4*)tgt4, (const int*)live_hi, n,
      (float*)best_score, (int*)best_idx);
  return (int)cudaGetLastError();
}
