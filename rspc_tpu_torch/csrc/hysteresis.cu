// Kernel B3: Canny hysteresis to a fixpoint, one CTA per frame.
//
// Replaces the TPU kernel rspc_tpu/ops/canny.py::_hysteresis_kernel.
// The result is the unique 8-connected closure of the strong pixels
// through weak pixels, so any propagation order that stops at a
// fixpoint gives the same bits as the plain PyTorch version
// (rspc_tpu_torch/ops/canny.py::_hysteresis_plain).
//
// Layout: the frame's weak mask and current mask live bit-packed in
// dynamic shared memory, row r / word c at r * ww + c (ww = ceil(W/32)),
// bit j of word c is column 32 * c + j. 640x480 takes 2 x 38.4 KB.
//
// One round: a row sweep (one thread per row; left-to-right then
// right-to-left, carrying the edge bit between words, with an in-word
// log-doubling flood), then a downward and an upward column sweep (one
// thread per word column; each row is lit from the 3-pixel dilation of
// the row before it, then flooded within the word). Rounds repeat until
// one changes no word. Threads read neighbouring words that another
// thread may be writing: bits only ever turn on and every bit set is in
// the closure, so a stale read only delays propagation; a round with no
// write at all proves the fixpoint.
//
// What bounds it on the card: the serial dependence along chains of weak
// pixels (shared-memory latency of the sweeps), not bytes or FLOPs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

// Light every bit reachable toward higher bit indices through runs of a.
__device__ __forceinline__ uint32_t flood_up(uint32_t b, uint32_t a) {
  b |= a & (b << 1); a &= a << 1;
  b |= a & (b << 2); a &= a << 2;
  b |= a & (b << 4); a &= a << 4;
  b |= a & (b << 8); a &= a << 8;
  b |= a & (b << 16);
  return b;
}

// Light every bit reachable toward lower bit indices through runs of a.
__device__ __forceinline__ uint32_t flood_down(uint32_t b, uint32_t a) {
  b |= a & (b >> 1); a &= a >> 1;
  b |= a & (b >> 2); a &= a >> 2;
  b |= a & (b >> 4); a &= a >> 4;
  b |= a & (b >> 8); a &= a >> 8;
  b |= a & (b >> 16);
  return b;
}

// Pixels of the row below (or above) lit by the 8-neighbourhood of
// word c of row `src`.
__device__ __forceinline__ uint32_t dilate_from(const uint32_t* cur, int src,
                                                int c, int ww) {
  const uint32_t* row = cur + src * ww;
  uint32_t v = row[c];
  uint32_t d = v | (v << 1) | (v >> 1);
  if (c > 0) d |= row[c - 1] >> 31;
  if (c + 1 < ww) d |= (row[c + 1] & 1u) << 31;
  return d;
}

__global__ void __launch_bounds__(kThreads)
hysteresis_kernel(const uint8_t* __restrict__ strong,
                  const uint8_t* __restrict__ weak,
                  uint8_t* __restrict__ out, int h, int w) {
  extern __shared__ uint32_t smem[];
  __shared__ int changed;
  const int ww = (w + 31) / 32;
  const int words = h * ww;
  uint32_t* wk = smem;
  uint32_t* cur = smem + words;
  const size_t frame = (size_t)blockIdx.x * h * w;
  const int tid = threadIdx.x;

  for (int k = tid; k < words; k += blockDim.x) {
    const int r = k / ww, c0 = (k % ww) * 32;
    const int n = min(32, w - c0);
    const uint8_t* srow = strong + frame + (size_t)r * w + c0;
    const uint8_t* wrow = weak + frame + (size_t)r * w + c0;
    uint32_t s = 0, a = 0;
    for (int j = 0; j < n; ++j) {
      s |= (uint32_t)(srow[j] != 0) << j;
      a |= (uint32_t)(wrow[j] != 0) << j;
    }
    cur[k] = s;
    wk[k] = a;
  }
  __syncthreads();

  while (true) {
    if (tid == 0) changed = 0;
    __syncthreads();

    // row sweeps: whole horizontal runs light in one pass
    for (int r = tid; r < h; r += blockDim.x) {
      uint32_t* crow = cur + r * ww;
      const uint32_t* arow = wk + r * ww;
      uint32_t carry = 0;
      for (int c = 0; c < ww; ++c) {
        const uint32_t a = arow[c], old = crow[c];
        const uint32_t b = flood_up(old | (a & carry), a);
        carry = b >> 31;
        if (b != old) { crow[c] = b; changed = 1; }
      }
      carry = 0;
      for (int c = ww - 1; c >= 0; --c) {
        const uint32_t a = arow[c], old = crow[c];
        const uint32_t b = flood_down(old | (a & (carry << 31)), a);
        carry = b & 1u;
        if (b != old) { crow[c] = b; changed = 1; }
      }
    }
    __syncthreads();

    // column sweeps: vertical and diagonal steps, down then up
    if (tid < ww) {
      const int c = tid;
      for (int r = 1; r < h; ++r) {
        const uint32_t a = wk[r * ww + c], old = cur[r * ww + c];
        uint32_t b = old | (a & dilate_from(cur, r - 1, c, ww));
        if (b != old) {
          b = flood_down(flood_up(b, a), a);
          cur[r * ww + c] = b;
          changed = 1;
        }
      }
      for (int r = h - 2; r >= 0; --r) {
        const uint32_t a = wk[r * ww + c], old = cur[r * ww + c];
        uint32_t b = old | (a & dilate_from(cur, r + 1, c, ww));
        if (b != old) {
          b = flood_down(flood_up(b, a), a);
          cur[r * ww + c] = b;
          changed = 1;
        }
      }
    }
    __syncthreads();
    const int again = changed;
    __syncthreads();
    if (!again) break;
  }

  for (int p = tid; p < h * w; p += blockDim.x) {
    const int r = p / w, col = p % w;
    out[frame + p] = (uint8_t)((cur[r * ww + (col >> 5)] >> (col & 31)) & 1u);
  }
}

}  // namespace

extern "C" int rspc_hysteresis_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// strong, weak, out: uint8 (bool) [frames, h, w], contiguous, on the
// current device. Launches on `stream`; allocates nothing.
extern "C" int rspc_hysteresis(const void* strong, const void* weak,
                               void* out, int frames, int h, int w,
                               void* stream) {
  if (frames <= 0 || h <= 0 || w <= 0) return 0;
  const int ww = (w + 31) / 32;
  const size_t smem = 2 * (size_t)h * ww * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      hysteresis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  hysteresis_kernel<<<frames, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)strong, (const uint8_t*)weak, (uint8_t*)out, h, w);
  return (int)cudaGetLastError();
}
