// Kernel B3: Canny hysteresis as connected-components labelling.
//
// Replaces the TPU kernel rspc_tpu/ops/canny.py::_hysteresis_kernel (a
// whole-frame fixpoint of directional floods in VMEM, one frame a call).
//
// What it computes, and why any labelling gives the same bits. The
// result is the 8-connected closure of the strong pixels through weak
// pixels. That equals the union of the 8-connected components of
// A = weak | strong that hold a strong pixel: on any path inside A from
// a strong pixel, every pixel after the last strong one is weak. So the
// kernel labels the components of A and lights a pixel of A when its
// component holds a strong pixel; which order the unions run in changes
// the labels, never the output, and the output equals the plain version
// (rspc_tpu_torch/ops/canny.py::_hysteresis_plain) bit for bit.
//
// Keys. Pixel p (flat index over the batch, < 2^31) has the key
// p | (strong ? 0 : 2^31). Every union hooks the larger root key under
// the smaller, so a tree's root is its least key, and that key has bit 31
// clear exactly when the tree holds a strong pixel: no separate marking
// pass. A label holds the key of an ancestor and only ever decreases: the
// hook is atomicMin, and path halving writes a grandparent with atomicMin
// as well. Because only "does the tree hold a strong pixel" reaches the
// output, a union of two trees that both already hold one may be skipped:
// a tree without a strong pixel never has a union skipped, so it still
// grows to its whole component, and every other tree is lit anyway.
//
// Three passes, each a launch on the caller's stream:
//   1. local: a block of 2 warps per 32 x 32 tile of a frame. Each warp
//      reads the tile's strong and weak bytes, 16 a lane (byte loads where
//      the frame's width or a pointer forbids 16-byte loads, or the tile
//      is ragged), as bits, and lane r gathers row r's A and strong bits.
//      Every run of A in a row hangs under its least key (found from the
//      bits: no union inside a row); lane r unites row r's runs with those
//      of row r-1, one union per run of columns where both rows have A
//      and one per diagonal contact no such run already joins (each warp
//      half the columns), in shared memory; then each run points at its
//      root and every pixel of A writes its root's global key to the
//      labels, a warp store per row. The tile's border bits (top and
//      bottom rows, left and right columns) go to a small array for pass
//      2. A tile without A stops after its border bits; the labels of
//      pixels outside A are never written and never read.
//   2. merge: a warp per tile joins the tile across its top border (with
//      the bottom rows of the three tiles above) and its left border
//      (with the right column of the tile to the left) by the same
//      contact rule on the border bits, on the global labels. Neighbours
//      are tiles of the same frame, so no union crosses a frame's first
//      or last row or wraps a row's end, and every contact between two
//      tiles is joined once.
//   3. output: 16 pixels a thread, flat over the batch, 16-byte loads and
//      stores where the pointers allow: a strong pixel is lit, a weak one
//      is lit when a key on its way to the root has bit 31 clear, the rest
//      is dark; the walks of 8 pixels advance together.
//
// What bounds it on the card: latency, no longer a serial chain over the
// frame. The function's bytes (the masks read once, the output written
// once: 9.2 MB at 10 x 480 x 640) take 2.75 us at 3.35 TB/s; the kernel
// reads the masks twice and writes and walks 4-byte labels, all held in
// the 50 MB L2. Pass 1 has one block per tile (3,000 at 10 x 480 x 640;
// up to 32 blocks resident per SM, so one wave), and its time is that of
// its slowest tiles: the dependent shared-memory finds of the row unions
// and the 32 row stores. The passes do not depend on the data's longest
// chain, only on the depth of the union-find trees. Frames of any size
// run: nothing scales with the frame in shared memory. The tensor cores
// have no role in boolean connectivity.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                   // tile side, pixels
constexpr int kTilePixels = kTile * kTile;
constexpr int kParts = 2;                   // pass 1: warps per tile (a block per tile)
constexpr int kLocalThreads = kParts * kTile;
constexpr int kMergeThreads = 128;          // pass 2: a warp per tile, 4 tiles a block
constexpr int kOutPixels = 16;              // pass 3's pixels per thread
constexpr int kWalk = 8;                    // pass 3's walks in flight per thread
constexpr int kOutThreads = 256;
constexpr uint32_t kWeakOnly = 1u << 31;    // global key: the pixel is not strong
constexpr uint32_t kIndex = kWeakOnly - 1;
constexpr uint32_t kLocalWeakOnly = 1u << 10;  // the same flag on a tile's keys
constexpr uint32_t kLocalIndex = kLocalWeakOnly - 1;
static_assert(kTilePixels <= (int)kLocalWeakOnly, "tile keys overflow their flag");

// A label read that sees other blocks' atomics: L2, not a stale L1 line
// (kGlobal), or a volatile shared-memory read.
template <uint32_t kIdx, bool kGlobal>
__device__ __forceinline__ uint32_t read_label(uint32_t* lab, uint32_t k) {
  if constexpr (kGlobal) return __ldcg(lab + (k & kIdx));
  else return *reinterpret_cast<volatile uint32_t*>(lab + (k & kIdx));
}

// Root key of k's tree, halving the path on the way (each visited node is
// lowered to its grandparent, with atomicMin: never raised). A path has
// at most 1024 nodes in a tile's shared labels; in the global labels
// every value is a tile root's key, so a path is shorter than 1 + 2^21
// (the tiles of 2^31 pixels). A walk of kMaxSteps can only be a cycle,
// and traps rather than hanging the card.
constexpr uint32_t kMaxSteps = 1u << 24;

template <uint32_t kIdx, bool kGlobal>
__device__ uint32_t find_root(uint32_t* lab, uint32_t k) {
  for (uint32_t step = 0;; ++step) {
    if (step == kMaxSteps) __trap();
    const uint32_t p = read_label<kIdx, kGlobal>(lab, k);
    if (p == k) return k;
    const uint32_t g = read_label<kIdx, kGlobal>(lab, p);
    if (g == p) return p;
    atomicMin(lab + (k & kIdx), g);
    k = g;
  }
}

// Join the trees of keys a and b: hook the larger root under the smaller.
// If the larger was hooked elsewhere meanwhile (atomicMin returns another
// value), its subtree now hangs under the smaller root and the tree it
// had joined is united next.
template <uint32_t kIdx, bool kGlobal>
__device__ void unite(uint32_t* lab, uint32_t a, uint32_t b) {
  while (true) {
    a = find_root<kIdx, kGlobal>(lab, a);
    b = find_root<kIdx, kGlobal>(lab, b);
    if (a == b) return;
    if (a > b) {
      const uint32_t t = a;
      a = b;
      b = t;
    }
    const uint32_t old = atomicMin(lab + (b & kIdx), a);
    if (old == b) return;
    b = old;
  }
}

struct Tile {
  size_t base;  // the frame's first pixel
  int r0, c0;   // the tile's first row and column in the frame
};

__device__ __forceinline__ Tile tile_of(int block, int h, int w, int tiles_y,
                                        int tiles_x) {
  const int per_frame = tiles_y * tiles_x;
  const int frame = block / per_frame, rest = block % per_frame;
  return {(size_t)frame * h * w, (rest / tiles_x) * kTile, (rest % tiles_x) * kTile};
}

__device__ __forceinline__ uint32_t key_of(size_t p, bool strong) {
  return (uint32_t)p | (strong ? 0u : kWeakOnly);
}

// 16 bool bytes (16-byte aligned when kVec16 and the chunk is whole)
// as 16 bits, bit j for byte j: nonzero bytes count as true.
template <bool kVec16>
__device__ __forceinline__ uint32_t load_bits16(const uint8_t* src, int valid) {
  uint32_t x[4] = {0, 0, 0, 0};
  if (kVec16 && valid >= 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < valid) x[j / 4] |= (uint32_t)src[j] << (8 * (j % 4));
  }
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // each byte to 0 or 1, then the four bytes to four bits in order
    const uint32_t nz = ((((x[j] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x[j]) & 0x80808080u) >> 7;
    bits |= ((nz * 0x01020408u) >> 24) << (4 * j);
  }
  return bits;
}

// The key of the representative of the run of A through column col of a
// tile row (A bits on_m, strong bits st_m): the run's least key, its
// first strong pixel, else its first pixel.
__device__ __forceinline__ uint32_t rep_key(uint32_t on_m, uint32_t st_m, int row, int col) {
  const uint32_t bit = 1u << col;
  const uint32_t below = ~on_m & (bit - 1), above = ~on_m & ~(bit | (bit - 1));
  const int start = below ? 32 - __clz(below) : 0;
  const uint32_t run = (above ? (above & (0u - above)) - 1 : ~0u) & (~0u << start);
  const uint32_t run_st = st_m & run;
  return run_st ? (uint32_t)(row * kTile + __ffs(run_st) - 1)
                : (uint32_t)(row * kTile + start) | kLocalWeakOnly;
}

template <bool kVec16>
__global__ void __launch_bounds__(kLocalThreads)
hysteresis_local(const uint8_t* __restrict__ strong,
                 const uint8_t* __restrict__ weak, uint4* __restrict__ borders,
                 uint32_t* __restrict__ labels, int h, int w, int tiles_y,
                 int tiles_x) {
  __shared__ uint32_t lab[kTilePixels];  // union-find over the runs' representatives
  const int lane = threadIdx.x % kTile, part = threadIdx.x / kTile;
  const Tile tile = tile_of(blockIdx.x, h, w, tiles_y, tiles_x);
  constexpr uint32_t kAll = ~0u;
  // the columns whose runs, contacts and output rows this warp takes
  constexpr int kPartCols = kTile / kParts;
  const uint32_t cols = kParts == 1 ? ~0u : ((1u << (kPartCols % kTile)) - 1) << (part * kPartCols);

  // Every warp reads the tile's masks as bits: chunk q = lane + 32 j of
  // 16 bytes, strong (j < 2) or weak, row q / 2 % 32, columns 16 (q % 2)
  // on; then lane r gathers row r's A bits (my_on) and strong bits
  // (my_st). Rows and columns outside the frame read as 0.
  uint32_t bits[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = lane + kTile * j, row = (q / 2) % kTile, col = 16 * (q % 2);
    const int r = tile.r0 + row, c = tile.c0 + col;
    const int valid = r < h ? min(16, w - c) : 0;
    bits[j] = valid > 0
        ? load_bits16<kVec16>((j < 2 ? strong : weak) + tile.base + (size_t)r * w + c, valid)
        : 0u;
  }
  uint32_t half[4];  // strong lo, strong hi, weak lo, weak hi of row `lane`
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int src = (2 * lane + hi) % kTile;
      const uint32_t a = __shfl_sync(kAll, bits[2 * m], src);
      const uint32_t b = __shfl_sync(kAll, bits[2 * m + 1], src);
      half[2 * m + hi] = lane < kTile / 2 ? a : b;
    }
  }
  const uint32_t my_st = half[0] | half[1] << 16;
  const uint32_t my_on = my_st | half[2] | half[3] << 16;
  // the A bits of the tile's top and bottom rows and of its left and
  // right columns, for pass 2
  const uint32_t left = __ballot_sync(kAll, my_on & 1u), right = __ballot_sync(kAll, my_on >> 31);
  const uint32_t top = __shfl_sync(kAll, my_on, 0), bottom = __shfl_sync(kAll, my_on, kTile - 1);
  if (threadIdx.x == 0) borders[blockIdx.x] = make_uint4(top, bottom, left, right);
  if (!__any_sync(kAll, my_on)) return;  // no pixel of A (every warp agrees)
  const int row = lane;
  const uint32_t starts = my_on & ~(my_on << 1) & cols;

  // Lane r: every run of A in row r hangs under its representative, so
  // no union runs inside a row ...
  for (uint32_t m = starts; m; m &= m - 1) {
    const uint32_t key = rep_key(my_on, my_st, row, __ffs(m) - 1);
    lab[key & kLocalIndex] = key;
  }
  __syncthreads();

  // ... and rows r-1 and r take one union per run of columns where both
  // have A (N), and one per diagonal contact (NE, NW) that no such run
  // already joins. A lane takes its row's contacts one after another.
  const uint32_t up = __shfl_up_sync(kAll, my_on, 1), up_st = __shfl_up_sync(kAll, my_st, 1);
  if (row > 0) {
    const uint32_t both = my_on & up;
    for (uint32_t m = both & ~(both << 1) & cols; m; m &= m - 1) {
      const int col = __ffs(m) - 1;
      unite<kLocalIndex, false>(lab, rep_key(my_on, my_st, row, col),
                                rep_key(up, up_st, row - 1, col));
    }
    for (uint32_t m = my_on & (up >> 1) & ~(my_on >> 1) & ~up & cols; m; m &= m - 1) {
      const int col = __ffs(m) - 1;
      unite<kLocalIndex, false>(lab, rep_key(my_on, my_st, row, col),
                                rep_key(up, up_st, row - 1, col + 1));
    }
    for (uint32_t m = my_on & (up << 1) & ~(my_on << 1) & ~up & cols; m; m &= m - 1) {
      const int col = __ffs(m) - 1;
      unite<kLocalIndex, false>(lab, rep_key(my_on, my_st, row, col),
                                rep_key(up, up_st, row - 1, col - 1));
    }
  }
  __syncthreads();

  // Each representative points straight at its root (a store of an
  // ancestor's key, never above the label it replaces) ...
  for (uint32_t m = starts; m; m &= m - 1) {
    const uint32_t key = rep_key(my_on, my_st, row, __ffs(m) - 1);
    lab[key & kLocalIndex] = find_root<kLocalIndex, false>(lab, key);
  }
  __syncthreads();

  // ... and every pixel of A writes the global key of its root, a lane a
  // column: a row of a tile is one coalesced store of a warp.
  const int c = tile.c0 + lane;
  for (int rr = part; rr < kTile; rr += kParts) {
    const uint32_t on_m = __shfl_sync(kAll, my_on, rr), st_m = __shfl_sync(kAll, my_st, rr);
    if (!(on_m >> lane & 1)) continue;
    const uint32_t root = lab[rep_key(on_m, st_m, rr, lane) & kLocalIndex];
    const int i = root & kLocalIndex;
    labels[tile.base + (size_t)(tile.r0 + rr) * w + c] =
        key_of(tile.base + (size_t)(tile.r0 + i / kTile) * w + tile.c0 + i % kTile,
               !(root & kLocalWeakOnly));
  }
}

// Pass 2, a warp per tile: the contacts of A across the tile's top
// border (with the bottom rows of the three tiles above) and its left
// border (with the right column of the tile to the left), found from the
// border bits of pass 1 by the rule of pass 1's row pairs (one union per
// run of positions where both sides have A, one per diagonal contact no
// such run already joins), plus the two corner contacts of the top row's
// ends. A tile handles its top and left borders only, and only inside
// its frame, so every contact between two tiles is handled once and none
// crosses a frame's edge or a row's end.
__global__ void __launch_bounds__(kMergeThreads)
hysteresis_merge(const uint4* __restrict__ borders, uint32_t* labels, int h,
                 int w, int tiles_y, int tiles_x, long long tiles) {
  const int lane = threadIdx.x % kTile;
  const long long tile_i = (long long)blockIdx.x * (kMergeThreads / kTile) + threadIdx.x / kTile;
  if (tile_i >= tiles) return;
  const Tile tile = tile_of((int)tile_i, h, w, tiles_y, tiles_x);
  const int tx = tile.c0 / kTile;
  const uint4 me = borders[tile_i];
  const uint32_t bit = 1u << lane;
  // Labels are ancestors' keys. Bit 31 clear on both sides: both trees
  // already hold a strong pixel, and their union changes no output.
  auto join = [&](size_t p, size_t q) {
    const uint32_t lp = __ldcg(labels + p), lq = __ldcg(labels + q);
    if ((lp | lq) & kWeakOnly) unite<kIndex, true>(labels, lp, lq);
  };
  // contacts between a side `mine` and a side `other` one position over:
  // `step` is the address step between neighbouring positions
  auto contacts = [&](uint32_t mine, uint32_t other, size_t p, size_t q, size_t step) {
    const uint32_t both = mine & other;
    if ((both & bit) && !(both & (bit >> 1))) join(p, q);
    if ((mine & bit) && !(other & bit)) {
      if (lane < kTile - 1 && (other & (bit << 1)) && !(mine & (bit << 1))) join(p, q + step);
      if (lane > 0 && (other & (bit >> 1)) && !(mine & (bit >> 1))) join(p, q - step);
    }
  };
  if (tile.r0 > 0) {
    const size_t p = tile.base + (size_t)tile.r0 * w + tile.c0 + lane;
    contacts(me.x, borders[tile_i - tiles_x].y, p, p - w, 1);
    if (lane == 0 && tx > 0 && (me.x & 1u) && (borders[tile_i - tiles_x - 1].y >> 31))
      join(p, p - w - 1);
    if (lane == kTile - 1 && tx + 1 < tiles_x && (me.x >> 31) &&
        (borders[tile_i - tiles_x + 1].y & 1u))
      join(p, p - w + 1);
  }
  if (tx > 0) {
    const size_t p = tile.base + (size_t)(tile.r0 + lane) * w + tile.c0;
    contacts(me.z, borders[tile_i - 1].w, p, p - 1, (size_t)w);
  }
}

template <bool kVec16>
__global__ void __launch_bounds__(kOutThreads)
hysteresis_output(const uint8_t* __restrict__ strong,
                  const uint8_t* __restrict__ weak, uint32_t* labels,
                  uint8_t* __restrict__ out, long long n) {
  const long long first = ((long long)blockIdx.x * kOutThreads + threadIdx.x) * kOutPixels;
  if (first >= n) return;
  const int valid = (int)min((long long)kOutPixels, n - first);
  // A strong pixel is lit. A weak one is lit when its tree holds a strong
  // pixel: its root, the least key, has bit 31 clear, and so has any key
  // on the way up. The walks of 8 weak pixels advance together (their
  // loads in flight at once), halving their paths.
  uint32_t lit = load_bits16<kVec16>(strong + first, valid);
  const uint32_t weak_only = load_bits16<kVec16>(weak + first, valid) & ~lit;
#pragma unroll 1
  for (int base = 0; base < kOutPixels; base += kWalk) {
    uint32_t walking = (weak_only >> base) & ((1u << kWalk) - 1), k[kWalk], p[kWalk];
#pragma unroll
    for (int j = 0; j < kWalk; ++j)
      if (walking >> j & 1) k[j] = __ldcg(labels + first + base + j);
    for (uint32_t step = 0; walking; ++step) {
      if (step == kMaxSteps) __trap();
#pragma unroll
      for (int j = 0; j < kWalk; ++j) {
        if ((walking >> j & 1) && !(k[j] & kWeakOnly)) {
          lit |= 1u << (base + j);
          walking &= ~(1u << j);
        }
      }
#pragma unroll
      for (int j = 0; j < kWalk; ++j)
        if (walking >> j & 1) p[j] = __ldcg(labels + (k[j] & kIndex));
#pragma unroll
      for (int j = 0; j < kWalk; ++j) {
        if (!(walking >> j & 1)) continue;
        if (p[j] == k[j]) {  // a root without a strong pixel
          walking &= ~(1u << j);
        } else if (p[j] & kWeakOnly) {
          const uint32_t g = __ldcg(labels + (p[j] & kIndex));
          if (g != p[j]) atomicMin(labels + (k[j] & kIndex), g);
          k[j] = g;
        } else {
          k[j] = p[j];
        }
      }
    }
  }
  uint32_t o[kOutPixels / 4];
#pragma unroll
  for (int j = 0; j < kOutPixels / 4; ++j)
    o[j] = ((lit >> (4 * j)) & 1u) | ((lit >> (4 * j + 1)) & 1u) << 8 |
           ((lit >> (4 * j + 2)) & 1u) << 16 | ((lit >> (4 * j + 3)) & 1u) << 24;
  if (kVec16 && valid == kOutPixels) {
    *reinterpret_cast<uint4*>(out + first) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    for (int j = 0; j < valid; ++j) out[first + j] = (lit >> j) & 1u;
  }
}

}  // namespace

// strong, weak, out: uint8 (bool) [frames, h, w], contiguous, on the
// current device; scratch: 4 * tiles + frames * h * w uint32 words, 16-byte
// aligned (its contents on entry do not matter): the tiles' border bits,
// then the labels. tiles_y, tiles_x: the tile grid of one frame
// (ceil(h / 32), ceil(w / 32); ops/canny.py::plan). Launches the three
// passes on `stream`, checking each launch; allocates nothing.
extern "C" int rspc_hysteresis(const void* strong, const void* weak,
                               void* scratch, void* out, int frames, int h,
                               int w, int tiles_y, int tiles_x,
                               void* stream) {
  if (frames <= 0 || h <= 0 || w <= 0) return 0;
  const long long n = (long long)frames * h * w;
  const long long tiles = (long long)frames * tiles_y * tiles_x;
  if (n > (long long)kIndex || (uintptr_t)scratch % 16 != 0 ||
      (long long)tiles_y * kTile < h || (long long)tiles_x * kTile < w ||
      (long long)(tiles_y - 1) * kTile >= h || (long long)(tiles_x - 1) * kTile >= w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* st = (const uint8_t*)strong;
  const auto* wk = (const uint8_t*)weak;
  auto* borders = (uint4*)scratch;
  auto* lab = (uint32_t*)scratch + 4 * tiles;
  const bool in16 = ((uintptr_t)strong | (uintptr_t)weak) % 16 == 0;

  constexpr int kMergeTiles = kMergeThreads / kTile;
  if (in16 && w % 16 == 0)
    hysteresis_local<true><<<(unsigned)tiles, kLocalThreads, 0, s>>>(st, wk, borders, lab, h, w, tiles_y, tiles_x);
  else
    hysteresis_local<false><<<(unsigned)tiles, kLocalThreads, 0, s>>>(st, wk, borders, lab, h, w, tiles_y, tiles_x);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  hysteresis_merge<<<(unsigned)((tiles + kMergeTiles - 1) / kMergeTiles), kMergeThreads, 0, s>>>(
      borders, lab, h, w, tiles_y, tiles_x, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long threads = (n + kOutPixels - 1) / kOutPixels;
  const unsigned blocks = (unsigned)((threads + kOutThreads - 1) / kOutThreads);
  if (in16 && (uintptr_t)out % 16 == 0)
    hysteresis_output<true><<<blocks, kOutThreads, 0, s>>>(st, wk, lab, (uint8_t*)out, n);
  else
    hysteresis_output<false><<<blocks, kOutThreads, 0, s>>>(st, wk, lab, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
