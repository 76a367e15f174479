// The ghost exchange's batched slab copy (dist/comm.py, dist/packed_halo.py;
// the host side is kernels/halo_copy.py): up to kMaxSlabs strided slabs
// copied in one launch of slab_copy_kernel.
//
// It replaces no TPU kernel. The reference moves its ghosts with
// jax.lax.ppermute inside shard_map and XLA fuses the slicing around it;
// the port made one PyTorch copy a slab and field instead: the packs and
// unpacks of every exchange, the seam strips' cuts and splices, some 140
// launches a step on a rank of #5's 2x2 mesh, each far shorter than its own
// launch and the graph's gap behind it. Here a pack, an unpack, a cut or a
// splice is one launch.
//
// A slab is nz x rows x cols 32-bit words (a float32 element is one word, a
// float64 two) at src + z sz + r sr + c, written to dst + z dz + r dr + c.
// The host merges rows, and then levels, into the run where both sides are
// contiguous across them, so a full-width row slab of a block is one run a
// level. The descriptors travel by value in the kernel's parameters (48 of
// 64 bytes: under the 4 KB that every CUDA version takes), so there is no
// table on the device and no copy to it, and a captured graph keeps them
// with the launch.
//
// Work. Slab i takes the grid blocks from its block0 up to the next slab's
// (a prefix the host computes; a block finds its slab by bisection). A
// wide slab (cols >= kWide words) is cut into units of one line (z, r) and
// at most kSeg words, a warp each; a line whose source and destination lie
// alike modulo 16 bytes moves 16 bytes a lane between a scalar head and
// tail, any other 4. A narrow slab (the ghost columns, 3 words wide in
// float32) gives each thread a line.
//
// Bound: bytes, each read once and written once, at 3.35 TB/s. An exchange
// moves a few MB at #5 on 2x2, a few microseconds at that rate, so a launch
// costs about its fixed latency; the point is to pay it once a batch.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlabs = 48;    // slabs a launch (kernels/halo_copy.py)
constexpr int kThreads = 256;    // a block's threads
constexpr int kWarps = kThreads / 32;
constexpr int kWide = 32;        // words a line from which a warp takes it
constexpr int kSeg = 1024;       // words a warp's unit, at most

struct Slab {
  const uint32_t* src;
  uint32_t* dst;
  long long sz, sr, dz, dr;      // strides of levels and rows, in words
  int nz, rows, cols;            // extents, cols in words
  int block0;                    // the slab's first grid block
};
static_assert(sizeof(Slab) == 64, "a slab descriptor is 64 bytes");

struct Batch {
  Slab s[kMaxSlabs];
  int n;
};
static_assert(sizeof(Batch) <= 4096, "the descriptors fit the parameters");

// n words from src to dst by the 32 lanes of a warp
__device__ __forceinline__ void copy_line(const uint32_t* __restrict__ src,
                                          uint32_t* __restrict__ dst, int n,
                                          int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  if (((a ^ b) & 15) != 0) {                   // never alike: 4 bytes a lane
#pragma unroll 4
    for (int i = lane; i < n; i += 32) dst[i] = src[i];
    return;
  }
  const int head = min(n, (int)(((16 - (b & 15)) & 15) >> 2));
  const int nv = (n - head) >> 2;
  if (lane < head) dst[lane] = src[lane];
  const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src + head);
  int4* __restrict__ d4 = reinterpret_cast<int4*>(dst + head);
#pragma unroll 4
  for (int i = lane; i < nv; i += 32) d4[i] = s4[i];
  const int t = head + 4 * nv + lane;
  if (t < n) dst[t] = src[t];                  // at most 3 words of tail
}

__global__ void __launch_bounds__(kThreads)
slab_copy_kernel(const Batch batch) {
  const int block = blockIdx.x;
  int lo = 0, hi = batch.n - 1;                // the last slab at or before
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (batch.s[mid].block0 <= block) lo = mid; else hi = mid - 1;
  }
  const Slab& s = batch.s[lo];
  const long long lines = (long long)s.nz * s.rows;
  long long line;
  int c0 = 0;
  if (s.cols >= kWide) {
    const int segs = (s.cols + kSeg - 1) / kSeg;
    const long long unit =
        (long long)(block - s.block0) * kWarps + threadIdx.x / 32;
    if (unit >= lines * segs) return;
    line = unit / segs;
    c0 = (int)(unit - line * segs) * kSeg;
  } else {
    line = (long long)(block - s.block0) * kThreads + threadIdx.x;
    if (line >= lines) return;
  }
  const int z = (int)(line / s.rows), r = (int)(line - (long long)z * s.rows);
  const uint32_t* __restrict__ src = s.src + z * s.sz + r * s.sr + c0;
  uint32_t* __restrict__ dst = s.dst + z * s.dz + r * s.dr + c0;
  if (s.cols >= kWide) {
    copy_line(src, dst, min(kSeg, s.cols - c0), threadIdx.x & 31);
  } else {
    for (int c = 0; c < s.cols; ++c) dst[c] = src[c];
  }
}

}  // namespace

// The layout that kernels/halo_copy.py writes: sizeof(Slab), kMaxSlabs,
// kThreads, kWide and kSeg, into out[0..4]; returns 0.
extern "C" int cm_slab_copy_layout(int* out) {
  out[0] = (int)sizeof(Slab);
  out[1] = kMaxSlabs;
  out[2] = kThreads;
  out[3] = kWide;
  out[4] = kSeg;
  return 0;
}

// One launch of slab_copy_kernel over the n descriptors at `slabs` (host
// memory, read before this returns) on a grid of `blocks`, on `stream`.
// Returns cudaGetLastError() after the launch; n outside 1..kMaxSlabs or
// no block is refused.
extern "C" int cm_slab_copy(const void* slabs, int n, int blocks,
                            void* stream) {
  if (slabs == nullptr || n < 1 || n > kMaxSlabs || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Batch batch{};
  std::memcpy(batch.s, slabs, sizeof(Slab) * n);
  batch.n = n;
  slab_copy_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(batch);
  return (int)cudaGetLastError();
}
