// Helpers of the kernels that march along latitude (fused_substep.cu,
// physics_epilogue.cu): strips and balanced runs of (strip, row) units, the
// block's segments, counters of finished tasks and the mbarriers that staged
// rows land on.
//
// Strips and runs. A block's nx longitudes are cut into ceil(nx / tx)
// strips of equal width to within q (the largest of 4, 2, 1 dividing nx),
// each starting at a multiple of q. A (strip, row) unit weighs the lanes
// its row's update passes span (pass_lanes: the strip's columns rounded up
// to a power of two, what a row of the strip costs), and belongs to the
// grid block whose share of the weight, b / blocks to (b + 1) / blocks of
// the whole, holds its midpoint, so runs differ by less than a unit's
// weight; a grid of as many blocks as units gives each block one
// (kernels/fused_substep.py::run_start is the same rule). A block walks its
// run as segments, the rows of one strip each, south to north.
#pragma once

#include <cstdint>

#include "column.cuh"

namespace cm {

__host__ __device__ inline int quantum(int nx) {
  return nx % 4 == 0 ? 4 : nx % 2 == 0 ? 2 : 1;
}

// the first longitude of strip s of `strips`
__device__ __forceinline__ int strip_start(int nx, int strips, int s) {
  const int q = quantum(nx);
  return q * (s * (nx / q) / strips);               // < 2^31: s * nx / q
}

// the lanes an update pass of a strip of ncol columns spans
__host__ __device__ inline int pass_lanes(int ncol) {
  int l = 1;
  while (l < ncol) l <<= 1;
  return l;
}

// the first unit (strip * ny + row) of block b's run
__device__ inline int run_start(int ny, int nx, int tx, int blocks, int b) {
  const int strips = (nx + tx - 1) / tx, units = strips * ny;
  if (blocks >= units) return min(b, units);         // a unit each
  const int q = quantum(nx), chunks = nx / q, g = blocks;
  const int w_lo = pass_lanes(q * (chunks / strips));
  const int w_hi = pass_lanes(q * ((chunks + strips - 1) / strips));
  if (w_lo == w_hi) {
    // every unit weighs the same: the least unit whose midpoint reaches
    // b / g of them, ceil((2 b units - g) / (2 g))
    const int num = 2 * b * units - g;
    return num <= 0 ? 0 : (num + 2 * g - 1) / (2 * g);
  }
  long long total = 0;
  for (int s = 0; s < strips; ++s)
    total += pass_lanes(strip_start(nx, strips, s + 1)
                        - strip_start(nx, strips, s));
  const long long share = b * total * ny;      // the target: share / g
  long long before = 0;                 // the weight of the strips before s
  for (int s = 0;; ++s) {
    const long long w = pass_lanes(strip_start(nx, strips, s + 1)
                                   - strip_start(nx, strips, s));
    if ((before + w * ny) * g > share || s == strips - 1) {
      // the first unit of strip s whose midpoint reaches the target
      const long long num = 2 * share - g * (2 * before + w);
      const long long j = num <= 0 ? 0 : (num + 2 * g * w - 1) / (2 * g * w);
      return j >= ny ? (s + 1) * ny : s * ny + (int)j;
    }
    before += w * ny;
  }
}

// Calls segment(s, jA, jB) for each segment of this block's run: rows jA ..
// jB-1 of strip s, in the order of the run.
template <class Segment>
__device__ __forceinline__ void for_each_segment(int ny, int nx, int tx,
                                                 int blocks,
                                                 Segment segment) {
  const int u1 = run_start(ny, nx, tx, blocks, blockIdx.x + 1);
  for (int u = run_start(ny, nx, tx, blocks, blockIdx.x); u < u1;) {
    const int s = u / ny, jA = u - s * ny;
    const int jB = min(ny, jA + (u1 - u));
    segment(s, jA, jB);
    u += jB - jA;
  }
}

// ---------------------------------------------------------------------------
// Staged lines. A (field, level) line of a strip keeps longitude fastest at
// a pitch of 4 mod 8 floats, 16-byte aligned from its fifth float, so that
// its copies are 16 bytes a lane where the rows allow it.
// ---------------------------------------------------------------------------

// the least n' >= n with n' = 4 mod 8: a line's pitch, a multiple of 4
// floats (16-byte copies) whose multiples by 32 consecutive levels fall in
// 8 banks, the fewest conflicts such a pitch allows
__host__ __device__ constexpr int pitch(int n) {
  return n + ((4 - n) % 8 + 8) % 8;
}

// the widest copy (4, 2 or 1 floats) that the rows of every staged field
// allow: a multiple of it in nx and in each field's address
inline int copy_width(int nx, const float* const* fields, int n) {
  for (int vec = quantum(nx); vec > 1; vec /= 2) {
    bool ok = true;
    for (int q = 0; q < n; ++q)
      ok = ok && reinterpret_cast<uintptr_t>(fields[q]) % (4 * vec) == 0;
    if (ok) return vec;
  }
  return 1;
}

// An asynchronous copy of 16, 8 or 4 bytes from device memory to the shared
// address dst (16 bytes bypass L1)
__device__ __forceinline__ void cp_async(unsigned dst, const float* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src));
}

// ---------------------------------------------------------------------------
// Counters of finished tasks in shared memory.
// ---------------------------------------------------------------------------

// Lane 0 reads the counter with acquire semantics until it reaches `want`;
// the warp's barrier then orders every lane's reads after it.
__device__ __forceinline__ void wait_for(const int* c, int want) {
  if (lane_id() == 0) {
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(c));
    int v;
    for (;;) {
      asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
                   : "=r"(v) : "r"(addr) : "memory");
      if (v >= want) break;
      __nanosleep(20);
    }
  }
  __syncwarp();
}

// The warp's barrier orders every lane's writes before lane 0's release.
__device__ __forceinline__ void finished(int* c) {
  __syncwarp();
  if (lane_id() == 0) {
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(c));
    asm volatile("red.release.cta.shared.add.s32 [%0], 1;\n"
                 :: "r"(addr) : "memory");
  }
}

// ---------------------------------------------------------------------------
// The mbarrier of a ring slot: each lane of each of a row's copy tasks
// arrives once, when its copies have landed.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(unsigned long long* bar,
                                             int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n"
               :: "r"(shared_addr(bar)), "r"(count) : "memory");
}

// this lane's arrival, once every copy it has issued has landed
__device__ __forceinline__ void arrive_on_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
               :: "r"(shared_addr(bar)) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void barrier_wait(unsigned long long* bar,
                                             unsigned parity) {
  const unsigned addr = shared_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
}

}  // namespace cm
