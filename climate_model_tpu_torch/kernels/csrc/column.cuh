// Helpers of the tiled kernels (fused_substep.cu, physics_epilogue.cu).
//
// A tile's lines: load_lines copies (field, level, row) lines of up to 64
// consecutive longitudes from device memory into shared memory, a warp per
// line and lanes along longitude, so each copy instruction reads
// consecutive floats, asynchronously, so many are in flight.
//
// A column of nz levels held by one warp: level k = m * 32 + lane lies in
// register m (m < L, L = ceil(nz / 32)) of lane k % 32. The helpers move
// values between levels with warp shuffles; every lane of the warp calls
// them (they are collective), and a level k >= nz is padding that the
// caller keeps at 0 before a sum.
#pragma once

#include "constants.cuh"

namespace cm {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// the lon index i on the circle of nx columns
__device__ __forceinline__ int wrap(int i, int nx) {
  if (i >= 0 && i < nx) return i;
  i %= nx;
  return i < 0 ? i + nx : i;
}

__device__ __forceinline__ int clamp_row(int j, int ny) {
  return j < 0 ? 0 : (j >= ny ? ny - 1 : j);
}

// An asynchronous 4-byte copy from device to shared memory (cp.async: no
// register holds the value, so a thread can have many in flight);
// wait_copies waits for every copy this thread started.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The lines (q, k, r) for q < nq, k < nk, r < nr, each of w <= 64
// longitudes from i_first (wrapped) on: line(q, k, r, row, off) names the
// line's row in device memory (indexed by longitude) and the offset in sm
// of its first element, whose columns are stride apart. A warp takes every
// kWarps-th line, lanes along longitude, and copies it with copy_async;
// its (q, k, r) advance by mixed-radix carries, so no integer division runs
// per line. The caller waits (wait_copies, then a barrier).
template <int kWarps, class Line>
__device__ __forceinline__ void load_lines(float* sm, int nq, int nk, int nr,
                                           int w, int i_first, int nx,
                                           int stride, Line line) {
  const int warp = threadIdx.x / 32, lane = lane_id();
  const int c0 = wrap(i_first + lane, nx), c1 = wrap(i_first + lane + 32, nx);
  // (q, k, r) of this warp's first line, and the step of kWarps lines
  int r = warp % nr, k = (warp / nr) % nk, q = warp / (nr * nk);
  const int dr = kWarps % nr, dk = (kWarps / nr) % nk;
  const int dq = kWarps / (nr * nk);
  while (q < nq) {
    const float* row;
    int off;
    line(q, k, r, row, off);
    if (lane < w) copy_async(sm + off + lane * stride, row + c0);
    if (lane + 32 < w) copy_async(sm + off + (lane + 32) * stride, row + c1);
    r += dr;
    k += dk;
    q += dq;
    if (r >= nr) { r -= nr; ++k; }
    if (k >= nk) { k -= nk; ++q; }
  }
}

// Set a kernel's shared memory to `bytes` a block, with the SM's memory
// split for the most shared memory; once per kernel (the flag).
template <class K>
__host__ inline int allow_smem(K kernel, int bytes, int& opted) {
  if (bytes <= opted) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) return (int)err;
  opted = bytes;
  return 0;
}

// x / y from r = rcp(y), the correctly rounded reciprocal: q = x * r
// corrected by one FMA step (Markstein). It gives the same bits as the IEEE
// division x / y whenever no intermediate leaves the normal range, and
// costs three instructions where the division costs about ten; a divisor
// shared by several quotients pays for its reciprocal once.
__device__ __forceinline__ float rcp(float y) { return __frcp_rn(y); }

__device__ __forceinline__ float div_rn(float x, float y, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, y, x), r, q);
}

// out[level k] = x[level k + 1]; undefined where k + 1 >= nz.
template <int L>
__device__ __forceinline__ void level_below(const float (&x)[L],
                                            float (&out)[L]) {
  const int lane = lane_id();
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const float d = __shfl_down_sync(kFull, x[m], 1);
    const float w = __shfl_sync(kFull, x[m + 1 < L ? m + 1 : m], 0);
    out[m] = lane == 31 ? (m + 1 < L ? w : 0.f) : d;
  }
}

// out[level k] = x[level k - 1]; undefined at k = 0.
template <int L>
__device__ __forceinline__ void level_above(const float (&x)[L],
                                            float (&out)[L]) {
  const int lane = lane_id();
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const float u = __shfl_up_sync(kFull, x[m], 1);
    const float w = __shfl_sync(kFull, x[m > 0 ? m - 1 : 0], 31);
    out[m] = lane == 0 ? (m > 0 ? w : 0.f) : u;
  }
}

// In place: x[k] = sum of x[k'] over k' >= k. Within each 32-level
// segment a Hillis-Steele tree over the lanes, from the bottom segment up,
// then the sum of the segments below added: (segment's tree sum) + carry.
template <int L>
__device__ __forceinline__ void suffix_sum(float (&x)[L]) {
  const int lane = lane_id();
  float carry = 0.f;
#pragma unroll
  for (int m = L - 1; m >= 0; --m) {
    float s = x[m];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(kFull, s, off);
      if (lane + off < 32) s += y;
    }
    x[m] = m == L - 1 ? s : s + carry;
    carry = m == L - 1 ? __shfl_sync(kFull, s, 0)
                       : carry + __shfl_sync(kFull, s, 0);
  }
}

// The sum over every level, on every lane: each lane's levels in order,
// then a butterfly over the lanes.
template <int L>
__device__ __forceinline__ float column_sum(const float (&x)[L]) {
  float s = x[0];
#pragma unroll
  for (int m = 1; m < L; ++m) s += x[m];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// The value of x at level k (any lane may ask; every lane gets it).
template <int L>
__device__ __forceinline__ float at_level(const float (&x)[L], int k) {
  float v = 0.f;
#pragma unroll
  for (int m = 0; m < L; ++m)
    if (m == k / 32) v = x[m];
  return __shfl_sync(kFull, v, k % 32);
}

// x[k] += d at level k alone.
template <int L>
__device__ __forceinline__ void add_at_level(float (&x)[L], int k, float d) {
  const int lane = lane_id();
#pragma unroll
  for (int m = 0; m < L; ++m)
    if (m * 32 + lane == k) x[m] = x[m] + d;
}

// The Exner factor (p / p_ref) ** kappa of the surface border of a column
// with COLP cn.
__device__ __forceinline__ float surface_exner(const float* sigma_vb,
                                               float ptop, float cn, int nz) {
  return powf(div_rn(ptop + sigma_vb[nz] * cn, kPRef, kRecipPRef), kKappa);
}

// Border pressures, Exner factors and the layer Exner factor of every
// level of a column with COLP cn (operators.py::diagnose_pressure): each
// lane raises its levels' upper border to kappa and takes the lower
// border's from the level below; the surface border's, x_sfc, comes from
// the caller (computed a column a thread, so no lane raises a second
// border).
template <int L>
struct Pressure {
  float lo[L], hi[L];      // border pressure above / below the level
  float x_lo[L], x_hi[L];  // (p / p_ref) ** kappa at those borders
  float pvtf[L];           // layer-mean Exner factor

  __device__ __forceinline__ void compute(const float* sigma_vb, float ptop,
                                          float cn, int nz, float x_sfc) {
    const int lane = lane_id();
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const int k = m * 32 + lane;
      lo[m] = k < nz ? ptop + sigma_vb[k] * cn : kPRef;
      x_lo[m] = powf(div_rn(lo[m], kPRef, kRecipPRef), kKappa);
    }
    level_below(lo, hi);
    level_below(x_lo, x_hi);
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const int k = m * 32 + lane;
      if (k == nz - 1) {
        hi[m] = ptop + sigma_vb[nz] * cn;
        x_hi[m] = x_sfc;
      }
      pvtf[m] = (hi[m] * x_hi[m] - lo[m] * x_lo[m])
                / (kOnePlusKappa * (hi[m] - lo[m]));
    }
  }
};

}  // namespace cm
