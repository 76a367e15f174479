// One full Matsuno substep of the dycore (tendencies + mass-weighted update),
// hand-written CUDA C++ for Hopper (sm_90a), fp32, in one launch.
//
// Replaces the TPU kernel climate_model_tpu/kernels/fused_substep.py::
// make_fused_substep_packed (the pallas_call at :1047) in the variants the
// Matsuno paths launch (climate_model_tpu/dycore/stepper.py:116-117 per step,
// climate_model_tpu/model.py:118-120 on the packed scan):
//   predictor  same_base=1: tendencies at the state, advanced from it;
//   corrector  same_base=0: tendencies at the predicted state, advanced from
//              the time-n base state (COLP_new = COLP_base + dt*dCOLP/dt).
// vmask (null, or a (ny,) row mask: 1 on interior v rows, 0 on walls) is the
// wall_mask=True form: v is multiplied by it instead of zeroing row 0 by
// index. The packed scan's corrector also runs the physics epilogue; that
// is a second launch, physics_epilogue.cu, on the fields written here.
// with_rad adds the cached radiative heating to the POTT tendency, with_diff
// the COLP-weighted 5-point horizontal diffusion (coefficients per latitude,
// read from the geometry table, so retuning them rebuilds nothing). dt is a
// runtime operand, read by each block from a float[2] on the device
// (scalars[0]; the reference's jnp.stack([dt_s, frac]) operand): adaptive
// dt never rebuilds or re-specialises anything, and a captured CUDA graph
// (climate_model_tpu_torch/graphs.py) takes a new dt without a re-capture.
//
// The same machinery runs one stage of classical RK4 on the conserved
// variables y = (COLP, COLP_u u, COLP_v v, COLP POTT, COLP QV, COLP QC)
// (rk4_stage_kernel<STAGE>, STAGE = 1..4; climate_model_tpu_torch/dycore/
// stepper.py::step_rk4): the tendencies k at the stage state, as the
// predictor computes them (its COLP_new, for the sigma velocity and the
// vertical fluxes, is the stage state's COLP + dt dCOLP/dt with the full
// dt, as tendencies(s, s.colp, dt) has it); then, from the t_n state y0,
// the next stage state y0 + c dt k (c = 1/2, 1/2, 1) in primitive form,
// QV and QC clamped at 0 and the v wall kept, as from_conserved does, and
// w dt k (w = 1/6, 1/3, 1/3, 1/6) added to an accumulator of the conserved
// tendencies in device memory (written by stages 1-3, read by 2-4). The
// last stage writes y0 + the accumulator in primitive form. A point of the
// accumulator is read and written by one thread (its COLP by the scan of
// its own column); only the last stage, which writes none of it, reads the
// accumulated COLP of the columns around. The stage's scan slot holds one
// more row: the next state's COLP.
//
// Layout: the plain State layout of the port. 3-D fields are contiguous
// (nz, ny, nx) fp32, 2-D fields (ny, nx). Longitude is periodic (an index
// wrap); latitude has rigid walls: south/north "clamp" neighbours replicate
// the edge row, "zero" neighbours read 0 beyond it, and v's south-wall row is
// held at 0 (climate_model_tpu_torch/dycore/boundaries.py). Per-latitude
// geometry is one (ny, 11) table in GEO_FIELDS order
// (kernels/fused_substep.py). None of the TPU kernel's Mosaic machinery (lane
// padding, K2 head slots, VMEM tile budget, manual DMA) is carried over.
//
// Shards (climate_model_tpu_torch/dist/packed_halo.py, the port of
// climate_model_tpu/dist/packed_halo.py). The shard-local variant is this
// launch on a shard's block, unchanged: the lon index still wraps, so the
// outermost columns of a block narrower than the circle read the far side's
// ghost columns. That is wrong data, as the TPU kernel's clamp
// (make_fused_substep_packed(..., wrap_lon=False),
// climate_model_tpu/kernels/fused_substep.py:392-398) is, and the chain
// radius below keeps it in the ghost columns, whose outputs belong to the
// neighbouring shard and are overwritten by the next exchange. The v wall
// comes from the block's rows of the global mask. Latitude needs no
// argument: a block's ghost rows are ordinary rows, and the wall rules of
// rows 0 and ny-1 run where the block ends, which is the pole on a
// polar-edge shard and a ghost row elsewhere. The seam strips of the
// halo-overlap schedule are the same launch again, on a strip-shaped block
// (3 freshly exchanged ghost rows and 6 rows of the shard). A column's
// arithmetic does not depend on which block computes it or in what order,
// so a block gives the same bits as the whole grid.
//
// Why 3 ghost rows and columns suffice. The update at (j, i) reads the
// column scans at (j, i), (j, i-1) and (j-1, i), and the inputs at most two
// columns west (colp of the face flux uflx(j, i-1)), two rows south (colp of
// vflx(j-1, i)), one column east and one row north; a column scan reads one
// column and one row around. The physics epilogue (physics_epilogue.cu)
// reads the post-dynamics fields one column and one row around. So the
// corrector's final field at (j, i) depends on its inputs within 3 columns
// west, 3 rows south, 2 columns east and 2 rows north, and the wrong edge
// rules of a block (the wrapped edge columns, the wall rows) reach no
// further in. With 3 ghost rows and columns on every side that has a
// neighbour (dist/sharding.py: HALO, HALO_N, GX, the reference's radii)
// every interior output is exact; with 2 the west and south edge of the
// interior is not (chip_smoke.py plants that fault).
//
// What bounds it on the card: not bytes. At config #3 (360x180x32 fp32,
// 8.3 MB per 3-D field) the predictor must move 11 3-D fields (u, v, pott,
// qv, qc and the radiative heating in, five fields out: 91 MB, >= 27.5 us
// at 3.35 TB/s) and the corrector 16 (the five base fields too: 133 MB,
// >= 40 us); it computes about 350 operations a point. The kernel keeps
// every intermediate on the chip, in one launch, and marches along
// latitude, so that each input line is copied once and each column scanned
// once, with the copies of later rows in flight while a row computes:
//   * A persistent grid (kernels/fused_substep.py::launch_plan): one block
//     of kThreads threads an SM, as many blocks as SMs, or as many as units
//     on a small block. The block's longitudes are cut into ceil(nx / tx)
//     strips of equal width (to within the 4, 2 or 1 columns a copy moves);
//     the (strip, row) units, strip after strip and south to north in one,
//     are dealt to the blocks in runs of equal weight, a unit weighing the
//     lanes its update passes span (run_start). A block walks its run row
//     by row; where it starts, or crosses into the next strip, it warms up:
//     it stages the rows it starts from and scans the row below its first.
//   * A ring of `depth` staged rows in shared memory (Ring; depth from the
//     plan, 5 or 6): a row's u, v, pott, qv and qc, a (field, level) line of
//     the strip's columns with one around, and its base COLP and surface
//     height; a ring of depth + 1 COLP lines (two columns west, one east);
//     the rows' geometry. Row j's update reads rows j-1 .. j+1 and row j+1's
//     scans rows j+1 and j+2, so depth - 4 rows are in flight. The copies
//     are cp.async along longitude, 16 bytes a lane where the rows allow it
//     (8 or 4 where the width or an address does not), the edge columns 4
//     bytes, and land on the slot's mbarrier (cp.async.mbarrier.arrive), so
//     the warp that issues them goes on with other work.
//   * A line keeps longitude fastest, at a pitch P of 4 mod 8 floats, the
//     strip's first column at offset 4, 16-byte aligned. The update reads
//     it with lanes along longitude, consecutive floats, with no bank
//     conflict. The scans' lanes along the levels of a column stride by P,
//     and fall in 8 banks: a 4-way conflict on their few staged reads, which
//     no pitch that keeps a 16-byte copy aligned avoids.
//   * A ring of scan results of three rows (wwind, phi, pvtf, COLP_new, base
//     COLP, dCOLP/dt; level fastest at an odd pitch EX, so the scans' lanes
//     along levels store and the update's along longitude read without a
//     conflict) and a two-row scratch (phi's layer part, the surface Exner
//     factor). Nothing is written to device memory but the outputs.
//   * The work is a stream of tasks that warps take from a counter in
//     shared memory (segment): the copies of a staged row (a task a field),
//     the terms of 4 columns of a row (1a: the surface Exner factor a lane a
//     column, then a lane a level, each taking the border below from the
//     next lane by a shuffle; the 4 columns' chains interleaved), the sums
//     of a row's columns (1b, 1c: a lane a column, both sums over k in the
//     plain version's serial order, then the sigma velocity per border) and
//     the passes of a row's update (a warp a pass of levels, lanes along
//     longitude, one thread a point, reading every neighbour from shared
//     memory and the base state and radiative heating from device memory,
//     coalesced, writing the five fields once). For row J the order is the
//     terms of row J+1, half of row J's update, the sums of row J+1, the
//     rest of the update, the copies of row J + depth - 2. A task first
//     waits for the tasks it reads from or whose slots it overwrites, by
//     counters of finished tasks (and the mbarriers of the copies); these
//     all come earlier in the order, so no task waits on a later one, no
//     barrier separates the rows, and row J+1's scans run beside row J's
//     update.
//   * Per run, each (field, level, row) line is copied once, plus the two
//     rows around the run (the plan's staged_rows_per_row), and each column
//     scanned once, plus one column west and the row below the run
//     (scanned_cols_per_col). A quotient whose divisor several quotients
//     of a point share (the cell area, dx^2, dy^2, dsigma, COLP_new, the
//     earth's radius) is div_rn of column.cuh: the correctly rounded
//     reciprocal once, then one FMA correction per quotient, which gives the
//     bits of the IEEE division in the normal range at a third of its cost.
// No sum changed association: both sums over k keep the plain version's
// serial order, and each point's arithmetic (level_terms, scan_sums,
// scan_wwind, point_update) is that of the tiled kernel this one replaced,
// whose outputs it equals bit for bit. What bounds it now is latency: the
// 16 warps an SM (the update's registers allow no more) are inside tasks
// nearly all the time, and a task's time is mostly its own dependent
// chain (PERF.md). The corrector's physics epilogue is a second launch
// (physics_epilogue.cu).

#include <cuda_runtime.h>

#include "column.cuh"
#include "constants.cuh"
#include "march.cuh"

// The block's dynamic shared memory (Ring's layout); every access indexes
// it directly, so each is a shared-memory load or store.
extern __shared__ __align__(16) float substep_smem[];
// dt, read once a block from the device operand (Args::scalars[0]); the
// arguments themselves stay in the kernel's parameter space
__shared__ float substep_dt;

namespace {

using namespace cm;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// A terms task: kTermCols columns of one row, a lane per level of a
// segment of kSeg levels, the columns' chains interleaved.
constexpr int kSeg = 32;
constexpr int kTermCols = 4;
constexpr int kChunk = 8;         // levels a serial sum reads at once
constexpr int kMinDepth = 5;      // the staged rows a row's tasks read, and one
constexpr int kMaxDepth = 6;

// GEO_FIELDS order (kernels/fused_substep.py)
enum Geo {
  kArea = 0, kAreaV, kDx, kDxs, kCorf, kCorfV, kTanLat, kTanLatV,
  kKdiffUV, kKdiffPott, kKdiffMoist, kNGeo
};

enum Field { kU = 0, kV, kPott, kQv, kQc, kNFields };

struct Args {
  const float *u, *v, *pott, *qv, *qc, *colp;        // evaluation state
  const float *ub, *vb, *pottb, *qvb, *qcb, *colpb;  // base state
  const float *hsurf, *rad, *geo, *sigma_vb, *dsigma;
  const float* vmask;                                // (ny,) or null
  float *u_out, *v_out, *pott_out, *qv_out, *qc_out, *colp_out;
  int nz, ny, nx, tx, depth, blocks;
  int vec;                                           // floats a copy moves
  const float* scalars;                              // (dt, frac) on the card
  float dy, dy2, ptop;
  int with_rad, with_diff;
  // an RK4 stage's accumulator of w dt k (null in a Matsuno substep)
  float *acc_u = nullptr, *acc_v = nullptr, *acc_pott = nullptr,
        *acc_qv = nullptr, *acc_qc = nullptr, *acc_colp = nullptr;
};

// RK4 stage m: the next stage state is y0 + c dt k_m, and w dt k_m is
// accumulated
__host__ __device__ constexpr float stage_c(int m) {
  return m == 3 ? 1.f : 0.5f;
}
__host__ __device__ constexpr float stage_w(int m) {
  return m == 1 || m == 4 ? 1.f / 6.f : 1.f / 3.f;
}

// Shared-memory layout, in floats; kernels/fused_substep.py::
// substep_smem_floats is the same formula. A staged line holds the strip's
// longitudes i0 - 2 .. i0 + ncol at offsets 2 .. ncol + 4 (the strip's
// first column at offset 4, 16-byte aligned); a scan level the scan
// columns i0 - 1 .. i0 + ncol - 1 at offsets 0 .. ncol.
struct Ring {
  int P, EX;      // pitch of a staged line and (odd) of a scan level
  int row;        // floats of a staged row: its fields', COLPb's, hsurf's lines
  int sslot;      // floats of a scan slot
  int xslot;      // floats of a scratch slot
  int wwind, phi, pvtf, cn, cb, dc;   // offsets in a scan slot
  int cx;                             // an RK4 stage's: the next COLP
  int phil, xs;                       // offsets in a scratch slot
  int fields, colp, geo, scan, scratch, sig, dsig, total;
  int depth;                          // staged rows in the ring
  unsigned md, md1;                   // ceil(2^32 / depth), ... / (depth + 1)

  __host__ __device__ Ring(int nz, int tx, int depth_, bool stage = false) {
    depth = depth_;
    md = 0xffffffffu / depth + 1;
    md1 = 0xffffffffu / (depth + 1) + 1;
    P = pitch(tx + 5);
    EX = (tx + 1) | 1;
    row = (kNFields * nz + 2) * P;      // and base COLP's and hsurf's lines
    wwind = 0;
    phi = wwind + (nz + 1) * EX;
    pvtf = phi + nz * EX;
    cn = pvtf + nz * EX;
    cb = cn + EX;
    dc = cb + EX;
    cx = dc + EX;
    sslot = cx + (stage ? EX : 0);
    phil = 0;
    xs = phil + nz * EX;
    xslot = xs + EX;
    fields = 0;
    colp = fields + depth * row;          // depth + 1 rows
    geo = colp + (depth + 1) * P;         // depth rows
    scan = geo + depth * kNGeo;           // 3 slots
    scratch = scan + 3 * sslot;           // 2 slots
    sig = scratch + 2 * xslot;
    dsig = sig + nz + 1;
    total = dsig + nz;
  }

  // row r's slot in the staged rows (r % depth) and in COLP's rows
  // (r % (depth + 1)), by a multiply: r < 2^16
  __device__ __forceinline__ int slot(int r) const {
    return r - depth * (int)__umulhi((unsigned)r, md);
  }
  __device__ __forceinline__ int cslot(int r) const {
    return r - (depth + 1) * (int)__umulhi((unsigned)r, md1);
  }
  // the offsets of row r's slots
  __device__ __forceinline__ int field_row(int r) const {
    return fields + slot(r) * row;
  }
  __device__ __forceinline__ int colp_row(int r) const {
    return colp + cslot(r) * P;
  }
  __device__ __forceinline__ int geo_row(int r) const {
    return geo + slot(r) * kNGeo;
  }
  __device__ __forceinline__ int scan_slot(int r) const {
    return scan + (r % 3) * sslot;
  }
  __device__ __forceinline__ int scratch_slot(int r) const {
    return scratch + (r & 1) * xslot;
  }
};

// Strips and runs: march.cuh (strip_start, pass_lanes, run_start), with
// tx, the strip width, from the plan.

// A strip: its first longitude and columns, how its lines are copied (nv
// copies of vec floats, then ns single floats, then the edge columns) and
// how its rows' work is cut into tasks.
struct Strip {
  int i0, ncol, nv, ns;
  int items, lpp;          // a line's copies; lines a warp copies at once
  int sums;                // sums tasks a row: ceil((ncol + 1) / 32)
  int txe, per_warp;       // lanes along longitude a pass, levels a pass
  int passes;              // update tasks a row
};

__device__ __forceinline__ Strip make_strip(const Args& a, int s) {
  const int strips = (a.nx + a.tx - 1) / a.tx;
  Strip st;
  st.i0 = strip_start(a.nx, strips, s);
  st.ncol = strip_start(a.nx, strips, s + 1) - st.i0;
  st.nv = st.ncol / a.vec;
  st.ns = st.ncol - st.nv * a.vec;
  st.items = st.nv + st.ns + 2;
  st.lpp = max(1, 32 / st.items);
  st.sums = (st.ncol + 32) / 32;
  st.txe = pass_lanes(st.ncol);
  st.per_warp = 32 / st.txe;
  st.passes = (a.nz + st.per_warp - 1) / st.per_warp;
  return st;
}

// ---------------------------------------------------------------------------
// Copies: cp.async from device to shared memory; a row's land on an
// mbarrier (the warm-up's COLP row is waited for by its thread).
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(int off) {
  return static_cast<unsigned>(__cvta_generic_to_shared(substep_smem + off));
}

__device__ __forceinline__ void copy(int dst, const float* src, int bytes) {
  cp_async(smem_addr(dst), src, bytes);
}

// wait for every copy this thread has issued
__device__ __forceinline__ void land_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lane `it` of a line's copies: the strip's column offset x of its first
// float (nv copies of vec floats, then ns single floats, then nw columns
// west and one east) and its width in bytes.
__device__ __forceinline__ void line_item(const Strip& st, int vec, int nw,
                                          int it, int& x, int& bytes) {
  bytes = it < st.nv ? 4 * vec : 4;
  it -= st.nv;
  x = it < 0 ? (it + st.nv) * vec
    : it < st.ns ? st.nv * vec + it
    : it < st.ns + nw ? it - st.ns - nw
    : st.ncol;
}

// What the update of row r reads from device memory beside the ring (the
// radiative heating, the corrector's base state, and an RK4 stage's t_n
// state and accumulator), fetched into L2 with the copies of row
// r + depth - 4: a lane a (field, level) line, both ends of its longitudes.
template <int STAGE>
__device__ __forceinline__ void prefetch_update_rows(const Args& a,
                                                     const Strip& st, int r) {
  const bool base = STAGE == 0 ? a.ub != a.u : STAGE > 1;
  const int nb = base ? kNFields : 0, na = STAGE > 1 ? kNFields : 0;
  const int nf = nb + na + (a.with_rad ? 1 : 0);
  if (r < 0 || r >= a.ny || nf == 0) return;
  for (int q = lane_id(); q < nf * a.nz; q += 32) {
    const int f = q / a.nz, k = q - f * a.nz;
    const int g = f < nb ? f : f - nb;
    const float* fld = f >= nb + na ? a.rad
                     : f < nb ? (g == kU ? a.ub : g == kV ? a.vb
                                 : g == kPott ? a.pottb : g == kQv ? a.qvb
                                 : a.qcb)
                     : g == kU ? a.acc_u : g == kV ? a.acc_v
                     : g == kPott ? a.acc_pott : g == kQv ? a.acc_qv
                     : a.acc_qc;
    const float* row = fld + ((size_t)k * a.ny + r) * a.nx + st.i0;
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row));
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + st.ncol - 1));
  }
}

// One warp's copies of row r's field f (0 <= r < ny): lpp lines at a time,
// a lane a copy (a line of more than 32 copies in turns of 32); f = -1 is
// COLP's line (two columns west) and the row's geometry, f = -2 COLP's
// line alone.
template <int STAGE>
__device__ void copy_lines(const Args& a, const Ring& t, const Strip& st,
                           int r, int f) {
  const int nz = a.nz, ny = a.ny, nx = a.nx, lane = lane_id();
  if (f < 0) {
    for (int it = lane; it < st.items + 1; it += 32) {
      int x, bytes;
      line_item(st, a.vec, 2, it, x, bytes);
      const int col = bytes > 4 ? st.i0 + x : wrap(st.i0 + x, nx);
      copy(t.colp_row(r) + 4 + x, a.colp + (size_t)r * nx + col,
           bytes);
    }
    if (f == -2) return;
    // the base COLP and the surface height of the row, as a field's line
    for (int q = lane; q < 2 * st.items; q += 32) {
      const int sub = q / st.items;
      int x, bytes;
      line_item(st, a.vec, 1, q - sub * st.items, x, bytes);
      const int col = bytes > 4 ? st.i0 + x : wrap(st.i0 + x, nx);
      copy(t.field_row(r) + (kNFields * nz + sub) * t.P + 4 + x,
           (sub ? a.hsurf : a.colpb) + (size_t)r * nx + col, bytes);
    }
    const int g = lane - (32 - kNGeo);
    if (g >= 0) copy(t.geo_row(r) + g, a.geo + r * kNGeo + g, 4);
    prefetch_update_rows<STAGE>(a, st, r - (a.depth - 4));
    return;
  }
  const int sub = lane / st.items;
  if (sub >= st.lpp) return;
  const float* row = (f == kU ? a.u : f == kV ? a.v : f == kPott ? a.pott
                      : f == kQv ? a.qv : a.qc) + (size_t)r * nx;
  const int line = t.field_row(r) + f * nz * t.P + 4;
  for (int it = lane - sub * st.items; it < st.items; it += 32) {
    int x, bytes;
    line_item(st, a.vec, 1, it, x, bytes);
    const float* src = row + (bytes > 4 ? st.i0 + x : wrap(st.i0 + x, nx));
    for (int k = sub; k < nz; k += st.lpp)
      copy(line + k * t.P + x, src + (size_t)k * ny * nx, bytes);
  }
}

// ---------------------------------------------------------------------------
// Column scans of one row. The work at each level (the flux divergence, the
// Exner factors with their powf, the divisions) runs a lane a level, 4
// columns a warp interleaved; the two sums over k run one lane per column,
// in the plain version's serial order.
// ---------------------------------------------------------------------------
struct ScanRow {                // shared-memory offsets of what it reads
  int j;                        // grid row
  bool own;                     // a row of the run: COLP_new is written
  int f0, f1;                   // staged rows j and j+1
  int cs, c0, c1;               // COLP rows j-1 (clamped), j and j+1
  int g0, g1;                   // geometry rows j and j+1
  int s, x;                     // scan slot and scratch slot of row j
};

// 1a. per level k of scan column ec: the divergence term (for
// wwind[k + 1]), the layer Exner factor (pvtf[k]), the geopotential jump
// across the layer (for phi[k]) and the layer's own part of its
// geopotential (phil[k]). The lane of level k raises its upper border to
// kappa and takes the lower border's from the next lane (or, below the
// last level, from xs).
struct LevelTerms {
  float div, pvtf, jump, own;
};

__device__ __forceinline__ LevelTerms level_terms(const Args& a,
                                                  const Ring& t,
                                                  const ScanRow& r, int ec,
                                                  int k, int kl) {
  const float* sm = substep_smem;
  const int nz = a.nz, ny = a.ny, j = r.j;
  const bool valid = k < nz;
  const int kk = valid ? k : nz - 1;
  const int xc = ec + 3;                         // the column's line offset
  const float* cp = sm + r.c0 + xc;
  const float ce = cp[0];
  const bool has_n = j + 1 < ny;
  const float colp_u = 0.5f * (cp[-1] + ce);
  const float colp_u_e = 0.5f * (ce + cp[1]);
  const float colp_v = 0.5f * (sm[r.cs + xc] + ce);
  const float colp_v_n = has_n ? 0.5f * (ce + sm[r.c1 + xc]) : 0.f;
  const float* g = sm + r.g0;
  const float dxs_n = has_n ? sm[r.g1 + kDxs] : 0.f;
  const int fs = nz * t.P, lk = kk * t.P + xc;
  const float uflx = sm[r.f0 + kU * fs + lk] * colp_u * a.dy;
  const float uflx_e = sm[r.f0 + kU * fs + lk + 1] * colp_u_e * a.dy;
  const float vflx = j == 0 ? 0.f
                            : sm[r.f0 + kV * fs + lk] * colp_v * g[kDxs];
  const float vflx_n = has_n ? sm[r.f1 + kV * fs + lk] * colp_v_n * dxs_n
                             : 0.f;
  LevelTerms o;
  o.div = (uflx_e - uflx + vflx_n - vflx) / g[kArea];
  // Exner factors of the layer's borders and the layer
  const float pb_lo = a.ptop + sm[t.sig + kk] * ce;
  const float pb_hi = a.ptop + sm[t.sig + kk + 1] * ce;
  const float pt_lo = powf(div_rn(pb_lo, kPRef, kRecipPRef), kKappa);
  const float below = __shfl_down_sync(kFull, pt_lo, 1);
  const float pt_hi = kk == nz - 1 ? sm[r.x + t.xs + ec]
                    : kl < kSeg - 1 ? below
                    : powf(div_rn(pb_hi, kPRef, kRecipPRef), kKappa);
  o.pvtf = (pb_hi * pt_hi - pb_lo * pt_lo) / (kOnePlusKappa * (pb_hi - pb_lo));
  const float cppt = kCp * sm[r.f0 + kPott * fs + lk];
  o.jump = cppt * (pt_hi - pt_lo);
  o.own = cppt * (pt_hi - o.pvtf);
  return o;
}

__device__ __forceinline__ void store_terms(const Ring& t, const ScanRow& r,
                                            int ec, int k,
                                            const LevelTerms& o) {
  float* sm = substep_smem;
  sm[r.s + t.wwind + (k + 1) * t.EX + ec] = o.div * sm[t.dsig + k];
  sm[r.s + t.pvtf + k * t.EX + ec] = o.pvtf;
  sm[r.s + t.phi + k * t.EX + ec] = o.jump;
  sm[r.x + t.phil + k * t.EX + ec] = o.own;
}

// 1b. the sums of one column: the divergence's prefix sum (in place in
// wwind[1..nz-1]) with dCOLP/dt and COLP_new, and the geopotential's suffix
// sum from the surface up (phi, replacing the jumps). Each loop reads
// kChunk levels' values before it adds and stores them, so the reads do not
// wait on the adds; the column's base COLP and surface height come read
// already. In an RK4 stage the base is the t_n state, and the tendencies'
// COLP_new is the evaluation state's COLP + dt dCOLP/dt; the next state's
// COLP (cx) and the accumulator's are written beside them.
template <int STAGE>
__device__ void scan_sums(const Args& a, const Ring& t, const ScanRow& r,
                          int ec, int i, float cb, float hsurf) {
  float* sm = substep_smem;
  const int nz = a.nz, nx = a.nx, j = r.j, ex = t.EX;
  const float ghs = kG * hsurf;
  float* w = sm + r.s + t.wwind + ec;
  float csum = 0.f;
  for (int k0 = 0; k0 < nz; k0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      v[q] = k0 + q < nz ? w[(k0 + q + 1) * ex] : 0.f;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int k = k0 + q;
      if (k < nz) {
        csum += v[q];
        if (k < nz - 1) w[(k + 1) * ex] = csum;
      }
    }
  }
  const float dcolpdt = -csum;
  const float dt = substep_dt;
  if constexpr (STAGE == 0) {
    const float cn = cb + dt * dcolpdt;
    sm[r.s + t.cn + ec] = cn;
    sm[r.s + t.cb + ec] = cb;
    sm[r.s + t.dc + ec] = dcolpdt;
    if (r.own && ec >= 1) a.colp_out[j * nx + i] = cn;
  } else {
    const int id = j * nx + i;
    const float wdt = stage_w(STAGE) * dt;
    const float cx = STAGE == 4
        ? cb + (a.acc_colp[id] + wdt * dcolpdt)
        : cb + stage_c(STAGE) * dt * dcolpdt;
    sm[r.s + t.cn + ec] = sm[r.c0 + ec + 3] + dt * dcolpdt;
    sm[r.s + t.cb + ec] = cb;
    sm[r.s + t.dc + ec] = dcolpdt;
    sm[r.s + t.cx + ec] = cx;
    if (r.own && ec >= 1) {
      a.colp_out[id] = cx;
      if constexpr (STAGE == 1) a.acc_colp[id] = wdt * dcolpdt;
      else if constexpr (STAGE < 4)
        a.acc_colp[id] = a.acc_colp[id] + wdt * dcolpdt;
    }
  }

  const float* own = sm + r.x + t.phil + ec;
  float* phi = sm + r.s + t.phi + ec;
  float suffix = 0.f;
  for (int k1 = nz - 1; k1 >= 0; k1 -= kChunk) {
    float jump[kChunk], part[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      jump[q] = k1 - q >= 0 ? phi[(k1 - q) * ex] : 0.f;
      part[q] = k1 - q >= 0 ? own[(k1 - q) * ex] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (k1 - q >= 0) {
        phi[(k1 - q) * ex] = (ghs + suffix) + part[q];
        suffix += jump[q];
      }
    }
  }
}

// 1c. per border: the sigma velocity; zero at top and bottom
__device__ __forceinline__ void scan_wwind(const Args& a, const Ring& t,
                                           const ScanRow& r, int ec) {
  float* sm = substep_smem;
  const int nz = a.nz;
  float* w = sm + r.s + t.wwind + ec;
  const float dc = sm[r.s + t.dc + ec], cn = sm[r.s + t.cn + ec];
#pragma unroll 4
  for (int kb = 0; kb < nz; ++kb)
    w[kb * t.EX] = kb == 0 ? 0.f : -(w[kb * t.EX] + sm[t.sig + kb] * dc) / cn;
  w[nz * t.EX] = 0.f;
}

// The terms of scan columns ec0 .. ec0 + kTermCols - 1 of row r (ec = 0 is
// longitude i0 - 1; columns past ncol are skipped): the surface Exner
// factors a lane a column, then the levels a segment of 32 at a time, a
// lane a level (1a).
__device__ void terms_task(const Args& a, const Ring& t, const ScanRow& r,
                           const Strip& st, int ec0) {
  // the terms of a column
  const int nz = a.nz, lane = lane_id();
  if (lane < kTermCols && ec0 + lane <= st.ncol)
    substep_smem[r.x + t.xs + ec0 + lane] = surface_exner(
        substep_smem + t.sig, a.ptop, substep_smem[r.c0 + ec0 + lane + 3], nz);
  __syncwarp();
  for (int m = 0; m < (nz + kSeg - 1) / kSeg; ++m) {
    const int k = m * kSeg + lane;
    LevelTerms o[kTermCols];
#pragma unroll
    for (int cc = 0; cc < kTermCols; ++cc)
      o[cc] = level_terms(a, t, r, min(ec0 + cc, st.ncol), k, lane);
#pragma unroll
    for (int cc = 0; cc < kTermCols; ++cc)
      if (k < nz && ec0 + cc <= st.ncol) store_terms(t, r, ec0 + cc, k, o[cc]);
  }
}

// The sums and sigma velocities (1b, 1c) of scan columns ec = part,
// part + parts, ... of row r, a lane a column.
template <int STAGE>
__device__ void sums_task(const Args& a, const Ring& t, const ScanRow& r,
                          const Strip& st, int part, int parts) {
  // the sums of the columns
  const int ec = part + parts * lane_id();
  if (ec > st.ncol) return;
  const int i = wrap(st.i0 - 1 + ec, a.nx);
  const float* b = substep_smem + r.f0 + kNFields * a.nz * t.P + 3 + ec;
  scan_sums<STAGE>(a, t, r, ec, i, b[0], b[t.P]);
  scan_wwind(a, t, r, ec);
}

// ---------------------------------------------------------------------------
// Tendencies and update at one point (j, i0 + x, k) of row j.
// ---------------------------------------------------------------------------
struct UpdRow {                  // shared-memory offsets of what it reads
  int j;
  int fs, f0, fn;               // staged rows j-1 (clamped), j, j+1
  int css, cs, c0, cn;          // COLP rows j-2, j-1 (clamped), j, j+1
  int gs, g0, gn;               // geometry rows j-1 (clamped), j, j+1
  int ss, s0;                   // scan slots of rows j-1 (clamped), j
};

// An RK4 stage's increment of a conserved variable from the t_n state, for
// its tendency k at (stage) point id: c dt k, or at the last stage the
// accumulator; w dt k is added to the accumulator (stages 1-3).
template <int STAGE>
__device__ __forceinline__ float stage_increment(float* acc, int id, float k,
                                                 float dt) {
  const float wdt = stage_w(STAGE) * dt;
  if constexpr (STAGE == 4) return acc[id] + wdt * k;
  __stcg(acc + id, STAGE == 1 ? wdt * k : acc[id] + wdt * k);
  return stage_c(STAGE) * dt * k;
}

template <bool SAME_BASE, int STAGE>
__device__ void point_update(const Args& a, const Ring& t, const UpdRow& r,
                             int i0, int x, int k) {
  const float* sm = substep_smem;
  const float dt = substep_dt;
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  const int j = r.j;
  const int i = i0 + x;
  const bool has_n = j + 1 < ny;
  const int js = j > 0 ? j - 1 : 0;
  const int jn = has_n ? j + 1 : j;                 // north clamp
  const float* g = sm + r.g0;
  const float area = g[kArea], area_v = g[kAreaV], dx = g[kDx];
  const float dx2 = dx * dx;
  const int id = (k * ny + j) * nx + i;
  // the reciprocals of the divisors that several quotients share (div_rn)
  const float r_area = rcp(area), r_dx2 = rcp(dx2), r_dy2 = rcp(a.dy2);
  const float r_earth = rcp(kREarth);

  // staged fields at (kk, jj, i + di) for jj in {js, j, j + 1}: a row's
  // slot in the ring, then offsets from this point's column
  const int fs = nz * t.P, xl = x + 4;
  auto frow = [&](int jj) {
    return jj == j ? r.f0 : jj == j + 1 ? r.fn : r.fs;
  };
  auto fld = [&](int f, int kk, int jj, int di) {
    return sm[frow(jj) + f * fs + kk * t.P + xl + di];
  };
  // COLP of the evaluation state at (jj, i + di)
  auto crow = [&](int jj) {
    return jj == j ? r.c0 : jj == j + 1 ? r.cn : jj == js ? r.cs : r.css;
  };
  auto colp = [&](int jj, int di) { return sm[crow(jj) + xl + di]; };
  // the geometry of row jj
  auto grow = [&](int jj) {
    return jj == j ? r.g0 : jj == j + 1 ? r.gn : r.gs;
  };
  // the scans at (jj, i + di), jj in {js, j}, di in {-1, 0}
  const int e = x + 1;
  auto srow = [&](int jj) { return jj == j ? r.s0 : r.ss; };
  auto cnp = [&](int jj, int di) { return sm[srow(jj) + t.cn + e + di]; };
  auto colpb = [&](int jj, int di) { return sm[srow(jj) + t.cb + e + di]; };
  auto cxp = [&](int jj, int di) { return sm[srow(jj) + t.cx + e + di]; };
  auto wwind = [&](int kb, int jj, int di) {
    return sm[srow(jj) + t.wwind + kb * t.EX + e + di];
  };
  auto phi = [&](int jj, int di) {
    return sm[srow(jj) + t.phi + k * t.EX + e + di];
  };
  auto pvtf = [&](int jj, int di) {
    return sm[srow(jj) + t.pvtf + k * t.EX + e + di];
  };

  // face-averaged COLP
  const float ce = colp(j, 0);
  auto colp_u_at = [&](int jj, int di) {
    return 0.5f * (colp(jj, di - 1) + colp(jj, di));
  };
  auto colp_v_at = [&](int jj, int di) {
    const int jjs = jj > 0 ? jj - 1 : 0;
    return 0.5f * (colp(jjs, di) + colp(jj, di));
  };
  // mass fluxes at u faces and (wall-zeroed) v faces of level k
  auto uflx = [&](int jj, int di) {
    return fld(kU, k, jj, di) * colp_u_at(jj, di) * a.dy;
  };
  auto vflx = [&](int jj, int di) {
    if (jj == 0 || jj >= ny) return 0.f;
    return fld(kV, k, jj, di) * colp_v_at(jj, di) * sm[grow(jj) + kDxs];
  };
  const float colp_u = colp_u_at(j, 0);
  const float colp_v = colp_v_at(j, 0);
  const float uf = uflx(j, 0), uf_e = uflx(j, 1), uf_w = uflx(j, -1);
  const float vf = vflx(j, 0), vf_n = vflx(j + 1, 0);

  const float cn = cnp(j, 0);
  const float cb = colpb(j, 0);
  const float dsig = sm[t.dsig + k];
  const float r_dsig = rcp(dsig), r_cn = rcp(cn);

  // ---- scalars: pott (radiative source), qv, qc ----
  const float* qbs[3] = {a.pottb, a.qvb, a.qcb};
  float* qouts[3] = {a.pott_out, a.qv_out, a.qc_out};
  float* qaccs[3] = {a.acc_pott, a.acc_qv, a.acc_qc};
  const float w_top = wwind(k, j, 0), w_bot = wwind(k + 1, j, 0);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int f = kPott + s;
    const float qc_ = fld(f, k, j, 0);
    const float qw = fld(f, k, j, -1), qe = fld(f, k, j, 1);
    const float qsn = fld(f, k, js, 0);
    const float qn = has_n ? fld(f, k, j + 1, 0) : 0.f;
    const float fx = uf * 0.5f * (qw + qc_);
    const float fx_e = uf_e * 0.5f * (qc_ + qe);
    const float fy = vf * 0.5f * (qsn + qc_);
    const float fy_n = has_n ? vf_n * 0.5f * (qc_ + qn) : 0.f;
    float dqdt = div_rn(-(fx_e - fx + fy_n - fy), area, r_area);
    const float fz_top = k > 0 ? w_top * cn * (0.5f * (fld(f, k - 1, j, 0) + qc_)) : 0.f;
    const float fz_bot = k < nz - 1 ? w_bot * cn * (0.5f * (qc_ + fld(f, k + 1, j, 0))) : 0.f;
    dqdt = dqdt - div_rn(fz_bot - fz_top, dsig, r_dsig);
    if (s == 0 && a.with_rad) dqdt = dqdt + ce * a.rad[id];
    if (a.with_diff) {
      const float coef = s == 0 ? g[kKdiffPott] : g[kKdiffMoist];
      const float qnc = has_n ? qn : qc_;
      const float lap = div_rn(qe - 2.f * qc_ + qw, dx2, r_dx2)
                        + div_rn(qnc - 2.f * qc_ + qsn, a.dy2, r_dy2);
      dqdt = dqdt + coef * ce * lap;
    }
    const float qb = SAME_BASE ? qc_ : qbs[s][id];
    float qnew;
    if constexpr (STAGE == 0) {
      qnew = div_rn(qb * cb + dt * dqdt, cn, r_cn);
    } else {
      const float cx = cxp(j, 0);
      qnew = div_rn(qb * cb + stage_increment<STAGE>(qaccs[s], id, dqdt, dt),
                    cx, rcp(cx));
    }
    if (s > 0) qnew = qnew < 0.f ? 0.f : qnew;     // NaN passes through
    __stcg(qouts[s] + id, qnew);
  }

  // ---- u momentum at the west face of (j, i) ----
  {
    const float uc = fld(kU, k, j, 0), ue = fld(kU, k, j, 1);
    const float uw = fld(kU, k, j, -1);
    const float us = fld(kU, k, js, 0);
    const float fxc = 0.5f * (uf + uf_e) * 0.5f * (uc + ue);
    const float fxc_w = 0.5f * (uf_w + uf) * 0.5f * (uw + uc);
    const float fyc = 0.5f * (vflx(j, -1) + vf) * 0.5f * (us + uc);
    const float fyc_n = has_n
        ? 0.5f * (vflx(j + 1, -1) + vf_n) * 0.5f * (uc + fld(kU, k, j + 1, 0))
        : 0.f;
    const float adv = div_rn(-(fxc - fxc_w + fyc_n - fyc), area, r_area);

    const float cn_u = 0.5f * (cnp(j, -1) + cn);
    float fz_top = 0.f, fz_bot = 0.f;
    if (k > 0) {
      const float w_u = 0.5f * (wwind(k, j, -1) + wwind(k, j, 0));
      fz_top = w_u * cn_u * (0.5f * (fld(kU, k - 1, j, 0) + uc));
    }
    if (k < nz - 1) {
      const float w_u = 0.5f * (wwind(k + 1, j, -1) + wwind(k + 1, j, 0));
      fz_bot = w_u * cn_u * (0.5f * (uc + fld(kU, k + 1, j, 0)));
    }
    const float vadv = div_rn(-(fz_bot - fz_top), dsig, r_dsig);

    const float vn = has_n ? fld(kV, k, j + 1, 0) : 0.f;
    const float vn_w = has_n ? fld(kV, k, j + 1, -1) : 0.f;
    const float v_at_u = 0.25f * (fld(kV, k, j, -1) + fld(kV, k, j, 0) + vn_w + vn);
    const float cor = colp_u
        * (g[kCorf] + div_rn(uc * g[kTanLat], kREarth, r_earth)) * v_at_u;

    const float pott_u = 0.5f * (fld(kPott, k, j, -1) + fld(kPott, k, j, 0));
    const float pgf = -colp_u * ((phi(j, 0) - phi(j, -1))
                                 + kCp * pott_u * (pvtf(j, 0) - pvtf(j, -1))) / dx;

    float dudt = adv + vadv + cor + pgf;
    if (a.with_diff) {
      const float un = fld(kU, k, jn, 0);
      const float lap = div_rn(ue - 2.f * uc + uw, dx2, r_dx2)
                        + div_rn(un - 2.f * uc + us, a.dy2, r_dy2);
      dudt = dudt + g[kKdiffUV] * colp_u * lap;
    }
    const float ub = SAME_BASE ? uc : a.ub[id];
    const float cu_old = 0.5f * (colpb(j, -1) + cb);
    if constexpr (STAGE == 0) {
      __stcg(a.u_out + id, (ub * cu_old + dt * dudt) / cn_u);
    } else {
      const float cx_u = 0.5f * (cxp(j, -1) + cxp(j, 0));
      __stcg(a.u_out + id,
             (ub * cu_old + stage_increment<STAGE>(a.acc_u, id, dudt, dt))
             / cx_u);
    }
  }

  // ---- v momentum at the south face of (j, i) ----
  {
    if (j == 0 && !a.vmask) {                       // south wall, by index
      __stcg(a.v_out + id, 0.f);
      if constexpr (STAGE >= 1 && STAGE <= 3) __stcg(a.acc_v + id, 0.f);
      return;
    }
    const float vc = fld(kV, k, j, 0), ve = fld(kV, k, j, 1);
    const float vw = fld(kV, k, j, -1);
    const float vs = fld(kV, k, js, 0);
    const float vn = has_n ? fld(kV, k, j + 1, 0) : 0.f;
    const float fyc = 0.5f * (vf + vf_n) * 0.5f * (vc + vn);
    const float fyc_s = 0.5f * (vflx(js, 0) + vf) * 0.5f * (vs + vc);
    const float uf_s = uflx(js, 0), uf_se = uflx(js, 1);
    const float fxc = 0.5f * (uf_s + uf) * 0.5f * (vw + vc);
    const float fxc_e = 0.5f * (uf_se + uf_e) * 0.5f * (vc + ve);
    const float adv = -(fxc_e - fxc + fyc - fyc_s) / area_v;

    const float cn_v = 0.5f * (cnp(js, 0) + cn);
    float fz_top = 0.f, fz_bot = 0.f;
    if (k > 0) {
      const float w_v = 0.5f * (wwind(k, js, 0) + wwind(k, j, 0));
      fz_top = w_v * cn_v * (0.5f * (fld(kV, k - 1, j, 0) + vc));
    }
    if (k < nz - 1) {
      const float w_v = 0.5f * (wwind(k + 1, js, 0) + wwind(k + 1, j, 0));
      fz_bot = w_v * cn_v * (0.5f * (vc + fld(kV, k + 1, j, 0)));
    }
    const float vadv = div_rn(-(fz_bot - fz_top), dsig, r_dsig);

    const float u_at_v = 0.25f * (fld(kU, k, js, 0) + fld(kU, k, js, 1)
                                  + fld(kU, k, j, 0) + fld(kU, k, j, 1));
    const float cor = -colp_v
        * (g[kCorfV] + div_rn(u_at_v * g[kTanLatV], kREarth, r_earth)) * u_at_v;

    const float pott_v = 0.5f * (fld(kPott, k, js, 0) + fld(kPott, k, j, 0));
    const float pgf = -colp_v * ((phi(j, 0) - phi(js, 0))
                                 + kCp * pott_v * (pvtf(j, 0) - pvtf(js, 0))) / a.dy;

    float dvdt = adv + vadv + cor + pgf;
    if (a.with_diff) {
      const float lap = div_rn(ve - 2.f * vc + vw, dx2, r_dx2)
                        + div_rn(vn - 2.f * vc + vs, a.dy2, r_dy2);
      dvdt = dvdt + g[kKdiffUV] * colp_v * lap;
    }
    const float vb = SAME_BASE ? vc : a.vb[id];
    const float cv_old = 0.5f * (colpb(js, 0) + cb);
    float vnew;
    if constexpr (STAGE == 0) {
      vnew = (vb * cv_old + dt * dvdt) / cn_v;
    } else {
      // the wall holds the tendency at 0 too (enforce_v_walls(dvdt))
      if (a.vmask) dvdt = dvdt * a.vmask[j] + 0.f;
      const float cx_v = 0.5f * (cxp(js, 0) + cxp(j, 0));
      vnew = (vb * cv_old + stage_increment<STAGE>(a.acc_v, id, dvdt, dt))
             / cx_v;
    }
    // the wall as data: 0 on wall rows. "+ 0" turns the -0 of a negative v
    // times 0 into +0, so the single-device mask equals the index rule bit
    // for bit
    __stcg(a.v_out + id, a.vmask ? vnew * a.vmask[j] + 0.f : vnew);
  }
}

// ---------------------------------------------------------------------------
// A block's run: segments of rows of one strip, each warmed up, then walked
// row by row.
// ---------------------------------------------------------------------------

__device__ __forceinline__ ScanRow scan_row(const Ring& t, int ny, int j,
                                            bool own) {
  ScanRow r;
  r.j = j;
  r.own = own;
  const bool has_n = j + 1 < ny;
  r.f0 = t.field_row(j);
  r.f1 = has_n ? t.field_row(j + 1) : r.f0;
  r.c0 = t.colp_row(j);
  r.cs = j > 0 ? t.colp_row(j - 1) : r.c0;
  r.c1 = has_n ? t.colp_row(j + 1) : r.c0;
  r.g0 = t.geo_row(j);
  r.g1 = has_n ? t.geo_row(j + 1) : r.g0;
  r.s = t.scan_slot(j);
  r.x = t.scratch_slot(j);
  return r;
}

__device__ __forceinline__ UpdRow upd_row(const Ring& t, int ny, int j) {
  UpdRow r;
  r.j = j;
  const int js = j > 0 ? j - 1 : 0, jss = js > 0 ? js - 1 : 0;
  const int jn = j + 1 < ny ? j + 1 : j;
  r.fs = t.field_row(js);
  r.f0 = t.field_row(j);
  r.fn = t.field_row(jn);
  r.css = t.colp_row(jss);
  r.cs = t.colp_row(js);
  r.c0 = t.colp_row(j);
  r.cn = t.colp_row(jn);
  r.gs = t.geo_row(js);
  r.g0 = t.geo_row(j);
  r.gn = t.geo_row(jn);
  r.ss = t.scan_slot(js);
  r.s0 = t.scan_slot(j);
  return r;
}

// One pass of the update of row j: levels k = p * per_warp + lane / txe,
// lanes along longitude.
template <bool SAME_BASE, int STAGE>
__device__ __forceinline__ void update_task(const Args& a, const Ring& t,
                                            const UpdRow& r, const Strip& st,
                                            int p) {
  // the update of a pass of levels
  const int nz = a.nz, lane = lane_id();
  const int x = lane % st.txe, k = p * st.per_warp + lane / st.txe;
  if (x < st.ncol && k < nz)
    point_update<SAME_BASE, STAGE>(a, t, r, st.i0, x, k);
}

// ---------------------------------------------------------------------------
// A segment's tasks, in the order warps take them from the block's counter:
// COLP of row jA-2 and rows jA-1 .. jA+1, the scans of the row below the
// segment and of its first row, the rest of the warm-up's copies (up to
// row jA + depth - 3); then for each row J the terms of row J+1, the first
// half of the update of row J, the sums of row J+1 (by then its terms are
// done), the rest of the update of row J and the copies of row
// J + depth - 2. A task waits, before it starts, for the tasks it reads
// from or whose slots it overwrites, all earlier in the order, by counters
// of finished tasks in shared memory: no task waits on a later one, and no
// barrier separates the rows.
// ---------------------------------------------------------------------------
struct Counters {
  // by staged slot: an mbarrier that the copies of the slot's row arrive
  // on as they land (each lane of each of its copy tasks once)
  unsigned long long landed[kMaxDepth];
  int ticket;                   // tasks taken
  int pre;                      // COLP of row jA-2 copied
  int terms[3];                 // terms tasks finished, by scan slot
  int sums[3];                  // sums tasks finished, by scan slot
  int updates[4];               // update passes finished, by row mod 4
};

// Counters of finished tasks: wait_for and finished (march.cuh).

// The tasks of segment jA .. jB-1 and how many of each a row has; kept in
// shared memory, so that no warp holds it in registers.
struct Plan {
  int jA, jB, last;             // rows; the last row staged
  int r_lo, r_mid, r_hi;        // rows staged by the warm-up; its scans read
                                // up to r_mid
  int j_first;                  // the first row scanned
  int cols, sums, passes;       // terms, sums and update tasks a row
  int depth;
  int npre, ncopy0, nrows0, nfirst;  // the warm-up's tasks
};

__device__ __forceinline__ int row_tasks(const Plan& p, int j) {
  return (j + 1 < p.jB ? p.cols + p.sums : 0) + p.passes
         + (j + p.depth - 2 <= p.last ? kNFields + 1 : 0);
}

// the update passes of row jj in this segment are finished
__device__ __forceinline__ void wait_updates(const Plan& p, Counters& c,
                                             int jj) {
  if (jj >= p.jA)
    wait_for(&c.updates[jj & 3], p.passes * ((jj - p.jA) / 4 + 1));
}

// Copy task f of staged row r, once the rows its slots held are read:
// every update of rows r-depth-1 .. r-depth+1 in this segment finished. The
// warp does not wait for its copies: each lane's arrival on the slot's
// mbarrier comes when they land.
template <int STAGE>
__device__ __forceinline__ void copy_task(const Args& a, const Ring& t,
                                          const Strip& st, const Plan& p,
                                          Counters& c, int r, int f) {
  for (int jj = r - p.depth - 1; jj <= r - p.depth + 1; ++jj)
    wait_updates(p, c, jj);
  copy_lines<STAGE>(a, t, st, r, f);
  arrive_on_copies(&c.landed[t.slot(r)]);
}

// The copies of staged row r (its fields, COLP and geometry) have landed:
// the slot's mbarrier has completed the phase of the slot's
// ((r - r_lo) / depth)-th row of the segment.
__device__ __forceinline__ void wait_row(const Ring& t, const Plan& p,
                                         Counters& c, int r) {
  if (r < p.r_lo || r > p.last) return;
  barrier_wait(&c.landed[t.slot(r)], ((r - p.r_lo) / p.depth) & 1);
}

// The terms, or the sums, of row R are finished.
__device__ __forceinline__ void wait_terms(const Plan& p, Counters& c,
                                           int R) {
  if (R >= p.j_first)
    wait_for(&c.terms[R % 3], p.cols * ((R - p.j_first) / 3 + 1));
}

__device__ __forceinline__ void wait_sums(const Plan& p, Counters& c,
                                          int R) {
  if (R >= p.j_first)
    wait_for(&c.sums[R % 3], p.sums * ((R - p.j_first) / 3 + 1));
}

// Terms task ec of row R (columns kTermCols * ec ..): once its rows are
// staged, the scan slot's last row (R-3) is read by the updates of rows R-3
// and R-2, and the scratch slot's (R-2) by its sums.
__device__ __forceinline__ void terms_row_task(const Args& a, const Ring& t,
                                               const Strip& st, const Plan& p,
                                               Counters& c, int R, int ec) {
  if (R == p.jA - 1 && R >= 1) wait_for(&c.pre, 1);
  wait_row(t, p, c, R);
  wait_row(t, p, c, R + 1);
  wait_updates(p, c, R - 3);
  wait_updates(p, c, R - 2);
  wait_sums(p, c, R - 2);
  terms_task(a, t, scan_row(t, a.ny, R, R >= p.jA), st, ec * kTermCols);
  finished(&c.terms[R % 3]);
}

// Sums task `part` of row R, once its terms are finished.
template <int STAGE>
__device__ __forceinline__ void sums_row_task(const Args& a, const Ring& t,
                                              const Strip& st, const Plan& p,
                                              Counters& c, int R, int part) {
  wait_terms(p, c, R);
  sums_task<STAGE>(a, t, scan_row(t, a.ny, R, R >= p.jA), st, part,
                   p.sums);
  finished(&c.sums[R % 3]);
}

// Update pass k of row J, once the sums of rows J-1 and J are finished
// (and with them the staged rows J-1 .. J+1 their terms read).
template <bool SAME_BASE, int STAGE>
__device__ __forceinline__ void update_row_task(const Args& a, const Ring& t,
                                                const Strip& st,
                                                const Plan& p, Counters& c,
                                                int J, int k) {
  wait_sums(p, c, J - 1);
  wait_sums(p, c, J);
  update_task<SAME_BASE, STAGE>(a, t, upd_row(t, a.ny, J), st, k);
  finished(&c.updates[J & 3]);
}

// Rows jA .. jB-1 of strip s.
template <bool SAME_BASE, int STAGE>
__device__ void segment(const Args& a, const Ring& t, int s, int jA, int jB,
                        Strip& st, Plan& p, Counters& c) {
  if (threadIdx.x == 0) {
    st = make_strip(a, s);
    p.jA = jA;
    p.jB = jB;
    p.depth = a.depth;
    p.last = min(jB, a.ny - 1);
    p.r_lo = max(jA - 1, 0);
    p.r_mid = min(jA + 1, p.last);
    p.r_hi = min(jA + a.depth - 3, p.last);
    p.j_first = jA > 0 ? jA - 1 : jA;
    p.cols = (st.ncol + kTermCols) / kTermCols;
    p.sums = st.sums;
    p.passes = st.passes;
    p.npre = jA >= 2 ? 1 : 0;
    p.ncopy0 = (p.r_mid - p.r_lo + 1) * (kNFields + 1);
    p.nrows0 = jA - p.j_first + 1;
    p.nfirst = p.npre + p.ncopy0 + p.nrows0 * (p.cols + p.sums)
               + (p.r_hi - p.r_mid) * (kNFields + 1);
    c.ticket = 0;
    c.pre = 0;
    for (int q = 0; q < kMaxDepth; ++q)
      barrier_init(&c.landed[q], (kNFields + 1) * 32);
    for (int q = 0; q < 3; ++q) c.terms[q] = c.sums[q] = 0;
    for (int q = 0; q < 4; ++q) c.updates[q] = 0;
  }
  __syncthreads();

  // a warp's place in the order: row J's tasks start at ticket `start`
  int J = jA, start = p.nfirst;
  for (;;) {
    int q = 0;
    if (lane_id() == 0) q = atomicAdd(&c.ticket, 1);
    q = __shfl_sync(kFull, q, 0);
    if (q < p.nfirst) {                       // the warm-up
      if (q < p.npre) {                       // COLP of row jA-2
        copy_lines<STAGE>(a, t, st, jA - 2, -2);
        land_copies();
        finished(&c.pre);
      } else if ((q -= p.npre) < p.ncopy0) {  // the rows its scans read
        copy_task<STAGE>(a, t, st, p, c, p.r_lo + q / (kNFields + 1),
                  q % (kNFields + 1) - 1);
      } else if ((q -= p.ncopy0) < p.nrows0 * p.cols) {
        terms_row_task(a, t, st, p, c, p.j_first + q / p.cols, q % p.cols);
      } else if ((q -= p.nrows0 * p.cols) < p.nrows0 * p.sums) {
        sums_row_task<STAGE>(a, t, st, p, c, p.j_first + q / p.sums,
                             q % p.sums);
      } else {                                // the rest of the first rows
        q -= p.nrows0 * p.sums;
        copy_task<STAGE>(a, t, st, p, c, p.r_mid + 1 + q / (kNFields + 1),
                  q % (kNFields + 1) - 1);
      }
      continue;
    }
    while (J < jB && q >= start + row_tasks(p, J)) {
      start += row_tasks(p, J);
      ++J;
    }
    if (J >= jB) break;
    q -= start;
    const int ncols = J + 1 < jB ? p.cols : 0;
    const int nsums = J + 1 < jB ? p.sums : 0;
    const int half = p.passes / 2;
    if (q < ncols)
      terms_row_task(a, t, st, p, c, J + 1, q);
    else if ((q -= ncols) < half)
      update_row_task<SAME_BASE, STAGE>(a, t, st, p, c, J, q);
    else if ((q -= half) < nsums)
      sums_row_task<STAGE>(a, t, st, p, c, J + 1, q);
    else if ((q -= nsums) < p.passes - half)
      update_row_task<SAME_BASE, STAGE>(a, t, st, p, c, J, half + q);
    else
      copy_task<STAGE>(a, t, st, p, c, J + p.depth - 2,
                       q - (p.passes - half) - 1);
  }
  __syncthreads();
}

// A block's runs of rows, for the kernels below.
template <bool SAME_BASE, int STAGE>
__device__ __forceinline__ void block_runs(const Args& args, Strip& strip,
                                           Plan& plan, Counters& counters) {
  // the first barrier publishes dt
  if (threadIdx.x == 0) substep_dt = __ldg(args.scalars);
  const Args& a = args;
  const Ring t(a.nz, a.tx, a.depth, STAGE > 0);
  for (int q = threadIdx.x; q <= a.nz; q += kThreads) {
    substep_smem[t.sig + q] = a.sigma_vb[q];
    if (q < a.nz) substep_smem[t.dsig + q] = a.dsigma[q];
  }
  __syncthreads();

  for_each_segment(a.ny, a.nx, a.tx, a.blocks, [&](int s, int jA, int jB) {
    segment<SAME_BASE, STAGE>(a, t, s, jA, jB, strip, plan, counters);
  });
}

// A Matsuno substep: the predictor (SAME_BASE) or the corrector.
template <bool SAME_BASE>
__global__ void __launch_bounds__(kThreads, 1)
substep_kernel(Args args) {
  __shared__ Strip strip;
  __shared__ Plan plan;
  __shared__ Counters counters;
  block_runs<SAME_BASE, 0>(args, strip, plan, counters);
}

// RK4 stage STAGE (1..4); the first evaluates at the t_n state itself.
template <int STAGE>
__global__ void __launch_bounds__(kThreads, 1)
rk4_stage_kernel(Args args) {
  __shared__ Strip strip;
  __shared__ Plan plan;
  __shared__ Counters counters;
  block_runs<STAGE == 1, STAGE>(args, strip, plan, counters);
}

template <typename K>
int launch_kernel(K kernel, int& opted, const Args& a, int smem,
                  cudaStream_t s) {
  const int err = allow_smem(kernel, smem, opted);
  if (err) return err;
  kernel<<<a.blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool SAME_BASE>
int launch(const Args& a, int smem, cudaStream_t s) {
  static int opted = 48 * 1024;                   // the default limit
  return launch_kernel(substep_kernel<SAME_BASE>, opted, a, smem, s);
}

template <int STAGE>
int launch_stage(const Args& a, int smem, cudaStream_t s) {
  static int opted = 48 * 1024;
  return launch_kernel(rk4_stage_kernel<STAGE>, opted, a, smem, s);
}

}  // namespace

// Plain C interface, loaded with ctypes (kernels/fused_substep.py). The
// predictor passes the evaluation state as the base (same_base=1). tx,
// depth, blocks and smem_bytes are the plan (launch_plan: the strip width,
// the ring depth, the persistent grid and the shared memory); scalars
// points to the float[2] (dt, frac) on the card (only dt is read here). A
// plan whose shared memory falls short of the ring's layout, 2 > nz > 128,
// a tx other than 4, 8, 16 or 32, a depth outside 5..6, no block, an empty
// grid or a null scalars is refused. Returns cudaGetLastError() after the
// launch; 0 is success.
extern "C" int cm_fused_substep_f32(
    const float* u, const float* v, const float* pott, const float* qv,
    const float* qc, const float* colp,
    const float* ub, const float* vb, const float* pottb, const float* qvb,
    const float* qcb, const float* colpb,
    const float* hsurf, const float* rad, const float* geo,
    const float* sigma_vb, const float* dsigma, const float* vmask,
    float* u_out, float* v_out, float* pott_out, float* qv_out, float* qc_out,
    float* colp_out,
    int nz, int ny, int nx, int tx, int depth, int blocks, int smem_bytes,
    const float* scalars, float dy, float ptop,
    int same_base, int with_rad, int with_diff, void* stream) {
  if (nz < 2 || nz > 128 || !(tx == 4 || tx == 8 || tx == 16 || tx == 32)
      || depth < kMinDepth || depth > kMaxDepth || blocks < 1 || ny < 1
      || nx < 1 || scalars == nullptr
      || smem_bytes < (int)sizeof(float) * Ring(nz, tx, depth).total)
    return (int)cudaErrorInvalidValue;
  const float* staged[] = {u, v, pott, qv, qc, colp, colpb, hsurf};
  Args a{u, v, pott, qv, qc, colp, ub, vb, pottb, qvb, qcb, colpb,
         hsurf, rad, geo, sigma_vb, dsigma, vmask,
         u_out, v_out, pott_out, qv_out, qc_out, colp_out,
         nz, ny, nx, tx, depth, blocks, copy_width(nx, staged, 8),
         scalars, dy, (float)((double)dy * (double)dy), ptop,
         with_rad, with_diff};
  if (same_base) {
    a.ub = u; a.vb = v; a.pottb = pott; a.qvb = qv; a.qcb = qc; a.colpb = colp;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return same_base ? launch<true>(a, smem_bytes, s)
                   : launch<false>(a, smem_bytes, s);
}

// One RK4 stage (rk4_stage_kernel<stage>): the tendencies at the stage state
// (u .. colp), the next stage state from the t_n state (u0 .. colp0; the
// stage state itself at stage 1) into the outputs, and the accumulator
// (acc_*, in place; (nz, ny, nx) and, for COLP, (ny, nx)) as the header
// says. The plan is the stage's (launch_plan: its scan slot holds one more
// row). Refused as cm_fused_substep_f32 refuses, and a stage outside 1..4
// or a null accumulator.
extern "C" int cm_rk4_stage_f32(
    const float* u, const float* v, const float* pott, const float* qv,
    const float* qc, const float* colp,
    const float* u0, const float* v0, const float* pott0, const float* qv0,
    const float* qc0, const float* colp0,
    const float* hsurf, const float* rad, const float* geo,
    const float* sigma_vb, const float* dsigma, const float* vmask,
    float* u_out, float* v_out, float* pott_out, float* qv_out, float* qc_out,
    float* colp_out,
    float* acc_u, float* acc_v, float* acc_pott, float* acc_qv,
    float* acc_qc, float* acc_colp,
    int nz, int ny, int nx, int tx, int depth, int blocks, int smem_bytes,
    const float* scalars, float dy, float ptop,
    int stage, int with_rad, int with_diff, void* stream) {
  if (nz < 2 || nz > 128 || !(tx == 4 || tx == 8 || tx == 16 || tx == 32)
      || depth < kMinDepth || depth > kMaxDepth || blocks < 1 || ny < 1
      || nx < 1 || scalars == nullptr || stage < 1 || stage > 4
      || !acc_u || !acc_v || !acc_pott || !acc_qv || !acc_qc || !acc_colp
      || smem_bytes < (int)sizeof(float) * Ring(nz, tx, depth, true).total)
    return (int)cudaErrorInvalidValue;
  if (stage == 1) {
    u0 = u; v0 = v; pott0 = pott; qv0 = qv; qc0 = qc; colp0 = colp;
  }
  const float* staged[] = {u, v, pott, qv, qc, colp, colp0, hsurf};
  Args a{u, v, pott, qv, qc, colp, u0, v0, pott0, qv0, qc0, colp0,
         hsurf, rad, geo, sigma_vb, dsigma, vmask,
         u_out, v_out, pott_out, qv_out, qc_out, colp_out,
         nz, ny, nx, tx, depth, blocks, copy_width(nx, staged, 8),
         scalars, dy, (float)((double)dy * (double)dy), ptop,
         with_rad, with_diff,
         acc_u, acc_v, acc_pott, acc_qv, acc_qc, acc_colp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 1: return launch_stage<1>(a, smem_bytes, s);
    case 2: return launch_stage<2>(a, smem_bytes, s);
    case 3: return launch_stage<3>(a, smem_bytes, s);
    default: return launch_stage<4>(a, smem_bytes, s);
  }
}
