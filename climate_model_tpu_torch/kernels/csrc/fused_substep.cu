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
// launch argument: adaptive dt never rebuilds or re-specialises anything.
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
// arithmetic does not depend on where a tile boundary falls, so a block
// gives the same bits as the whole grid.
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
// What bounds it on the card: bytes, in principle. At config #3
// (360x180x32 fp32, 8.3 MB per 3-D field) the predictor must move 11 3-D
// fields (u, v, pott, qv, qc and the radiative heating in, five fields out:
// 91 MB, >= 27.5 us at 3.35 TB/s) and the corrector 16 (the five base
// fields too: 133 MB, >= 40 us). The design keeps every intermediate on the
// chip, in one launch:
//   * A block (kThreads threads, one block an SM) owns a tile of tj
//     latitude rows x tx longitudes (kernels/fused_substep.py::launch_plan
//     sizes it and its dynamic shared memory). It copies u, v, pott, qv and
//     qc of the tile with one column and one row around into shared memory
//     with cp.async, a warp per (field, level, row) line and lanes along
//     longitude, so each copy reads consecutive floats; shared memory keeps
//     them as columns (level fastest, an odd column stride, so neither the
//     line writes nor the column reads conflict in banks). COLP comes in as
//     a 2-D patch with two columns and two rows around, the geometry as the
//     tile's rows with one around.
//   * The column scans run for the tile plus one column west and one row
//     south (what the update reads at (j, i-1) and (j-1, i)). The work of
//     each level (the flux divergence, the Exner factors with one powf a
//     border, the layer's geopotential terms) runs a warp per column with
//     the levels on the lanes, each lane taking the border below from the
//     next lane by a shuffle. The two sums over k (the divergence's prefix
//     sum, giving COLP_new and the sigma velocity; the geopotential's suffix
//     sum from the surface up) run a thread per column over shared memory,
//     in the plain version's serial order. wwind, phi, pvtf and COLP_new
//     stay in shared memory: nothing is written to device memory but the
//     outputs.
//   * The update then runs one thread per point of the tile, lanes along
//     longitude, reading every neighbour from shared memory and the base
//     state and the radiative heating from device memory (coalesced), and
//     writes the five fields once. The halo columns' scans are computed
//     twice, by two tiles, identically. A quotient whose divisor several
//     quotients of a point share (the cell area, dx^2, dy^2, dsigma, COLP_new,
//     the earth's radius) is div_rn of column.cuh: the correctly rounded
//     reciprocal once, then one FMA correction per quotient, which gives the
//     bits of the IEEE division in the normal range at a third of its cost.
// No sum changed association: both sums over k keep the plain version's
// serial order. Measured on an H100 (PERF.md), the kernel is not bound by
// bytes: the staging (about 1 TB/s from L2 with the halo rows, well under
// the card's rate), the scans and the update take about a third of its
// time each. The corrector's physics epilogue is a second launch
// (physics_epilogue.cu).

#include <cuda_runtime.h>

#include "column.cuh"
#include "constants.cuh"

namespace {

using namespace cm;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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
  int nz, ny, nx, tx, tj;
  float dt, dy, dy2, ptop;
  int with_rad, with_diff;
};

// Shared-memory layout of a tile, in floats; kernels/fused_substep.py::
// substep_smem_floats is the same formula.
struct Tile {
  int nzp, nwp;  // column strides of the levels and of the nz+1 borders
  int sx, sy;    // staged columns and rows: the tile, one around
  int ex, ey;    // columns and rows of the scans: the tile, one west/south
  int px;        // COLP patch columns (the tile, two west, one east)
  int fields, wwind, phil, phi, pvtf, cn, cb, dc, xs, colp, geo, sig, dsig,
      total;

  __host__ __device__ Tile(int nz, int tx, int tj) {
    nzp = nz | 1;
    nwp = (nz + 1) | 1;
    sx = tx + 2; sy = tj + 2;
    ex = tx + 1; ey = tj + 1;
    px = tx + 3;
    const int e = ex * ey;
    fields = 0;
    wwind = fields + kNFields * sy * sx * nzp;
    phil = wwind + e * nwp;
    phi = phil + e * nzp;
    pvtf = phi + e * nzp;
    cn = pvtf + e * nzp;
    cb = cn + e;
    dc = cb + e;
    xs = dc + e;
    colp = xs + e;
    geo = colp + (tj + 3) * px;
    sig = geo + (tj + 2) * kNGeo;
    dsig = sig + nz + 1;
    total = dsig + nz;
  }
};

// ---------------------------------------------------------------------------
// Column scans. The work at each level (the flux divergence, the Exner
// factors with their powf, the divisions) runs one warp per column with the
// levels on the lanes; the two sums over k run one thread per column over
// shared memory, in the plain version's serial order.
// ---------------------------------------------------------------------------
struct Col {
  int j, i, e, er, ec;  // grid row and column, scan slot and its row, column
  bool active;          // a slot the update reads
};

__device__ __forceinline__ Col scan_col(const Args& a, const Tile& t, int e,
                                        int j0, int i0, int nrow, int ncol) {
  const int er = e / t.ex, ec = e % t.ex;
  Col c{j0 - 1 + er, wrap(i0 - 1 + ec, a.nx), e, er, ec, true};
  c.active = !(er > nrow || ec > ncol || (er == 0 && (ec == 0 || j0 == 0)));
  return c;
}

// the staged column of field f at the slot's row + dr, column + dc
__device__ __forceinline__ const float* staged(const Tile& t, const float* sm,
                                               int f, const Col& c, int dr,
                                               int dc) {
  return sm + ((f * t.sy + c.er + dr) * t.sx + c.ec + dc) * t.nzp;
}

// 1a. per level k of a column: the divergence term (for wwind[k + 1]), the
// layer Exner factor (pvtf[k]), the geopotential jump across the layer
// (for phi[k]) and the layer's own part of its geopotential (phil[k]). The
// lane of level k raises its upper border to kappa and takes the lower
// border's from the next lane (or, below the last level, from xs).
struct LevelTerms {
  float div, pvtf, jump, own;
};

__device__ __forceinline__ LevelTerms level_terms(const Args& a,
                                                  const Tile& t,
                                                  const float* sm,
                                                  const Col& c, int k,
                                                  int j0) {
  const int nz = a.nz, ny = a.ny, j = c.j, lane = lane_id();
  const bool valid = k < nz;
  const int kk = valid ? k : nz - 1;
  const float* cp = sm + t.colp + (j - j0 + 2) * t.px + c.ec + 1;
  const float ce = cp[0];
  const bool has_n = j + 1 < ny;
  const int js = j > 0 ? j - 1 : 0;
  const float colp_u = 0.5f * (cp[-1] + ce);
  const float colp_u_e = 0.5f * (ce + cp[1]);
  const float colp_v = 0.5f * (cp[(js - j) * t.px] + ce);
  const float colp_v_n = has_n ? 0.5f * (ce + cp[t.px]) : 0.f;
  const float* g = sm + t.geo + (j - j0 + 1) * kNGeo;
  const float dxs_n = has_n ? g[kNGeo + kDxs] : 0.f;
  const float uflx = staged(t, sm, kU, c, 0, 0)[kk] * colp_u * a.dy;
  const float uflx_e = staged(t, sm, kU, c, 0, 1)[kk] * colp_u_e * a.dy;
  const float vflx = j == 0 ? 0.f
                            : staged(t, sm, kV, c, 0, 0)[kk] * colp_v * g[kDxs];
  const float vflx_n = has_n ? staged(t, sm, kV, c, 1, 0)[kk] * colp_v_n * dxs_n
                             : 0.f;
  LevelTerms r;
  r.div = (uflx_e - uflx + vflx_n - vflx) / g[kArea];
  // Exner factors of the layer's borders and the layer
  const float pb_lo = a.ptop + sm[t.sig + kk] * ce;
  const float pb_hi = a.ptop + sm[t.sig + kk + 1] * ce;
  const float pt_lo = powf(div_rn(pb_lo, kPRef, kRecipPRef), kKappa);
  const float below = __shfl_down_sync(kFull, pt_lo, 1);
  const float pt_hi = kk == nz - 1 ? sm[t.xs + c.e]
                    : lane < 31 ? below
                    : powf(div_rn(pb_hi, kPRef, kRecipPRef), kKappa);
  r.pvtf = (pb_hi * pt_hi - pb_lo * pt_lo) / (kOnePlusKappa * (pb_hi - pb_lo));
  const float cppt = kCp * staged(t, sm, kPott, c, 0, 0)[kk];
  r.jump = cppt * (pt_hi - pt_lo);
  r.own = cppt * (pt_hi - r.pvtf);
  return r;
}

__device__ __forceinline__ void store_terms(const Tile& t, float* sm,
                                            const Col& c, int k,
                                            const LevelTerms& r) {
  sm[t.wwind + c.e * t.nwp + k + 1] = r.div * sm[t.dsig + k];
  sm[t.pvtf + c.e * t.nzp + k] = r.pvtf;
  sm[t.phi + c.e * t.nzp + k] = r.jump;
  sm[t.phil + c.e * t.nzp + k] = r.own;
}

// 1b. the sums of one column: the divergence's prefix sum (in place in
// wwind[1..nz-1]) with dCOLP/dt and COLP_new, and the geopotential's suffix
// sum from the surface up (phi, replacing the jumps)
__device__ void scan_sums(const Args& a, const Tile& t, float* sm,
                          const Col& c) {
  const int nz = a.nz, nx = a.nx, e = c.e;
  float* w = sm + t.wwind + e * t.nwp;
  float csum = 0.f;
#pragma unroll 4
  for (int k = 0; k < nz; ++k) {
    csum += w[k + 1];
    if (k < nz - 1) w[k + 1] = csum;
  }
  const float dcolpdt = -csum;
  const float cb = a.colpb[c.j * nx + c.i];
  const float cn = cb + a.dt * dcolpdt;
  sm[t.cn + e] = cn;
  sm[t.cb + e] = cb;
  sm[t.dc + e] = dcolpdt;
  if (c.er >= 1 && c.ec >= 1) a.colp_out[c.j * nx + c.i] = cn;

  const float ghs = kG * a.hsurf[c.j * nx + c.i];
  const float* own = sm + t.phil + e * t.nzp;
  float* phi = sm + t.phi + e * t.nzp;
  float suffix = 0.f;
#pragma unroll 4
  for (int k = nz - 1; k >= 0; --k) {
    const float jump = phi[k];
    phi[k] = (ghs + suffix) + own[k];
    suffix += jump;
  }
}

// 1c. per border: the sigma velocity; zero at top and bottom
__device__ void scan_wwind(const Args& a, const Tile& t, float* sm,
                           const Col& c) {
  const int nz = a.nz;
  float* w = sm + t.wwind + c.e * t.nwp;
  const float dc = sm[t.dc + c.e], cn = sm[t.cn + c.e];
  for (int kb = lane_id(); kb < nz; kb += 32)
    w[kb] = kb == 0 ? 0.f : -(w[kb] + sm[t.sig + kb] * dc) / cn;
  if (lane_id() == 0) w[nz] = 0.f;
}

// ---------------------------------------------------------------------------
// Tendencies and update at one point (jr, x, k) of the tile.
// ---------------------------------------------------------------------------
template <bool SAME_BASE>
__device__ void point_update(const Args& a, const Tile& t, const float* sm,
                             int j0, int i0, int jr, int x, int k) {
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  const int j = j0 + jr;
  const int i = i0 + x;
  const bool has_n = j + 1 < ny;
  const int js = j > 0 ? j - 1 : 0;
  const int jn = has_n ? j + 1 : j;                 // north clamp
  const float* g = sm + t.geo + (jr + 1) * kNGeo;
  const float area = g[kArea], area_v = g[kAreaV], dx = g[kDx];
  const float dx2 = dx * dx;
  const int id = (k * ny + j) * nx + i;
  // the reciprocals of the divisors that several quotients share (div_rn)
  const float r_area = rcp(area), r_dx2 = rcp(dx2), r_dy2 = rcp(a.dy2);
  const float r_earth = rcp(kREarth);

  // staged fields at (kk, jj, i + di) for jj in {js, j, j + 1}: offsets
  // from this point's column, the strides computed once
  const int cs = t.nzp, rs = t.sx * t.nzp, fs = t.sy * rs;
  const float* f0 = sm + t.fields + ((jr + 1) * t.sx + x + 1) * cs;
  auto fld = [&](int f, int kk, int jj, int di) {
    return f0[f * fs + (jj - j) * rs + di * cs + kk];
  };
  // COLP of the evaluation state at (jj, i + di)
  const float* c0 = sm + t.colp + (jr + 2) * t.px + x + 2;
  auto colp = [&](int jj, int di) { return c0[(jj - j) * t.px + di]; };
  // the scan slot of (jj, i + di), di in {-1, 0}
  const int s0 = (jr + 1) * t.ex + x + 1;
  auto slot = [&](int jj, int di) { return s0 + (jj - j) * t.ex + di; };
  auto cnp = [&](int jj, int di) { return sm[t.cn + slot(jj, di)]; };
  auto colpb = [&](int jj, int di) { return sm[t.cb + slot(jj, di)]; };
  auto wwind = [&](int kb, int jj, int di) {
    return sm[t.wwind + slot(jj, di) * t.nwp + kb];
  };
  auto phi = [&](int jj, int di) {
    return sm[t.phi + slot(jj, di) * t.nzp + k];
  };
  auto pvtf = [&](int jj, int di) {
    return sm[t.pvtf + slot(jj, di) * t.nzp + k];
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
    return fld(kV, k, jj, di) * colp_v_at(jj, di) * g[(jj - j) * kNGeo + kDxs];
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
    float qnew = div_rn(qb * cb + a.dt * dqdt, cn, r_cn);
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
    __stcg(a.u_out + id, (ub * cu_old + a.dt * dudt) / cn_u);
  }

  // ---- v momentum at the south face of (j, i) ----
  {
    if (j == 0 && !a.vmask) {                       // south wall, by index
      __stcg(a.v_out + id, 0.f);
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
    const float vnew = (vb * cv_old + a.dt * dvdt) / cn_v;
    // the wall as data: 0 on wall rows. "+ 0" turns the -0 of a negative v
    // times 0 into +0, so the single-device mask equals the index rule bit
    // for bit
    __stcg(a.v_out + id, a.vmask ? vnew * a.vmask[j] + 0.f : vnew);
  }
}

// ---------------------------------------------------------------------------
// The substep: stage, scan, update.
// ---------------------------------------------------------------------------
template <bool SAME_BASE>
__global__ void __launch_bounds__(kThreads, 1)
substep_kernel(Args a) {
  extern __shared__ float sm[];
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  const Tile t(nz, a.tx, a.tj);
  const int i0 = blockIdx.x * a.tx, j0 = blockIdx.y * a.tj;
  const int ncol = min(a.tx, nx - i0), nrow = min(a.tj, ny - j0);
  const int warp = threadIdx.x / 32, lane = lane_id();

  // 1. stage: a warp per (field, level, row) line of sx columns
  load_lines<kWarps>(
      sm, kNFields, nz, t.sy, t.sx, i0 - 1, nx, t.nzp,
      [&](int f, int k, int r, const float*& row, int& off) {
        const float* src = f == kU ? a.u : f == kV ? a.v : f == kPott ? a.pott
                         : f == kQv ? a.qv : a.qc;
        row = src + ((size_t)k * ny + clamp_row(j0 - 1 + r, ny)) * nx;
        off = t.fields + (f * t.sy + r) * t.sx * t.nzp + k;
      });
  load_lines<kWarps>(
      sm, 1, 1, a.tj + 3, t.px, i0 - 2, nx, 1,
      [&](int, int, int r, const float*& row, int& off) {
        row = a.colp + (size_t)clamp_row(j0 - 2 + r, ny) * nx;
        off = t.colp + r * t.px;
      });
  for (int q = threadIdx.x; q <= nz; q += kThreads) {
    sm[t.sig + q] = a.sigma_vb[q];
    if (q < nz) sm[t.dsig + q] = a.dsigma[q];
  }
  for (int q = threadIdx.x; q < (a.tj + 2) * kNGeo; q += kThreads)
    sm[t.geo + q] = a.geo[clamp_row(j0 - 1 + q / kNGeo, ny) * kNGeo
                          + q % kNGeo];
  wait_copies();
  __syncthreads();

  // 2. column scans of the tile, one column west and one row south (the
  // slots the update reads)
  const int slots = t.ex * t.ey;
  // the surface border's Exner factor of each column, a thread per column
  for (int e = threadIdx.x; e < slots; e += kThreads) {
    const Col c = scan_col(a, t, e, j0, i0, nrow, ncol);
    if (!c.active) continue;
    const float ce = sm[t.colp + (c.j - j0 + 2) * t.px + c.ec + 1];
    sm[t.xs + e] = surface_exner(sm + t.sig, a.ptop, ce, nz);
  }
  __syncthreads();
  // 1a. a warp per column, levels on the lanes (every lane runs every
  // segment of 32 levels: the shuffles need the whole warp)
  for (int e = warp; e < slots; e += kWarps) {
    const Col c = scan_col(a, t, e, j0, i0, nrow, ncol);
    if (!c.active) continue;
    for (int m = 0; m < (nz + 31) / 32; ++m) {
      const int k = m * 32 + lane;
      const LevelTerms r = level_terms(a, t, sm, c, k, j0);
      if (k < nz) store_terms(t, sm, c, k, r);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < slots; e += kThreads) {
    const Col c = scan_col(a, t, e, j0, i0, nrow, ncol);
    if (c.active) scan_sums(a, t, sm, c);
  }
  __syncthreads();
  for (int e = warp; e < slots; e += kWarps) {
    const Col c = scan_col(a, t, e, j0, i0, nrow, ncol);
    if (c.active) scan_wwind(a, t, sm, c);
  }
  __syncthreads();

  // 3. the update, one thread per point, lanes along longitude
  const int per_warp = 32 / a.tx;                 // levels a warp takes a pass
  const int x = lane % a.tx, ksub = lane / a.tx;
  if (x >= ncol) return;
  for (int jr = 0; jr < nrow; ++jr)
    for (int k = warp * per_warp + ksub; k < nz; k += kWarps * per_warp)
      point_update<SAME_BASE>(a, t, sm, j0, i0, jr, x, k);
}

template <bool SAME_BASE>
int launch(const Args& a, dim3 grid, int smem, cudaStream_t s) {
  static int opted = 48 * 1024;                   // the default limit
  const int err = allow_smem(substep_kernel<SAME_BASE>, smem, opted);
  if (err) return err;
  substep_kernel<SAME_BASE><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (kernels/fused_substep.py). The
// predictor passes the evaluation state as the base (same_base=1). tx, tj
// and smem_bytes are the tile plan (launch_plan); a plan whose shared
// memory falls short of the tile's layout, 2 > nz > 128 or a tx that does
// not divide 32 is refused. Returns cudaGetLastError() after the launch; 0
// is success.
extern "C" int cm_fused_substep_f32(
    const float* u, const float* v, const float* pott, const float* qv,
    const float* qc, const float* colp,
    const float* ub, const float* vb, const float* pottb, const float* qvb,
    const float* qcb, const float* colpb,
    const float* hsurf, const float* rad, const float* geo,
    const float* sigma_vb, const float* dsigma, const float* vmask,
    float* u_out, float* v_out, float* pott_out, float* qv_out, float* qc_out,
    float* colp_out,
    int nz, int ny, int nx, int tx, int tj, int smem_bytes,
    float dt, float dy, float ptop,
    int same_base, int with_rad, int with_diff, void* stream) {
  if (nz < 2 || nz > 128 || tx < 1 || tx > 32 || 32 % tx != 0 || tj < 1
      || smem_bytes < (int)sizeof(float) * Tile(nz, tx, tj).total)
    return (int)cudaErrorInvalidValue;
  Args a{u, v, pott, qv, qc, colp, ub, vb, pottb, qvb, qcb, colpb,
         hsurf, rad, geo, sigma_vb, dsigma, vmask,
         u_out, v_out, pott_out, qv_out, qc_out, colp_out,
         nz, ny, nx, tx, tj,
         dt, dy, (float)((double)dy * (double)dy), ptop,
         with_rad, with_diff};
  if (same_base) {
    a.ub = u; a.vb = v; a.pottb = pott; a.qvb = qv; a.qcb = qc; a.colpb = colp;
  }
  const dim3 grid((nx + tx - 1) / tx, (ny + tj - 1) / tj);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return same_base ? launch<true>(a, grid, smem_bytes, s)
                   : launch<false>(a, grid, smem_bytes, s);
}
