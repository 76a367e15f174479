// The physics epilogue of the Matsuno corrector: surface, turbulence and
// microphysics on the post-dynamics fields, hand-written CUDA C++ for
// Hopper (sm_90a), fp32.
//
// Replaces the epilogue of the TPU kernel climate_model_tpu/kernels/
// fused_substep.py::make_fused_substep_packed with phys= (the pallas_call at
// :1047, the epilogue body at :778-989, launched by the packed scan's
// corrector, climate_model_tpu/model.py:119-120). It is the second launch of
// that corrector: the substep (fused_substep.cu) writes the post-dynamics u,
// v, pott, qv, qc and COLP_new, this one writes the step's final fields. It
// computes, with pressure and Exner factors of the NEW colp:
//   surface      bulk sensible and latent fluxes (1 m/s gust floor on the
//                cell-centre wind from u at the east face and v at the
//                north face), the slab tsurf (land or ocean heat capacity),
//                the soil bucket's evaporation efficiency and drying, the
//                bottom-layer pott and qv increments, and the u and v drag
//                averaged to the faces with the west and south neighbours;
//   turbulence   explicit vertical K-diffusion of pott, qv, qc (zero flux
//                at top and bottom, qv and qc clipped at 0) with the
//                optional moist-convective K, and of u and v with the
//                column's dz and rho averaged with the west and south column;
//   microphysics saturation adjustment, autoconversion with
//                frac = 1 - exp(-dt/tau) (computed by the wrapper in fp32),
//                the column rain sum and the soil refill.
// Every physics switch and parameter is a launch argument; dt and frac are
// a runtime operand, a float[2] on the device that each block reads once
// (the reference's jnp.stack([dt_s, frac])): adaptive dt and retuning
// rebuild nothing, and a captured CUDA graph takes a new dt without a
// re-capture. The operator order and the
// association of every expression follow the plain PyTorch splits
// (physics/surface.py, turbulence.py, microphysics.py), which are the plain
// version this kernel is held to, but for two sums that are warp-wide
// trees here (column.cuh): the geopotential's suffix sum of the height
// profile (suffix_sum) and the column's rain sum (column_sum).
//
// Layout and edges: the plain State layout, (nz, ny, nx) and (ny, nx) fp32.
// Longitude wraps (on a shard's block too: fused_substep.cu's header says
// why the block's 3 ghost rows and columns keep the wrong edge columns out
// of the interior, for this launch as well); the cell-centre v reads 0 north
// of the last row; the face averages clamp at the south wall
// (dycore/boundaries.py); v is multiplied by vmask when one is given and
// zeroed on row 0 otherwise, after the drag and after the diffusion, where
// the TPU kernel calls apply_wall.
//
// What bounds it on the card: bytes. It must read the five post-dynamics
// 3-D fields and about ten 2-D fields and write five 3-D and three 2-D
// fields: at config #3 (360x180x32 fp32, 8.3 MB per 3-D field) about 84 MB,
// >= 25 us at 3.35 TB/s. The design:
//   * A block (threads_for<L>() threads: 16 warps at up to 32 levels, two
//     blocks an SM; else 8) owns a tile of tj latitude rows x tx longitudes
//     (kernels/fused_substep.py::launch_plan sizes it and its dynamic
//     shared memory). It copies the tile's u, v, qv and qc, and pott of the
//     tile with one column west and one row south, into shared memory with
//     cp.async: a warp per (field, level, row) line, lanes along longitude,
//     so each copy reads consecutive floats, kept as columns (level
//     fastest, odd column stride: no bank conflicts either way). The bottom
//     level of u and v comes in with one column and one row around, the
//     2-D fields for the tile (and colp, tsurf and hsurf for its west
//     column and south row), sigma_vb and dsigma likewise.
//   * Neighbour columns once. The drag at the west (south) face needs the
//     stress of column (j, i-1) ((j-1, i)), and the diffusion of u (v) the
//     height profile of that column after its surface heating. So every
//     column of the tile and of its west column and south row first gets its
//     surface core (rho, wind, stresses, bottom heating; a thread per
//     column) and then its height profile (dz and rho at centres and
//     interior borders; a warp per column with the levels on the lanes)
//     into shared memory. Only the halo columns are computed twice, by two
//     tiles, identically.
//   * Then one warp per column of the tile runs the physics with the column
//     in registers (ceil(nz/32) levels a lane; at up to 32 levels ptxas
//     reports no stack frame): each diffusion's border flux takes the level
//     below from the next lane by a shuffle and the flux above from the
//     previous lane, the convective K the level below likewise, the faces'
//     profiles are the means of two columns' profiles read from shared
//     memory, and the rain sum is a warp reduction. The results go back to
//     shared memory and out with coalesced lines.
// Measured on an H100 (PERF.md), the launch is not bound by bytes but by
// the latency of the per-column work, at 32 warps an SM.
// No thread reads what another block writes, so no ordering between blocks
// is needed, and a column's arithmetic does not depend on where a tile
// boundary falls.

#include <cuda_runtime.h>

#include "column.cuh"
#include "constants.cuh"

namespace {

using namespace cm;

// threads a block: 16 warps where a column fits one register a lane (64
// registers a thread, two blocks an SM), else 8
template <int L>
__host__ __device__ constexpr int threads_for() { return L == 1 ? 512 : 256; }

struct Epi {
  // post-dynamics fields (the substep's output) and COLP_new
  const float *u, *v, *pott, *qv, *qc, *colp;
  // the 2-D state and forcing the physics reads
  const float *tsurf, *rain, *soil, *swflx, *lwflx;
  const float *land, *evap_eff, *hsurf, *vmask, *sigma_vb, *dsigma;
  float *u_out, *v_out, *pott_out, *qv_out, *qc_out;
  float *tsurf_out, *rain_out, *soil_out;
  int nz, ny, nx, tx, tj;
  const float* scalars;             // (dt, frac) on the card
  float dt, ptop, frac;             // dt, frac: from scalars
  int w_srf, w_trb, w_mic, w_soil, w_conv;
  float drag, soil_cap, ocean_cap, qc_thr, k_scalar, k_mom, sm_cap, conv_k,
      conv_rh;
};

// The surface core of a column, kept for its neighbours (shared memory).
enum SurfSlot {
  kRho = 0, kWind, kShflx, kPSfc, kDpSfc, kTaux, kTauy, kDpottB, kNSurf
};
// The height profile of a column (turbulence.py): layer thickness dzc and
// density rc at the nz centres, centre-to-centre distance dzvb and density
// rvb at the nz-1 interior borders (index kb: between levels kb and kb+1).
enum ProfSlot { kDzc = 0, kRc, kDzvb, kRvb, kNProf };
// Own fields of the tile in shared memory (pott lives with the halo).
enum OwnSlot { kOwnU = 0, kOwnV, kOwnQv, kOwnQc, kNOwn };
// 2-D fields of the tile with its west column and south row, and of the
// tile alone.
enum Ext2 { kColp = 0, kTsurf, kHsurf, kNExt2 };
enum Own2 { kLand = 0, kEvapEff, kSwflx, kLwflx, kRain, kSoil, kNOwn2 };

// Shared-memory layout of a tile, in floats; kernels/fused_substep.py::
// epilogue_smem_floats is the same formula.
struct Tile {
  int nzp;     // column stride (odd)
  int ex, ey;  // the tile with one column west and one row south
  int bx, by;  // bottom u and v: the tile with one column and row around
  int pott, own, prof, surf, ub, vb, ext2, xs, own2, sig, dsig, total;

  __host__ __device__ Tile(int nz, int tx, int tj) {
    nzp = nz | 1;
    ex = tx + 1; ey = tj + 1;
    bx = tx + 2; by = tj + 2;
    const int e = ex * ey;
    pott = 0;
    own = pott + e * nzp;
    prof = own + kNOwn * tx * tj * nzp;
    surf = prof + kNProf * e * nzp;
    ub = surf + kNSurf * e;
    vb = ub + bx * by;
    ext2 = vb + bx * by;
    xs = ext2 + kNExt2 * e;
    own2 = xs + e;
    sig = own2 + kNOwn2 * tx * tj;
    dsig = sig + nz + 1;
    total = dsig + nz;
  }
};

// x clipped below at 0, NaN passing through (torch.clamp(x, min=0))
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// physics/thermo.py::qsat_water (Magnus)
__device__ __forceinline__ float qsat_water(float tair, float pair) {
  const float t_c = tair - kTZeroC;
  const float es = kMagnusE0 * expf(kMagnusA * t_c / (t_c + kMagnusB));
  float denom = pair - kOneMinusEps * es;
  denom = denom < 1.f ? 1.f : denom;
  return kEps * es / denom;
}

// ---------------------------------------------------------------------------
// The surface core of one column of the tile or its halo (surface.py::
// surface_fluxes, the part a column and its neighbours share), a thread per
// column: the surface border's Exner factor, then, with the surface on,
// rho, wind, the sensible flux, the surface pressure and layer mass, the
// stresses and the bottom layer's heating, into shared memory.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void surface_core(const Epi& e, const Tile& t,
                                             float* sm, int j, int er,
                                             int ec) {
  const int nz = e.nz, kb = nz - 1;
  const int c = er * t.ex + ec;
  const int es = t.ex * t.ey;
  const float* sig = sm + t.sig;
  const float cn = sm[t.ext2 + kColp * es + c];
  const float x_sfc = surface_exner(sig, e.ptop, cn, nz);
  sm[t.xs + c] = x_sfc;
  if (!e.w_srf) return;
  // the bottom level's pressures and Exner factors, as Pressure has them
  const float lo_b = e.ptop + sig[kb] * cn;
  const float hi_b = e.ptop + sig[nz] * cn;
  const float x_lo = powf(div_rn(lo_b, kPRef, kRecipPRef), kKappa);
  const float pvtf_b = (hi_b * x_sfc - lo_b * x_lo)
                       / (kOnePlusKappa * (hi_b - lo_b));
  const float t_air = sm[t.pott + c * t.nzp + kb] * pvtf_b;
  const float p_air = 0.5f * (lo_b + hi_b);
  const float rho = p_air / (kRd * t_air);
  const float* ub = sm + t.ub + er * t.bx + ec;
  const float* vb = sm + t.vb + er * t.bx + ec;
  const float u_c = 0.5f * (ub[0] + ub[1]);
  const float vn = j + 1 < e.ny ? vb[t.bx] : 0.f;
  const float v_c = 0.5f * (vb[0] + vn);
  const float wind = sqrtf(u_c * u_c + v_c * v_c + 1.f);
  const float tsurf = sm[t.ext2 + kTsurf * es + c];
  const float shflx = rho * kCp * e.drag * wind * (tsurf - t_air);
  const float dp_sfc = cn * sm[t.dsig + kb];
  // bottom-layer heating of the sensible flux (surface.py::surface_step)
  const float m_sfc = dp_sfc / kG;
  float* sf = sm + t.surf + c;
  sf[kRho * es] = rho;
  sf[kWind * es] = wind;
  sf[kShflx * es] = shflx;
  sf[kPSfc * es] = hi_b;
  sf[kDpSfc * es] = dp_sfc;
  sf[kTaux * es] = -rho * e.drag * wind * u_c;
  sf[kTauy * es] = -rho * e.drag * wind * v_c;
  sf[kDpottB * es] = e.dt * shflx / (kCp * m_sfc) / pvtf_b;
}

// ---------------------------------------------------------------------------
// The height profile of one column of the tile or its halo, a warp per
// column with the levels on the lanes.
// ---------------------------------------------------------------------------
template <int L>
__device__ __forceinline__ void column_profile(const Epi& e, const Tile& t,
                                               float* sm, int c) {
  const int nz = e.nz, kb = nz - 1;
  const int lane = lane_id();
  const int es = t.ex * t.ey;
  const float cn = sm[t.ext2 + kColp * es + c];
  const float* ptc = sm + t.pott + c * t.nzp;
  float pt[L];
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    pt[m] = k < nz ? ptc[k] : 0.f;
  }
  Pressure<L> p;
  p.compute(sm + t.sig, e.ptop, cn, nz, sm[t.xs + c]);
  const float dpott_b = e.w_srf ? sm[t.surf + kDpottB * es + c] : 0.f;
  if (!e.w_trb) return;

  // the profile (turbulence.py), from the column after its surface heating;
  // the geopotential is the hydrostatic suffix sum from the surface up
  // (operators.py::diagnose_geopotential)
  add_at_level(pt, kb, dpott_b);
  float cppt[L], phivb_lo[L];
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    cppt[m] = kCp * pt[m];
    phivb_lo[m] = k < nz ? cppt[m] * (p.x_hi[m] - p.x_lo[m]) : 0.f;
  }
  suffix_sum(phivb_lo);
  const float phivb_sfc = kG * sm[t.ext2 + kHsurf * es + c];
  float phivb_hi[L];
#pragma unroll
  for (int m = 0; m < L; ++m) phivb_lo[m] = phivb_sfc + phivb_lo[m];
  level_below(phivb_lo, phivb_hi);
  float zc[L], tair[L];
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    if (k == kb) phivb_hi[m] = phivb_sfc;
    const float phi = phivb_hi[m] + cppt[m] * (p.x_hi[m] - p.pvtf[m]);
    zc[m] = div_rn(phi, kG, kRecipG);
    tair[m] = pt[m] * p.pvtf[m];
  }
  float zc_below[L], tair_below[L];
  level_below(zc, zc_below);
  level_below(tair, tair_below);
  float* pr = sm + t.prof + c * t.nzp;
  const int plane = t.ex * t.ey * t.nzp;
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    if (k < nz) {
      const float dzc = div_rn(phivb_lo[m], kG, kRecipG)
                        - div_rn(phivb_hi[m], kG, kRecipG);
      pr[kDzc * plane + k] = dzc;
      pr[kRc * plane + k] = (p.hi[m] - p.lo[m]) / (kG * dzc);
      if (k < kb) {
        pr[kDzvb * plane + k] = zc[m] - zc_below[m];
        pr[kRvb * plane + k] =
            p.hi[m] / (kRd * (0.5f * (tair[m] + tair_below[m])));
      }
    }
  }
}

// The divisors of a K-diffusion step on a profile: the layer mass rc * dzc
// and the border distance dzvb, with their reciprocals (div_rn), shared by
// the diffusions on the same profile.
template <int L>
struct Divisors {
  float mass[L], r_mass[L], dzvb[L], r_dzvb[L], rvb[L];

  __device__ __forceinline__ Divisors(const float (&dzc)[L],
                                      const float (&rc)[L],
                                      const float (&dzvb_)[L],
                                      const float (&rvb_)[L]) {
#pragma unroll
    for (int m = 0; m < L; ++m) {
      mass[m] = rc[m] * dzc[m];
      r_mass[m] = rcp(mass[m]);
      dzvb[m] = dzvb_[m];
      r_dzvb[m] = rcp(dzvb_[m]);
      rvb[m] = rvb_[m];
    }
  }
};

// One explicit K-diffusion step of the column x, in place: upward-positive
// flux at the interior borders, zero at top and bottom; kk is the
// diffusivity per border.
template <int L>
__device__ __forceinline__ void diffuse(float (&x)[L], const float (&kk)[L],
                                        const Divisors<L>& d, int nz,
                                        float dt) {
  const int lane = lane_id();
  float xb[L], f[L], ft[L];
  level_below(x, xb);
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    f[m] = 0.f;
    if (k < nz - 1) {
      const float grad = div_rn(x[m] - xb[m], d.dzvb[m], d.r_dzvb[m]);
      f[m] = -kk[m] * d.rvb[m] * grad;
    }
  }
  level_above(f, ft);
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    const float f_top = k > 0 ? ft[m] : 0.f;
    if (k < nz)
      x[m] = x[m] + div_rn(dt * (f[m] - f_top), d.mass[m], d.r_mass[m]);
  }
}

// The profile of slot c (or, with c2 >= 0, the face profile: the mean of
// slot c2's and slot c's, in that order) into registers.
template <int L>
__device__ __forceinline__ void load_profile(const Tile& t, const float* sm,
                                             int c, int c2, int nz,
                                             float (&dzc)[L], float (&rc)[L],
                                             float (&dzvb)[L],
                                             float (&rvb)[L]) {
  const int lane = lane_id();
  const int plane = t.ex * t.ey * t.nzp;
  const float* a = sm + t.prof + c * t.nzp;
  const float* b = sm + t.prof + (c2 >= 0 ? c2 : c) * t.nzp;
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    const int kk = k < nz ? k : nz - 1;
    const int kv = k < nz - 1 ? k : 0;
    dzc[m] = a[kDzc * plane + kk];
    rc[m] = a[kRc * plane + kk];
    dzvb[m] = a[kDzvb * plane + kv];
    rvb[m] = a[kRvb * plane + kv];
    if (c2 >= 0) {
      dzc[m] = 0.5f * (b[kDzc * plane + kk] + dzc[m]);
      rc[m] = 0.5f * (b[kRc * plane + kk] + rc[m]);
      dzvb[m] = 0.5f * (b[kDzvb * plane + kv] + dzvb[m]);
      rvb[m] = 0.5f * (b[kRvb * plane + kv] + rvb[m]);
    }
  }
}

// ---------------------------------------------------------------------------
// The physics of one column (jr, x) of the tile, in registers.
// ---------------------------------------------------------------------------
template <int L>
__device__ __forceinline__ void column_physics(const Epi& e, const Tile& t,
                                               float* sm, int j0, int i0,
                                               int jr, int x) {
  const int nz = e.nz, kb = nz - 1, nx = e.nx;
  const int lane = lane_id();
  const int j = j0 + jr, i = i0 + x;
  const int id2 = j * nx + i;
  const int c = (jr + 1) * t.ex + x + 1;           // this column's slot
  const int cw = c - 1;                             // the west column's
  const int cs = j == 0 ? c : c - t.ex;             // the south (clamped)
  const int o = jr * e.tx + x;                      // own-field column
  float* ptc = sm + t.pott + c * t.nzp;
  const int own_plane = e.tx * e.tj * t.nzp;
  float* ou = sm + t.own + kOwnU * own_plane + o * t.nzp;
  float* ov = sm + t.own + kOwnV * own_plane + o * t.nzp;
  float* oqv = sm + t.own + kOwnQv * own_plane + o * t.nzp;
  float* oqc = sm + t.own + kOwnQc * own_plane + o * t.nzp;
  float pt[L], qv[L], qc[L], u[L], v[L];
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    const int kk = k < nz ? k : 0;
    pt[m] = ptc[kk];
    u[m] = ou[kk];
    v[m] = ov[kk];
    qv[m] = oqv[kk];
    qc[m] = oqc[kk];
  }
  const int es = t.ex * t.ey;
  const float* own2 = sm + t.own2 + o;
  const int own2_plane = e.tx * e.tj;
  const float cn = sm[t.ext2 + kColp * es + c];
  const float land = own2[kLand * own2_plane];
  float tsurf = sm[t.ext2 + kTsurf * es + c];
  float rain = own2[kRain * own2_plane], sm_ = own2[kSoil * own2_plane];
  // the v wall (apply_wall of the TPU kernel); "+ 0" as in fused_substep.cu
  const float vm = e.vmask ? e.vmask[j] : 0.f;
  auto wall = [&]() {
#pragma unroll
    for (int m = 0; m < L; ++m)
      v[m] = e.vmask ? v[m] * vm + 0.f : (j == 0 ? 0.f : v[m]);
  };

  // ---- surface ----
  if (e.w_srf) {
    auto surf = [&](int slot, int col) { return sm[t.surf + slot * es + col]; };
    const float qsat_s = qsat_water(tsurf, surf(kPSfc, c));
    float eff = own2[kEvapEff * own2_plane];
    if (e.w_soil) {
      float frac = sm_ / e.sm_cap;
      frac = frac < 0.f ? 0.f : (frac > 1.f ? 1.f : frac);
      eff = land > 0.5f ? frac : 1.f;
    }
    const float evap = surf(kRho, c) * e.drag * surf(kWind, c) * eff
                       * relu(qsat_s - at_level(qv, kb));
    const float lhflx = kLv * evap;
    const float heat_cap = land > 0.5f ? e.soil_cap : e.ocean_cap;
    const float net = own2[kSwflx * own2_plane] + own2[kLwflx * own2_plane]
                      - surf(kShflx, c) - lhflx;
    tsurf = tsurf + e.dt * net / heat_cap;

    const float m_sfc = surf(kDpSfc, c) / kG;
    add_at_level(pt, kb, surf(kDpottB, c));
    add_at_level(qv, kb, e.dt * evap / m_sfc);
    const float m_u = 0.5f * (surf(kDpSfc, cw) + surf(kDpSfc, c)) / kG;
    const float m_v = 0.5f * (surf(kDpSfc, cs) + surf(kDpSfc, c)) / kG;
    add_at_level(u, kb,
                 e.dt * 0.5f * (surf(kTaux, cw) + surf(kTaux, c)) / m_u);
    add_at_level(v, kb,
                 e.dt * 0.5f * (surf(kTauy, cs) + surf(kTauy, c)) / m_v);
    wall();
    if (e.w_soil && land > 0.5f) {
      const float dried = sm_ - e.dt * evap / kRhoWater;
      sm_ = dried < 0.f ? 0.f : (dried > e.sm_cap ? e.sm_cap : dried);
    }
  }

  Pressure<L> p;
  p.compute(sm + t.sig, e.ptop, cn, nz, sm[t.xs + c]);

  // ---- turbulence ----
  if (e.w_trb) {
    float dzc[L], rc[L], dzvb[L], rvb[L], kk[L];
    load_profile(t, sm, c, -1, nz, dzc, rc, dzvb, rvb);
#pragma unroll
    for (int m = 0; m < L; ++m) kk[m] = e.k_scalar;
    if (e.w_conv) {
      // moist-convective K at the interior borders (turbulence.py::
      // convective_k), from the post-surface column
      float rh[L], th[L], rh_b[L], th_b[L];
#pragma unroll
      for (int m = 0; m < L; ++m) {
        const float tair = pt[m] * p.pvtf[m];
        const float qs = qsat_water(tair, 0.5f * (p.lo[m] + p.hi[m]));
        rh[m] = qv[m] / (qs < 1e-10f ? 1e-10f : qs);
        th[m] = pt[m] * expf(kLv * qs / (kCp * tair));
      }
      level_below(rh, rh_b);
      level_below(th, th_b);
#pragma unroll
      for (int m = 0; m < L; ++m) {
        const bool fire = (rh[m] < rh_b[m] ? rh[m] : rh_b[m]) > e.conv_rh
                          && th[m] < th_b[m];
        kk[m] = e.k_scalar + (fire ? e.conv_k : 0.f);
      }
    }
    {
      const Divisors<L> d(dzc, rc, dzvb, rvb);
      diffuse(pt, kk, d, nz, e.dt);
      diffuse(qv, kk, d, nz, e.dt);
      diffuse(qc, kk, d, nz, e.dt);
    }
#pragma unroll
    for (int m = 0; m < L; ++m) {
      qv[m] = relu(qv[m]);
      qc[m] = relu(qc[m]);
      kk[m] = e.k_mom;
    }
    // u with the profile averaged over the west column and this one
    load_profile(t, sm, c, cw, nz, dzc, rc, dzvb, rvb);
    diffuse(u, kk, Divisors<L>(dzc, rc, dzvb, rvb), nz, e.dt);
    // v with the south column (clamped at the wall)
    load_profile(t, sm, c, cs, nz, dzc, rc, dzvb, rvb);
    diffuse(v, kk, Divisors<L>(dzc, rc, dzvb, rvb), nz, e.dt);
    wall();
  }

  // ---- microphysics ----
  if (e.w_mic) {
    float rain_k[L];
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const int k = m * 32 + lane;
      rain_k[m] = 0.f;
      if (k >= nz) continue;
      const float tair = pt[m] * p.pvtf[m];
      const float qs = qsat_water(tair, 0.5f * (p.lo[m] + p.hi[m]));
      const float gamma = 1.f + kLv2 * qs / (kCpRv * (tair * tair));
      const float dq = (qv[m] - qs) / gamma;
      const float cond = relu(dq);
      const float ndq = relu(-dq);
      const float evp = qc[m] < ndq ? qc[m] : ndq;
      const float dqc = cond - evp;
      qv[m] = qv[m] - dqc;
      qc[m] = qc[m] + dqc;
      pt[m] = pt[m] + kLvOverCp * dqc / p.pvtf[m];
      const float to_rain = relu(qc[m] - e.qc_thr) * e.frac;
      qc[m] = relu(qc[m] - to_rain);
      qv[m] = relu(qv[m]);
      rain_k[m] = to_rain * (cn * sm[t.dsig + k]);
    }
    const float rain_inc = column_sum(rain_k) / kG;
    rain = rain + rain_inc;
    if (e.w_soil && land > 0.5f) {
      const float wet = sm_ + rain_inc / kRhoWater;
      sm_ = wet > e.sm_cap ? e.sm_cap : wet;
    }
  }

#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    if (k < nz) {
      ptc[k] = pt[m];
      ou[k] = u[m];
      ov[k] = v[m];
      oqv[k] = qv[m];
      oqc[k] = qc[m];
    }
  }
  if (lane == 0) {
    e.tsurf_out[id2] = tsurf;
    e.rain_out[id2] = rain;
    e.soil_out[id2] = sm_;
  }
}

// A 3-D field's (level, row) lines of the tile from shared memory (columns
// stride nzp apart, row r's first at r * w) back to device memory, a warp
// per line, lanes along longitude: rows j0 + r < j0 + nrow, columns i0 + c
// < i0 + ncol; (k, r) advance by carries, as in load_lines.
template <int kWarps>
__device__ __forceinline__ void store_lines(const float* sm, int nzp, int w,
                                            float* dst, const Epi& e, int j0,
                                            int i0, int nrow, int ncol) {
  const int warp = threadIdx.x / 32, lane = lane_id();
  int r = warp % nrow, k = warp / nrow;
  const int dr = kWarps % nrow, dk = kWarps / nrow;
  while (k < e.nz) {
    float* row = dst + ((size_t)k * e.ny + j0 + r) * e.nx + i0;
    for (int c = lane; c < ncol; c += 32) row[c] = sm[(r * w + c) * nzp + k];
    r += dr;
    k += dk;
    if (r >= nrow) { r -= nrow; ++k; }
  }
}

template <int L>
__global__ void __launch_bounds__(threads_for<L>(), L == 1 ? 2 : 1)
epilogue_kernel(Epi args) {
  constexpr int kWarps = threads_for<L>() / 32;
  extern __shared__ float sm[];
  // dt and frac, read once a block from the device operand while the tile
  // stages; the staging's barrier publishes them
  __shared__ float scal_block[2];
  if (threadIdx.x < 2) scal_block[threadIdx.x] = __ldg(args.scalars
                                                       + threadIdx.x);
  Epi e = args;
  const int nz = e.nz, ny = e.ny, nx = e.nx, kb = nz - 1;
  const Tile t(nz, e.tx, e.tj);
  const int i0 = blockIdx.x * e.tx, j0 = blockIdx.y * e.tj;
  const int ncol = min(e.tx, nx - i0), nrow = min(e.tj, ny - j0);
  const int warp = threadIdx.x / 32;
  const int es = t.ex * t.ey, own_plane = e.tx * e.tj * t.nzp;

  // 1. load: pott with the west column and south row, the bottom level of
  // u and v with one column and row around, colp, tsurf and hsurf likewise,
  // the tile's u, v, qv, qc and other 2-D fields, sigma_vb and dsigma
  auto row3 = [&](const float* f, int k, int j) {
    return f + ((size_t)k * ny + clamp_row(j, ny)) * nx;
  };
  load_lines<kWarps>(sm, 1, nz, t.ey, t.ex, i0 - 1, nx, t.nzp,
                     [&](int, int k, int r, const float*& row, int& off) {
                       row = row3(e.pott, k, j0 - 1 + r);
                       off = t.pott + r * t.ex * t.nzp + k;
                     });
  load_lines<kWarps>(sm, 2, 1, t.by, t.bx, i0 - 1, nx, 1,
                     [&](int q, int, int r, const float*& row, int& off) {
                       row = row3(q ? e.v : e.u, kb, j0 - 1 + r);
                       off = (q ? t.vb : t.ub) + r * t.bx;
                     });
  load_lines<kWarps>(sm, kNExt2, 1, t.ey, t.ex, i0 - 1, nx, 1,
                     [&](int q, int, int r, const float*& row, int& off) {
                       const float* f = q == kColp ? e.colp
                                      : q == kTsurf ? e.tsurf : e.hsurf;
                       row = row3(f, 0, j0 - 1 + r);
                       off = t.ext2 + q * es + r * t.ex;
                     });
  for (int q = threadIdx.x; q <= nz; q += threads_for<L>()) {
    sm[t.sig + q] = e.sigma_vb[q];
    if (q < nz) sm[t.dsig + q] = e.dsigma[q];
  }
  load_lines<kWarps>(sm, kNOwn, nz, e.tj, e.tx, i0, nx, t.nzp,
                     [&](int q, int k, int r, const float*& row, int& off) {
                       const float* f = q == kOwnU ? e.u : q == kOwnV ? e.v
                                      : q == kOwnQv ? e.qv : e.qc;
                       row = row3(f, k, j0 + r);
                       off = t.own + q * own_plane + r * e.tx * t.nzp + k;
                     });
  load_lines<kWarps>(sm, kNOwn2, 1, e.tj, e.tx, i0, nx, 1,
                     [&](int q, int, int r, const float*& row, int& off) {
                       const float* f = q == kLand ? e.land
                                      : q == kEvapEff ? e.evap_eff
                                      : q == kSwflx ? e.swflx
                                      : q == kLwflx ? e.lwflx
                                      : q == kRain ? e.rain : e.soil;
                       row = row3(f, 0, j0 + r);
                       off = t.own2 + q * e.tx * e.tj + r * e.tx;
                     });
  wait_copies();
  __syncthreads();
  e.dt = scal_block[0];
  e.frac = scal_block[1];

  // 2. the surface core, then the profile, of the tile, its west column and
  // south row (the columns the physics reads: see active)
  auto active = [&](int er, int ec) {
    return !(er > nrow || ec > ncol || (er == 0 && (ec == 0 || j0 == 0)));
  };
  for (int c = threadIdx.x; c < es; c += threads_for<L>()) {
    const int er = c / t.ex, ec = c % t.ex;
    if (active(er, ec)) surface_core(e, t, sm, j0 - 1 + er, er, ec);
  }
  __syncthreads();
  if (e.w_trb) {
    for (int c = warp; c < es; c += kWarps) {
      const int er = c / t.ex, ec = c % t.ex;
      if (active(er, ec)) column_profile<L>(e, t, sm, c);
    }
    __syncthreads();
  }

  // 3. the physics, one warp per column of the tile
  for (int o = warp; o < e.tx * e.tj; o += kWarps) {
    const int jr = o / e.tx, x = o % e.tx;
    if (jr < nrow && x < ncol) column_physics<L>(e, t, sm, j0, i0, jr, x);
  }
  __syncthreads();

  // 4. store the tile's five fields
  store_lines<kWarps>(sm + t.pott + (t.ex + 1) * t.nzp, t.nzp, t.ex,
                      e.pott_out, e, j0, i0, nrow, ncol);
#pragma unroll
  for (int q = 0; q < kNOwn; ++q)
    store_lines<kWarps>(sm + t.own + q * own_plane, t.nzp, e.tx,
                        q == kOwnU ? e.u_out : q == kOwnV ? e.v_out
                        : q == kOwnQv ? e.qv_out : e.qc_out,
                        e, j0, i0, nrow, ncol);
}

template <int L>
int launch(const Epi& e, dim3 grid, int smem, cudaStream_t s) {
  static int opted = 48 * 1024;                   // the default limit
  const int err = allow_smem(epilogue_kernel<L>, smem, opted);
  if (err) return err;
  epilogue_kernel<L><<<grid, threads_for<L>(), smem, s>>>(e);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (kernels/fused_substep.py), called
// after cm_fused_substep_f32 on the same stream. vmask may be null (the
// index rule); scalars points to the float[2] (dt, frac) on the card. tx,
// tj and smem_bytes are the tile plan (launch_plan); a plan whose shared
// memory falls short of the tile's layout, 2 > nz > 128, a tx over 32 or a
// null scalars is refused. Returns cudaGetLastError() after the launch; 0
// is success.
extern "C" int cm_physics_epilogue_f32(
    const float* u, const float* v, const float* pott, const float* qv,
    const float* qc, const float* colp,
    const float* tsurf, const float* rain, const float* soil,
    const float* swflx, const float* lwflx,
    const float* land, const float* evap_eff, const float* hsurf,
    const float* vmask, const float* sigma_vb, const float* dsigma,
    float* u_out, float* v_out, float* pott_out, float* qv_out,
    float* qc_out, float* tsurf_out, float* rain_out, float* soil_out,
    int nz, int ny, int nx, int tx, int tj, int smem_bytes,
    const float* scalars, float ptop,
    int w_srf, int w_trb, int w_mic, int w_soil, int w_conv,
    float drag, float soil_cap, float ocean_cap, float qc_thr,
    float k_scalar, float k_mom, float sm_cap, float conv_k, float conv_rh,
    void* stream) {
  if (nz < 2 || nz > 128 || tx < 1 || tx > 32 || tj < 1
      || scalars == nullptr
      || smem_bytes < (int)sizeof(float) * Tile(nz, tx, tj).total)
    return (int)cudaErrorInvalidValue;
  Epi e{u, v, pott, qv, qc, colp, tsurf, rain, soil, swflx, lwflx,
        land, evap_eff, hsurf, vmask, sigma_vb, dsigma,
        u_out, v_out, pott_out, qv_out, qc_out, tsurf_out, rain_out, soil_out,
        nz, ny, nx, tx, tj, scalars, 0.f, ptop, 0.f,
        w_srf, w_trb, w_mic, w_soil, w_conv, drag, soil_cap, ocean_cap,
        qc_thr, k_scalar, k_mom, sm_cap, conv_k, conv_rh};
  const dim3 grid((nx + tx - 1) / tx, (ny + tj - 1) / tj);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((nz + 31) / 32) {
    case 1: return launch<1>(e, grid, smem_bytes, s);
    case 2: return launch<2>(e, grid, smem_bytes, s);
    case 3: return launch<3>(e, grid, smem_bytes, s);
    case 4: return launch<4>(e, grid, smem_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}
