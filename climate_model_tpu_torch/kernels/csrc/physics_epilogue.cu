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
// What bounds it on the card: bytes in principle. It must read the five
// post-dynamics 3-D fields and about ten 2-D fields and write five 3-D and
// three 2-D fields: at config #3 (360x180x32 fp32, 8.3 MB per 3-D field)
// about 84 MB, >= 25 us at 3.35 TB/s. In practice the latency of each
// column's chain of shuffles and special functions (PERF.md). So the kernel
// marches along latitude, as the substep does (fused_substep.cu's header),
// to keep every warp in a column's chain while the copies and stores of
// other rows run beside it:
//   * A persistent grid (kernels/fused_substep.py::launch_plan): one block
//     an SM (threads_for<L>(): 32 warps where a column fits one register a
//     lane, at 64 registers a thread; else 8), as many blocks as SMs, or as
//     many as units on a small block. Strips of at most tx longitudes and
//     balanced runs of (strip, row) units by the substep's rules (march.cuh,
//     run_start); a block walks its run south to north, and where it starts
//     or crosses into the next strip it warms up: it stages the row below
//     its first and computes that row's surface cores and profiles.
//   * A ring of `depth` staged rows in shared memory (5 or 6, from the
//     plan): a row's pott with the west column and its u, v, qv and qc, as
//     (field, level) lines, longitude fastest, as the substep stages them
//     (march.cuh), so that their copies and stores move 16 bytes a lane
//     where the rows allow it; a column's levels lie a pitch apart (4 mod 8
//     floats: a 4-way bank conflict on the few reads and writes of a whole
//     column). The copies are cp.async and land on the slot's mbarrier; the
//     row below a segment stages only pott. The 2-D fields (colp, tsurf,
//     hsurf, the bottom u and v around a column, the forcing) are read from
//     device memory where they are used: coalesced by the surface cores'
//     lanes, one float a column elsewhere. (Staged by 4-byte copies, they
//     cost more than all the 3-D lines.)
//   * A ring of kProfRows (4) rows of surface cores (rho, wind, stresses,
//     bottom heating, a lane a column) and height profiles (dz and rho at
//     centres and interior borders, a warp a column with the levels on the
//     lanes, each column's levels at an odd pitch), with the layer Exner
//     factors the profile computes, of the strip's columns and the one
//     west, computed kAhead (1) row ahead of the physics. Row j's physics
//     reads rows j and j-1 of it, so each column's core, profile and Exner
//     factors are computed once, but the west column and a segment's first
//     south row (the plan's profiled_cols_per_col).
//   * The work is a stream of tasks that warps take from a counter in
//     shared memory: a staged row's copies (five tasks: pott, u, v, qv,
//     qc), a row's surface cores (ceil((ncol + 1) / 32) tasks, a lane a
//     column), its profiles (kProfCols columns a task), its physics (the
//     plan's phys_cols columns a task, in turn: a column in registers,
//     ceil(nz/32) levels a lane; each diffusion's border flux takes the
//     level below from the next lane by a shuffle and the flux above from
//     the previous lane, the convective K the level below likewise, the
//     faces' profiles are the means of two columns' profiles, the rain sum
//     a warp reduction; results back into the slot, the 2-D outputs
//     straight out) and its stores (five tasks: a field's (level, column)
//     lines, lanes along longitude). For row J the order is the surface
//     cores of row J+1, half of row J's physics, the profiles of row J+1,
//     the rest of the physics, the stores of row J-1 and the copies of row
//     J + depth - 2. A task first waits for the tasks it reads from or
//     whose slots it overwrites, all earlier in the order, by counters of
//     finished tasks (and the copies' mbarriers): no barrier separates the
//     rows, and row J's column chains run beside row J+1's profiles and
//     row J-1's stores. The rings are deep enough that what a task waits
//     for was taken a row or more before it: the profiles' slot was last
//     read by the physics of rows J-3 and J-2, the copies' by the stores of
//     row J-2, and the surface cores read a row copied a row before.
// No thread reads what another block writes, so no ordering between blocks
// is needed, and a column's arithmetic does not depend on where a strip or
// run boundary falls: every output equals that of the tiled kernel this one
// replaced, bit for bit.

#include <cuda_runtime.h>

#include "column.cuh"
#include "constants.cuh"
#include "march.cuh"

// The block's dynamic shared memory (Ring's layout).
extern __shared__ __align__(16) float epi_smem[];
// dt and frac, read once a block from the device operand (Epi::scalars)
__shared__ float epi_scal[2];

namespace {

using namespace cm;

// threads a block: 32 warps where a column fits one register a lane (64
// registers a thread), else 8
template <int L>
__host__ __device__ constexpr int threads_for() { return L == 1 ? 1024 : 256; }

// Rows ahead of the physics whose surface cores and profiles are computed,
// rows of the profile ring, staged rows of the ring at least and at most.
// Row J's tasks compute the profiles of row J + kAhead, whose slot the
// physics of rows J - 3 and J - 2 read last (kProfRows = kAhead + 3), and
// copy row J + depth - 2, whose slot the stores of row J - 2 read last; so
// the profiles read rows up to J + kAhead + 1 staged a row earlier
// (depth >= kAhead + 4).
constexpr int kAhead = 1;
constexpr int kProfRows = kAhead + 3;
constexpr int kMinDepth = kAhead + 4;
constexpr int kMaxDepth = 8;
constexpr int kProfCols = 3;      // columns a profile task
constexpr int kCopyTasks = 5;     // a staged row's: pott, u, v, qv, qc
constexpr int kStoreTasks = 5;    // a row's: pott, u, v, qv, qc
enum Task { kCopy = 0, kSurf, kProf, kPhys, kStore };

struct Epi {
  // post-dynamics fields (the substep's output) and COLP_new
  const float *u, *v, *pott, *qv, *qc, *colp;
  // the 2-D state and forcing the physics reads
  const float *tsurf, *rain, *soil, *swflx, *lwflx;
  const float *land, *evap_eff, *hsurf, *vmask, *sigma_vb, *dsigma;
  float *u_out, *v_out, *pott_out, *qv_out, *qc_out;
  float *tsurf_out, *rain_out, *soil_out;
  int nz, ny, nx, tx, depth, blocks;
  int phys_cols;                    // columns a physics task
  int vec;                          // floats a copy or store moves
  const float* scalars;             // (dt, frac) on the card
  float ptop;
  int w_srf, w_trb, w_mic, w_soil, w_conv;
  float drag, soil_cap, ocean_cap, qc_thr, k_scalar, k_mom, sm_cap, conv_k,
      conv_rh;
};

// The surface core of a column, kept for its neighbours.
enum SurfSlot {
  kRho = 0, kWind, kShflx, kPSfc, kDpSfc, kTaux, kTauy, kDpottB, kNSurf
};
// The height profile of a column (turbulence.py): layer thickness dzc and
// density rc at the nz centres, centre-to-centre distance dzvb and density
// rvb at the nz-1 interior borders (index kb: between levels kb and kb+1).
enum ProfSlot { kDzc = 0, kRc, kDzvb, kRvb, kNProf };
// The 3-D fields of a staged row (pott with the west column).
enum Field3 { kPott = 0, kU, kV, kQv, kQc, kNField3 };

// Shared-memory layout, in floats; kernels/fused_substep.py::
// epilogue_smem_floats is the same formula. A staged row's 3-D fields are
// (field, level) lines at pitch P (march.cuh), longitude i0 + x at offset
// 4 + x (pott's west column at 3). Column c of a row's profiles is
// longitude i0 - 1 + c (c = 0 the west column); a profile (and the layer
// Exner factors pv beside it) keeps a column's levels at an odd pitch nzp.
struct Ring {
  int nz, P, nzp; // levels; pitch of a staged line; of a profile's column
  int tx, ex;     // strip columns at most; with the west one
  int row;                                  // a staged slot's floats
  int prof, surf, xs, pv, pslot;                // in a profile slot; its floats
  int fields, profs, sig, dsig, total;
  int depth;
  unsigned md;    // ceil(2^32 / depth)

  __host__ __device__ Ring(int nz_, int tx_, int depth_) {
    nz = nz_;
    depth = depth_;
    md = 0xffffffffu / depth + 1;
    P = pitch(tx_ + 4);
    nzp = nz | 1;
    tx = tx_;
    ex = tx + 1;
    row = kNField3 * nz * P;
    prof = 0;
    surf = prof + kNProf * ex * nzp;
    xs = surf + kNSurf * ex;
    pv = xs + ex;
    pslot = pv + ex * nzp;
    fields = 0;
    profs = fields + depth * row;         // kProfRows slots
    sig = profs + kProfRows * pslot;
    dsig = sig + nz + 1;
    total = dsig + nz;
  }

  // row r's slot in the staged rows (r % depth), by a multiply: r < 2^16
  __device__ __forceinline__ int slot(int r) const {
    return r - depth * (int)__umulhi((unsigned)r, md);
  }
  __device__ __forceinline__ int field_row(int r) const {
    return fields + slot(r) * row;
  }
  __device__ __forceinline__ int prof_row(int r) const {
    return profs + (r % kProfRows) * pslot;
  }
  // field f's level-0 line in the staged slot sr, at longitude i0
  __device__ __forceinline__ int line(int sr, int f) const {
    return sr + f * nz * P + 4;
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
// The surface core of column c of row j (longitude i0 - 1 + c; surface.py::
// surface_fluxes, the part a column and its neighbours share), a thread per
// column, from the row's staged slot sr and the 2-D fields in device
// memory into its profile slot pr: the surface border's Exner factor,
// then, with the surface on, rho, wind, the sensible flux, the surface
// pressure and layer mass, the stresses and the bottom layer's heating.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void surface_core(const Epi& e, const Ring& t,
                                             int sr, int pr, int j, int i0,
                                             int c) {
  float* sm = epi_smem;
  const int nz = e.nz, nx = e.nx, kb = nz - 1;
  const float* sig = sm + t.sig;
  const size_t at = (size_t)j * nx + wrap(i0 - 1 + c, nx);
  const float cn = __ldg(e.colp + at);
  const float x_sfc = surface_exner(sig, e.ptop, cn, nz);
  sm[pr + t.xs + c] = x_sfc;
  if (!e.w_srf) return;
  const float dt = epi_scal[0];
  // the bottom level's pressures and Exner factors, as Pressure has them
  const float lo_b = e.ptop + sig[kb] * cn;
  const float hi_b = e.ptop + sig[nz] * cn;
  const float x_lo = powf(div_rn(lo_b, kPRef, kRecipPRef), kKappa);
  const float pvtf_b = (hi_b * x_sfc - lo_b * x_lo)
                       / (kOnePlusKappa * (hi_b - lo_b));
  const float t_air = sm[t.line(sr, kPott) + kb * t.P + c - 1] * pvtf_b;
  const float p_air = 0.5f * (lo_b + hi_b);
  const float rho = p_air / (kRd * t_air);
  const size_t bottom = (size_t)kb * e.ny * nx;
  const float u_c = 0.5f * (__ldg(e.u + bottom + at)
                            + __ldg(e.u + bottom + (size_t)j * nx
                                    + wrap(i0 + c, nx)));
  const float vn = j + 1 < e.ny ? __ldg(e.v + bottom + at + nx) : 0.f;
  const float v_c = 0.5f * (__ldg(e.v + bottom + at) + vn);
  const float wind = sqrtf(u_c * u_c + v_c * v_c + 1.f);
  const float tsurf = __ldg(e.tsurf + at);
  const float shflx = rho * kCp * e.drag * wind * (tsurf - t_air);
  const float dp_sfc = cn * sm[t.dsig + kb];
  // bottom-layer heating of the sensible flux (surface.py::surface_step)
  const float m_sfc = dp_sfc / kG;
  float* sf = sm + pr + t.surf + c;
  sf[kRho * t.ex] = rho;
  sf[kWind * t.ex] = wind;
  sf[kShflx * t.ex] = shflx;
  sf[kPSfc * t.ex] = hi_b;
  sf[kDpSfc * t.ex] = dp_sfc;
  sf[kTaux * t.ex] = -rho * e.drag * wind * u_c;
  sf[kTauy * t.ex] = -rho * e.drag * wind * v_c;
  sf[kDpottB * t.ex] = dt * shflx / (kCp * m_sfc) / pvtf_b;
}

// ---------------------------------------------------------------------------
// The height profile of column c of row j (longitude i0 - 1 + c; staged
// slot sr, profile slot pr), a warp with the levels on the lanes, and its
// layer Exner factors (with the turbulence off, those alone).
// ---------------------------------------------------------------------------
template <int L>
__device__ __forceinline__ void column_profile(const Epi& e, const Ring& t,
                                               int sr, int pr, int j, int i0,
                                               int c) {
  // the profile of a column
  float* sm = epi_smem;
  const int nz = e.nz, kb = nz - 1;
  const int lane = lane_id();
  const size_t at = (size_t)j * e.nx + wrap(i0 - 1 + c, e.nx);
  const float cn = __ldg(e.colp + at);
  const float* ptc = sm + t.line(sr, kPott) + c - 1;
  float pt[L];
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    pt[m] = k < nz ? ptc[k * t.P] : 0.f;
  }
  Pressure<L> p;
  p.compute(sm + t.sig, e.ptop, cn, nz, sm[pr + t.xs + c]);
  // the layer Exner factors, for the column's physics (Layers)
  float* pv = sm + pr + t.pv + c * t.nzp;
#pragma unroll
  for (int m = 0; m < L; ++m)
    if (m * 32 + lane < nz) pv[m * 32 + lane] = p.pvtf[m];
  const float dpott_b = e.w_srf ? sm[pr + t.surf + kDpottB * t.ex + c] : 0.f;
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
  const float phivb_sfc = kG * __ldg(e.hsurf + at);
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
  float* pf = sm + pr + t.prof + c * t.nzp;
  const int plane = t.ex * t.nzp;
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    if (k < nz) {
      const float dzc = div_rn(phivb_lo[m], kG, kRecipG)
                        - div_rn(phivb_hi[m], kG, kRecipG);
      pf[kDzc * plane + k] = dzc;
      pf[kRc * plane + k] = (p.hi[m] - p.lo[m]) / (kG * dzc);
      if (k < kb) {
        pf[kDzvb * plane + k] = zc[m] - zc_below[m];
        pf[kRvb * plane + k] =
            p.hi[m] / (kRd * (0.5f * (tair[m] + tair_below[m])));
      }
    }
  }
}

// A column's border pressures and layer Exner factors as Pressure<L> has
// them at its levels (padding lanes hold other finite values), the factors
// read from pv, where the column's profile task stored them: the physics
// does not raise the borders to kappa again.
template <int L>
struct Layers {
  float lo[L], hi[L], pvtf[L];

  __device__ __forceinline__ Layers(const float* sigma_vb, float ptop,
                                    float cn, int nz, const float* pv) {
    const int lane = lane_id();
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const int k = m * 32 + lane, kk = k < nz ? k : nz - 1;
      lo[m] = k < nz ? ptop + sigma_vb[k] * cn : kPRef;
      hi[m] = ptop + sigma_vb[kk + 1] * cn;
      pvtf[m] = pv[kk];
    }
  }
};

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

// The profile at a (the column's first level in a profile slot) or, with
// b, the face profile: the mean of b's and a's, in that order, into
// registers.
template <int L>
__device__ __forceinline__ void load_profile(const Ring& t, const float* a,
                                             const float* b, int nz,
                                             float (&dzc)[L], float (&rc)[L],
                                             float (&dzvb)[L],
                                             float (&rvb)[L]) {
  const int lane = lane_id();
  const int plane = t.ex * t.nzp;
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    const int kk = k < nz ? k : nz - 1;
    const int kv = k < nz - 1 ? k : 0;
    dzc[m] = a[kDzc * plane + kk];
    rc[m] = a[kRc * plane + kk];
    dzvb[m] = a[kDzvb * plane + kv];
    rvb[m] = a[kRvb * plane + kv];
    if (b) {
      dzc[m] = 0.5f * (b[kDzc * plane + kk] + dzc[m]);
      rc[m] = 0.5f * (b[kRc * plane + kk] + rc[m]);
      dzvb[m] = 0.5f * (b[kDzvb * plane + kv] + dzvb[m]);
      rvb[m] = 0.5f * (b[kRvb * plane + kv] + rvb[m]);
    }
  }
}

// ---------------------------------------------------------------------------
// The physics of column (j, i0 + x), in registers: its staged slot sr, the
// profile slots of its row (pr) and of the row south (ps).
// ---------------------------------------------------------------------------
template <int L>
__device__ __forceinline__ void column_physics(const Epi& e, const Ring& t,
                                               int sr, int pr, int ps, int j,
                                               int i0, int x) {
  // the physics of a column
  float* sm = epi_smem;
  const int nz = e.nz, kb = nz - 1, nx = e.nx;
  const int lane = lane_id();
  const float dt = epi_scal[0];
  const int i = i0 + x;
  const int id2 = j * nx + i;
  const int c = x + 1;                              // this column's
  const int cw = x;                                 // the west column's
  const int psc = j == 0 ? pr : ps;                 // the south (clamped)
  // the column's levels in the staged lines, P apart
  float* ptc = sm + t.line(sr, kPott) + x;
  float* ou = sm + t.line(sr, kU) + x;
  float* ov = sm + t.line(sr, kV) + x;
  float* oqv = sm + t.line(sr, kQv) + x;
  float* oqc = sm + t.line(sr, kQc) + x;
  float pt[L], qv[L], qc[L], u[L], v[L];
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int k = m * 32 + lane;
    const int kk = (k < nz ? k : 0) * t.P;
    pt[m] = ptc[kk];
    u[m] = ou[kk];
    v[m] = ov[kk];
    qv[m] = oqv[kk];
    qc[m] = oqc[kk];
  }
  const float cn = __ldg(e.colp + id2);
  const float land = __ldg(e.land + id2);
  float tsurf = __ldg(e.tsurf + id2);
  float rain = __ldg(e.rain + id2), sm_ = __ldg(e.soil + id2);
  // the v wall (apply_wall of the TPU kernel); "+ 0" as in fused_substep.cu
  const float vm = e.vmask ? e.vmask[j] : 0.f;
  auto wall = [&]() {
#pragma unroll
    for (int m = 0; m < L; ++m)
      v[m] = e.vmask ? v[m] * vm + 0.f : (j == 0 ? 0.f : v[m]);
  };

  // ---- surface ----
  if (e.w_srf) {
    auto surf = [&](int slot, int at, int col) {
      return sm[at + t.surf + slot * t.ex + col];
    };
    const float qsat_s = qsat_water(tsurf, surf(kPSfc, pr, c));
    float eff = __ldg(e.evap_eff + id2);
    if (e.w_soil) {
      float frac = sm_ / e.sm_cap;
      frac = frac < 0.f ? 0.f : (frac > 1.f ? 1.f : frac);
      eff = land > 0.5f ? frac : 1.f;
    }
    const float evap = surf(kRho, pr, c) * e.drag * surf(kWind, pr, c) * eff
                       * relu(qsat_s - at_level(qv, kb));
    const float lhflx = kLv * evap;
    const float heat_cap = land > 0.5f ? e.soil_cap : e.ocean_cap;
    const float net = __ldg(e.swflx + id2) + __ldg(e.lwflx + id2)
                      - surf(kShflx, pr, c) - lhflx;
    tsurf = tsurf + dt * net / heat_cap;

    const float m_sfc = surf(kDpSfc, pr, c) / kG;
    add_at_level(pt, kb, surf(kDpottB, pr, c));
    add_at_level(qv, kb, dt * evap / m_sfc);
    const float m_u = 0.5f * (surf(kDpSfc, pr, cw) + surf(kDpSfc, pr, c)) / kG;
    const float m_v = 0.5f * (surf(kDpSfc, psc, c) + surf(kDpSfc, pr, c)) / kG;
    add_at_level(u, kb,
                 dt * 0.5f * (surf(kTaux, pr, cw) + surf(kTaux, pr, c)) / m_u);
    add_at_level(v, kb,
                 dt * 0.5f * (surf(kTauy, psc, c) + surf(kTauy, pr, c)) / m_v);
    wall();
    if (e.w_soil && land > 0.5f) {
      const float dried = sm_ - dt * evap / kRhoWater;
      sm_ = dried < 0.f ? 0.f : (dried > e.sm_cap ? e.sm_cap : dried);
    }
  }

  const Layers<L> p(sm + t.sig, e.ptop, cn, nz, sm + pr + t.pv + c * t.nzp);

  // ---- turbulence ----
  if (e.w_trb) {
    float dzc[L], rc[L], dzvb[L], rvb[L], kk[L];
    const float* pf = sm + pr + t.prof + c * t.nzp;
    load_profile(t, pf, (const float*)nullptr, nz, dzc, rc, dzvb, rvb);
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
      diffuse(pt, kk, d, nz, dt);
      diffuse(qv, kk, d, nz, dt);
      diffuse(qc, kk, d, nz, dt);
    }
#pragma unroll
    for (int m = 0; m < L; ++m) {
      qv[m] = relu(qv[m]);
      qc[m] = relu(qc[m]);
      kk[m] = e.k_mom;
    }
    // u with the profile averaged over the west column and this one
    load_profile(t, pf, pf - t.nzp, nz, dzc, rc, dzvb, rvb);
    diffuse(u, kk, Divisors<L>(dzc, rc, dzvb, rvb), nz, dt);
    // v with the south column (clamped at the wall)
    load_profile(t, pf, sm + psc + t.prof + c * t.nzp, nz, dzc, rc, dzvb,
                 rvb);
    diffuse(v, kk, Divisors<L>(dzc, rc, dzvb, rvb), nz, dt);
    wall();
  }

  // ---- microphysics ----
  if (e.w_mic) {
    const float frac_ac = epi_scal[1];
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
      const float to_rain = relu(qc[m] - e.qc_thr) * frac_ac;
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
      ptc[k * t.P] = pt[m];
      ou[k * t.P] = u[m];
      ov[k * t.P] = v[m];
      oqv[k * t.P] = qv[m];
      oqc[k * t.P] = qc[m];
    }
  }
  if (lane == 0) {
    e.tsurf_out[id2] = tsurf;
    e.rain_out[id2] = rain;
    e.soil_out[id2] = sm_;
  }
}

// ---------------------------------------------------------------------------
// Copies and stores, a warp, lanes along the floats of a line in turn (a
// line shorter than the warp shares a pass with the next), so consecutive
// lanes touch consecutive longitudes.
// ---------------------------------------------------------------------------

// A line's items: nv copies of vec floats, then ns single floats, then (with
// west) longitude i0 - 1; item `it`'s first column x (x = -1 the west one)
// and its floats.
__device__ __forceinline__ void line_item(int it, int nv, int ns, int vec,
                                          int& x, int& n) {
  n = it < nv ? vec : 1;
  x = it < nv ? it * vec : it < nv + ns ? nv * vec + it - nv : -1;
}

// A 3-D field's (level) lines of the strip's ncol columns from src (level
// 0's row at longitude i0, levels plane apart; the west column at offset
// iw from it) into the staged lines from dst (march.cuh's layout): lpp
// lines at a time, a lane an item, the levels in turn.
__device__ __forceinline__ void copy_field(const float* src, int dst, int P,
                                           size_t plane, int nz, int ncol,
                                           int vec, bool west, int iw) {
  const int nv = ncol / vec, ns = ncol - nv * vec;
  const int items = nv + ns + (west ? 1 : 0);
  const int lpp = max(1, 32 / items), sub = lane_id() / items;
  if (sub >= lpp) return;
  for (int it = lane_id() - sub * items; it < items; it += 32) {
    int x, n;
    line_item(it, nv, ns, vec, x, n);
    const float* from = src + (x < 0 ? iw : x) + sub * plane;
    unsigned to = shared_addr(epi_smem + dst + x + sub * P);
    const size_t step = lpp * plane;
    for (int k = sub; k < nz; k += lpp, from += step, to += 4 * lpp * P)
      cp_async(to, from, 4 * n);
  }
}

// A 3-D field's lines of the strip's ncol columns back to device memory:
// src the staged line of level 0, dst level 0's row at longitude i0; lpp
// lines at a time, as copy_field.
__device__ __forceinline__ void store_field(const float* src, int P,
                                            float* dst, size_t plane, int nz,
                                            int ncol, int vec) {
  const int nv = ncol / vec, ns = ncol - nv * vec, items = nv + ns;
  const int lpp = max(1, 32 / items), sub = lane_id() / items;
  if (sub >= lpp) return;
  for (int it = lane_id() - sub * items; it < items; it += 32) {
    int x, n;
    line_item(it, nv, ns, vec, x, n);
    const float* from = src + x + sub * P;
    float* to = dst + x + sub * plane;
    const size_t step = lpp * plane;
    for (int k = sub; k < nz; k += lpp, from += lpp * P, to += step) {
      if (n == 4)
        *reinterpret_cast<float4*>(to) =
            *reinterpret_cast<const float4*>(from);
      else if (n == 2)
        *reinterpret_cast<float2*>(to) =
            *reinterpret_cast<const float2*>(from);
      else
        *to = *from;
    }
  }
}

// ---------------------------------------------------------------------------
// A block's run: segments of rows of one strip, each warmed up, then walked
// row by row through the tasks of the header.
// ---------------------------------------------------------------------------
struct Counters {
  // by staged slot: an mbarrier that the copies of the slot's row arrive
  // on as they land (each lane of each of its copy tasks once)
  unsigned long long landed[kMaxDepth];
  int ticket;                   // tasks taken
  int surf[kProfRows];          // surface tasks finished, by profile slot
  int prof[kProfRows];          // profile tasks finished, by profile slot
  int phys[kProfRows];          // physics tasks finished, by profile slot
  int stores[kMaxDepth];        // store tasks finished, by staged slot
};

// The tasks of segment jA .. jB-1 of the strip at i0; kept in shared
// memory, so that no warp holds it in registers.
struct Plan {
  int i0, ncol;                 // the strip
  int jA, jB, last;             // rows; the last row staged
  int r_lo, r_mid, r_hi;        // rows staged by the warm-up; its surface
                                // cores read up to r_mid
  int nrows0;                   // rows of the warm-up's surface cores and
                                // profiles, from j_first
  int j_first;                  // the first row profiled
  int nsurf, nprof, nphys;      // surface, profile and physics tasks a row
  int depth;
  int ncopy0, nfirst;           // the warm-up's tasks
};

__device__ __forceinline__ int row_tasks(const Plan& p, int J) {
  if (J == p.jB) return kStoreTasks;                // the last row's stores
  return (J + kAhead < p.jB ? p.nsurf + p.nprof : 0) + p.nphys
         + (J > p.jA ? kStoreTasks : 0)
         + (J + p.depth - 2 <= p.last ? kCopyTasks : 0);
}

// The copies of staged row r have landed: the slot's mbarrier has completed
// the phase of the slot's ((r - r_lo) / depth)-th row of the segment.
__device__ __forceinline__ void wait_row(const Ring& t, const Plan& p,
                                         Counters& c, int r) {
  if (r < p.r_lo || r > p.last) return;
  barrier_wait(&c.landed[t.slot(r)], ((r - p.r_lo) / p.depth) & 1);
}

// The surface tasks, the profile tasks, the physics or the stores of row r
// are finished.
__device__ __forceinline__ void wait_surf(const Plan& p, Counters& c,
                                          int r) {
  if (r >= p.j_first)
    wait_for(&c.surf[r % kProfRows],
             p.nsurf * ((r - p.j_first) / kProfRows + 1));
}

__device__ __forceinline__ void wait_prof(const Plan& p, Counters& c,
                                          int r) {
  if (r >= p.j_first)
    wait_for(&c.prof[r % kProfRows],
             p.nprof * ((r - p.j_first) / kProfRows + 1));
}

__device__ __forceinline__ void wait_phys(const Plan& p, Counters& c,
                                          int r) {
  if (r >= p.jA)
    wait_for(&c.phys[r % kProfRows],
             p.nphys * ((r - p.jA) / kProfRows + 1));
}

__device__ __forceinline__ void wait_stores(const Ring& t, const Plan& p,
                                            Counters& c, int r) {
  if (r >= p.jA)
    wait_for(&c.stores[t.slot(r)], kStoreTasks * ((r - p.jA) / p.depth + 1));
}

// The copies of field f of staged row r (pott, u, v, qv or qc): the row
// below a segment stages pott alone.
__device__ __forceinline__ void copy_row(const Epi& e, const Ring& t,
                                         const Plan& p, int r, int f) {
  // the copies of a staged row
  const int nz = e.nz, ny = e.ny, nx = e.nx, i0 = p.i0, ncol = p.ncol;
  const int sr = t.field_row(r);
  const bool below = r == p.jA - 1;
  const size_t plane = (size_t)ny * nx;
  {
    // pott of the row below the segment; every field of the segment's rows
    if (below && f != kPott) return;
    const float* src = (f == kPott ? e.pott : f == kU ? e.u : f == kV ? e.v
                        : f == kQv ? e.qv : e.qc) + (size_t)r * nx + i0;
    copy_field(src, t.line(sr, f), t.P, plane, nz, ncol, e.vec, f == kPott,
               wrap(i0 - 1, nx) - i0);
    return;
  }
}

// Copy task f of staged row r, once the row its slot held is read: the
// stores of row r - depth, or the profiles of the warm-up's row below the
// segment. Each lane arrives on the slot's mbarrier when its copies land;
// the warp does not wait for them.
__device__ void copy_task(const Epi& e, const Ring& t, const Plan& p,
                          Counters& c, int r, int f) {
  const int prev = r - p.depth;
  if (prev >= p.jA) wait_stores(t, p, c, prev);
  else if (prev == p.jA - 1 && prev >= 0) wait_prof(p, c, prev);
  copy_row(e, t, p, r, f);
  arrive_on_copies(&c.landed[t.slot(r)]);
}

// The surface cores of columns part, part + nsurf, ... of row r, a lane a
// column.
__device__ __forceinline__ void surface_cores(const Epi& e, const Ring& t,
                                              const Plan& p, int r,
                                              int part) {
  // the surface cores of a row
  const int col = part + p.nsurf * lane_id();
  if (col <= p.ncol)
    surface_core(e, t, t.field_row(r), t.prof_row(r), r, p.i0, col);
}

// Surface task `part` of row r, once the profile slot's last row
// (r - kProfRows) is read by the physics of that row and the next, and then
// rows r and r+1 are staged. In that order: the physics' rows are done
// only after the rows that their slots held before r and r+1 have landed,
// so that the parity an mbarrier wait reads names the phase of r or r+1.
__device__ void surf_task(const Epi& e, const Ring& t, const Plan& p,
                          Counters& c, int r, int part) {
  wait_phys(p, c, r - kProfRows);
  wait_phys(p, c, r - kProfRows + 1);
  wait_row(t, p, c, r);
  surface_cores(e, t, p, r, part);
  finished(&c.surf[r % kProfRows]);
}

// Profile task q of row r (columns kProfCols q ..), once its surface cores
// are finished.
template <int L>
__device__ void prof_task(const Epi& e, const Ring& t, const Plan& p,
                          Counters& c, int r, int q) {
  wait_surf(p, c, r);
  const int end = min((q + 1) * kProfCols, p.ncol + 1);
  for (int col = q * kProfCols; col < end; ++col)
    column_profile<L>(e, t, t.field_row(r), t.prof_row(r), r, p.i0, col);
  finished(&c.prof[r % kProfRows]);
}

// Physics task q of row J (columns phys_cols q ..), once the profiles of
// rows J and J-1 are finished (with them the surface cores and the staged
// rows they read).
template <int L>
__device__ void phys_task(const Epi& e, const Ring& t, const Plan& p,
                          Counters& c, int J, int q) {
  wait_row(t, p, c, J);
  wait_prof(p, c, J);
  if (J > 0) wait_prof(p, c, J - 1);
  const int end = min((q + 1) * e.phys_cols, p.ncol);
  for (int x = q * e.phys_cols; x < end; ++x)
    column_physics<L>(e, t, t.field_row(J), t.prof_row(J),
                      J > 0 ? t.prof_row(J - 1) : 0, J, p.i0, x);
  finished(&c.phys[J % kProfRows]);
}

// The stores of field f (pott, u, v, qv, qc) of row J.
__device__ __forceinline__ void store_row(const Epi& e, const Ring& t,
                                          const Plan& p, int J, int f) {
  // the stores of a row
  float* dst = f == kPott ? e.pott_out : f == kU ? e.u_out : f == kV ? e.v_out
             : f == kQv ? e.qv_out : e.qc_out;
  store_field(epi_smem + t.line(t.field_row(J), f), t.P,
              dst + (size_t)J * e.nx + p.i0, (size_t)e.ny * e.nx, e.nz,
              p.ncol, e.vec);
}

// Store task f of row J, once its physics is finished.
__device__ void store_task(const Epi& e, const Ring& t, const Plan& p,
                           Counters& c, int J, int f) {
  wait_phys(p, c, J);
  store_row(e, t, p, J, f);
  finished(&c.stores[t.slot(J)]);
}

// Rows jA .. jB-1 of strip s. The order of the tasks: the warm-up (the
// copies of rows jA-1 .. jA+1, the surface cores and then the profiles of
// rows jA-1 and jA, the rest of the warm-up's copies, up to row
// jA + depth - 2); then each row's (row_tasks; the header's order); then the
// last row's stores.
template <int L>
__device__ void segment(const Epi& e, const Ring& t, int s, int jA, int jB,
                        Plan& p, Counters& c) {
  if (threadIdx.x == 0) {
    const int strips = (e.nx + e.tx - 1) / e.tx;
    p.i0 = strip_start(e.nx, strips, s);
    p.ncol = strip_start(e.nx, strips, s + 1) - p.i0;
    p.jA = jA;
    p.jB = jB;
    p.depth = e.depth;
    p.last = jB - 1;
    p.r_lo = max(jA - 1, 0);
    p.r_mid = min(jA + kAhead, p.last);
    p.r_hi = min(jA + e.depth - 3, p.last);
    p.j_first = jA > 0 ? jA - 1 : jA;
    p.nsurf = (p.ncol + 32) / 32;
    p.nprof = (p.ncol + kProfCols) / kProfCols;
    p.nphys = (p.ncol + e.phys_cols - 1) / e.phys_cols;
    p.ncopy0 = (p.r_mid - p.r_lo + 1) * kCopyTasks;
    p.nrows0 = min(jA + kAhead - 1, jB - 1) - p.j_first + 1;
    p.nfirst = p.ncopy0 + p.nrows0 * (p.nsurf + p.nprof)
               + (p.r_hi - p.r_mid) * kCopyTasks;
    c.ticket = 0;
    for (int q = 0; q < kMaxDepth; ++q) {
      barrier_init(&c.landed[q], kCopyTasks * 32);
      c.stores[q] = 0;
    }
    for (int q = 0; q < kProfRows; ++q) c.surf[q] = c.prof[q] = c.phys[q] = 0;
  }
  __syncthreads();

  // a warp's place in the order: row J's tasks start at ticket `start`
  int J = jA, start = p.nfirst;
  for (;;) {
    int q = 0;
    if (lane_id() == 0) q = atomicAdd(&c.ticket, 1);
    q = __shfl_sync(kFull, q, 0);
    // the task: its kind, its row and its index among the row's of its kind
    int kind, r, idx;
    if (q < p.nfirst) {                       // the warm-up
      if (q < p.ncopy0) {
        kind = kCopy, r = p.r_lo + q / kCopyTasks, idx = q % kCopyTasks;
      } else if ((q -= p.ncopy0) < p.nrows0 * p.nsurf) {
        kind = kSurf, r = p.j_first + q / p.nsurf, idx = q % p.nsurf;
      } else if ((q -= p.nrows0 * p.nsurf) < p.nrows0 * p.nprof) {
        kind = kProf, r = p.j_first + q / p.nprof, idx = q % p.nprof;
      } else {
        q -= p.nrows0 * p.nprof;
        kind = kCopy, r = p.r_mid + 1 + q / kCopyTasks, idx = q % kCopyTasks;
      }
    } else {
      while (J <= jB && q >= start + row_tasks(p, J)) {
        start += row_tasks(p, J);
        ++J;
      }
      if (J > jB) break;
      q -= start;
      const int nsurf = J + kAhead < jB ? p.nsurf : 0;
      const int nprof = J + kAhead < jB ? p.nprof : 0;
      const int nstore = J > jA ? kStoreTasks : 0;
      const int half = p.nphys / 2;
      if (J == jB)
        kind = kStore, r = jB - 1, idx = q;
      else if (q < nsurf)
        kind = kSurf, r = J + kAhead, idx = q;
      else if ((q -= nsurf) < half)
        kind = kPhys, r = J, idx = q;
      else if ((q -= half) < nprof)
        kind = kProf, r = J + kAhead, idx = q;
      else if ((q -= nprof) < p.nphys - half)
        kind = kPhys, r = J, idx = half + q;
      else if ((q -= p.nphys - half) < nstore)
        kind = kStore, r = J - 1, idx = q;
      else
        kind = kCopy, r = J + p.depth - 2, idx = q - nstore;
    }
    switch (kind) {
      case kCopy: copy_task(e, t, p, c, r, idx); break;
      case kSurf: surf_task(e, t, p, c, r, idx); break;
      case kProf: prof_task<L>(e, t, p, c, r, idx); break;
      case kPhys: phys_task<L>(e, t, p, c, r, idx); break;
      default: store_task(e, t, p, c, r, idx);
    }
  }
  __syncthreads();
}

template <int L>
__global__ void __launch_bounds__(threads_for<L>(), 1)
epilogue_kernel(Epi args) {
  __shared__ Plan plan;
  __shared__ Counters counters;
  const Epi& e = args;
  const Ring t(e.nz, e.tx, e.depth);
  // dt and frac, read once a block; the first barrier publishes them
  if (threadIdx.x < 2) epi_scal[threadIdx.x] = __ldg(e.scalars + threadIdx.x);
  for (int q = threadIdx.x; q <= e.nz; q += threads_for<L>()) {
    epi_smem[t.sig + q] = e.sigma_vb[q];
    if (q < e.nz) epi_smem[t.dsig + q] = e.dsigma[q];
  }
  __syncthreads();
  for_each_segment(e.ny, e.nx, e.tx, e.blocks, [&](int s, int jA, int jB) {
    segment<L>(e, t, s, jA, jB, plan, counters);
  });
}

template <int L>
int launch(const Epi& e, int smem, cudaStream_t s) {
  static int opted = 48 * 1024;                   // the default limit
  const int err = allow_smem(epilogue_kernel<L>, smem, opted);
  if (err) return err;
  epilogue_kernel<L><<<e.blocks, threads_for<L>(), smem, s>>>(e);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (kernels/fused_substep.py), called
// after cm_fused_substep_f32 on the same stream. vmask may be null (the
// index rule); scalars points to the float[2] (dt, frac) on the card. tx,
// depth, blocks and smem_bytes are the plan (launch_plan: the strip width,
// the ring depth, the persistent grid and the shared memory). A plan whose
// shared memory falls short of the ring's layout, 2 > nz > 128, a tx other
// than 4, 8, 16 or 32, a depth outside 5..6, no block, an empty grid or a
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
    int nz, int ny, int nx, int tx, int depth, int blocks, int phys_cols,
    int smem_bytes, const float* scalars, float ptop,
    int w_srf, int w_trb, int w_mic, int w_soil, int w_conv,
    float drag, float soil_cap, float ocean_cap, float qc_thr,
    float k_scalar, float k_mom, float sm_cap, float conv_k, float conv_rh,
    void* stream) {
  if (nz < 2 || nz > 128 || !(tx == 4 || tx == 8 || tx == 16 || tx == 32)
      || depth < kMinDepth || depth > kMaxDepth || blocks < 1 || ny < 1
      || nx < 1 || phys_cols < 1 || phys_cols > 32 || scalars == nullptr
      || smem_bytes < (int)sizeof(float) * Ring(nz, tx, depth).total)
    return (int)cudaErrorInvalidValue;
  const float* fields[] = {u, v, pott, qv, qc, u_out, v_out, pott_out,
                           qv_out, qc_out};
  Epi e{u, v, pott, qv, qc, colp, tsurf, rain, soil, swflx, lwflx,
        land, evap_eff, hsurf, vmask, sigma_vb, dsigma,
        u_out, v_out, pott_out, qv_out, qc_out, tsurf_out, rain_out, soil_out,
        nz, ny, nx, tx, depth, blocks, phys_cols, copy_width(nx, fields, 10),
        scalars, ptop,
        w_srf, w_trb, w_mic, w_soil, w_conv, drag, soil_cap, ocean_cap,
        qc_thr, k_scalar, k_mom, sm_cap, conv_k, conv_rh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((nz + 31) / 32) {
    case 1: return launch<1>(e, smem_bytes, s);
    case 2: return launch<2>(e, smem_bytes, s);
    case 3: return launch<3>(e, smem_bytes, s);
    case 4: return launch<4>(e, smem_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}
