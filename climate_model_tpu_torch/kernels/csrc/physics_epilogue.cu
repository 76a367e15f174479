// The physics epilogue of the Matsuno corrector: surface, turbulence and
// microphysics on the post-dynamics fields, hand-written CUDA C++ for
// Hopper (sm_90a), fp32.
//
// Replaces the epilogue of the TPU kernel climate_model_tpu/kernels/
// fused_substep.py::make_fused_substep_packed with phys= (the body at
// :777-989, launched by the packed scan's corrector, climate_model_tpu/
// model.py:119-120). It is the third launch of that corrector: launches 1
// and 2 (fused_substep.cu) write the post-dynamics u, v, pott, qv, qc and
// COLP_new, this one writes the step's final fields. It computes, with
// pressure and Exner factors of the NEW colp:
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
// Every physics switch and parameter is a launch argument, and so is dt:
// adaptive dt and retuning rebuild nothing. The operator order and the
// association of every expression follow the plain PyTorch splits
// (physics/surface.py, turbulence.py, microphysics.py), which are the plain
// version this kernel is held to.
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
// Why one thread per column, and why it recomputes its neighbours: the
// drag at the west (south) face needs the stress of column (j, i-1)
// ((j-1, i)), and the diffusion of u (v) needs the dz and rho profiles of
// that column AFTER its surface heating. A thread therefore recomputes the
// surface fluxes and the profile of its west and south columns from the
// post-dynamics fields, which no thread of this launch writes: no thread
// reads what another writes, and no ordering between blocks is needed.
// A thread keeps 15 column arrays (five fields, the convective K, a
// neighbour's pott, and its own and a face's height profile): in local
// memory for columns of up to kMaxNz levels; for taller columns in its
// slice of a device workspace that the wrapper allocates (kColArrays * nz
// floats per column, epilogue_kernel<false>), so every nz >= 2 runs.
//
// What bounds it on the card: bytes. With launches 1-2 the corrector must
// read the 16 3-D fields of the corrector and about ten 2-D fields and write
// five 3-D and four 2-D fields: at config #3 (360x180x32 fp32, 8.3 MB per
// 3-D field) about 135 MB, >= 40 us at 3.35 TB/s. This simple design moves
// five more 3-D fields out and back (the post-dynamics scratch, ~83 MB),
// re-reads the neighbour columns and keeps the column arrays in local
// memory. A later version would run the epilogue on the tile of the point
// launch, from shared memory, and write each field once.

#include <cuda_runtime.h>

#include "constants.cuh"

namespace {

using namespace cm;

constexpr int kMaxNz = 64;      // tallest column held in local memory
constexpr int kColArrays = 15;  // column arrays per thread

struct Epi {
  // post-dynamics fields (launch 2's output) and COLP_new (launch 1's)
  const float *u, *v, *pott, *qv, *qc, *colp;
  // the 2-D state and forcing the physics reads
  const float *tsurf, *rain, *soil, *swflx, *lwflx;
  const float *land, *evap_eff, *hsurf, *vmask, *sigma_vb, *dsigma;
  float *u_out, *v_out, *pott_out, *qv_out, *qc_out;
  float *tsurf_out, *rain_out, *soil_out;
  float* work;  // kColArrays * nz floats per column, or null (nz <= kMaxNz)
  int nz, ny, nx;
  float dt, ptop, frac;
  int w_srf, w_trb, w_mic, w_soil, w_conv;
  float drag, soil_cap, ocean_cap, qc_thr, k_scalar, k_mom, sm_cap, conv_k,
      conv_rh;

  __device__ int at(int k, int j, int i) const { return (k * ny + j) * nx + i; }
  __device__ int at2(int j, int i) const { return j * nx + i; }
};

// x clipped below at 0, NaN passing through (torch.clamp(x, min=0))
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// Border pressures, Exner factors and the layer Exner factor of level k of
// a column with COLP cn (operators.py::diagnose_pressure).
struct Level {
  float pvb_lo, pvb_hi, pvtfvb_lo, pvtfvb_hi, pvtf;
};

__device__ Level level(const Epi& e, float cn, int k) {
  Level p;
  p.pvb_lo = e.ptop + e.sigma_vb[k] * cn;
  p.pvb_hi = e.ptop + e.sigma_vb[k + 1] * cn;
  p.pvtfvb_lo = powf(p.pvb_lo / kPRef, kKappa);
  p.pvtfvb_hi = powf(p.pvb_hi / kPRef, kKappa);
  p.pvtf = (p.pvb_hi * p.pvtfvb_hi - p.pvb_lo * p.pvtfvb_lo)
           / (kOnePlusKappa * (p.pvb_hi - p.pvb_lo));
  return p;
}

// physics/thermo.py::qsat_water (Magnus)
__device__ float qsat_water(float tair, float pair) {
  const float t_c = tair - kTZeroC;
  const float es = kMagnusE0 * expf(kMagnusA * t_c / (t_c + kMagnusB));
  float denom = pair - kOneMinusEps * es;
  denom = denom < 1.f ? 1.f : denom;
  return kEps * es / denom;
}

// The part of surface.py::surface_fluxes a column and its neighbours share.
struct Surf {
  float rho, wind, u_c, v_c, shflx, pvtf_b, p_sfc, dp_sfc;
  __device__ float taux(float drag) const { return -rho * drag * wind * u_c; }
  __device__ float tauy(float drag) const { return -rho * drag * wind * v_c; }
};

__device__ Surf surface_core(const Epi& e, int j, int i) {
  const int kb = e.nz - 1;
  const int ie = i == e.nx - 1 ? 0 : i + 1;
  const float cn = e.colp[e.at2(j, i)];
  const Level p = level(e, cn, kb);
  Surf s;
  s.pvtf_b = p.pvtf;
  s.p_sfc = p.pvb_hi;
  const float t_air = e.pott[e.at(kb, j, i)] * p.pvtf;
  const float p_air = 0.5f * (p.pvb_lo + p.pvb_hi);
  s.rho = p_air / (kRd * t_air);
  s.u_c = 0.5f * (e.u[e.at(kb, j, i)] + e.u[e.at(kb, j, ie)]);
  const float vn = j + 1 < e.ny ? e.v[e.at(kb, j + 1, i)] : 0.f;
  s.v_c = 0.5f * (e.v[e.at(kb, j, i)] + vn);
  s.wind = sqrtf(s.u_c * s.u_c + s.v_c * s.v_c + 1.f);
  s.shflx = s.rho * kCp * e.drag * s.wind * (e.tsurf[e.at2(j, i)] - t_air);
  s.dp_sfc = cn * e.dsigma[kb];
  return s;
}

// Bottom-layer heating of the sensible flux (surface.py::surface_step).
__device__ float bottom_heating(const Epi& e, const Surf& s) {
  const float m_sfc = s.dp_sfc / kG;
  return e.dt * s.shflx / (kCp * m_sfc) / s.pvtf_b;
}

// Height-coordinate geometry of a column for the K-diffusion
// (turbulence.py): layer thickness dzc and density rc at the nz centres,
// centre-to-centre distance dzvb and density rvb at the nz-1 interior
// borders (index kb: between levels kb and kb+1). The geopotential is the
// hydrostatic suffix sum from the surface up (operators.py::
// diagnose_geopotential), so the walk runs bottom to top.
struct Profile {
  float *dzc, *rc, *dzvb, *rvb;
};

// The profile whose four arrays start at p, stride apart.
__device__ Profile profile_at(float* p, int stride) {
  return Profile{p, p + stride, p + 2 * stride, p + 3 * stride};
}

__device__ void copy_profile(int nz, const Profile& src, Profile& dst) {
  for (int k = 0; k < nz; ++k) {
    dst.dzc[k] = src.dzc[k];
    dst.rc[k] = src.rc[k];
    dst.dzvb[k] = src.dzvb[k];
    dst.rvb[k] = src.rvb[k];
  }
}

__device__ void column_profile(const Epi& e, float cn, float hs,
                               const float* pt, Profile& pr) {
  const float phivb_sfc = kG * hs;
  float phivb_hi = phivb_sfc, suffix = 0.f;
  float zc_below = 0.f, tair_below = 0.f;
  for (int k = e.nz - 1; k >= 0; --k) {
    const Level p = level(e, cn, k);
    const float cppt = kCp * pt[k];
    suffix = suffix + cppt * (p.pvtfvb_hi - p.pvtfvb_lo);
    const float phivb_lo = phivb_sfc + suffix;
    const float phi = phivb_hi + cppt * (p.pvtfvb_hi - p.pvtf);
    const float zc = phi / kG;
    pr.dzc[k] = phivb_lo / kG - phivb_hi / kG;
    pr.rc[k] = (p.pvb_hi - p.pvb_lo) / (kG * pr.dzc[k]);
    const float tair = pt[k] * p.pvtf;
    if (k < e.nz - 1) {
      pr.dzvb[k] = zc - zc_below;
      pr.rvb[k] = p.pvb_hi / (kRd * (0.5f * (tair + tair_below)));
    }
    zc_below = zc;
    tair_below = tair;
    phivb_hi = phivb_lo;
  }
}

// Face profile: the mean of a column's and its neighbour's (in place in nb).
__device__ void face_profile(int nz, const Profile& own, Profile& nb) {
  for (int k = 0; k < nz; ++k) {
    nb.dzc[k] = 0.5f * (nb.dzc[k] + own.dzc[k]);
    nb.rc[k] = 0.5f * (nb.rc[k] + own.rc[k]);
    if (k < nz - 1) {
      nb.dzvb[k] = 0.5f * (nb.dzvb[k] + own.dzvb[k]);
      nb.rvb[k] = 0.5f * (nb.rvb[k] + own.rvb[k]);
    }
  }
}

// One explicit K-diffusion step of the column x, in place: upward-positive
// flux at the interior borders, zero at top and bottom. kk is the
// diffusivity per border (null: the constant k).
__device__ void diffuse(const Epi& e, float* x, const float* kk, float k,
                        const Profile& pr) {
  float f_top = 0.f;
  for (int l = 0; l < e.nz; ++l) {
    float f_bot = 0.f;
    if (l < e.nz - 1) {
      const float grad = (x[l] - x[l + 1]) / pr.dzvb[l];
      f_bot = -(kk ? kk[l] : k) * pr.rvb[l] * grad;
    }
    x[l] = x[l] + e.dt * (f_bot - f_top) / (pr.rc[l] * pr.dzc[l]);
    f_top = f_bot;
  }
}

// pott column of (j, i) from the post-dynamics field, its bottom layer
// raised by dpott_b (that column's surface heating)
__device__ void load_pott(const Epi& e, int j, int i, float dpott_b,
                          float* pt) {
  for (int k = 0; k < e.nz; ++k) pt[k] = e.pott[e.at(k, j, i)];
  pt[e.nz - 1] = pt[e.nz - 1] + dpott_b;
}

template <bool kLocal>
__global__ void epilogue_kernel(Epi e) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= e.nx) return;
  const int nz = e.nz, kb = nz - 1;
  const int iw = i == 0 ? e.nx - 1 : i - 1;
  const int js = j > 0 ? j - 1 : 0;
  const int id2 = e.at2(j, i);

  // the thread's column arrays: local memory, or its workspace slice
  float in_local[kLocal ? kColArrays * kMaxNz : 1];
  const int stride = kLocal ? kMaxNz : nz;
  float* buf = kLocal ? in_local
                      : e.work + (size_t)id2 * kColArrays * (size_t)nz;
  float* pt = buf;
  float* qv = buf + stride;
  float* qc = buf + 2 * stride;
  float* u = buf + 3 * stride;
  float* v = buf + 4 * stride;
  for (int k = 0; k < nz; ++k) {
    const int id = e.at(k, j, i);
    pt[k] = e.pott[id];
    qv[k] = e.qv[id];
    qc[k] = e.qc[id];
    u[k] = e.u[id];
    v[k] = e.v[id];
  }
  const float cn = e.colp[id2];
  const float land = e.land[id2];
  float tsurf = e.tsurf[id2], rain = e.rain[id2], sm = e.soil[id2];
  // the v wall (apply_wall of the TPU kernel); "+ 0" as in fused_substep.cu
  const float vm = e.vmask ? e.vmask[j] : 0.f;
  auto wall = [&]() {
    for (int k = 0; k < nz; ++k)
      v[k] = e.vmask ? v[k] * vm + 0.f : (j == 0 ? 0.f : v[k]);
  };

  // ---- surface ----
  float dpott_w = 0.f, dpott_s = 0.f;   // the west and south bottom heating
  if (e.w_srf) {
    const Surf c = surface_core(e, j, i);
    const Surf w = surface_core(e, j, iw);
    const Surf s = js == j ? c : surface_core(e, js, i);
    const float qsat_s = qsat_water(tsurf, c.p_sfc);
    float eff = e.evap_eff[id2];
    if (e.w_soil) {
      float frac = sm / e.sm_cap;
      frac = frac < 0.f ? 0.f : (frac > 1.f ? 1.f : frac);
      eff = land > 0.5f ? frac : 1.f;
    }
    const float evap =
        c.rho * e.drag * c.wind * eff * relu(qsat_s - qv[kb]);
    const float lhflx = kLv * evap;
    const float heat_cap = land > 0.5f ? e.soil_cap : e.ocean_cap;
    const float net = e.swflx[id2] + e.lwflx[id2] - c.shflx - lhflx;
    tsurf = tsurf + e.dt * net / heat_cap;

    const float m_sfc = c.dp_sfc / kG;
    pt[kb] = pt[kb] + bottom_heating(e, c);
    qv[kb] = qv[kb] + e.dt * evap / m_sfc;
    const float m_u = 0.5f * (w.dp_sfc + c.dp_sfc) / kG;
    const float m_v = 0.5f * (s.dp_sfc + c.dp_sfc) / kG;
    u[kb] = u[kb] + e.dt * 0.5f * (w.taux(e.drag) + c.taux(e.drag)) / m_u;
    v[kb] = v[kb] + e.dt * 0.5f * (s.tauy(e.drag) + c.tauy(e.drag)) / m_v;
    wall();
    if (e.w_soil && land > 0.5f) {
      float dried = sm - e.dt * evap / kRhoWater;
      sm = dried < 0.f ? 0.f : (dried > e.sm_cap ? e.sm_cap : dried);
    }
    dpott_w = bottom_heating(e, w);
    dpott_s = bottom_heating(e, s);
  }

  // ---- turbulence ----
  if (e.w_trb) {
    Profile own = profile_at(buf + 7 * stride, stride);
    Profile nb = profile_at(buf + 11 * stride, stride);
    column_profile(e, cn, e.hsurf[id2], pt, own);
    // moist-convective K at the interior borders (turbulence.py::
    // convective_k), from the post-surface column
    float* kk = buf + 5 * stride;
    if (e.w_conv) {
      float rh_up = 0.f, th_up = 0.f;
      for (int k = 0; k < nz; ++k) {
        const Level p = level(e, cn, k);
        const float tair = pt[k] * p.pvtf;
        const float qs = qsat_water(tair, 0.5f * (p.pvb_lo + p.pvb_hi));
        const float rh = qv[k] / (qs < 1e-10f ? 1e-10f : qs);
        const float th_es = pt[k] * expf(kLv * qs / (kCp * tair));
        if (k > 0) {
          const bool fire = (rh_up < rh ? rh_up : rh) > e.conv_rh
                            && th_up < th_es;
          kk[k - 1] = e.k_scalar + (fire ? e.conv_k : 0.f);
        }
        rh_up = rh;
        th_up = th_es;
      }
    }
    const float* ks = e.w_conv ? kk : nullptr;
    diffuse(e, pt, ks, e.k_scalar, own);
    diffuse(e, qv, ks, e.k_scalar, own);
    diffuse(e, qc, ks, e.k_scalar, own);
    for (int k = 0; k < nz; ++k) {
      qv[k] = relu(qv[k]);
      qc[k] = relu(qc[k]);
    }
    // u with the profile averaged over the west column and this one
    float* col = buf + 6 * stride;
    load_pott(e, j, iw, dpott_w, col);
    column_profile(e, e.colp[e.at2(j, iw)], e.hsurf[e.at2(j, iw)], col, nb);
    face_profile(nz, own, nb);
    diffuse(e, u, nullptr, e.k_mom, nb);
    // v with the south column (clamped at the wall)
    if (js == j) {
      copy_profile(nz, own, nb);
    } else {
      load_pott(e, js, i, dpott_s, col);
      column_profile(e, e.colp[e.at2(js, i)], e.hsurf[e.at2(js, i)], col,
                     nb);
    }
    face_profile(nz, own, nb);
    diffuse(e, v, nullptr, e.k_mom, nb);
    wall();
  }

  // ---- microphysics ----
  if (e.w_mic) {
    float rain_sum = 0.f;
    for (int k = 0; k < nz; ++k) {
      const Level p = level(e, cn, k);
      const float tair = pt[k] * p.pvtf;
      const float qs = qsat_water(tair, 0.5f * (p.pvb_lo + p.pvb_hi));
      const float gamma = 1.f + kLv2 * qs / (kCpRv * (tair * tair));
      const float dq = (qv[k] - qs) / gamma;
      const float cond = relu(dq);
      const float ndq = relu(-dq);
      const float evp = qc[k] < ndq ? qc[k] : ndq;
      const float dqc = cond - evp;
      qv[k] = qv[k] - dqc;
      qc[k] = qc[k] + dqc;
      pt[k] = pt[k] + kLvOverCp * dqc / p.pvtf;
      const float to_rain = relu(qc[k] - e.qc_thr) * e.frac;
      qc[k] = relu(qc[k] - to_rain);
      qv[k] = relu(qv[k]);
      rain_sum = rain_sum + to_rain * (cn * e.dsigma[k]);
    }
    const float rain_inc = rain_sum / kG;
    rain = rain + rain_inc;
    if (e.w_soil && land > 0.5f) {
      const float wet = sm + rain_inc / kRhoWater;
      sm = wet > e.sm_cap ? e.sm_cap : wet;
    }
  }

  for (int k = 0; k < nz; ++k) {
    const int id = e.at(k, j, i);
    e.u_out[id] = u[k];
    e.v_out[id] = v[k];
    e.pott_out[id] = pt[k];
    e.qv_out[id] = qv[k];
    e.qc_out[id] = qc[k];
  }
  e.tsurf_out[id2] = tsurf;
  e.rain_out[id2] = rain;
  e.soil_out[id2] = sm;
}

}  // namespace

// Plain C interface, loaded with ctypes (kernels/fused_substep.py), called
// after cm_fused_substep_f32 on the same stream. vmask may be null (the
// index rule). work: kColArrays * nz floats per column when nz > kMaxNz,
// else ignored (may be null). Returns cudaGetLastError() after the launch;
// 0 is success.
extern "C" int cm_physics_epilogue_f32(
    const float* u, const float* v, const float* pott, const float* qv,
    const float* qc, const float* colp,
    const float* tsurf, const float* rain, const float* soil,
    const float* swflx, const float* lwflx,
    const float* land, const float* evap_eff, const float* hsurf,
    const float* vmask, const float* sigma_vb, const float* dsigma,
    float* u_out, float* v_out, float* pott_out, float* qv_out,
    float* qc_out, float* tsurf_out, float* rain_out, float* soil_out,
    float* work, int nz, int ny, int nx, float dt, float ptop,
    float frac,
    int w_srf, int w_trb, int w_mic, int w_soil, int w_conv,
    float drag, float soil_cap, float ocean_cap, float qc_thr,
    float k_scalar, float k_mom, float sm_cap, float conv_k, float conv_rh,
    void* stream) {
  if (nz < 2 || (nz > kMaxNz && !work)) return (int)cudaErrorInvalidValue;
  Epi e{u, v, pott, qv, qc, colp, tsurf, rain, soil, swflx, lwflx,
        land, evap_eff, hsurf, vmask, sigma_vb, dsigma,
        u_out, v_out, pott_out, qv_out, qc_out, tsurf_out, rain_out, soil_out,
        nz > kMaxNz ? work : nullptr, nz, ny, nx, dt, ptop, frac,
        w_srf, w_trb, w_mic, w_soil, w_conv, drag, soil_cap, ocean_cap,
        qc_thr, k_scalar, k_mom, sm_cap, conv_k, conv_rh};
  const int threads = 128;
  const dim3 cols((nx + threads - 1) / threads, ny);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nz <= kMaxNz)
    epilogue_kernel<true><<<cols, threads, 0, s>>>(e);
  else
    epilogue_kernel<false><<<cols, threads, 0, s>>>(e);
  return (int)cudaGetLastError();
}
