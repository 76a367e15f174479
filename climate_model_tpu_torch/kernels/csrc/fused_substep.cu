// One full Matsuno substep of the dycore (tendencies + mass-weighted update),
// hand-written CUDA C++ for Hopper (sm_90a), fp32.
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
// is a third launch, in physics_epilogue.cu, on the fields written here.
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
// climate_model_tpu/dist/packed_halo.py). The shard-local variant is these
// launches on a shard's block, unchanged: the lon index still wraps, so
// the outermost columns of a block narrower than the circle read the far
// side's ghost columns. That is wrong data, as the TPU kernel's clamp
// (make_fused_substep_packed(..., wrap_lon=False),
// climate_model_tpu/kernels/fused_substep.py:392-398) is, and the chain
// radius below keeps it in the ghost columns, whose outputs belong to the
// neighbouring shard and are overwritten by the next exchange. The v wall
// comes from the block's rows of the global mask. Latitude needs no
// argument: a block's ghost rows are ordinary rows, and the wall rules of
// rows 0 and ny-1 run where the block ends, which is the pole on a
// polar-edge shard and a ghost row elsewhere. The seam strips of the
// halo-overlap schedule are the same launches again, on a strip-shaped
// block (3 freshly exchanged ghost rows and 6 rows of the shard).
//
// Why 3 ghost rows and columns suffice. Launch 2 at (j, i) reads launch 1's
// outputs at (j, i), (j, i-1) and (j-1, i), and the inputs at most two
// columns west (colp of the face flux uflx(j, i-1)), two rows south (colp of
// vflx(j-1, i)), one column east and one row north; launch 1 reads one
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
// Two launches per substep, because the horizontal stencils of the update
// read column-integrated intermediates at NEIGHBOUR columns:
//   1. column_kernel, one thread per (j, i) column walking k: flux divergence
//      -> dCOLP/dt (prefix sum over k) -> COLP_new and the sigma velocity at
//      the interior borders; Exner factors and the hydrostatic geopotential
//      (suffix sum over k). Writes COLP_new (the colp output) and three
//      scratch fields the wrapper allocates: wwind (nz+1, ny, nx), phi and
//      pvtf (nz, ny, nx).
//   2. point_kernel, one thread per (k, j, i): flux-form advection of
//      pott/qv/qc with the radiative source and diffusion, u/v momentum
//      (advection, Coriolis and metric terms, pressure gradient, diffusion),
//      the mass-weighted update, the qv/qc >= 0 clip and the v wall.
//
// What bounds it on the card: bytes. It does ~10^2 flops per point on data it
// must read from device memory; at config #3 (360x180x32 fp32, 8.3 MB per
// 3-D field) the predictor must move 11 3-D fields (u, v, pott, qv, qc and
// the radiative heating in, five fields out: 91 MB, >= 27 us at 3.35 TB/s)
// and the corrector 16 (the five base fields too: 133 MB, >= 40 us). This
// simple design moves more: the scratch fields go out and back, and every
// neighbour read goes to L1/L2 instead of registers. A later version would
// keep a tile of latitude rows with a one-row halo in shared memory, run the
// two k-scans in registers, and finish the substep in one launch.

#include <cuda_runtime.h>

#include "constants.cuh"

namespace {

using namespace cm;

// GEO_FIELDS order (kernels/fused_substep.py)
enum Geo {
  kArea = 0, kAreaV, kDx, kDxs, kCorf, kCorfV, kTanLat, kTanLatV,
  kKdiffUV, kKdiffPott, kKdiffMoist, kNGeo
};

struct Args {
  const float *u, *v, *pott, *qv, *qc, *colp;        // evaluation state
  const float *ub, *vb, *pottb, *qvb, *qcb, *colpb;  // base state
  const float *hsurf, *rad, *geo, *sigma_vb, *dsigma;
  const float* vmask;                                // (ny,) or null
  float *u_out, *v_out, *pott_out, *qv_out, *qc_out, *colp_out;
  float *wwind, *phi, *pvtf;                         // scratch
  int nz, ny, nx;
  float dt, dy, dy2, ptop;
  int with_rad, with_diff;
};

struct Idx {
  int nx, ny;
  __device__ int at(int k, int j, int i) const { return (k * ny + j) * nx + i; }
  __device__ int at2(int j, int i) const { return j * nx + i; }
};

// ---------------------------------------------------------------------------
// Launch 1: column scans.
// ---------------------------------------------------------------------------
__global__ void column_kernel(Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= a.nx) return;
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  const Idx x{nx, ny};
  const int iw = i == 0 ? nx - 1 : i - 1;
  const int ie = i == nx - 1 ? 0 : i + 1;
  const int js = j > 0 ? j - 1 : 0;
  const bool has_n = j + 1 < ny;

  const float ce = a.colp[x.at2(j, i)];
  const float colp_u = 0.5f * (a.colp[x.at2(j, iw)] + ce);
  const float colp_u_e = 0.5f * (ce + a.colp[x.at2(j, ie)]);
  const float colp_v = 0.5f * (a.colp[x.at2(js, i)] + ce);
  const float colp_v_n = has_n ? 0.5f * (ce + a.colp[x.at2(j + 1, i)]) : 0.f;
  const float* g = a.geo + j * kNGeo;
  const float area = g[kArea];
  const float dxs = g[kDxs];
  const float dxs_n = has_n ? a.geo[(j + 1) * kNGeo + kDxs] : 0.f;

  // pass 1: flux divergence, its prefix sum over k (parked in wwind[k+1])
  float csum = 0.f;
  for (int k = 0; k < nz; ++k) {
    const float uflx = a.u[x.at(k, j, i)] * colp_u * a.dy;
    const float uflx_e = a.u[x.at(k, j, ie)] * colp_u_e * a.dy;
    const float vflx = j == 0 ? 0.f : a.v[x.at(k, j, i)] * colp_v * dxs;
    const float vflx_n = has_n ? a.v[x.at(k, j + 1, i)] * colp_v_n * dxs_n : 0.f;
    const float div = (uflx_e - uflx + vflx_n - vflx) / area;
    csum += div * a.dsigma[k];
    if (k < nz - 1) a.wwind[x.at(k + 1, j, i)] = csum;
  }
  const float dcolpdt = -csum;
  const float cn = a.colpb[x.at2(j, i)] + a.dt * dcolpdt;
  a.colp_out[x.at2(j, i)] = cn;

  // pass 2: sigma velocity at the interior borders; zero at top and bottom
  a.wwind[x.at(0, j, i)] = 0.f;
  a.wwind[x.at(nz, j, i)] = 0.f;
  for (int kb = 1; kb < nz; ++kb) {
    const int id = x.at(kb, j, i);
    a.wwind[id] = -(a.wwind[id] + a.sigma_vb[kb] * dcolpdt) / cn;
  }

  // Exner factors and geopotential, surface upward (suffix sum of the
  // border-to-border jumps)
  const float ghs = kG * a.hsurf[x.at2(j, i)];
  float pb_hi = a.ptop + a.sigma_vb[nz] * ce;
  float pt_hi = powf(pb_hi / kPRef, kKappa);
  float suffix = 0.f;
  for (int k = nz - 1; k >= 0; --k) {
    const float pb_lo = a.ptop + a.sigma_vb[k] * ce;
    const float pt_lo = powf(pb_lo / kPRef, kKappa);
    const float pvtf = (pb_hi * pt_hi - pb_lo * pt_lo)
                       / (kOnePlusKappa * (pb_hi - pb_lo));
    const float cppt = kCp * a.pott[x.at(k, j, i)];
    a.pvtf[x.at(k, j, i)] = pvtf;
    a.phi[x.at(k, j, i)] = (ghs + suffix) + cppt * (pt_hi - pvtf);
    suffix += cppt * (pt_hi - pt_lo);
    pb_hi = pb_lo;
    pt_hi = pt_lo;
  }
}

// ---------------------------------------------------------------------------
// Launch 2: tendencies and update at one point.
// ---------------------------------------------------------------------------
template <bool SAME_BASE>
__global__ void point_kernel(Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx) return;
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  const Idx x{nx, ny};
  const int iw = i == 0 ? nx - 1 : i - 1;
  const int ie = i == nx - 1 ? 0 : i + 1;
  const int js = j > 0 ? j - 1 : 0;
  const bool has_n = j + 1 < ny;
  const int jn = has_n ? j + 1 : j;                 // north clamp
  const float* g = a.geo + j * kNGeo;
  const float area = g[kArea], area_v = g[kAreaV], dx = g[kDx];
  const float dx2 = dx * dx;
  const float* colp = a.colp;
  const float* cnp = a.colp_out;                    // COLP_new (launch 1)
  const float* colpb = SAME_BASE ? a.colp : a.colpb;
  const int id = x.at(k, j, i);
  const int id2 = x.at2(j, i);

  // face-averaged COLP
  const float ce = colp[id2];
  auto colp_u_at = [&](int jj, int ii) {
    const int iiw = ii == 0 ? nx - 1 : ii - 1;
    return 0.5f * (colp[x.at2(jj, iiw)] + colp[x.at2(jj, ii)]);
  };
  auto colp_v_at = [&](int jj, int ii) {
    const int jjs = jj > 0 ? jj - 1 : 0;
    return 0.5f * (colp[x.at2(jjs, ii)] + colp[x.at2(jj, ii)]);
  };
  // mass fluxes at u faces and (wall-zeroed) v faces of level k
  auto uflx = [&](int jj, int ii) {
    return a.u[x.at(k, jj, ii)] * colp_u_at(jj, ii) * a.dy;
  };
  auto vflx = [&](int jj, int ii) {
    if (jj == 0 || jj >= ny) return 0.f;
    return a.v[x.at(k, jj, ii)] * colp_v_at(jj, ii) * a.geo[jj * kNGeo + kDxs];
  };
  const float colp_u = colp_u_at(j, i);
  const float colp_v = colp_v_at(j, i);
  const float uf = uflx(j, i), uf_e = uflx(j, ie), uf_w = uflx(j, iw);
  const float vf = vflx(j, i), vf_n = vflx(j + 1, i);

  const float cn = cnp[id2];
  const float cb = colpb[id2];
  const float dsig = a.dsigma[k];
  auto wwind = [&](int kb, int jj, int ii) { return a.wwind[x.at(kb, jj, ii)]; };

  // ---- scalars: pott (radiative source), qv, qc ----
  const float* qs[3] = {a.pott, a.qv, a.qc};
  const float* qbs[3] = {SAME_BASE ? a.pott : a.pottb, SAME_BASE ? a.qv : a.qvb,
                         SAME_BASE ? a.qc : a.qcb};
  float* qouts[3] = {a.pott_out, a.qv_out, a.qc_out};
  const float w_top = wwind(k, j, i), w_bot = wwind(k + 1, j, i);
  for (int s = 0; s < 3; ++s) {
    const float* q = qs[s];
    const float qc_ = q[id];
    const float qw = q[x.at(k, j, iw)], qe = q[x.at(k, j, ie)];
    const float qsn = q[x.at(k, js, i)];
    const float qn = has_n ? q[x.at(k, j + 1, i)] : 0.f;
    const float fx = uf * 0.5f * (qw + qc_);
    const float fx_e = uf_e * 0.5f * (qc_ + qe);
    const float fy = vf * 0.5f * (qsn + qc_);
    const float fy_n = has_n ? vf_n * 0.5f * (qc_ + qn) : 0.f;
    float dqdt = -(fx_e - fx + fy_n - fy) / area;
    const float fz_top = k > 0 ? w_top * cn * (0.5f * (q[x.at(k - 1, j, i)] + qc_)) : 0.f;
    const float fz_bot = k < nz - 1 ? w_bot * cn * (0.5f * (qc_ + q[x.at(k + 1, j, i)])) : 0.f;
    dqdt = dqdt - (fz_bot - fz_top) / dsig;
    if (s == 0 && a.with_rad) dqdt = dqdt + ce * a.rad[id];
    if (a.with_diff) {
      const float coef = s == 0 ? g[kKdiffPott] : g[kKdiffMoist];
      const float qnc = has_n ? qn : qc_;
      const float lap = (qe - 2.f * qc_ + qw) / dx2 + (qnc - 2.f * qc_ + qsn) / a.dy2;
      dqdt = dqdt + coef * ce * lap;
    }
    const float qb = SAME_BASE ? qc_ : qbs[s][id];
    float qnew = (qb * cb + a.dt * dqdt) / cn;
    if (s > 0) qnew = qnew < 0.f ? 0.f : qnew;     // NaN passes through
    qouts[s][id] = qnew;
  }

  const float* u = a.u;
  const float* v = a.v;
  const float* phi = a.phi;
  const float* pvtf = a.pvtf;
  const float* pott = a.pott;

  // ---- u momentum at the west face of (j, i) ----
  {
    const float uc = u[id], ue = u[x.at(k, j, ie)], uw = u[x.at(k, j, iw)];
    const float us = u[x.at(k, js, i)];
    const float fxc = 0.5f * (uf + uf_e) * 0.5f * (uc + ue);
    const float fxc_w = 0.5f * (uf_w + uf) * 0.5f * (uw + uc);
    const float fyc = 0.5f * (vflx(j, iw) + vf) * 0.5f * (us + uc);
    const float fyc_n = has_n
        ? 0.5f * (vflx(j + 1, iw) + vf_n) * 0.5f * (uc + u[x.at(k, j + 1, i)])
        : 0.f;
    const float adv = -(fxc - fxc_w + fyc_n - fyc) / area;

    const float cn_u = 0.5f * (cnp[x.at2(j, iw)] + cn);
    float fz_top = 0.f, fz_bot = 0.f;
    if (k > 0) {
      const float w_u = 0.5f * (wwind(k, j, iw) + wwind(k, j, i));
      fz_top = w_u * cn_u * (0.5f * (u[x.at(k - 1, j, i)] + uc));
    }
    if (k < nz - 1) {
      const float w_u = 0.5f * (wwind(k + 1, j, iw) + wwind(k + 1, j, i));
      fz_bot = w_u * cn_u * (0.5f * (uc + u[x.at(k + 1, j, i)]));
    }
    const float vadv = -(fz_bot - fz_top) / dsig;

    const float vn = has_n ? v[x.at(k, j + 1, i)] : 0.f;
    const float vn_w = has_n ? v[x.at(k, j + 1, iw)] : 0.f;
    const float v_at_u = 0.25f * (v[x.at(k, j, iw)] + v[id] + vn_w + vn);
    const float cor = colp_u * (g[kCorf] + uc * g[kTanLat] / kREarth) * v_at_u;

    const float pott_u = 0.5f * (pott[x.at(k, j, iw)] + pott[id]);
    const float pgf = -colp_u * ((phi[id] - phi[x.at(k, j, iw)])
                                 + kCp * pott_u * (pvtf[id] - pvtf[x.at(k, j, iw)])) / dx;

    float dudt = adv + vadv + cor + pgf;
    if (a.with_diff) {
      const float un = u[x.at(k, jn, i)];
      const float lap = (ue - 2.f * uc + uw) / dx2 + (un - 2.f * uc + us) / a.dy2;
      dudt = dudt + g[kKdiffUV] * colp_u * lap;
    }
    const float ub = SAME_BASE ? uc : a.ub[id];
    const float cu_old = 0.5f * (colpb[x.at2(j, iw)] + cb);
    a.u_out[id] = (ub * cu_old + a.dt * dudt) / cn_u;
  }

  // ---- v momentum at the south face of (j, i) ----
  {
    if (j == 0 && !a.vmask) {                       // south wall, by index
      a.v_out[id] = 0.f;
      return;
    }
    const float vc = v[id], ve = v[x.at(k, j, ie)], vw = v[x.at(k, j, iw)];
    const float vs = v[x.at(k, js, i)];
    const float vn = has_n ? v[x.at(k, j + 1, i)] : 0.f;
    const float fyc = 0.5f * (vf + vf_n) * 0.5f * (vc + vn);
    const float fyc_s = 0.5f * (vflx(js, i) + vf) * 0.5f * (vs + vc);
    const float uf_s = uflx(js, i), uf_se = uflx(js, ie);
    const float fxc = 0.5f * (uf_s + uf) * 0.5f * (vw + vc);
    const float fxc_e = 0.5f * (uf_se + uf_e) * 0.5f * (vc + ve);
    const float adv = -(fxc_e - fxc + fyc - fyc_s) / area_v;

    const float cn_v = 0.5f * (cnp[x.at2(js, i)] + cn);
    float fz_top = 0.f, fz_bot = 0.f;
    if (k > 0) {
      const float w_v = 0.5f * (wwind(k, js, i) + wwind(k, j, i));
      fz_top = w_v * cn_v * (0.5f * (v[x.at(k - 1, j, i)] + vc));
    }
    if (k < nz - 1) {
      const float w_v = 0.5f * (wwind(k + 1, js, i) + wwind(k + 1, j, i));
      fz_bot = w_v * cn_v * (0.5f * (vc + v[x.at(k + 1, j, i)]));
    }
    const float vadv = -(fz_bot - fz_top) / dsig;

    const float u_at_v = 0.25f * (u[x.at(k, js, i)] + u[x.at(k, js, ie)]
                                  + u[id] + u[x.at(k, j, ie)]);
    const float cor = -colp_v * (g[kCorfV] + u_at_v * g[kTanLatV] / kREarth) * u_at_v;

    const float pott_v = 0.5f * (pott[x.at(k, js, i)] + pott[id]);
    const float pgf = -colp_v * ((phi[id] - phi[x.at(k, js, i)])
                                 + kCp * pott_v * (pvtf[id] - pvtf[x.at(k, js, i)])) / a.dy;

    float dvdt = adv + vadv + cor + pgf;
    if (a.with_diff) {
      const float lap = (ve - 2.f * vc + vw) / dx2 + (vn - 2.f * vc + vs) / a.dy2;
      dvdt = dvdt + g[kKdiffUV] * colp_v * lap;
    }
    const float vb = SAME_BASE ? vc : a.vb[id];
    const float cv_old = 0.5f * (colpb[x.at2(js, i)] + cb);
    const float vnew = (vb * cv_old + a.dt * dvdt) / cn_v;
    // the wall as data: 0 on wall rows. "+ 0" turns the -0 of a negative v
    // times 0 into +0, so the single-device mask equals the index rule bit
    // for bit
    a.v_out[id] = a.vmask ? vnew * a.vmask[j] + 0.f : vnew;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes (kernels/fused_substep.py). The
// predictor passes the evaluation state as the base (same_base=1). Returns
// cudaGetLastError() after the launches; 0 is success.
extern "C" int cm_fused_substep_f32(
    const float* u, const float* v, const float* pott, const float* qv,
    const float* qc, const float* colp,
    const float* ub, const float* vb, const float* pottb, const float* qvb,
    const float* qcb, const float* colpb,
    const float* hsurf, const float* rad, const float* geo,
    const float* sigma_vb, const float* dsigma, const float* vmask,
    float* u_out, float* v_out, float* pott_out, float* qv_out, float* qc_out,
    float* colp_out, float* wwind, float* phi, float* pvtf,
    int nz, int ny, int nx, float dt, float dy, float ptop,
    int same_base, int with_rad, int with_diff, void* stream) {
  Args a{u, v, pott, qv, qc, colp, ub, vb, pottb, qvb, qcb, colpb,
         hsurf, rad, geo, sigma_vb, dsigma, vmask,
         u_out, v_out, pott_out, qv_out, qc_out, colp_out, wwind, phi, pvtf,
         nz, ny, nx, dt, dy, (float)((double)dy * (double)dy), ptop,
         with_rad, with_diff};
  if (same_base) {
    a.ub = u; a.vb = v; a.pottb = pott; a.qvb = qv; a.qcb = qc; a.colpb = colp;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const dim3 cols((nx + threads - 1) / threads, ny);
  column_kernel<<<cols, threads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 pts((nx + threads - 1) / threads, ny, nz);
  if (same_base)
    point_kernel<true><<<pts, threads, 0, s>>>(a);
  else
    point_kernel<false><<<pts, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
