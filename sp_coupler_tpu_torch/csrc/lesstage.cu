// One full LES Runge-Kutta stage between two pressure projections, for
// NVIDIA Hopper (sm_90a). Replaces the Pallas TPU kernel
// sp_coupler_tpu/ops/lesstage_pallas.py::_kernel (driven through its
// _batched_call / stage_fused): saturation adjustment, Deardorff TKE
// closure, hybrid52 advection + diffusion of thl/qt/qr/e12, 2nd-order
// momentum advection + subgrid stress + surface drag, buoyancy, TKE
// sources, Coriolis, coupler forcings (qt modes 0-3), simpleice
// microphysics with sedimentation, sponge layer, and the RK axpy update
// with its clips.
//
// What bounds it: memory traffic. Per stage and instance it must read 7
// current fields (u, v, w, thl, qt, qr, e12) and 7 base fields and write 7
// updated fields; the arithmetic (~1.5k flops and ~10 transcendentals per
// point) is far below the card's float32 rate. The TPU kernel keeps whole
// 64x64 planes in VMEM and takes the slab means in-kernel. A Hopper block
// cannot hold that, and blocks run in no order, so this first version is
// three launches:
//   1. k_means:   one block per (instance, level): saturation adjustment
//                 and plane means of thv, thl, qt, u, v; on level 0 also
//                 <u*^2> and the surface rain flux.
//   2. k_closure: one thread per point: S^2, N^2, mixing length, Km, Kh
//                 and the TKE source, written to scratch; kmax by a warp
//                 max and atomicMax on the int bits of the (non-negative)
//                 float.
//   3. k_tend:    one thread per point: every tendency and the axpy.
//                 Stencil neighbours (+-3 in x/y, +-2 in z) come straight
//                 from global memory; they hit L1/L2, so device-memory
//                 traffic stays close to one read of each field plus the
//                 three scratch fields. Shared-memory tiling, TMA and
//                 fusing the passes are later work.
// The saturation adjustment is recomputed where a neighbour level needs
// it instead of being stored: it costs a few transcendentals, a stored
// copy costs device-memory bandwidth.
//
// Semantics kept from the TPU kernel: edge-replicated z halos for cell
// fields and profiles, w face nz identically zero, the global-z masks of
// the boundary one-sided differences, sign(0) == 0 in the 5th-order face
// value, log(0) = -inf -> exp(b * -inf) = 0 in the fall speed (b > 0 is
// checked by the wrapper), and the clips of the axpy.
//
// Plain C interface for ctypes: lesstage_stage(const StageArgs*, stream)
// returns cudaGetLastError() after the three launches.

#include <cuda_runtime.h>

namespace {

// physical constants, sp_coupler_tpu/constants.py (double, rounded once)
constexpr double D_PREF0 = 1.0e5, D_RD = 287.04, D_RV = 461.5, D_CP = 1004.0;
constexpr double D_RLV = 2.53e6, D_RLS = 2.84e6, D_GRAV = 9.81;
constexpr double D_ES0 = 610.78, D_TMELT = 273.16, D_AT_LIQ = 17.27;
constexpr double D_BT_LIQ = 35.86;

constexpr float PREF0 = (float)D_PREF0;
constexpr float RLV = (float)D_RLV;
constexpr float RV = (float)D_RV;
constexpr float CP = (float)D_CP;
constexpr float GRAV = (float)D_GRAV;
constexpr float ES0 = (float)D_ES0;
constexpr float TMELT = (float)D_TMELT;
constexpr float AT_LIQ = (float)D_AT_LIQ;
constexpr float BT_LIQ = (float)D_BT_LIQ;
constexpr float RD_CP = (float)(D_RD / D_CP);
constexpr float MRD_CP = (float)(-D_RD / D_CP);
constexpr float RD_RV = (float)(D_RD / D_RV);
constexpr float ONE_M_RD_RV = (float)(1.0 - D_RD / D_RV);
constexpr float RLV_CP = (float)(D_RLV / D_CP);
constexpr float EPS_I = (float)(D_RV / D_RD - 1.0);
constexpr float ICE_RAMP = (float)(D_TMELT - 250.0);

// subgrid constants, sp_coupler_tpu/models/les/subgrid.py
constexpr float KAPPA = 0.4f, CM = 0.12f, CH1 = 1.0f, CH2 = 2.0f;
constexpr float CE1 = 0.19f, CE2 = 0.51f, CN = 0.76f, E12_MIN = 1e-3f;

constexpr int NT = 256;  // threads per block

}  // namespace

extern "C" {

struct StageArgs {
  int n, nz, ny, nx, qt_mode, n_sat_iter;
  float dx, dy, dz, fdt, f_cor, sponge_depth, sponge_tau, zs, delta;
  float nc_fac, auto_k, accr_k, evap_tau, sed_a, sed_b, ice_tau, ice_qi0;
  float sed_ai, sed_bi;
  // current state: [n, nz, P] cells, w [n, nz+1, P] faces
  const float *u, *v, *w, *thl, *qt, *qr, *e12;
  // base state of the RK update, same layouts
  const float *ub, *vb, *wb, *thlb, *qtb, *qrb, *e12b;
  // profiles [n, nz] (rhobh [n, nz+1]) and per-instance scalars [n]
  const float *pbf, *rhobf, *rhobh, *f_u, *f_v, *f_thl, *f_qt;
  const float *dt, *wthl, *wqt, *z0m;
  // outputs: [n, nz, P] each; aux [n, 3] = kmax, <u*^2>, surface rain flux
  float *un, *vn, *wn, *thln, *qtn, *qrn, *e12n, *aux;
  // scratch: means [n, 5, nz] (thv, thl, qt, u, v); Km, Kh, src [n, nz, P]
  float *means, *Km, *Kh, *src;
};

}  // extern "C"

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ int clampz(int k, int nz) {
  return k < 0 ? 0 : (k >= nz ? nz - 1 : k);
}

__device__ __forceinline__ float qsat_liq(float T, float p) {
  float es = ES0 * expf(AT_LIQ * (T - TMELT) / (T - BT_LIQ));
  es = fminf(es, 0.9f * p);
  return RD_RV * es / (p - ONE_M_RD_RV * es);
}

// utils/thermo.sat_adjust: (T, ql, qs) from (thl, qt, p)
__device__ __forceinline__ void sat_adjust(float thl, float qt, float p,
                                           int n_iter, float& T, float& ql,
                                           float& qs) {
  const float ex = powf(p / PREF0, RD_CP);
  T = thl * ex;
  ql = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    qs = qsat_liq(T, p);
    const float dqsdt = qs * RLV / (RV * T * T);
    ql = fmaxf((qt - qs + dqsdt * (T - thl * ex)) / (1.0f + RLV_CP * dqsdt),
               0.f);
    T = thl * ex + RLV * ql / CP;
  }
  qs = qsat_liq(T, p);
}

__device__ __forceinline__ float thv_of(float thl, float qt, float qr,
                                        float p, int n_sat_iter) {
  float T, ql, qs;
  sat_adjust(thl, qt, p, n_sat_iter, T, ql, qs);
  const float iex = powf(p / PREF0, MRD_CP);
  return T * iex * (1.0f + EPS_I * (qt - ql) - ql - qr);
}

__device__ __forceinline__ float ice_frac(float T) {
  return fminf(fmaxf((TMELT - T) / ICE_RAMP, 0.f), 1.f);
}

// downward sedimentation flux rho vt qr; log(0) = -inf gives exp(-inf) = 0
__device__ __forceinline__ float sed_flux(const StageArgs& a, float rf,
                                          float qr, float T) {
  const float fi = ice_frac(T);
  const float lrq = logf(fmaxf(rf * qr, 0.f));
  const float vt = (1.0f - fi) * a.sed_a * expf(a.sed_b * lrq) +
                   fi * a.sed_ai * expf(a.sed_bi * lrq);
  return rf * vt * fmaxf(qr, 0.f);
}

// 5th-order upwind face value at face x' from s at x'-3 .. x'+2
__device__ __forceinline__ float face5(float sm3, float sm2, float sm1,
                                       float s0, float sp1, float sp2,
                                       float vel) {
  const float central =
      (37.0f * (sm1 + s0) - 8.0f * (sm2 + sp1) + (sm3 + sp2)) / 60.0f;
  const float upwind =
      (10.0f * (s0 - sm1) - 5.0f * (sp1 - sm2) + (sp2 - sm3)) / 60.0f;
  const float sg = vel > 0.f ? 1.f : (vel < 0.f ? -1.f : 0.f);
  return central - sg * upwind;
}

template <int NV>
__device__ __forceinline__ void block_sum(double (&v)[NV], double* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    for (int o = 16; o > 0; o >>= 1)
      v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < NV; ++j) sh[j * 32 + warp] = v[j];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      v[j] = lane < (NT >> 5) ? sh[j * 32 + lane] : 0.0;
      for (int o = 16; o > 0; o >>= 1)
        v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
    }
  }
}

// ---- pass 1: plane means -------------------------------------------------
// Sums are taken in float64 (free here): N^2 is a difference of the thv
// means of two adjacent levels (~300 K each, ~0.15 K apart on the
// 64x64x160 grid), and a float32 sum of 4096 values near 300 K carries up
// to ~5e-5 K of rounding.

__global__ void __launch_bounds__(NT) k_means(StageArgs a) {
  __shared__ double sh[7 * 32];
  const int k = blockIdx.x, b = blockIdx.y;
  const int nz = a.nz, nx = a.nx, P = a.ny * a.nx;
  const size_t base = ((size_t)b * nz + k) * P;
  const float p = a.pbf[b * nz + k];
  const float rf = a.rhobf[b * nz + k];
  float cd = 0.f;
  if (k == 0) {
    const float l = logf(0.5f * a.dz / fmaxf(a.z0m[b], 1e-6f));
    cd = (KAPPA / l) * (KAPPA / l);
  }
  double s[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < P; i += NT) {
    const float thl = a.thl[base + i], qt = a.qt[base + i];
    const float qr = a.qr[base + i];
    float T, ql, qs;
    sat_adjust(thl, qt, p, a.n_sat_iter, T, ql, qs);
    const float iex = powf(p / PREF0, MRD_CP);
    s[0] += T * iex * (1.0f + EPS_I * (qt - ql) - ql - qr);
    s[1] += thl;
    s[2] += qt;
    s[3] += a.u[base + i];
    s[4] += a.v[base + i];
    if (k == 0) {
      const int y = i / nx, x = i - y * nx;
      const float u1 = 0.5f * (a.u[base + i] + a.u[base + y * nx + wrap(x + 1, nx)]);
      const float v1 = 0.5f * (a.v[base + i] +
                               a.v[base + wrap(y + 1, a.ny) * nx + x]);
      const float U1 = sqrtf(u1 * u1 + v1 * v1 + 1e-4f);
      s[5] += cd * (U1 * U1);
      s[6] += sed_flux(a, rf, qr, T);
    }
  }
  block_sum<7>(s, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 5; ++j)
      a.means[((size_t)b * 5 + j) * nz + k] = (float)(s[j] / P);
    if (k == 0) {
      a.aux[b * 3 + 1] = (float)(s[5] / P);
      a.aux[b * 3 + 2] = (float)(s[6] / P);
    }
  }
}

// ---- pass 2: TKE closure --------------------------------------------------

__global__ void __launch_bounds__(NT) k_closure(StageArgs a) {
  const int i = blockIdx.x * NT + threadIdx.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int nz = a.nz, ny = a.ny, nx = a.nx, P = ny * nx;
  float km = 0.f;
  if (i < P) {
    const int y = i / nx, x = i - y * nx;
    const float* u = a.u + (size_t)b * nz * P;
    const float* v = a.v + (size_t)b * nz * P;
    const float* w = a.w + (size_t)b * (nz + 1) * P;
    auto C = [&](const float* f, int dk, int dy, int dx) {
      return f[((size_t)clampz(g + dk, nz) * ny + wrap(y + dy, ny)) * nx +
               wrap(x + dx, nx)];
    };
    auto Wf = [&](int dk, int dy, int dx) {
      int k = g + dk;
      if (k >= nz) return 0.f;  // rigid lid: face nz is zero
      if (k < 0) k = 0;
      return w[((size_t)k * ny + wrap(y + dy, ny)) * nx + wrap(x + dx, nx)];
    };
    auto uc = [&](int dk, int dy, int dx) {
      return 0.5f * (C(u, dk, dy, dx) + C(u, dk, dy, dx + 1));
    };
    auto vc = [&](int dk, int dy, int dx) {
      return 0.5f * (C(v, dk, dy, dx) + C(v, dk, dy + 1, dx));
    };
    auto wc = [&](int dy, int dx) { return 0.5f * (Wf(0, dy, dx) + Wf(1, dy, dx)); };
    const float dx = a.dx, dy = a.dy, dz = a.dz;
    const float bm = (g == 0 || g == nz - 1) ? 2.0f : 1.0f;
    const float dudx = (C(u, 0, 0, 1) - C(u, 0, 0, 0)) / dx;
    const float dvdy = (C(v, 0, 1, 0) - C(v, 0, 0, 0)) / dy;
    const float dwdz = (Wf(1, 0, 0) - Wf(0, 0, 0)) / dz;
    const float dudy = (uc(0, 1, 0) - uc(0, -1, 0)) / (2.0f * dy);
    const float dudz = bm * (uc(1, 0, 0) - uc(-1, 0, 0)) / (2.0f * dz);
    const float dvdx = (vc(0, 0, 1) - vc(0, 0, -1)) / (2.0f * dx);
    const float dvdz = bm * (vc(1, 0, 0) - vc(-1, 0, 0)) / (2.0f * dz);
    const float dwdx = (wc(0, 1) - wc(0, -1)) / (2.0f * dx);
    const float dwdy = (wc(1, 0) - wc(-1, 0)) / (2.0f * dy);
    const float S2 = 2.0f * (dudx * dudx + dvdy * dvdy + dwdz * dwdz) +
                     (dudy + dvdx) * (dudy + dvdx) +
                     (dudz + dwdx) * (dudz + dwdx) +
                     (dvdz + dwdy) * (dvdz + dwdy);
    const float* thvm = a.means + (size_t)b * 5 * nz;
    const float dthv =
        bm * (thvm[clampz(g + 1, nz)] - thvm[clampz(g - 1, nz)]) / (2.0f * dz);
    const float N2 = GRAV / fmaxf(thvm[g], 1.0f) * dthv;
    const size_t idx = ((size_t)b * nz + g) * P + i;
    const float e12 = fmaxf(a.e12[idx], E12_MIN);
    const float delta = a.delta;
    const float lam_stable = CN * e12 / sqrtf(fmaxf(N2, 1e-10f));
    const float lam = N2 > 1e-10f ? fminf(delta, lam_stable) : delta;
    const float Km = CM * lam * e12;
    const float Kh = (CH1 + CH2 * lam / delta) * Km;
    const float diss = (CE1 + CE2 * lam / delta) * (e12 * e12 * e12) / lam;
    a.Km[idx] = Km;
    a.Kh[idx] = Kh;
    a.src[idx] = (Km * S2 + (-Kh * N2) - diss) / (2.0f * e12);
    km = Km;
  }
  // Km >= 0: the int bits order like the floats
  const unsigned bits = __reduce_max_sync(0xffffffffu, __float_as_uint(km));
  if ((threadIdx.x & 31) == 0)
    atomicMax(reinterpret_cast<unsigned*>(a.aux + b * 3), bits);
}

// ---- pass 3: tendencies + RK axpy -----------------------------------------

__global__ void __launch_bounds__(NT) k_tend(StageArgs a) {
  const int i = blockIdx.x * NT + threadIdx.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int nz = a.nz, ny = a.ny, nx = a.nx, P = ny * nx;
  if (i >= P) return;
  const int y = i / nx, x = i - y * nx;
  const size_t off = (size_t)b * nz * P;
  const float *u = a.u + off, *v = a.v + off;
  const float *thl = a.thl + off, *qt = a.qt + off, *qr = a.qr + off;
  const float *e12 = a.e12 + off;
  const float *Kmf = a.Km + off, *Khf = a.Kh + off;
  const float* w = a.w + (size_t)b * (nz + 1) * P;
  const float dx = a.dx, dy = a.dy, dz = a.dz;

  auto C = [&](const float* f, int dk, int dy_, int dx_) {
    return f[((size_t)clampz(g + dk, nz) * ny + wrap(y + dy_, ny)) * nx +
             wrap(x + dx_, nx)];
  };
  auto Wf = [&](int dk, int dy_, int dx_) {
    int k = g + dk;
    if (k >= nz) return 0.f;  // rigid lid: face nz is zero
    if (k < 0) k = 0;
    return w[((size_t)k * ny + wrap(y + dy_, ny)) * nx + wrap(x + dx_, nx)];
  };
  auto prof = [&](const float* p, int dk) { return p[b * nz + clampz(g + dk, nz)]; };

  const float dtv = a.dt[b];
  const float rf = prof(a.rhobf, 0);
  const float m0 = g == 0 ? 0.f : 1.f;
  const float rf_m1 = prof(a.rhobf, -1) * m0;
  const float rh_lo = a.rhobh[b * (nz + 1) + g];
  const float rh_hi = a.rhobh[b * (nz + 1) + g + 1];
  const float irf = 1.0f / (rf * dz);
  const float irh = 1.0f / (rh_lo * dz);
  const float fmv = (g == 0 || g == nz - 1) ? 0.f : 1.f;
  const float fm_m1 = (g - 1 <= 0 || g - 1 == nz - 1) ? 0.f : 1.f;
  const float sfc = g == 0 ? rh_lo * irf : 0.f;

  const float u0 = C(u, 0, 0, 0), um = C(u, -1, 0, 0), up = C(u, 1, 0, 0);
  const float v0 = C(v, 0, 0, 0), vm = C(v, -1, 0, 0), vp = C(v, 1, 0, 0);
  const float w_k = Wf(0, 0, 0), w_km1 = Wf(-1, 0, 0), w_k1 = Wf(1, 0, 0);

  const float Km0 = C(Kmf, 0, 0, 0), Kmm = C(Kmf, -1, 0, 0);
  const float Kmp = C(Kmf, 1, 0, 0), Kmmm = C(Kmf, -2, 0, 0);
  const float Kh0 = C(Khf, 0, 0, 0), Khm = C(Khf, -1, 0, 0);
  const float Khp = C(Khf, 1, 0, 0);

  // ---- scalar tendencies (thl, qt, qr share Kh; e12 uses 2 Km) ----
  const float wr_lo = w_k * rh_lo, wr_hi = w_k1 * rh_hi;
  const float ux0 = u0, ux1 = C(u, 0, 0, 1), vy0 = v0, vy1 = C(v, 0, 1, 0);
  auto scal_tend = [&](const float* s, float K0, float Km_, float Kp_,
                       float Kx0, float Kx1, float Ky0, float Ky1) {
    float sx[7], sy[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      sx[j] = C(s, 0, 0, j - 3);
      sy[j] = C(s, 0, j - 3, 0);
    }
    const float s0 = sx[3], sm_ = C(s, -1, 0, 0), sp_ = C(s, 1, 0, 0);
    const float Fx0 = ux0 * face5(sx[0], sx[1], sx[2], sx[3], sx[4], sx[5], ux0);
    const float Fx1 = ux1 * face5(sx[1], sx[2], sx[3], sx[4], sx[5], sx[6], ux1);
    const float Fy0 = vy0 * face5(sy[0], sy[1], sy[2], sy[3], sy[4], sy[5], vy0);
    const float Fy1 = vy1 * face5(sy[1], sy[2], sy[3], sy[4], sy[5], sy[6], vy1);
    float tend = -(Fx1 - Fx0) / dx - (Fy1 - Fy0) / dy;
    tend = tend - (wr_hi * 0.5f * (s0 + sp_) - wr_lo * 0.5f * (sm_ + s0)) * irf;
    const float Fdx0 = -Kx0 * (sx[3] - sx[2]) / dx;
    const float Fdx1 = -Kx1 * (sx[4] - sx[3]) / dx;
    tend = tend - (Fdx1 - Fdx0) / dx;
    const float Fdy0 = -Ky0 * (sy[3] - sy[2]) / dy;
    const float Fdy1 = -Ky1 * (sy[4] - sy[3]) / dy;
    tend = tend - (Fdy1 - Fdy0) / dy;
    const float Fz_lo = -rh_lo * 0.5f * (Km_ + K0) * (s0 - sm_) / dz;
    const float Fz_hi = -rh_hi * 0.5f * (K0 + Kp_) * (sp_ - s0) / dz;
    return tend - (Fz_hi - Fz_lo) * irf;
  };
  const float Khx0 = 0.5f * (C(Khf, 0, 0, -1) + Kh0);
  const float Khx1 = 0.5f * (Kh0 + C(Khf, 0, 0, 1));
  const float Khy0 = 0.5f * (C(Khf, 0, -1, 0) + Kh0);
  const float Khy1 = 0.5f * (Kh0 + C(Khf, 0, 1, 0));
  const float Kmx_m = C(Kmf, 0, 0, -1), Kmx_p = C(Kmf, 0, 0, 1);
  const float Kmy_m = C(Kmf, 0, -1, 0), Kmy_p = C(Kmf, 0, 1, 0);
  const float Kx0 = 0.5f * (Kmx_m + Km0), Kx1 = 0.5f * (Km0 + Kmx_p);
  const float Ky0 = 0.5f * (Kmy_m + Km0), Ky1 = 0.5f * (Km0 + Kmy_p);

  float dthl = scal_tend(thl, Kh0, Khm, Khp, Khx0, Khx1, Khy0, Khy1);
  float dqt = scal_tend(qt, Kh0, Khm, Khp, Khx0, Khx1, Khy0, Khy1);
  float dqr = scal_tend(qr, Kh0, Khm, Khp, Khx0, Khx1, Khy0, Khy1);
  float de12 = scal_tend(e12, 2.0f * Km0, 2.0f * Kmm, 2.0f * Kmp,
                         Kx0 * 2.0f, Kx1 * 2.0f, Ky0 * 2.0f, Ky1 * 2.0f);
  dthl = dthl + sfc * a.wthl[b];
  dqt = dqt + sfc * a.wqt[b];

  // ---- momentum: 2nd-order advection + diffusion ----
  auto ucen = [&](int dx_) { return 0.5f * (C(u, 0, 0, dx_) + C(u, 0, 0, dx_ + 1)); };
  const float Fxu0 = ucen(0) * ucen(0), Fxu_m = ucen(-1) * ucen(-1);
  float du = -(Fxu0 - Fxu_m) / dx;
  // corner fluxes v_bar(x) * u_bar(y) at y-faces y and y+1
  auto Fyu = [&](int dy_) {
    return 0.5f * (C(v, 0, dy_, -1) + C(v, 0, dy_, 0)) *
           (0.5f * (C(u, 0, dy_ - 1, 0) + C(u, 0, dy_, 0)));
  };
  du = du - (Fyu(1) - Fyu(0)) / dy;
  const float wbx_k = 0.5f * (Wf(0, 0, -1) + w_k);
  const float wbx_k1 = 0.5f * (Wf(1, 0, -1) + w_k1);
  du = du - (rh_hi * wbx_k1 * 0.5f * (u0 + up) - rh_lo * wbx_k * 0.5f * (um + u0)) * irf;
  du = du - ((-Kx1 * (C(u, 0, 0, 1) - u0) / dx) - (-Kx0 * (u0 - C(u, 0, 0, -1)) / dx)) / dx;
  du = du - ((-Ky1 * (C(u, 0, 1, 0) - u0) / dy) - (-Ky0 * (u0 - C(u, 0, -1, 0)) / dy)) / dy;
  {
    const float Fz_lo = -rh_lo * 0.5f * (Kmm + Km0) * (u0 - um) / dz;
    const float Fz_hi = -rh_hi * 0.5f * (Km0 + Kmp) * (up - u0) / dz;
    du = du - (Fz_hi - Fz_lo) * irf;
  }

  auto vcen = [&](int dy_) { return 0.5f * (C(v, 0, dy_, 0) + C(v, 0, dy_ + 1, 0)); };
  const float Fyv0 = vcen(0) * vcen(0), Fyv_m = vcen(-1) * vcen(-1);
  float dv = -(Fyv0 - Fyv_m) / dy;
  auto Fxv = [&](int dx_) {
    return 0.5f * (C(u, 0, -1, dx_) + C(u, 0, 0, dx_)) *
           (0.5f * (C(v, 0, 0, dx_ - 1) + C(v, 0, 0, dx_)));
  };
  dv = dv - (Fxv(1) - Fxv(0)) / dx;
  const float wby_k = 0.5f * (Wf(0, -1, 0) + w_k);
  const float wby_k1 = 0.5f * (Wf(1, -1, 0) + w_k1);
  dv = dv - (rh_hi * wby_k1 * 0.5f * (v0 + vp) - rh_lo * wby_k * 0.5f * (vm + v0)) * irf;
  dv = dv - ((-Kx1 * (C(v, 0, 0, 1) - v0) / dx) - (-Kx0 * (v0 - C(v, 0, 0, -1)) / dx)) / dx;
  dv = dv - ((-Ky1 * (C(v, 0, 1, 0) - v0) / dy) - (-Ky0 * (v0 - C(v, 0, -1, 0)) / dy)) / dy;
  {
    const float Fz_lo = -rh_lo * 0.5f * (Kmm + Km0) * (v0 - vm) / dz;
    const float Fz_hi = -rh_hi * 0.5f * (Km0 + Kmp) * (vp - v0) / dz;
    dv = dv - (Fz_hi - Fz_lo) * irf;
  }

  if (g == 0) {  // surface drag on plane 0, interpolated to the u/v points
    const float l = logf(0.5f * dz / fmaxf(a.z0m[b], 1e-6f));
    const float cd = (KAPPA / l) * (KAPPA / l);
    auto flux = [&](int dy_, int dx_, bool want_u) {
      const float u1c = 0.5f * (C(u, 0, dy_, dx_) + C(u, 0, dy_, dx_ + 1));
      const float v1c = 0.5f * (C(v, 0, dy_, dx_) + C(v, 0, dy_ + 1, dx_));
      const float U1 = sqrtf(u1c * u1c + v1c * v1c + 1e-4f);
      const float ustar2 = cd * (U1 * U1);
      return want_u ? -ustar2 * u1c / U1 : -ustar2 * v1c / U1;
    };
    du = du + sfc * (0.5f * (flux(0, -1, true) + flux(0, 0, true)));
    dv = dv + sfc * (0.5f * (flux(-1, 0, false) + flux(0, 0, false)));
  }

  // w at face g
  float dw;
  {
    auto Fxw = [&](int dx_) {
      return 0.5f * (C(u, -1, 0, dx_) + C(u, 0, 0, dx_)) *
             (0.5f * (Wf(0, 0, dx_ - 1) + Wf(0, 0, dx_)));
    };
    dw = -(Fxw(1) - Fxw(0)) / dx;
    auto Fyw = [&](int dy_) {
      return 0.5f * (C(v, -1, dy_, 0) + C(v, 0, dy_, 0)) *
             (0.5f * (Wf(0, dy_ - 1, 0) + Wf(0, dy_, 0)));
    };
    dw = dw - (Fyw(1) - Fyw(0)) / dy;
    const float wc_k = 0.5f * (w_k + w_k1), wc_km1 = 0.5f * (w_km1 + w_k);
    dw = dw - (rf * wc_k * wc_k - rf_m1 * wc_km1 * wc_km1) * irh;
    auto Kf = [&](int dy_, int dx_) {
      return 0.5f * (C(Kmf, -1, dy_, dx_) + C(Kmf, 0, dy_, dx_));
    };
    const float Kf0 = Kf(0, 0);
    const float Kfx0 = 0.5f * (Kf(0, -1) + Kf0), Kfx1 = 0.5f * (Kf0 + Kf(0, 1));
    const float Kfy0 = 0.5f * (Kf(-1, 0) + Kf0), Kfy1 = 0.5f * (Kf0 + Kf(1, 0));
    dw = dw - ((-Kfx1 * (Wf(0, 0, 1) - w_k) / dx) - (-Kfx0 * (w_k - Wf(0, 0, -1)) / dx)) / dx;
    dw = dw - ((-Kfy1 * (Wf(0, 1, 0) - w_k) / dy) - (-Kfy0 * (w_k - Wf(0, -1, 0)) / dy)) / dy;
    const float Fd_k = -fmv * rf * (0.25f * Kmm + 0.5f * Km0 + 0.25f * Kmp) *
                       (w_k1 - w_k) / dz;
    const float Fd_km1 = -fm_m1 * rf_m1 * (0.25f * Kmmm + 0.5f * Kmm + 0.25f * Km0) *
                         (w_k - w_km1) / dz;
    dw = dw - (Fd_k - Fd_km1) * irh;
  }

  // ---- thermodynamics at g-1, g, g+1 (recomputed, not stored) ----
  const float* mns = a.means + (size_t)b * 5 * nz;
  const float p0 = prof(a.pbf, 0);
  const float thl_0 = C(thl, 0, 0, 0), qt_0 = C(qt, 0, 0, 0), qr_0 = C(qr, 0, 0, 0);
  float T_0, ql_0, qs_0;
  sat_adjust(thl_0, qt_0, p0, a.n_sat_iter, T_0, ql_0, qs_0);
  const float iex_0 = powf(p0 / PREF0, MRD_CP);
  const float thv_0 = T_0 * iex_0 * (1.0f + EPS_I * (qt_0 - ql_0) - ql_0 - qr_0);
  const float thv_m1 = thv_of(C(thl, -1, 0, 0), C(qt, -1, 0, 0), C(qr, -1, 0, 0),
                              prof(a.pbf, -1), a.n_sat_iter);
  const float thvm_c = mns[g], thvm_c_m1 = mns[clampz(g - 1, nz)];
  const float b_0 = GRAV * (thv_0 - thvm_c) / fmaxf(thvm_c, 1.0f);
  const float b_m1 = GRAV * (thv_m1 - thvm_c_m1) / fmaxf(thvm_c_m1, 1.0f);
  dw = dw + 0.5f * (b_0 + b_m1) * m0;
  dw = m0 * dw;

  // ---- TKE sources ----
  de12 = de12 + a.src[off + (size_t)g * P + i];

  // ---- coriolis ----
  if (a.f_cor != 0.f) {
    const float vc_at_u = 0.25f * (v0 + C(v, 0, 1, 0) + C(v, 0, 0, -1) + C(v, 0, 1, -1));
    const float uc_at_v = 0.25f * (u0 + C(u, 0, 0, 1) + C(u, 0, -1, 0) + C(u, 0, -1, 1));
    du = du + a.f_cor * vc_at_u;
    dv = dv - a.f_cor * uc_at_v;
  }

  // ---- coupler forcings ----
  du = du + prof(a.f_u, 0);
  dv = dv + prof(a.f_v, 0);
  dthl = dthl + prof(a.f_thl, 0);
  const float fqt = prof(a.f_qt, 0);
  if (a.qt_mode == 0 || a.qt_mode == 1) {
    dqt = dqt + fqt;
  } else {
    const float scale = qt_0 / fmaxf(mns[2 * nz + g], 1e-10f);
    if (a.qt_mode == 2)
      dqt = dqt + fqt * scale;
    else
      dqt = dqt + (fqt < 0.f ? fqt * scale : fqt);
  }

  // ---- microphysics (simpleice) ----
  const float fi_0 = ice_frac(T_0);
  const float ql_pos = fmaxf(ql_0, 0.f);
  const float auto_ = a.auto_k * powf(ql_pos * (1.0f - fi_0), 2.47f) * a.nc_fac +
                      fmaxf(ql_pos * fi_0 - a.ice_qi0, 0.f) / a.ice_tau;
  const float accr = a.accr_k * powf(ql_pos * fmaxf(qr_0, 0.f), 1.15f);
  const float to_rain = fminf(auto_ + accr, ql_pos / dtv);
  const float qv_0 = qt_0 - ql_0;
  const float subsat = fminf(fmaxf((qs_0 - qv_0) / fmaxf(qs_0, 1e-8f), 0.f), 1.f);
  const float evap = fminf(subsat * qr_0 / a.evap_tau, fmaxf(qr_0, 0.f) / dtv);
  float mdqr = to_rain - evap;
  dqt = dqt - to_rain + evap;
  const float lheat = (1.0f - fi_0) * RLV + fi_0 * (float)D_RLS;
  dthl = dthl - lheat / CP * iex_0 * evap;
  const float flux_0 = sed_flux(a, rf, qr_0, T_0);
  float flux_p1 = 0.f;
  if (g < nz - 1) {
    float T_1, ql_1, qs_1;
    const float qr_1 = C(qr, 1, 0, 0);
    sat_adjust(C(thl, 1, 0, 0), C(qt, 1, 0, 0), prof(a.pbf, 1), a.n_sat_iter,
               T_1, ql_1, qs_1);
    flux_p1 = sed_flux(a, prof(a.rhobf, 1), qr_1, T_1);
  }
  const float dqr_sed = (flux_p1 - flux_0) * irf;
  mdqr = fmaxf(mdqr + dqr_sed, -fmaxf(qr_0, 0.f) / dtv);
  dqr = dqr + mdqr;

  // ---- sponge layer ----
  const float zs = a.zs;  // top of the undamped column, nz*dz - depth
  const float zf = ((float)g + 0.5f) * dz;
  const float rate = fminf(fmaxf((zf - zs) / a.sponge_depth, 0.f), 1.f) / a.sponge_tau;
  du = du - rate * (u0 - mns[3 * nz + g]);
  dv = dv - rate * (v0 - mns[4 * nz + g]);
  dthl = dthl - rate * (thl_0 - mns[nz + g]);
  dqt = dqt - rate * (qt_0 - mns[2 * nz + g]);
  const float zh = (float)g * dz;
  const float rate_h = fminf(fmaxf((zh - zs) / a.sponge_depth, 0.f), 1.f) / a.sponge_tau;
  dw = dw - rate_h * w_k;

  // ---- RK axpy + clips ----
  const size_t o = off + (size_t)g * P + i;
  const size_t ow = (size_t)b * (nz + 1) * P + (size_t)g * P + i;
  const float f = a.fdt * dtv;
  a.un[o] = a.ub[o] + f * du;
  a.vn[o] = a.vb[o] + f * dv;
  a.wn[o] = a.wb[ow] + f * dw;
  a.thln[o] = a.thlb[o] + f * dthl;
  a.qtn[o] = fmaxf(a.qtb[o] + f * dqt, 0.f);
  a.qrn[o] = fmaxf(a.qrb[o] + f * dqr, 0.f);
  a.e12n[o] = fmaxf(a.e12b[o] + f * de12, E12_MIN);
}

}  // namespace

extern "C" int lesstage_stage(const StageArgs* args, cudaStream_t stream) {
  const StageArgs a = *args;
  const int P = a.ny * a.nx;
  const dim3 grid_pts((P + NT - 1) / NT, a.nz, a.n);
  k_means<<<dim3(a.nz, a.n), NT, 0, stream>>>(a);
  k_closure<<<grid_pts, NT, 0, stream>>>(a);
  k_tend<<<grid_pts, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
