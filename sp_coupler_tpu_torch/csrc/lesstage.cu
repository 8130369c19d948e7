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
// The bound, per point of the [n, nz, ny, nx] grid: 7 current fields
// (u, v, w, thl, qt, qr, e12) and 7 base fields read once, 7 updated
// fields written once, 21 float32 = 84 bytes; ~1.2k float operations by
// a hand count (tendencies and axpy ~890, thermodynamics ~100, closure
// ~86, plane means ~80; chip_smoke.py, KERNEL_OPS), each an add,
// multiply, compare or min/max issued as one float32 instruction, 128 a
// clock per SM: 33.5 T/s on an H100 SXM (the data sheet's 67 TFLOP/s
// counts a fused multiply-add as two). At 64x64x160, n = 1: 55 MB,
// 16.4 us at 3.35 TB/s, against 0.76 G operations, 22.7 us. Operations
// bind (the ~30 exp, log and reciprocals a point go to the special
// function units, 16 a clock per SM: ~5 us, which does not bind). So the
// design computes each point's thermodynamics and closure once and reads
// the stencils from shared memory rather than recomputing at every
// neighbour; it moves each byte once. Measured on an H100 80GB HBM3
// (PERF.md, Findings), the stage is held by instruction issue: the
// tendencies take about half of k_stage's time, and the 5th-order face
// values are not yet shared between neighbouring cells.
//
// The design, two launches:
//   1. k_means: one block per (instance, level): plane means of thv, thl,
//      qt, u, v (N^2 at every point needs the thv means of the levels
//      above and below, and blocks cannot wait on one another), and the
//      level's Exner factors; on level 0 also <u*^2> and the surface
//      rain flux.
//   2. k_stage: one block per (TX x TY tile of columns, chunk of TZ
//      levels, instance), one thread per column, marching upward in z;
//      32x8 tiles, two blocks an SM (128 registers a thread, 91 KB of
//      shared memory), and TZ chosen so the blocks run in whole waves.
//      The current fields go through a ring of NSLOT z-planes in shared
//      memory, each over the tile plus a 3-point periodic x/y halo (the
//      5th-order faces), filled by cp.async: the next plane's copies are
//      in flight while the current level is computed. Each plane that
//      enters the ring gets, once per point, the saturation adjustment,
//      thv and the fall flux (kept in the column's registers, the only
//      reader), and the closure Km, Kh and TKE source once per point of
//      the tile plus a 1-point halo (kept in a ring of NCSLOT planes in
//      shared memory: Km is read at k-2..k+1, Kh at k-1..k+1, both +-1
//      in x/y). The tendencies then come from shared memory alone; the
//      base fields are read and the outputs written once each, coalesced
//      along x. A chunk starts by copying its own z-halo (k-3..k+1). kmax
//      is a warp max and an atomicMax on the int bits of the
//      (non-negative) float; aux is zeroed by the wrapper. The launch
//      geometry (tile, TZ, shared-memory bytes) comes from
//      ops/lesstage.py::stage_geometry through StageArgs.
//
// Semantics kept from the TPU kernel: edge-replicated z halos for cell
// fields and profiles, w face nz identically zero, the global-z masks of
// the boundary one-sided differences, sign(0) == 0 in the 5th-order face
// value, log(0) = -inf -> exp(b * -inf) = 0 in the fall speed (b > 0 is
// checked by the wrapper), and the clips of the axpy.
//
// Halo mode (StageArgs.halo = h > 0, for a rank's block of a plane split
// over ranks): the current fields are the block padded with h >= 3 points a
// side by its neighbours' values (parallel/plane.py), [.., ny + 2h, nx + 2h];
// the base fields, the outputs and the launch are the block's ny x nx
// columns. The row/column tables of k_stage address the padded block
// (stencil::plane_index) instead of wrapping; kmax takes the block's
// points. k_means sums over the block and, with StageArgs.sums set, writes
// its float64 sums (slots 0-4 per level; <u*^2> and the rain flux in slots
// 5 and 6 of level 0) instead of the means: the wrapper sums them over the
// plane's ranks, divides by the whole plane's points, fills means and aux,
// and only then launches k_stage. The Exner slots 5-6 of means are a
// level's own and are written by k_means in both modes.
//
// Plain C interface for ctypes, each returning the first CUDA error of its
// launches (0 if none): lesstage_stage(const StageArgs*, stream) runs both
// launches (the whole plane); lesstage_means and lesstage_apply run
// k_means and k_stage alone (halo mode, with the reduction between them).

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using stencil::clampz;
using stencil::cp_async_commit;
using stencil::cp_async_f32;
using stencil::cp_async_wait_all;
using stencil::face5;
using stencil::ring;
using stencil::wrap;
using stencil::plane_index;

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

constexpr int NT_MEANS = 1024;  // threads of a k_means block

}  // namespace

extern "C" {

struct StageArgs {
  int n, nz, ny, nx, qt_mode, n_sat_iter;
  // launch geometry (ops/lesstage.py::stage_geometry): tile, levels per
  // z-chunk, dynamic shared-memory bytes of a k_stage block; the halo of
  // the current fields (0: the whole periodic plane)
  int tx, ty, tz, smem, halo;
  float dx, dy, dz, fdt, f_cor, sponge_depth, sponge_tau, zs, delta;
  float nc_fac, auto_k, accr_k, evap_tau, sed_a, sed_b, ice_tau, ice_qi0;
  float sed_ai, sed_bi;
  // current state: [n, nz, PP] cells, w [n, nz+1, PP] faces; PP = P =
  // ny * nx, or (ny + 2 halo) * (nx + 2 halo) in halo mode
  const float *u, *v, *w, *thl, *qt, *qr, *e12;
  // base state of the RK update: [n, nz, P] cells, w [n, nz+1, P]
  const float *ub, *vb, *wb, *thlb, *qtb, *qrb, *e12b;
  // profiles [n, nz] (rhobh [n, nz+1]) and per-instance scalars [n]
  const float *pbf, *rhobf, *rhobh, *f_u, *f_v, *f_thl, *f_qt;
  const float *dt, *wthl, *wqt, *z0m;
  // outputs: [n, nz, P] each; aux [n, 3] = kmax, <u*^2>, surface rain flux
  float *un, *vn, *wn, *thln, *qtn, *qrn, *e12n, *aux;
  // scratch [n, 7, nz]: plane means of thv, thl, qt, u, v; then
  // ex = (p/p0)^(Rd/cp) and iex = (p/p0)^(-Rd/cp) of each level
  float *means;
  // halo mode: k_means's float64 sums [n, 7, nz] (null: it writes means)
  double *sums;
};

}  // extern "C"

namespace {

__device__ __forceinline__ float qsat_liq(float T, float p) {
  float es = ES0 * expf(AT_LIQ * (T - TMELT) / (T - BT_LIQ));
  es = fminf(es, 0.9f * p);
  return RD_RV * es / (p - ONE_M_RD_RV * es);
}

// utils/thermo.sat_adjust: (T, ql, qs) from (thl, qt, p); ex = (p/p0)^(Rd/cp).
// An iteration is a function of T alone, so once T stops changing (every
// unsaturated point, after one) the remaining iterations and the final qs
// would repeat it: stopping there gives the same bits, at a third of the
// transcendentals
__device__ __forceinline__ void sat_adjust(float thl, float qt, float p,
                                           float ex, int n_iter, float& T,
                                           float& ql, float& qs) {
  T = thl * ex;
  ql = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    qs = qsat_liq(T, p);
    const float dqsdt = qs * RLV / (RV * T * T);
    ql = fmaxf((qt - qs + dqsdt * (T - thl * ex)) / (1.0f + RLV_CP * dqsdt),
               0.f);
    const float T_next = thl * ex + RLV * ql / CP;
    if (T_next == T) return;
    T = T_next;
  }
  qs = qsat_liq(T, p);
}

__device__ __forceinline__ float ice_frac(float T) {
  return fminf(fmaxf((TMELT - T) / ICE_RAMP, 0.f), 1.f);
}

// downward sedimentation flux rho vt qr; log(0) = -inf gives exp(-inf) = 0,
// so it is 0 where qr <= 0 (skipped there)
__device__ __forceinline__ float sed_flux(const StageArgs& a, float rf,
                                          float qr, float T) {
  if (!(qr > 0.f)) return 0.f;
  const float fi = ice_frac(T);
  const float lrq = logf(fmaxf(rf * qr, 0.f));
  const float vt = (1.0f - fi) * a.sed_a * expf(a.sed_b * lrq) +
                   fi * a.sed_ai * expf(a.sed_bi * lrq);
  return rf * vt * fmaxf(qr, 0.f);
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
      v[j] = lane < (NT_MEANS >> 5) ? sh[j * 32 + lane] : 0.0;
      for (int o = 16; o > 0; o >>= 1)
        v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
    }
  }
}

// ---- launch 1: plane means -----------------------------------------------
// Sums are taken in float64 (free here): N^2 is a difference of the thv
// means of two adjacent levels (~300 K each, ~0.15 K apart on the
// 64x64x160 grid), and a float32 sum of 4096 values near 300 K carries up
// to ~5e-5 K of rounding.

__global__ void __launch_bounds__(NT_MEANS) k_means(StageArgs a) {
  __shared__ double sh[7 * 32];
  const int k = blockIdx.x, b = blockIdx.y;
  const int nz = a.nz, nx = a.nx, P = a.ny * a.nx, h = a.halo;
  const int pnx = nx + 2 * h;
  const size_t base = ((size_t)b * nz + k) * ((size_t)(a.ny + 2 * h) * pnx);
  const float p = a.pbf[b * nz + k];
  const float rf = a.rhobf[b * nz + k];
  const float ex = powf(p / PREF0, RD_CP), iex = powf(p / PREF0, MRD_CP);
  float cd = 0.f;
  if (k == 0) {
    const float l = logf(0.5f * a.dz / fmaxf(a.z0m[b], 1e-6f));
    cd = (KAPPA / l) * (KAPPA / l);
  }
  double s[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < P; i += NT_MEANS) {
    const int y = i / nx, x = i - y * nx;
    // the point, and its neighbours at x + 1 and y + 1: in the padded
    // block's halo, or the periodic plane's own
    const size_t o = h ? base + (size_t)(y + h) * pnx + x + h : base + i;
    const size_t ox = h ? o + 1 : base + y * nx + wrap(x + 1, nx);
    const size_t oy = h ? o + pnx : base + wrap(y + 1, a.ny) * nx + x;
    const float thl = a.thl[o], qt = a.qt[o];
    const float qr = a.qr[o];
    float T, ql, qs;
    sat_adjust(thl, qt, p, ex, a.n_sat_iter, T, ql, qs);
    s[0] += T * iex * (1.0f + EPS_I * (qt - ql) - ql - qr);
    s[1] += thl;
    s[2] += qt;
    s[3] += a.u[o];
    s[4] += a.v[o];
    if (k == 0) {
      const float u1 = 0.5f * (a.u[o] + a.u[ox]);
      const float v1 = 0.5f * (a.v[o] + a.v[oy]);
      const float U1 = sqrtf(u1 * u1 + v1 * v1 + 1e-4f);
      s[5] += cd * (U1 * U1);
      s[6] += sed_flux(a, rf, qr, T);
    }
  }
  block_sum<7>(s, sh);
  if (threadIdx.x == 0) {
    float* const m = a.means + (size_t)b * 7 * nz + k;
    m[5 * nz] = ex;
    m[6 * nz] = iex;
    if (a.sums) {  // halo mode: the block's sums, reduced by the wrapper
      double* const d = a.sums + (size_t)b * 7 * nz + k;
#pragma unroll
      for (int j = 0; j < 5; ++j) d[j * nz] = s[j];
      if (k == 0) {
        d[5 * nz] = s[5];
        d[6 * nz] = s[6];
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) m[j * nz] = (float)(s[j] / P);
    if (k == 0) {
      a.aux[b * 3 + 1] = (float)(s[5] / P);
      a.aux[b * 3 + 2] = (float)(s[6] / P);
    }
  }
}

// ---- launch 2: the stage, marching in z ------------------------------------

constexpr int TX = 32, TY = 8;  // the tile of columns, ops/lesstage.py TX, TY
constexpr int HALO = 3;    // x/y halo of the field planes (5th-order faces)
constexpr int NF = 7;      // fields in the ring
constexpr int NSLOT = 5;   // field planes k-1..k+2 live, k+3 in flight
constexpr int NCSLOT = 4;  // closure planes k-2..k+1
enum { F_U, F_V, F_W, F_THL, F_QT, F_QR, F_E12 };
enum { C_KM, C_KH, C_SRC };

// shared-memory layout of a k_stage block; ops/lesstage.py::shared_bytes
// computes the same byte count
struct Tile {
  static constexpr int NT = TX * TY;  // one thread per column of the tile
  static constexpr int W = TX + 2 * HALO, H = TY + 2 * HALO, PL = W * H;
  static constexpr int CW = TX + 2, CPL = CW * (TY + 2);
  static constexpr int FLD = NSLOT * NF * PL;   // field ring (floats)
  static constexpr int CLO = NCSLOT * 3 * CPL;  // Km, Kh, src ring (floats)
  static constexpr int BYTES = 4 * (FLD + CLO) + 4 * (W + H);
};

// thermodynamics of one point: saturation adjustment, thv, fall flux
struct Thermo {
  float T, ql, qs, thv, flux;
};

__global__ void __launch_bounds__(TX * TY, 2) k_stage(StageArgs a) {
  using L = Tile;
  constexpr int NT = L::NT, W = L::W, PL = L::PL, CW = L::CW, CPL = L::CPL;
  extern __shared__ float smem[];
  float* const fld = smem;                  // [NSLOT][NF][PL]
  float* const clo = smem + L::FLD;         // [NCSLOT][3][CPL]
  int* const rowoff = reinterpret_cast<int*>(clo + L::CLO);  // [H] y*pnx
  int* const colx = rowoff + L::H;                           // [W] x

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int nz = a.nz, ny = a.ny, nx = a.nx, P = ny * nx;
  const int h = a.halo, pnx = nx + 2 * h, PP = (ny + 2 * h) * pnx;
  const int tiles_x = (nx + TX - 1) / TX;
  const int x0 = (blockIdx.x % tiles_x) * TX, y0 = (blockIdx.x / tiles_x) * TY;
  const int k0 = blockIdx.y * a.tz, k1 = min(nz, k0 + a.tz);
  const int b = blockIdx.z;
  const int gx = x0 + tx, gy = y0 + ty;
  const bool own = gx < nx && gy < ny;  // the column is on the grid
  const int ci = (ty + HALO) * W + tx + HALO;  // the column in a field plane
  const int cc = (ty + 1) * CW + tx + 1;       // ... in a closure plane

  for (int i = tid; i < L::H; i += NT)
    rowoff[i] = plane_index(y0 + i - HALO, ny, h) * pnx;
  for (int i = tid; i < W; i += NT) colx[i] = plane_index(x0 + i - HALO, nx, h);
  __syncthreads();

  const size_t off = (size_t)b * nz * PP;        // current fields (padded)
  const size_t offw = (size_t)b * (nz + 1) * PP;
  const size_t offo = (size_t)b * nz * P;        // base fields and outputs
  const size_t offwo = (size_t)b * (nz + 1) * P;
  const float* const pbf = a.pbf + b * nz;
  const float* const rhobf = a.rhobf + b * nz;
  const float* const rhobh = a.rhobh + b * (nz + 1);
  const float* const mns = a.means + (size_t)b * 7 * nz;
  const float* const ex_l = mns + 5 * nz;   // Exner factors of each level
  const float* const iex_l = mns + 6 * nz;
  const float dz = a.dz;
  const float rdx = 1.0f / a.dx, rdy = 1.0f / a.dy, rdz = 1.0f / dz;

  // start the copies of plane j: cells clamp to [0, nz-1]; w faces below 0
  // are face 0, faces at and above nz are zero (rigid lid)
  auto load = [&](int j) {
    float* const dst = fld + ring(j, NSLOT) * NF * PL;
    const size_t c = off + (size_t)clampz(j, nz) * PP;
    const bool wzero = j >= nz;
    const size_t cw = offw + (size_t)(j < 0 ? 0 : j) * PP;
    for (int i = tid; i < PL; i += NT) {
      const int r = i / W, q = i - r * W;
      const int o = rowoff[r] + colx[q];
      cp_async_f32(dst + F_U * PL + i, a.u + c + o);
      cp_async_f32(dst + F_V * PL + i, a.v + c + o);
      if (wzero)
        dst[F_W * PL + i] = 0.f;
      else
        cp_async_f32(dst + F_W * PL + i, a.w + cw + o);
      cp_async_f32(dst + F_THL * PL + i, a.thl + c + o);
      cp_async_f32(dst + F_QT * PL + i, a.qt + c + o);
      cp_async_f32(dst + F_QR * PL + i, a.qr + c + o);
      cp_async_f32(dst + F_E12 * PL + i, a.e12 + c + o);
    }
    cp_async_commit();
  };

  // closure of level clampz(j) over the tile + 1-point halo, into the
  // closure ring at level j; reads field planes g-1..g+1
  auto closure = [&](int j) {
    const int g = clampz(j, nz);
    const float* const fm = fld + ring(g - 1, NSLOT) * NF * PL;
    const float* const f0 = fld + ring(g, NSLOT) * NF * PL;
    const float* const fp = fld + ring(g + 1, NSLOT) * NF * PL;
    float* const out = clo + ring(j, NCSLOT) * 3 * CPL;
    const float bm = (g == 0 || g == nz - 1) ? 2.0f : 1.0f;
    const float dthv = bm * (mns[clampz(g + 1, nz)] - mns[clampz(g - 1, nz)]) *
                       (0.5f * rdz);
    const float N2 = GRAV / fmaxf(mns[g], 1.0f) * dthv;
    const float rsN = 1.0f / sqrtf(fmaxf(N2, 1e-10f));
    const float delta = a.delta, rdelta = 1.0f / delta;
    for (int i = tid; i < CPL; i += NT) {
      const int r = i / CW, q = i - r * CW;
      const int f = (r + HALO - 1) * W + q + HALO - 1;
      auto C = [&](int fi, int dk, int dy_, int dx_) {
        const float* p = dk < 0 ? fm : (dk > 0 ? fp : f0);
        return p[fi * PL + f + dy_ * W + dx_];
      };
      auto uc = [&](int dk, int dy_, int dx_) {
        return 0.5f * (C(F_U, dk, dy_, dx_) + C(F_U, dk, dy_, dx_ + 1));
      };
      auto vc = [&](int dk, int dy_, int dx_) {
        return 0.5f * (C(F_V, dk, dy_, dx_) + C(F_V, dk, dy_ + 1, dx_));
      };
      auto wc = [&](int dy_, int dx_) {
        return 0.5f * (C(F_W, 0, dy_, dx_) + C(F_W, 1, dy_, dx_));
      };
      const float dudx = (C(F_U, 0, 0, 1) - C(F_U, 0, 0, 0)) * rdx;
      const float dvdy = (C(F_V, 0, 1, 0) - C(F_V, 0, 0, 0)) * rdy;
      const float dwdz = (C(F_W, 1, 0, 0) - C(F_W, 0, 0, 0)) * rdz;
      const float dudy = (uc(0, 1, 0) - uc(0, -1, 0)) * (0.5f * rdy);
      const float dudz = bm * (uc(1, 0, 0) - uc(-1, 0, 0)) * (0.5f * rdz);
      const float dvdx = (vc(0, 0, 1) - vc(0, 0, -1)) * (0.5f * rdx);
      const float dvdz = bm * (vc(1, 0, 0) - vc(-1, 0, 0)) * (0.5f * rdz);
      const float dwdx = (wc(0, 1) - wc(0, -1)) * (0.5f * rdx);
      const float dwdy = (wc(1, 0) - wc(-1, 0)) * (0.5f * rdy);
      const float S2 = 2.0f * (dudx * dudx + dvdy * dvdy + dwdz * dwdz) +
                       (dudy + dvdx) * (dudy + dvdx) +
                       (dudz + dwdx) * (dudz + dwdx) +
                       (dvdz + dwdy) * (dvdz + dwdy);
      const float e12 = fmaxf(C(F_E12, 0, 0, 0), E12_MIN);
      const float lam_stable = CN * e12 * rsN;
      const float lam = N2 > 1e-10f ? fminf(delta, lam_stable) : delta;
      const float Km = CM * lam * e12;
      const float Kh = (CH1 + CH2 * lam * rdelta) * Km;
      const float diss = (CE1 + CE2 * lam * rdelta) * (e12 * e12 * e12) / lam;
      out[C_KM * CPL + i] = Km;
      out[C_KH * CPL + i] = Kh;
      out[C_SRC * CPL + i] = (Km * S2 + (-Kh * N2) - diss) / (2.0f * e12);
    }
  };

  // thermodynamics of this thread's column at level clampz(j)
  auto thermo = [&](int j) {
    const int g = clampz(j, nz);
    const float* const f = fld + ring(j, NSLOT) * NF * PL + ci;
    const float p = pbf[g];
    const float thl = f[F_THL * PL], qt = f[F_QT * PL], qr = f[F_QR * PL];
    Thermo t;
    sat_adjust(thl, qt, p, ex_l[g], a.n_sat_iter, t.T, t.ql, t.qs);
    t.thv = t.T * iex_l[g] * (1.0f + EPS_I * (qt - t.ql) - t.ql - qr);
    t.flux = sed_flux(a, rhobf[g], qr, t.T);
    return t;
  };

  // prologue: the chunk's own z-halo, thermodynamics at k0-1, k0 and the
  // closure at k0-2..k0
  for (int j = k0 - 3; j <= k0 + 1; ++j) load(j);
  cp_async_wait_all();
  __syncthreads();
  Thermo t_m = thermo(k0 - 1), t_0 = thermo(k0);
  for (int j = k0 - 2; j <= k0; ++j) closure(j);
  __syncthreads();
  load(k0 + 2);

  const float dtv = a.dt[b], rdtv = 1.0f / dtv;
  const float fstep = a.fdt * dtv;
  const float r_ice_tau = 1.0f / a.ice_tau, r_evap_tau = 1.0f / a.evap_tau;
  const float r_sp_depth = 1.0f / a.sponge_depth;
  const float r_sp_tau = 1.0f / a.sponge_tau;
  unsigned kmax_bits = 0u;  // Km >= 0: the int bits order like the floats

  for (int g = k0; g < k1; ++g) {
    cp_async_wait_all();
    __syncthreads();  // plane g+2 is in; every read of step g-1 is done
    if (g + 3 <= k1 + 1) load(g + 3);
    const Thermo t_p = thermo(g + 1);
    closure(g + 1);
    __syncthreads();

    const float* const qm = fld + ring(g - 1, NSLOT) * NF * PL + ci;
    const float* const q0 = fld + ring(g, NSLOT) * NF * PL + ci;
    const float* const qp = fld + ring(g + 1, NSLOT) * NF * PL + ci;
    const float* const kmm = clo + ring(g - 2, NCSLOT) * 3 * CPL + cc;
    const float* const km_ = clo + ring(g - 1, NCSLOT) * 3 * CPL + cc;
    const float* const k0_ = clo + ring(g, NCSLOT) * 3 * CPL + cc;
    const float* const kp_ = clo + ring(g + 1, NCSLOT) * 3 * CPL + cc;
    auto C = [&](int fi, int dk, int dy_, int dx_) {
      const float* p = dk < 0 ? qm : (dk > 0 ? qp : q0);
      return p[fi * PL + dy_ * W + dx_];
    };
    auto Wf = [&](int dk, int dy_, int dx_) { return C(F_W, dk, dy_, dx_); };
    auto Kc = [&](int ki, int dk, int dy_, int dx_) {
      const float* p = dk < -1 ? kmm : (dk < 0 ? km_ : (dk > 0 ? kp_ : k0_));
      return p[ki * CPL + dy_ * CW + dx_];
    };
    auto prof = [&](const float* p, int dk) {
      return p[b * nz + clampz(g + dk, nz)];
    };

    const float rf = rhobf[g];
    const float m0 = g == 0 ? 0.f : 1.f;
    const float rf_m1 = rhobf[clampz(g - 1, nz)] * m0;
    const float rh_lo = rhobh[g];
    const float rh_hi = rhobh[g + 1];
    const float irf = 1.0f / (rf * dz);
    const float irh = 1.0f / (rh_lo * dz);
    const float fmv = (g == 0 || g == nz - 1) ? 0.f : 1.f;
    const float fm_m1 = (g - 1 <= 0 || g - 1 == nz - 1) ? 0.f : 1.f;
    const float sfc = g == 0 ? rh_lo * irf : 0.f;

    const float u0 = C(F_U, 0, 0, 0), um = C(F_U, -1, 0, 0), up = C(F_U, 1, 0, 0);
    const float v0 = C(F_V, 0, 0, 0), vm = C(F_V, -1, 0, 0), vp = C(F_V, 1, 0, 0);
    const float w_k = Wf(0, 0, 0), w_km1 = Wf(-1, 0, 0), w_k1 = Wf(1, 0, 0);

    const float Km0 = Kc(C_KM, 0, 0, 0), Kmm = Kc(C_KM, -1, 0, 0);
    const float Kmp = Kc(C_KM, 1, 0, 0), Kmmm = Kc(C_KM, -2, 0, 0);
    const float Kh0 = Kc(C_KH, 0, 0, 0), Khm = Kc(C_KH, -1, 0, 0);
    const float Khp = Kc(C_KH, 1, 0, 0);

    // ---- scalar tendencies (thl, qt, qr share Kh; e12 uses 2 Km) ----
    const float wr_lo = w_k * rh_lo, wr_hi = w_k1 * rh_hi;
    const float ux0 = u0, ux1 = C(F_U, 0, 0, 1), vy0 = v0, vy1 = C(F_V, 0, 1, 0);
    auto scal_tend = [&](int s, float K0, float Km_, float Kp_, float Kx0,
                         float Kx1, float Ky0, float Ky1) {
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
      float tend = -(Fx1 - Fx0) * rdx - (Fy1 - Fy0) * rdy;
      tend = tend - (wr_hi * 0.5f * (s0 + sp_) - wr_lo * 0.5f * (sm_ + s0)) * irf;
      const float Fdx0 = -Kx0 * (sx[3] - sx[2]) * rdx;
      const float Fdx1 = -Kx1 * (sx[4] - sx[3]) * rdx;
      tend = tend - (Fdx1 - Fdx0) * rdx;
      const float Fdy0 = -Ky0 * (sy[3] - sy[2]) * rdy;
      const float Fdy1 = -Ky1 * (sy[4] - sy[3]) * rdy;
      tend = tend - (Fdy1 - Fdy0) * rdy;
      const float Fz_lo = -rh_lo * 0.5f * (Km_ + K0) * (s0 - sm_) * rdz;
      const float Fz_hi = -rh_hi * 0.5f * (K0 + Kp_) * (sp_ - s0) * rdz;
      return tend - (Fz_hi - Fz_lo) * irf;
    };
    const float Khx0 = 0.5f * (Kc(C_KH, 0, 0, -1) + Kh0);
    const float Khx1 = 0.5f * (Kh0 + Kc(C_KH, 0, 0, 1));
    const float Khy0 = 0.5f * (Kc(C_KH, 0, -1, 0) + Kh0);
    const float Khy1 = 0.5f * (Kh0 + Kc(C_KH, 0, 1, 0));
    const float Kmx_m = Kc(C_KM, 0, 0, -1), Kmx_p = Kc(C_KM, 0, 0, 1);
    const float Kmy_m = Kc(C_KM, 0, -1, 0), Kmy_p = Kc(C_KM, 0, 1, 0);
    const float Kx0 = 0.5f * (Kmx_m + Km0), Kx1 = 0.5f * (Km0 + Kmx_p);
    const float Ky0 = 0.5f * (Kmy_m + Km0), Ky1 = 0.5f * (Km0 + Kmy_p);

    float dthl = scal_tend(F_THL, Kh0, Khm, Khp, Khx0, Khx1, Khy0, Khy1);
    float dqt = scal_tend(F_QT, Kh0, Khm, Khp, Khx0, Khx1, Khy0, Khy1);
    float dqr = scal_tend(F_QR, Kh0, Khm, Khp, Khx0, Khx1, Khy0, Khy1);
    float de12 = scal_tend(F_E12, 2.0f * Km0, 2.0f * Kmm, 2.0f * Kmp,
                           Kx0 * 2.0f, Kx1 * 2.0f, Ky0 * 2.0f, Ky1 * 2.0f);
    dthl = dthl + sfc * a.wthl[b];
    dqt = dqt + sfc * a.wqt[b];

    // ---- momentum: 2nd-order advection + diffusion ----
    auto ucen = [&](int dx_) {
      return 0.5f * (C(F_U, 0, 0, dx_) + C(F_U, 0, 0, dx_ + 1));
    };
    const float Fxu0 = ucen(0) * ucen(0), Fxu_m = ucen(-1) * ucen(-1);
    float du = -(Fxu0 - Fxu_m) * rdx;
    // corner fluxes v_bar(x) * u_bar(y) at y-faces y and y+1
    auto Fyu = [&](int dy_) {
      return 0.5f * (C(F_V, 0, dy_, -1) + C(F_V, 0, dy_, 0)) *
             (0.5f * (C(F_U, 0, dy_ - 1, 0) + C(F_U, 0, dy_, 0)));
    };
    du = du - (Fyu(1) - Fyu(0)) * rdy;
    const float wbx_k = 0.5f * (Wf(0, 0, -1) + w_k);
    const float wbx_k1 = 0.5f * (Wf(1, 0, -1) + w_k1);
    du = du - (rh_hi * wbx_k1 * 0.5f * (u0 + up) - rh_lo * wbx_k * 0.5f * (um + u0)) * irf;
    du = du - ((-Kx1 * (C(F_U, 0, 0, 1) - u0) * rdx) -
               (-Kx0 * (u0 - C(F_U, 0, 0, -1)) * rdx)) * rdx;
    du = du - ((-Ky1 * (C(F_U, 0, 1, 0) - u0) * rdy) -
               (-Ky0 * (u0 - C(F_U, 0, -1, 0)) * rdy)) * rdy;
    {
      const float Fz_lo = -rh_lo * 0.5f * (Kmm + Km0) * (u0 - um) * rdz;
      const float Fz_hi = -rh_hi * 0.5f * (Km0 + Kmp) * (up - u0) * rdz;
      du = du - (Fz_hi - Fz_lo) * irf;
    }

    auto vcen = [&](int dy_) {
      return 0.5f * (C(F_V, 0, dy_, 0) + C(F_V, 0, dy_ + 1, 0));
    };
    const float Fyv0 = vcen(0) * vcen(0), Fyv_m = vcen(-1) * vcen(-1);
    float dv = -(Fyv0 - Fyv_m) * rdy;
    auto Fxv = [&](int dx_) {
      return 0.5f * (C(F_U, 0, -1, dx_) + C(F_U, 0, 0, dx_)) *
             (0.5f * (C(F_V, 0, 0, dx_ - 1) + C(F_V, 0, 0, dx_)));
    };
    dv = dv - (Fxv(1) - Fxv(0)) * rdx;
    const float wby_k = 0.5f * (Wf(0, -1, 0) + w_k);
    const float wby_k1 = 0.5f * (Wf(1, -1, 0) + w_k1);
    dv = dv - (rh_hi * wby_k1 * 0.5f * (v0 + vp) - rh_lo * wby_k * 0.5f * (vm + v0)) * irf;
    dv = dv - ((-Kx1 * (C(F_V, 0, 0, 1) - v0) * rdx) -
               (-Kx0 * (v0 - C(F_V, 0, 0, -1)) * rdx)) * rdx;
    dv = dv - ((-Ky1 * (C(F_V, 0, 1, 0) - v0) * rdy) -
               (-Ky0 * (v0 - C(F_V, 0, -1, 0)) * rdy)) * rdy;
    {
      const float Fz_lo = -rh_lo * 0.5f * (Kmm + Km0) * (v0 - vm) * rdz;
      const float Fz_hi = -rh_hi * 0.5f * (Km0 + Kmp) * (vp - v0) * rdz;
      dv = dv - (Fz_hi - Fz_lo) * irf;
    }

    if (g == 0) {  // surface drag on plane 0, interpolated to the u/v points
      const float l = logf(0.5f * dz / fmaxf(a.z0m[b], 1e-6f));
      const float cd = (KAPPA / l) * (KAPPA / l);
      auto flux = [&](int dy_, int dx_, bool want_u) {
        const float u1c = 0.5f * (C(F_U, 0, dy_, dx_) + C(F_U, 0, dy_, dx_ + 1));
        const float v1c = 0.5f * (C(F_V, 0, dy_, dx_) + C(F_V, 0, dy_ + 1, dx_));
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
        return 0.5f * (C(F_U, -1, 0, dx_) + C(F_U, 0, 0, dx_)) *
               (0.5f * (Wf(0, 0, dx_ - 1) + Wf(0, 0, dx_)));
      };
      dw = -(Fxw(1) - Fxw(0)) * rdx;
      auto Fyw = [&](int dy_) {
        return 0.5f * (C(F_V, -1, dy_, 0) + C(F_V, 0, dy_, 0)) *
               (0.5f * (Wf(0, dy_ - 1, 0) + Wf(0, dy_, 0)));
      };
      dw = dw - (Fyw(1) - Fyw(0)) * rdy;
      const float wc_k = 0.5f * (w_k + w_k1), wc_km1 = 0.5f * (w_km1 + w_k);
      dw = dw - (rf * wc_k * wc_k - rf_m1 * wc_km1 * wc_km1) * irh;
      auto Kf = [&](int dy_, int dx_) {
        return 0.5f * (Kc(C_KM, -1, dy_, dx_) + Kc(C_KM, 0, dy_, dx_));
      };
      const float Kf0 = Kf(0, 0);
      const float Kfx0 = 0.5f * (Kf(0, -1) + Kf0), Kfx1 = 0.5f * (Kf0 + Kf(0, 1));
      const float Kfy0 = 0.5f * (Kf(-1, 0) + Kf0), Kfy1 = 0.5f * (Kf0 + Kf(1, 0));
      dw = dw - ((-Kfx1 * (Wf(0, 0, 1) - w_k) * rdx) -
                 (-Kfx0 * (w_k - Wf(0, 0, -1)) * rdx)) * rdx;
      dw = dw - ((-Kfy1 * (Wf(0, 1, 0) - w_k) * rdy) -
                 (-Kfy0 * (w_k - Wf(0, -1, 0)) * rdy)) * rdy;
      const float Fd_k = -fmv * rf * (0.25f * Kmm + 0.5f * Km0 + 0.25f * Kmp) *
                         (w_k1 - w_k) * rdz;
      const float Fd_km1 = -fm_m1 * rf_m1 *
                           (0.25f * Kmmm + 0.5f * Kmm + 0.25f * Km0) *
                           (w_k - w_km1) * rdz;
      dw = dw - (Fd_k - Fd_km1) * irh;
    }

    // ---- buoyancy, from thv at g and g-1 (computed once per point) ----
    const float thvm_c = mns[g], thvm_c_m1 = mns[clampz(g - 1, nz)];
    const float b_0 = GRAV * (t_0.thv - thvm_c) / fmaxf(thvm_c, 1.0f);
    const float b_m1 = GRAV * (t_m.thv - thvm_c_m1) / fmaxf(thvm_c_m1, 1.0f);
    dw = dw + 0.5f * (b_0 + b_m1) * m0;
    dw = m0 * dw;

    // ---- TKE sources ----
    de12 = de12 + Kc(C_SRC, 0, 0, 0);

    // ---- coriolis ----
    if (a.f_cor != 0.f) {
      const float vc_at_u = 0.25f * (v0 + C(F_V, 0, 1, 0) + C(F_V, 0, 0, -1) +
                                     C(F_V, 0, 1, -1));
      const float uc_at_v = 0.25f * (u0 + C(F_U, 0, 0, 1) + C(F_U, 0, -1, 0) +
                                     C(F_U, 0, -1, 1));
      du = du + a.f_cor * vc_at_u;
      dv = dv - a.f_cor * uc_at_v;
    }

    // ---- coupler forcings ----
    const float thl_0 = C(F_THL, 0, 0, 0), qt_0 = C(F_QT, 0, 0, 0);
    const float qr_0 = C(F_QR, 0, 0, 0);
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
    const float iex_0 = iex_l[g];
    const float fi_0 = ice_frac(t_0.T);
    const float ql_pos = fmaxf(t_0.ql, 0.f);
    float auto_ = 0.f, accr = 0.f;  // both 0 without cloud water (qi0 >= 0)
    if (ql_pos > 0.f || a.ice_qi0 < 0.f) {
      auto_ = a.auto_k * powf(ql_pos * (1.0f - fi_0), 2.47f) * a.nc_fac +
              fmaxf(ql_pos * fi_0 - a.ice_qi0, 0.f) * r_ice_tau;
      accr = a.accr_k * powf(ql_pos * fmaxf(qr_0, 0.f), 1.15f);
    }
    const float to_rain = fminf(auto_ + accr, ql_pos * rdtv);
    const float qv_0 = qt_0 - t_0.ql;
    const float subsat =
        fminf(fmaxf((t_0.qs - qv_0) / fmaxf(t_0.qs, 1e-8f), 0.f), 1.f);
    const float evap = fminf(subsat * qr_0 * r_evap_tau, fmaxf(qr_0, 0.f) * rdtv);
    float mdqr = to_rain - evap;
    dqt = dqt - to_rain + evap;
    const float lheat = (1.0f - fi_0) * RLV + fi_0 * (float)D_RLS;
    dthl = dthl - lheat / CP * iex_0 * evap;
    const float flux_p1 = g < nz - 1 ? t_p.flux : 0.f;
    const float dqr_sed = (flux_p1 - t_0.flux) * irf;
    mdqr = fmaxf(mdqr + dqr_sed, -fmaxf(qr_0, 0.f) * rdtv);
    dqr = dqr + mdqr;

    // ---- sponge layer ----
    const float zs = a.zs;  // top of the undamped column, nz*dz - depth
    const float zf = ((float)g + 0.5f) * dz;
    const float rate = fminf(fmaxf((zf - zs) * r_sp_depth, 0.f), 1.f) * r_sp_tau;
    du = du - rate * (u0 - mns[3 * nz + g]);
    dv = dv - rate * (v0 - mns[4 * nz + g]);
    dthl = dthl - rate * (thl_0 - mns[nz + g]);
    dqt = dqt - rate * (qt_0 - mns[2 * nz + g]);
    const float zh = (float)g * dz;
    const float rate_h = fminf(fmaxf((zh - zs) * r_sp_depth, 0.f), 1.f) * r_sp_tau;
    dw = dw - rate_h * w_k;

    // ---- RK axpy + clips ----
    if (own) {
      const size_t o = offo + (size_t)g * P + (size_t)gy * nx + gx;
      const size_t ow = offwo + (size_t)g * P + (size_t)gy * nx + gx;
      a.un[o] = a.ub[o] + fstep * du;
      a.vn[o] = a.vb[o] + fstep * dv;
      a.wn[o] = a.wb[ow] + fstep * dw;
      a.thln[o] = a.thlb[o] + fstep * dthl;
      a.qtn[o] = fmaxf(a.qtb[o] + fstep * dqt, 0.f);
      a.qrn[o] = fmaxf(a.qrb[o] + fstep * dqr, 0.f);
      a.e12n[o] = fmaxf(a.e12b[o] + fstep * de12, E12_MIN);
      kmax_bits = max(kmax_bits, __float_as_uint(Km0));
    }
    t_m = t_0;
    t_0 = t_p;
  }

  const unsigned bits = __reduce_max_sync(0xffffffffu, kmax_bits);
  if ((tid & 31) == 0)
    atomicMax(reinterpret_cast<unsigned*>(a.aux + b * 3), bits);
}

cudaError_t launch_stage(const StageArgs& a, cudaStream_t stream) {
  if (a.tx != TX || a.ty != TY || a.smem < Tile::BYTES || a.tz < 1 ||
      (a.halo != 0 && a.halo < HALO))
    return cudaErrorInvalidValue;
  static int allowed[stencil::MAX_DEVICES] = {};
  const cudaError_t e = stencil::allow_shared(k_stage, a.smem, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(((a.nx + TX - 1) / TX) * ((a.ny + TY - 1) / TY),
                  (a.nz + a.tz - 1) / a.tz, a.n);
  k_stage<<<grid, TX * TY, a.smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_means(const StageArgs& a, cudaStream_t stream) {
  if (a.halo != 0 && a.halo < HALO) return cudaErrorInvalidValue;
  k_means<<<dim3(a.nz, a.n), NT_MEANS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lesstage_stage(const StageArgs* args, cudaStream_t stream) {
  StageArgs a = *args;
  a.sums = nullptr;
  const cudaError_t e = launch_means(a, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_stage(a, stream);
}

extern "C" int lesstage_means(const StageArgs* args, cudaStream_t stream) {
  return (int)launch_means(*args, stream);
}

extern "C" int lesstage_apply(const StageArgs* args, cudaStream_t stream) {
  return (int)launch_stage(*args, stream);
}
