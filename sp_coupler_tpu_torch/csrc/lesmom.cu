// Momentum advection + subgrid diffusion tendencies of the LES, for NVIDIA
// Hopper (sm_90a). Replaces the Pallas TPU kernel
// sp_coupler_tpu/ops/lesmom_pallas.py::_kernel (via _batched_call,
// momentum_tendencies): du, dv at the u/v points and dw at the z-faces from
// 2nd-order flux-form advection plus down-gradient diffusion with Km, as
// models/les/advect.py advect_u/v/w plus models/les/subgrid.py
// diffuse_momentum without the surface stress (the caller adds that on
// plane 0).
//
// Semantics kept from the TPU kernel: u, v and Km edge-replicated in z on
// the cell grid and w on the face grid (faces 0..nz as given, so the outer
// advective fluxes vanish only by the state invariant w[0] = w[nz] = 0);
// Km two levels down edge-clamped; rhobf[k-1] taken as 0 at k = 0; w
// diffused with the face-interpolated viscosity Kf = (Km[k-1] + Km[k]) / 2
// and the densities swapped (rhobf at its faces, rhobh at its cells), its
// vertical diffusive flux zeroed at cells 0 and nz-1 (masks fm, fm_m1);
// dw at face 0 zeroed (mask m0) and dw at face nz written as 0.
//
// Halo mode (halo = h > 0, for a rank's block of a plane split over ranks):
// u, v, w and Km are the block padded with h >= 3 points a side by its
// neighbours' values (parallel/plane.py), [.., ny + 2h, nx + 2h]; the
// launch covers the block's ny x nx columns and du, dv, dw are unpadded.
// Only the row/column tables change (stencil::plane_index); with halo 0
// the kernel is the whole-plane one, periodic in x and y.
//
// The bound: bytes. At 64x64x160 and n = 1 a field is 2.62 MB; the kernel
// reads 4 fields (u, v, w, Km) and writes 3, 18.4 MB, 5.5 us at 3.35 TB/s;
// ~230 float operations a point (ops/bounds.py, KERNEL_OPS) take 2.3 us
// at the data sheet's 67 TFLOP/s of float32. Read straight from global memory for each
// point, the stencil (+-1 in x and y, -2..+1 in z) costs far more
// instructions and L1/L2 traffic than either: ~60 reads a point through
// clamped and wrapped 64-bit index arithmetic, the corner fluxes and the
// face viscosity computed two to four times, ~30 divisions a point. So
// the design cuts the instructions a point.
//
// The design: one block per (TX x TY tile of columns, chunk of tz levels,
// instance), one thread per column, marching upward in z.
//   - u, v, w and Km go through a ring of NSLOT z-planes in shared memory,
//     each over the tile plus a 1-point periodic x/y halo (corners
//     included), filled by cp.async: the next level's planes are in flight
//     while the current one is computed. A tile wider than the plane wraps
//     through the row/column tables.
//   - Each horizontal face flux of the level is computed once, by one
//     thread, into shared memory: the centred fluxes u_c^2 and v_c^2, the
//     corner flux v_bar(x) u_bar(y) (du's y-flux and dv's x-flux are the
//     same product), u_bar(z) w_bar(x) and v_bar(z) w_bar(y) for w, and the
//     diffusive fluxes of u, v (with Km at the faces) and w (with Kf at the
//     faces). Kf itself is computed once per point of the plane + halo, a
//     level ahead, into a 2-plane ring. Each thread then differences the
//     fluxes of its cell's faces; the tile's far faces take one extra row
//     and column of fluxes.
//   - The vertical fluxes are carried up: the flux through a cell's upper
//     face is the next level's lower-face flux, the same expression, kept
//     in a register. The column's u, v, w and Km at the levels around it
//     stay in registers too.
//   - 1/dx, 1/dy, 1/dz once per launch, 1/(rhobf dz) and 1/(rhobh dz) once
//     per level, multiplied where the plain version divides (the
//     diffusive fluxes' /dx, /dy, /dz and every difference's /dx, /dy), so
//     last bits differ from it.
// A chunk starts by copying the planes of its first level and the one
// below, and reads Km two levels down from memory. The launch geometry
// (tz, shared-memory bytes) comes from ops/lesmom.py::momentum_geometry.
//
// Plain C interface for ctypes: lesmom_tend returns cudaGetLastError().

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using stencil::clampz;
using stencil::cp_async_commit;
using stencil::cp_async_f32;
using stencil::cp_async_wait_all;
using stencil::plane_index;
using stencil::ring;

constexpr int TX = 32, TY = 8;  // the tile of columns, ops/lesmom.py TX, TY
constexpr int NT = TX * TY;     // one thread per column of the tile
constexpr int NF = 4;           // fields in the ring
constexpr int NSLOT = 4;        // planes k-1..k+1 live, k+2 in flight
constexpr int RESIDENT = 4;     // blocks an SM, ops/lesmom.py RESIDENT
enum { F_U, F_V, F_W, F_K };
// the flux planes, one value per face (or corner) of the tile: x-faces
// (between columns x-1 and x), y-faces, and the corner of the two
enum {
  X_UU, X_KU, X_KV, X_UW, X_KW,  // x-faces
  Y_VV, Y_KU, Y_KV, Y_VW, Y_KW,  // y-faces
  C_UV,                          // corners
  NFLUX
};

// shared-memory layout of a block; ops/lesmom.py::shared_bytes computes the
// same byte count
struct Tile {
  static constexpr int W = TX + 2, H = TY + 2, PL = W * H;  // 1-point halo
  static constexpr int FW = TX + 1, FL = FW * (TY + 1);     // flux plane
  static constexpr int FLD = NSLOT * NF * PL;  // field ring (floats)
  static constexpr int KF = 2 * PL;            // Kf ring (floats)
  static constexpr int FLX = NFLUX * FL;       // flux planes (floats)
  static constexpr int BYTES = 4 * (FLD + KF + FLX) + 4 * (W + H);
};
static_assert(Tile::BYTES <= 48 * 1024, "beyond the default allowance");

struct Mom {
  // u, v, Km [n, nz, PP]; w [n, nz+1, PP]; rhobf [n, nz]; rhobh [n, nz+1];
  // du, dv [n, nz, P]; dw [n, nz+1, P]; P = ny * nx, PP = (ny + 2 halo) x
  // (nx + 2 halo)
  const float *u, *v, *w, *Km, *rhobf, *rhobh;
  float *du, *dv, *dw;
  int nz, ny, nx, tz, halo;
  float dx, dy, dz;
};

__global__ void __launch_bounds__(NT, RESIDENT) k_momentum(Mom a) {
  using L = Tile;
  constexpr int W = L::W, PL = L::PL, FW = L::FW, FL = L::FL;
  extern __shared__ float smem[];
  float* const fld = smem;            // [NSLOT][NF][PL]
  float* const kfr = fld + L::FLD;    // [2][PL]
  float* const flx = kfr + L::KF;     // [NFLUX][FL]
  int* const rowoff = reinterpret_cast<int*>(flx + L::FLX);  // [H] y*pnx
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
  const int ci = (ty + 1) * W + tx + 1;  // the column in a plane

  for (int i = tid; i < L::H; i += NT)
    rowoff[i] = plane_index(y0 + i - 1, ny, h) * pnx;
  for (int i = tid; i < W; i += NT) colx[i] = plane_index(x0 + i - 1, nx, h);
  __syncthreads();

  const size_t off = (size_t)b * nz * PP;
  const size_t offw = (size_t)b * (nz + 1) * PP;
  const float* const rhobf = a.rhobf + b * nz;
  const float* const rhobh = a.rhobh + b * (nz + 1);
  const float dz = a.dz;
  const float rdx = 1.0f / a.dx, rdy = 1.0f / a.dy, rdz = 1.0f / dz;

  auto plane = [&](int j) { return fld + ring(j, NSLOT) * NF * PL; };

  // start the copies of level j: cells clamp to [0, nz-1], w faces to
  // [0, nz]
  auto load = [&](int j) {
    float* const dst = plane(j);
    const size_t c = off + (size_t)clampz(j, nz) * PP;
    const size_t cw = offw + (size_t)clampz(j, nz + 1) * PP;
    for (int i = tid; i < PL; i += NT) {
      const int r = i / W, q = i - r * W;
      const int o = rowoff[r] + colx[q];
      cp_async_f32(dst + F_U * PL + i, a.u + c + o);
      cp_async_f32(dst + F_V * PL + i, a.v + c + o);
      cp_async_f32(dst + F_W * PL + i, a.w + cw + o);
      cp_async_f32(dst + F_K * PL + i, a.Km + c + o);
    }
    cp_async_commit();
  };

  // Kf of level j over the plane + halo, from the Km planes of j-1 and j
  auto face_visc = [&](int j) {
    const float* const km = plane(j - 1) + F_K * PL;
    const float* const kc = plane(j) + F_K * PL;
    float* const out = kfr + (j & 1) * PL;
    for (int i = tid; i < PL; i += NT) out[i] = 0.5f * (km[i] + kc[i]);
  };

  // the fluxes of level g at tile position (ly, lx), ly in [0, TY], lx in
  // [0, TX]: x-face lx of row ly (ly < TY), y-face ly of column lx
  // (lx < TX), and their corner
  auto fluxes = [&](int g, int ly, int lx) {
    const float* const p = plane(g) + (ly + 1) * W + lx + 1;
    const float* const pm = plane(g - 1) + (ly + 1) * W + lx + 1;
    const float* const kf = kfr + (g & 1) * PL + (ly + 1) * W + lx + 1;
    float* const f = flx + ly * FW + lx;
    const float u_c = p[F_U * PL], v_c = p[F_V * PL], w_c = p[F_W * PL];
    const float k_c = p[F_K * PL];
    if (ly < TY) {
      const float u_l = p[F_U * PL - 1], w_l = p[F_W * PL - 1];
      const float uc = 0.5f * (u_l + u_c);  // u at the cell centre x-1
      f[X_UU * FL] = uc * uc;
      const float Kx = 0.5f * (p[F_K * PL - 1] + k_c);
      f[X_KU * FL] = -Kx * (u_c - u_l) * rdx;
      f[X_KV * FL] = -Kx * (v_c - p[F_V * PL - 1]) * rdx;
      f[X_UW * FL] = 0.5f * (pm[F_U * PL] + u_c) * (0.5f * (w_l + w_c));
      const float Kfx = 0.5f * (kf[-1] + kf[0]);
      f[X_KW * FL] = -Kfx * (w_c - w_l) * rdx;
    }
    if (lx < TX) {
      const float v_b = p[F_V * PL - W], w_b = p[F_W * PL - W];
      const float vc = 0.5f * (v_b + v_c);  // v at the cell centre y-1
      f[Y_VV * FL] = vc * vc;
      const float Ky = 0.5f * (p[F_K * PL - W] + k_c);
      f[Y_KU * FL] = -Ky * (u_c - p[F_U * PL - W]) * rdy;
      f[Y_KV * FL] = -Ky * (v_c - v_b) * rdy;
      f[Y_VW * FL] = 0.5f * (pm[F_V * PL] + v_c) * (0.5f * (w_b + w_c));
      const float Kfy = 0.5f * (kf[-W] + kf[0]);
      f[Y_KW * FL] = -Kfy * (w_c - w_b) * rdy;
    }
    f[C_UV * FL] =
        0.5f * (p[F_V * PL - 1] + v_c) * (0.5f * (p[F_U * PL - W] + u_c));
  };

  // prologue: levels k0-1..k0+1, Kf(k0), the column's values and the
  // fluxes through the lower faces of level k0
  load(k0 - 1);
  load(k0);
  load(k0 + 1);
  const float K_mm = a.Km[off + (size_t)clampz(k0 - 2, nz) * PP + rowoff[ty + 1] +
                          colx[tx + 1]];
  cp_async_wait_all();
  __syncthreads();
  face_visc(k0);

  float u_0, v_0, w_0, K_m, K_0;
  float Fu_a, Fu_d, Fv_a, Fv_d, Fw_a, Fw_d;  // lower-face vertical fluxes
  {
    const float* const pm = plane(k0 - 1) + ci;
    const float* const p0 = plane(k0) + ci;
    const float u_m = pm[F_U * PL], v_m = pm[F_V * PL], w_m = pm[F_W * PL];
    u_0 = p0[F_U * PL];
    v_0 = p0[F_V * PL];
    w_0 = p0[F_W * PL];
    K_m = pm[F_K * PL];
    K_0 = p0[F_K * PL];
    const float rh_lo = rhobh[k0];
    const float rf_m1 = k0 == 0 ? 0.f : rhobf[k0 - 1];
    const float fm_m1 = (k0 - 1 <= 0 || k0 - 1 == nz - 1) ? 0.f : 1.f;
    const float wbx = 0.5f * (p0[F_W * PL - 1] + w_0);
    const float wby = 0.5f * (p0[F_W * PL - W] + w_0);
    Fu_a = rh_lo * wbx * 0.5f * (u_m + u_0);
    Fv_a = rh_lo * wby * 0.5f * (v_m + v_0);
    Fu_d = -rh_lo * 0.5f * (K_m + K_0) * (u_0 - u_m) * rdz;
    Fv_d = -rh_lo * 0.5f * (K_m + K_0) * (v_0 - v_m) * rdz;
    const float wc = 0.5f * (w_m + w_0);
    Fw_a = rf_m1 * wc * wc;
    Fw_d = -fm_m1 * rf_m1 * (0.25f * K_mm + 0.5f * K_m + 0.25f * K_0) *
           (w_0 - w_m) * rdz;
  }

  for (int g = k0; g < k1; ++g) {
    cp_async_wait_all();
    __syncthreads();  // level g+1 is in; every read of step g-1 is done
    if (g + 2 <= k1) load(g + 2);
    fluxes(g, ty, tx);
    if (tid < TY)
      fluxes(g, tid, TX);  // x-faces of the column beyond the tile
    else if (tid < TY + TX + 1)
      fluxes(g, TY, tid - TY);  // y-faces of the row beyond the tile
    if (g + 1 < k1) face_visc(g + 1);
    __syncthreads();

    auto F = [&](int fi, int dy_, int dx_) {
      return flx[fi * FL + (ty + dy_) * FW + tx + dx_];
    };
    const float* const pp = plane(g + 1) + ci;
    const float u_p = pp[F_U * PL], v_p = pp[F_V * PL], w_p = pp[F_W * PL];
    const float K_p = pp[F_K * PL];
    const float rf = rhobf[g];
    const float rh_lo = rhobh[g], rh_hi = rhobh[g + 1];
    const float irf = 1.0f / (rf * dz), irh = 1.0f / (rh_lo * dz);
    const float m0 = g == 0 ? 0.f : 1.f;
    const float fm = (g == 0 || g == nz - 1) ? 0.f : 1.f;

    // du (x-face point)
    const float Fu_a_hi =
        rh_hi * (0.5f * (pp[F_W * PL - 1] + w_p)) * 0.5f * (u_0 + u_p);
    const float Fu_d_hi = -rh_hi * 0.5f * (K_0 + K_p) * (u_p - u_0) * rdz;
    float du = -(F(X_UU, 0, 1) - F(X_UU, 0, 0)) * rdx;
    du = du - (F(C_UV, 1, 0) - F(C_UV, 0, 0)) * rdy;
    du = du - (Fu_a_hi - Fu_a) * irf;
    du = du - (F(X_KU, 0, 1) - F(X_KU, 0, 0)) * rdx;
    du = du - (F(Y_KU, 1, 0) - F(Y_KU, 0, 0)) * rdy;
    du = du - (Fu_d_hi - Fu_d) * irf;

    // dv (y-face point)
    const float Fv_a_hi =
        rh_hi * (0.5f * (pp[F_W * PL - W] + w_p)) * 0.5f * (v_0 + v_p);
    const float Fv_d_hi = -rh_hi * 0.5f * (K_0 + K_p) * (v_p - v_0) * rdz;
    float dv = -(F(Y_VV, 1, 0) - F(Y_VV, 0, 0)) * rdy;
    dv = dv - (F(C_UV, 0, 1) - F(C_UV, 0, 0)) * rdx;
    dv = dv - (Fv_a_hi - Fv_a) * irf;
    dv = dv - (F(X_KV, 0, 1) - F(X_KV, 0, 0)) * rdx;
    dv = dv - (F(Y_KV, 1, 0) - F(Y_KV, 0, 0)) * rdy;
    dv = dv - (Fv_d_hi - Fv_d) * irf;

    // dw (z-face g): the vertical fluxes at cells g (upper) and g-1
    const float wc = 0.5f * (w_0 + w_p);
    const float Fw_a_hi = rf * wc * wc;
    const float Fw_d_hi = -fm * rf * (0.25f * K_m + 0.5f * K_0 + 0.25f * K_p) *
                          (w_p - w_0) * rdz;
    float dw = -(F(X_UW, 0, 1) - F(X_UW, 0, 0)) * rdx;
    dw = dw - (F(Y_VW, 1, 0) - F(Y_VW, 0, 0)) * rdy;
    dw = dw - (Fw_a_hi - Fw_a) * irh;
    dw = dw - (F(X_KW, 0, 1) - F(X_KW, 0, 0)) * rdx;
    dw = dw - (F(Y_KW, 1, 0) - F(Y_KW, 0, 0)) * rdy;
    dw = dw - (Fw_d_hi - Fw_d) * irh;
    dw = m0 * dw;

    if (own) {
      const size_t o = (size_t)b * nz * P + (size_t)g * P + (size_t)gy * nx + gx;
      const size_t ow =
          (size_t)b * (nz + 1) * P + (size_t)g * P + (size_t)gy * nx + gx;
      a.du[o] = du;
      a.dv[o] = dv;
      a.dw[ow] = dw;
      if (g == nz - 1) a.dw[ow + P] = 0.f;
    }
    u_0 = u_p;
    v_0 = v_p;
    w_0 = w_p;
    K_m = K_0;
    K_0 = K_p;
    Fu_a = Fu_a_hi;
    Fu_d = Fu_d_hi;
    Fv_a = Fv_a_hi;
    Fv_d = Fv_d_hi;
    Fw_a = Fw_a_hi;
    Fw_d = Fw_d_hi;
  }
}

}  // namespace

extern "C" int lesmom_tend(const float* u, const float* v, const float* w,
                           const float* Km, const float* rhobf,
                           const float* rhobh, float* du, float* dv, float* dw,
                           int n, int nz, int ny, int nx, int tz, int smem,
                           int halo, float dx, float dy, float dz,
                           cudaStream_t stream) {
  if (tz < 1 || smem < Tile::BYTES || smem > 48 * 1024 ||
      (halo != 0 && halo < 3))
    return (int)cudaErrorInvalidValue;
  const Mom a{u, v, w, Km, rhobf, rhobh, du, dv, dw, nz, ny, nx, tz, halo,
              dx, dy, dz};
  const dim3 grid(((nx + TX - 1) / TX) * ((ny + TY - 1) / TY),
                  (nz + tz - 1) / tz, n);
  k_momentum<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
