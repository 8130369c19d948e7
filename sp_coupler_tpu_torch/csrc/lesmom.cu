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
// diffused with the face-interpolated viscosity (Km[k-1] + Km[k]) / 2 and
// the densities swapped (rhobf at its faces, rhobh at its cells), its
// vertical diffusive flux zeroed at cells 0 and nz-1 (masks fm, fm_m1);
// dw at face 0 zeroed (mask m0) and dw at face nz written as 0.
//
// What bounds it: memory traffic. At 64x64x160 and n = 1 a field is 2.62 MB;
// the kernel reads 4 fields (u, v, w, Km) and writes 3, about 18 MB, which is
// 5.5 us at 3.35 TB/s; the ~250 flops a point are far below the card's rate.
// This first version is one thread per point computing all three
// tendencies, reading its stencil (+-1 in x and y, -2..+1 in z) straight
// from global memory: neighbouring threads share it, so L1/L2 do the reuse
// and device-memory traffic stays near one read of each field. Tiling x/y in
// shared memory is later work.
//
// Plain C interface for ctypes: lesmom_tend returns cudaGetLastError().

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using stencil::clampz;
using stencil::wrap;

constexpr int NT = 256;  // threads per block

struct Mom {
  // u, v, Km [n, nz, P]; w [n, nz+1, P]; rhobf [n, nz]; rhobh [n, nz+1];
  // du, dv [n, nz, P]; dw [n, nz+1, P]; P = ny * nx
  const float *u, *v, *w, *Km, *rhobf, *rhobh;
  float *du, *dv, *dw;
  int nz, ny, nx;
  float dx, dy, dz;
};

__global__ void __launch_bounds__(NT) k_momentum(Mom a) {
  const int i = blockIdx.x * NT + threadIdx.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int nz = a.nz, ny = a.ny, nx = a.nx, P = ny * nx;
  if (i >= P) return;
  const int y = i / nx, x = i - y * nx;
  const size_t off = (size_t)b * nz * P;
  const float *u = a.u + off, *v = a.v + off, *Km = a.Km + off;
  const float* w = a.w + (size_t)b * (nz + 1) * P;
  const float dx = a.dx, dy = a.dy, dz = a.dz;

  auto C = [&](const float* f, int dk, int dy_, int dx_) {
    return f[((size_t)clampz(g + dk, nz) * ny + wrap(y + dy_, ny)) * nx +
             wrap(x + dx_, nx)];
  };
  // w on the face grid, edge-replicated outside faces 0..nz
  auto Wf = [&](int dk, int dy_, int dx_) {
    return w[((size_t)clampz(g + dk, nz + 1) * ny + wrap(y + dy_, ny)) * nx +
             wrap(x + dx_, nx)];
  };

  const float rf = a.rhobf[b * nz + g];
  const float m0 = g == 0 ? 0.f : 1.f;
  const float rf_m1 = g == 0 ? 0.f : a.rhobf[b * nz + g - 1];
  const float rh_lo = a.rhobh[b * (nz + 1) + g];
  const float rh_hi = a.rhobh[b * (nz + 1) + g + 1];
  const float irf = 1.0f / (rf * dz);
  const float irh = 1.0f / (rh_lo * dz);
  const float fm = (g == 0 || g == nz - 1) ? 0.f : 1.f;
  const float fm_m1 = (g - 1 <= 0 || g - 1 == nz - 1) ? 0.f : 1.f;

  const float u0 = C(u, 0, 0, 0), um = C(u, -1, 0, 0), up = C(u, 1, 0, 0);
  const float v0 = C(v, 0, 0, 0), vm = C(v, -1, 0, 0), vp = C(v, 1, 0, 0);
  const float w_k = Wf(0, 0, 0), w_km1 = Wf(-1, 0, 0), w_k1 = Wf(1, 0, 0);
  const float K0 = C(Km, 0, 0, 0), Kl = C(Km, -1, 0, 0);
  const float Ku = C(Km, 1, 0, 0), Kll = C(Km, -2, 0, 0);

  // Km interpolated to the x- and y-faces of the cell
  const float Kx0 = 0.5f * (C(Km, 0, 0, -1) + K0);
  const float Kx1 = 0.5f * (K0 + C(Km, 0, 0, 1));
  const float Ky0 = 0.5f * (C(Km, 0, -1, 0) + K0);
  const float Ky1 = 0.5f * (K0 + C(Km, 0, 1, 0));

  // ---- du (x-face points) ----
  auto ucen = [&](int dx_) {
    return 0.5f * (C(u, 0, 0, dx_) + C(u, 0, 0, dx_ + 1));
  };
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
  du = du - (rh_hi * wbx_k1 * 0.5f * (u0 + up) -
             rh_lo * wbx_k * 0.5f * (um + u0)) * irf;
  {
    const float Fdx0 = -Kx0 * (u0 - C(u, 0, 0, -1)) / dx;
    const float Fdx1 = -Kx1 * (C(u, 0, 0, 1) - u0) / dx;
    du = du - (Fdx1 - Fdx0) / dx;
    const float Fdy0 = -Ky0 * (u0 - C(u, 0, -1, 0)) / dy;
    const float Fdy1 = -Ky1 * (C(u, 0, 1, 0) - u0) / dy;
    du = du - (Fdy1 - Fdy0) / dy;
    const float Fz_lo = -rh_lo * 0.5f * (Kl + K0) * (u0 - um) / dz;
    const float Fz_hi = -rh_hi * 0.5f * (K0 + Ku) * (up - u0) / dz;
    du = du - (Fz_hi - Fz_lo) * irf;
  }

  // ---- dv (y-face points) ----
  auto vcen = [&](int dy_) {
    return 0.5f * (C(v, 0, dy_, 0) + C(v, 0, dy_ + 1, 0));
  };
  const float Fyv0 = vcen(0) * vcen(0), Fyv_m = vcen(-1) * vcen(-1);
  float dv = -(Fyv0 - Fyv_m) / dy;
  // corner fluxes u_bar(y) * v_bar(x) at x-faces x and x+1
  auto Fxv = [&](int dx_) {
    return 0.5f * (C(u, 0, -1, dx_) + C(u, 0, 0, dx_)) *
           (0.5f * (C(v, 0, 0, dx_ - 1) + C(v, 0, 0, dx_)));
  };
  dv = dv - (Fxv(1) - Fxv(0)) / dx;
  const float wby_k = 0.5f * (Wf(0, -1, 0) + w_k);
  const float wby_k1 = 0.5f * (Wf(1, -1, 0) + w_k1);
  dv = dv - (rh_hi * wby_k1 * 0.5f * (v0 + vp) -
             rh_lo * wby_k * 0.5f * (vm + v0)) * irf;
  {
    const float Fdx0 = -Kx0 * (v0 - C(v, 0, 0, -1)) / dx;
    const float Fdx1 = -Kx1 * (C(v, 0, 0, 1) - v0) / dx;
    dv = dv - (Fdx1 - Fdx0) / dx;
    const float Fdy0 = -Ky0 * (v0 - C(v, 0, -1, 0)) / dy;
    const float Fdy1 = -Ky1 * (C(v, 0, 1, 0) - v0) / dy;
    dv = dv - (Fdy1 - Fdy0) / dy;
    const float Fz_lo = -rh_lo * 0.5f * (Kl + K0) * (v0 - vm) / dz;
    const float Fz_hi = -rh_hi * 0.5f * (K0 + Ku) * (vp - v0) / dz;
    dv = dv - (Fz_hi - Fz_lo) * irf;
  }

  // ---- dw (z-face g) ----
  auto Fxw = [&](int dx_) {
    return 0.5f * (C(u, -1, 0, dx_) + C(u, 0, 0, dx_)) *
           (0.5f * (Wf(0, 0, dx_ - 1) + Wf(0, 0, dx_)));
  };
  float dw = -(Fxw(1) - Fxw(0)) / dx;
  auto Fyw = [&](int dy_) {
    return 0.5f * (C(v, -1, dy_, 0) + C(v, 0, dy_, 0)) *
           (0.5f * (Wf(0, dy_ - 1, 0) + Wf(0, dy_, 0)));
  };
  dw = dw - (Fyw(1) - Fyw(0)) / dy;
  const float wc_k = 0.5f * (w_k + w_k1), wc_km1 = 0.5f * (w_km1 + w_k);
  dw = dw - (rf * wc_k * wc_k - rf_m1 * wc_km1 * wc_km1) * irh;
  // face-interpolated viscosity Kf = (Km[k-1] + Km[k]) / 2
  auto Kf = [&](int dy_, int dx_) {
    return 0.5f * (C(Km, -1, dy_, dx_) + C(Km, 0, dy_, dx_));
  };
  {
    const float Kf0 = Kf(0, 0);
    const float Kfx0 = 0.5f * (Kf(0, -1) + Kf0), Kfx1 = 0.5f * (Kf0 + Kf(0, 1));
    const float Kfy0 = 0.5f * (Kf(-1, 0) + Kf0), Kfy1 = 0.5f * (Kf0 + Kf(1, 0));
    const float Fdx0 = -Kfx0 * (w_k - Wf(0, 0, -1)) / dx;
    const float Fdx1 = -Kfx1 * (Wf(0, 0, 1) - w_k) / dx;
    dw = dw - (Fdx1 - Fdx0) / dx;
    const float Fdy0 = -Kfy0 * (w_k - Wf(0, -1, 0)) / dy;
    const float Fdy1 = -Kfy1 * (Wf(0, 1, 0) - w_k) / dy;
    dw = dw - (Fdy1 - Fdy0) / dy;
    // vertical: flux at cell g (faces g, g+1) and cell g-1, zeroed at the
    // outermost cells
    const float Fd_k = -fm * rf * (0.25f * Kl + 0.5f * K0 + 0.25f * Ku) *
                       (w_k1 - w_k) / dz;
    const float Fd_km1 = -fm_m1 * rf_m1 * (0.25f * Kll + 0.5f * Kl + 0.25f * K0) *
                         (w_k - w_km1) / dz;
    dw = dw - (Fd_k - Fd_km1) * irh;
  }
  dw = m0 * dw;

  const size_t o = off + (size_t)g * P + i;
  const size_t ow = (size_t)b * (nz + 1) * P + (size_t)g * P + i;
  a.du[o] = du;
  a.dv[o] = dv;
  a.dw[ow] = dw;
  if (g == nz - 1) a.dw[ow + P] = 0.f;
}

}  // namespace

extern "C" int lesmom_tend(const float* u, const float* v, const float* w,
                           const float* Km, const float* rhobf,
                           const float* rhobh, float* du, float* dv, float* dw,
                           int n, int nz, int ny, int nx, float dx, float dy,
                           float dz, cudaStream_t stream) {
  const Mom a{u, v, w, Km, rhobf, rhobh, du, dv, dw, nz, ny, nx, dx, dy, dz};
  const int P = ny * nx;
  k_momentum<<<dim3((P + NT - 1) / NT, nz, n), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
