// Advection + diffusion tendency of a stack of S cell-centred scalars, for
// NVIDIA Hopper (sm_90a). Replaces two Pallas TPU kernels that compute the
// same thing in two layouts:
//   - sp_coupler_tpu/ops/lesflat_pallas.py::_kernel (via _batched_call,
//     advect_diffuse_scalars), fields [n, S, nz, ny*nx]: C entry lesflat_tend;
//   - sp_coupler_tpu/ops/advect_pallas.py::_kernel (via _batched_call,
//     advect_diffuse_scalars), fields [n, S, nz, ny, nx]: C entry
//     advect_tend.
// The two layouts differ only in how a TPU tiles them into VMEM; on the card
// both are the same contiguous memory, so both entries launch one kernel.
//
// Per point: 5th-order upwind horizontal and 2nd-order vertical flux-form
// advection (DALES iadv=52) plus down-gradient diffusion with the scalar's
// own K. Semantics kept from the TPU kernels: sign(0) == 0 in the face
// value; the vertical advective flux uses rhobh * w at faces k and k+1 as
// given (zero at the outer faces only by the state invariant w[0] = w[nz] =
// 0); s and K are edge-replicated in z, so the vertical diffusive flux
// through the outer faces is zero; 1 / (rhobf dz) as the vertical factor.
// The prescribed surface flux is not included: the caller adds it on plane 0.
//
// What bounds it: memory traffic. At 64x64x160 and n = 1 a field is 2.62 MB;
// with S = 4 the kernel reads 11 fields (u, v, w, 4 K, 4 s) and writes 4,
// about 39 MB, which is 12 us at 3.35 TB/s. The arithmetic (~150 flops a
// point and scalar) is far below the card's rate. This first version is one
// thread per output point, reading its stencil (+-3 in x and y, +-1 in z)
// straight from global memory: neighbouring threads share most of it, so
// L1/L2 do the reuse and device-memory traffic stays near one read of each
// field. Tiling x/y in shared memory is later work.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using stencil::clampz;
using stencil::face5;
using stencil::wrap;

constexpr int NT = 256;  // threads per block

struct Flat {
  // u, v [n, nz, P]; w [n, nz+1, P]; K, s [n, S, nz, P]; rhobf [n, nz];
  // rhobh [n, nz+1]; out [n, S, nz, P]; P = ny * nx
  const float *u, *v, *w, *K, *s, *rhobf, *rhobh;
  float* out;
  int S, nz, ny, nx;
  float dx, dy, dz;
};

__global__ void __launch_bounds__(NT) k_scalar_tend(Flat a) {
  const int i = blockIdx.x * NT + threadIdx.x;
  const int k = blockIdx.y, bs = blockIdx.z;  // bs = instance * S + scalar
  const int b = bs / a.S;
  const int nz = a.nz, ny = a.ny, nx = a.nx, P = ny * nx;
  if (i >= P) return;
  const int y = i / nx, x = i - y * nx;
  const float* u = a.u + ((size_t)b * nz + k) * P;
  const float* v = a.v + ((size_t)b * nz + k) * P;
  const float* w = a.w + ((size_t)b * (nz + 1) + k) * P;
  const float* s = a.s + (size_t)bs * nz * P;
  const float* K = a.K + (size_t)bs * nz * P;
  const float dx = a.dx, dy = a.dy, dz = a.dz;
  auto at = [&](const float* f, int dk, int dy_, int dx_) {
    return f[((size_t)clampz(k + dk, nz) * ny + wrap(y + dy_, ny)) * nx +
             wrap(x + dx_, nx)];
  };

  const float rh_lo = a.rhobh[b * (nz + 1) + k];
  const float rh_hi = a.rhobh[b * (nz + 1) + k + 1];
  const float irfdz = 1.0f / (a.rhobf[b * nz + k] * dz);

  float sx[7], sy[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    sx[j] = at(s, 0, 0, j - 3);
    sy[j] = at(s, 0, j - 3, 0);
  }
  const float s0 = sx[3], sm = at(s, -1, 0, 0), sp = at(s, 1, 0, 0);

  // advection, horizontal: fluxes at faces x, x+1 and y, y+1
  const float u0 = u[i], u1 = u[y * nx + wrap(x + 1, nx)];
  const float v0 = v[i], v1 = v[wrap(y + 1, ny) * nx + x];
  const float Fx0 = u0 * face5(sx[0], sx[1], sx[2], sx[3], sx[4], sx[5], u0);
  const float Fx1 = u1 * face5(sx[1], sx[2], sx[3], sx[4], sx[5], sx[6], u1);
  const float Fy0 = v0 * face5(sy[0], sy[1], sy[2], sy[3], sy[4], sy[5], v0);
  const float Fy1 = v1 * face5(sy[1], sy[2], sy[3], sy[4], sy[5], sy[6], v1);
  float tend = -(Fx1 - Fx0) / dx - (Fy1 - Fy0) / dy;

  // advection, vertical cd2 with rhobh * w at faces k (w[i]) and k+1
  const float wr_lo = w[i] * rh_lo, wr_hi = w[P + i] * rh_hi;
  const float Flo = wr_lo * 0.5f * (sm + s0);
  const float Fhi = wr_hi * 0.5f * (s0 + sp);
  tend = tend - (Fhi - Flo) * irfdz;

  // diffusion, horizontal: K interpolated to the faces
  const float K0 = at(K, 0, 0, 0);
  const float Kx0 = 0.5f * (at(K, 0, 0, -1) + K0);
  const float Kx1 = 0.5f * (K0 + at(K, 0, 0, 1));
  const float Ky0 = 0.5f * (at(K, 0, -1, 0) + K0);
  const float Ky1 = 0.5f * (K0 + at(K, 0, 1, 0));
  const float Fdx0 = -Kx0 * (sx[3] - sx[2]) / dx;
  const float Fdx1 = -Kx1 * (sx[4] - sx[3]) / dx;
  tend = tend - (Fdx1 - Fdx0) / dx;
  const float Fdy0 = -Ky0 * (sy[3] - sy[2]) / dy;
  const float Fdy1 = -Ky1 * (sy[4] - sy[3]) / dy;
  tend = tend - (Fdy1 - Fdy0) / dy;

  // diffusion, vertical (edge-replicated s, K: zero flux at the outer faces)
  const float Fz_lo = -rh_lo * 0.5f * (at(K, -1, 0, 0) + K0) * (s0 - sm) / dz;
  const float Fz_hi = -rh_hi * 0.5f * (K0 + at(K, 1, 0, 0)) * (sp - s0) / dz;
  tend = tend - (Fz_hi - Fz_lo) * irfdz;

  a.out[((size_t)bs * nz + k) * P + i] = tend;
}

int launch(const float* u, const float* v, const float* w, const float* K,
           const float* s, const float* rhobf, const float* rhobh, float* out,
           int n, int S, int nz, int ny, int nx, float dx, float dy, float dz,
           cudaStream_t stream) {
  const Flat a{u, v, w, K, s, rhobf, rhobh, out, S, nz, ny, nx, dx, dy, dz};
  const int P = ny * nx;
  k_scalar_tend<<<dim3((P + NT - 1) / NT, nz, n * S), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lesflat_tend(const float* u, const float* v, const float* w,
                 const float* K, const float* s, const float* rhobf,
                 const float* rhobh, float* out, int n, int S, int nz, int ny,
                 int nx, float dx, float dy, float dz, cudaStream_t stream) {
  return launch(u, v, w, K, s, rhobf, rhobh, out, n, S, nz, ny, nx, dx, dy,
                dz, stream);
}

int advect_tend(const float* u, const float* v, const float* w,
                const float* K, const float* s, const float* rhobf,
                const float* rhobh, float* out, int n, int S, int nz, int ny,
                int nx, float dx, float dy, float dz, cudaStream_t stream) {
  return launch(u, v, w, K, s, rhobf, rhobh, out, n, S, nz, ny, nx, dx, dy,
                dz, stream);
}

}  // extern "C"
