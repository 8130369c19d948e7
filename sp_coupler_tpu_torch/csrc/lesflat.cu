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
// Halo mode (halo = h > 0, for a rank's block of a plane split over ranks):
// u, v, w, K and s are the block padded with h >= 3 points a side by its
// neighbours' values (parallel/plane.py), [.., ny + 2h, nx + 2h]; the
// launch covers the block's ny x nx columns and out is unpadded. Only the
// row/column tables change (stencil::plane_index); with halo 0 the kernel
// is the whole-plane one, periodic in x and y.
//
// The bound: bytes. At 64x64x160 and n = 1 a field is 2.62 MB; with S = 4
// the kernel reads 11 fields (u, v, w, 4 K, 4 s) and writes 4, 39.3 MB,
// 11.7 us at 3.35 TB/s; ~140 float operations a point and scalar
// (ops/bounds.py, KERNEL_OPS) take 5.5 us at the data sheet's 67 TFLOP/s
// of float32. Read straight from global memory for each point and
// scalar, the +-3-point stencil costs far more instructions and L1/L2
// traffic than either: ~31 reads a point through wrapped 64-bit index
// arithmetic, u, v, w re-read for each scalar, each face flux computed by
// both cells that share the face, ~10 divisions a point and scalar. So
// the design cuts the instructions a point.
//
// The design: one block per (TX x TY tile of columns, chunk of tz levels,
// instance, group of up to SMAX scalars: the whole stack of 4 on the LES
// path), one thread per column, marching upward in z.
//   - Each level's planes go through a ring of NSLOT z-planes in shared
//     memory, filled by cp.async: the next level's are in flight while the
//     current one is computed. A plane holds each scalar over the tile plus
//     a 3-point periodic x/y halo (the 5th-order faces), each K, u, v and w
//     over the tile plus a 1-point halo. A tile wider than the plane wraps
//     through the row/column tables.
//   - u, v, w and the density factors are read once for all the block's
//     scalars: P nz (3 + 2 S) floats in all.
//   - Each horizontal face flux (the advective u s_face and the diffusive
//     -K_face ds/dx, on x- and y-faces) is computed once, by one thread,
//     into shared memory, then each thread differences the fluxes of its
//     cell's faces, as the TPU kernel shifts whole flux arrays; the tile's
//     far faces take one extra row and column of fluxes.
//   - The vertical fluxes are carried up: the flux through a cell's upper
//     face is the next level's lower-face flux, the same expression, kept
//     in a register; s and K of the column at k+-1 stay in registers too.
//   - 1/dx, 1/dy, 1/dz once per launch and 1/(rhobf dz) once per level,
//     multiplied where the plain version divides (the diffusive fluxes'
//     /dx, /dy, /dz and the horizontal differences' /dx, /dy), so last
//     bits differ from it.
// A chunk starts by copying the planes of its first two levels and reads
// s and K one level below from memory. The launch geometry (tz, shared-
// memory bytes, scalar groups) comes from ops/lesflat.py::scalar_geometry.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using stencil::clampz;
using stencil::cp_async_commit;
using stencil::cp_async_f32;
using stencil::cp_async_wait_all;
using stencil::face5;
using stencil::plane_index;
using stencil::ring;

constexpr int TX = 32, TY = 8;  // the tile of columns, ops/lesflat.py TX, TY
constexpr int NT = TX * TY;     // one thread per column of the tile
constexpr int HALO = 3;         // x/y halo of the scalar planes
constexpr int SMAX = 4;         // scalars a block takes, ops/lesflat.py SMAX
constexpr int NSLOT = 3;        // planes k, k+1 live, k+2 in flight
constexpr int RESIDENT = 3;     // blocks an SM, ops/lesflat.py RESIDENT
// a scalar's flux planes, one value per face of the tile: advective and
// diffusive, on x-faces (between columns x-1 and x) and y-faces
enum { X_A, Y_A, X_D, Y_D, NFLUX };

// shared-memory layout of a block; ops/lesflat.py::shared_bytes computes
// the same byte count
struct Tile {
  static constexpr int SW = TX + 2 * HALO, SH = TY + 2 * HALO;
  static constexpr int SPL = SW * SH;                  // scalar plane
  static constexpr int KW = TX + 2, KPL = KW * (TY + 2);  // 1-point halo
  // a level's slot: SMAX scalars, SMAX K, u, v, w
  static constexpr int K_OFF = SMAX * SPL, U_OFF = K_OFF + SMAX * KPL;
  static constexpr int V_OFF = U_OFF + KPL, W_OFF = V_OFF + KPL;
  static constexpr int SLOT = W_OFF + KPL;
  static constexpr int FW = TX + 1, FL = FW * (TY + 1);  // flux plane
  static constexpr int FLD = NSLOT * SLOT;            // ring (floats)
  static constexpr int FLX = SMAX * NFLUX * FL;       // flux planes (floats)
  static constexpr int BYTES = 4 * (FLD + FLX) + 4 * (SW + SH);
};

struct Flat {
  // u, v [n, nz, PP]; w [n, nz+1, PP]; K, s [n, S, nz, PP]; rhobf [n, nz];
  // rhobh [n, nz+1]; out [n, S, nz, P]; P = ny * nx, PP = (ny + 2 halo) x
  // (nx + 2 halo)
  const float *u, *v, *w, *K, *s, *rhobf, *rhobh;
  float* out;
  int S, nz, ny, nx, tz, halo;
  float dx, dy, dz;
};

__global__ void __launch_bounds__(NT, RESIDENT) k_scalars(Flat a) {
  using L = Tile;
  constexpr int SW = L::SW, SPL = L::SPL, KW = L::KW, KPL = L::KPL;
  constexpr int FW = L::FW, FL = L::FL;
  extern __shared__ float smem[];
  float* const fld = smem;             // [NSLOT][SLOT]
  float* const flx = fld + L::FLD;     // [SMAX][NFLUX][FL]
  int* const rowoff = reinterpret_cast<int*>(flx + L::FLX);  // [SH] y*pnx
  int* const colx = rowoff + L::SH;                          // [SW] x

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int S = a.S, nz = a.nz, ny = a.ny, nx = a.nx, P = ny * nx;
  const int h = a.halo, pnx = nx + 2 * h, PP = (ny + 2 * h) * pnx;
  const int tiles_x = (nx + TX - 1) / TX;
  const int x0 = (blockIdx.x % tiles_x) * TX, y0 = (blockIdx.x / tiles_x) * TY;
  const int k0 = blockIdx.y * a.tz, k1 = min(nz, k0 + a.tz);
  const int groups = (S + SMAX - 1) / SMAX;
  const int b = blockIdx.z / groups, j0 = (blockIdx.z % groups) * SMAX;
  const int ns = min(SMAX, S - j0);  // scalars of this block
  const int gx = x0 + tx, gy = y0 + ty;
  const bool own = gx < nx && gy < ny;  // the column is on the grid
  const int cs = (ty + HALO) * SW + tx + HALO;  // the column in a scalar plane
  const int ck = (ty + 1) * KW + tx + 1;        // ... in a K, u, v, w plane

  for (int i = tid; i < L::SH; i += NT)
    rowoff[i] = plane_index(y0 + i - HALO, ny, h) * pnx;
  for (int i = tid; i < SW; i += NT) colx[i] = plane_index(x0 + i - HALO, nx, h);
  __syncthreads();

  const size_t off = (size_t)b * nz * PP;
  const size_t offw = (size_t)b * (nz + 1) * PP;
  const size_t offs = ((size_t)b * S + j0) * nz * PP;  // scalar j0 of b
  const size_t NZP = (size_t)nz * PP;                  // one scalar's field
  const size_t offo = ((size_t)b * S + j0) * nz * P;   // ... in out
  const size_t NZPO = (size_t)nz * P;
  const float* const rhobf = a.rhobf + b * nz;
  const float* const rhobh = a.rhobh + b * (nz + 1);
  const float dz = a.dz;
  const float rdx = 1.0f / a.dx, rdy = 1.0f / a.dy, rdz = 1.0f / dz;

  auto slot = [&](int j) { return fld + ring(j, NSLOT) * L::SLOT; };

  // start the copies of level j: cells clamp to [0, nz-1], w faces to
  // [0, nz]
  auto load = [&](int j) {
    float* const dst = slot(j);
    const int lc = clampz(j, nz);
    const size_t c = off + (size_t)lc * PP;
    const size_t cs_ = offs + (size_t)lc * PP;
    const size_t cw = offw + (size_t)clampz(j, nz + 1) * PP;
    for (int i = tid; i < SPL; i += NT) {
      const int r = i / SW, q = i - r * SW;
      const int o = rowoff[r] + colx[q];
#pragma unroll
      for (int js = 0; js < SMAX; ++js)
        if (js < ns) cp_async_f32(dst + js * SPL + i, a.s + cs_ + js * NZP + o);
    }
    for (int i = tid; i < KPL; i += NT) {
      const int r = i / KW, q = i - r * KW;
      const int o = rowoff[r + HALO - 1] + colx[q + HALO - 1];
#pragma unroll
      for (int js = 0; js < SMAX; ++js)
        if (js < ns)
          cp_async_f32(dst + L::K_OFF + js * KPL + i, a.K + cs_ + js * NZP + o);
      cp_async_f32(dst + L::U_OFF + i, a.u + c + o);
      cp_async_f32(dst + L::V_OFF + i, a.v + c + o);
      cp_async_f32(dst + L::W_OFF + i, a.w + cw + o);
    }
    cp_async_commit();
  };

  // the fluxes of level g at tile position (ly, lx), ly in [0, TY], lx in
  // [0, TX]: x-face lx of row ly (ly < TY) and y-face ly of column lx
  // (lx < TX), for each scalar of the block
  auto fluxes = [&](int g, int ly, int lx) {
    const float* const sl = slot(g);
    const int ks = (ly + 1) * KW + lx + 1;
    const float uf = sl[L::U_OFF + ks], vf = sl[L::V_OFF + ks];
#pragma unroll
    for (int js = 0; js < SMAX; ++js) {
      if (js >= ns) break;
      const float* const s = sl + js * SPL + (ly + HALO) * SW + lx + HALO;
      const float* const K = sl + L::K_OFF + js * KPL + ks;
      float* const f = flx + js * NFLUX * FL + ly * FW + lx;
      if (ly < TY) {
        f[X_A * FL] = uf * face5(s[-3], s[-2], s[-1], s[0], s[1], s[2], uf);
        const float Kx = 0.5f * (K[-1] + K[0]);
        f[X_D * FL] = -Kx * (s[0] - s[-1]) * rdx;
      }
      if (lx < TX) {
        f[Y_A * FL] = vf * face5(s[-3 * SW], s[-2 * SW], s[-SW], s[0], s[SW],
                                 s[2 * SW], vf);
        const float Ky = 0.5f * (K[-KW] + K[0]);
        f[Y_D * FL] = -Ky * (s[0] - s[-SW]) * rdy;
      }
    }
  };

  // prologue: levels k0 and k0+1, s and K of the column at k0-1, and the
  // fluxes through the lower face of level k0
  load(k0);
  load(k0 + 1);
  float s_0[SMAX], K_0[SMAX], Fa[SMAX], Fd[SMAX];
  {
    const size_t cm = offs + (size_t)clampz(k0 - 1, nz) * PP +
                      rowoff[ty + HALO] + colx[tx + HALO];
    float s_m[SMAX], K_m[SMAX];
#pragma unroll
    for (int js = 0; js < SMAX; ++js) {
      if (js >= ns) break;
      s_m[js] = a.s[cm + js * NZP];
      K_m[js] = a.K[cm + js * NZP];
    }
    cp_async_wait_all();
    __syncthreads();
    const float* const sl = slot(k0);
    const float rh_lo = rhobh[k0];
    const float wr_lo = sl[L::W_OFF + ck] * rh_lo;
#pragma unroll
    for (int js = 0; js < SMAX; ++js) {
      if (js >= ns) break;
      s_0[js] = sl[js * SPL + cs];
      K_0[js] = sl[L::K_OFF + js * KPL + ck];
      Fa[js] = wr_lo * 0.5f * (s_m[js] + s_0[js]);
      Fd[js] = -rh_lo * 0.5f * (K_m[js] + K_0[js]) * (s_0[js] - s_m[js]) * rdz;
    }
  }

  for (int g = k0; g < k1; ++g) {
    cp_async_wait_all();
    __syncthreads();  // level g+1 is in; every read of step g-1 is done
    if (g + 2 <= k1) load(g + 2);
    fluxes(g, ty, tx);
    if (tid < TY)
      fluxes(g, tid, TX);  // x-faces of the column beyond the tile
    else if (tid < TY + TX)
      fluxes(g, TY, tid - TY);  // y-faces of the row beyond the tile
    __syncthreads();

    const float* const sp = slot(g + 1);
    const float rh_hi = rhobh[g + 1];
    const float irfdz = 1.0f / (rhobf[g] * dz);
    const float wr_hi = sp[L::W_OFF + ck] * rh_hi;
    float* const out =
        a.out + offo + (size_t)g * P + (own ? (size_t)gy * nx + gx : 0);
#pragma unroll
    for (int js = 0; js < SMAX; ++js) {
      if (js >= ns) break;
      auto F = [&](int fi, int dy_, int dx_) {
        return flx[(js * NFLUX + fi) * FL + (ty + dy_) * FW + tx + dx_];
      };
      const float s_p = sp[js * SPL + cs], K_p = sp[L::K_OFF + js * KPL + ck];
      const float Fa_hi = wr_hi * 0.5f * (s_0[js] + s_p);
      const float Fd_hi =
          -rh_hi * 0.5f * (K_0[js] + K_p) * (s_p - s_0[js]) * rdz;
      float tend = -(F(X_A, 0, 1) - F(X_A, 0, 0)) * rdx -
                   (F(Y_A, 1, 0) - F(Y_A, 0, 0)) * rdy;
      tend = tend - (Fa_hi - Fa[js]) * irfdz;
      tend = tend - (F(X_D, 0, 1) - F(X_D, 0, 0)) * rdx;
      tend = tend - (F(Y_D, 1, 0) - F(Y_D, 0, 0)) * rdy;
      tend = tend - (Fd_hi - Fd[js]) * irfdz;
      if (own) out[js * NZPO] = tend;
      s_0[js] = s_p;
      K_0[js] = K_p;
      Fa[js] = Fa_hi;
      Fd[js] = Fd_hi;
    }
  }
}

int launch(const Flat& a, int n, int smem, cudaStream_t stream) {
  if (a.tz < 1 || a.S < 1 || smem < Tile::BYTES ||
      (a.halo != 0 && a.halo < HALO))
    return (int)cudaErrorInvalidValue;
  static int allowed[stencil::MAX_DEVICES] = {};
  const cudaError_t e = stencil::allow_shared(k_scalars, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((a.nx + TX - 1) / TX) * ((a.ny + TY - 1) / TY),
                  (a.nz + a.tz - 1) / a.tz, n * ((a.S + SMAX - 1) / SMAX));
  k_scalars<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lesflat_tend(const float* u, const float* v, const float* w,
                 const float* K, const float* s, const float* rhobf,
                 const float* rhobh, float* out, int n, int S, int nz, int ny,
                 int nx, int tz, int smem, int halo, float dx, float dy,
                 float dz, cudaStream_t stream) {
  return launch(Flat{u, v, w, K, s, rhobf, rhobh, out, S, nz, ny, nx, tz,
                     halo, dx, dy, dz},
                n, smem, stream);
}

int advect_tend(const float* u, const float* v, const float* w,
                const float* K, const float* s, const float* rhobf,
                const float* rhobh, float* out, int n, int S, int nz, int ny,
                int nx, int tz, int smem, int halo, float dx, float dy,
                float dz, cudaStream_t stream) {
  return launch(Flat{u, v, w, K, s, rhobf, rhobh, out, S, nz, ny, nx, tz,
                     halo, dx, dy, dz},
                n, smem, stream);
}

}  // extern "C"
