// Device helpers shared by the LES stencil kernels (lesstage.cu, lesflat.cu,
// lesmom.cu): periodic and edge-clamped indices on the [nz, ny, nx] grid
// and the 5th-order upwind face value.
#pragma once

namespace stencil {

// periodic index for |i - n/2| < 3n/2, i.e. offsets of at most n - 1
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// edge-replicated index in [0, n - 1]
__device__ __forceinline__ int clampz(int k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// 5th-order upwind face value at face x' (between cells x'-1 and x') from s
// at x'-3 .. x'+2; sign(0) == 0, as jnp.sign. The 1/60 is one multiply,
// not a division (without fast math a division is a ~10-instruction
// sequence)
__device__ __forceinline__ float face5(float sm3, float sm2, float sm1,
                                       float s0, float sp1, float sp2,
                                       float vel) {
  const float central =
      (37.0f * (sm1 + s0) - 8.0f * (sm2 + sp1) + (sm3 + sp2)) * (1.0f / 60.0f);
  const float upwind =
      (10.0f * (s0 - sm1) - 5.0f * (sp1 - sm2) + (sp2 - sm3)) * (1.0f / 60.0f);
  const float sg = vel > 0.f ? 1.f : (vel < 0.f ? -1.f : 0.f);
  return central - sg * upwind;
}

}  // namespace stencil
