// Helpers shared by the LES stencil kernels (lesstage.cu, lesflat.cu,
// lesmom.cu): periodic and edge-clamped indices on the [nz, ny, nx] grid,
// the 5th-order upwind face value, the ring of z-planes in shared memory
// and its asynchronous copies, and the dynamic shared-memory allowance.
#pragma once

#include <cuda_runtime.h>

namespace stencil {

// periodic index for |i - n/2| < 3n/2, i.e. offsets of at most n - 1
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// periodic index for any offset (tiles wider than the plane)
__device__ __forceinline__ int wrapmod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// edge-replicated index in [0, n - 1]
__device__ __forceinline__ int clampz(int k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// index of row or column i of the plane (i may lie off it): on the whole
// periodic plane of n points (halo 0), its periodic image; on a block
// padded with a halo of h >= 3 points a side by its neighbours' values
// (the halo mode), its place in the padded array of n + 2h points,
// clamped to it. A point of the block reads at most 3 points off it, so
// only the columns of a tile beyond the block read clamped values, and no
// output is written from them
__device__ __forceinline__ int plane_index(int i, int n, int h) {
  return h == 0 ? wrapmod(i, n) : clampz(i + h, n + 2 * h);
}

// slot of level j >= -m in a ring of m z-planes
__device__ __forceinline__ int ring(int j, int m) { return (j + m) % m; }

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

// asynchronous 4-byte copy from global to shared memory (sm_80+); a group
// of them is committed, then waited for
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int MAX_DEVICES = 64;

// Let `kernel` use `bytes` of dynamic shared memory on the current device:
// above 48 KB this must be allowed first. allowed[] holds, per device, the
// size allowed so far, so the attribute is set once per device and again
// only for a larger size.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes,
                         int (&allowed)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    allowed[dev] = bytes;
  }
  return cudaSuccess;
}

}  // namespace stencil
