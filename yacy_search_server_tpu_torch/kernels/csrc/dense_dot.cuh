// What the dense kernels share: the bf16 dot over DIM = 256 in its fixed
// order (K9 `dense_dot` in dense.cu, K14 `ann_assign` and K15 `ann_fuse`
// in ann.cu), the fixed-scale boost, and K10's bitonic network over
// 64-bit keys in shared memory (K10 `rerank_sort`, K14, K15).
//
// The dot: every element is rounded to bf16 to nearest even, so each
// product of two bf16 values is exact in f32 and only the order of the
// sum decides the bits. Lane l of a warp holds elements 8l..8l+7 and
// sums their products as ((p0+p1)+(p2+p3))+((p4+p5)+(p6+p7)); the xor
// butterfly over offsets 16, 8, 4, 2, 1 adds the lanes (every lane ends
// with the same sum: f32 addition commutes). The plain versions
// (kernels/dense.dot_plain) add in this order. Built with -fmad=false,
// and every operation is an explicitly rounded intrinsic.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

#include "common.cuh"

namespace yt {

constexpr int DD_DIM = 256;
constexpr float BOOST_SCALE = 8355840.0f;  // 255 << 15

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// lane l's 8 elements of an f16 row, bf16-rounded
__device__ __forceinline__ void load8(const __half* row, int l, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(row) + l);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = bf16r(f.x);
    v[2 * i + 1] = bf16r(f.y);
  }
}

// lane l's 8 elements of an int8 row (exact in bf16: |x| <= 127)
__device__ __forceinline__ void load8_i8(const int8_t* row, int l, float* v) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + l);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __int2float_rn((int)b[i]);
}

// lane l's 8 query elements from their f32 bits, bf16-rounded
__device__ __forceinline__ void load8_q(const int32_t* qbits, int l,
                                        float* q) {
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = bf16r(__int_as_float(qbits[8 * l + i]));
}

// the fixed order: a lane's pairwise tree, then the butterfly
__device__ __forceinline__ float lane_sum(const float* d, const float* q) {
  float p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = __fmul_rn(d[i], q[i]);
  const float a0 = __fadd_rn(p[0], p[1]), a1 = __fadd_rn(p[2], p[3]);
  const float a2 = __fadd_rn(p[4], p[5]), a3 = __fadd_rn(p[6], p[7]);
  return __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
}
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// sparse + round((sims * alpha) * SCALE), rintf half to even, the int32
// sum wrapping as XLA's
__device__ __forceinline__ int32_t boosted(int32_t sparse, float sims,
                                           float alpha) {
  const float bo = rintf(__fmul_rn(__fmul_rn(sims, alpha), BOOST_SCALE));
  return (int32_t)((uint32_t)sparse + (uint32_t)__float2int_rn(bo));
}

// K10's bitonic network: n (a power of two) 64-bit keys in shared memory
// sorted ascending by the whole block; with a lane array the lane breaks
// full ties (the stable sort's result), without one equal keys are
// indistinguishable to the caller
template <bool WITH_LANE>
__device__ void bitonic_sort(unsigned long long* key, uint16_t* lane, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long ka = key[i], kb = key[p];
          bool gt = ka > kb;
          if (WITH_LANE) gt = gt || (ka == kb && lane[i] > lane[p]);
          if (gt == ((i & k) == 0)) {
            key[i] = kb;
            key[p] = ka;
            if (WITH_LANE) {
              const uint16_t la = lane[i];
              lane[i] = lane[p];
              lane[p] = la;
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// raise a kernel's dynamic shared memory cap once a device (the launch
// fails otherwise past 48 KB)
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, bool* raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && raised[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev >= 0 && dev < 64) raised[dev] = true;
  return e;
}

}  // namespace yt
