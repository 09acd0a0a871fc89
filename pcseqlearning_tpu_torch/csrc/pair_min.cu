// Batched exact pairwise distance with bidirectional masked min/argmin.
//
// Replaces the Pallas TPU kernel pcseqlearning_tpu/ops/pallas_tpu.py::_kernel
// (launched by _pallas_pair_min; public entry pair_min). For each component c:
//   d2[p, q] = |a[c, p] - b[c, q]|^2        (direct differences)
//   fwd_d2[p] = min over q with b_mask of d2, fwd_idx = first argmin
//   bwd_d2[q] = min over p with a_mask of d2, bwd_idx = first argmin
// An empty row gives +inf and index 0.
//
// What bounds it on an H100: operations. Each pair costs 8 float32 flops
// (3 sub, 3 mul, 2 add) plus a compare; bytes are only the C*(P+Q) points
// and the outputs. The design keeps everything on chip: one block per
// component stages a's and b's points (xyz + mask as one float4 each, about
// 12 KB at P=256, Q=512) in shared memory, then a thread per p scans all q
// (forward) and a thread per q scans all p (backward). In each inner step
// every thread of a warp reads the same shared-memory word, a broadcast with
// no bank conflicts, and the mask test is uniform across the warp.
//
// The distance uses round-to-nearest intrinsics so nvcc cannot contract it
// into FMAs: the kernel then rounds exactly like the plain PyTorch version
// (dx*dx + dy*dy + dz*dz, each op rounded), and argmins agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ float d2_direct(float4 a, float4 b) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  const float dz = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void pair_min_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                const uint8_t* __restrict__ a_mask,
                                const uint8_t* __restrict__ b_mask, int P, int Q,
                                float* __restrict__ fwd_d2, int* __restrict__ fwd_idx,
                                float* __restrict__ bwd_d2, int* __restrict__ bwd_idx) {
  extern __shared__ float4 smem[];
  float4* sa = smem;      // [P]: x, y, z, mask
  float4* sb = smem + P;  // [Q]
  const long long c = blockIdx.x;
  const float* ac = a + c * P * 3;
  const float* bc = b + c * Q * 3;
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    sa[p] = make_float4(ac[3 * p], ac[3 * p + 1], ac[3 * p + 2],
                        a_mask[c * P + p] ? 1.f : 0.f);
  for (int q = threadIdx.x; q < Q; q += blockDim.x)
    sb[q] = make_float4(bc[3 * q], bc[3 * q + 1], bc[3 * q + 2],
                        b_mask[c * Q + q] ? 1.f : 0.f);
  __syncthreads();

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float4 x = sa[p];
    float best = INFINITY;
    int arg = 0;
    for (int q = 0; q < Q; ++q) {
      const float4 y = sb[q];
      if (y.w != 0.f) {
        const float d = d2_direct(x, y);
        if (d < best) {  // strict: ties keep the first index
          best = d;
          arg = q;
        }
      }
    }
    fwd_d2[c * P + p] = best;
    fwd_idx[c * P + p] = arg;
  }
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const float4 y = sb[q];
    float best = INFINITY;
    int arg = 0;
    for (int p = 0; p < P; ++p) {
      const float4 x = sa[p];
      if (x.w != 0.f) {
        const float d = d2_direct(x, y);
        if (d < best) {
          best = d;
          arg = p;
        }
      }
    }
    bwd_d2[c * Q + q] = best;
    bwd_idx[c * Q + q] = arg;
  }
}

extern "C" int pair_min_launch(const void* a, const void* b, const void* a_mask,
                               const void* b_mask, int C, int P, int Q, void* fwd_d2,
                               void* fwd_idx, void* bwd_d2, void* bwd_idx, void* stream) {
  if (C == 0) return 0;
  const size_t smem = (size_t)(P + Q) * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_min_kernel<<<C, 256, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const uint8_t*)a_mask, (const uint8_t*)b_mask,
      P, Q, (float*)fwd_d2, (int*)fwd_idx, (float*)bwd_d2, (int*)bwd_idx);
  return (int)cudaGetLastError();
}
