// Up to k nearest same-frame neighbours within a radius over the sorted grid.
//
// Replaces the Pallas TPU kernel pcseqlearning_tpu/ops/pallas_scan.py::_scan_kernel
// (launched by _scan_kernel_call; public entry radius_neighbors_sorted). The
// reference table is sorted by cell key (frame, cx, cy) at cell size = radius;
// each query's candidates are three contiguous runs of it (columns cx-1..cx+1,
// rows cy-1..cy+1), given as [start, end) bounds. For each query the kernel
// returns the k smallest d2 <= r2 in ascending order with their sorted
// positions; ties go to the lower sorted position; missing entries are
// +inf / -1.
//
// What bounds it on an H100: operations and run-read latency; work is one
// distance per (query, run member) pair and bytes are the points, bounds and
// the [m, k] outputs. The TPU kernel merged whole union windows into a
// running top-k with k min/argmin passes per window; here one thread per
// query walks only its own runs and keeps a sorted top-k (k <= 8) in
// registers by insertion, so the per-pair cost is one distance and one
// compare against the current k-th best. Runs are visited in ascending
// position and insertion is stable, which gives the lower-position tie rule.
//
// Distances use round-to-nearest intrinsics (no FMA contraction), so results
// match the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KMAX 8

__global__ void radius_scan_kernel(const float* __restrict__ ref_xyz,
                                   const float* __restrict__ q_xyz,
                                   const int* __restrict__ bounds, int m, float r2, int k,
                                   float* __restrict__ out_d, int* __restrict__ out_p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float bd[KMAX];
  int bp[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    bd[t] = INFINITY;
    bp[t] = -1;
  }
  const float qx = q_xyz[3 * (long long)i], qy = q_xyz[3 * (long long)i + 1],
              qz = q_xyz[3 * (long long)i + 2];
  for (int dx = 0; dx < 3; ++dx) {
    const int s = bounds[dx * (long long)m + i];
    const int e = bounds[(3 + dx) * (long long)m + i];
    for (int j = s; j < e; ++j) {
      const float ex = __fsub_rn(qx, ref_xyz[3 * (long long)j]);
      const float ey = __fsub_rn(qy, ref_xyz[3 * (long long)j + 1]);
      const float ez = __fsub_rn(qz, ref_xyz[3 * (long long)j + 2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                 __fmul_rn(ez, ez));
      if (d2 <= r2 && d2 < bd[k - 1]) {
        // stable insertion: the new entry goes after every entry <= d2,
        // and every entry behind it shifts down by one
        float cd = d2;
        int cp = j;
        bool placed = false;
#pragma unroll
        for (int t = 0; t < KMAX; ++t) {
          if (t < k && (placed || cd < bd[t])) {
            placed = true;
            const float td = bd[t];
            const int tp = bp[t];
            bd[t] = cd;
            bp[t] = cp;
            cd = td;
            cp = tp;
          }
        }
      }
    }
  }
  for (int t = 0; t < k; ++t) {
    out_d[(long long)i * k + t] = bd[t];
    out_p[(long long)i * k + t] = bp[t];
  }
}

extern "C" int radius_scan_launch(const void* ref_xyz, const void* q_xyz, const void* bounds,
                                  int m, float r2, int k, void* out_d, void* out_p,
                                  void* stream) {
  if (m == 0) return 0;
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  radius_scan_kernel<<<(m + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)ref_xyz, (const float*)q_xyz, (const int*)bounds, m, r2, k,
      (float*)out_d, (int*)out_p);
  return (int)cudaGetLastError();
}
