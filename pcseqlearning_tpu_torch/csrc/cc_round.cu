// One label-propagation round of exact same-frame radius connected components.
//
// Replaces the Pallas TPU kernel pcseqlearning_tpu/ops/pallas_scan.py::_cc_kernel
// (launched by _cc_kernel_call inside _cc_rounds). Points are sorted by their
// cell key (frame, cx, cy) at cell size = radius, so every neighbour of slot i
// lies in three contiguous runs of the sorted table: columns cx-1, cx, cx+1,
// each spanning rows cy-1..cy+1. For every slot i:
//   out[i] = min(labels[i], min{labels[j] : j in the runs of i, |x_i - x_j|^2 <= r2})
// which is the TPU kernel's minimum followed by its min with the old label.
//
// What bounds it on an H100: operations, and the latency of the run reads.
// Work is one distance per (slot, run member) pair, so it grows with point
// density; bytes are the n sorted points, labels and run bounds. The TPU
// kernel copied a fixed union window per block of 256 slots (and truncated
// blocks whose union outgrew the window); here one thread per slot walks its
// own three runs [start, end) straight from global memory, so nothing is
// truncated and no window is scanned beyond the runs. Neighbouring threads
// are neighbouring slots of the same cell, so a warp walks the same runs and
// its loads of a run member are served together from L1.
//
// Distances use round-to-nearest intrinsics (no FMA contraction), so the
// d2 <= r2 test matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void cc_round_kernel(const float* __restrict__ xyz, const int* __restrict__ labels,
                                const int* __restrict__ bounds, int m, float r2,
                                int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float qx = xyz[3 * (long long)i], qy = xyz[3 * (long long)i + 1],
              qz = xyz[3 * (long long)i + 2];
  int best = labels[i];
  for (int dx = 0; dx < 3; ++dx) {
    const int s = bounds[dx * (long long)m + i];
    const int e = bounds[(3 + dx) * (long long)m + i];
    for (int j = s; j < e; ++j) {
      const float ex = __fsub_rn(qx, xyz[3 * (long long)j]);
      const float ey = __fsub_rn(qy, xyz[3 * (long long)j + 1]);
      const float ez = __fsub_rn(qz, xyz[3 * (long long)j + 2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                 __fmul_rn(ez, ez));
      if (d2 <= r2) best = min(best, labels[j]);
    }
  }
  out[i] = best;
}

extern "C" int cc_round_launch(const void* xyz, const void* labels, const void* bounds, int m,
                               float r2, void* out, void* stream) {
  if (m == 0) return 0;
  const int threads = 256;
  cc_round_kernel<<<(m + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const int*)labels, (const int*)bounds, m, r2, (int*)out);
  return (int)cudaGetLastError();
}
