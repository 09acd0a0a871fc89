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
// What bounds it on an H100: operations. Work is one distance, one compare
// and one min per (slot, run member) pair, so it grows with point density;
// bytes are the sorted points, labels, run bounds and the block plan. The
// design moves pair data through shared memory:
//   * A block plan, built once per CC chunk by ops/sorted_grid.py::block_plan
//     and reused by all of the chunk's rounds, cuts the sorted slots into
//     blocks of at most CC_THREADS consecutive slots that never cross a
//     column (frame, cx). Within a column the runs' starts and ends do not
//     decrease with the slot, so for each dx the block's runs lie in one
//     contiguous range [lo, hi) of the table, given by the plan. This is the
//     counterpart of the TPU kernel's per-block window (its win_start scalar
//     prefetch), without the fixed window width: nothing is truncated. The
//     plan lists the blocks heaviest first, so that the longest ones do not
//     start last and leave the card idle behind them.
//   * Each round the block stages its three ranges, laid end to end, in
//     chunks of CC_CHUNK points (most blocks need one), one float4 (x, y, z,
//     label bits) per point, loaded coalesced.
//     One thread per slot then scans the part of the chunk that its warp's
//     runs cover: the loop bounds are warp-uniform (the warp's union of runs,
//     from warp reductions), so every thread reads the same shared-memory
//     word (a broadcast) and the warp never diverges. Where all of the warp's
//     runs overlap, the scan needs only the distance test; at the edges each
//     thread also checks that j lies in its own run, s_i <= j < e_i. A pair
//     then costs one broadcast load, eight float operations, a compare and
//     a predicated min, and the warps scan somewhat more pairs than the runs
//     hold (their union of runs; PERF.md gives both on the bench scene).
// The distance tests are repeated in every round of a chunk (up to 24);
// caching them across rounds is not done here.
//
// Distances use round-to-nearest intrinsics (no FMA contraction), so the
// d2 <= r2 test matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <limits.h>

#define CC_THREADS 128  // slots per plan block, one per thread
#define CC_CHUNK 1024   // points staged in shared memory at a time (16 KB)
#define FULL 0xffffffffu

__device__ __forceinline__ float d2_direct(float qx, float qy, float qz, float4 p) {
  const float ex = __fsub_rn(qx, p.x);
  const float ey = __fsub_rn(qy, p.y);
  const float ez = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
}

// best over staged points [j0, j1) (table positions; sm holds from c0 on);
// TEST: also require s <= j < e. The min is one predicated instruction.
template <bool TEST>
__device__ __forceinline__ int scan(const float4* sm, int c0, int j0, int j1, float qx,
                                    float qy, float qz, float r2, int s, int e, int best) {
#pragma unroll 8
  for (int j = j0; j < j1; ++j) {
    const float4 p = sm[j - c0];
    const float d = d2_direct(qx, qy, qz, p);
    const int lab = __float_as_int(p.w), run = !TEST || (j >= s && j < e);
    asm("{\n\t.reg .pred p_run, p_in;\n\t"
        "setp.ne.s32 p_run, %4, 0;\n\t"
        "setp.le.and.f32 p_in, %1, %2, p_run;\n\t"
        "@p_in min.s32 %0, %0, %3;\n\t}"
        : "+r"(best)
        : "f"(d), "f"(r2), "r"(lab), "r"(run));
  }
  return best;
}

// plan [nb, 8] int32 rows: slot0, slot1, lo[3], hi[3]
__global__ void __launch_bounds__(CC_THREADS)
    cc_round_kernel(const float* __restrict__ xyz, const int* __restrict__ labels,
                    const int* __restrict__ bounds, const int* __restrict__ plan, int m,
                    float r2, int* __restrict__ out) {
  __shared__ float4 sm[CC_CHUNK];
  const int* bp = plan + 8 * (long long)blockIdx.x;
  const int i = bp[0] + threadIdx.x;
  const bool active = i < bp[1];
  float qx = 0.f, qy = 0.f, qz = 0.f;
  int best = INT_MAX;
  if (active) {
    qx = xyz[3 * (long long)i];
    qy = xyz[3 * (long long)i + 1];
    qz = xyz[3 * (long long)i + 2];
    best = labels[i];
  }
  // per probe column dx: this thread's run [s, e), the warp's union of runs
  // [ulo, uhi) and their intersection [ilo, ihi); the block's range
  // [lo, lo + len) sits at offset off of the three ranges laid end to end
  int s[3], e[3], ulo[3], uhi[3], ilo[3], ihi[3], lo[3], len[3], off[3], total = 0;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    s[dx] = active ? bounds[dx * (long long)m + i] : 0;
    e[dx] = active ? bounds[(3 + dx) * (long long)m + i] : 0;
    const bool ne = active && s[dx] < e[dx];
    ulo[dx] = __reduce_min_sync(FULL, ne ? s[dx] : INT_MAX);
    uhi[dx] = __reduce_max_sync(FULL, ne ? e[dx] : INT_MIN);
    ilo[dx] = __reduce_max_sync(FULL, active ? s[dx] : INT_MIN);
    ihi[dx] = __reduce_min_sync(FULL, active ? e[dx] : INT_MAX);
    lo[dx] = bp[2 + dx];
    len[dx] = bp[5 + dx] - lo[dx];
    off[dx] = total;
    total += len[dx];
  }
  // stage the three ranges, end to end, CC_CHUNK points at a time
  for (int v0 = 0; v0 < total; v0 += CC_CHUNK) {
    const int v1 = min(v0 + CC_CHUNK, total);
    __syncthreads();  // the previous chunk has been read
    for (int v = v0 + threadIdx.x; v < v1; v += CC_THREADS) {
      const long long j = v < off[1]   ? lo[0] + v
                          : v < off[2] ? lo[1] + (v - off[1])
                                       : lo[2] + (v - off[2]);
      sm[v - v0] = make_float4(xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2],
                               __int_as_float(labels[j]));
    }
    __syncthreads();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      // table positions of dx's range in this chunk; sm[j - c0] holds point j
      const int c0 = lo[dx] - off[dx] + v0;
      const int a = max(c0 + max(0, off[dx] - v0), ulo[dx]);
      const int b = min(c0 + min(v1, off[dx] + len[dx]) - v0, uhi[dx]);
      if (a < b) {  // warp-uniform
        const int m0 = min(max(ilo[dx], a), b), m1 = max(min(ihi[dx], b), m0);
        best = scan<true>(sm, c0, a, m0, qx, qy, qz, r2, s[dx], e[dx], best);
        best = scan<false>(sm, c0, m0, m1, qx, qy, qz, r2, s[dx], e[dx], best);
        best = scan<true>(sm, c0, m1, b, qx, qy, qz, r2, s[dx], e[dx], best);
      }
    }
  }
  if (active) out[i] = best;
}

extern "C" int cc_round_launch(const void* xyz, const void* labels, const void* bounds,
                               const void* plan, int num_blocks, int block_slots, int m,
                               float r2, void* out, void* stream) {
  if (block_slots != CC_THREADS) return (int)cudaErrorInvalidValue;
  if (m == 0 || num_blocks == 0) return 0;
  cc_round_kernel<<<num_blocks, CC_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const int*)labels, (const int*)bounds, (const int*)plan, m, r2,
      (int*)out);
  return (int)cudaGetLastError();
}
