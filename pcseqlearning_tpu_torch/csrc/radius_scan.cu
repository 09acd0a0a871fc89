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
// What bounds it on an H100: operations. Work is one distance and one
// compare per (query, run member) pair, 10 operations as chip_smoke.py counts
// them, so it grows with the run pairs; bytes are the table, the queries,
// their run bounds, the block plan and the [m, k] outputs. Walking each
// query's runs from its own thread, in the caller's order, made every pair
// three scattered loads and let a warp's lanes run unequal trip counts. The
// design follows csrc/cc_round.cu instead:
//   * The prep (ops/sorted_grid.py::scan_prep) sorts the queries by cell, as
//     the TPU prep did, and block_plan cuts them into blocks of at most
//     SCAN_THREADS consecutive queries of one column, each with the union
//     range [lo, hi) of its queries' runs for each probe column dx, heaviest
//     block first. A block whose three ranges are empty writes its pads and
//     returns (the TPU kernel's blk_any skip): padded, invalid and isolated
//     queries cost no scan.
//   * A block stages its three ranges end to end in shared memory, SCAN_CHUNK
//     points at a time, one float4 (x, y, z, sorted position) per point,
//     loaded coalesced. One thread per query scans the part of each chunk
//     that its warp's runs cover, with warp-uniform bounds from warp
//     reductions: every shared-memory load is a broadcast and the warp never
//     diverges. Each thread tests s_i <= j < e_i only where the warp's runs
//     differ.
//   * Each thread keeps its top k in registers. Probe columns dx = 0, 1, 2
//     are visited in that order and each range in ascending position, so
//     positions arrive in ascending order and a strict < keeps the tie rule.
//     The list's empty entries hold the least float above r2, so one compare
//     against the k-th best is also the radius test. For k = 1, what the
//     tracking claims ask, a pair then costs one broadcast load, eight float
//     operations, one compare and two predicated moves; a larger k inserts
//     stably into the sorted list when a pair beats its k-th best.
//
// Distances use round-to-nearest intrinsics (no FMA contraction), so results
// match the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define SCAN_THREADS 128  // queries per plan block, one per thread
#define SCAN_CHUNK 1024   // points staged in shared memory at a time (16 KB)
#define KMAX 8
#define FULL 0xffffffffu

__device__ __forceinline__ float d2_direct(float qx, float qy, float qz, float4 p) {
  const float ex = __fsub_rn(qx, p.x);
  const float ey = __fsub_rn(qy, p.y);
  const float ez = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
}

// The top-k list: bd[KMAX - k .. KMAX) ascending, with positions bp; the
// entries below KMAX - k hold -inf and never move, so the k-th best is always
// bd[KMAX - 1]. Stable insertion of (d, j) with d < bd[KMAX - 1]: d goes
// after every entry <= d, the entries behind it move up by one.
__device__ __forceinline__ void insert(float (&bd)[KMAX], int (&bp)[KMAX], float d, int j) {
#pragma unroll
  for (int t = KMAX - 1; t > 0; --t) {
    const bool up = d < bd[t - 1], here = d < bd[t];
    bp[t] = up ? bp[t - 1] : here ? j : bp[t];
    bd[t] = up ? bd[t - 1] : here ? d : bd[t];
  }
  if (d < bd[0]) {
    bd[0] = d;
    bp[0] = j;
  }
}

// scan staged points [j0, j1) (table positions; sm holds from c0 on);
// TEST: also require s <= j < e; TOP1: k == 1.
template <bool TEST, bool TOP1>
__device__ __forceinline__ void scan(const float4* sm, int c0, int j0, int j1, float qx,
                                     float qy, float qz, int s, int e, float (&bd)[KMAX],
                                     int (&bp)[KMAX]) {
#pragma unroll 8
  for (int j = j0; j < j1; ++j) {
    const float4 p = sm[j - c0];
    const float d = d2_direct(qx, qy, qz, p);
    const bool take = (!TEST || (j >= s && j < e)) && d < bd[KMAX - 1];
    if (TOP1) {
      bd[KMAX - 1] = take ? d : bd[KMAX - 1];
      bp[KMAX - 1] = take ? __float_as_int(p.w) : bp[KMAX - 1];
    } else if (take) {
      insert(bd, bp, d, __float_as_int(p.w));
    }
  }
}

template <bool TOP1>
__device__ __forceinline__ void scan_chunk(const float4* sm, int c0, int a, int m0, int m1,
                                           int b, float qx, float qy, float qz, int s, int e,
                                           float (&bd)[KMAX], int (&bp)[KMAX]) {
  scan<true, TOP1>(sm, c0, a, m0, qx, qy, qz, s, e, bd, bp);
  scan<false, TOP1>(sm, c0, m0, m1, qx, qy, qz, s, e, bd, bp);
  scan<true, TOP1>(sm, c0, m1, b, qx, qy, qz, s, e, bd, bp);
}

// plan [nb, 8] int32 rows: query0, query1, lo[3], hi[3] (sorted queries)
__global__ void __launch_bounds__(SCAN_THREADS)
    radius_scan_kernel(const float* __restrict__ ref_xyz, const float* __restrict__ q_xyz,
                       const int* __restrict__ bounds, const int* __restrict__ plan, int m,
                       float r2, int k, float* __restrict__ out_d, int* __restrict__ out_p) {
  __shared__ float4 sm[SCAN_CHUNK];
  const int* pb = plan + 8 * (long long)blockIdx.x;
  const int i = pb[0] + threadIdx.x;
  const bool active = i < pb[1];
  // the block's range for dx is [lo, lo + len), at offset off of the three
  // ranges laid end to end
  int lo[3], len[3], off[3], total = 0;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    lo[dx] = pb[2 + dx];
    len[dx] = pb[5 + dx] - lo[dx];
    off[dx] = total;
    total += len[dx];
  }
  const float empty = nextafterf(r2, INFINITY);  // d < empty  <=>  d <= r2
  float bd[KMAX];
  int bp[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    bd[t] = t < KMAX - k ? -INFINITY : empty;
    bp[t] = -1;
  }
  if (total > 0) {  // block-uniform
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (active) {
      qx = q_xyz[3 * (long long)i];
      qy = q_xyz[3 * (long long)i + 1];
      qz = q_xyz[3 * (long long)i + 2];
    }
    // per probe column dx: this thread's run [s, e), the warp's union of
    // runs [ulo, uhi) and their intersection [ilo, ihi)
    int s[3], e[3], ulo[3], uhi[3], ilo[3], ihi[3];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      s[dx] = active ? bounds[dx * (long long)m + i] : 0;
      e[dx] = active ? bounds[(3 + dx) * (long long)m + i] : 0;
      const bool ne = active && s[dx] < e[dx];
      ulo[dx] = __reduce_min_sync(FULL, ne ? s[dx] : INT_MAX);
      uhi[dx] = __reduce_max_sync(FULL, ne ? e[dx] : INT_MIN);
      ilo[dx] = __reduce_max_sync(FULL, active ? s[dx] : INT_MIN);
      ihi[dx] = __reduce_min_sync(FULL, active ? e[dx] : INT_MAX);
    }
    // stage the three ranges, end to end, SCAN_CHUNK points at a time
    for (int v0 = 0; v0 < total; v0 += SCAN_CHUNK) {
      const int v1 = min(v0 + SCAN_CHUNK, total);
      __syncthreads();  // the previous chunk has been read
      for (int v = v0 + threadIdx.x; v < v1; v += SCAN_THREADS) {
        const int j = v < off[1]   ? lo[0] + v
                      : v < off[2] ? lo[1] + (v - off[1])
                                   : lo[2] + (v - off[2]);
        sm[v - v0] = make_float4(ref_xyz[3 * (long long)j], ref_xyz[3 * (long long)j + 1],
                                 ref_xyz[3 * (long long)j + 2], __int_as_float(j));
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
          if (k == 1)  // uniform
            scan_chunk<true>(sm, c0, a, m0, m1, b, qx, qy, qz, s[dx], e[dx], bd, bp);
          else
            scan_chunk<false>(sm, c0, a, m0, m1, b, qx, qy, qz, s[dx], e[dx], bd, bp);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (t >= KMAX - k) {
        const long long o = (long long)i * k + t - (KMAX - k);
        out_d[o] = bp[t] >= 0 ? bd[t] : INFINITY;
        out_p[o] = bp[t];
      }
    }
  }
}

extern "C" int radius_scan_launch(const void* ref_xyz, const void* q_xyz, const void* bounds,
                                  const void* plan, int num_blocks, int block_queries, int m,
                                  float r2, int k, void* out_d, void* out_p, void* stream) {
  if (block_queries != SCAN_THREADS || k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  if (m == 0 || num_blocks == 0) return 0;
  radius_scan_kernel<<<num_blocks, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ref_xyz, (const float*)q_xyz, (const int*)bounds, (const int*)plan, m, r2,
      k, (float*)out_d, (int*)out_p);
  return (int)cudaGetLastError();
}
