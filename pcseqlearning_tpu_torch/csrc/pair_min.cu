// Batched exact pairwise distance with bidirectional masked min/argmin.
//
// Replaces the Pallas TPU kernel pcseqlearning_tpu/ops/pallas_tpu.py::_kernel
// (launched by _pallas_pair_min; public entry pair_min). For each component c:
//   d2[p, q] = |a[c, p] - b[c, q]|^2        (direct differences)
//   fwd_d2[p] = min over q with b_mask of d2, fwd_idx = first argmin
//   bwd_d2[q] = min over p with a_mask of d2, bwd_idx = first argmin
// An empty row gives +inf and index 0.
//
// What bounds it on an H100: operations. A pair costs 8 float32 operations
// (3 sub, 3 mul, 2 add; no FMA, see below) plus a compare and two selects
// for the running min and argmin; bytes are only the C*(P+Q) points and the
// outputs. The walk calls it with C = 144 components, P = 256 and Q = 256 or
// 512, and most of a call's components have few or no valid points while a
// few are full, so the design is about filling 132 SMs and about the
// longest block:
//   * Rows are independent. Component c has P forward rows (a's points,
//     scanning b) and Q backward rows (b's points, scanning a). The grid is
//     C * (fwd_blocks + bwd_blocks) blocks of THREADS threads, fwd_blocks =
//     ceil(P / ROWS) and bwd_blocks = ceil(Q / ROWS); block s of a component
//     owns ROWS forward rows for s < fwd_blocks, else ROWS backward rows.
//     Thread t = h * ROWS + g takes the slice's row g and scans segment h of
//     SEGMENTS equal parts of the staged points; segment 0 then takes the
//     other segments' minima through shared memory (a later segment wins
//     only when strictly smaller, which keeps the first argmin). Two
//     segments halve the longest scan, the one over a full component, which
//     sets the time of a walk-sized call (C = 144: 1,728 blocks on 132 SMs).
//     No reduction crosses blocks.
//   * Compacted operand: a block stages only the side its rows scan, and
//     only the points whose mask is set, in their original order (a stable
//     in-block prefix sum over warp ballots, done in shared memory after one
//     round of independent loads). Each staged point is one float4,
//     x, y, z and its original index as integer bits. Masked points then cost
//     no iterations, every thread of a warp reads the same word (a broadcast),
//     and the scan order is the index order, so a strict < keeps the first
//     argmin.
//
// The distance uses round-to-nearest intrinsics so nvcc cannot contract it
// into FMAs: the kernel then rounds exactly like the plain PyTorch version
// (dx*dx + dy*dy + dz*dz, each op rounded), and outputs agree bit for bit.
//
// Streamed mode, for sides too large for the shared-memory tile (max(P, Q)
// above 14,464 points; ImplicitReconstructionHead.loss calls C = 1, P =
// 27 n samples, Q = n returns, n = 32,768 at full width: 2.9e10 pairs).
// Operations bound it, at the card's unfused float32 rate: a pair's 8
// operations may not fuse (see above), which halves the 67 TFLOP/s that the
// bound counts, and each direction adds its compares and selects; bytes are
// only the points and the keys. So each d2 is computed once and feeds both
// minima, p's row and q's column:
//   * The rows are the larger side (a and b swap roles when Q > P; the
//     distance has the same bits either way, y - x being -(x - y)). A block
//     owns one rectangle of one component, a tile of rows (whole passes, at
//     most S_TILE) by S_SLICE columns, and the grid tiles each component's
//     [rows, columns] exactly once. The block stages its columns in shared
//     memory as (x, y, z, mask) and runs passes of S_WARPS * S_RPW rows:
//     warp w holds rows w * S_RPW to w * S_RPW + S_RPW - 1 of the pass (its
//     group) in registers, the same rows in every lane (a register-blocked
//     tile of S_RPW rows by one column a lane), and walks the slice in steps
//     of S_STEP columns, lane l taking columns i * 32 + l of the step. A
//     pair then costs 12 instructions: its 8 operations, a compare and two
//     selects for the row's minimum and first argmin (in registers across
//     the whole slice), and one min for the column's minimum over the
//     group.
//   * First argmin. A lane takes its columns in ascending order with a
//     strict <; after each pass a butterfly over the lanes takes each row's
//     lexicographic minimum of (d2, index). After each step the block merges
//     the S_WARPS group minima of each column into the slice's column keys
//     in shared memory in group order (row order), a later group only when
//     strictly smaller, so a key holds the first group that reaches the
//     minimum; at the block's end that group's distances are computed again
//     and its first valid row with an equal d2 is the argmin. Across blocks
//     a 64-bit atomicMin on (d2 bits << 32 | index) merges: d2 >= 0, so its
//     float bits order as unsigned integers, and equal d2 go to the lower
//     index whatever the order of arrival, so a run repeats bit for bit. One
//     atomic goes out per (row, slice) and per (column, row tile). Keys start
//     at (+inf bits, 0), which an empty row keeps: +inf and index 0.
//   * Masks are predicates, never a penalty on the distance: the row's
//     compare is anded with the column's mask (one predicate per staged
//     column), and the column's min is predicated on the row's; a warp whose
//     rows are all valid takes a loop without row masks. A masked point
//     keeps its own result; a pair of masked points feeds nothing. NaN wins
//     no strict < and no min.
//     A finish kernel unpacks the keys.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 128                // threads per block
#define SEGMENTS 2                 // scan segments per row
#define ROWS (THREADS / SEGMENTS)  // output rows per block

__device__ __forceinline__ float d2_direct(float ax, float ay, float az, float4 b) {
  const float dx = __fsub_rn(ax, b.x);
  const float dy = __fsub_rn(ay, b.y);
  const float dz = __fsub_rn(az, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Stage the n points of pts[N] whose mask is set into sm[0, n), in order, as
// (x, y, z, index bits); every thread of the block calls this and gets n.
// First every point goes to sm[k] with its index, or -1 where masked
// (independent loads, all in flight together); then a stable in-place
// compaction over shared memory, THREADS points a round: a kept point moves
// to its rank among the kept ones, which is never to the right of it nor
// into a later round's points.
__device__ int stage_compacted(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                               int N, float4* sm, int* warp_counts) {
  for (int k = threadIdx.x; k < N; k += THREADS)
    sm[k] = make_float4(pts[3 * k], pts[3 * k + 1], pts[3 * k + 2],
                        __int_as_float(mask[k] ? k : -1));
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < N; base += THREADS) {
    const int k = base + threadIdx.x;
    const float4 v = k < N ? sm[k] : make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
    const bool keep = __float_as_int(v.w) >= 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();  // this round's points are read before any is written
    int before = total, round = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) before += warp_counts[w];
      round += warp_counts[w];
    }
    if (keep) sm[before + __popc(ballot & ((1u << lane) - 1u))] = v;
    total += round;
    __syncthreads();  // warp_counts is rewritten next round; sm is complete after the last
  }
  return total;
}

__global__ void __launch_bounds__(THREADS)
    pair_min_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const uint8_t* __restrict__ a_mask, const uint8_t* __restrict__ b_mask,
                    int P, int Q, int fwd_blocks, int bwd_blocks, float* __restrict__ fwd_d2,
                    int* __restrict__ fwd_idx, float* __restrict__ bwd_d2,
                    int* __restrict__ bwd_idx) {
  extern __shared__ float4 sm[];  // [n]: the compacted scanned side
  __shared__ int warp_counts[THREADS / 32];
  __shared__ float part_d[(SEGMENTS - 1) * ROWS];
  __shared__ int part_i[(SEGMENTS - 1) * ROWS];
  const int per_c = fwd_blocks + bwd_blocks;
  const long long c = blockIdx.x / per_c;
  const int s = blockIdx.x % per_c;
  const bool fwd = s < fwd_blocks;
  const float* rows = fwd ? a + c * P * 3 : b + c * Q * 3;
  const int nrows = fwd ? P : Q;
  const float* scan = fwd ? b + c * Q * 3 : a + c * P * 3;
  const uint8_t* scan_mask = fwd ? b_mask + c * Q : a_mask + c * P;
  float* out_d = fwd ? fwd_d2 + c * P : bwd_d2 + c * Q;
  int* out_i = fwd ? fwd_idx + c * P : bwd_idx + c * Q;
  const int g = threadIdx.x % ROWS, h = threadIdx.x / ROWS;  // row lane, scan segment (warp-uniform)
  const int row = (fwd ? s : s - fwd_blocks) * ROWS + g;
  const bool ok = row < nrows;
  const float x = ok ? rows[3 * row] : 0.f;
  const float y = ok ? rows[3 * row + 1] : 0.f;
  const float z = ok ? rows[3 * row + 2] : 0.f;
  float best = INFINITY;
  int arg = 0;
  const int n = stage_compacted(scan, scan_mask, fwd ? Q : P, sm, warp_counts);

  // segment h scans the staged points [n*h/SEGMENTS, n*(h+1)/SEGMENTS)
#pragma unroll 4
  for (int j = n * h / SEGMENTS; j < n * (h + 1) / SEGMENTS; ++j) {
    const float4 p = sm[j];
    const float d = d2_direct(x, y, z, p);
    if (d < best) {  // strict: ties keep the first index
      best = d;
      arg = __float_as_int(p.w);
    }
  }
  // segment 0 takes a later segment's minimum only when it is smaller
  if (h > 0) {
    part_d[(h - 1) * ROWS + g] = best;
    part_i[(h - 1) * ROWS + g] = arg;
  }
  __syncthreads();
  if (h > 0 || !ok) return;
#pragma unroll
  for (int hh = 0; hh < SEGMENTS - 1; ++hh) {
    const float d = part_d[hh * ROWS + g];
    if (d < best) {
      best = d;
      arg = part_i[hh * ROWS + g];
    }
  }
  out_d[row] = best;
  out_i[row] = arg;
}

#define S_WARPS 8      // warps a block, streamed mode
#define S_THREADS 256  // threads a block (S_WARPS * 32)
#define S_RPW 14       // rows a warp holds in registers during a pass
#define S_STEP 256     // columns a step covers (S_STEP / 32 a lane)
#define S_TILE 1120    // the most rows a block covers, in passes of S_WARPS * S_RPW
#define S_SLICE 4096   // columns a block stages, in steps of S_STEP
// shared memory: the staged columns, their keys, a step's partials (104 KB)
#define S_SMEM (S_SLICE * 16 + S_SLICE * 8 + S_WARPS * S_STEP * 4)

static_assert(S_THREADS == S_WARPS * 32, "a warp is 32 threads");
static_assert(S_STEP == S_THREADS, "a step's merge takes one column a thread");
static_assert(S_STEP % 32 == 0 && S_SLICE % S_STEP == 0, "steps tile the slice");
static_assert(S_TILE % (2 * S_WARPS * S_RPW) == 0, "passes tile the row tile and its half");
static_assert(S_RPW < 32, "a pass's row masks are the low bits of one ballot");

__global__ void pair_min_stream_init(unsigned long long* __restrict__ keys, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = (unsigned long long)__float_as_uint(INFINITY) << 32;
}

// One step of a warp's pass: the lane's S_STEP / 32 columns against the
// warp's S_RPW rows (row r valid where bit r of rmask is set; all of them
// where ALL). The rows' minima and first argmins update in registers; each
// column's minimum over the valid rows (a min, no index) goes to the warp's
// partials of the step.
template <bool ALL>
__device__ __forceinline__ void stream_step(const float4* __restrict__ cols, int k0, int j0,
                                            int lane, unsigned rmask, const float (&x)[S_RPW],
                                            const float (&y)[S_RPW], const float (&z)[S_RPW],
                                            float (&best)[S_RPW], int (&arg)[S_RPW],
                                            float* __restrict__ pd) {
#pragma unroll 2
  for (int i = 0; i < S_STEP / 32; ++i) {
    const int k = k0 + i * 32 + lane;
    const float4 p = cols[k];
    const bool live = __float_as_int(p.w) != 0;  // the column's mask
    const int j = j0 + k;
    float cd = INFINITY;
#pragma unroll
    for (int r = 0; r < S_RPW; ++r) {
      const float d = d2_direct(x[r], y[r], z[r], p);
      if (live && d < best[r]) {  // strict: the lane's columns ascend
        best[r] = d;
        arg[r] = j;
      }
      if (ALL || ((rmask >> r) & 1u)) cd = fminf(cd, d);  // NaN never wins
    }
    pd[i * 32 + lane] = cd;
  }
}

__global__ void __launch_bounds__(S_THREADS, 2)
    pair_min_stream_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                           const uint8_t* __restrict__ row_mask,
                           const uint8_t* __restrict__ col_mask, int C, int nrows, int ncols,
                           int tile_rows, int slices, unsigned long long* __restrict__ row_keys,
                           unsigned long long* __restrict__ col_keys) {
  extern __shared__ float4 sm[];
  float4* staged = sm;                      // [S_SLICE] the slice's columns
  float* kd = (float*)(staged + S_SLICE);   // [S_SLICE] their minima over the tile's rows
  int* kg = (int*)(kd + S_SLICE);           //           and the first group holding it
  float* pd = (float*)(kg + S_SLICE);       // [S_WARPS][S_STEP] a step's partial minima
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x / slices, slice = blockIdx.x % slices;
  const int r0 = tile * tile_rows, r1 = min(nrows, r0 + tile_rows);
  const int j0 = slice * S_SLICE, n = min(S_SLICE, ncols - j0);
  const int steps = (n + S_STEP - 1) / S_STEP;
  const int passes = (r1 - r0 + S_WARPS * S_RPW - 1) / (S_WARPS * S_RPW);
  for (long long c = blockIdx.y; c < C; c += gridDim.y) {
    const float* rp = rows + c * nrows * 3;
    const float* cp = cols + c * ncols * 3;
    const uint8_t* rm = row_mask + c * nrows;
    const uint8_t* cm = col_mask + c * ncols;
    __syncthreads();  // the previous component's keys have been read
    for (int k = threadIdx.x; k < steps * S_STEP; k += S_THREADS) {
      const int j = j0 + k;  // past the slice: a masked column, never flushed
      staged[k] = k < n ? make_float4(cp[3 * j], cp[3 * j + 1], cp[3 * j + 2],
                                      __int_as_float(cm[j] ? 1 : 0))
                        : make_float4(0.f, 0.f, 0.f, __int_as_float(0));
      kd[k] = INFINITY;
      kg[k] = 0;
    }
    __syncthreads();
    for (int pass = 0; pass < passes; ++pass) {
      const int rb = r0 + pass * (S_WARPS * S_RPW) + warp * S_RPW;  // the warp's first row
      const unsigned rmask =
          __ballot_sync(0xffffffffu, lane < S_RPW && rb + lane < r1 && rm[rb + lane]);
      float x[S_RPW], y[S_RPW], z[S_RPW], best[S_RPW];
      int arg[S_RPW];
#pragma unroll
      for (int r = 0; r < S_RPW; ++r) {
        const bool ok = rb + r < r1;
        x[r] = ok ? rp[3 * (rb + r)] : 0.f;
        y[r] = ok ? rp[3 * (rb + r) + 1] : 0.f;
        z[r] = ok ? rp[3 * (rb + r) + 2] : 0.f;
        best[r] = INFINITY;
        arg[r] = 0;
      }
      const bool all = rmask == (1u << S_RPW) - 1u;  // warp-uniform
      float* pdw = pd + warp * S_STEP;
      for (int s = 0; s < steps; ++s) {
        if (all)
          stream_step<true>(staged, s * S_STEP, j0, lane, rmask, x, y, z, best, arg, pdw);
        else
          stream_step<false>(staged, s * S_STEP, j0, lane, rmask, x, y, z, best, arg, pdw);
        __syncthreads();
        // column s * S_STEP + t takes the warps' partials in warp order, that
        // is in row order: a later group only when strictly smaller
        const int k = s * S_STEP + threadIdx.x;
        float d = kd[k];
        int g = kg[k];
#pragma unroll
        for (int w = 0; w < S_WARPS; ++w) {
          const float e = pd[w * S_STEP + threadIdx.x];
          if (e < d) {
            d = e;
            g = pass * S_WARPS + w;
          }
        }
        kd[k] = d;
        kg[k] = g;
        __syncthreads();  // the partials are rewritten next step
      }
      // each row's lexicographic minimum of (d2, index) over the lanes; lane
      // r sends row r's key
      unsigned long long mine = 0;
#pragma unroll
      for (int r = 0; r < S_RPW; ++r) {
        unsigned long long key =
            ((unsigned long long)__float_as_uint(best[r]) << 32) | (unsigned int)arg[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
          key = o < key ? o : key;
        }
        if (lane == r) mine = key;
      }
      if (lane < S_RPW && rb + lane < r1 &&
          (unsigned int)(mine >> 32) != __float_as_uint(INFINITY))
        atomicMin(row_keys + c * nrows + rb + lane, mine);
    }
    // each column's first argmin: the first valid row of its first minimal
    // group (group g is warp g % S_WARPS of pass g / S_WARPS, rows r0 +
    // g * S_RPW onward) whose distance, computed again, equals the minimum
    for (int k = threadIdx.x; k < n; k += S_THREADS) {
      const float m = kd[k];
      if (!(m < INFINITY)) continue;
      const float4 p = staged[k];
      const int g0 = r0 + kg[k] * S_RPW;
      int arg = g0;
#pragma unroll
      for (int r = S_RPW - 1; r >= 0; --r) {  // descending: the last match taken is the first
        const int row = g0 + r;
        if (row < r1 && rm[row] &&
            d2_direct(rp[3 * row], rp[3 * row + 1], rp[3 * row + 2], p) == m)
          arg = row;
      }
      atomicMin(col_keys + c * ncols + j0 + k,
                ((unsigned long long)__float_as_uint(m) << 32) | (unsigned int)arg);
    }
  }
}

__global__ void pair_min_stream_finish(const unsigned long long* __restrict__ keys, long long n,
                                       float* __restrict__ d2, int* __restrict__ idx) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = keys[i];
    d2[i] = __uint_as_float((unsigned int)(k >> 32));
    idx[i] = (int)(unsigned int)(k & 0xffffffffu);
  }
}

// Rows a block covers: whole passes, from S_TILE down to S_TILE / 2 rows; a
// smaller tile only where its blocks fill the waves of resident blocks better
// by over half a percent of them (each tile adds an atomic a column and a
// staging of the slice). At the head's call (884,736 rows by 8 slices, 264
// resident blocks on an H100) S_TILE rows give 6,320 blocks, 99.7% of 24
// waves.
static int stream_tile(int nrows, long long per_tile, int slots) {
  int best = S_TILE;
  double best_fill = -1.0;
  for (int t = S_TILE; t >= S_TILE / 2; t -= S_WARPS * S_RPW) {
    const long long blocks = (long long)((nrows + t - 1) / t) * per_tile;
    const long long waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (fill > best_fill + 0.005) {
      best_fill = fill;
      best = t;
    }
  }
  return best;
}

// The streamed mode: keys is scratch of C * (P + Q) 64-bit words (forward
// rows first). Four launches on the stream: init, scan, two finishes.
static int pair_min_stream(const void* a, const void* b, const void* a_mask, const void* b_mask,
                           int C, int P, int Q, void* fwd_d2, void* fwd_idx, void* bwd_d2,
                           void* bwd_idx, void* keys, cudaStream_t stream) {
  unsigned long long* fk = (unsigned long long*)keys;
  unsigned long long* bk = fk + (long long)C * P;
  const long long n = (long long)C * (P + Q);
  pair_min_stream_init<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(fk, n);
  const bool swap = Q > P;  // the larger side holds the rows
  const int nrows = swap ? Q : P, ncols = swap ? P : Q;
  const long long slices = (ncols + S_SLICE - 1) / S_SLICE;
  const int cy = C < 65535 ? C : 65535;
  if (nrows > 0 && slices > 0) {
    cudaError_t e = cudaFuncSetAttribute(pair_min_stream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
    if (e == cudaSuccess)  // two blocks an SM: 2 x 104 KB of shared memory
      e = cudaFuncSetAttribute(pair_min_stream_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_min_stream_kernel,
                                                        S_THREADS, S_SMEM);
    if (e != cudaSuccess) return (int)e;
    const int tile_rows = stream_tile(nrows, slices * cy, sms * (per_sm > 0 ? per_sm : 1));
    const long long tiles = (nrows + tile_rows - 1) / tile_rows;
    if (tiles * slices > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(tiles * slices), (unsigned)cy);
    pair_min_stream_kernel<<<grid, S_THREADS, S_SMEM, stream>>>(
        (const float*)(swap ? b : a), (const float*)(swap ? a : b),
        (const uint8_t*)(swap ? b_mask : a_mask), (const uint8_t*)(swap ? a_mask : b_mask), C,
        nrows, ncols, tile_rows, (int)slices, swap ? bk : fk, swap ? fk : bk);
  }
  const long long nf = (long long)C * P, nb = (long long)C * Q;
  if (nf > 0)
    pair_min_stream_finish<<<(unsigned)((nf + 255) / 256), 256, 0, stream>>>(
        fk, nf, (float*)fwd_d2, (int*)fwd_idx);
  if (nb > 0)
    pair_min_stream_finish<<<(unsigned)((nb + 255) / 256), 256, 0, stream>>>(
        bk, nb, (float*)bwd_d2, (int*)bwd_idx);
  return (int)cudaGetLastError();
}

extern "C" int pair_min_launch(const void* a, const void* b, const void* a_mask,
                               const void* b_mask, int C, int P, int Q, void* fwd_d2,
                               void* fwd_idx, void* bwd_d2, void* bwd_idx, void* keys,
                               void* stream) {
  if (keys != nullptr)  // the wrapper gives scratch keys when the tile cannot hold a side
    return pair_min_stream(a, b, a_mask, b_mask, C, P, Q, fwd_d2, fwd_idx, bwd_d2, bwd_idx, keys,
                           (cudaStream_t)stream);
  const int fwd_blocks = (P + ROWS - 1) / ROWS, bwd_blocks = (Q + ROWS - 1) / ROWS;
  if (C == 0 || fwd_blocks + bwd_blocks == 0) return 0;
  const size_t smem = (size_t)(P > Q ? P : Q) * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pair_min_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_min_kernel<<<(unsigned)C * (fwd_blocks + bwd_blocks), THREADS, smem,
                    (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const uint8_t*)a_mask, (const uint8_t*)b_mask, P, Q,
      fwd_blocks, bwd_blocks, (float*)fwd_d2, (int*)fwd_idx, (float*)bwd_d2, (int*)bwd_idx);
  return (int)cudaGetLastError();
}
