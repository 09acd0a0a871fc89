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
// 27 n samples, Q = n returns, n = 32,768 at full width: 2.9e10 pairs each
// way). Again operations bound it, and with one component the whole card
// must share one row set, so the scanned side is cut too:
//   * A block owns S_ROWS rows of one direction (S_RPT rows a thread, kept
//     in registers, so each staged point read from shared memory serves
//     S_RPT distances) and one slice of S_SLICE scanned points, which it
//     streams through shared memory S_CHUNK points at a time. A masked
//     point is staged with NaN coordinates: its distance is NaN, which no
//     strict < takes, so it costs no branch.
//   * Within a block the scan runs in index order with a strict <, which
//     keeps the first argmin. Across the slices of a row the minima merge
//     with a 64-bit atomicMin on (d2 bits << 32 | index): d2 >= 0, so its
//     float bits order as unsigned integers, and equal d2 go to the lower
//     index, the first argmin again. Keys start at (+inf bits, 0), which an
//     empty row keeps: +inf and index 0. A finish kernel unpacks the keys.

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

#define S_THREADS 128             // threads per block, streamed mode
#define S_RPT 2                   // rows a thread
#define S_ROWS (S_THREADS * S_RPT)  // rows a block
#define S_CHUNK 1024              // scanned points staged at a time (16 KB)
#define S_SLICE 4096              // scanned points a block covers

__global__ void pair_min_stream_init(unsigned long long* __restrict__ keys, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = (unsigned long long)__float_as_uint(INFINITY) << 32;
}

__global__ void __launch_bounds__(S_THREADS)
    pair_min_stream_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           const uint8_t* __restrict__ a_mask, const uint8_t* __restrict__ b_mask,
                           int C, int P, int Q, int fwd_tiles, int fwd_slices, int bwd_slices,
                           unsigned long long* __restrict__ fwd_keys,
                           unsigned long long* __restrict__ bwd_keys) {
  __shared__ float4 sm[S_CHUNK];
  const int fwd_blocks = fwd_tiles * fwd_slices;
  const int s = blockIdx.x;
  const bool fwd = s < fwd_blocks;
  const int t = fwd ? s : s - fwd_blocks;
  const int slices = fwd ? fwd_slices : bwd_slices;
  const int tile = t / slices, slice = t % slices;
  const int nrows = fwd ? P : Q, nscan = fwd ? Q : P;
  const int j0 = slice * S_SLICE;
  const int j1 = min(nscan, j0 + S_SLICE);
  for (long long c = blockIdx.y; c < C; c += gridDim.y) {
    const float* rows = fwd ? a + c * P * 3 : b + c * Q * 3;
    const float* scan = fwd ? b + c * Q * 3 : a + c * P * 3;
    const uint8_t* scan_mask = fwd ? b_mask + c * Q : a_mask + c * P;
    unsigned long long* keys = fwd ? fwd_keys + c * P : bwd_keys + c * Q;
    float x[S_RPT], y[S_RPT], z[S_RPT], best[S_RPT];
    int arg[S_RPT];
#pragma unroll
    for (int r = 0; r < S_RPT; ++r) {
      const int row = tile * S_ROWS + r * S_THREADS + threadIdx.x;
      const bool ok = row < nrows;
      x[r] = ok ? rows[3 * row] : 0.f;
      y[r] = ok ? rows[3 * row + 1] : 0.f;
      z[r] = ok ? rows[3 * row + 2] : 0.f;
      best[r] = INFINITY;
      arg[r] = 0;
    }
    for (int base = j0; base < j1; base += S_CHUNK) {
      const int n = min(S_CHUNK, j1 - base);
      __syncthreads();  // the previous chunk has been read
      for (int k = threadIdx.x; k < n; k += S_THREADS) {
        const int j = base + k;
        sm[k] = scan_mask[j] ? make_float4(scan[3 * j], scan[3 * j + 1], scan[3 * j + 2],
                                           __int_as_float(j))
                             : make_float4(NAN, NAN, NAN, __int_as_float(j));
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 p = sm[k];
#pragma unroll
        for (int r = 0; r < S_RPT; ++r) {
          const float d = d2_direct(x[r], y[r], z[r], p);
          if (d < best[r]) {  // strict: ties keep the first index; NaN never
            best[r] = d;
            arg[r] = __float_as_int(p.w);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < S_RPT; ++r) {
      const int row = tile * S_ROWS + r * S_THREADS + threadIdx.x;
      if (row < nrows && best[r] < INFINITY)
        atomicMin(keys + row, ((unsigned long long)__float_as_uint(best[r]) << 32) |
                                  (unsigned int)arg[r]);
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

// The streamed mode: keys is scratch of C * (P + Q) 64-bit words (forward
// rows first). Four launches on the stream: init, scan, two finishes.
static int pair_min_stream(const void* a, const void* b, const void* a_mask, const void* b_mask,
                           int C, int P, int Q, void* fwd_d2, void* fwd_idx, void* bwd_d2,
                           void* bwd_idx, void* keys, cudaStream_t stream) {
  unsigned long long* fk = (unsigned long long*)keys;
  unsigned long long* bk = fk + (long long)C * P;
  const long long n = (long long)C * (P + Q);
  pair_min_stream_init<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(fk, n);
  const int fwd_tiles = (P + S_ROWS - 1) / S_ROWS, bwd_tiles = (Q + S_ROWS - 1) / S_ROWS;
  const int fwd_slices = (Q + S_SLICE - 1) / S_SLICE, bwd_slices = (P + S_SLICE - 1) / S_SLICE;
  const long long blocks = (long long)fwd_tiles * fwd_slices + (long long)bwd_tiles * bwd_slices;
  if (blocks > 0) {
    const dim3 grid((unsigned)blocks, (unsigned)(C < 65535 ? C : 65535));
    pair_min_stream_kernel<<<grid, S_THREADS, 0, stream>>>(
        (const float*)a, (const float*)b, (const uint8_t*)a_mask, (const uint8_t*)b_mask, C, P,
        Q, fwd_tiles, fwd_slices, bwd_slices, fk, bk);
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
