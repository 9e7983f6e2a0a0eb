// HFB forward-backward scans for Hopper (sm_90a).
//
// Replaces the TPU kernel htk_tpu/ops/fb_pallas.py : fb_scans_pallas (kernel
// body _make_kernel). Contract: htk_tpu/algo/fb.py : backward_scan,
// forward_scan and xi_scan, batched over B utterances of T padded frames and
// Q composite states, in the log semiring with HTK's LAdd clamps:
//
//   backward  beta_t[i] = ladd_j logA[i,j] + (outp[t+1,j] + beta_{t+1}[j]),
//             outp[T] = 0 and beta_T = LZERO; beta_{t_real-1} = aE; with a
//             beam, beta_t[i] = LZERO where beta_t[i] < max_k beta_t[k] - beam
//   forward   alpha_t[j] = (t == 0 ? a0[j] : ladd_i alpha_{t-1}[i] + logA[i,j])
//                          + outp[t,j]; with a beam, LZERO where beta_t[j] is
//             not above LZERO/2
//   logP      ladd_j alpha_{max(t_real-1,0)}[j] + aE[j]
//   xi[i,j]   sum over t < t_real-1, in t order, of
//             exp_or_zero(((alpha_t[i] + logA[i,j]) + (outp[t+1,j]
//                           + beta_{t+1}[j])) - logP)
//
// where ladd is ladd_reduce: the max, then the sum of exp(x - max) over the
// terms not below minLogExp, max + log(sum), and LZERO when the max is below
// LSMALL. Betas and alphas at t >= t_real carry on the recursion, as in the
// reference; callers read only t < t_real.
//
// Dead cells. A cell with logA[i,j] <= LZERO/2 (a transition the composite
// does not have: HTK writes log 0 as LZERO) is left out of every sum. It
// never changes ladd_reduce's result as long as its term stays below
// LSMALL, i.e. logA[i,j] + v < LSMALL for the state values v it meets
// (log-likelihoods, far from 5e9 in magnitude; dead values are ~LZERO):
// in a row that has a live term at or above LSMALL the dead term's
// difference from the max is below minLogExp, so its exp counts 0 and the
// max is a live term's; in a row that has none the result is LZERO either
// way. A dead cell's xi is 0 in the dense sum too, since its x is then far
// below the point where exp underflows in float32. This is the threshold
// chip_smoke.py's fb_bound counts live cells by; tests/test_torch_fb.py
// checks the argument on the plain version.
//
// Two designs compute this function; ops/fb_scans.py : fb_plan picks one
// from (B, T, Q, beam) alone, and fb_scans_cuda(path=) forces either. Both
// read the same live-cell lists.
//
// The lists (launch_tables). Per utterance, the live successors of each
// state (for the backward scan and xi) and its live predecessors (for the
// forward scan), in ascending index order with their logA values, in a
// global scratch (the wrapper's), built over the grid, a warp a task: a row
// task counts (then fills) row i's successors with ballots over 128-column
// steps; a tile task walks kTileRows rows of a 32-column strip, lane j
// reading a 128-byte row segment, and counts (then fills, in ascending row
// order) column j's predecessors in the tile. Between the two passes
// fb_offsets_kernel turns the tiles' counts into each tile's start within
// its column and scans the row and column totals into list offsets (int64:
// Q^2 passes 2^31 below the memory limit). Three launches: at HMMIRest's arc
// shape (B = 256, Q = 16) they cost what the narrow design's former table
// kernel (a block a direction, a thread a column walking the rows) did, in
// one call on an H100 at 700 W, and at Q = 192 and 256 as much or less
// (scripts/fb_designs.py --compare, PERF.md §6).
//
// The narrow design (fb_scans_launch; HERest's batches, HMMIRest's arcs,
// FULLC and -K: Q below 896, a thread a state). fb_scan_kernel gives each
// state a thread (a thread loops over states where Q exceeds the block); a
// step is, per state, the two-pass max-then-sum over its list, reading the
// previous step's state vector from shared memory, and one __syncthreads
// (two under a beam, for the block-wide max), the state vectors
// ping-ponging. The block copies its lists into shared memory when they fit
// beside the vectors and offsets, and reads them from the global scratch
// when they do not (a dense logA of 250 states has 62,500 cells): the same
// code on another pointer. Without a beam the two scans are independent, so
// 2B blocks run them at once, backward in blocks [0, B) and forward in [B,
// 2B); under a beam the forward scan needs the betas, so B blocks run
// backward then forward. What bounds it: the latency of T dependent steps
// per scan. Bytes (outp in, alphas and betas out: 11.8 MB at B = 8, T =
// 512, Q = 192) are 3.5 us at the HBM rate, and the live cells' operations
// a tenth of that; each step is a few dependent shared-memory reads, exps
// and logs per state and a barrier, on B (or 2B) of the card's 132 SMs. It
// runs on 2B SMs and a state's list in one thread, so a large composite
// breaks it: the phone loop (B = 1, Q = 10,332, 3,444-long lists) takes
// about 21 s a launch on 2 SMs. The state vectors live in one block's
// shared memory: it refuses Q past 19,359 (ops/fb_scans.py : scan_smem).
//
// The wide design (fb_scans_wide_launch; Q from 896 on: HNTrainSGD's phone
// loop, any Q that fits device memory). fb_wide_scan_kernel is one
// persistent cooperative grid (all blocks resident, SMs x occupancy: 132 on
// an H100) with one grid barrier a step (decode_scan.cu's monotonic
// counter, release/acquire at GPU scope). Without a beam backward runs on
// blocks [0, G/2) and forward on [G/2, G), each half with its own counter;
// under a beam the whole grid runs backward (two barriers a step: the raw
// betas, then the pruned ones once every block's maximum is in) and then
// forward. A half gives each utterance P = G/2 / B blocks (or a block a run
// of utterances when B > G/2). Each warp owns a contiguous range of states
// whose cost, the list entries plus kStateCost a state, is an equal share
// of the utterance's (split_point, mirrored by tests/test_torch_fb.py).
// Each step a block copies the previous state vector (double-buffered in
// global memory, in L2) into shared memory where the wrapper gives it room
// (Q up to 57,856; past that the kSmem = false variant reads it from L2),
// then in each warp a short list (fewer than kLongList entries) takes a
// lane and its two passes, and a long list takes the warp: its lanes take
// consecutive entries, eight in flight a lane, a shuffle max, then a
// shuffle sum of the terms not below minLogExp (ladd_reduce's rule; only
// the sum's order differs); the second pass walks each lane's entries
// backwards, so the list's tail, read last by the first pass, is the
// likeliest to be in cache still.
// What bounds it: the lists' bytes a step. The phone loop's are 95 MB a
// direction (8 bytes an entry), past the 50 MB L2, so each step streams
// them from HBM, twice where the second pass misses: 380 MB a step at
// most, 113 us at 3.35 TB/s, against the 112-122 us a step measured (T =
// 504: 56-62 ms a scan, chip_smoke.py phase 26); one pass alone would be 57
// us. A grid barrier costs about 4 us a step, so on short lists the narrow
// design's launch is cheaper: fb_plan's crossover, WIDE_Q, is where the
// wide design wins on composites with random links (ops/fb_scans.py
// fb_plan). kLongList (64) and kStateCost (32) barely matter: thresholds
// 16-1,024 and costs 8-128 gave the phone loop's scan 59.04-59.56 ms in one
// call on an H100 at 700 W (scripts/fb_designs.py --sweep). Also tried, by
// scripts that were not kept (so no numbers here), and not kept: 256 or
// 512 threads a block, 16 or 32 loads in flight a lane, and a cache of each
// warp's first terms of a long list in shared memory (faster on the phone
// loop, but it spilled registers and was slower at Q = 20,480).
//
// xi. Where the caller drops xi (xi == nullptr), neither design clears it
// or runs fb_xi_kernel. Else the launch clears xi (a dead cell's is 0), then
// fb_xi_kernel gives each live cell a warp (its row found by a binary
// search of the offsets) whose lanes split the sum over t, so xi's terms are
// added in another order than the reference's (within xi's tolerance); a
// grid-stride loop spreads the cells over the card, at any Q.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr float kLSmall = -0.5e10f;
constexpr float kDead = kLZero / 2;  // logA at or below: no transition
constexpr float kMinLogExp = -23.025850929940457f;  // -log(-LZERO)
constexpr float kMinEArg = -708.3f;
constexpr int kXiThreads = 256;
constexpr int kXiBlocks = 528;  // 4 per SM over the batch
constexpr int kMaxWarps = 32;
constexpr int kTaskThreads = 256;  // table kernels: 8 warps a block
constexpr int kTaskWarps = kTaskThreads / 32;
constexpr int kTileRows = 128;     // rows of a predecessor tile
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// The live-cell lists (both designs).

__device__ __forceinline__ int n_chunks(int Q) {
  return (Q + kTileRows - 1) / kTileRows;
}

// Warp tasks of utterance blockIdx.y: a row task i < Q, then tile tasks
// (strip s of 32 columns, chunk c of kTileRows rows), c-major. Count
// (kFill false) writes row i's live cells to off[b][0][i] and column j's in
// chunk c to part[b][c][j]; fill (kFill true) writes the lists, successors
// from off[b][0][i] and predecessors from off[b][1][j] + part[b][c][j],
// each in ascending index order.
template <bool kFill>
__global__ void __launch_bounds__(kTaskThreads)
fb_tables_kernel(const float* __restrict__ logA,  // (B, Q, Q)
                 long long* __restrict__ off,     // (B, 2, Q + 1)
                 long long* __restrict__ part,    // (B, chunks, Q)
                 int* __restrict__ nbr,           // (B, 2, Q * Q)
                 float* __restrict__ val,         // (B, 2, Q * Q)
                 int Q) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const size_t QQ = static_cast<size_t>(Q) * Q;
  const float* A = logA + b * QQ;
  const int strips = (Q + 31) / 32;
  const int chunks = n_chunks(Q);
  const long long tasks = Q + static_cast<long long>(strips) * chunks;
  long long* o = off + static_cast<size_t>(b) * 2 * (Q + 1);
  long long* pb = part + static_cast<size_t>(b) * chunks * Q;
  for (long long task = static_cast<long long>(blockIdx.x) * kTaskWarps
                        + (threadIdx.x >> 5);
       task < tasks; task += static_cast<long long>(gridDim.x) * kTaskWarps) {
    if (task < Q) {  // row i: its successors
      const int i = static_cast<int>(task);
      const float* Ai = A + static_cast<size_t>(i) * Q;
      int* nb = nbr + static_cast<size_t>(b) * 2 * QQ;
      float* va = val + static_cast<size_t>(b) * 2 * QQ;
      long long at = kFill ? o[i] : 0;
      for (int j0 = 0; j0 < Q; j0 += 128) {
        float a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u + lane;
          a[u] = j < Q ? Ai[j] : kLZero;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool live = a[u] > kDead;
          const unsigned m = __ballot_sync(kFull, live);
          if (kFill && live) {
            const long long k = at + __popc(m & ((1u << lane) - 1u));
            nb[k] = j0 + 32 * u + lane;
            va[k] = a[u];
          }
          at += __popc(m);
        }
      }
      if (!kFill && lane == 0) o[i] = at;
    } else {  // a tile: its columns' predecessors among its rows
      const long long tt = task - Q;
      const int s = static_cast<int>(tt % strips);
      const int c = static_cast<int>(tt / strips);
      const int j = s * 32 + lane;
      const int i0 = c * kTileRows;
      const int i1 = min(Q, i0 + kTileRows);
      if (j < Q) {
        int* nb = nbr + (static_cast<size_t>(b) * 2 + 1) * QQ;
        float* va = val + (static_cast<size_t>(b) * 2 + 1) * QQ;
        long long at =
            kFill ? o[Q + 1 + j] + pb[static_cast<size_t>(c) * Q + j] : 0;
        for (int i = i0; i < i1; i += 4) {
          float a[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            a[u] = i + u < i1 ? A[static_cast<size_t>(i + u) * Q + j] : kLZero;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (a[u] > kDead) {
              if (kFill) {
                nb[at] = i + u;
                va[at] = a[u];
              }
              ++at;
            }
          }
        }
        if (!kFill) pb[static_cast<size_t>(c) * Q + j] = at;
      }
    }
  }
}

// Counts x[0..n) -> exclusive offsets x[0..n], by the whole block: a
// thread a contiguous segment, the segments' sums scanned over the block.
__device__ void block_exclusive_scan(long long* x, int n) {
  __shared__ long long warp_sum[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, tid * per);
  const int hi = min(n, lo + per);
  long long s = 0;
  for (int q = lo; q < hi; ++q) s += x[q];
  long long inc = s;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    long long w = lane < nw ? warp_sum[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) warp_sum[lane] = w;
  }
  __syncthreads();
  long long run = inc - s + (warp ? warp_sum[warp - 1] : 0);
  for (int q = lo; q < hi; ++q) {
    const long long v = x[q];
    x[q] = run;
    run += v;
  }
  if (tid == blockDim.x - 1) x[n] = run;
}

// The list offsets of utterance blockIdx.x, direction blockIdx.y. For the
// predecessors, first each column j's total over its chunks, part[b][c][j]
// becoming the exclusive sum over the chunks before c.
__global__ void __launch_bounds__(1024)
fb_offsets_kernel(long long* __restrict__ off, long long* __restrict__ part,
                  int Q) {
  long long* o =
      off + (static_cast<size_t>(blockIdx.x) * 2 + blockIdx.y) * (Q + 1);
  if (blockIdx.y == 1) {
    constexpr int kLoads = 8;  // chunks a thread has in flight
    const int chunks = n_chunks(Q);
    long long* pb = part + static_cast<size_t>(blockIdx.x) * chunks * Q;
    for (int j = threadIdx.x; j < Q; j += blockDim.x) {
      long long at = 0;
      for (int c0 = 0; c0 < chunks; c0 += kLoads) {
        long long v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          v[u] = c0 + u < chunks ? pb[static_cast<size_t>(c0 + u) * Q + j]
                                 : 0;
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (c0 + u < chunks) pb[static_cast<size_t>(c0 + u) * Q + j] = at;
          at += v[u];
        }
      }
      o[j] = at;
    }
    __syncthreads();
  }
  block_exclusive_scan(o, Q);
}

// ---------------------------------------------------------------------------
// The narrow design.

// ladd_reduce over the list [k0, k1) of x = vec[nbr[k]] + val[k]: the max,
// then the sum of exps (two passes over the list, no terms kept)
__device__ __forceinline__ float list_ladd(const float* vec, const int* nbr,
                                           const float* val, int k0, int k1) {
  float hi = -FLT_MAX;
  for (int k = k0; k < k1; ++k) hi = fmaxf(hi, vec[nbr[k]] + val[k]);
  if (hi < kLSmall) return kLZero;
  float sum = 0.0f;
  for (int k = k0; k < k1; ++k) {
    const float diff = (vec[nbr[k]] + val[k]) - hi;
    sum += diff < kMinLogExp ? 0.0f : expf(diff);
  }
  return hi + logf(sum);
}

struct Lists {
  const int* off;  // (Q + 1,) in shared memory
  const int* nbr;  // shared or global
  const float* val;
};

__global__ void __launch_bounds__(1024)
fb_scan_kernel(const float* __restrict__ outp,   // (B, T, Q)
               const float* __restrict__ a0,     // (B, Q)
               const float* __restrict__ aE,     // (B, Q)
               const int* __restrict__ t_real,   // (B,)
               const long long* off,             // (B, 2, Q + 1)
               const int* nbr,                   // (B, 2, Q * Q)
               const float* val,                 // (B, 2, Q * Q)
               float* alphas,                    // (B, T, Q)
               float* betas,                     // (B, T, Q)
               float* logp,                      // (B,)
               int B, int T, int Q, int smem, int use_beam, float beam) {
  extern __shared__ float smem_f[];
  float* bufA = smem_f;          // (Q,) state vectors, ping-pong
  float* bufB = bufA + Q;        // (Q,)
  float* red = bufB + Q;         // (kMaxWarps,) per-warp maxima (beam)
  int* off_s = reinterpret_cast<int*>(red + kMaxWarps);  // (dirs, Q + 1)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  // without a beam: backward in blocks [0, B), forward in [B, 2B)
  const bool concurrent = !use_beam;
  const int b = concurrent && blockIdx.x >= B ? blockIdx.x - B : blockIdx.x;
  const bool do_back = !concurrent || blockIdx.x < B;
  const bool do_fwd = !concurrent || blockIdx.x >= B;
  const int d0 = do_back ? 0 : 1;  // first list direction this block uses
  const int dirs = (do_back ? 1 : 0) + (do_fwd ? 1 : 0);
  const size_t QQ = static_cast<size_t>(Q) * Q;
  const size_t TQ = static_cast<size_t>(T) * Q;
  const float* op = outp + b * TQ;
  float* al = alphas + b * TQ;
  float* be = betas + b * TQ;
  const float* a0b = a0 + static_cast<size_t>(b) * Q;
  const float* aEb = aE + static_cast<size_t>(b) * Q;
  const int tr = t_real[b];

  // offsets into shared memory; the entries too when they all fit
  int total = 0;
  for (int d = 0; d < dirs; ++d) {
    const long long* g =
        off + (static_cast<size_t>(b) * 2 + d0 + d) * (Q + 1);
    for (int q = tid; q <= Q; q += nthreads)
      off_s[d * (Q + 1) + q] = static_cast<int>(g[q]);  // Q^2 < 2^31
    total += static_cast<int>(g[Q]);
  }
  const size_t base = (2 * static_cast<size_t>(Q) + kMaxWarps
                       + static_cast<size_t>(dirs) * (Q + 1)) * 4;
  const bool in_smem = base + 8 * static_cast<size_t>(total)
                       <= static_cast<size_t>(smem);
  int* nbr_s = off_s + dirs * (Q + 1);
  float* val_s = reinterpret_cast<float*>(nbr_s + (in_smem ? total : 0));
  Lists back = {}, fwd = {};
  int at = 0;
  for (int d = 0; d < dirs; ++d) {
    const size_t list = static_cast<size_t>(b) * 2 + d0 + d;
    const int n = static_cast<int>(off[list * (Q + 1) + Q]);
    Lists L;
    L.off = off_s + d * (Q + 1);
    if (in_smem) {  // the list's entries from nbr_s + at on
      for (int k = tid; k < n; k += nthreads) {
        nbr_s[at + k] = nbr[list * QQ + k];
        val_s[at + k] = val[list * QQ + k];
      }
      L.nbr = nbr_s + at;
      L.val = val_s + at;
      at += n;
    } else {
      L.nbr = nbr + list * QQ;
      L.val = val + list * QQ;
    }
    if (d0 + d == 0) back = L; else fwd = L;
  }
  for (int q = tid; q < Q; q += nthreads) bufA[q] = kLZero;  // 0 + beta_T
  __syncthreads();

  if (do_back) {  // beta_t from o_{t+1} + beta_{t+1}, reset to aE at tr - 1
    const Lists& L = back;
    float* cur = bufA;
    float* nxt = bufB;
    for (int t = T - 1; t >= 0; --t) {
      const float* orow = op + static_cast<size_t>(t) * Q;
      float* brow = be + static_cast<size_t>(t) * Q;
      float wmax = -FLT_MAX;
      for (int q = tid; q < Q; q += nthreads) {
        const float v = t == tr - 1
            ? aEb[q] : list_ladd(cur, L.nbr, L.val, L.off[q], L.off[q + 1]);
        if (use_beam) {
          nxt[q] = v;
          wmax = fmaxf(wmax, v);
        } else {
          brow[q] = v;
          nxt[q] = orow[q] + v;
        }
      }
      if (use_beam) {
        for (int s = 16; s > 0; s >>= 1)
          wmax = fmaxf(wmax, __shfl_xor_sync(kFull, wmax, s));
        if (lane == 0) red[warp] = wmax;
        __syncthreads();
        float mx = red[0];
        for (int w = 1; w < nwarps; ++w) mx = fmaxf(mx, red[w]);
        const float thr = mx - beam;
        for (int q = tid; q < Q; q += nthreads) {
          float v = nxt[q];
          if (v < thr) v = kLZero;
          brow[q] = v;
          nxt[q] = orow[q] + v;
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }

  if (do_fwd) {  // alpha_t from alpha_{t-1} (ping-pong)
    const Lists& L = fwd;
    float* prev = bufA;
    float* next = bufB;
    for (int t = 0; t < T; ++t) {
      const size_t row = static_cast<size_t>(t) * Q;
      for (int q = tid; q < Q; q += nthreads) {
        const float pred = t == 0
            ? a0b[q] : list_ladd(prev, L.nbr, L.val, L.off[q], L.off[q + 1]);
        float a = pred + op[row + q];
        if (use_beam && !(be[row + q] > kLZero / 2)) a = kLZero;
        next[q] = a;
        al[row + q] = a;
      }
      __syncthreads();
      float* tmp = prev;
      prev = next;
      next = tmp;
    }
    // logP from the last real frame, by warp 0 over every state
    if (warp == 0) {
      const int t1 = tr - 1 > 0 ? tr - 1 : 0;
      const float* a = al + static_cast<size_t>(t1) * Q;
      float hi = -FLT_MAX;
      for (int q = lane; q < Q; q += 32) hi = fmaxf(hi, aEb[q] + a[q]);
      for (int s = 16; s > 0; s >>= 1)
        hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, s));
      float sum = 0.0f;
      for (int q = lane; q < Q; q += 32) {
        const float diff = (aEb[q] + a[q]) - hi;
        sum += diff < kMinLogExp ? 0.0f : expf(diff);
      }
      for (int s = 16; s > 0; s >>= 1)
        sum += __shfl_xor_sync(kFull, sum, s);
      if (lane == 0) logp[b] = hi < kLSmall ? kLZero : hi + logf(sum);
    }
  }
}

// xi of the live cells of utterance blockIdx.y (xi is cleared before): a
// warp a cell, its lanes taking every 32nd frame, then a shuffle sum
__global__ void __launch_bounds__(kXiThreads)
fb_xi_kernel(const float* __restrict__ outp,    // (B, T, Q)
             const float* __restrict__ alphas,  // (B, T, Q)
             const float* __restrict__ betas,   // (B, T, Q)
             const float* __restrict__ logp,    // (B,)
             const int* __restrict__ t_real,    // (B,)
             const long long* __restrict__ off, // (B, 2, Q + 1)
             const int* __restrict__ nbr,       // (B, 2, Q * Q)
             const float* __restrict__ val,     // (B, 2, Q * Q)
             float* __restrict__ xi,            // (B, Q, Q)
             int T, int Q) {
  constexpr int kXiWarps = kXiThreads / 32;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const size_t QQ = static_cast<size_t>(Q) * Q;
  const size_t TQ = static_cast<size_t>(T) * Q;
  const long long* o = off + static_cast<size_t>(b) * 2 * (Q + 1);  // successors
  const int* nb = nbr + static_cast<size_t>(b) * 2 * QQ;
  const float* va = val + static_cast<size_t>(b) * 2 * QQ;
  const long long n = o[Q];
  const float lp = logp[b];
  const int tr = t_real[b];
  for (long long k = static_cast<long long>(blockIdx.x) * kXiWarps
                     + (threadIdx.x >> 5);
       k < n; k += static_cast<long long>(gridDim.x) * kXiWarps) {
    int lo = 0, hi = Q - 1;  // the row i: the last with o[i] <= k
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (o[mid] <= k) lo = mid; else hi = mid - 1;
    }
    const int i = lo;
    const int j = nb[k];
    const float a = va[k];
    const float* al = alphas + b * TQ + i;
    const float* op = outp + b * TQ + j;
    const float* be = betas + b * TQ + j;
    float acc = 0.0f;
    for (int t = lane; t < tr - 1; t += 32) {
      const size_t nx = static_cast<size_t>(t + 1) * Q;
      const float tgt = op[nx] + be[nx];
      const float x = ((al[static_cast<size_t>(t) * Q] + a) + tgt) - lp;
      acc += x > kLSmall ? expf(fmaxf(x, kMinEArg)) : 0.0f;
    }
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(kFull, acc, s);
    if (lane == 0) xi[b * QQ + static_cast<size_t>(i) * Q + j] = acc;
  }
}

// ---------------------------------------------------------------------------
// The wide design.

constexpr int kWideThreads = 1024;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kUnroll = 8;      // entries a lane has in flight (long list)
constexpr int kLongList = 64;   // a list this long or longer takes a warp
constexpr int kStateCost = 32;  // a state's cost in list entries (the split)

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
               : : "l"(p) : "memory");
}

// Every block of a group arrives once per barrier; the counter reaches
// target when all of them have. The block's writes are ordered before
// thread 0's release by the first __syncthreads, its reads after thread
// 0's acquire by the second; data written by other blocks during the
// launch is read with ld.global.cg (__ldcg), past the SM's L1.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    red_release(count);
    while (ld_acquire(count) < target) {
    }
  }
  __syncthreads();
}

// A float as an int that orders as the float does (for atomicMax)
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// The first state of warp k of NW over offsets o: the least q in [0, Q]
// with (o[q] + c q) NW >= k (o[Q] + c Q), c = kStateCost. Warp k owns
// [split(k), split(k + 1)); each state, and so each live cell, has one
// owner.
__device__ int split_point(const long long* o, int Q, int NW, int k) {
  constexpr long long c = kStateCost;
  const long long want = static_cast<long long>(k) * (o[Q] + c * Q);
  int lo = 0, hi = Q;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((o[mid] + c * mid) * NW >= want)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

template <bool kSmem>
__device__ __forceinline__ float vec_at(const float* v, int i) {
  if constexpr (kSmem) {
    return v[i];
  } else {
    return __ldcg(v + i);
  }
}

// ladd_reduce over the list [k0, k1) of x = vec[nbr[k]] + val[k] by one
// thread (a short list): the max, then the sum of exps
template <bool kSmem>
__device__ float thread_ladd(const float* vec, const int* __restrict__ nbr,
                             const float* __restrict__ val, long long k0,
                             long long k1) {
  float hi = -FLT_MAX;
  for (long long k = k0; k < k1; ++k)
    hi = fmaxf(hi, vec_at<kSmem>(vec, __ldg(nbr + k)) + __ldg(val + k));
  if (hi < kLSmall) return kLZero;
  float sum = 0.0f;
  for (long long k = k0; k < k1; ++k) {
    const float diff =
        (vec_at<kSmem>(vec, __ldg(nbr + k)) + __ldg(val + k)) - hi;
    sum += diff < kMinLogExp ? 0.0f : expf(diff);
  }
  return hi + logf(sum);
}

// The same by a warp (a long list): lane l takes entries k0 + l, k0 + l +
// 32, ... in order, kUnroll loads in flight; a shuffle max, each lane's sum
// of its terms' exps, a shuffle sum. Every lane returns the result.
template <bool kSmem>
__device__ float warp_ladd(const float* vec, const int* __restrict__ nbr,
                           const float* __restrict__ val, long long k0,
                           long long k1, int lane) {
  float hi = -FLT_MAX;
  long long k = k0 + lane;
  for (; k + 32 * (kUnroll - 1) < k1; k += 32 * kUnroll) {
    int n[kUnroll];
    float a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      n[u] = __ldg(nbr + k + 32 * u);
      a[u] = __ldg(val + k + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      hi = fmaxf(hi, vec_at<kSmem>(vec, n[u]) + a[u]);
  }
  for (; k < k1; k += 32)
    hi = fmaxf(hi, vec_at<kSmem>(vec, __ldg(nbr + k)) + __ldg(val + k));
  for (int s = 16; s > 0; s >>= 1)
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, s));
  if (hi < kLSmall) return kLZero;
  float sum = 0.0f;
  // the second pass walks the lane's entries backwards: the list's tail,
  // read last by the first, is the likeliest to be in L1 or L2 still
  long long i = k0 + lane < k1 ? (k1 - 1 - k0 - lane) / 32 : -1;
  for (; i >= kUnroll - 1; i -= kUnroll) {
    int n[kUnroll];
    float a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      n[u] = __ldg(nbr + k0 + lane + 32 * (i - u));
      a[u] = __ldg(val + k0 + lane + 32 * (i - u));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float diff = (vec_at<kSmem>(vec, n[u]) + a[u]) - hi;
      sum += diff < kMinLogExp ? 0.0f : expf(diff);
    }
  }
  for (; i >= 0; --i) {
    const long long kk = k0 + lane + 32 * i;
    const float diff =
        (vec_at<kSmem>(vec, __ldg(nbr + kk)) + __ldg(val + kk)) - hi;
    sum += diff < kMinLogExp ? 0.0f : expf(diff);
  }
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(kFull, sum, s);
  return hi + logf(sum);
}

// The warp's states [qa, qb) of one utterance: a short list a lane, a long
// one (kLongList entries or more) the whole warp; emit(q, v) by q's lane.
template <bool kSmem, typename Emit>
__device__ __forceinline__ void warp_states(const float* vec,
                                            const long long* o,
                                            const int* nbr, const float* val,
                                            int qa, int qb, int lane,
                                            Emit emit) {
  for (int base = qa; base < qb; base += 32) {
    const int q = base + lane;
    const bool has = q < qb;
    const long long k0 = has ? __ldg(o + q) : 0;
    const long long k1 = has ? __ldg(o + q + 1) : 0;
    const bool is_long = has && k1 - k0 >= kLongList;
    float v = 0.0f;
    if (has && !is_long) v = thread_ladd<kSmem>(vec, nbr, val, k0, k1);
    unsigned m = __ballot_sync(kFull, is_long);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float r = warp_ladd<kSmem>(vec, nbr, val,
                                       __shfl_sync(kFull, k0, src),
                                       __shfl_sync(kFull, k1, src), lane);
      if (lane == src) v = r;
    }
    if (has) emit(q, v);
  }
}

// ladd_reduce over q of x(q) by the whole block (logP)
template <typename X>
__device__ float block_ladd(int Q, float* red, X x) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float hi = -FLT_MAX;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) hi = fmaxf(hi, x(q));
  for (int s = 16; s > 0; s >>= 1)
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, s));
  if (lane == 0) red[warp] = hi;
  __syncthreads();
  float mx = red[0];
  for (int w = 1; w < kWideWarps; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();
  float sum = 0.0f;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const float diff = x(q) - mx;
    sum += diff < kMinLogExp ? 0.0f : expf(diff);
  }
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(kFull, sum, s);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWideWarps; ++w) total += red[w];
  __syncthreads();
  return mx < kLSmall ? kLZero : mx + logf(total);
}

// The scans over the grid. buf (2 directions, 2 parities, B, Q): the ready
// state vectors, backward's o_{t+1} + beta_{t+1} (the plane read at
// t = T - 1 holds LZERO, 0 + beta_T, from the wrapper) and forward's
// alpha_t. raw (B, Q): backward's unpruned betas under a beam; gmax (B, T):
// their maxima as ordered ints (INT_MIN from the wrapper). ranges (2,
// range_rows, kWideWarps, 2): each warp's [qa, qb) for each utterance it
// serves. barrier (2,): zero.
template <bool kSmem>
__global__ void __launch_bounds__(kWideThreads, 1)
fb_wide_scan_kernel(const float* __restrict__ outp,    // (B, T, Q)
                    const float* __restrict__ a0,      // (B, Q)
                    const float* __restrict__ aE,      // (B, Q)
                    const int* __restrict__ t_real,    // (B,)
                    const long long* __restrict__ off, // (B, 2, Q + 1)
                    const int* __restrict__ nbr,       // (B, 2, Q * Q)
                    const float* __restrict__ val,     // (B, 2, Q * Q)
                    float* alphas, float* betas, float* logp, float* buf,
                    float* raw, int* gmax, int* ranges, unsigned* barrier,
                    int B, int T, int Q, int use_beam, float beam,
                    int range_rows) {
  extern __shared__ float vec_s[];  // (Q,) when kSmem
  __shared__ int bmax_s;
  __shared__ float red_s[kWideWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool concurrent = !use_beam;
  const int Gh = concurrent ? gridDim.x / 2 : gridDim.x;
  int blk = blockIdx.x;
  int half = 0;
  if (concurrent) {
    if (blk >= 2 * Gh) return;
    half = blk >= Gh;
    if (half) blk -= Gh;
  }
  const int P = B <= Gh ? Gh / B : 1;  // blocks an utterance
  const int NG = Gh / P;               // groups: g serves g, g + NG, ...
  const int grp = blk / P;
  const int part = blk - grp * P;
  const bool active = grp < NG;
  const int NW = P * kWideWarps;
  const size_t QQ = static_cast<size_t>(Q) * Q;
  const size_t TQ = static_cast<size_t>(T) * Q;
  const size_t BQ = static_cast<size_t>(B) * Q;
  unsigned* bar = barrier + half;
  unsigned arrivals = 0;
  auto sync_grid = [&]() { grid_barrier(bar, ++arrivals * Gh); };
  auto lists = [&](int b, int d) {
    return off + (static_cast<size_t>(b) * 2 + d) * (Q + 1);
  };
  auto range = [&](int b, int d, int w) {
    return ranges + ((static_cast<size_t>(d) * range_rows
                      + static_cast<size_t>(b) * P + part) * kWideWarps + w)
                    * 2;
  };

  for (int d = 0; d < 2; ++d) {
    if (concurrent && d != half) continue;
    for (int b = grp; active && b < B; b += NG) {
      if (lane == 0) {
        const int k = part * kWideWarps + warp;
        int* r = range(b, d, warp);
        r[0] = split_point(lists(b, d), Q, NW, k);
        r[1] = split_point(lists(b, d), Q, NW, k + 1);
      }
    }
  }
  __syncthreads();

  // the ready vector of direction d and parity p into shared memory (or
  // its address in L2)
  auto stage = [&](int d, int p, int b) -> const float* {
    const float* src = buf + (static_cast<size_t>(d) * 2 + p) * BQ
                       + static_cast<size_t>(b) * Q;
    if constexpr (kSmem) {
      for (int q = tid; q < Q; q += kWideThreads) vec_s[q] = __ldcg(src + q);
      return vec_s;
    } else {
      return src;
    }
  };

  if (!concurrent || half == 0) {  // backward
    for (int t = T - 1; t >= 0; --t) {
      for (int b = grp; active && b < B; b += NG) {
        const int* r = range(b, 0, warp);
        const int qa = r[0], qb = r[1];
        const float* orow = outp + b * TQ + static_cast<size_t>(t) * Q;
        float* brow = betas + b * TQ + static_cast<size_t>(t) * Q;
        float* dst = buf + static_cast<size_t>(t & 1) * BQ
                     + static_cast<size_t>(b) * Q;
        const bool reset = t == t_real[b] - 1;  // beta = aE, no list
        const float* vec = reset ? nullptr : stage(0, (t + 1) & 1, b);
        if (tid == 0) bmax_s = INT_MIN;
        __syncthreads();
        float tmax = -FLT_MAX;
        auto emit = [&](int q, float v) {
          if (use_beam) {
            raw[static_cast<size_t>(b) * Q + q] = v;
            tmax = fmaxf(tmax, v);
          } else {
            brow[q] = v;
            dst[q] = __ldg(orow + q) + v;
          }
        };
        if (reset) {
          for (int q = qa + lane; q < qb; q += 32)
            emit(q, __ldg(aE + static_cast<size_t>(b) * Q + q));
        } else {
          warp_states<kSmem>(vec, lists(b, 0), nbr + b * 2 * QQ,
                             val + b * 2 * QQ, qa, qb, lane, emit);
        }
        if (use_beam) {
          for (int s = 16; s > 0; s >>= 1)
            tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, s));
          if (lane == 0) atomicMax(&bmax_s, ordered(tmax));
          __syncthreads();
          if (tid == 0) atomicMax(gmax + static_cast<size_t>(b) * T + t,
                                  bmax_s);
        }
        __syncthreads();
      }
      sync_grid();
      if (use_beam) {  // prune this block's states, write betas and buf
        for (int b = grp; active && b < B; b += NG) {
          const int qa = range(b, 0, 0)[0];
          const int qb = range(b, 0, kWideWarps - 1)[1];
          const float thr =
              unordered(__ldcg(gmax + static_cast<size_t>(b) * T + t)) - beam;
          const float* orow = outp + b * TQ + static_cast<size_t>(t) * Q;
          float* brow = betas + b * TQ + static_cast<size_t>(t) * Q;
          float* dst = buf + static_cast<size_t>(t & 1) * BQ
                       + static_cast<size_t>(b) * Q;
          for (int q = qa + tid; q < qb; q += kWideThreads) {
            float v = __ldcg(raw + static_cast<size_t>(b) * Q + q);
            if (v < thr) v = kLZero;
            brow[q] = v;
            dst[q] = __ldg(orow + q) + v;
          }
        }
        sync_grid();
      }
    }
  }

  if (!concurrent || half == 1) {  // forward
    for (int t = 0; t < T; ++t) {
      for (int b = grp; active && b < B; b += NG) {
        const int* r = range(b, 1, warp);
        const int qa = r[0], qb = r[1];
        const float* orow = outp + b * TQ + static_cast<size_t>(t) * Q;
        const float* brow = betas + b * TQ + static_cast<size_t>(t) * Q;
        float* arow = alphas + b * TQ + static_cast<size_t>(t) * Q;
        float* dst = buf + (2 + static_cast<size_t>(t & 1)) * BQ
                     + static_cast<size_t>(b) * Q;
        const float* vec = t == 0 ? nullptr : stage(1, (t - 1) & 1, b);
        __syncthreads();
        auto emit = [&](int q, float pred) {
          float a = pred + __ldg(orow + q);
          if (use_beam && !(__ldcg(brow + q) > kLZero / 2)) a = kLZero;
          arow[q] = a;
          dst[q] = a;
        };
        if (t == 0) {
          for (int q = qa + lane; q < qb; q += 32)
            emit(q, __ldg(a0 + static_cast<size_t>(b) * Q + q));
        } else {
          warp_states<kSmem>(vec, lists(b, 1), nbr + (b * 2 + 1) * QQ,
                             val + (b * 2 + 1) * QQ, qa, qb, lane, emit);
        }
        __syncthreads();
      }
      sync_grid();
    }
    // logP from the last real frame, by each utterance's first block
    for (int b = grp; active && part == 0 && b < B; b += NG) {
      const int t1 = t_real[b] - 1 > 0 ? t_real[b] - 1 : 0;
      const float* a = alphas + b * TQ + static_cast<size_t>(t1) * Q;
      const float* e = aE + static_cast<size_t>(b) * Q;
      const float lp = block_ladd(Q, red_s, [&](int q) {
        return __ldg(e + q) + __ldcg(a + q);
      });
      if (tid == 0) logp[b] = lp;
    }
  }
}

}  // namespace

// The scan kernel's block size for Q states: a thread a state, up to 1,024.
static int scan_threads(int Q) {
  const int t = (Q + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// Launches the table kernels: the live-cell lists of logA into off (B, 2,
// Q + 1) and part (B, chunks, Q) int64 and nbr/val (B, 2, Q * Q), over the
// card's `sms` SMs.
static cudaError_t launch_tables(const void* logA, void* off, void* part,
                                 void* nbr, void* val, int B, int Q, int sms,
                                 cudaStream_t s) {
  const long long tasks =
      Q + static_cast<long long>((Q + 31) / 32) * ((Q + kTileRows - 1)
                                                   / kTileRows);
  long long bx = (static_cast<long long>(sms) * 8 + B - 1) / B;
  const long long need = (tasks + kTaskWarps - 1) / kTaskWarps;
  if (bx > need) bx = need;
  const dim3 grid(static_cast<unsigned>(bx), B);
  long long* o = static_cast<long long*>(off);
  long long* p = static_cast<long long*>(part);
  fb_tables_kernel<false><<<grid, kTaskThreads, 0, s>>>(
      static_cast<const float*>(logA), o, p, nullptr, nullptr, Q);
  const int threads = Q >= 1024 ? 1024 : (Q + 31) / 32 * 32;
  fb_offsets_kernel<<<dim3(B, 2), threads, 0, s>>>(o, p, Q);
  fb_tables_kernel<true><<<grid, kTaskThreads, 0, s>>>(
      static_cast<const float*>(logA), o, p, static_cast<int*>(nbr),
      static_cast<float*>(val), Q);
  return cudaGetLastError();
}

// Clears xi and launches fb_xi_kernel over the live cells of the
// successor lists.
static cudaError_t launch_xi(const void* outp, const void* alphas,
                             const void* betas, const void* logp,
                             const void* t_real, const void* off,
                             const void* nbr, const void* val, void* xi,
                             int B, int T, int Q, cudaStream_t s) {
  const size_t QQ = static_cast<size_t>(Q) * Q;
  cudaError_t err = cudaMemsetAsync(
      xi, 0, static_cast<size_t>(B) * QQ * sizeof(float), s);
  if (err != cudaSuccess) return err;
  size_t nx = (kXiBlocks + B - 1) / B;
  const size_t cap = (QQ + kXiThreads / 32 - 1) / (kXiThreads / 32);
  if (nx > cap) nx = cap;
  fb_xi_kernel<<<dim3(static_cast<unsigned>(nx), B), kXiThreads, 0, s>>>(
      static_cast<const float*>(outp), static_cast<const float*>(alphas),
      static_cast<const float*>(betas), static_cast<const float*>(logp),
      static_cast<const int*>(t_real), static_cast<const long long*>(off),
      static_cast<const int*>(nbr), static_cast<const float*>(val),
      static_cast<float*>(xi), T, Q);
  return cudaGetLastError();
}

static cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Launches the narrow design's table, scan and xi kernels on `stream` (xi
// unless xi is null); returns the first cudaError_t. off / part / nbr / val
// are the wrapper's scratch: (B, 2, Q + 1) and (B, chunks, Q) int64, (B, 2,
// Q * Q) int32 and (B, 2, Q * Q) float32. smem is the scan kernel's dynamic
// shared memory (the wrapper's `scan_smem`).
extern "C" int fb_scans_launch(
    const void* outp, const void* logA, const void* a0, const void* aE,
    const void* t_real, void* alphas, void* betas, void* logp, void* xi,
    void* off, void* part, void* nbr, void* val, int B, int T, int Q,
    int smem, int use_beam, float beam, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int smem_set[64] = {};  // per card: raise the attribute once
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        fb_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = smem;
  }
  err = launch_tables(logA, off, part, nbr, val, B, Q, sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_scan_kernel<<<use_beam ? B : 2 * B, scan_threads(Q), smem, s>>>(
      static_cast<const float*>(outp), static_cast<const float*>(a0),
      static_cast<const float*>(aE), static_cast<const int*>(t_real),
      static_cast<const long long*>(off), static_cast<const int*>(nbr),
      static_cast<const float*>(val), static_cast<float*>(alphas),
      static_cast<float*>(betas), static_cast<float*>(logp), B, T, Q, smem,
      use_beam, beam);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (xi) {
    err = launch_xi(outp, alphas, betas, logp, t_real, off, nbr, val, xi, B,
                    T, Q, s);
  }
  return static_cast<int>(err);
}

// Launches the wide design on `stream`: the table kernels, the cooperative
// scan grid (SMs x the blocks an SM holds: 132 on an H100), and xi unless
// xi is null; returns the first cudaError_t. Scratch from the wrapper: off
// (B, 2, Q + 1) and part (B, chunks, Q) int64, nbr/val (B, 2, Q * Q), buf
// (2, 2, B, Q) float32 (LZERO), raw (B, Q) float32 and gmax (B, T) int32
// (INT_MIN) under a beam, ranges (2, rows, 32, 2) int32 with rows at least
// max(B, the grid), barrier (2,) uint32 (zero). vec_smem: 4 Q, the bytes of
// shared memory for a block's copy of the state vector, or 0: the scan then
// reads it from L2 (the wrapper's `wide_vec_smem`). events: null, or 4
// cudaEvent_t recorded before the tables, before the scan, before xi and
// at the end.
extern "C" int fb_scans_wide_launch(
    const void* outp, const void* logA, const void* a0, const void* aE,
    const void* t_real, void* alphas, void* betas, void* logp, void* xi,
    void* off, void* part, void* nbr, void* val, void* buf, void* raw,
    void* gmax, void* ranges, void* barrier, void* const* events, int B,
    int T, int Q, int use_beam, float beam, int vec_smem, int rows,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* scan =
      vec_smem ? reinterpret_cast<const void*>(fb_wide_scan_kernel<true>)
               : reinterpret_cast<const void*>(fb_wide_scan_kernel<false>);
  int sms = 0, occ = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        scan, cudaFuncAttributeMaxDynamicSharedMemorySize, vec_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, scan,
                                                        kWideThreads,
                                                        vec_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = sms * occ;
  if (grid < 2 || grid > rows || B > rows)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto mark = [&](int i) {
    return events ? cudaEventRecord(static_cast<cudaEvent_t>(events[i]), s)
                  : cudaSuccess;
  };
  if ((err = mark(0)) != cudaSuccess) return static_cast<int>(err);
  err = launch_tables(logA, off, part, nbr, val, B, Q, sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = mark(1)) != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&outp, &a0, &aE, &t_real, &off, &nbr, &val, &alphas,
                  &betas, &logp, &buf, &raw, &gmax, &ranges, &barrier, &B,
                  &T, &Q, &use_beam, &beam, &rows};
  err = cudaLaunchCooperativeKernel(scan, dim3(grid), dim3(kWideThreads),
                                    args, static_cast<size_t>(vec_smem), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = mark(2)) != cudaSuccess) return static_cast<int>(err);
  if (xi) {
    err = launch_xi(outp, alphas, betas, logp, t_real, off, nbr, val, xi, B,
                    T, Q, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(mark(3));
}
