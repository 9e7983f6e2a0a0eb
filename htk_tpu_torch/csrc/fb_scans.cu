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
// Design. fb_tables_kernel lists, per utterance, the live successors of
// each state (for the backward scan and xi) and its live predecessors (for
// the forward scan), in ascending index order with their logA values, in
// a global scratch (the wrapper's): a warp a row with ballots for the
// successors, a thread a column walking the rows for the predecessors.
// fb_scan_kernel then gives each state a thread (a thread loops over
// states where Q exceeds the block); a step is, per state, the two-pass
// max-then-sum over its list, reading the previous step's state vector
// from shared memory, and one __syncthreads (two under a beam, for the
// block-wide max), the state vectors ping-ponging. The block copies its
// lists into shared memory when they fit beside the vectors and offsets,
// and reads them from the global scratch when they do not (a dense logA of
// 250 states has 62,500 cells): the same code on another pointer. Without
// a beam the two scans are independent, so 2B blocks run them at once,
// backward in blocks [0, B) and forward in [B, 2B); under a beam the
// forward scan needs the betas, so B blocks run backward then forward.
// The launch clears xi (a dead cell's is 0), then fb_xi_kernel gives each
// live cell a warp (its row found by a binary search of the offsets) whose
// lanes split the sum over t, so xi's terms are added in another order than
// the reference's (within xi's tolerance); a grid-stride loop spreads the
// cells over the card.
//
// What bounds it: the latency of T dependent steps per scan. Bytes (outp
// in, alphas and betas out: 11.8 MB at B = 8, T = 512, Q = 192) are 3.5 us
// at the HBM rate, and the live cells' operations a tenth of that; each
// step is a few dependent shared-memory reads, exps and logs per state
// and a barrier, on B (or 2B) of the card's 132 SMs. A state with a long
// list (an ergodic model) runs its list serially in one thread.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr float kLSmall = -0.5e10f;
constexpr float kDead = kLZero / 2;  // logA at or below: no transition
constexpr float kMinLogExp = -23.025850929940457f;  // -log(-LZERO)
constexpr float kMinEArg = -708.3f;
constexpr int kTableThreads = 512;
constexpr int kXiThreads = 256;
constexpr int kXiBlocks = 528;  // 4 per SM over the batch
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

// cnt[0..Q) -> exclusive offsets cnt[0..Q], by warp 0; then a barrier
__device__ void exclusive_scan(int* cnt, int Q) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < Q; base += 32) {
      const int q = base + lane;
      const int v = q < Q ? cnt[q] : 0;
      int x = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      if (q < Q) cnt[q] = carry + x - v;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) cnt[Q] = carry;
  }
  __syncthreads();
}

// Lists of utterance blockIdx.x, direction blockIdx.y: 0 the successors j
// of each row i, 1 the predecessors i of each column j; entries ascending.
__global__ void __launch_bounds__(kTableThreads)
fb_tables_kernel(const float* __restrict__ logA,  // (B, Q, Q)
                 int* __restrict__ off,           // (B, 2, Q + 1)
                 int* __restrict__ nbr,           // (B, 2, Q * Q)
                 float* __restrict__ val,         // (B, 2, Q * Q)
                 int Q) {
  extern __shared__ int cnt[];  // (Q + 1,)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t QQ = static_cast<size_t>(Q) * Q;
  const float* A = logA + blockIdx.x * QQ;
  const size_t list = static_cast<size_t>(blockIdx.x) * 2 + blockIdx.y;
  int* nb = nbr + list * QQ;
  float* va = val + list * QQ;
  const bool rows = blockIdx.y == 0;
  if (rows) {
    for (int i = warp; i < Q; i += nwarps) {
      const float* Ai = A + static_cast<size_t>(i) * Q;
      int c = 0;
      for (int j0 = 0; j0 < Q; j0 += 32) {
        const int j = j0 + lane;
        c += __popc(__ballot_sync(kFull, j < Q && Ai[j] > kDead));
      }
      if (lane == 0) cnt[i] = c;
    }
  } else {
    for (int j = tid; j < Q; j += blockDim.x) {
      int c = 0;
      for (int i = 0; i < Q; ++i)
        c += A[static_cast<size_t>(i) * Q + j] > kDead;
      cnt[j] = c;
    }
  }
  __syncthreads();
  exclusive_scan(cnt, Q);
  if (rows) {
    for (int i = warp; i < Q; i += nwarps) {
      const float* Ai = A + static_cast<size_t>(i) * Q;
      int at = cnt[i];
      for (int j0 = 0; j0 < Q; j0 += 32) {
        const int j = j0 + lane;
        const float a = j < Q ? Ai[j] : kLZero;
        const bool live = a > kDead;
        const unsigned m = __ballot_sync(kFull, live);
        if (live) {
          const int k = at + __popc(m & ((1u << lane) - 1u));
          nb[k] = j;
          va[k] = a;
        }
        at += __popc(m);
      }
    }
  } else {
    for (int j = tid; j < Q; j += blockDim.x) {
      int at = cnt[j];
      for (int i = 0; i < Q; ++i) {
        const float a = A[static_cast<size_t>(i) * Q + j];
        if (a > kDead) {
          nb[at] = i;
          va[at] = a;
          ++at;
        }
      }
    }
  }
  int* o = off + list * (Q + 1);
  for (int q = tid; q <= Q; q += blockDim.x) o[q] = cnt[q];
}

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
               const int* off,                   // (B, 2, Q + 1)
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
    const int* g = off + (static_cast<size_t>(b) * 2 + d0 + d) * (Q + 1);
    for (int q = tid; q <= Q; q += nthreads) off_s[d * (Q + 1) + q] = g[q];
    total += g[Q];
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
    const int n = off[list * (Q + 1) + Q];
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
             const int* __restrict__ off,       // (B, 2, Q + 1)
             const int* __restrict__ nbr,       // (B, 2, Q * Q)
             const float* __restrict__ val,     // (B, 2, Q * Q)
             float* __restrict__ xi,            // (B, Q, Q)
             int T, int Q) {
  constexpr int kXiWarps = kXiThreads / 32;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const size_t QQ = static_cast<size_t>(Q) * Q;
  const size_t TQ = static_cast<size_t>(T) * Q;
  const int* o = off + static_cast<size_t>(b) * 2 * (Q + 1);  // successors
  const int* nb = nbr + static_cast<size_t>(b) * 2 * QQ;
  const float* va = val + static_cast<size_t>(b) * 2 * QQ;
  const int n = o[Q];
  const float lp = logp[b];
  const int tr = t_real[b];
  for (int k = blockIdx.x * kXiWarps + (threadIdx.x >> 5); k < n;
       k += gridDim.x * kXiWarps) {
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

}  // namespace

// The scan kernel's block size for Q states: a thread a state, up to 1,024.
static int scan_threads(int Q) {
  const int t = (Q + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// Launches the table, scan and xi kernels on `stream`; returns the first
// cudaError_t. off / nbr / val are the wrapper's scratch: (B, 2, Q + 1)
// int32, (B, 2, Q * Q) int32 and (B, 2, Q * Q) float32. smem is the scan
// kernel's dynamic shared memory (the wrapper's `scan_smem`).
extern "C" int fb_scans_launch(
    const void* outp, const void* logA, const void* a0, const void* aE,
    const void* t_real, void* alphas, void* betas, void* logp, void* xi,
    void* off, void* nbr, void* val, int B, int T, int Q, int smem,
    int use_beam, float beam, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int smem_set[64] = {};  // per card: raise the attribute once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        fb_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = smem;
  }
  fb_tables_kernel<<<dim3(B, 2), kTableThreads, (Q + 1) * sizeof(int), s>>>(
      static_cast<const float*>(logA), static_cast<int*>(off),
      static_cast<int*>(nbr), static_cast<float*>(val), Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_scan_kernel<<<use_beam ? B : 2 * B, scan_threads(Q), smem, s>>>(
      static_cast<const float*>(outp), static_cast<const float*>(a0),
      static_cast<const float*>(aE), static_cast<const int*>(t_real),
      static_cast<const int*>(off), static_cast<const int*>(nbr),
      static_cast<const float*>(val), static_cast<float*>(alphas),
      static_cast<float*>(betas), static_cast<float*>(logp), B, T, Q, smem,
      use_beam, beam);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t QQ = static_cast<size_t>(Q) * Q;
  err = cudaMemsetAsync(xi, 0, static_cast<size_t>(B) * QQ * sizeof(float),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t nx = (kXiBlocks + B - 1) / B;
  const size_t cap = (QQ + kXiThreads / 32 - 1) / (kXiThreads / 32);
  if (nx > cap) nx = cap;
  fb_xi_kernel<<<dim3(static_cast<unsigned>(nx), B), kXiThreads, 0, s>>>(
      static_cast<const float*>(outp), static_cast<const float*>(alphas),
      static_cast<const float*>(betas), static_cast<const float*>(logp),
      static_cast<const int*>(t_real), static_cast<const int*>(off),
      static_cast<const int*>(nbr), static_cast<const float*>(val),
      static_cast<float*>(xi), T, Q);
  return static_cast<int>(cudaGetLastError());
}
