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
// Design. The three recursions are sequential in t, so fb_scan_kernel runs
// one block per utterance over both scans, 32 warps, one warp per output
// state at a time: the warp reads a row (backward) or a column (forward) of
// logA, takes the max and then the sum of exps with shuffles. logA stays in
// shared memory with a row stride of Q + 1, so that rows and columns both
// read without bank conflicts, while Q (Q + 1) floats fit (Q <= 239; 147 KB
// at Q = 192). A larger Q reads logA from global memory (L2) instead, and
// its transpose for the forward step, so that every warp reads contiguous
// memory. The state vectors live in shared memory. xi is no recursion: the
// second kernel, fb_xi_kernel, gives each of the B Q^2 cells a thread that
// sums over t, so it spreads over the whole card.
//
// What bounds it: the scans do 2 T Q^2 log-semiring terms per utterance on
// one SM each (B of the card's 132 SMs), so at B = 8 they are bound by the
// latency of T dependent steps of shared-memory reads, shuffles and
// __syncthreads, not by bytes or the card's peak rate. Spreading an
// utterance over several SMs and skipping the LZERO blocks of the banded
// composite logA are later work.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr float kLSmall = -0.5e10f;
constexpr float kMinLogExp = -23.025850929940457f;  // -log(-LZERO)
constexpr float kMinEArg = -708.3f;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kXiThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// ladd_reduce over k < n of x(k) = vec[k] + A[k * step], by one warp; every
// lane returns the result. Two passes (max, then the sum of exps) read A
// twice rather than keep n terms in registers.
__device__ float warp_ladd(const float* vec, const float* A, size_t step,
                           int n, int lane) {
  float hi = -FLT_MAX;
  for (int k = lane; k < n; k += 32) hi = fmaxf(hi, vec[k] + A[k * step]);
  for (int off = 16; off > 0; off >>= 1)
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
  float sum = 0.0f;
  for (int k = lane; k < n; k += 32) {
    const float diff = (vec[k] + A[k * step]) - hi;
    sum += diff < kMinLogExp ? 0.0f : expf(diff);
  }
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  return hi < kLSmall ? kLZero : hi + logf(sum);
}

__global__ void __launch_bounds__(kThreads)
fb_scan_kernel(const float* __restrict__ outp,   // (B, T, Q)
               const float* __restrict__ logA,   // (B, Q, Q)
               const float* __restrict__ logAT,  // (B, Q, Q), or null
               const float* __restrict__ a0,     // (B, Q)
               const float* __restrict__ aE,     // (B, Q)
               const int* __restrict__ t_real,   // (B,)
               float* alphas,                    // (B, T, Q)
               float* betas,                     // (B, T, Q)
               float* logp,                      // (B,)
               int T, int Q, int smem_A, int use_beam, float beam) {
  extern __shared__ float smem[];
  float* vec_s = smem;          // (Q,) backward: o_next + beta_next
  float* cur_s = vec_s + Q;     // (Q,) backward: beta_t
  float* red_s = cur_s + Q;     // (kWarps,) per-warp maxima for the beam
  float* A_s = red_s + kWarps;  // (Q, Q + 1) logA when smem_A

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t QQ = static_cast<size_t>(Q) * Q;
  const size_t TQ = static_cast<size_t>(T) * Q;
  const float* op = outp + b * TQ;
  float* al = alphas + b * TQ;
  float* be = betas + b * TQ;
  const float* a0b = a0 + static_cast<size_t>(b) * Q;
  const float* aEb = aE + static_cast<size_t>(b) * Q;
  const int tr = t_real[b];

  // logA[i, j] = rowA[i * row_stride + j] = colA[j * col_stride + i * col_step]
  const float* rowA;
  const float* colA;
  size_t row_stride, col_stride, col_step;
  if (smem_A) {
    const float* gA = logA + b * QQ;
    for (size_t idx = tid; idx < QQ; idx += kThreads) {
      const size_t i = idx / Q;
      A_s[idx + i] = gA[idx];  // row i starts at i * (Q + 1)
    }
    rowA = colA = A_s;
    row_stride = col_step = Q + 1;
    col_stride = 1;
  } else {
    rowA = logA + b * QQ;
    colA = logAT + b * QQ;
    row_stride = col_stride = Q;
    col_step = 1;
  }
  for (int q = tid; q < Q; q += kThreads) cur_s[q] = kLZero;
  __syncthreads();

  // backward: beta_t from beta_{t+1}, reset to aE at t_real - 1
  for (int t = T - 1; t >= 0; --t) {
    const float* o_next = op + static_cast<size_t>(t + 1) * Q;
    for (int j = tid; j < Q; j += kThreads)
      vec_s[j] = (t == T - 1 ? 0.0f : o_next[j]) + cur_s[j];
    __syncthreads();
    float wmax = -FLT_MAX;
    for (int i = warp; i < Q; i += kWarps) {
      float v = warp_ladd(vec_s, rowA + i * row_stride, 1, Q, lane);
      if (t == tr - 1) v = aEb[i];
      wmax = fmaxf(wmax, v);
      if (lane == 0) cur_s[i] = v;
    }
    if (use_beam && lane == 0) red_s[warp] = wmax;
    __syncthreads();
    if (use_beam) {
      float mx = red_s[0];
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_s[w]);
      const float thr = mx - beam;
      for (int i = tid; i < Q; i += kThreads)
        if (cur_s[i] < thr) cur_s[i] = kLZero;
      __syncthreads();
    }
    for (int i = tid; i < Q; i += kThreads)
      be[static_cast<size_t>(t) * Q + i] = cur_s[i];
  }
  __syncthreads();

  // forward: alpha_t from alpha_{t-1} (ping-pong in vec_s / cur_s)
  float* prev = vec_s;
  float* next = cur_s;
  for (int t = 0; t < T; ++t) {
    const size_t row = static_cast<size_t>(t) * Q;
    for (int j = warp; j < Q; j += kWarps) {
      const float pred = t == 0
          ? a0b[j]
          : warp_ladd(prev, colA + j * col_stride, col_step, Q, lane);
      float a = pred + op[row + j];
      if (use_beam && !(be[row + j] > kLZero / 2)) a = kLZero;
      if (lane == 0) {
        next[j] = a;
        al[row + j] = a;
      }
    }
    __syncthreads();
    float* tmp = prev;
    prev = next;
    next = tmp;
  }

  // logP from the last real frame
  if (warp == 0) {
    const int t1 = tr - 1 > 0 ? tr - 1 : 0;
    const float lp = warp_ladd(aEb, al + static_cast<size_t>(t1) * Q, 1, Q,
                               lane);
    if (lane == 0) logp[b] = lp;
  }
}

__global__ void __launch_bounds__(kXiThreads)
fb_xi_kernel(const float* __restrict__ outp,    // (B, T, Q)
             const float* __restrict__ logA,    // (B, Q, Q)
             const float* __restrict__ alphas,  // (B, T, Q)
             const float* __restrict__ betas,   // (B, T, Q)
             const float* __restrict__ logp,    // (B,)
             const int* __restrict__ t_real,    // (B,)
             float* __restrict__ xi,            // (B, Q, Q)
             int T, int Q) {
  const int b = blockIdx.y;
  const size_t QQ = static_cast<size_t>(Q) * Q;
  const size_t cell = static_cast<size_t>(blockIdx.x) * kXiThreads
                      + threadIdx.x;
  if (cell >= QQ) return;
  const int i = static_cast<int>(cell / Q);
  const int j = static_cast<int>(cell - static_cast<size_t>(i) * Q);
  const size_t TQ = static_cast<size_t>(T) * Q;
  const float* al = alphas + b * TQ + i;
  const float* op = outp + b * TQ + j;
  const float* be = betas + b * TQ + j;
  const float a = logA[b * QQ + cell];
  const float lp = logp[b];
  const int tr = t_real[b];
  float acc = 0.0f;
  for (int t = 0; t < tr - 1; ++t) {
    const size_t nx = static_cast<size_t>(t + 1) * Q;
    const float tgt = op[nx] + be[nx];
    const float x = ((al[static_cast<size_t>(t) * Q] + a) + tgt) - lp;
    acc += x > kLSmall ? expf(fmaxf(x, kMinEArg)) : 0.0f;
  }
  xi[b * QQ + cell] = acc;
}

}  // namespace

// Launches both kernels on `stream`, the scans then xi; returns the
// cudaError_t of the launches. logAT is read only when smem_A is 0.
extern "C" int fb_scans_launch(
    const void* outp, const void* logA, const void* logAT, const void* a0,
    const void* aE, const void* t_real, void* alphas, void* betas,
    void* logp, void* xi, int B, int T, int Q, int smem_A, int use_beam,
    float beam, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = (2 * static_cast<size_t>(Q) + kWarps) * sizeof(float);
  if (smem_A) smem += static_cast<size_t>(Q) * (Q + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fb_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_scan_kernel<<<B, kThreads, smem, s>>>(
      static_cast<const float*>(outp), static_cast<const float*>(logA),
      static_cast<const float*>(logAT), static_cast<const float*>(a0),
      static_cast<const float*>(aE), static_cast<const int*>(t_real),
      static_cast<float*>(alphas), static_cast<float*>(betas),
      static_cast<float*>(logp), T, Q, smem_A, use_beam, beam);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t QQ = static_cast<size_t>(Q) * Q;
  const dim3 grid(static_cast<unsigned>((QQ + kXiThreads - 1) / kXiThreads),
                  static_cast<unsigned>(B));
  fb_xi_kernel<<<grid, kXiThreads, 0, s>>>(
      static_cast<const float*>(outp), static_cast<const float*>(logA),
      static_cast<const float*>(alphas), static_cast<const float*>(betas),
      static_cast<const float*>(logp), static_cast<const int*>(t_real),
      static_cast<float*>(xi), T, Q);
  return static_cast<int>(cudaGetLastError());
}
