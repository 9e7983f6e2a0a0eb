// HRec token-passing decode over a general word network, for Hopper (sm_90a).
//
// Replaces the TPU kernel htk_tpu/ops/decode_pallas.py : decode_scan_pallas
// (kernel body _make_kernel). Contract: htk_tpu/algo/decode.py : decode_scan,
// batched. Per utterance b and frame t:
//
//   1. word ends   WE[n] = max(LZERO, max_{s in n} v[s] + aE[s]); the first
//                  maximising state gives pwn/pwt, -1 where WE <= LSMALL
//   2. cross-word  entry[j] = (max_i WE[i] + trans[i,j]) + wdpen[j], first i;
//                  at t == 0 entry = start and an = -1
//   3. within-word max_k v[s-k] + band[k,s] over the K-wide band, first k,
//                  wn/wt carried from the same k
//   4. combine     entry_s = (entry[node[s]] + a0[s]) + bonus[s];
//                  v' = max(within, entry_s) + outp[b,t,s]; records from the
//                  entry (an[node], t-1) where entry_s > within; records of
//                  states with v' <= LSMALL reset to -1
//
// Every value is one fp32 add or a max, in the reference's order, so the
// kernel and the plain torch version (ops/decode_scan.py) agree bit for bit.
//
// Design: one persistent thread block per utterance loops over the T frames
// with __syncthreads() between the phases. The state vectors v/wn/wt
// (12 B x Ns, ~150 KB at Ns = 12k, twice for ping-pong) exceed what shared
// memory can hold beside the rest, so they live in a per-utterance global
// ping-pong scratch that the wrapper allocates; they stay resident in L2.
// Shared memory holds only WE, entry and an (12 B x Nn). The TPU kernel's
// additive (Nn, Ns) membership mask (48 MB at Nn = 1k) is replaced by a CSR
// of node offsets: the states of one node are contiguous.
//   - word ends: one warp per node segment, a shuffle reduction on
//     (value, state index) that keeps the first maximiser;
//   - cross-word: one thread per target j walking down column j, so that
//     neighbouring threads read neighbouring trans[i, j];
//   - within-word and combine: one thread per state.
//
// What bounds it: each frame streams the whole (Nn, Nn) trans matrix (4 MB
// at Nn = 1k) once per utterance, from L2, on B SMs only, so the cross-word
// step dominates and most of the card idles at small B. The fix, sharing one
// trans tile across the batch (as htk_tpu/ops/maxplus_pallas.py does) and
// spreading the columns of one frame over several blocks, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr float kLSmall = -0.5e10f;
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
decode_scan_kernel(const float* __restrict__ outp,        // (B, T, Ns)
                   const float* __restrict__ band,        // (K, Ns)
                   const float* __restrict__ a0,          // (Ns,)
                   const float* __restrict__ aE,          // (Ns,)
                   const float* __restrict__ bonus,       // (Ns,)
                   const int* __restrict__ node_of_state, // (Ns,)
                   const int* __restrict__ node_off,      // (Nn + 1,)
                   const float* __restrict__ trans,       // (Nn, Nn)
                   const float* __restrict__ start,       // (Nn,)
                   const float* __restrict__ wdpen,       // (Nn,)
                   float* __restrict__ we_out,            // (B, T, Nn)
                   int* __restrict__ pwn_out,             // (B, T, Nn)
                   int* __restrict__ pwt_out,             // (B, T, Nn)
                   float* vbuf,                           // (2, B, Ns)
                   int* wnbuf,                            // (2, B, Ns)
                   int* wtbuf,                            // (2, B, Ns)
                   int B, int T, int Ns, int Nn, int K) {
  extern __shared__ unsigned char smem[];
  float* we_s = reinterpret_cast<float*>(smem);
  float* entry_s = we_s + Nn;
  int* an_s = reinterpret_cast<int*>(entry_s + Nn);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const size_t plane = static_cast<size_t>(B) * Ns;
  const size_t row = static_cast<size_t>(b) * Ns;

  for (int s = tid; s < Ns; s += nthr) {
    vbuf[row + s] = kLZero;
    wnbuf[row + s] = -1;
    wtbuf[row + s] = -1;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t cur = (t & 1) ? plane : 0;
    const size_t nxt = (t & 1) ? 0 : plane;
    const float* v = vbuf + cur + row;
    const int* wn = wnbuf + cur + row;
    const int* wt = wtbuf + cur + row;
    const size_t rec = (static_cast<size_t>(b) * T + t) * Nn;

    // 1. word ends: one warp per node segment
    for (int n = warp; n < Nn; n += nwarps) {
      const int s0 = node_off[n];
      const int s1 = node_off[n + 1];
      float best = kLZero;
      int sid = 0x7fffffff;
      for (int s = s0 + lane; s < s1; s += 32) {
        const float e = v[s] + aE[s];
        if (e > best) {
          best = e;
          sid = s;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(kFull, best, off);
        const int os = __shfl_down_sync(kFull, sid, off);
        if (ob > best || (ob == best && os < sid)) {
          best = ob;
          sid = os;
        }
      }
      if (lane == 0) {
        const bool ok = best > kLSmall;
        we_s[n] = best;
        we_out[rec + n] = best;
        pwn_out[rec + n] = ok ? wn[sid] : -1;
        pwt_out[rec + n] = ok ? wt[sid] : -1;
      }
    }
    __syncthreads();

    // 2. cross-word max-plus: one thread per target node j
    for (int j = tid; j < Nn; j += nthr) {
      if (t == 0) {
        entry_s[j] = start[j];
        an_s[j] = -1;
        continue;
      }
      const float* col = trans + j;
      float best = we_s[0] + col[0];
      int arg = 0;
      int i = 1;
      for (; i + 4 <= Nn; i += 4) {
        const float c0 = we_s[i] + col[static_cast<size_t>(i) * Nn];
        const float c1 = we_s[i + 1] + col[static_cast<size_t>(i + 1) * Nn];
        const float c2 = we_s[i + 2] + col[static_cast<size_t>(i + 2) * Nn];
        const float c3 = we_s[i + 3] + col[static_cast<size_t>(i + 3) * Nn];
        if (c0 > best) { best = c0; arg = i; }
        if (c1 > best) { best = c1; arg = i + 1; }
        if (c2 > best) { best = c2; arg = i + 2; }
        if (c3 > best) { best = c3; arg = i + 3; }
      }
      for (; i < Nn; ++i) {
        const float c = we_s[i] + col[static_cast<size_t>(i) * Nn];
        if (c > best) { best = c; arg = i; }
      }
      entry_s[j] = best + wdpen[j];
      an_s[j] = arg;
    }
    __syncthreads();

    // 3 + 4. within-word band and combine: one thread per state
    float* vn = vbuf + nxt + row;
    int* wnn = wnbuf + nxt + row;
    int* wtn = wtbuf + nxt + row;
    const float* op = outp + (static_cast<size_t>(b) * T + t) * Ns;
    for (int s = tid; s < Ns; s += nthr) {
      float within = v[s] + band[s];
      int src = s;
      for (int k = 1; k < K; ++k) {
        const float c = (s >= k ? v[s - k] : kLZero)
                        + band[static_cast<size_t>(k) * Ns + s];
        if (c > within) {
          within = c;
          src = s >= k ? s - k : -1;
        }
      }
      const int n = node_of_state[s];
      const float es = (entry_s[n] + a0[s]) + bonus[s];
      const bool use_entry = es > within;
      const float nv = (use_entry ? es : within) + op[s];
      int rwn, rwt;
      if (use_entry) {
        rwn = an_s[n];
        rwt = t - 1;
      } else {
        rwn = src >= 0 ? wn[src] : -1;
        rwt = src >= 0 ? wt[src] : -1;
      }
      if (nv <= kLSmall) {
        rwn = -1;
        rwt = -1;
      }
      vn[s] = nv;
      wnn[s] = rwn;
      wtn[s] = rwt;
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The finals after T frames sit in plane (T & 1) of vbuf/wnbuf/wtbuf.
extern "C" int decode_scan_launch(
    const void* outp, const void* band, const void* a0, const void* aE,
    const void* bonus, const void* node_of_state, const void* node_off,
    const void* trans, const void* start, const void* wdpen,
    void* we_out, void* pwn_out, void* pwt_out,
    void* vbuf, void* wnbuf, void* wtbuf,
    int B, int T, int Ns, int Nn, int K, void* stream) {
  const size_t smem = static_cast<size_t>(Nn) * 12;
  cudaError_t err = cudaFuncSetAttribute(
      decode_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_scan_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(outp), static_cast<const float*>(band),
      static_cast<const float*>(a0), static_cast<const float*>(aE),
      static_cast<const float*>(bonus),
      static_cast<const int*>(node_of_state),
      static_cast<const int*>(node_off), static_cast<const float*>(trans),
      static_cast<const float*>(start), static_cast<const float*>(wdpen),
      static_cast<float*>(we_out), static_cast<int*>(pwn_out),
      static_cast<int*>(pwt_out), static_cast<float*>(vbuf),
      static_cast<int*>(wnbuf), static_cast<int*>(wtbuf), B, T, Ns, Nn, K);
  return static_cast<int>(cudaGetLastError());
}
