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
// Design: one cooperative, persistent grid of G blocks (the SM count times
// the occupancy at the full shared-memory budget: 132 on an H100) loops over
// the T frames for the whole batch. The host cuts the nodes into G
// contiguous ranges (ops/decode_scan.py : partition); block g owns nodes
// [bounds[g], bounds[g+1]), their states (contiguous, from node_off) and the
// matching target columns of trans. Before frame 0 it copies its columns
// trans[:, n0:n1] into shared memory, where they stay for all T frames, if
// they fit beside the rest; otherwise it reads them from global memory (L2).
// Either way trans is read once a frame for the whole batch. Per frame:
//   - one grid-wide barrier, the only one a frame: every block's word ends
//     of frame t and states of frame t - 1 are written;
//   - per chunk of `bchunk` utterances: the chunk's WE rows of frame t
//     (every node) staged in shared memory; the cross-word max over i for
//     the block's columns, with the i range split over lanes (16-byte reads
//     of quads of WE and of the column) and warps, and the (value, index)
//     partials merged by "larger value, then smaller index", which is the
//     serial scan's first-i rule since every candidate is the same single
//     fp32 add;
//   - band, combine and the word ends of frame t + 1, by groups of gw lanes,
//     one (utterance, node) pair each: a lane takes a state, loads the K
//     band candidates' scores and records together (one round trip to L2,
//     the K - 1 halo states below the block's range included, which the
//     neighbour wrote before the barrier), writes v(t), and keeps the first
//     maximising v(t) + aE with its records; a shuffle reduction over the
//     group gives the node's word end, written to the (B, T, Nn) records.
//     The word ends of frame 0 come from the same pass over the initial
//     states, before the loop.
// One barrier a frame is enough: v(t-1), halos included, is complete before
// the barrier of frame t, and a block overwrites that plane (in frame t+1)
// only after the barrier of frame t+1, which every block reaches only after
// its reads of frame t. The state vectors v/wn/wt live in a (2, B, Ns)
// global ping-pong scratch (resident in L2); data written by other blocks
// during the launch is read with ld.global.cg, past the SM's L1. The
// barrier is a monotonic arrival counter (zeroed by the wrapper) with
// release/acquire at GPU scope; the cooperative launch guarantees that all
// G blocks are resident, and is refused (an error, no fallback) otherwise.
//
// What bounds it: the T dependent frames, not bytes or operations. Each
// frame pays one grid barrier and a chain of dependent steps: the WE rows
// from L2 (every block reads the same B x Nn values), the cross-word
// add-and-compare over (B, cols, Nn), and one round trip to L2 for the
// states. On an H100 (700 W) a frame takes about 8.8 us at B = 8,
// Nn = 1,000, Ns = 11,955, against about 4 us for a one-node net (the
// barrier and the phases' latencies alone). Each barrier's acquire
// invalidates the SM's L1, so a block keeps its nodes' state offsets, word
// penalties and starts in shared memory, and the frame loop's index
// arithmetic avoids divisions (instruction issue, over 32 warps, is much of
// each phase). Later work: one copy of the word ends a thread-block cluster
// instead of a block (distributed shared memory or TMA multicast), so that
// L2 serves each WE row once a cluster; fewer barriers (several frames a
// barrier where the network's cross-word links allow it).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr float kLSmall = -0.5e10f;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;  // 227 KB, the most a Hopper block can use
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = 8;  // WE loads a thread keeps in flight

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

// Every block arrives once per frame; the counter reaches target = (t+1)*G
// when all G blocks have arrived at frame t's barrier. The block's writes
// are ordered before thread 0's release by the first __syncthreads, and
// its reads after thread 0's acquire by the second.
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

// (v, i) beats (bv, bi) if larger, or equal with a smaller index
__device__ __forceinline__ void merge(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// A word end in the making: the first maximising state's e = v + aE and
// its records.
struct WordEnd {
  float e;
  int sid, wn, wt;
};

__device__ __forceinline__ void keep_first_max(WordEnd& w, float e, int s,
                                               int wn, int wt) {
  if (e > w.e || (e == w.e && s < w.sid)) {
    w.e = e;
    w.sid = s;
    w.wn = wn;
    w.wt = wt;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
decode_scan_kernel(const float* __restrict__ outp,        // (B, T, Ns)
                   const float* __restrict__ band,        // (K, Ns)
                   const float* __restrict__ a0,          // (Ns,)
                   const float* __restrict__ aE,          // (Ns,)
                   const float* __restrict__ bonus,       // (Ns,)
                   const int* __restrict__ node_off,      // (Nn + 1,)
                   const int* __restrict__ bounds,        // (G + 1,)
                   const float* __restrict__ trans,       // (Nn, Nn)
                   const float* __restrict__ start,       // (Nn,)
                   const float* __restrict__ wdpen,       // (Nn,)
                   float* we_out,                         // (B, T, Nn)
                   int* pwn_out,                          // (B, T, Nn)
                   int* pwt_out,                          // (B, T, Nn)
                   float* vbuf,                           // (2, B, Ns)
                   int* wnbuf,                            // (2, B, Ns)
                   int* wtbuf,                            // (2, B, Ns)
                   unsigned* barrier,                     // (1,), zeroed
                   int B, int T, int Ns, int Nn, int K, int nnp,
                   int cols_max, int trans_smem, int bchunk, int jw, int gw) {
  const int n0 = bounds[blockIdx.x];
  const int n1 = bounds[blockIdx.x + 1];
  const int cols = n1 - n0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // cross-word step: column groups of jw lanes, the other 32 / jw lanes of
  // a warp split i in quads
  // (jw, gw: powers of 2; the frame loop divides by none but cols)
  const int ljw = 31 - __clz(jw);
  const int iw = 32 >> ljw;
  const int jlane = lane & (jw - 1);
  const int ilane = lane >> ljw;
  const int ngroups = (cols_max + jw - 1) >> ljw;
  const int npart = max(bchunk * ngroups, kWarps) * jw;
  // band and combine: groups of gw lanes, one (utterance, node) pair each
  const int lgw = 31 - __clz(gw);
  const int gpw = 32 >> lgw;
  const int glane = lane & (gw - 1);
  const size_t plane = static_cast<size_t>(B) * Ns;
  // WE staging: element q = bb * Nn + i of a chunk; this thread's first
  // (bb, i) and the step of kThreads elements
  const int stage_b = tid / Nn, stage_i = tid - stage_b * Nn;
  const int step_b = kThreads / Nn, step_i = kThreads - step_b * Nn;

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* trans_s = sm;                         // (cols_max, nnp), by column
  float* we_s = trans_s + (trans_smem ? cols_max * nnp : 0);  // (bchunk, nnp)
  float* entry_s = we_s + bchunk * nnp;        // (bchunk, cols_max)
  int* an_s = reinterpret_cast<int*>(entry_s + bchunk * cols_max);
  float* part_v = reinterpret_cast<float*>(an_s + bchunk * cols_max);
  int* part_i = reinterpret_cast<int*>(part_v + npart);
  // the block's nodes: state offsets (cols + 1), word penalties, starts
  int* off_s = part_i + npart;
  float* wdpen_s = reinterpret_cast<float*>(off_s + cols_max + 1);
  float* start_s = wdpen_s + cols_max;
  for (int q = tid; q <= cols; q += kThreads) {
    off_s[q] = node_off[n0 + q];
    if (q < cols) {
      wdpen_s[q] = wdpen[n0 + q];
      start_s[q] = start[n0 + q];
    }
  }

  // the rows are padded to nnp (a multiple of 4 whose quarter is odd, so
  // that 16-byte reads of 8 columns hit distinct banks): WE pads are -inf
  // and trans pads 0, so a pad candidate never wins
  if (trans_smem) {
    for (int q = tid; q < cols * nnp; q += kThreads) {
      const int jl = q / nnp;
      const int i = q - jl * nnp;
      trans_s[q] = i < Nn ? trans[static_cast<size_t>(i) * Nn + n0 + jl] : 0.f;
    }
  }
  for (int q = tid; q < bchunk * (nnp - Nn); q += kThreads) {
    const int bb = q / (nnp - Nn);
    we_s[bb * nnp + Nn + (q - bb * (nnp - Nn))] = -INFINITY;
  }

  // one pass over the (utterance, node) pairs of utterances [b0, b0 + nb):
  // at init, plane 0 := LZERO / -1 and the word ends of frame 0; in frame t,
  // band and combine into plane nxt and the word ends of frame t + 1
  auto states_pass = [&](int t, int b0, int nb, size_t cur, size_t nxt,
                         bool init) {
    const int npairs = nb * cols;
    for (int pw = warp * gpw; pw < npairs; pw += kWarps * gpw) {
      const int p = pw + (lane >> lgw);
      WordEnd w = {kLZero, 0x7fffffff, -1, -1};
      int bb = 0, n = 0;
      if (p < npairs) {
        bb = p / cols;
        const int jl = p - bb * cols;
        n = n0 + jl;
        const int b = b0 + bb;
        const size_t row = static_cast<size_t>(b) * Ns;
        const float en = init ? 0.f : entry_s[bb * cols_max + jl];
        const int an = init ? -1 : an_s[bb * cols_max + jl];
        const int s_end = off_s[jl + 1];
        for (int s = off_s[jl] + glane; s < s_end; s += gw) {
          float nv = kLZero;
          int rwn = -1, rwt = -1;
          if (!init) {
            const float* v = vbuf + cur + row;
            float within = __ldcg(v + s) + band[s];
            int wwn = __ldcg(wnbuf + cur + row + s);
            int wwt = __ldcg(wtbuf + cur + row + s);
            for (int k = 1; k < K; ++k) {
              const bool in = s >= k;
              const float c = (in ? __ldcg(v + s - k) : kLZero)
                              + band[static_cast<size_t>(k) * Ns + s];
              const int cwn = in ? __ldcg(wnbuf + cur + row + s - k) : -1;
              const int cwt = in ? __ldcg(wtbuf + cur + row + s - k) : -1;
              if (c > within) {
                within = c;
                wwn = cwn;
                wwt = cwt;
              }
            }
            const float es = (en + a0[s]) + bonus[s];
            const bool use_entry = es > within;
            nv = (use_entry ? es : within)
                 + outp[(static_cast<size_t>(b) * T + t) * Ns + s];
            rwn = use_entry ? an : wwn;
            rwt = use_entry ? t - 1 : wwt;
            if (nv <= kLSmall) {
              rwn = -1;
              rwt = -1;
            }
          }
          vbuf[nxt + row + s] = nv;
          wnbuf[nxt + row + s] = rwn;
          wtbuf[nxt + row + s] = rwt;
          const float e = nv + aE[s];
          if (e > w.e) {
            w.e = e;
            w.sid = s;
            w.wn = rwn;
            w.wt = rwt;
          }
        }
      }
      for (int off = gw >> 1; off > 0; off >>= 1) {
        keep_first_max(w, __shfl_xor_sync(kFull, w.e, off),
                       __shfl_xor_sync(kFull, w.sid, off),
                       __shfl_xor_sync(kFull, w.wn, off),
                       __shfl_xor_sync(kFull, w.wt, off));
      }
      const int tn = init ? 0 : t + 1;
      if (p < npairs && glane == 0 && tn < T) {
        const bool ok = w.e > kLSmall;
        const size_t rec = (static_cast<size_t>(b0 + bb) * T + tn) * Nn + n;
        we_out[rec] = w.e;
        pwn_out[rec] = ok ? w.wn : -1;
        pwt_out[rec] = ok ? w.wt : -1;
      }
    }
  };

  __syncthreads();
  states_pass(0, 0, B, 0, 0, true);

  for (int t = 0; t < T; ++t) {
    const size_t cur = (t & 1) ? plane : 0;
    const size_t nxt = (t & 1) ? 0 : plane;

    // every block's word ends of frame t and states of frame t - 1 are
    // written
    grid_barrier(barrier, static_cast<unsigned>(t + 1) * gridDim.x);

    for (int b0 = 0; b0 < B; b0 += bchunk) {
      const int nb = min(bchunk, B - b0);
      // cross-word step for the block's columns
      if (t == 0) {
        for (int q = tid; q < nb * cols; q += kThreads) {
          const int bb = q / cols;
          const int jl = q - bb * cols;
          entry_s[bb * cols_max + jl] = start_s[jl];
          an_s[bb * cols_max + jl] = -1;
        }
      } else if (cols > 0) {
        // kStage loads in flight a thread before their stores
        const float* rows = we_out + (static_cast<size_t>(b0) * T + t) * Nn;
        const size_t row_step = static_cast<size_t>(T) * Nn;
        int bb = stage_b, i = stage_i;
        while (bb < nb) {
          float r[kStage];
          int at[kStage];
#pragma unroll
          for (int u = 0; u < kStage; ++u) {
            at[u] = bb < nb ? bb * nnp + i : -1;
            r[u] = bb < nb ? __ldcg(rows + bb * row_step + i) : 0.f;
            bb += step_b;
            i += step_i;
            if (i >= Nn) {
              i -= Nn;
              ++bb;
            }
          }
#pragma unroll
          for (int u = 0; u < kStage; ++u) {
            if (at[u] >= 0) we_s[at[u]] = r[u];
          }
        }
        __syncthreads();
        // partials: task (bb, column group) split into `slices` warps, a
        // power of 2
        const int tasks = nb * ngroups;
        const int lsl = 31 - __clz(max(1, kWarps / tasks));
        const int slices = 1 << lsl;
        for (int slot = warp; slot < tasks * slices; slot += kWarps) {
          const int task = slot >> lsl;
          const int sl = slot & (slices - 1);
          const int bb = ngroups == 1 ? task : task / ngroups;
          const int jl = (task - bb * ngroups) * jw + jlane;
          float best = -INFINITY;
          int arg = 0x7fffffff;
          if (jl < cols) {
            const float* w = we_s + bb * nnp;
            if (trans_smem) {
              // quads i..i+3 of WE and of column jl, 16 bytes each
              const float* col = trans_s + jl * nnp;
              for (int i = 4 * (sl * iw + ilane); i < nnp;
                   i += 4 * slices * iw) {
                const float4 wq = *reinterpret_cast<const float4*>(w + i);
                const float4 cq = *reinterpret_cast<const float4*>(col + i);
                const float c0 = wq.x + cq.x, c1 = wq.y + cq.y;
                const float c2 = wq.z + cq.z, c3 = wq.w + cq.w;
                if (c0 > best) { best = c0; arg = i; }
                if (c1 > best) { best = c1; arg = i + 1; }
                if (c2 > best) { best = c2; arg = i + 2; }
                if (c3 > best) { best = c3; arg = i + 3; }
              }
            } else {
              const float* col = trans + n0 + jl;
#pragma unroll 4
              for (int i = sl * iw + ilane; i < Nn; i += slices * iw) {
                const float c =
                    w[i] + __ldg(col + static_cast<size_t>(i) * Nn);
                if (c > best) {
                  best = c;
                  arg = i;
                }
              }
            }
          }
          for (int off = jw; off < 32; off <<= 1) {
            merge(best, arg, __shfl_xor_sync(kFull, best, off),
                  __shfl_xor_sync(kFull, arg, off));
          }
          if (ilane == 0) {
            part_v[slot * jw + jlane] = best;
            part_i[slot * jw + jlane] = arg;
          }
        }
        __syncthreads();
        for (int q = tid; q < nb * cols; q += kThreads) {
          const int bb = q / cols;
          const int jl = q - bb * cols;
          const int g = jl >> ljw;
          const int at = ((bb * ngroups + g) * slices) * jw + (jl & (jw - 1));
          float best = part_v[at];
          int arg = part_i[at];
          for (int sl = 1; sl < slices; ++sl) {
            merge(best, arg, part_v[at + sl * jw], part_i[at + sl * jw]);
          }
          entry_s[bb * cols_max + jl] = best + wdpen_s[jl];
          an_s[bb * cols_max + jl] = arg;
        }
      }
      __syncthreads();
      // band, combine, and the word ends of frame t + 1
      states_pass(t, b0, nb, cur, nxt, false);
      __syncthreads();
    }
  }
}

}  // namespace

// The full grid on `device`, which must be the current device: SMs times
// the blocks an SM holds at the kernel's full shared-memory budget (one on
// Hopper). Negative: -cudaError.
extern "C" int decode_scan_grid(int device) {
  int sms = 0, occ = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, decode_scan_kernel, kThreads, kSmemMax);
  return err == cudaSuccess ? sms * occ : -static_cast<int>(err);
}

// Launches the cooperative grid of `grid` blocks on `stream`; returns the
// cudaError_t of the launch (a grid larger than the card holds at once is
// refused). The finals after T frames sit in plane (T & 1) of the buffers.
extern "C" int decode_scan_launch(
    const void* outp, const void* band, const void* a0, const void* aE,
    const void* bonus, const void* node_off, const void* bounds,
    const void* trans, const void* start, const void* wdpen, void* we_out,
    void* pwn_out, void* pwt_out, void* vbuf, void* wnbuf, void* wtbuf,
    void* barrier, int B, int T, int Ns, int Nn, int K, int nnp, int cols_max,
    int trans_smem, int bchunk, int jw, int gw, int grid, int smem,
    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&outp, &band, &a0, &aE, &bonus, &node_off, &bounds,
                  &trans, &start, &wdpen, &we_out, &pwn_out, &pwt_out,
                  &vbuf, &wnbuf, &wtbuf, &barrier, &B, &T, &Ns, &Nn, &K,
                  &nnp, &cols_max, &trans_smem, &bchunk, &jw, &gw};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(decode_scan_kernel), dim3(grid),
      dim3(kThreads), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
