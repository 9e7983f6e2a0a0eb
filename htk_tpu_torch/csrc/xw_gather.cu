// Segmented max-plus with first-slot argmax, and a gather-add, over a
// static slot stream, for Hopper (sm_90a): the explicit-bigram leg of the
// factored cross-word step of the uniform-row LV decoder.
//
// Replaces four TPU kernels, all of which gather word-end scores WE[b, i]
// through a static table of source rows:
//
//   htk_tpu/ops/xw_route.py : routed_explicit_leg   (segmax)
//   benchmarks/gather_probe.py : pallas_leg_build   (segmax, B = 1)
//   htk_tpu/ops/xw_pallas.py : _window_gather_jit   (gather_add)
//   benchmarks/dyngather_probe.py : build           (gather_add, no add)
//
// segmax, for every segment r of [seg_off[r], seg_off[r+1]) and batch row b:
//
//   val[b, out_row[r]] = max_k WE[b, preds[k]] + scores[k]
//   arg[b, out_row[r]] = preds[k*], k* the first slot reaching the max
//
// The running max is seeded with the segment's first slot and updated only
// on a strict `>`, so it is exactly jnp.max / jnp.argmax over a padded
// bucket row (pads included) and torch.max(dim). Each candidate is one fp32
// add of WE and the already-scaled score, as in the plain torch version
// (ops/xw_gather.py), so values agree bit for bit. An empty segment writes
// (2 * LZERO, -1). `skip` is an optional device flag (a 0-dim bool, or
// null): where it is set every block returns before it reads a slot and
// val / arg are left unspecified, so a caller can gate the launch on a
// value computed on the device (the adaptive-exact leg's certificate)
// without waiting for it on the host.
//
// gather_add: out[b, n] = WE[b, pred[n]] + lp[n], or WE[b, pred[n]] alone
// when lp is null (the probe's plain lane gather).
//
// Design. segmax: lanes over a segment's slots. A group of G lanes (G a
// power of two, 1-32) takes one segment, cut at 16-byte boundaries into
// quads of 4 slots: lane j walks quads j, j + G, ... from the one holding
// the segment's first slot, reading each quad's preds and scores with one
// 16-byte load apiece (slots outside the segment masked), so a group reads
// consecutive addresses in few instructions. Each lane holds, for each
// batch row it serves, a (value, slot) pair; the group merges the pairs
// with xor shuffles, where (v, k) beats (v', k') if v > v' or v == v' and
// k < k' -- the serial walk's result, whatever order the lanes saw the
// slots in. A lane with no slot holds (-inf, INT_MAX) and so loses to any
// slot, -inf candidates and all-pad segments included; a group whose every
// lane is empty writes (2 * LZERO, -1). The slot's pred rides along, so no
// load follows the merge. G follows the width (ops/xw_gather.lane_class):
// the fewest lanes, at least 2, that leave each lane at most 3 quads,
// capped at 32, so the 20k-word net's 8-40 slot segments (quad-aligned in
// the bucket leg) take 2 or 4 lanes and a 700-slot one a warp. (Of the
// rules tried on the card, 1-4 quads a lane and at least 1, 2 or 4 lanes,
// this one was the fastest on the 20k net's bucket leg and routed CSR and
// on bucket_max's uniform 16-slot segments.) The host schedule (ops/xw_gather.schedule, built once per seg_off
// tensor) sorts the segments into the six classes of G, cuts each class
// into warp tasks of 32 / G segments and lists each position's slot range;
// a warp finds its class from the tasks' prefix counts. A warp's tasks form
// a chain of dependent loads (position, slots, gathers), so each is issued
// a task ahead: the next task's positions while this one gathers, its
// first slots while this one merges and writes, the first task's before
// the copy of WE below.
//
// WE in shared memory. The grid is (segment chunks) x (row groups): a
// block copies its group's rows of WE into dynamic shared memory with
// 16-byte loads, kStage in flight a thread, the rows interleaved (source
// row p's values for the group's rows side by side), and then every
// gather reads them with one 4-, 8- or 16-byte load (two at 8 rows). A
// group holds a power of two of rows, as many as fit in 227 KB, at most
// kRowsMax (2 rows at C = 20,000: 160 KB; bucket_max's one row at
// C = 22,000: 88 KB). Where one row does not fit (C over 58,112)
// the same code gathers through the read-only cache, kRowsMax rows a
// group. The grid is persistent: one block an SM when staged (each block
// pays for its copy), two unstaged, shared among the row groups, and each
// block loops over its share of the warp tasks. A launch gated by `skip`
// costs one short block an SM.
//
// gather_add: each thread takes 4 consecutive slots, reads their pred (and
// lp) once with one 16-byte load each and loops over all B rows, gathering
// 4 values of WE and writing them with one 16-byte store; grid =
// ceil(N / (4 kGatherThreads)). Where WE is at most 48 KB (the probe's
// table row: 8 KB) every block first copies it into shared memory, so that
// the gathers, which depend on the pred loads, read shared memory instead
// of making a second trip to L2. Where a pointer is not 16-byte aligned (a
// view at an odd element offset, or an output row when N % 4 != 0) and at
// the tail, it falls to scalar loads and stores.
//
// What bounds them: bytes. segmax must read the slot stream (8 B a slot),
// WE and the segment tables and write val and arg; its operations (an add
// and a compare per (b, slot)) take a tenth of that time at the card's FP32
// rate. Its real traffic is larger than that bound: each row group reads
// the slot stream again (4 times at B = 8, C = 20,000), and each block
// copies its rows from L2 (132 blocks x 160 KB = 21 MB), against ~110 MB of
// 32-byte L2 sectors when every gather of a batch row was its own sector.
// gather_add moves the slot tables once and the B output rows once: at
// B = 1 (the probe's lane gather) half of its bytes are the pred it reads.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kLZero = -1.0e10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSegThreads = 1024;    // threads per segmax block
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kClasses = 6;          // lane groups of 1, 2, 4, 8, 16, 32
constexpr int kRowsMax = 8;          // batch rows a segmax block serves
constexpr int kSmemMax = 232448;     // 227 KB, a Hopper block's most
constexpr int kGatherThreads = 256;  // threads per block, 4 slots each
constexpr int kStageMax = 12288;     // WE staged in shared memory up to 48 KB
constexpr int kStage = 8;            // staging loads a thread keeps in flight

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// (v, k) beats (bv, bk): a larger value, or an equal one at an earlier slot
__device__ __forceinline__ bool beats(float v, int k, float bv, int bk) {
  return v > bv || (v == bv && k < bk);
}

// WE's rows [0, nr) of C floats from src (row-major) into shared dst with
// the rows interleaved, dst[p kRows + q] = src[q C + p], so that one
// kRows-wide load gathers a source row for every batch row. Every thread
// of the block takes part: where src is aligned and C a multiple of 4, a
// thread reads 4 columns of every row with 16-byte loads (kStage in
// flight) and writes them as kRows consecutive 16-byte stores.
template <int kRows>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           float* dst, int nr, int C) {
  if (aligned16(src) && C % 4 == 0) {
    constexpr int kAt = kStage / kRows;  // column quads in flight a thread
    const int c4 = C >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i0 = threadIdx.x; i0 < c4; i0 += kSegThreads * kAt) {
      float4 r[kAt][kRows];
#pragma unroll
      for (int a = 0; a < kAt; ++a) {
        const int i = i0 + a * kSegThreads;
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          r[a][q] = i < c4 && q < nr
              ? __ldg(s4 + static_cast<size_t>(q) * c4 + i)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int a = 0; a < kAt; ++a) {
        const int i = i0 + a * kSegThreads;
        if (i < c4) {
          float o[4 * kRows];  // columns 4 i .. 4 i + 3, rows interleaved
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            o[q] = r[a][q].x;
            o[kRows + q] = r[a][q].y;
            o[2 * kRows + q] = r[a][q].z;
            o[3 * kRows + q] = r[a][q].w;
          }
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            d4[i * kRows + m] = make_float4(o[4 * m], o[4 * m + 1],
                                            o[4 * m + 2], o[4 * m + 3]);
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < nr * C; i += kSegThreads) {
    const int q = i / C;
    dst[(i - q * C) * kRows + q] = __ldg(src + i);
  }
}

// the kRows values of source row p in the interleaved shared copy
template <int kRows>
__device__ __forceinline__ void we_rows(const float* tab, int p,
                                        float (&v)[kRows]) {
  if constexpr (kRows == 1) {
    v[0] = tab[p];
  } else if constexpr (kRows == 2) {
    const float2 x = reinterpret_cast<const float2*>(tab)[p];
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int h = 0; h < kRows / 4; ++h) {
      const float4 x = reinterpret_cast<const float4*>(tab)[p * (kRows / 4)
                                                            + h];
      v[4 * h] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  }
}

// A lane's share of a warp task: its segment s (-1 for none) with slots
// [k0, k1), the quads (4 slots at a 16-byte boundary) q, q + 2^c, ... it
// walks while 4 q < k1, and the task's class c.
struct Span {
  int s, q, k0, k1, c;
};

// sched: (kClasses + 1) warp-task prefix counts, (kClasses + 1) segment
// prefix counts, each position's (k0, k1), and the segment at each
// position (ops/xw_gather.schedule); t >= n_tasks gives no segment
__device__ __forceinline__ Span fetch(const int* __restrict__ sched, int R,
                                     int n_tasks, int t, int lane) {
  Span a{-1, 0, 0, 0, 0};
  if (t < n_tasks) {
#pragma unroll
    for (int i = 1; i < kClasses; ++i) a.c += t >= __ldg(sched + i);
    const int* seg_pre = sched + kClasses + 1;
    const int pos = __ldg(seg_pre + a.c)
                    + ((t - __ldg(sched + a.c)) << (5 - a.c)) + (lane >> a.c);
    if (pos < __ldg(seg_pre + a.c + 1)) {
      const int2 sp = __ldg(reinterpret_cast<const int2*>(
          sched + 2 * (kClasses + 1)) + pos);
      a.s = __ldg(sched + 2 * (kClasses + 1) + 2 * R + pos);
      a.q = (sp.x >> 2) + (lane & ((1 << a.c) - 1));
      a.k0 = sp.x;
      a.k1 = sp.y;
    }
  }
  return a;
}

// slots 4 q .. 4 q + 3 of the stream: one 16-byte load of each where the
// pointers allow (`vec`) and the quad lies inside the N slots
struct Quad {
  int4 p;
  float4 sc;
};

__device__ __forceinline__ void load_quad(Quad& b,
                                          const int* __restrict__ preds,
                                          const float* __restrict__ scores,
                                          int q, int k1, int N, bool vec) {
  if (4 * q >= k1) return;  // no slot of the lane's segment
  if (vec && 4 * q + 4 <= N) {
    b.p = __ldg(reinterpret_cast<const int4*>(preds) + q);
    b.sc = __ldg(reinterpret_cast<const float4*>(scores) + q);
  } else {
    int p[4] = {0, 0, 0, 0};
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (4 * q + u < N) {
        p[u] = __ldg(preds + 4 * q + u);
        sc[u] = __ldg(scores + 4 * q + u);
      }
    }
    b.p = make_int4(p[0], p[1], p[2], p[3]);
    b.sc = make_float4(sc[0], sc[1], sc[2], sc[3]);
  }
}

// Block (x, y) serves batch rows [y rows, y rows + rows) and warp tasks
// t = x kSegWarps + warp + i gridDim.x kSegWarps. The loads a task needs
// are in flight a task ahead: the next task's positions while this one
// gathers, its first quad while this one merges and writes, and the first
// task's before the copy of WE.
template <int kRows, bool kStaged>
__global__ void __launch_bounds__(kSegThreads)
segmax_kernel(const float* __restrict__ we,       // (B, C)
              const int* __restrict__ preds,      // (N,)
              const float* __restrict__ scores,   // (N,)
              const int* __restrict__ out_row,    // (R,)
              const int* __restrict__ sched,      // (2 kClasses + 2 + 3 R,)
              const unsigned char* __restrict__ skip,  // () or null
              float* __restrict__ val,            // (B, C_out)
              int* __restrict__ arg,              // (B, C_out)
              int B, int C, int N, int R, int C_out, int rows, int vec) {
  if (skip && *skip) return;
  extern __shared__ float4 stage[];  // the row group's rows of WE
  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, B - r0);
  const float* w = we + static_cast<size_t>(r0) * C;
  const int lane = threadIdx.x & 31;
  const int n_tasks = __ldg(sched + kClasses);
  const int stride = gridDim.x * kSegWarps;
  int t = blockIdx.x * kSegWarps + (threadIdx.x >> 5);
  Span cur = fetch(sched, R, n_tasks, t, lane);
  Quad buf;
  load_quad(buf, preds, scores, cur.q, cur.k1, N, vec);
  if (kStaged) {
    stage_rows<kRows>(w, reinterpret_cast<float*>(stage), nr, C);
    __syncthreads();
  }
  const float* tab = reinterpret_cast<const float*>(stage);
  for (; t < n_tasks; t += stride) {  // t and cur.c are warp-uniform
    const Span nxt = fetch(sched, R, n_tasks, t + stride, lane);
    const int col = cur.s >= 0 ? __ldg(out_row + cur.s) : 0;
    float best[kRows];
    int bk[kRows], bp[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      best[q] = -CUDART_INF_F;
      bk[q] = INT_MAX;
      bp[q] = -1;
    }
    for (int qd = cur.q; 4 * qd < cur.k1;) {
      const int p4[4] = {buf.p.x, buf.p.y, buf.p.z, buf.p.w};
      const float s4[4] = {buf.sc.x, buf.sc.y, buf.sc.z, buf.sc.w};
      const int k = 4 * qd;
      qd += 1 << cur.c;
      load_quad(buf, preds, scores, qd, cur.k1, N, vec);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k + u >= cur.k0 && k + u < cur.k1) {
          float we_p[kRows];
          if constexpr (kStaged) {
            we_rows<kRows>(tab, p4[u], we_p);
          } else {
#pragma unroll
            for (int q = 0; q < kRows; ++q)
              we_p[q] = q < nr ? __ldg(w + static_cast<size_t>(q) * C
                                       + p4[u]) : 0.f;
          }
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            if (q < nr) {
              const float v = we_p[q] + s4[u];
              if (beats(v, k + u, best[q], bk[q])) {
                best[q] = v;
                bk[q] = k + u;
                bp[q] = p4[u];
              }
            }
          }
        }
      }
    }
    load_quad(buf, preds, scores, nxt.q, nxt.k1, N, vec);
    const int G = 1 << cur.c;
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (q < nr) {  // nr is block-uniform
          const float ov = __shfl_xor_sync(kFull, best[q], off);
          const int ok = __shfl_xor_sync(kFull, bk[q], off);
          const int op = __shfl_xor_sync(kFull, bp[q], off);
          if (beats(ov, ok, best[q], bk[q])) {
            best[q] = ov;
            bk[q] = ok;
            bp[q] = op;
          }
        }
      }
    }
    if (cur.s >= 0) {  // every lane of the group holds the result
      const int j = lane & (G - 1);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {  // lane j writes rows j mod G
        if (q < nr && (q & (G - 1)) == j) {
          const size_t o = static_cast<size_t>(r0 + q) * C_out + col;
          const bool none = bk[q] == INT_MAX;
          val[o] = none ? 2.f * kLZero : best[q];
          arg[o] = none ? -1 : bp[q];
        }
      }
    }
    cur = nxt;
  }
}

template <int kRows, bool kStaged>
cudaError_t segmax_run(const void* we, const void* preds, const void* scores,
                       const void* out_row, const void* sched,
                       const void* skip, void* val, void* arg, int B, int C,
                       int N, int R, int C_out, int rows, int chunks,
                       cudaStream_t stream) {
  const int smem = kStaged ? kRows * C * static_cast<int>(sizeof(float)) : 0;
  if (kStaged) {
    static bool raised[64] = {};  // per card: raise the attribute once
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !raised[dev]) {
      err = cudaFuncSetAttribute(segmax_kernel<kRows, kStaged>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax);
      if (err != cudaSuccess) return err;
      if (dev < 64) raised[dev] = true;
    }
  }
  const dim3 grid(chunks, (B + rows - 1) / rows);
  segmax_kernel<kRows, kStaged><<<grid, kSegThreads, smem, stream>>>(
      static_cast<const float*>(we), static_cast<const int*>(preds),
      static_cast<const float*>(scores), static_cast<const int*>(out_row),
      static_cast<const int*>(sched), static_cast<const unsigned char*>(skip),
      static_cast<float*>(val), static_cast<int*>(arg), B, C, N, R, C_out,
      rows, aligned16(preds) && aligned16(scores));
  return cudaGetLastError();
}

// out[b, n + k] = WE[b, p[k]] (+ l[k]) for k < m and every row b; WE from
// shared memory (kShared) or through the read-only cache
template <bool kShared>
__device__ __forceinline__ void gather_rows(const float* we, const int* p,
                                            const float* l, bool add,
                                            float* out, int B, int C, int N,
                                            int n, int m) {
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const float* w = we + static_cast<size_t>(b) * C;
    float g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      g[k] = k < m ? (kShared ? w[p[k]] : __ldg(w + p[k])) : 0.f;
      if (add) g[k] += l[k];  // without lp the values are WE's exactly
    }
    float* dst = out + static_cast<size_t>(b) * N + n;
    if (m == 4 && aligned16(dst)) {
      *reinterpret_cast<float4*>(dst) = make_float4(g[0], g[1], g[2], g[3]);
    } else {
      for (int k = 0; k < m; ++k) dst[k] = g[k];
    }
  }
}

__global__ void __launch_bounds__(kGatherThreads)
gather_add_kernel(const float* __restrict__ we,    // (B, C)
                  const int* __restrict__ pred,    // (N,)
                  const float* __restrict__ lp,    // (N,) or null
                  float* __restrict__ out,         // (B, N)
                  int B, int C, int N, int staged) {
  extern __shared__ float table[];  // WE, when `staged`
  const int n = (blockIdx.x * kGatherThreads + threadIdx.x) * 4;
  const int m = max(0, min(4, N - n));
  int p[4] = {0, 0, 0, 0};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  if (m == 4 && aligned16(pred + n)) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(pred + n));
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  } else {
    for (int k = 0; k < m; ++k) p[k] = __ldg(pred + n + k);
  }
  if (lp) {
    if (m == 4 && aligned16(lp + n)) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(lp + n));
      l[0] = v.x; l[1] = v.y; l[2] = v.z; l[3] = v.w;
    } else {
      for (int k = 0; k < m; ++k) l[k] = __ldg(lp + n + k);
    }
  }
  if (staged) {  // the whole of WE, kStage loads in flight a thread
    const int total = B * C;
    for (int q0 = threadIdx.x; q0 < total; q0 += kGatherThreads * kStage) {
      float r[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int q = q0 + u * kGatherThreads;
        r[u] = q < total ? __ldg(we + q) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int q = q0 + u * kGatherThreads;
        if (q < total) table[q] = r[u];
      }
    }
    __syncthreads();
  }
  if (m == 0) return;
  if (staged) {
    gather_rows<true>(table, p, l, lp != nullptr, out, B, C, N, n, m);
  } else {
    gather_rows<false>(we, p, l, lp != nullptr, out, B, C, N, n, m);
  }
}

}  // namespace

// Launch on `stream`; each returns the cudaError_t of its launch.
// segmax: sched is ops/xw_gather.schedule's table on the card; a block
// serves `rows` batch rows (1 to kRowsMax), a row group has `chunks`
// blocks, and its rows of WE are copied into shared memory when `staged`
// (rows * C * 4 bytes, at most 227 KB).
extern "C" int segmax_launch(const void* we, const void* preds,
                             const void* scores, const void* out_row,
                             const void* sched, const void* skip, void* val,
                             void* arg, int B, int C, int N, int R,
                             int C_out, int rows, int staged, int chunks,
                             void* stream) {
  using Run = cudaError_t (*)(const void*, const void*, const void*,
                              const void*, const void*, const void*, void*,
                              void*, int, int, int, int, int, int, int,
                              cudaStream_t);
  static const Run runs[4][2] = {
      {segmax_run<1, false>, segmax_run<1, true>},
      {segmax_run<2, false>, segmax_run<2, true>},
      {segmax_run<4, false>, segmax_run<4, true>},
      {segmax_run<8, false>, segmax_run<8, true>}};
  const int r = rows <= 1 ? 0 : rows <= 2 ? 1 : rows <= 4 ? 2 : 3;
  if (rows < 1 || rows > kRowsMax || chunks < 1 ||
      (staged && ((rows & (rows - 1)) ||
                  static_cast<long long>(rows) * C * 4 > kSmemMax)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(runs[r][staged ? 1 : 0](
      we, preds, scores, out_row, sched, skip, val, arg, B, C, N, R, C_out,
      rows, chunks, static_cast<cudaStream_t>(stream)));
}

extern "C" int gather_add_launch(const void* we, const void* pred,
                                 const void* lp, void* out, int B, int C,
                                 int N, void* stream) {
  const int per_block = 4 * kGatherThreads;
  const int staged = static_cast<long long>(B) * C <= kStageMax;
  gather_add_kernel<<<(N + per_block - 1) / per_block, kGatherThreads,
                      staged ? B * C * sizeof(float) : 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(we), static_cast<const int*>(pred),
      static_cast<const float*>(lp), static_cast<float*>(out), B, C, N,
      staged);
  return static_cast<int>(cudaGetLastError());
}
