// One frame of the uniform-row LV decoder's step, for Hopper (sm_90a): the
// entry into each word row, the banded within-word update and the word
// ends of the new carry, in one launch.
//
// Replaces no Pallas kernel: the reference's step is XLA code
// (htk_tpu/algo/decode.py : _make_uniform_step), and the port's plain
// version is algo/decode._make_uniform_step, about 40 torch ops a frame,
// some 20 of them passes over the whole (B, Ns) state array. Here, for
// every batch row b and word row c (S states, flat state i = c S + s):
//
//   entry   m, an   = bo_best[b] + uni[c], bo_arg[b], then the explicit
//                     leg's (xv, xa)[b, c] where strictly better (the
//                     factored exact leg: `bo` packed, `uni`, `xv`/`xa`
//                     optional), or (xv, xa)[b, c] as they are (every
//                     other leg's (m, an) planes); at t == 0 `start[c]`
//                     with record 0
//           en      = m + word_pen, erec = ((an + 1) << 15) | t
//   update  within  = max_k v[b, i - k] + band[k, i], the first k on ties
//                     (v[b, j] for j < 0 is LZERO, its record 0)
//           e       = (en + bonus[c]) + a0[i]
//           v'      = max(within, e) + outp[b, i]   (e only if greater)
//           rec'    = e > within ? erec : rec[b, i - k*]
//           rec'    = 0 where v' <= LSMALL
//   ends    WE[b, c] = max_s v'[b, i] + aE[i], the first s on ties;
//           (pwn, pwt) = the record at that state, unpacked, where
//           WE > LSMALL, else (-1, -1): plane t + 1 of the (B, T, C)
//           planes and a contiguous (B, C) copy for the next frame's
//           cross-word leg; and, for the factored leg, the next frame's
//           back-off best max_c WE[b, c] + bow[c] (the first c on ties)
//           as one packed 64-bit key a batch row, by atomicMax.
//
// Every float is the plain version's: the same fp32 adds in the same
// order, the same comparisons and the same tie rules, nothing
// reassociated and no multiply (so nothing to contract into an FMA).
// With a beam the prune needs each batch row's largest v' first: phase
// kUpdate writes v' and rec' and reduces that maximum (a packed 32-bit
// atomicMax), and phase kEnds prunes (v' < top - beam gives LZERO), zeroes
// the records and forms the word ends. Without one, phase kFused does
// everything in one launch. Records are 32 bits: (an + 1) << 15 | t is
// below 2^32 for the decoder's REC_MAXROWS rows and 15-bit frames.
//
// Bound: bytes. A frame reads v, rec and outp once and writes v and rec
// once, (B, Ns) each, 20 bytes a state; the planes, the tables and the
// entry planes are (B, C) or (Ns,) and small beside them (13 x 320,000
// states: 83.2 MB, 24.8 us at 3.35 TB/s).
//
// Design. The work a state is small and the same everywhere, so what
// costs is each state's share of the warp-wide steps (shuffles, the
// word end's reduction, the stores) and keeping enough loads in flight.
// Where S is even and at most 64 (compile_lv_loop pads S to a multiple
// of 4), a lane holds two adjacent states with 8-byte loads and stores,
// a group of G lanes (the smallest power of two at least S / 2) a row,
// a warp 32 / G consecutive rows: every warp-wide step then serves two
// states. A shift's source comes by one shuffle from the lane before
// (across the warp where the rows fill their groups, else inside the
// group); the range's first lane loads the K - 1 states before it (the
// previous row's tail). The word end is a redux max of the order-keyed
// score over the group, a ballot for its first lane (lanes hold states
// in order), and two shuffles for its score and record; the back-off key
// rides a xor-shuffle tree over the warp's row leaders into shared
// memory, and leaves the block in one atomicMax a batch row. A block
// takes kWarps warps of rows for a chunk of `bsz` batch rows (the grid's
// y), keeps the rows' per-state tables in registers across them, and
// issues a batch row's loads before it computes the previous one. Any
// other S takes a state a lane, a warp a row walked in chunks of 32. A
// packed key orders as its float (sign-flipped bits, -0 taken as +0) and
// then by the complement of the row, so the largest key is the largest
// value at its first row. K (the band's shifts, 1-3) is a template
// parameter.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

// The launch's operands; mirrored field for field by ops/lv_step._Args.
struct LvStepArgs {
  const float* v;        // (B, Ns) carry in
  const unsigned* rec;   // (B, Ns) carry in, packed records
  float* v_out;          // (B, Ns) carry out
  unsigned* rec_out;     // (B, Ns)
  const float* outp;     // frame t's scores, rows of Ns at outp_bstride
  const float* band;     // (K, Ns)
  const float* a0;       // (Ns,)
  const float* aE;       // (Ns,)
  const float* bonus;    // (C,)
  const float* start;    // (C,) at t == 0, else null
  const unsigned long long* bo;  // (B,) back-off best of frame t, or null
  const float* uni;      // (C,) with bo
  const float* xv;       // (B, C) explicit leg's values (with bo), or m
  const int* xa;         // (B, C) their source rows, or an
  float* we;             // plane t + 1 of WE, rows at plane_bstride, or null
  int* pwn;              // plane t + 1 of pwn
  int* pwt;              // plane t + 1 of pwt
  float* we_buf;         // (B, C) WE of the new carry, or null
  const float* bow;      // (C,) with bo_next
  unsigned long long* bo_next;  // (B,) back-off best of frame t + 1, or null
  unsigned* top;         // (B,) largest new score, packed (phase kUpdate/kEnds)
  long long outp_bstride;
  long long plane_bstride;
  float word_pen;
  float beam;
  int B, C, S, K, t, phase, bsz;
};

namespace {

constexpr float kLZero = -1.0e10f;   // utils/logmath.LZERO
constexpr float kLSmall = -0.5e10f;  // utils/logmath.LSMALL
constexpr int kTBits = 15;           // algo/decode.REC_TBITS
constexpr unsigned kTMask = (1u << kTBits) - 1;
constexpr int kKMax = 3;    // band width (ops/lv_step.K_MAX)
constexpr int kBMax = 32;   // batch rows a block (ops/lv_step.BSZ_MAX)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block (ops/lv_step.WARPS)
constexpr int kThreads = 32 * kWarps;
// blocks an SM: caps a thread at 48 registers, so 40 warps an SM keep
// their loads in flight (uncapped: up to 66 registers, 4 blocks, 4% slower)
constexpr int kMinBlocks = 5;

enum Phase { kFused = 0, kUpdate = 1, kEnds = 2 };

// A float's bits as an unsigned that orders as the float (-0 as +0).
__device__ __forceinline__ unsigned ord_bits(float x) {
  if (x == 0.0f) x = 0.0f;
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ord(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// What the kernels share: a block's batch rows, its word rows' tables, the
// entry into a row, a row's word end and the block's keys.
struct Block {
  int b0, nb;  // the block's batch rows
  int c;       // the lane's word row
  bool row;    // c < C
  float bonus_c, start_c, uni_c, bow_c;
};

// Frame t's keys (the back-off best, or the prune's top) of the block's
// batch rows into shared memory; the row's tables.
__device__ __forceinline__ Block block_start(const LvStepArgs& a, int c,
                                             unsigned long long* key_in) {
  Block k;
  k.b0 = blockIdx.y * a.bsz;
  k.nb = min(a.bsz, a.B - k.b0);
  k.c = c;
  k.row = c < a.C;
  if (threadIdx.x < kBMax) {
    unsigned long long x = 0;
    if (static_cast<int>(threadIdx.x) < k.nb) {
      if (a.phase == kEnds)
        x = a.top[k.b0 + threadIdx.x];
      else if (a.bo)
        x = a.bo[k.b0 + threadIdx.x];
    }
    key_in[threadIdx.x] = x;
  }
  k.bonus_c = k.start_c = k.uni_c = k.bow_c = 0.f;
  if (k.row) {
    k.bonus_c = a.bonus[c];
    if (a.start) k.start_c = a.start[c];
    if (a.bo) k.uni_c = a.uni[c];
    if (a.bo_next) k.bow_c = a.bow[c];
  }
  __syncthreads();
  return k;
}

// The entry into row c of batch row b0 + bi: its score before the row's
// bonus, and its record. `xv`, `xa`: the row's explicit-leg entry (or m, an).
__device__ __forceinline__ void entry(const LvStepArgs& a, const Block& k,
                                      unsigned long long key, float xv,
                                      int xa, float& en, unsigned& erec) {
  en = 0.f;
  erec = 0;
  if (a.phase == kEnds || !k.row) return;
  if (a.start) {
    en = k.start_c;
    return;
  }
  float m = xv;
  int an = xa;
  if (a.bo) {
    m = from_ord(static_cast<unsigned>(key >> 32)) + k.uni_c;
    an = static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
    if (a.xv && xv > m) {
      m = xv;
      an = xa;
    }
  }
  en = m + a.word_pen;
  erec = (static_cast<unsigned>(an + 1) << kTBits) |
         static_cast<unsigned>(a.t);
}

// Row c's word end in batch row b from its group of G lanes (the group's
// `owner` lane holds the score `we` and record `wr`): plane t + 1, the word
// end's copy, and the warp's back-off key (the value, then the lower row;
// 0 for none) into red[bi][warp].
template <int G>
__device__ __forceinline__ void word_end(const LvStepArgs& a, const Block& k,
                                         int bi, int j, float we, unsigned wr,
                                         unsigned long long (*red)[kWarps]) {
  const int b = k.b0 + bi;
  const bool lead = k.row && j == 0;
  if (lead) {
    const unsigned prec = we > kLSmall ? wr : 0u;
    if (a.we) {
      const long long p = b * a.plane_bstride + k.c;
      a.we[p] = we;
      a.pwn[p] = static_cast<int>(prec >> kTBits) - 1;
      a.pwt[p] = static_cast<int>(prec & kTMask) - 1;
    }
    if (a.we_buf) a.we_buf[static_cast<long long>(b) * a.C + k.c] = we;
  }
  if (!a.bo_next) return;
  unsigned long long key =
      lead ? (static_cast<unsigned long long>(ord_bits(we + k.bow_c)) << 32) |
                 (0xffffffffu - static_cast<unsigned>(k.c))
           : 0ull;
#pragma unroll
  for (int o = 16; o >= G; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, key, o);
    key = y > key ? y : key;
  }
  if ((threadIdx.x & 31) == 0) red[bi][threadIdx.x >> 5] = key;
}

// The block's keys of frame t + 1 (the back-off best, or the top) into
// global memory: the warps' merged, one atomicMax a batch row.
__device__ __forceinline__ void block_end(const LvStepArgs& a,
                                          const Block& k,
                                          unsigned long long (*red)[kWarps]) {
  const bool ends = a.phase != kUpdate;
  if (ends ? a.bo_next == nullptr : a.top == nullptr) return;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < k.nb) {
    unsigned long long m = red[threadIdx.x][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      m = red[threadIdx.x][w] > m ? red[threadIdx.x][w] : m;
    if (ends)
      atomicMax(a.bo_next + k.b0 + threadIdx.x, m);
    else
      atomicMax(a.top + k.b0 + threadIdx.x, static_cast<unsigned>(m));
  }
}

// Rows of an even S up to 64: a lane holds two adjacent states (8-byte
// loads and stores), a group of G lanes (the smallest power of two at
// least S / 2) a row. Shift sources come by shuffle from the lane before
// (across the warp where the rows fill their groups, else inside the
// group); the range's first lane loads the K - 1 states before it.
template <int G, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    lv_step_pairs(const LvStepArgs a) {
  __shared__ unsigned long long key_in[kBMax];
  __shared__ unsigned long long red[kBMax][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);
  const int base = lane & ~(G - 1);
  const unsigned gmask = G == 32 ? kFull : ((1u << (G & 31)) - 1u) << base;
  const Block k = block_start(
      a, (blockIdx.x * kWarps + warp) * (32 / G) + lane / G, key_in);
  const int S = a.S;
  const long long Ns = static_cast<long long>(a.C) * S;
  const int phase = a.phase;
  const bool act = k.row && 2 * j < S;
  const long long i0 = static_cast<long long>(k.c) * S + 2 * j;
  const int hl = S == 2 * G ? lane : j;  // 0: the range's first lane
  const int width = S == 2 * G ? 32 : G;

  float2 bnd[K], a0 = {0.f, 0.f}, aE = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < K; ++q) bnd[q] = make_float2(0.f, 0.f);
  if (act) {
#pragma unroll
    for (int q = 0; q < K; ++q)
      bnd[q] = *reinterpret_cast<const float2*>(a.band + q * Ns + i0);
    a0 = *reinterpret_cast<const float2*>(a.a0 + i0);
    aE = *reinterpret_cast<const float2*>(a.aE + i0);
  }

  struct Loaded {
    float2 v, o;
    uint2 r;
    float hv[2];
    unsigned hr[2];
    float xv;
    int xa;
  };
  // batch row bi's loads; each is issued before the previous row is
  // computed
  auto load = [&](int bi) {
    Loaded l;
    l.v = make_float2(kLZero, kLZero);
    l.o = make_float2(0.f, 0.f);
    l.r = make_uint2(0u, 0u);
    l.hv[0] = l.hv[1] = kLZero;
    l.hr[0] = l.hr[1] = 0u;
    l.xv = 0.f;
    l.xa = 0;
    const int b = k.b0 + bi;
    const long long bN = static_cast<long long>(b) * Ns;
    if (act) {
      if (phase == kEnds) {
        l.v = *reinterpret_cast<const float2*>(a.v_out + bN + i0);
        l.r = *reinterpret_cast<const uint2*>(a.rec_out + bN + i0);
      } else {
        l.v = *reinterpret_cast<const float2*>(a.v + bN + i0);
        l.r = *reinterpret_cast<const uint2*>(a.rec + bN + i0);
        l.o = *reinterpret_cast<const float2*>(a.outp + b * a.outp_bstride +
                                               i0);
#pragma unroll
        for (int h = 0; h < K - 1; ++h)
          if (hl == 0 && i0 - 1 - h >= 0) {
            l.hv[h] = a.v[bN + i0 - 1 - h];
            l.hr[h] = a.rec[bN + i0 - 1 - h];
          }
      }
    }
    if (k.row && phase != kEnds && !a.start && a.xv) {
      const long long bc = static_cast<long long>(b) * a.C + k.c;
      l.xv = a.xv[bc];
      l.xa = a.xa[bc];
    }
    return l;
  };

  Loaded nxt = load(0);
  for (int bi = 0; bi < k.nb; ++bi) {
    const Loaded cur = nxt;
    if (bi + 1 < k.nb) nxt = load(bi + 1);
    const long long bN = static_cast<long long>(k.b0 + bi) * Ns;
    float2 nv;
    uint2 nr;
    if (phase != kEnds) {
      float en;
      unsigned erec;
      entry(a, k, key_in[bi], cur.xv, cur.xa, en, erec);
      float w0 = cur.v.x + bnd[0].x, w1 = cur.v.y + bnd[0].y;
      unsigned r0 = cur.r.x, r1 = cur.r.y;
      if (K >= 2) {  // state 2j - 1, then for K = 3 state 2j - 2
        float p1 = __shfl_up_sync(kFull, cur.v.y, 1, width);
        unsigned q1 = __shfl_up_sync(kFull, cur.r.y, 1, width);
        if (hl == 0) {
          p1 = cur.hv[0];
          q1 = cur.hr[0];
        }
        float c0 = p1 + bnd[K >= 2 ? 1 : 0].x;
        if (c0 > w0) {
          w0 = c0;
          r0 = q1;
        }
        float c1 = cur.v.x + bnd[K >= 2 ? 1 : 0].y;
        if (c1 > w1) {
          w1 = c1;
          r1 = cur.r.x;
        }
        if (K >= 3) {
          float p0 = __shfl_up_sync(kFull, cur.v.x, 1, width);
          unsigned q0 = __shfl_up_sync(kFull, cur.r.x, 1, width);
          if (hl == 0) {
            p0 = cur.hv[1];
            q0 = cur.hr[1];
          }
          c0 = p0 + bnd[K - 1].x;
          if (c0 > w0) {
            w0 = c0;
            r0 = q0;
          }
          c1 = p1 + bnd[K - 1].y;
          if (c1 > w1) {
            w1 = c1;
            r1 = q1;
          }
        }
      }
      const float e0 = (en + k.bonus_c) + a0.x;
      const float e1 = (en + k.bonus_c) + a0.y;
      nv.x = (e0 > w0 ? e0 : w0) + cur.o.x;
      nv.y = (e1 > w1 ? e1 : w1) + cur.o.y;
      nr.x = e0 > w0 ? erec : r0;
      nr.y = e1 > w1 ? erec : r1;
    } else {
      const float thr = from_ord(static_cast<unsigned>(key_in[bi])) - a.beam;
      nv.x = cur.v.x < thr ? kLZero : cur.v.x;
      nv.y = cur.v.y < thr ? kLZero : cur.v.y;
      nr = cur.r;
    }
    if (phase == kUpdate) {
      unsigned top = 0;
      if (act) {
        *reinterpret_cast<float2*>(a.v_out + bN + i0) = nv;
        *reinterpret_cast<uint2*>(a.rec_out + bN + i0) = nr;
        top = max(ord_bits(nv.x), ord_bits(nv.y));
      }
      top = __reduce_max_sync(kFull, top);
      if (lane == 0) red[bi][warp] = top;
      continue;
    }
    if (nv.x <= kLSmall) nr.x = 0;
    if (nv.y <= kLSmall) nr.y = 0;
    if (act) {
      *reinterpret_cast<float2*>(a.v_out + bN + i0) = nv;
      *reinterpret_cast<uint2*>(a.rec_out + bN + i0) = nr;
    }
    // the word end: the largest score, then the first state (lanes hold
    // states in order, so the group's first lane holding the largest)
    const float ev0 = nv.x + aE.x, ev1 = nv.y + aE.y;
    const float bv = ev1 > ev0 ? ev1 : ev0;
    const unsigned br = ev1 > ev0 ? nr.y : nr.x;
    const unsigned o = act ? ord_bits(bv) : 0u;
    const unsigned om = __reduce_max_sync(gmask, o);
    const unsigned sel =
        (__ballot_sync(kFull, act && o == om) & gmask) >> base;
    const int owner = base + (sel ? __ffs(sel) - 1 : 0);
    word_end<G>(a, k, bi, j, __shfl_sync(kFull, bv, owner),
                __shfl_sync(kFull, br, owner), red);
  }
  block_end(a, k, red);
}

// Any other S: a lane a state, a warp a row, walked in chunks of 32
// states; each lane keeps its running word end over its chunks, the first
// K - 1 lanes of a chunk load the states before it.
template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    lv_step_chunks(const LvStepArgs a) {
  __shared__ unsigned long long key_in[kBMax];
  __shared__ unsigned long long red[kBMax][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Block k = block_start(a, blockIdx.x * kWarps + warp, key_in);
  const int S = a.S;
  const long long Ns = static_cast<long long>(a.C) * S;
  const int phase = a.phase;
  const int chunks = (S + 31) / 32;

  for (int bi = 0; bi < k.nb; ++bi) {
    const int b = k.b0 + bi;
    const long long bN = static_cast<long long>(b) * Ns;
    float en = 0.f, xv = 0.f;
    unsigned erec = 0;
    int xa = 0;
    if (k.row && phase != kEnds && !a.start && a.xv) {
      xv = a.xv[static_cast<long long>(b) * a.C + k.c];
      xa = a.xa[static_cast<long long>(b) * a.C + k.c];
    }
    entry(a, k, key_in[bi], xv, xa, en, erec);
    const float thr = phase == kEnds
                          ? from_ord(static_cast<unsigned>(key_in[bi])) -
                                a.beam
                          : 0.f;
    float best_v = -INFINITY;
    int best_s = INT_MAX;
    unsigned best_r = 0, top = 0;
    for (int q = 0; q < chunks; ++q) {
      const int s = q * 32 + lane;
      const bool act = k.row && s < S;
      const long long i = static_cast<long long>(k.c) * S + s;
      float nv;
      unsigned nr;
      if (phase != kEnds) {
        const float vv = act ? a.v[bN + i] : kLZero;
        const unsigned rr = act ? a.rec[bN + i] : 0u;
        float within = vv + (act ? a.band[i] : 0.f);
        unsigned wrec = rr;
#pragma unroll
        for (int d = 1; d < K; ++d) {
          float vk = __shfl_up_sync(kFull, vv, d);
          unsigned rk = __shfl_up_sync(kFull, rr, d);
          if (lane < d) {
            const bool in = act && i - d >= 0;
            vk = in ? a.v[bN + i - d] : kLZero;
            rk = in ? a.rec[bN + i - d] : 0u;
          }
          const float ck = vk + (act ? a.band[d * Ns + i] : 0.f);
          if (ck > within) {
            within = ck;
            wrec = rk;
          }
        }
        const float e = (en + k.bonus_c) + (act ? a.a0[i] : 0.f);
        nv = (e > within ? e : within) +
             (act ? a.outp[b * a.outp_bstride + i] : 0.f);
        nr = e > within ? erec : wrec;
      } else {
        nv = act ? a.v_out[bN + i] : kLZero;
        nr = act ? a.rec_out[bN + i] : 0u;
        if (nv < thr) nv = kLZero;
      }
      if (phase == kUpdate) {
        if (act) {
          a.v_out[bN + i] = nv;
          a.rec_out[bN + i] = nr;
          top = max(top, ord_bits(nv));
        }
        continue;
      }
      if (nv <= kLSmall) nr = 0;
      if (act) {
        a.v_out[bN + i] = nv;
        a.rec_out[bN + i] = nr;
        const float ev = nv + a.aE[i];
        if (ev > best_v) {  // chunks in order: the first state wins ties
          best_v = ev;
          best_s = s;
          best_r = nr;
        }
      }
    }
    if (phase == kUpdate) {
      top = __reduce_max_sync(kFull, top);
      if (lane == 0) red[bi][warp] = top;
      continue;
    }
    // the word end: the largest score, then the lowest state
    const bool has = best_s != INT_MAX;
    const unsigned o = has ? ord_bits(best_v) : 0u;
    const unsigned om = __reduce_max_sync(kFull, o);
    const unsigned sm = __reduce_min_sync(
        kFull, (has && o == om) ? static_cast<unsigned>(best_s)
                                : 0xffffffffu);
    const int owner = static_cast<int>(sm & 31);
    word_end<32>(a, k, bi, lane, __shfl_sync(kFull, best_v, owner),
                 __shfl_sync(kFull, best_r, owner), red);
  }
  block_end(a, k, red);
}

template <int G, int K>
cudaError_t run_pairs(const LvStepArgs& a, cudaStream_t stream) {
  const int rows = kWarps * (32 / G);
  const dim3 grid((a.C + rows - 1) / rows, (a.B + a.bsz - 1) / a.bsz);
  lv_step_pairs<G, K><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t run_chunks(const LvStepArgs& a, cudaStream_t stream) {
  const dim3 grid((a.C + kWarps - 1) / kWarps, (a.B + a.bsz - 1) / a.bsz);
  lv_step_chunks<K><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One launch of phase a->phase over the whole (B, C) grid on `stream`:
// two states a lane where S is even and at most 64 and the frame's scores
// are 8-byte aligned, else a state a lane. Returns a cudaError_t.
extern "C" int lv_step_launch(const LvStepArgs* a, void* stream) {
  using Run = cudaError_t (*)(const LvStepArgs&, cudaStream_t);
  static const Run pairs[kKMax][6] = {
      {run_pairs<1, 1>, run_pairs<2, 1>, run_pairs<4, 1>, run_pairs<8, 1>,
       run_pairs<16, 1>, run_pairs<32, 1>},
      {run_pairs<1, 2>, run_pairs<2, 2>, run_pairs<4, 2>, run_pairs<8, 2>,
       run_pairs<16, 2>, run_pairs<32, 2>},
      {run_pairs<1, 3>, run_pairs<2, 3>, run_pairs<4, 3>, run_pairs<8, 3>,
       run_pairs<16, 3>, run_pairs<32, 3>}};
  static const Run chunks[kKMax] = {run_chunks<1>, run_chunks<2>,
                                    run_chunks<3>};
  if (a->B < 1 || a->C < 1 || a->S < 1 || a->K < 1 || a->K > kKMax ||
      a->bsz < 1 || a->bsz > kBMax || a->phase < kFused ||
      a->phase > kEnds || a->t < 0 || a->t > static_cast<int>(kTMask))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool paired = a->S % 2 == 0 && a->S <= 64 &&
                      a->outp_bstride % 2 == 0 &&
                      (reinterpret_cast<uintptr_t>(a->outp) |
                       reinterpret_cast<uintptr_t>(a->band) |
                       reinterpret_cast<uintptr_t>(a->a0) |
                       reinterpret_cast<uintptr_t>(a->aE)) % 8 == 0;
  if (!paired) return static_cast<int>(chunks[a->K - 1](*a, s));
  int g = 0;
  while ((1 << g) < a->S / 2) ++g;
  return static_cast<int>(pairs[a->K - 1][g](*a, s));
}
