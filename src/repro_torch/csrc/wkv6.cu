// K3: the RWKV6 (Finch) WKV recurrence from a zero state.
//
// Replaces repro/kernels/wkv6.py::_wkv_kernel (the Pallas TPU kernel,
// entry wkv6).  Per (batch, head), with the N x N f32 state S laid out
// [key i x value j] as the TPU kernel and wkv_step keep it:
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// It returns every y_t (B, S, H, N) and the final state (B, H, N, N),
// both f32.  Any sequence length (the Pallas wrapper's S % block_t
// assert does not carry over).  The plain PyTorch version is
// repro_torch/models/blocks_rnn.py::wkv_scan.
//
// What bounds it on an H100.  Each step reads r, k, v, w (4N floats) and
// writes y (N floats); the state never leaves the chip.  At rwkv6-7b's
// prefill (B=1, H=64, N=64, S=1000) that is 83 MB of traffic (25 us at
// 3.35 TB/s) and ~1.1 GFLOP (16 us at the 67 TFLOP/s f32 rate): bytes
// bound it.  The first design ran the recurrence token by token, a chain
// of dependent FMAs, shared loads and shuffles per step (~300 ns a step,
// 12x the bound), on 4 warps an SM.  This one cuts the chain to one link
// per chunk of T = 16 steps (the chunked form of the JAX package's
// wkv_chunked, ported as blocks_rnn.py::wkv_chunked).  Within a chunk,
// with D(a, b) = prod_{a <= tau < b} w_tau (elementwise over the key
// index i; 1 when a >= b):
//     y_t = (r_t . D(0, t)) S_c                                  (inter)
//         + sum_{s<t} [sum_i r_t[i] k_s[i] D(s+1, t)[i]] v_s     (intra)
//         + (r_t . u . k_t) v_t                                  (bonus)
//     S_{c+1} = D(0, T) . S_c + sum_s (k_s . D(s+1, T)) v_s^T
// Every factor is a product of w's over a range, so it lies in [0, 1]:
// nothing overflows (the factored r*P, k/P form divides by P and does),
// w = 0 and w = 1 are exact, and nothing takes a log.  wkv_chunked's
// exp(L_{t-1} - L_s) of cumulative log-decays is the same algebra, but
// in f32 the difference of two large |L| (up to ~1000 in a chunk when
// decays reach exact 0 and are clamped at 1e-30) loses up to ulp(|L|),
// ~1e-4, absolute: a kernel built on it missed the 2e-4 tolerance at
// S = 1000 with decays over the model's range
// (tests/test_torch_cuda.py::test_wkv6_chunks_and_extreme_decays), where
// the products hold it.  The design:
//   * one block of 512 threads per (batch, head, 32 state columns): at
//     rwkv6-7b's shape 128 blocks, one per SM of the 132;
//   * r, k, w (all N columns) and v (the block's 32) arrive a chunk at a
//     time with cp.async into one of three shared-memory stages, straight
//     from the (B, S, H, N) layout, two chunks ahead; a short tail chunk
//     is padded with r = k = v = 0 and w = 1;
//   * warp specialisation, one block barrier a step: at step c, warps 0-7
//     run the A phase of chunk c + 1 (it does not depend on S) while
//     warps 8-15 run the products of chunk c, from the other of two sets
//     of A-phase outputs.  The A phase, on the CUDA cores: thread
//     (s, slice) walks t = 0..T-1 over N/16 key rows with kd = k_s .
//     D(s+1, t), one FMA for A[t][s] and one multiply a term, no exp;
//     the bonus lands on the diagonal; kd ends as k~_s = k_s . D(s+1, T);
//     before s the thread carries D(0, t) instead, which gives r~_s (and,
//     at s = T-1, the chunk's decay); a butterfly of 15 shuffles sums the
//     16 slices.  The block of the other 32 columns recomputes A.  The
//     products, on the tensor cores: warps 8-11 hold S_c in mma
//     accumulators, copy it to shared memory for warps 12-15 (a named
//     barrier between the eight) and form S_{c+1} = D(0, T) . S_c +
//     k~^T V; warps 12-15 form y = r~ S_c + A V, one 16 x 8 tile each,
//     stored from the accumulators.  The overlap gains less than the
//     A phase's share (7% on an H100 at S = 1000): the two halves
//     compete for the same SM;
//   * the products are mma.sync m16n8k8 in 3xTF32: each operand is
//     split into a TF32 high part and its remainder and three products
//     (lo.hi + hi.lo + hi.hi) accumulate in f32, which keeps ~2^-20 of
//     each product where plain TF32 keeps ~2^-10 and would miss the 2e-4
//     tolerance.  On the CUDA cores the same products were bound by
//     shared memory: every operand was a warp-wide broadcast feeding one
//     FMA a lane (~320 load cycles a warp a chunk); as mma fragments,
//     from rows padded so that each load hits 32 banks, every value is
//     read once a warp;
//   * the serial chain is S_c -> S_{c+1}: ceil(S / 16) links (63 at
//     S = 1000) instead of S.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;           // steps a chunk
constexpr int kThreads = 512;    // 8 warps for A, 4 for the state, 4 for y
constexpr int kAThreads = 256;   // warps 0-7: the A phase
constexpr int kTP = kT + 4;      // row stride of A (conflict-free reads)
constexpr unsigned kFull = 0xffffffffu;

template <int N>
struct Plan {
  static constexpr int kCG = N < 32 ? N : 32;      // state columns a block
  static constexpr int kColBlocks = N / kCG;
  static constexpr int kIW = N / 16;               // key rows a slice (A)
  // row strides in shared memory, padded so that every mma fragment
  // load touches 32 distinct banks
  static constexpr int kNQ = N + 4;                // r~ [T][NQ]
  static constexpr int kNK = N + 8;                // k~ [T][NK]
  static constexpr int kCP = kCG + 8;              // v, S [.][CP]
  static constexpr int kMT = N / 16;               // state tiles: rows
  static constexpr int kNT = kCG / 8;              //   ... and columns
  static constexpr int kStateTiles = (kMT * kNT + 3) / 4;   // a warp
  // floats: three stages of r, k, w (T x N) and v (T x CP); two sets
  // of the A phase's outputs (r~, k~, A, the chunk's decay); S_c as the
  // y warps read it (N x CP); u (N)
  static constexpr int kStage = 3 * kT * N + kT * kCP;
  static constexpr int kABuf = kT * (kNQ + kNK + kTP) + N;
  static constexpr int kFloats = 3 * kStage + 2 * kABuf + N * kCP + N;
  static_assert(kIW >= 1 && kNT <= 4, "thread mapping");
};

// 16 bytes global -> shared without a trip through registers (sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Start copying steps [t0, t0 + n) of r, k, w (all N columns) and v
// (columns [j0, j0 + CG)) into one stage; steps n..T-1 of the stage are
// padded with r = k = v = 0 and w = 1.
template <int N>
__device__ __forceinline__ void stage_chunk(
    float* st, const float* r, const float* k, const float* v,
    const float* w, long long base, long long step_stride, int j0, int t0,
    int n) {
  using PL = Plan<N>;
  constexpr int kRowVecs = N / 4;
  constexpr int kVVecs = PL::kCG / 4;
  constexpr int kVecs = 3 * kRowVecs + kVVecs;       // 16-byte pieces a step
  float* sr = st;
  float* sk = st + kT * N;
  float* sw = st + 2 * kT * N;
  float* sv = st + 3 * kT * N;
  for (int e = threadIdx.x; e < kT * kVecs; e += kThreads) {
    const int tt = e / kVecs;
    int c = e % kVecs;
    float* dst;
    const float* src;
    int which;
    if (c < 3 * kRowVecs) {
      const int a = c / kRowVecs;
      c = (c % kRowVecs) * 4;
      dst = (a == 0 ? sr : a == 1 ? sk : sw) + tt * N + c;
      src = (a == 0 ? r : a == 1 ? k : w) + c;
      which = a;
    } else {
      c = (c - 3 * kRowVecs) * 4;
      dst = sv + tt * PL::kCP + c;
      src = v + j0 + c;
      which = 3;
    }
    if (tt < n) {
      cp_async16(dst, src + base + (t0 + tt) * step_stride);
    } else {
      const float pad = which == 2 ? 1.0f : 0.0f;    // w = 1, others 0
      *reinterpret_cast<float4*>(dst) = make_float4(pad, pad, pad, pad);
    }
  }
}

// W consecutive floats of shared memory (W = 1, 2 or 4, aligned to W)
// in one load or store.
template <int W>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    dst[0] = src[0];
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* dst, const float* src) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// One step of a reduce-scatter over the 16 lanes of a half-warp: lanes
// whose bit O is set keep the upper O of the values, the others the
// lower, each adding its partner's copy (xor O).  After O = 8, 4, 2, 1,
// acc[0] of lane l holds the sum over the 16 lanes of acc[l].
template <int O>
__device__ __forceinline__ void fold(float* acc, int slice) {
  const bool hi = (slice & O) != 0;
#pragma unroll
  for (int q = 0; q < O; ++q) {
    const float send = hi ? acc[q] : acc[q + O];
    const float keep = hi ? acc[q + O] : acc[q];
    acc[q] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi is exact in f32.  The tensor cores read the top 19
// bits of each operand, so lo enters with its leading 11 bits: x is
// carried to ~2^-21.  A mask and a subtract, where cvt.rna.tf32 runs on a
// slow pipe (it held the products to ~16 conversions a clock an SM).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a (16 x 8) b (8 x 8) in 3xTF32 on the tensor cores, f32 accumulation:
// dc += a_lo b_hi + a_hi b_lo (the corrections) and dm += a_hi b_hi (the
// main term), two accumulators so that the products' chains overlap;
// a_lo b_lo (~2^-22 of the product) is dropped.  a, b: mma fragments as
// floats.  The caller adds dc to dm once at the end.
__device__ __forceinline__ void mma_3xtf32(float* dm, float* dc,
                                           const float* a, const float* b) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
#pragma unroll
  for (int q = 0; q < 2; ++q) split_tf32(b[q], bh[q], bl[q]);
  mma_tf32(dc, al, bh);
  mma_tf32(dm, ah, bh);
  mma_tf32(dc, ah, bl);
}

// The A phase of one chunk, by threads 0-255: A (with the bonus on its
// diagonal), r~, k~ and the chunk's decay, from the chunk's stage `st`
// into the output set `ab`.  Thread (as, slice) runs t = 0..T-1 over key
// rows [ib, ib + IW): before as, pd = prod_{tau < t} w_tau (at as it
// gives r~_as, and on the last row the chunk's decay); at as, the bonus
// u . k_as feeds A[as][as]; after as, kd = k_as . prod_{as < tau < t}
// w_tau feeds A[t][as], and at the end kd is k~_as.  Every row is loaded
// first and the steps use selects, not branches, so that the loads'
// latency is paid once.  A butterfly then sums the 16 slices and leaves
// A[t = slice][as] on each lane.
template <int N>
__device__ __forceinline__ void a_phase(const float* st, const float* su,
                                        float* ab, int tid) {
  using PL = Plan<N>;
  constexpr int kIW = PL::kIW;
  const float* sr = st;
  const float* sk = st + kT * N;
  const float* sw = st + 2 * kT * N;
  float* sq = ab;
  float* skt = sq + kT * PL::kNQ;
  float* sA = skt + kT * PL::kNK;
  float* spend = sA + kT * kTP;
  const int as = tid >> 4;
  const int slice = tid & 15;
  const int ib = slice * kIW;
  float rt[kT][kIW], wt[kT][kIW];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    load_row<kIW>(rt[t], sr + t * N + ib);
    load_row<kIW>(wt[t], sw + t * N + ib);
  }
  float kd[kIW], uk[kIW], pd[kIW];
  load_row<kIW>(kd, sk + as * N + ib);
  load_row<kIW>(uk, su + ib);
#pragma unroll
  for (int c = 0; c < kIW; ++c) {
    uk[c] *= kd[c];
    pd[c] = 1.0f;
  }
  float acc[kT];
  float rq[kIW] = {};                                // r~_as
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const bool before = t < as, at = t == as, after = t > as;
    float a = 0.0f;
#pragma unroll
    for (int c = 0; c < kIW; ++c) {
      a = fmaf(rt[t][c], after ? kd[c] : at ? uk[c] : 0.0f, a);
      if (at) rq[c] = rt[t][c] * pd[c];
      kd[c] *= after ? wt[t][c] : 1.0f;
      pd[c] *= before ? wt[t][c] : 1.0f;
    }
    acc[t] = a;
  }
  store_row<kIW>(sq + as * PL::kNQ + ib, rq);
  store_row<kIW>(skt + as * PL::kNK + ib, kd);
  if (as == kT - 1) {
#pragma unroll
    for (int c = 0; c < kIW; ++c) pd[c] *= wt[kT - 1][c];
    store_row<kIW>(spend + ib, pd);
  }
  fold<8>(acc, slice);
  fold<4>(acc, slice);
  fold<2>(acc, slice);
  fold<1>(acc, slice);
  sA[slice * kTP + as] = acc[0];
}

template <int N>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ state_out, int seq, int heads) {
  using PL = Plan<N>;
  constexpr int kCG = PL::kCG;
  constexpr int kCP = PL::kCP;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                               // 3 x kStage
  float* abuf = stage + 3 * PL::kStage;              // 2 x kABuf
  float* sS = abuf + 2 * PL::kABuf;                  // S_c [N][CP]
  float* su = sS + N * kCP;                          // [N]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;                         // mma fragment row
  const int tig = lane & 3;                          // ... and column
  const int bh = blockIdx.x / PL::kColBlocks;
  const int b = bh / heads;
  const int h = bh % heads;
  const int j0 = (blockIdx.x % PL::kColBlocks) * kCG;
  const long long step_stride = static_cast<long long>(heads) * N;
  const long long base = (static_cast<long long>(b) * seq * heads + h) * N;

  // warps 0-7 run the A phase one chunk ahead; warps 8-11 own S's tiles
  // (16 rows x 8 columns, tile sw + 4q) in mma accumulators; warps 12-15
  // one 8-column tile of y each
  const bool a_warp = tid < kAThreads;
  const int sw = warp - 8;
  const bool state_warp = sw >= 0 && sw < 4;
  float acc_s[PL::kStateTiles][4];
#pragma unroll
  for (int q = 0; q < PL::kStateTiles; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_s[q][e] = 0.0f;
  }

  const int n_chunks = (seq + kT - 1) / kT;
  auto chunk_len = [&](int c) { return seq - c * kT < kT ? seq - c * kT : kT; };
  for (int c = 0; c < 2 && c < n_chunks; ++c) {
    stage_chunk<N>(stage + c * PL::kStage, r, k, v, w, base, step_stride,
                   j0, c * kT, chunk_len(c));
    cp_async_commit();
  }
  for (int e = tid; e < N; e += kThreads) su[e] = u[h * N + e];
  cp_async_wait_all();
  __syncthreads();
  if (a_warp) a_phase<N>(stage, su, abuf, tid);
  __syncthreads();

  // step ci: the A phase of chunk ci + 1 beside the products of chunk ci
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kT;
    const int n = chunk_len(ci);
    if (ci + 2 < n_chunks) {
      // stage (ci + 2) % 3 last held chunk ci - 1, done with before the
      // barrier that ended the last step
      stage_chunk<N>(stage + ((ci + 2) % 3) * PL::kStage, r, k, v, w, base,
                     step_stride, j0, t0 + 2 * kT, chunk_len(ci + 2));
      cp_async_commit();
    }
    if (a_warp) {
      if (ci + 1 < n_chunks) {
        a_phase<N>(stage + ((ci + 1) % 3) * PL::kStage, su,
                   abuf + ((ci + 1) % 2) * PL::kABuf, tid);
      }
    } else {
      const float* ab = abuf + (ci % 2) * PL::kABuf;
      const float* sq = ab;
      const float* skt = sq + kT * PL::kNQ;
      const float* sA = skt + kT * PL::kNK;
      const float* spend = sA + kT * kTP;
      const float* sv = stage + (ci % 3) * PL::kStage + 3 * kT * N;
      // the state warps hand S_c to the y warps
      if (state_warp) {
#pragma unroll
        for (int q = 0; q < PL::kStateTiles; ++q) {
          const int tile = sw + 4 * q;
          if (tile < PL::kMT * PL::kNT) {
            const int i = (tile / PL::kNT) * 16 + gid;
            const int jj = (tile % PL::kNT) * 8 + 2 * tig;
            *reinterpret_cast<float2*>(&sS[i * kCP + jj]) =
                make_float2(acc_s[q][0], acc_s[q][1]);
            *reinterpret_cast<float2*>(&sS[(i + 8) * kCP + jj]) =
                make_float2(acc_s[q][2], acc_s[q][3]);
          }
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads - kAThreads));

      // ---- products on the tensor cores (3xTF32) ----------------------
      if (state_warp) {
        // S_{c+1} = decay . S_c + k~^T V: tile rows i, columns j, K = s
#pragma unroll
        for (int q = 0; q < PL::kStateTiles; ++q) {
          const int tile = sw + 4 * q;
          if (tile < PL::kMT * PL::kNT) {
            const int i = (tile / PL::kNT) * 16 + gid;
            const int jn = (tile % PL::kNT) * 8 + gid;
            const float d0 = spend[i], d1 = spend[i + 8];
            float dm[2][4] = {}, dc[2][4] = {};   // one pair per k-step
#pragma unroll
            for (int kk = 0; kk < kT; kk += 8) {
              const float a[4] = {skt[(kk + tig) * PL::kNK + i],
                                  skt[(kk + tig) * PL::kNK + i + 8],
                                  skt[(kk + tig + 4) * PL::kNK + i],
                                  skt[(kk + tig + 4) * PL::kNK + i + 8]};
              const float bb[2] = {sv[(kk + tig) * kCP + jn],
                                   sv[(kk + tig + 4) * kCP + jn]};
              mma_3xtf32(dm[kk / 8], dc[kk / 8], a, bb);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc_s[q][e] = fmaf(acc_s[q][e], e < 2 ? d0 : d1,
                                 (dm[0][e] + dc[0][e]) +
                                     (dm[1][e] + dc[1][e]));
            }
          }
        }
      } else if (warp - 12 < PL::kNT) {
        // y = r~ S_c + A V: one 16 x 8 tile, K = i then s
        const int nt = warp - 12;
        const int jn = nt * 8 + gid;
        // four accumulator pairs: k-steps over i go round robin to the
        // first two, the two k-steps over s to the last two
        float dm[4][4] = {}, dc[4][4] = {};
#pragma unroll
        for (int kk = 0; kk < N; kk += 8) {
          const float a[4] = {sq[gid * PL::kNQ + kk + tig],
                              sq[(gid + 8) * PL::kNQ + kk + tig],
                              sq[gid * PL::kNQ + kk + tig + 4],
                              sq[(gid + 8) * PL::kNQ + kk + tig + 4]};
          const float bb[2] = {sS[(kk + tig) * kCP + jn],
                               sS[(kk + tig + 4) * kCP + jn]};
          mma_3xtf32(dm[(kk / 8) % 2], dc[(kk / 8) % 2], a, bb);
        }
#pragma unroll
        for (int kk = 0; kk < kT; kk += 8) {
          const float a[4] = {sA[gid * kTP + kk + tig],
                              sA[(gid + 8) * kTP + kk + tig],
                              sA[gid * kTP + kk + tig + 4],
                              sA[(gid + 8) * kTP + kk + tig + 4]};
          const float bb[2] = {sv[(kk + tig) * kCP + jn],
                               sv[(kk + tig + 4) * kCP + jn]};
          mma_3xtf32(dm[2 + kk / 8], dc[2 + kk / 8], a, bb);
        }
        float acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e] = ((dm[0][e] + dc[0][e]) + (dm[1][e] + dc[1][e])) +
                   ((dm[2][e] + dc[2][e]) + (dm[3][e] + dc[3][e]));
        }
        const int jj = j0 + nt * 8 + 2 * tig;
        if (gid < n) {
          *reinterpret_cast<float2*>(
              &y[base + (t0 + gid) * step_stride + jj]) =
              make_float2(acc[0], acc[1]);
        }
        if (gid + 8 < n) {
          *reinterpret_cast<float2*>(
              &y[base + (t0 + gid + 8) * step_stride + jj]) =
              make_float2(acc[2], acc[3]);
        }
      }
    }
    cp_async_wait_all();                   // chunk ci + 2 has landed
    __syncthreads();
  }

  if (state_warp) {
    float* out = state_out + (static_cast<long long>(b) * heads + h) * N * N;
#pragma unroll
    for (int q = 0; q < PL::kStateTiles; ++q) {
      const int tile = sw + 4 * q;
      if (tile < PL::kMT * PL::kNT) {
        const int i = (tile / PL::kNT) * 16 + gid;
        const int jj = j0 + (tile % PL::kNT) * 8 + 2 * tig;
        *reinterpret_cast<float2*>(&out[i * N + jj]) =
            make_float2(acc_s[q][0], acc_s[q][1]);
        *reinterpret_cast<float2*>(&out[(i + 8) * N + jj]) =
            make_float2(acc_s[q][2], acc_s[q][3]);
      }
    }
  }
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* state, int batch, int seq,
           int heads, cudaStream_t stream) {
  using PL = Plan<N>;
  const size_t smem = sizeof(float) * PL::kFloats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv_kernel<N><<<batch * heads * PL::kColBlocks, kThreads, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(state), seq, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch K3 on `stream`.  r, k, v, w: contiguous float32 (B, S, H, N),
// 16-byte aligned; u: contiguous float32 (H, N).  Writes y (B, S, H, N) and the final
// state (B, H, N, N), both contiguous float32.  N is 16, 32 or 64.
// Returns cudaGetLastError() after the launch (0 on success).
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, void* state, int batch, int seq,
             int heads, int n, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16:
      return launch<16>(r, k, v, w, u, y, state, batch, seq, heads, s);
    case 32:
      return launch<32>(r, k, v, w, u, y, state, batch, seq, heads, s);
    case 64:
      return launch<64>(r, k, v, w, u, y, state, batch, seq, heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
