// K1: one greedy + EASY-backfill scheduling pass per what-if fork.
//
// Replaces repro/kernels/policy_eval.py::_pass_kernel (the Pallas TPU
// kernel behind the JAX engine's "pallas" backend), through both of its
// entries: policy_eval_pass_batched (K1: every fork reads its own rows)
// and policy_eval_pass (K1': one (J,) snapshot shared by the k forks,
// each with its own order).  The two differ only in the row stride of
// the per-job arrays (J, or 0 for shared rows) and of free0/now (1 or 0).  Semantics follow
// the reference pass, repro/core/backfill.py::schedule_pass_with_order,
// where the two differ:
//   * node arithmetic (nodes, free, need, cum, extra) is int32;
//   * shadow-time ties use the lexicographic (end, slot) order, not the
//     Pallas kernel's inclusive `end <= end` count;
//   * `now + est` is a plain f32 add (__fadd_rn); nothing is contracted
//     into an FMA.
// The plain PyTorch version is repro_torch/core/backfill.py::_pass.
//
// What bounds it on an H100.  A launch moves few bytes (k*J*21 in,
// k*J + 4k out: 0.7 MB at k=32, J=1024, a fraction of a microsecond at
// 3.35 TB/s), and its operations (the O(R^2) count over the R running
// and just-started jobs, R ~ 100 on a Polaris pass) take less.  It is
// bound by latency: one block per fork runs a chain of phases, each
// ending in a block barrier.  Timed phase by phase on the card (clock64
// stamps, a Polaris drain at k=32, J=1024), the first design spent most
// of its time in (a) the R^2 count, one thread per running job walking
// all R others (14k of 25k clocks on the first pass), (b) the backfill
// walk on one thread (18k clocks on an average pass of the drain, with
// up to 434 candidates of which at most 3 start), and (c) twelve
// block-wide scans of 256 threads, three barriers each.  This design:
//   * one block per fork (grid = k), the fork's rows in shared memory
//     (25 bytes per slot), one thread per slot up to J = 1024 and P = 2
//     or 4 consecutive slots (ranks) a thread above it, loaded with
//     16-byte reads where the rows are aligned;
//   * six block barriers in all: pass 1 is ONE block scan (each thread
//     sums its P ranks first), and the head rank, the started nodes and
//     the compaction of the running set are warp-aggregated shared
//     atomics in the same phase (a just-started job is appended by the
//     thread that started it, a running one by the thread that owns its
//     slot).  The compacted set is unordered, so the lexicographic tie
//     compares slots, not positions: the same order;
//   * the R^2 count splits each job's sum over up to 32 threads (a power
//     of two, as many as the block has to spare) and closes it with
//     shuffles; each job is one 64-bit key whose unsigned order is the
//     (end, slot) order, so a pair costs one compare; one barrier gives
//     `shadow` and the first feasible `cum`;
//   * the filter needs no scan: each thread writes, per rank, the job's
//     nodes (or -1 if it cannot start even at the initial state) and its
//     cond_a bit, from what it kept in registers during pass 1, and sets
//     the rank's bit in a mask of candidates (one word per 32 ranks);
//   * the walk is one warp, 32 ranks a round, over the groups of 32
//     ranks whose mask word is not empty (see walk_warp below): on most
//     passes of a Polaris drain no rank is a candidate and the walk reads
//     one mask word a lane.
// What bounds it now (the same clock64 stamps, on an H100): ~11k clocks
// on the first Polaris pass, still latency: the count's loop over R keys
// (~4k), pass 1's chain of dependent shared loads, scan and atomics
// (~2.5k), the loads from device memory (~1.3k), and on passes with
// candidates the walk's rounds (~3k on an average pass of the drain).
//
// Why the warp walk equals the serial walk.  The serial walk visits the
// candidates in rank order with state (F, E) and starts c iff
// nd <= F && (a || nd <= E), then F -= nd and, if !a, E -= nd.  F and E
// never rise, and the test is monotone in both, so a candidate that fails
// it at some state fails it at every later state: dropping it early
// changes nothing.  In a round, the lanes that pass the test at the
// current state ("live") are taken in lane (= rank) order; an inclusive
// scan gives each live lane the nodes PF and PE (PE over !a lanes only)
// of itself and every live lane before it.  If every live lane before l
// starts, the serial state at l is (F - PF + nd, E - PE + nd*!a), so l
// starts iff PF <= F && (a || PE <= E).  Let f be the first live lane
// for which that fails: every live lane before f starts (by induction
// over lanes), f does not, and the state after f is (F - PF_f', E -
// PE_f') with f' the last live lane before f, which is what the serial
// walk holds there.  The round drops lanes <= f, re-tests the rest at
// the new state and repeats; when no live lane fails, all start.  Every
// decision, and the order of the state's updates, is the serial walk's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxJ = 4096;              // 25 * 4096 B = 100 KiB of shared memory
constexpr int kBytesPerSlot = 25;
constexpr int kQueued = 1;               // lifecycle codes, core/state.py
constexpr int kRunning = 2;
constexpr int kInt32Max = 2147483647;
constexpr unsigned kFull = 0xffffffffu;

constexpr uint8_t kFlagQueued = 1;
constexpr uint8_t kFlagRunning = 2;
constexpr uint8_t kFlagStarted = 4;

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

__device__ __forceinline__ long long warp_incl_scan64(long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long n = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

// (end, slot) as one 64-bit key whose unsigned order is the
// lexicographic order of the pass's tie rule: the end's bits mapped so
// that integer order is float order (-0 is first made +0, which the
// float compare does not tell apart), then the slot.  Ends here are
// never NaN or +inf (those are dropped before), so every key is below
// kNoKey, the key of +inf.
__device__ __forceinline__ uint32_t float_key(float e) {
  const uint32_t u = __float_as_uint(e + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ uint64_t end_slot_key(float e, int slot) {
  return (static_cast<uint64_t>(float_key(e)) << 32) |
         static_cast<uint32_t>(slot);
}

constexpr uint32_t kNoKey = 0xff800000u;         // float_key(+inf)
constexpr uint32_t kMinusInfKey = 0x007fffffu;   // float_key(-inf)

__device__ __forceinline__ float warp_min_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The backfill walk over ranks (head_rank, limit), by one whole warp.
// Bit r % 32 of s_mask[r / 32] is set iff rank r passed the filter at
// the initial state; s_cnd[r] is then its nodes and s_ca[r] its cond_a
// bit.  The warp reads 32 mask words at a time and visits only the
// groups of 32 ranks that hold a candidate, in rank order.  Returns the
// final free count (every lane gets it) and marks each started slot in
// s_flags.
__device__ int walk_warp(const int* s_cnd, const uint8_t* s_ca,
                         const uint32_t* s_mask, const int* s_order,
                         uint8_t* s_flags, int first_word, int last_word,
                         int free_now, int extra_now) {
  const int lane = threadIdx.x & 31;
  for (int wb = first_word; wb <= last_word; wb += 32) {
    const uint32_t word = wb + lane <= last_word ? s_mask[wb + lane] : 0u;
    unsigned busy = __ballot_sync(kFull, word != 0u);
    while (busy) {
      const int g = __ffs(busy) - 1;
      busy &= busy - 1u;
      const uint32_t cand = __shfl_sync(kFull, word, g);
      const int r = (wb + g) * 32 + lane;
      int nd = -1;
      bool a = false;
      if ((cand >> lane) & 1u) {
        nd = s_cnd[r];
        a = s_ca[r] != 0;
      }
      unsigned live = __ballot_sync(
          kFull, nd >= 0 && nd <= free_now && (a || nd <= extra_now));
      while (live) {
        const bool mine = (live >> lane) & 1u;
        const long long pf = warp_incl_scan64(mine ? nd : 0);
        const long long pe = warp_incl_scan64(mine && !a ? nd : 0);
        const unsigned fails = __ballot_sync(
            kFull, mine && !(pf <= free_now && (a || pe <= extra_now)));
        // live lanes before the first failing one all start
        const unsigned ok =
            fails ? live & ((fails & (0u - fails)) - 1u) : live;
        if (ok) {
          const int last = 31 - __clz(ok);
          free_now -= static_cast<int>(__shfl_sync(kFull, pf, last));
          extra_now -= static_cast<int>(__shfl_sync(kFull, pe, last));
          if ((ok >> lane) & 1u) s_flags[s_order[r]] |= kFlagStarted;
        }
        if (!fails) break;
        live &= ~((2u << (__ffs(fails) - 1)) - 1u);    // lanes after it
        live &= __ballot_sync(
            kFull, nd >= 0 && nd <= free_now && (a || nd <= extra_now));
      }
    }
  }
  return free_now;
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads, 1)
pass_kernel(const int* __restrict__ order, const int* __restrict__ state,
            const int* __restrict__ nodes, const float* __restrict__ est,
            const float* __restrict__ end_t, const int* __restrict__ free0,
            const float* __restrict__ now_in,
            const int* __restrict__ limit_in,
            uint8_t* __restrict__ started_out, int* __restrict__ free_out,
            int J, int job_stride, int scalar_stride, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  // compacted running jobs (any order): their (end, slot) keys
  uint64_t* s_lkey = reinterpret_cast<uint64_t*>(smem);
  int* s_order = reinterpret_cast<int*>(s_lkey + J);     // rank -> slot
  int* s_nodes = s_order + J;                            // slot -> nodes
  // slot -> end_t for a running slot, est for any other
  float* s_t = reinterpret_cast<float*>(s_nodes + J);
  int* s_lnodes = reinterpret_cast<int*>(s_t + J);       // ... their nodes
  uint8_t* s_flags = reinterpret_cast<uint8_t*>(s_lnodes + J);  // slot flags
  // after the count, the compacted arrays hold the filter's output
  int* s_cnd = s_lnodes;                                 // rank -> nodes | -1
  uint8_t* s_ca = reinterpret_cast<uint8_t*>(s_lkey);    // rank -> cond_a

  __shared__ uint32_t s_mask[kMaxJ / 32];   // candidate bits, by rank
  __shared__ int warp_tot[32];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  __shared__ int sh_head_rank;
  __shared__ int sh_started_nodes;
  __shared__ int sh_n_run;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_threads = blockDim.x;
  const int n_warps = n_threads >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * J;       // order, out
  const size_t jrow = static_cast<size_t>(blockIdx.x) * job_stride;
  const int free_start = free0[blockIdx.x * scalar_stride];
  const float now = now_in[blockIdx.x * scalar_stride];
  int limit = limit_in != nullptr ? limit_in[0] : J;
  limit = max(0, min(limit, J));

  if (tid == 0) {
    sh_head_rank = kInt32Max;
    sh_started_nodes = 0;
    sh_n_run = 0;
  }
  for (int e = tid; e < (J + 31) / 32; e += n_threads) s_mask[e] = 0u;
  // ---- load: rows into shared memory ------------------------------------
  if (vec) {
    for (int e = tid; e < J / 4; e += n_threads) {
      const int4 o = reinterpret_cast<const int4*>(order + row)[e];
      const int4 st = reinterpret_cast<const int4*>(state + jrow)[e];
      const int4 nd = reinterpret_cast<const int4*>(nodes + jrow)[e];
      const float4 es = reinterpret_cast<const float4*>(est + jrow)[e];
      const float4 en = reinterpret_cast<const float4*>(end_t + jrow)[e];
      reinterpret_cast<int4*>(s_order)[e] = o;
      reinterpret_cast<int4*>(s_nodes)[e] = nd;
      reinterpret_cast<float4*>(s_t)[e] = make_float4(
          st.x == kRunning ? en.x : es.x, st.y == kRunning ? en.y : es.y,
          st.z == kRunning ? en.z : es.z, st.w == kRunning ? en.w : es.w);
      const int s4[4] = {st.x, st.y, st.z, st.w};
      uint32_t fl = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        fl |= static_cast<uint32_t>((s4[c] == kQueued ? kFlagQueued : 0) |
                                    (s4[c] == kRunning ? kFlagRunning : 0))
              << (8 * c);
      }
      reinterpret_cast<uint32_t*>(s_flags)[e] = fl;
    }
  } else {
    for (int s = tid; s < J; s += n_threads) {
      const int st = state[jrow + s];
      s_order[s] = order[row + s];
      s_nodes[s] = nodes[jrow + s];
      s_t[s] = st == kRunning ? end_t[jrow + s] : est[jrow + s];
      s_flags[s] = (st == kQueued ? kFlagQueued : 0) |
                   (st == kRunning ? kFlagRunning : 0);
    }
  }
  __syncthreads();                                               // barrier 1

  // ---- pass 1: a queued rank starts iff its demand prefix fits free0 ----
  // Thread tid owns ranks [tid * P, tid * P + P) and, for the compaction,
  // slots of the same numbers.  It keeps each rank's slot, nodes and
  // now + est in registers for the filter.
  const int r0 = tid * P;
  int slot_p[P], nd_p[P];
  float ea_p[P];                    // now + est of the rank's slot
  unsigned queued_bits = 0, started_bits = 0;
  int local = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int r = r0 + p;
    slot_p[p] = -1;
    nd_p[p] = 0;
    ea_p[p] = 0.0f;
    if (r < limit) {
      const int slot = s_order[r];
      slot_p[p] = slot;
      if (s_flags[slot] & kFlagQueued) {
        queued_bits |= 1u << p;
        nd_p[p] = s_nodes[slot];
        ea_p[p] = __fadd_rn(now, s_t[slot]);
      }
    }
    local += nd_p[p];
  }
  const int incl = warp_incl_scan(local);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();                                               // barrier 2
  const int wincl = warp_incl_scan(lane < n_warps ? warp_tot[lane] : 0);
  const int wbefore = __shfl_sync(kFull, wincl, (warp + 31) & 31);
  int need = (warp > 0 ? wbefore : 0) + incl - local;
  int head_local = kInt32Max, started_nodes = 0, n_append = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!((queued_bits >> p) & 1u)) continue;
    need += nd_p[p];
    if (need <= free_start) {
      started_bits |= 1u << p;
      s_flags[slot_p[p]] |= kFlagStarted;
      started_nodes += nd_p[p];
      n_append += ea_p[p] < INFINITY;
    } else {
      head_local = min(head_local, r0 + p);
    }
  }
  // compaction: running and just-started jobs with an end below +inf (a
  // NaN or +inf end never counts toward a finite end, and is never
  // feasible itself, so dropping it is exact)
  float run_t[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int s = r0 + p;
    run_t[p] = INFINITY;
    if (s < J && (s_flags[s] & kFlagRunning)) run_t[p] = s_t[s];
    n_append += run_t[p] < INFINITY;
  }
  const int app_incl = warp_incl_scan(n_append);
  int app_base = 0;
  if (lane == 31 && app_incl > 0) app_base = atomicAdd(&sh_n_run, app_incl);
  int pos = __shfl_sync(kFull, app_base, 31) + app_incl - n_append;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (((started_bits >> p) & 1u) && ea_p[p] < INFINITY) {
      s_lkey[pos] = end_slot_key(ea_p[p], slot_p[p]);
      s_lnodes[pos] = nd_p[p];
      ++pos;
    }
    if (run_t[p] < INFINITY) {
      s_lkey[pos] = end_slot_key(run_t[p], r0 + p);
      s_lnodes[pos] = s_nodes[r0 + p];
      ++pos;
    }
  }
  head_local = __reduce_min_sync(kFull, head_local);
  started_nodes = __reduce_add_sync(kFull, started_nodes);
  if (lane == 0) {
    if (head_local != kInt32Max) atomicMin(&sh_head_rank, head_local);
    if (started_nodes) atomicAdd(&sh_started_nodes, started_nodes);
  }
  __syncthreads();                                               // barrier 3

  const int head_rank = sh_head_rank;
  const bool has_head = head_rank != kInt32Max;
  const int free1 = free_start - sh_started_nodes;

  if (has_head) {
    const int n_run = sh_n_run;
    const int head_slot = s_order[head_rank];
    const int head_nodes = s_nodes[head_slot];

    // ---- cum(i) = free1 + sum_j nodes(j) * [(e_j, s_j) <=lex (e_i, s_i)] --
    // tpi threads share job i's sum: a power of two, at most 32
    int tpi = 1;
    while (tpi < 32 && tpi * 2 * max(n_run, 1) <= n_threads) tpi *= 2;
    const int groups = n_threads / tpi;
    const int sub = tid & (tpi - 1);
    uint32_t my_key = kNoKey;          // the least feasible end, as a key
    int my_cum = kInt32Max;
    for (int base = 0; base < n_run; base += groups) {
      const int i = base + tid / tpi;
      int part = 0;
      uint64_t ki = 0;
      if (i < n_run) {
        ki = s_lkey[i];
#pragma unroll 4
        for (int j = sub; j < n_run; j += tpi) {
          part += s_lkey[j] <= ki ? s_lnodes[j] : 0;
        }
      }
      for (int o = 1; o < tpi; o <<= 1) part += __shfl_xor_sync(kFull, part, o);
      const uint32_t end_key = static_cast<uint32_t>(ki >> 32);
      if (i < n_run && sub == 0) {
        const int cum = free1 + part;
        if (cum >= head_nodes && end_key != kMinusInfKey) {
          my_key = min(my_key, end_key);
          my_cum = min(my_cum, cum);
        }
      }
    }
    // ---- shadow: block minima of the feasible ends and cums -------------
    float my_end = my_key == kNoKey ? INFINITY : key_to_float(my_key);
    my_end = warp_min_f(my_end);
    my_cum = __reduce_min_sync(kFull, my_cum);
    if (lane == 0) {
      red_f[warp] = my_end;
      red_i[warp] = my_cum;
    }
    __syncthreads();                                             // barrier 4
    const float shadow = warp_min_f(lane < n_warps ? red_f[lane] : INFINITY);
    const int cum_first =
        __reduce_min_sync(kFull, lane < n_warps ? red_i[lane] : kInt32Max);
    const int extra = shadow < INFINITY ? cum_first - head_nodes : 0;

    // ---- pass 2 filter: ranks (head, limit) that can still start --------
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = r0 + p;
      if (r <= head_rank || r >= limit) continue;
      int cnd = -1;
      const bool cond_a = ea_p[p] <= shadow;
      if (((queued_bits >> p) & 1u) && !((started_bits >> p) & 1u) &&
          slot_p[p] != head_slot && nd_p[p] <= free1 &&
          (cond_a || nd_p[p] <= extra)) {
        cnd = nd_p[p];
        atomicOr(&s_mask[r >> 5], 1u << (r & 31));
      }
      s_cnd[r] = cnd;
      s_ca[r] = cond_a ? 1 : 0;
    }
    __syncthreads();                                             // barrier 5

    // ---- pass 2: the EASY backfill walk, one warp, in rank order --------
    if (warp == 0) {
      const int free_end =
          head_rank + 1 < limit
              ? walk_warp(s_cnd, s_ca, s_mask, s_order, s_flags,
                          (head_rank + 1) >> 5, (limit - 1) >> 5, free1,
                          extra)
              : free1;
      if (lane == 0) free_out[blockIdx.x] = free_end;
    }
    __syncthreads();                                             // barrier 6
  } else if (tid == 0) {
    free_out[blockIdx.x] = free1;
  }

  if (vec) {
    for (int e = tid; e < J / 4; e += n_threads) {
      const uint32_t fl = reinterpret_cast<const uint32_t*>(s_flags)[e];
      reinterpret_cast<uint32_t*>(started_out + row)[e] = (fl >> 2) &
                                                          0x01010101u;
    }
  } else {
    for (int s = tid; s < J; s += n_threads) {
      started_out[row + s] = (s_flags[s] & kFlagStarted) ? 1 : 0;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int P>
int launch_p(const void* order, const void* state, const void* nodes,
             const void* est, const void* end_t, const void* free0,
             const void* now, const void* limit, void* started,
             void* free_out, int k, int J, int job_stride,
             int scalar_stride, cudaStream_t stream) {
  const int per = (J + P - 1) / P;
  const int threads = min(kMaxThreads, (per + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(kBytesPerSlot) * J;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pass_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = J % 4 == 0 && aligned16(order) && aligned16(state) &&
                  aligned16(nodes) && aligned16(est) && aligned16(end_t) &&
                  aligned16(started);
  pass_kernel<P><<<k, threads, smem, stream>>>(
      static_cast<const int*>(order), static_cast<const int*>(state),
      static_cast<const int*>(nodes), static_cast<const float*>(est),
      static_cast<const float*>(end_t), static_cast<const int*>(free0),
      static_cast<const float*>(now), static_cast<const int*>(limit),
      static_cast<uint8_t*>(started), static_cast<int*>(free_out), J,
      job_stride, scalar_stride, vec);
  return static_cast<int>(cudaGetLastError());
}

// Launch pass_kernel on `stream` for k forks of J slots: one thread per
// slot up to 1024 slots, two or four a thread above.
int launch(const void* order, const void* state, const void* nodes,
           const void* est, const void* end_t, const void* free0,
           const void* now, const void* limit, void* started,
           void* free_out, int k, int J, int job_stride, int scalar_stride,
           void* stream) {
  if (k < 0 || J <= 0 || J > kMaxJ) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J <= kMaxThreads) {
    return launch_p<1>(order, state, nodes, est, end_t, free0, now, limit,
                       started, free_out, k, J, job_stride, scalar_stride, s);
  }
  if (J <= 2 * kMaxThreads) {
    return launch_p<2>(order, state, nodes, est, end_t, free0, now, limit,
                       started, free_out, k, J, job_stride, scalar_stride, s);
  }
  return launch_p<4>(order, state, nodes, est, end_t, free0, now, limit,
                     started, free_out, k, J, job_stride, scalar_stride, s);
}

}  // namespace

extern "C" {

// The largest job-table capacity J the kernel takes.
int policy_eval_max_j(void) { return kMaxJ; }

// Launch K1 on `stream`.  All (k, J) arrays are contiguous rows:
// order/state/nodes int32, est/end_t float32; free0 int32 (k,), now
// float32 (k,), limit int32 (1,) or NULL for J.  Writes started (k, J)
// bytes (0/1) and free_out int32 (k,).  Returns cudaGetLastError()
// after the launch (0 on success).
int policy_eval_pass_batched(const void* order, const void* state,
                             const void* nodes, const void* est,
                             const void* end_t, const void* free0,
                             const void* now, const void* limit,
                             void* started, void* free_out, int k, int J,
                             void* stream) {
  return launch(order, state, nodes, est, end_t, free0, now, limit, started,
                free_out, k, J, J, 1, stream);
}

// Launch K1' on `stream`: the same pass for k forks of one shared
// snapshot.  order (k, J) int32 contiguous; state/nodes int32 and
// est/end_t float32 (J,); free0 int32 and now float32 of one element;
// limit as above.  Writes started (k, J) bytes and free_out int32 (k,).
int policy_eval_pass(const void* order, const void* state, const void* nodes,
                     const void* est, const void* end_t, const void* free0,
                     const void* now, const void* limit, void* started,
                     void* free_out, int k, int J, void* stream) {
  return launch(order, state, nodes, est, end_t, free0, now, limit, started,
                free_out, k, J, 0, 0, stream);
}

}  // extern "C"
