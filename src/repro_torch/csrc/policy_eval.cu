// K1: one greedy + EASY-backfill scheduling pass per what-if fork.
//
// Replaces repro/kernels/policy_eval.py::_pass_kernel (the Pallas TPU
// kernel behind the JAX engine's "pallas" backend).  Semantics follow
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
// 3.35 TB/s).  The work is (a) the O(R^2) lexicographic count over the
// R running and just-started jobs of a fork, and (b) the backfill walk,
// a chain of dependent steps through `free` and `extra`.  Neither is a
// throughput problem at these sizes: the kernel is bound by latency
// (block-wide barriers and the serial walk), not by bytes or operations.
// What the design does about each:
//   * one block per fork (grid = k), the fork's rows in shared memory
//     (29 bytes per slot), so every later step reads on-chip memory only;
//   * pass 1 is the reference's closed form: a block-wide int32 prefix
//     sum over ranks [0, limit) and a min-reduce for the head rank;
//   * the running set is compacted first (finite ends only, in slot
//     order), so the count is R^2 instead of J^2, split over 256 threads
//     with broadcast shared-memory reads, then two block min-reductions
//     give `shadow` and the first feasible `cum`;
//   * the walk visits only ranks that can still start: `free` and
//     `extra` never rise, so a rank that does not fit `free1`, or fails
//     both conditions at the initial `extra`, is dropped by a parallel
//     filter before one thread walks the survivors in rank order.
// A later change may make the walk warp-parallel; this one is simple.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJ = 4096;              // 29 * 4096 B = 116 KiB of shared memory
constexpr int kBytesPerSlot = 29;
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

// Block-wide inclusive scan of one int per thread.  Every thread of the
// block must call it.  Returns the inclusive prefix; *total gets the sum.
__device__ int block_incl_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = warp_incl_scan(v);
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_tot[lane] : 0;
    t = warp_incl_scan(t);
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_tot[warp - 1] : 0;
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return x + before;
}

__device__ float block_min_f(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fminf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ int block_min_i(int v, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = min(r, red[w]);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
pass_kernel(const int* __restrict__ order, const int* __restrict__ state,
            const int* __restrict__ nodes, const float* __restrict__ est,
            const float* __restrict__ end_t, const int* __restrict__ free0,
            const float* __restrict__ now_in,
            const int* __restrict__ limit_in,
            uint8_t* __restrict__ started_out, int* __restrict__ free_out,
            int J) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_order = reinterpret_cast<int*>(smem);           // rank -> slot
  int* s_nodes = s_order + J;                            // slot -> nodes
  float* s_est = reinterpret_cast<float*>(s_nodes + J);  // slot -> est
  float* s_end = s_est + J;                              // slot -> end_t
  float* s_lend = s_end + J;     // compacted running ends (slot order)
  int* s_lnodes = reinterpret_cast<int*>(s_lend + J);    // ... their nodes
  int* s_cand = s_lnodes + J;    // backfill candidates (slots, rank order)
  uint8_t* s_flags = reinterpret_cast<uint8_t*>(s_cand + J);  // slot flags

  __shared__ int warp_tot[kWarps];
  __shared__ float red_f[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int sh_head_rank;
  __shared__ int sh_started_nodes;

  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * J;
  const int free_start = free0[blockIdx.x];
  const float now = now_in[blockIdx.x];
  int limit = limit_in != nullptr ? limit_in[0] : J;
  limit = max(0, min(limit, J));

  if (tid == 0) {
    sh_head_rank = kInt32Max;
    sh_started_nodes = 0;
  }
  for (int s = tid; s < J; s += kThreads) {
    const int st = state[row + s];
    s_order[s] = order[row + s];
    s_nodes[s] = nodes[row + s];
    s_est[s] = est[row + s];
    s_end[s] = end_t[row + s];
    s_flags[s] = (st == kQueued ? kFlagQueued : 0) |
                 (st == kRunning ? kFlagRunning : 0);
  }
  __syncthreads();

  // ---- pass 1: a queued rank starts iff its demand prefix fits free0 ----
  int carry = 0;
  for (int base = 0; base < limit; base += kThreads) {
    const int r = base + tid;
    int slot = -1;
    int v = 0;
    bool queued = false;
    if (r < limit) {
      slot = s_order[r];
      queued = (s_flags[slot] & kFlagQueued) != 0;
      v = queued ? s_nodes[slot] : 0;
    }
    int total;
    const int need = carry + block_incl_scan(v, warp_tot, &total);
    if (queued) {
      if (need <= free_start) {
        s_flags[slot] |= kFlagStarted;
        atomicAdd(&sh_started_nodes, v);
      } else {
        atomicMin(&sh_head_rank, r);
      }
    }
    carry += total;
  }
  __syncthreads();

  const int head_rank = sh_head_rank;
  const bool has_head = head_rank != kInt32Max;
  const int free1 = free_start - sh_started_nodes;
  const int head_slot = has_head ? s_order[head_rank] : -1;
  const int head_nodes = has_head ? s_nodes[head_slot] : 0;

  float shadow = INFINITY;
  int extra = kInt32Max / 2;  // no head: unconstrained
  if (has_head) {
    // ---- compact running + just-started jobs with an end below +inf ----
    // (a NaN or +inf end never counts toward a finite end, and is never
    // feasible itself, so dropping it is exact)
    int n_run = 0;
    for (int base = 0; base < J; base += kThreads) {
      const int s = base + tid;
      bool keep = false;
      float e = 0.0f;
      int nd = 0;
      if (s < J) {
        const uint8_t fl = s_flags[s];
        if (fl & (kFlagRunning | kFlagStarted)) {
          e = (fl & kFlagStarted) ? __fadd_rn(now, s_est[s]) : s_end[s];
          keep = e < INFINITY;
          nd = s_nodes[s];
        }
      }
      int total;
      const int pos = n_run + block_incl_scan(keep ? 1 : 0, warp_tot, &total) - 1;
      if (keep) {
        s_lend[pos] = e;
        s_lnodes[pos] = nd;
      }
      n_run += total;
    }
    __syncthreads();

    // ---- cum(i) = free1 + sum_j nodes(j) * [(e_j, j) <=lex (e_i, i)] ----
    float my_end = INFINITY;
    int my_cum = kInt32Max;
    for (int i = tid; i < n_run; i += kThreads) {
      const float ei = s_lend[i];
      int cum = free1;
      for (int j = 0; j < n_run; ++j) {
        const float ej = s_lend[j];
        cum += (ej < ei || (ej == ei && j <= i)) ? s_lnodes[j] : 0;
      }
      if (cum >= head_nodes && isfinite(ei)) {
        my_end = fminf(my_end, ei);
        my_cum = min(my_cum, cum);
      }
    }
    shadow = block_min_f(my_end, red_f);
    const int cum_first = block_min_i(my_cum, red_i);
    extra = shadow < INFINITY ? cum_first - head_nodes : 0;
  }

  // ---- pass 2 filter: ranks (head, limit) that can still start ----------
  int n_cand = 0;
  if (has_head) {
    for (int base = head_rank + 1; base < limit; base += kThreads) {
      const int r = base + tid;
      bool keep = false;
      int slot = -1;
      if (r < limit) {
        slot = s_order[r];
        const uint8_t fl = s_flags[slot];
        if ((fl & kFlagQueued) && !(fl & kFlagStarted) && slot != head_slot) {
          const int nd = s_nodes[slot];
          const bool cond_a = __fadd_rn(now, s_est[slot]) <= shadow;
          keep = nd <= free1 && (cond_a || nd <= extra);
        }
      }
      int total;
      const int pos = n_cand + block_incl_scan(keep ? 1 : 0, warp_tot, &total) - 1;
      if (keep) s_cand[pos] = slot;
      n_cand += total;
    }
  }
  __syncthreads();

  // ---- pass 2: the EASY backfill walk, in rank order ----------------------
  if (tid == 0) {
    int free_now = free1;
    int extra_now = extra;
    for (int c = 0; c < n_cand; ++c) {
      const int slot = s_cand[c];
      const int nd = s_nodes[slot];
      const bool cond_a = __fadd_rn(now, s_est[slot]) <= shadow;
      if (nd <= free_now && (cond_a || nd <= extra_now)) {
        free_now -= nd;
        if (!cond_a) extra_now -= nd;
        s_flags[slot] |= kFlagStarted;
      }
    }
    free_out[blockIdx.x] = free_now;
  }
  __syncthreads();

  for (int s = tid; s < J; s += kThreads) {
    started_out[row + s] = (s_flags[s] & kFlagStarted) ? 1 : 0;
  }
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
  if (k < 0 || J <= 0 || J > kMaxJ) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return 0;
  const size_t smem = static_cast<size_t>(kBytesPerSlot) * J;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pass_kernel<<<k, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const int*>(state),
      static_cast<const int*>(nodes), static_cast<const float*>(est),
      static_cast<const float*>(end_t), static_cast<const int*>(free0),
      static_cast<const float*>(now), static_cast<const int*>(limit),
      static_cast<uint8_t*>(started), static_cast<int*>(free_out), J);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
