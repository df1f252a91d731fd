// The drain's step: after K1's pass, each fork's starts, its advance to
// its next predicted end and the next iteration's rank limit, in one
// launch.
//
// Replaces no TPU kernel.  The JAX package runs these ops inside the
// drain's lax.while_loop (repro/core/des.py), where XLA fuses them; the
// port ran them as ~50 PyTorch kernels an iteration (core/des.py::
// apply_starts, _advance, pass_rank_limit and the loop's active and
// iters lines), most of the drain's kernels and of the host's dispatch.
// The plain PyTorch version is
// repro_torch/kernels/drain_step.py::drain_step_plain, whose results it
// gives bit for bit.
//
// Per fork f of k, over its J slots, given K1's started mask:
//   * started &= active[f], in K1's own buffer: a row of zeros where the
//     fork is not active, the row as it is where it is;
//   * the starts: start_t = now, end_t = now + est (one rounding, no
//     contraction), state = RUNNING, free_nodes less the started nodes;
//   * the advance: t_next = max(min end_t over RUNNING slots, now), +inf
//     where nothing runs and NaN where either is NaN (torch's amin and
//     maximum); a fork with a queued job and a finite t_next moves to it
//     and retires every RUNNING slot with end_t <= t_next (DONE, its nodes
//     back to free_nodes); one with a queued job and no finite t_next is
//     dead;
//   * iters += 1; active = !dead && a slot is QUEUED; an active fork's
//     queued count goes into limit by atomicMax.  The launch zeroes limit
//     first, with a memset on the same stream, after K1 has read it.
// Integer sums wrap as torch's int32 sums do, and sums of integers,
// counts, min and max do not depend on their order, so neither does the
// result.  The one exception is a min over ends of +0.0 and -0.0, whose
// sign torch's reduction leaves to its own order too.
//
// A fork that is not active changes nowhere but its started row, as the
// loop keeps active[f] == !dead[f] && a slot is QUEUED: a dead fork stays
// dead, and one with nothing queued gets nothing queued.  Its state is
// not read.
//
// What bounds it on an H100: bytes.  An active fork reads a started byte
// and a state word a slot, the estimate and node count of a started slot
// and the end of a running one, and writes what changes; a fork that is
// not active writes its started row.  Read whole, the five tables are
// 17 B a slot (started, state, nodes, est, end_t): 142.6 MB, 42.6 us at
// 3.35 TB/s at the Polaris drain's shape (k = 8,192, J = 1,024); the
// least bytes of its real iterations are ~48 MB, ~14 us.  What keeps it
// from that bound is latency: each fork waits on its row's loads, then
// on the ends of its running jobs, then on its barriers.  So the design
// keeps as many forks in flight as the card holds threads:
//   * eight slots a thread, strided (thread i reads slots c·T + i, so
//     every load is coalesced), their loads in flight together; a thread
//     keeps its slots' ends in registers and which of them run as a
//     bitmask, and reads a node count again only where a job ends;
//   * T = J / 8 threads a fork, rounded up to a power of two: a warp a
//     fork at J <= 256 (eight forks a block, reductions by shuffles
//     alone), a block of 64 to 512 threads a fork above (shuffles, then
//     one pass through shared memory); 2,048 threads an SM, so at most
//     32 registers a thread.  On an H100 at the Polaris shape this took
//     35-47 us a launch, against 80-104 us for a block of 256 threads
//     a fork holding four slots a thread in registers at half the
//     occupancy, and 37-57 us for a warp a fork at every J.  The layout
//     is chosen from J alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxJ = 4096;
constexpr int kPer = 8;                  // slots a thread
constexpr int kQueued = 1;               // lifecycle codes, core/state.py
constexpr int kRunning = 2;
constexpr int kDone = 3;
constexpr unsigned kFull = 0xffffffffu;

// What a fork's first pass adds up over its slots after the starts.
struct Fold {
  unsigned started_nodes;  // an int32 sum, wrapping: added unsigned
  int queued;              // QUEUED slots
  float min_end;           // least end of a RUNNING slot, NaNs left out
  int nan_end;             // a RUNNING slot ends at NaN
};

__device__ __forceinline__ Fold fold(Fold a, Fold b) {
  return {a.started_nodes + b.started_nodes, a.queued + b.queued,
          fminf(a.min_end, b.min_end), a.nan_end | b.nan_end};
}

__device__ __forceinline__ Fold warp_fold(Fold v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Fold w{__shfl_xor_sync(kFull, v.started_nodes, o),
                 __shfl_xor_sync(kFull, v.queued, o),
                 __shfl_xor_sync(kFull, v.min_end, o),
                 __shfl_xor_sync(kFull, v.nan_end, o)};
    v = fold(v, w);
  }
  return v;
}

// kThreads threads a fork, kBlock threads a block (kThreads, or 256 when
// a warp takes a fork).
template <int kThreads, int kBlock>
__global__ void __launch_bounds__(kBlock, 2048 / kBlock) step_kernel(
    uint8_t* __restrict__ started, int* __restrict__ state,
    const int* __restrict__ nodes, const float* __restrict__ est,
    float* __restrict__ start_t, float* __restrict__ end_t,
    int* __restrict__ free_nodes, float* __restrict__ now,
    uint8_t* __restrict__ active, uint8_t* __restrict__ dead,
    int* __restrict__ iters, int* __restrict__ limit, int k, int J) {
  constexpr int kWarps = kThreads / 32;
  __shared__ Fold part[kWarps];
  __shared__ unsigned freed_part[kWarps];
  const int t = threadIdx.x % kThreads;
  const int f = blockIdx.x * (kBlock / kThreads) + threadIdx.x / kThreads;
  // kThreads == kBlock: one fork a block, so the block returns whole here
  if (f >= k) return;
  const long long row = static_cast<long long>(f) * J;
  if (!active[f]) {
    for (int s = t; s < J; s += kThreads) started[row + s] = 0;
    return;
  }
  const float t_now = now[f];
  int free0 = 0, it0 = 0;                // the fork's scalars, loaded early
  bool dead0 = false;
  if (t == 0) {
    free0 = free_nodes[f];
    it0 = iters[f];
    dead0 = dead[f];
  }

  // ---- the starts, and the fold over the table they leave ------------
  int code[kPer];
  uint8_t go[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = i * kThreads + t;
    code[i] = s < J ? state[row + s] : 0;
    go[i] = s < J ? started[row + s] : 0;
  }
  float end[kPer];
  unsigned run = 0;                      // bit i: slot i runs
  Fold v{0u, 0, INFINITY, 0};
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = i * kThreads + t;
    end[i] = 0.0f;
    if (go[i]) {
      end[i] = __fadd_rn(t_now, est[row + s]);
      v.started_nodes += static_cast<unsigned>(nodes[row + s]);
      start_t[row + s] = t_now;
      end_t[row + s] = end[i];
      state[row + s] = kRunning;
      code[i] = kRunning;
    } else if (code[i] == kRunning) {
      end[i] = end_t[row + s];
    }
    if (code[i] == kRunning) {
      run |= 1u << i;
      if (isnan(end[i])) {
        v.nan_end = 1;
      } else {
        v.min_end = fminf(v.min_end, end[i]);
      }
    }
    v.queued += code[i] == kQueued;
  }
  v = warp_fold(v);
  if constexpr (kWarps > 1) {
    if (t % 32 == 0) part[t / 32] = v;
    __syncthreads();
    v = part[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fold(v, part[w]);
  }

  // ---- the advance ----------------------------------------------------
  const bool has_queued = v.queued > 0;
  const float least = v.nan_end ? NAN : v.min_end;
  const float t_next = isnan(least) || isnan(t_now) ? NAN
                                                    : fmaxf(least, t_now);
  const bool finite = isfinite(t_next);
  const bool advance = has_queued && finite;
  unsigned freed = 0;
  if (advance) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = i * kThreads + t;
      if ((run >> i & 1u) && end[i] <= t_next) {
        freed += static_cast<unsigned>(nodes[row + s]);
        state[row + s] = kDone;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) freed += __shfl_xor_sync(kFull, freed, o);
  if constexpr (kWarps > 1) {
    if (t % 32 == 0) freed_part[t / 32] = freed;
    __syncthreads();
    freed = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) freed += freed_part[w];
  }

  // ---- the fork's scalars and the next rank limit ---------------------
  if (t == 0) {
    free_nodes[f] = static_cast<int>(static_cast<unsigned>(free0) -
                                     v.started_nodes + freed);
    if (advance) now[f] = t_next;
    const bool is_dead = dead0 || (has_queued && !finite);
    dead[f] = is_dead;
    iters[f] = it0 + 1;
    const bool next = !is_dead && has_queued;
    active[f] = next;
    if (next) atomicMax(limit, v.queued);
  }
}
}  // namespace

extern "C" {

// The largest job-table capacity J the kernel takes.
int drain_step_max_j(void) { return kMaxJ; }

// Launch the step on `stream`, after zeroing limit there.  started, active
// and dead are bool (one byte each): started (k, J), active and dead
// (k,); state, nodes int32 and est, start_t, end_t float32, (k, J)
// contiguous rows; free_nodes and iters int32 (k,); now float32 (k,);
// limit int32 (1,).  Updates started, state, start_t, end_t, free_nodes,
// now, active, dead, iters and limit in place.  Returns
// cudaGetLastError() after the launch (0 on success).
int drain_step(void* started, void* state, const void* nodes,
               const void* est, void* start_t, void* end_t,
               void* free_nodes, void* now, void* active, void* dead,
               void* iters, void* limit, int k, int J, void* stream) {
  if (k < 0 || J <= 0 || J > kMaxJ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(limit, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k == 0) return 0;
#define STEP_ARGS                                                        \
  static_cast<uint8_t*>(started), static_cast<int*>(state),              \
      static_cast<const int*>(nodes), static_cast<const float*>(est),    \
      static_cast<float*>(start_t), static_cast<float*>(end_t),          \
      static_cast<int*>(free_nodes), static_cast<float*>(now),           \
      static_cast<uint8_t*>(active), static_cast<uint8_t*>(dead),        \
      static_cast<int*>(iters), static_cast<int*>(limit), k, J
  if (J <= 32 * kPer) {
    step_kernel<32, 256><<<(k + 7) / 8, 256, 0, s>>>(STEP_ARGS);
  } else if (J <= 64 * kPer) {
    step_kernel<64, 64><<<k, 64, 0, s>>>(STEP_ARGS);
  } else if (J <= 128 * kPer) {
    step_kernel<128, 128><<<k, 128, 0, s>>>(STEP_ARGS);
  } else if (J <= 256 * kPer) {
    step_kernel<256, 256><<<k, 256, 0, s>>>(STEP_ARGS);
  } else {
    step_kernel<512, 512><<<k, 512, 0, s>>>(STEP_ARGS);
  }
#undef STEP_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
