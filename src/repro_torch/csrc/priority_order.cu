// The order stage of the drain and the replay: every fork's priority
// order of its job slots, in one launch, in fork order.
//
// Replaces no TPU kernel.  The JAX package leaves this stage to XLA
// (repro/core/engine.py: keys, a stable argsort, and for forks whose keys
// never depend on the clock a compaction of an order hoisted out of the
// loop); the port ran it as ~80 PyTorch ops a step (core/engine.py::
// make_order_fn, core/backfill.py::priority_order,
// core/policies.py::priority_key_spec), which were most of the drain's
// kernels and of the host's dispatch.  The plain PyTorch version is
// repro_torch/kernels/priority_order.py::priority_order_plain.
//
// Per fork f of k, over its J slots:
//   * hoist_row[f] >= 0: the static order hoisted[hoist_row[f]] (a
//     permutation of the slots) stably partitioned, QUEUED slots first
//     (backfill.py::compact_queued_first);
//   * hoist_row[f] < 0: the slots in stable ascending order of their key,
//     policies.priority_key_spec where the slot is QUEUED and +inf
//     elsewhere (backfill.py::priority_order).  The order is the one
//     torch.argsort(stable=True) gives on the card, checked there
//     (tests/test_torch_cuda.py): -0.0 ties +0.0, -inf first, +inf after
//     every finite key, NaN last, ties in slot order.
//
// The keys are bitwise those of torch's CUDA ops (ROADMAP C3): the same
// operations in the same order, each rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, IEEE division; powf, expf and expm1f from
// libdevice; nothing contracted into an FMA), torch's clamp (NaN passes,
// else fmaxf/fminf), exact products for the exponents 1, 2 and 3, and
// the linear term summed left to right over the six features.  Family 3
// is the integer-id EXPF row, which ages by the reciprocal product torch
// uses when it divides a CUDA tensor by a host scalar (wait / 3600.0).
//
// What bounds it on an H100: bytes.  A re-sorted fork reads 16 B a slot
// (state, submit, estimate, nodes), a hoisted fork 8 B (its static row
// and its state), and each writes 4 B: 159.4 MB, 47.6 us at 3.35 TB/s, at
// the Polaris drain's shape (7,168 re-sorted and 1,024 hoisted forks of
// J = 1,024), 184.5 MB at the farm's (16,384 and 32,768 of J = 256).  The
// sort is the work that can keep it from that bound.  The design:
//   * one warp per fork, four forks a block: no block barrier, and J
//     (1,024 on Polaris, 256 on the farm) sets only the chunk count;
//   * slots in chunks of 32, one a lane, so every load is coalesced, with
//     four chunks' loads in flight (on an H100, a Polaris-shaped call
//     with 5% of the slots queued: two chunks 104.9 us, four 99.2, eight
//     173.0, their registers cutting the occupancy); the keys are
//     computed in registers;
//   * only the keys that are neither +inf nor NaN are sorted: a fork
//     compacts them (ballot counts) as 64-bit words (ordered key bits,
//     slot) into shared memory, pads them to the next power of two P and
//     sorts them with a bitonic network, so a fork pays for its queued
//     jobs, not for J.  The network runs in registers on blocks of 256
//     words, 8 a lane (strides below 32 by shuffles, the others inside a
//     lane); only its strides of 256 and more pass through shared
//     memory.  Run wholly in shared memory it is bound by that memory's
//     bandwidth (500 against 327 us a call with 65% queued), and with up
//     to 32 words a lane in registers the kernel needs 168 registers a
//     thread, which cuts its occupancy (424 us).  The +inf slots (every
//     slot that is not queued) and then the NaN slots follow in slot
//     order, placed by ballot counts over a byte a slot;
//   * a hoisted fork keeps a queued byte a slot in shared memory and
//     places its static row's ranks with one ballot count a chunk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxJ = 4096;
constexpr int kWarps = 4;                // forks a block
constexpr int kQueued = 1;               // lifecycle code, core/state.py
constexpr int kNTheta = 9;               // policies.N_THETA
constexpr int kThA = 6;                  // policies.TH_A, TH_B, TH_TAU
constexpr int kThB = 7;
constexpr int kThTau = 8;
constexpr int kFamWfp = 1;               // policies.FAM_WFP, FAM_EXP
constexpr int kFamExp = 2;
constexpr int kFamExpfId = 3;            // kernels/priority_order.py
constexpr float kAgingCap = 30.0f;       // policies.AGING_CAP
constexpr float kEstFloor = 1.0f;        // policies._EST_FLOOR
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kTagSorted = 0;
constexpr uint8_t kTagInf = 1;
constexpr uint8_t kTagNaN = 2;

// torch's clamp_min / clamp_max on the card: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// policies._pow: exact products for the exponents 1, 2 and 3
__device__ __forceinline__ float pow_exact(float x, float p) {
  if (p == 1.0f) return x;
  if (p == 2.0f) return __fmul_rn(x, x);
  if (p == 3.0f) return __fmul_rn(__fmul_rn(x, x), x);
  return powf(x, p);
}

// policies.priority_key_spec for one slot of one fork
__device__ __forceinline__ float priority_key(float now, float submit,
                                              float est_rt, int nodes_i,
                                              int family,
                                              const float (&th)[kNTheta]) {
  const float wait = clamp_min(__fsub_rn(now, submit), 0.0f);
  const float est = clamp_min(est_rt, kEstFloor);
  const float nodes = __int2float_rn(nodes_i);
  const float area = __fmul_rn(nodes, est);
  const float xfactor = __fdiv_rn(__fadd_rn(wait, est), est);
  float lin = __fmul_rn(wait, th[0]);
  lin = __fadd_rn(lin, __fmul_rn(est, th[1]));
  lin = __fadd_rn(lin, __fmul_rn(nodes, th[2]));
  lin = __fadd_rn(lin, __fmul_rn(area, th[3]));
  lin = __fadd_rn(lin, __fmul_rn(xfactor, th[4]));
  lin = __fadd_rn(lin, __fmul_rn(submit, th[5]));
  float nl = 0.0f;
  if (family == kFamWfp || family == kFamExp || family == kFamExpfId) {
    const float scaled = family == kFamExpfId
        ? __fmul_rn(wait, __frcp_rn(th[kThTau]))
        : __fdiv_rn(wait, th[kThTau]);
    const float aged = clamp_max(scaled, kAgingCap);
    if (family == kFamWfp) {
      nl = -__fmul_rn(__fmul_rn(pow_exact(__fdiv_rn(wait, est), th[kThA]),
                                pow_exact(nodes, th[kThB])),
                      expf(aged));
    } else {
      nl = -expm1f(aged);
    }
  }
  return __fadd_rn(lin, nl);
}

// (key, slot) as one word whose unsigned order is the sort's: the key's
// bits mapped so that integer order is float order, -0.0 first made
// +0.0, then the slot.  Only keys that are neither +inf nor NaN come
// here, so every word is below ~0, the padding.
__device__ __forceinline__ uint64_t sort_word(float key, int slot) {
  uint32_t u = __float_as_uint(key);
  if (u == 0x80000000u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(slot);
}

// Stages of an ascending bitonic network over P words, run on the 32 E
// words of buf[base, base + 32 E) in registers (element e of lane l is
// index base + 32 e + l): the phases size_lo..size_hi, in each the
// strides below min(size, 32 E).  Strides below 32 exchange between
// lanes (shuffles), the others inside a lane.  The words are written back
// unless out is given: then the slots of the first n are written there.
template <int E>
__device__ void network_regs(uint64_t* buf, int base, int size_lo,
                             int size_hi, int lane, int* out = nullptr,
                             int n = 0) {
  uint64_t v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = buf[base + (e << 5) + lane];
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    for (int stride = min(size, 32 * E) >> 1; stride > 0; stride >>= 1) {
      if (stride < 32) {
        const bool lower = (lane & stride) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const uint64_t y = __shfl_xor_sync(kFull, v[e], stride);
          const bool up = ((base + (e << 5) + lane) & size) == 0;
          v[e] = (lower == up) == (v[e] < y) ? v[e] : y;
        }
      } else {
        const int S = stride >> 5;
#pragma unroll
        for (int e = 0; e < E; ++e) {
#pragma unroll
          for (int t = 1; t < E; t <<= 1) {   // S, as a constant
            if (t != S || (e & t)) continue;
            const bool up = ((base + (e << 5) + lane) & size) == 0;
            const uint64_t x = v[e];
            const uint64_t y = v[e + t];
            const bool swap = (x > y) == up;
            v[e] = swap ? y : x;
            v[e + t] = swap ? x : y;
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = base + (e << 5) + lane;
    if (out == nullptr) {
      buf[i] = v[e];
    } else if (i < n) {
      out[i] = static_cast<int>(static_cast<uint32_t>(v[e]));
    }
  }
}

// One stage (size, stride) of the network over buf[0, P) in shared
// memory, for strides of 256 and more.
__device__ void stage_shared(uint64_t* a, int P, int size, int stride,
                             int lane) {
  for (int p = lane; p < (P >> 1); p += 32) {
    const int lo = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
    const int hi = lo + stride;
    const uint64_t x = a[lo];
    const uint64_t y = a[hi];
    if ((x > y) == ((lo & size) == 0)) {
      a[lo] = y;
      a[hi] = x;
    }
  }
}

// Sort buf[0, P) ascending (P a power of two, 32 to 4,096) and write the
// slots of the first n words to out.  Up to 256 words the network runs in
// registers alone; above, in blocks of 256 in registers with the strides
// of 256 and more as passes over shared memory.
__device__ void sort_and_write(uint64_t* buf, int P, int n, int* out,
                               int lane) {
  switch (P) {
    case 32: network_regs<1>(buf, 0, 2, 32, lane, out, n); return;
    case 64: network_regs<2>(buf, 0, 2, 64, lane, out, n); return;
    case 128: network_regs<4>(buf, 0, 2, 128, lane, out, n); return;
    case 256: network_regs<8>(buf, 0, 2, 256, lane, out, n); return;
    default: break;
  }
  for (int b = 0; b < P; b += 256) network_regs<8>(buf, b, 2, 256, lane);
  for (int size = 512; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride >= 256; stride >>= 1) {
      __syncwarp();
      stage_shared(buf, P, size, stride, lane);
    }
    __syncwarp();
    for (int b = 0; b < P; b += 256) {
      network_regs<8>(buf, b, size, size, lane);
    }
  }
  __syncwarp();
  for (int r = lane; r < n; r += 32) {
    out[r] = static_cast<int>(static_cast<uint32_t>(buf[r]));
  }
}

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// A warp's shared memory: the sort's words (at least 32, the register
// sort's least) and a byte a slot.
__device__ __forceinline__ int sort_cap(int J) {
  return next_pow2(J < 32 ? 32 : J);
}

__device__ __forceinline__ size_t warp_bytes(int J) {
  return static_cast<size_t>(sort_cap(J)) * 8 + ((J + 15) & ~15);
}

constexpr int kBatch = 4;                // chunks whose loads are in flight

__global__ void __launch_bounds__(kWarps * 32)
order_kernel(const int* __restrict__ state, const float* __restrict__ submit,
             const float* __restrict__ est, const int* __restrict__ nodes,
             const float* __restrict__ now, const int* __restrict__ family,
             const float* __restrict__ theta,
             const int* __restrict__ hoisted,
             const int* __restrict__ hoist_row, int* __restrict__ out, int k,
             int J) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long f = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (f >= k) return;
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem + warp * warp_bytes(J));
  uint8_t* tag = reinterpret_cast<uint8_t*>(buf + sort_cap(J));
  const size_t row = static_cast<size_t>(f) * J;
  const unsigned below = (1u << lane) - 1u;
  const int chunks = (J + 31) >> 5;

  const int hrow = hoist_row[f];
  if (hrow >= 0) {                        // a hoisted fork: compaction
    int n_queued = 0;
    for (int c0 = 0; c0 < chunks; c0 += kBatch) {
      int st[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = ((c0 + u) << 5) + lane;
        st[u] = s < J ? state[row + s] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = ((c0 + u) << 5) + lane;
        const bool q = st[u] == kQueued;
        if (s < J) tag[s] = q;
        n_queued += __popc(__ballot_sync(kFull, q));
      }
    }
    __syncwarp();
    const int* ranked = hoisted + static_cast<size_t>(hrow) * J;
    int before = 0;                       // queued ranks before the chunk
    for (int c0 = 0; c0 < chunks; c0 += kBatch) {
      int slot[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = ((c0 + u) << 5) + lane;
        slot[u] = r < J ? ranked[r] : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = ((c0 + u) << 5) + lane;
        const bool q = slot[u] >= 0 && tag[slot[u]] != 0;
        const unsigned b = __ballot_sync(kFull, q);
        const int qb = before + __popc(b & below);
        if (r < J) out[row + (q ? qb : n_queued + r - qb)] = slot[u];
        before += __popc(b);
      }
    }
    return;
  }

  // a re-sorted fork: keys, then the sort
  float th[kNTheta];
#pragma unroll
  for (int i = 0; i < kNTheta; ++i) th[i] = theta[f * kNTheta + i];
  const int fam = family[f];
  const float t = now[f];
  int n = 0;                              // keys to sort
  int n_inf = 0;                          // +inf keys
  for (int c0 = 0; c0 < chunks; c0 += kBatch) {
    int st[kBatch], nd[kBatch];
    float sb[kBatch], es[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = ((c0 + u) << 5) + lane;
      const bool valid = s < J;
      st[u] = valid ? state[row + s] : 0;
      sb[u] = valid ? submit[row + s] : 0.0f;
      es[u] = valid ? est[row + s] : 0.0f;
      nd[u] = valid ? nodes[row + s] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = ((c0 + u) << 5) + lane;
      const bool valid = s < J;
      const float key = st[u] == kQueued
          ? priority_key(t, sb[u], es[u], nd[u], fam, th)
          : __int_as_float(0x7f800000);                 // +inf
      const bool is_nan = valid && isnan(key);
      const bool is_inf = valid && key == __int_as_float(0x7f800000);
      const bool sorted = valid && !is_nan && !is_inf;
      const unsigned bs = __ballot_sync(kFull, sorted);
      if (sorted) buf[n + __popc(bs & below)] = sort_word(key, s);
      if (valid) {
        tag[s] = is_nan ? kTagNaN : (is_inf ? kTagInf : kTagSorted);
      }
      n += __popc(bs);
      n_inf += __popc(__ballot_sync(kFull, is_inf));
    }
  }
  const int P = next_pow2(n < 32 ? 32 : n);
  for (int i = n + lane; i < P; i += 32) buf[i] = ~0ull;
  __syncwarp();
  int* out_row = out + row;
  sort_and_write(buf, P, n, out_row, lane);
  int done_inf = 0;                       // +inf and NaN slots placed
  int done_nan = 0;
  for (int c = 0; c < chunks; ++c) {
    const int s = (c << 5) + lane;
    const uint8_t g = s < J ? tag[s] : kTagSorted;
    const unsigned bi = __ballot_sync(kFull, g == kTagInf);
    const unsigned bn = __ballot_sync(kFull, g == kTagNaN);
    if (g == kTagInf) {
      out_row[n + done_inf + __popc(bi & below)] = s;
    } else if (g == kTagNaN) {
      out_row[n + n_inf + done_nan + __popc(bn & below)] = s;
    }
    done_inf += __popc(bi);
    done_nan += __popc(bn);
  }
}

// The keys alone, one thread a slot: for the checks of C3.
__global__ void keys_kernel(const int* __restrict__ state,
                            const float* __restrict__ submit,
                            const float* __restrict__ est,
                            const int* __restrict__ nodes,
                            const float* __restrict__ now,
                            const int* __restrict__ family,
                            const float* __restrict__ theta,
                            float* __restrict__ keys, long long total,
                            int J) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const long long f = i / J;
  float th[kNTheta];
#pragma unroll
  for (int c = 0; c < kNTheta; ++c) th[c] = theta[f * kNTheta + c];
  keys[i] = state[i] == kQueued
      ? priority_key(now[f], submit[i], est[i], nodes[i], family[f], th)
      : __int_as_float(0x7f800000);
}

size_t host_warp_bytes(int J) {
  size_t p = 32;
  while (p < static_cast<size_t>(J)) p <<= 1;
  return p * 8 + ((J + 15) & ~15);
}

}  // namespace

extern "C" {

// The largest job-table capacity J the kernel takes.
int priority_order_max_j(void) { return kMaxJ; }

// Launch the order stage on `stream`.  state, nodes int32 and submit, est
// float32, all (k, J) contiguous rows; now float32 (k,); family int32
// (k,); theta float32 (k, 9); hoisted int32 (n_hoisted, J) (NULL when no
// fork is hoisted); hoist_row int32 (k,): a row of hoisted, or -1 for a
// re-sorted fork.  Writes out int32 (k, J).  Returns cudaGetLastError()
// after the launch (0 on success).
int priority_order(const void* state, const void* submit, const void* est,
                   const void* nodes, const void* now, const void* family,
                   const void* theta, const void* hoisted,
                   const void* hoist_row, void* out, int k, int J,
                   void* stream) {
  if (k < 0 || J <= 0 || J > kMaxJ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == 0) return 0;
  const size_t smem = kWarps * host_warp_bytes(J);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  order_kernel<<<(k + kWarps - 1) / kWarps, kWarps * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(state), static_cast<const float*>(submit),
      static_cast<const float*>(est), static_cast<const int*>(nodes),
      static_cast<const float*>(now), static_cast<const int*>(family),
      static_cast<const float*>(theta), static_cast<const int*>(hoisted),
      static_cast<const int*>(hoist_row), static_cast<int*>(out), k, J);
  return static_cast<int>(cudaGetLastError());
}

// Launch the keys alone on `stream` (inputs as priority_order): writes
// keys float32 (k, J), +inf where a slot is not queued.
int priority_keys(const void* state, const void* submit, const void* est,
                  const void* nodes, const void* now, const void* family,
                  const void* theta, void* keys, int k, int J,
                  void* stream) {
  if (k < 0 || J <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(k) * J;
  if (total == 0) return 0;
  const int threads = 256;
  keys_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(state), static_cast<const float*>(submit),
      static_cast<const float*>(est), static_cast<const int*>(nodes),
      static_cast<const float*>(now), static_cast<const int*>(family),
      static_cast<const float*>(theta), static_cast<float*>(keys), total, J);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
