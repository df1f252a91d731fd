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
// prefill (B=1, H=64, N=64, S=1024) that is 84 MB of traffic (25 us at
// 3.35 TB/s) and 4*N^2*S*H = 1.07 GFLOP (16 us at the 67 TFLOP/s f32
// rate): bytes bound it.  The recurrence is sequential in t, though,
// and B*H = 64 heads give little parallelism, so the kernel is bound by
// the latency of its per-step dependent chain, not by either rate.  The
// state's columns are independent (column j needs only v_t[j]), and a
// column's rows only meet in the sum for y_t[j], so the design:
//   * one block per (batch, head, 16 columns): 64 threads, 4 per column,
//     each keeping a quarter of its column's rows of the state in
//     registers for the whole sequence; two xor-shuffles finish y_t[j].
//     At rwkv6-7b's shape that is 256 blocks, each step a chain of N/4
//     dependent FMAs;
//   * r, k, v, w arrive in chunks of kChunk steps, copied with cp.async
//     into one of two shared-memory stages while the other is computed,
//     read straight from the (B, S, H, N) layout the model produces (each
//     step's N values are contiguous, so the copies coalesce; no
//     transpose anywhere), and broadcast from shared memory with 16-byte
//     reads.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;       // steps staged in shared memory at once
constexpr int kCols = 16;        // state columns (value index j) per block
constexpr int kParts = 4;        // threads sharing one column's rows
constexpr int kThreads = kCols * kParts;           // 64
constexpr unsigned kFull = 0xffffffffu;

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

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Start copying steps [t0, t0 + n) of r, k, v, w into one stage buffer.
template <int N>
__device__ __forceinline__ void stage_chunk(
    float (*buf)[kChunk][N], const float* r, const float* k, const float* v,
    const float* w, long long base, long long step_stride, int t0, int n) {
  constexpr int kVecs = N / 4;                     // 16-byte pieces a step
  for (int e = threadIdx.x; e < n * kVecs; e += kThreads) {
    const int tt = e / kVecs;
    const int c = (e % kVecs) * 4;
    const long long off = base + (t0 + tt) * step_stride + c;
    cp_async16(&buf[0][tt][c], r + off);
    cp_async16(&buf[1][tt][c], k + off);
    cp_async16(&buf[2][tt][c], v + off);
    cp_async16(&buf[3][tt][c], w + off);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ state_out, int seq, int heads) {
  constexpr int kRows = N / kParts;                // rows (key index i)
  static_assert(kRows % 4 == 0, "rows are read four at a time");
  // two stages of (r, k, v, w) x kChunk steps: one computed while the
  // next is in flight
  __shared__ __align__(16) float stage[2][4][kChunk][N];
  __shared__ __align__(16) float su[N];

  constexpr int kColBlocks = N / kCols;
  const int bh = blockIdx.x / kColBlocks;
  const int b = bh / heads;
  const int h = bh % heads;
  const int part = threadIdx.x % kParts;
  const int j = (blockIdx.x % kColBlocks) * kCols + threadIdx.x / kParts;
  const int i0 = part * kRows;
  for (int e = threadIdx.x; e < N; e += kThreads) su[e] = u[h * N + e];

  float st[kRows];                       // S[i0 + i][j]
#pragma unroll
  for (int i = 0; i < kRows; ++i) st[i] = 0.0f;

  const long long step_stride = static_cast<long long>(heads) * N;
  const long long base = (static_cast<long long>(b) * seq * heads + h) * N;

  const int n_chunks = (seq + kChunk - 1) / kChunk;
  stage_chunk<N>(stage[0], r, k, v, w, base, step_stride, 0,
                 seq < kChunk ? seq : kChunk);
  cp_async_commit();
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kChunk;
    const int n = seq - t0 < kChunk ? seq - t0 : kChunk;
    if (ci + 1 < n_chunks) {
      const int t1 = t0 + kChunk;
      stage_chunk<N>(stage[(ci + 1) % 2], r, k, v, w, base, step_stride, t1,
                     seq - t1 < kChunk ? seq - t1 : kChunk);
      cp_async_commit();
      cp_async_wait<1>();                 // chunk ci has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*sr)[N] = stage[ci % 2][0];
    const float(*sk)[N] = stage[ci % 2][1];
    const float(*sv)[N] = stage[ci % 2][2];
    const float(*sw)[N] = stage[ci % 2][3];
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float yj = 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[tt][i0 + i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[tt][i0 + i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[tt][i0 + i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[i0 + i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kk[c] * vj;
          yj = fmaf(rr[c], st[i + c] + uu[c] * kv, yj);
          st[i + c] = fmaf(ww[c], st[i + c], kv);
        }
      }
      yj += __shfl_xor_sync(kFull, yj, 1);
      yj += __shfl_xor_sync(kFull, yj, 2);
      if (part == 0) y[base + (t0 + tt) * step_stride + j] = yj;
    }
    __syncthreads();                      // stage ci % 2 is free again
  }

  float* out = state_out + (static_cast<long long>(b) * heads + h) * N * N;
#pragma unroll
  for (int i = 0; i < kRows; ++i) out[(i0 + i) * N + j] = st[i];
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* state, int batch, int seq,
           int heads, cudaStream_t stream) {
  wkv_kernel<N><<<batch * heads * (N / kCols), kThreads, 0, stream>>>(
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
