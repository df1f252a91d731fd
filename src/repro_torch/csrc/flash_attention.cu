// K4: flash attention forward (online softmax), causal or not, with GQA
// and an optional sliding window.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel, entry flash_attention).  It computes what that kernel
// computes: scores and the running max/denominator are f32, masked
// scores are -1e30, p is rounded to v's dtype before P.V (f32
// accumulation) while the denominator sums the unrounded p, the
// denominator is clamped at 1e-30, and the output is written once in
// q's dtype.  Query head h reads kv head (h % Hq) / group of the same
// batch row; repeated KV is never formed.  Unlike the Pallas wrapper it
// takes any Sq and Sk: the last query and key tiles are ragged and
// masked here (rows past Sk are zero-filled, so no NaN meets p = 0),
// not padded by the caller.  The plain PyTorch version is
// repro_torch/models/attention.py::full_attention.
//
// The window (the Pallas kernel has none; full_attention's
// local_window): window = W > 0 masks keys with k_pos <= q_pos - W, and
// implies causal.  A query tile's key loop starts at the tile holding
// key q_tile*64 - W + 1, not at 0, and keeps the causal upper bound, so
// a tile does O(W) work, not O(q_pos).  The first tile a row visits can
// lie wholly outside that row's window (rows near the bottom of a query
// tile have later windows than its top row): every score there is
// -1e30, the row's running max stays -1e30 and p = exp(0) = 1 is summed
// into l and acc; the next tile holds the row's diagonal, its max is
// finite, and the rescale by exp(-1e30 - m) = 0 clears what was summed,
// exactly.
//
// What bounds it on an H100.  Causal prefill of llama3.2-1b (B=1, Hq=32,
// Hkv=8, D=64, S=2048, bf16) moves q, k, v and o once (~21 MB, 6 us at
// 3.35 TB/s) but does 4*Hq*S^2*D/2 = 17 GFLOP (17 us at the 989 TFLOP/s
// bf16 tensor rate): operations bound it, and so they do for
// recurrentgemma-2b's local layers (Hq=10, Hkv=1, D=256, W=2048: 21.5
// GFLOP at S=2048).  Two paths, one per dtype:
//   * bfloat16 (the serving path): tensor cores through
//     mma.sync.m16n8k16 with f32 accumulation.  One block of 4 warps per
//     (64-row query tile, batch*head), heaviest causal tiles first; each
//     warp keeps the 16 rows' scores of the current key tile and the
//     output accumulator in registers, and turns the score fragments
//     straight into the A fragments of P.V.  K and V are staged row
//     major in shared memory with rows padded by 8 elements, so fragment
//     reads hit 32 distinct banks; V's B fragments come from
//     ldmatrix.trans, so V needs no transposing store (scalar stores
//     of a transpose would be 32-way bank-conflicted at D = 256).  For
//     D <= 128
//     the warp's Q fragments live in registers and key tiles are 64
//     wide.  At D = 256 that plan needs 128 (accumulator) + 64 (Q) + 32
//     (scores) f32 registers a thread before any address: past the 255
//     limit, so it would spill.  D = 256 therefore keeps the Q tile in
//     shared memory (a fragment is read per k-step) and halves the key
//     tile to 32 (16 score registers): ~71 KB of shared memory a block,
//     with the opt-in above 48 KB.
//   * float32: CUDA cores (the tensor cores have no f32 product).  4
//     threads per query row, each owning a contiguous quarter of the head
//     dim, 16-byte shared-memory reads, a row's 64 scores in registers,
//     two xor-shuffles to finish each dot product.  D <= 128 only: at
//     D = 256 a thread would hold 64 q, 64 accumulator and 64 score
//     values.  The serving path is bf16.
// Neither overlaps loads with compute (no cp.async/TMA pipeline) nor
// uses wgmma or warp specialisation: those are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

// The first key tile (of width bk) that query tile q_tile visits: the
// one holding key q_tile*64 - window + 1, the earliest key its top row
// sees; 0 without a window.
__device__ __forceinline__ int first_key_tile(int q_tile, int window,
                                              int bk) {
  if (window <= 0) return 0;
  const int lo = q_tile * kBlockQ - window + 1;
  return lo > 0 ? lo / bk : 0;
}

// ---------------------------------------------------------------------
// float32: CUDA cores.
// ---------------------------------------------------------------------

constexpr int kPartsPerRow = 4;
constexpr int kF32Threads = kBlockQ * kPartsPerRow;   // 256

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = u.w;
}

// Copy rows [key0, key0 + kBlockK) of one (batch, kv head) of K or V into
// a dense (kBlockK, D) shared tile; rows at or past sk are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* base,
                                              long long row_stride, int key0,
                                              int sk) {
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < kBlockK * kPerRow; idx += kF32Threads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (key0 + r < sk) {
      val = *reinterpret_cast<const float4*>(
          base + static_cast<long long>(key0 + r) * row_stride + c);
    }
    *reinterpret_cast<float4*>(tile + r * D + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq,
                 int group, int sq, int sk, long long qsb, long long qsh,
                 long long qss, long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss, long long osb,
                 long long osh, long long oss, float scale, int causal,
                 int window) {
  constexpr int kDp = D / kPartsPerRow;      // dims owned by one thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kBlockK * D;

  const int q_tile = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / group;
  const int row = threadIdx.x / kPartsPerRow;
  const int part = threadIdx.x % kPartsPerRow;
  const int q_pos = q_tile * kBlockQ + row;
  const int d0 = part * kDp;

  // q scaled in f32 first, as the TPU kernel does
  float qf[kDp];
  if (q_pos < sq) {
    const float* qrow = q + b * qsb + h * qsh + q_pos * qss + d0;
#pragma unroll
    for (int c = 0; c < kDp; c += 4) load4(qrow + c, qf + c);
#pragma unroll
    for (int i = 0; i < kDp; ++i) qf[i] *= scale;
  } else {
#pragma unroll
    for (int i = 0; i < kDp; ++i) qf[i] = 0.0f;
  }

  float acc[kDp];
#pragma unroll
  for (int i = 0; i < kDp; ++i) acc[i] = 0.0f;
  float m = kNegInf;
  float l = 0.0f;

  const int k_tiles = (sk + kBlockK - 1) / kBlockK;
  int n_tiles = k_tiles;
  if (causal) {
    const int hi = ((q_tile + 1) * kBlockQ + kBlockK - 1) / kBlockK;
    n_tiles = hi < k_tiles ? hi : k_tiles;
  }
  const int kt_lo = first_key_tile(q_tile, window, kBlockK);
  const float* kbase = k + b * ksb + kvh * ksh;
  const float* vbase = v + b * vsb + kvh * vsh;

  for (int kt = kt_lo; kt < n_tiles; ++kt) {
    const int key0 = kt * kBlockK;
    __syncthreads();                      // the previous tile is consumed
    load_tile_f32<D>(ks, kbase, kss, key0, sk);
    load_tile_f32<D>(vs, vbase, vss, key0, sk);
    __syncthreads();

    float s[kBlockK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float kf[kDp];
#pragma unroll
      for (int c = 0; c < kDp; c += 4) load4(ks + j * D + d0 + c, kf + c);
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kDp; ++i) dot = fmaf(qf[i], kf[i], dot);
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      const int k_pos = key0 + j;
      const bool ok = k_pos < sk && (!causal || k_pos <= q_pos) &&
                      (window <= 0 || k_pos > q_pos - window);
      s[j] = ok ? dot : kNegInf;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kDp; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      float vf[kDp];
#pragma unroll
      for (int c = 0; c < kDp; c += 4) load4(vs + j * D + d0 + c, vf + c);
#pragma unroll
      for (int i = 0; i < kDp; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
    }
    m = m_new;
  }

  if (q_pos < sq) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    float* orow = o + b * osb + h * osh + q_pos * oss + d0;
#pragma unroll
    for (int i = 0; i < kDp; ++i) orow[i] = acc[i] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int hq, int hkv, int sq, int sk,
               const long long* st, float scale, int causal, int window,
               cudaStream_t stream) {
  const size_t smem = 2 * kBlockK * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  flash_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hq / hkv,
      sq, sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// bfloat16: tensor cores.  Fragment layouts are those of PTX's
// mma.m16n8k16 (g = lane / 4, t = lane % 4): A rows g and g + 8, columns
// 2t, 2t + 1 (+ 8); B column g, rows 2t, 2t + 1 (+ 8); C rows g, g + 8,
// columns 2t, 2t + 1.
// ---------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;        // 128, 16 rows a warp
constexpr int kPad = 8;

// The register plan per head dim: D = 256 keeps Q in shared memory and
// takes 32-key tiles (see the note at the top).
template <int D>
struct Bf16Plan {
  static constexpr bool kQInSmem = D > 128;
  static constexpr int kBK = D > 128 ? 32 : 64;    // keys per tile
  static constexpr int kLd = D + kPad;             // K, V, Q tiles: [row][d]
  static constexpr size_t kSmemBytes =
      (2 * static_cast<size_t>(kBK) +
       (kQInSmem ? static_cast<size_t>(kBlockQ) : 0)) *
      kLd * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 b16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8, and r[m] is this lane's pair of
// matrix m as a B fragment of mma.m16n8k16 (rows 2t, 2t + 1 of column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int hq, int group, int sq,
                 int sk, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, long long osb, long long osh,
                 long long oss, float scale, int causal, int window) {
  using Plan = Bf16Plan<D>;
  constexpr int kBK = Plan::kBK;
  constexpr int kLdK = Plan::kLd;
  constexpr int kLdQ = Plan::kLd;
  constexpr int kDSteps = D / 16;                // k-steps of Q K^T
  constexpr int kNTiles = kBK / 8;               // score n-tiles
  constexpr int kDTiles = D / 8;                 // output n-tiles
  constexpr int kVecPerRow = D / 8;              // 16-byte pieces a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kBK * kLdK;
  __nv_bfloat16* qs = vs + kBK * kLdK;             // used when kQInSmem

  const int q_tile = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                          // fragment row group
  const int t = lane % 4;                          // thread in group
  const int row0 = q_tile * kBlockQ + warp * 16 + g;   // and row0 + 8

  // Q fragments (A operand, 16 rows x D), rows past sq are zero: in
  // registers, or (D = 256) the block's 64 x D tile in shared memory,
  // made visible by the barrier after the first K/V tile.
  uint32_t qa[Plan::kQInSmem ? 1 : kDSteps][4];
  if constexpr (Plan::kQInSmem) {
    const __nv_bfloat16* qbase = q + b * qsb + h * qsh;
    for (int idx = threadIdx.x; idx < kBlockQ * kVecPerRow;
         idx += kMmaThreads) {
      const int r = idx / kVecPerRow;
      const int c = (idx % kVecPerRow) * 8;
      const int pos = q_tile * kBlockQ + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (pos < sq) {
        val = *reinterpret_cast<const uint4*>(
            qbase + static_cast<long long>(pos) * qss + c);
      }
      *reinterpret_cast<uint4*>(qs + r * kLdQ + c) = val;
    }
  } else {
    const __nv_bfloat16* q0 = q + b * qsb + h * qsh + row0 * qss;
    const __nv_bfloat16* q8 = q0 + 8 * qss;
    const bool ok0 = row0 < sq, ok8 = row0 + 8 < sq;
#pragma unroll
    for (int ksp = 0; ksp < kDSteps; ++ksp) {
      const int c = ksp * 16 + 2 * t;
      qa[ksp][0] = ok0 ? ld32(q0 + c) : 0u;
      qa[ksp][1] = ok8 ? ld32(q8 + c) : 0u;
      qa[ksp][2] = ok0 ? ld32(q0 + c + 8) : 0u;
      qa[ksp][3] = ok8 ? ld32(q8 + c + 8) : 0u;
    }
  }
  const __nv_bfloat16* qrow = qs + (warp * 16 + g) * kLdQ + 2 * t;

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m0 = kNegInf, m8 = kNegInf;    // running max of rows g, g + 8
  float l0 = 0.0f, l8 = 0.0f;          // this thread's share of the sums

  const int k_tiles = (sk + kBK - 1) / kBK;
  int n_tiles = k_tiles;
  if (causal) {
    const int hi = ((q_tile + 1) * kBlockQ + kBK - 1) / kBK;
    n_tiles = hi < k_tiles ? hi : k_tiles;
  }
  const int kt_lo = first_key_tile(q_tile, window, kBK);
  const __nv_bfloat16* kbase = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vbase = v + b * vsb + kvh * vsh;

  for (int kt = kt_lo; kt < n_tiles; ++kt) {
    const int key0 = kt * kBK;
    __syncthreads();                      // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBK * kVecPerRow;
         idx += kMmaThreads) {
      const int r = idx / kVecPerRow;
      const int c = (idx % kVecPerRow) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key0 + r < sk) {
        kv = *reinterpret_cast<const uint4*>(
            kbase + static_cast<long long>(key0 + r) * kss + c);
        vv = *reinterpret_cast<const uint4*>(
            vbase + static_cast<long long>(key0 + r) * vss + c);
      }
      *reinterpret_cast<uint4*>(ks + r * kLdK + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * kLdK + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x kBK keys, each score summed
    // over the k-steps in order.  Q in shared memory: one fragment read
    // per k-step, used for every n-tile; Q in registers: n-tile by
    // n-tile (this order keeps D = 128 free of spills).
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    if constexpr (Plan::kQInSmem) {
#pragma unroll
      for (int ksp = 0; ksp < kDSteps; ++ksp) {
        const uint32_t qf[4] = {ld32(qrow + ksp * 16),
                                ld32(qrow + 8 * kLdQ + ksp * 16),
                                ld32(qrow + ksp * 16 + 8),
                                ld32(qrow + 8 * kLdQ + ksp * 16 + 8)};
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const __nv_bfloat16* krow = ks + (nt * 8 + g) * kLdK + 2 * t;
          mma_bf16(s[nt], qf, ld32(krow + ksp * 16),
                   ld32(krow + ksp * 16 + 8));
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const __nv_bfloat16* krow = ks + (nt * 8 + g) * kLdK + 2 * t;
#pragma unroll
        for (int ksp = 0; ksp < kDSteps; ++ksp) {
          mma_bf16(s[nt], qa[ksp], ld32(krow + ksp * 16),
                   ld32(krow + ksp * 16 + 8));
        }
      }
    }

    // scale, mask, running max per row
    float mx0 = m0, mx8 = m8;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = key < sk && (!causal || key <= row) &&
                        (window <= 0 || key > row - window);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx8 = fmaxf(mx8, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx8 = fmaxf(mx8, __shfl_xor_sync(kFull, mx8, 1));
    mx8 = fmaxf(mx8, __shfl_xor_sync(kFull, mx8, 2));
    const float alpha0 = expf(m0 - mx0), alpha8 = expf(m8 - mx8);
    m0 = mx0;
    m8 = mx8;
    l0 *= alpha0;
    l8 *= alpha8;
#pragma unroll
    for (int i = 0; i < kDTiles; ++i) {
      acc[i][0] *= alpha0;
      acc[i][1] *= alpha0;
      acc[i][2] *= alpha8;
      acc[i][3] *= alpha8;
    }

    // P = exp(S - m): f32 into the sums, bf16 into the A fragments of P V
    uint32_t pa[kNTiles / 2][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const float p0 = expf(s[nt][0] - m0), p1 = expf(s[nt][1] - m0);
      const float p2 = expf(s[nt][2] - m8), p3 = expf(s[nt][3] - m8);
      l0 += p0 + p1;
      l8 += p2 + p3;
      pa[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: V's rows (keys) are the B operand's k, its columns (d)
    // the n; one ldmatrix.trans gives the B fragments of output n-tiles
    // dt and dt + 1 for one 16-key k-step.
    const __nv_bfloat16* vrow = vs + (lane & 15) * kLdK + (lane >> 4) * 8;
#pragma unroll
    for (int dt = 0; dt < kDTiles; dt += 2) {
#pragma unroll
      for (int ksp = 0; ksp < kBK / 16; ++ksp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + ksp * 16 * kLdK + dt * 8);
        mma_bf16(acc[dt], pa[ksp], b[0], b[1]);
        mma_bf16(acc[dt + 1], pa[ksp], b[2], b[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l8 += __shfl_xor_sync(kFull, l8, 1);
  l8 += __shfl_xor_sync(kFull, l8, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv8 = 1.0f / fmaxf(l8, 1e-30f);
  __nv_bfloat16* o0 = o + b * osb + h * osh + row0 * oss + 2 * t;
  __nv_bfloat16* o8 = o0 + 8 * oss;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    if (row0 < sq) {
      *reinterpret_cast<uint32_t*>(o0 + dt * 8) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (row0 + 8 < sq) {
      *reinterpret_cast<uint32_t*>(o8 + dt * 8) =
          pack_bf16(acc[dt][2] * inv8, acc[dt][3] * inv8);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
               int batch, int hq, int hkv, int sq, int sk,
               const long long* st, float scale, int causal, int window,
               cudaStream_t stream) {
  const size_t smem = Bf16Plan<D>::kSmemBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  flash_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      hq, hq / hkv, sq, sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int batch, int hq, int hkv, int sq, int sk, const long long* st,
           float scale, int causal, int window, cudaStream_t stream) {
  if constexpr (D > 128) {
    // float32 takes D <= 128 only (see the note at the top)
    if (dtype == 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16<D>(q, k, v, o, batch, hq, hkv, sq, sk, st, scale,
                          causal, window, stream);
  } else {
    return dtype == 0
               ? launch_f32<D>(q, k, v, o, batch, hq, hkv, sq, sk, st,
                               scale, causal, window, stream)
               : launch_bf16<D>(q, k, v, o, batch, hq, hkv, sq, sk, st,
                                scale, causal, window, stream);
  }
}

}  // namespace

extern "C" {

// Launch K4 on `stream`.  q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) and o
// (B, Hq, Sq, D) are addressed as base + b*s[0] + h*s[1] + t*s[2] + d,
// in elements, with `strides` = {q's 3, k's 3, v's 3, o's 3}; the head
// dim is contiguous and every row starts 16-byte aligned.  dtype: 0 for
// float32, 1 for bfloat16.  D is 32, 64 or 128, or 256 in bfloat16.
// window > 0 masks keys at or before q_pos - window and implies causal;
// 0 is no window.  Returns cudaGetLastError() after the launch (0 on
// success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int dtype, int batch, int hq, int hkv,
                        int sq, int sk, int d, const long long* strides,
                        float scale, int causal, int window, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      sk <= 0 || window < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (window > 0) causal = 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                        scale, causal, window, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                        scale, causal, window, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                         scale, causal, window, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                         scale, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
