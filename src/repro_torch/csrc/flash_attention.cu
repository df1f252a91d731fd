// K4: flash attention forward (online softmax), causal or not, with GQA.
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
// What bounds it on an H100.  Causal prefill of llama3.2-1b (B=1, Hq=32,
// Hkv=8, D=64, S=2048, bf16) moves q, k, v and o once (~21 MB, 6 us at
// 3.35 TB/s) but does 4*Hq*S^2*D/2 = 17 GFLOP (17 us at the 989 TFLOP/s
// bf16 tensor rate): operations bound it.  Two paths, one per dtype:
//   * bfloat16 (the serving path): tensor cores through
//     mma.sync.m16n8k16 with f32 accumulation.  One block of 4 warps per
//     (64-row query tile, batch*head), heaviest causal tiles first; each
//     warp keeps its 16 rows' Q fragments, the 64 scores of the current
//     key tile and the output accumulator in registers, and turns the
//     score fragments straight into the A fragments of P.V.  K (row
//     major) and V (transposed) are staged in shared memory with rows
//     padded by 8 elements, so fragment reads hit 32 distinct banks.
//   * float32: CUDA cores (the tensor cores have no f32 product).  4
//     threads per query row, each owning a contiguous quarter of the head
//     dim, 16-byte shared-memory reads, a row's 64 scores in registers,
//     two xor-shuffles to finish each dot product.
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
                 long long osh, long long oss, float scale, int causal) {
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
  const float* kbase = k + b * ksb + kvh * ksh;
  const float* vbase = v + b * vsb + kvh * vsh;

  for (int kt = 0; kt < n_tiles; ++kt) {
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
      const bool ok = k_pos < sk && (!causal || k_pos <= q_pos);
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
               const long long* st, float scale, int causal,
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
      st[9], st[10], st[11], scale, causal);
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int hq, int group, int sq,
                 int sk, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, long long osb, long long osh,
                 long long oss, float scale, int causal) {
  constexpr int kLdK = D + kPad;                 // K tile: [key][d]
  constexpr int kLdV = kBlockK + kPad;           // V tile: [d][key]
  constexpr int kDSteps = D / 16;                // k-steps of Q K^T
  constexpr int kNTiles = kBlockK / 8;           // score n-tiles
  constexpr int kDTiles = D / 8;                 // output n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vts = ks + kBlockK * kLdK;

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

  // Q fragments (A operand, 16 rows x D), rows past sq are zero.
  uint32_t qa[kDSteps][4];
  {
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

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m0 = kNegInf, m8 = kNegInf;    // running max of rows g, g + 8
  float l0 = 0.0f, l8 = 0.0f;          // this thread's share of the sums

  const int k_tiles = (sk + kBlockK - 1) / kBlockK;
  int n_tiles = k_tiles;
  if (causal) {
    const int hi = ((q_tile + 1) * kBlockQ + kBlockK - 1) / kBlockK;
    n_tiles = hi < k_tiles ? hi : k_tiles;
  }
  const __nv_bfloat16* kbase = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vbase = v + b * vsb + kvh * vsh;
  constexpr int kVecPerRow = D / 8;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int key0 = kt * kBlockK;
    __syncthreads();                      // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * kVecPerRow;
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
      __nv_bfloat16 vals[8];
      memcpy(vals, &vv, sizeof(vals));
#pragma unroll
      for (int i = 0; i < 8; ++i) vts[(c + i) * kLdV + r] = vals[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* krow = ks + (nt * 8 + g) * kLdK + 2 * t;
#pragma unroll
      for (int ksp = 0; ksp < kDSteps; ++ksp) {
        mma_bf16(s[nt], qa[ksp], ld32(krow + ksp * 16),
                 ld32(krow + ksp * 16 + 8));
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
        const bool ok = key < sk && (!causal || key <= row);
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

    // O += P V: V^T rows (d) are the B operand's columns.
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      const __nv_bfloat16* vrow = vts + (dt * 8 + g) * kLdV + 2 * t;
#pragma unroll
      for (int ksp = 0; ksp < kBlockK / 16; ++ksp) {
        mma_bf16(acc[dt], pa[ksp], ld32(vrow + ksp * 16),
                 ld32(vrow + ksp * 16 + 8));
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
               const long long* st, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kBlockK) * (D + kPad) +
                       static_cast<size_t>(D) * (kBlockK + kPad)) *
                      sizeof(__nv_bfloat16);
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
      st[7], st[8], st[9], st[10], st[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int batch, int hq, int hkv, int sq, int sk, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  return dtype == 0
             ? launch_f32<D>(q, k, v, o, batch, hq, hkv, sq, sk, st, scale,
                             causal, stream)
             : launch_bf16<D>(q, k, v, o, batch, hq, hkv, sq, sk, st, scale,
                              causal, stream);
}

}  // namespace

extern "C" {

// Launch K4 on `stream`.  q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) and o
// (B, Hq, Sq, D) are addressed as base + b*s[0] + h*s[1] + t*s[2] + d,
// in elements, with `strides` = {q's 3, k's 3, v's 3, o's 3}; the head
// dim is contiguous and every row starts 16-byte aligned.  dtype: 0 for
// float32, 1 for bfloat16.  D is 32, 64 or 128.  Returns
// cudaGetLastError() after the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int dtype, int batch, int hq, int hkv,
                        int sq, int sk, int d, const long long* strides,
                        float scale, int causal, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      sk <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                        scale, causal, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                        scale, causal, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                         scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
