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
// key row0 - W + 1 (row0 the tile's top row), not at 0, and keeps the
// causal upper bound, so a tile does O(W) work, not O(q_pos).  The first
// tile a row visits can lie wholly outside that row's window (rows near
// the bottom of a query tile have later windows than its top row): every
// score there is -1e30, the row's running max stays -1e30 and p =
// exp(0) = 1 is summed into l and acc; a later tile holds the row's
// diagonal, its max is finite, and the rescale by exp(-1e30 - m) = 0
// clears what was summed, exactly.
//
// What bounds it on an H100.  Operations, at both shapes of the serving
// path.  Causal prefill of llama3.2-1b (B=1, Hq=32, Hkv=8, D=64, bf16)
// at S=1000 moves q, k, v and o once (5.1 MB, 1.5 us at 3.35 TB/s) but
// does 4*Hq*S^2*D/2 = 4.1 GFLOP (4.1 us at the 989 TFLOP/s bf16 tensor
// rate); recurrentgemma-2b's local layer (Hq=10, Hkv=1, D=256, W=2048)
// at S=2048 moves 23 MB (6.9 us) and does 21.5 GFLOP (21.7 us).  Only
// wgmma reaches that rate, so the bf16 path is built around it.  Two
// paths, one per dtype:
//   * bfloat16 (the serving path; flash_wgmma_kernel): one block of
//     three warpgroups per (128-row query tile, batch*head), heaviest
//     causal tiles first.  Warpgroup 0 is the producer: it drops to 24
//     registers a thread (setmaxnreg) and one thread issues TMA loads,
//     Q's 128 x D tile once, then each key tile's K and V into a ring of
//     kStages shared-memory stages with their own full and empty
//     mbarriers (K and V apart, so S = Q K^T starts before V lands).
//     Warpgroups 1 and 2 are consumers of 64 query rows each, raised to
//     240 registers: S = Q K^T by wgmma with both operands in shared
//     memory (K-major), the mask only on the tiles that need it (the
//     causal diagonal, the window's first tiles, the ragged last key
//     tile), the online softmax in registers with exp2 (log2(e) folded
//     into the scale), P rounded to bf16 straight from the accumulator
//     fragments into wgmma's register A operand, and O += P V by wgmma
//     with V read in place as an MN-major B operand (the transpose bit):
//     V is never transposed by a store.  The tensor cores are kept busy
//     two ways: within a consumer, S_j = Q K_j^T and O += P_{j-1} V_{j-1}
//     are issued together and S_j's softmax runs under the second; the
//     two consumers take turns to issue (named barriers), so one's
//     products run under the other's softmax.  The grid runs every
//     head's heaviest causal tile first (blockIdx.x is the head, y the
//     tile from the last), which matters as much as any of these where
//     blocks barely outnumber the SMs (recurrentgemma: 160 blocks).
//     Tiles are written by TMA in 128-byte swizzle (64-byte at D = 32,
//     where a row is 64 bytes), as wgmma's descriptors read them; D > 64
//     is loaded as 64-column boxes side by side.  TMA zero-fills rows
//     past Sq and Sk (the maps' dims are the real lengths), so a ragged
//     tile needs no masked load.
//     Plan per D (WgPlan; repeated in kernels/flash_attention.py::PLAN):
//       D    key tile  stages  shared memory bytes (Q, 2 x stages
//                              tiles, 1024 alignment, 256 barriers)
//       32   128       3        58,624
//       64   128       3       115,968
//       128  128       2       165,120
//       256   64       2       197,888  (of the 232,448 a block may use)
//     A consumer thread holds the 64 x D f32 accumulator (D / 2
//     registers: 128 at D = 256), the 64 x key-tile scores (32 or 64)
//     and P as bf16 (16 or 32): at most ~190 of its 240.  Left for later:
//     a third consumer warpgroup at D <= 64 (192-row tiles, where the
//     exp2 throughput rivals the products'), a persistent tile scheduler
//     or a split of the heaviest causal tiles' keys, the output through
//     shared memory and TMA, and fp8.
//   * float32: CUDA cores (the tensor cores have no f32 product).  4
//     threads per query row, each owning a contiguous quarter of the head
//     dim, 16-byte shared-memory reads, a row's 64 scores in registers,
//     two xor-shuffles to finish each dot product.  D <= 128 only: at
//     D = 256 a thread would hold 64 q, 64 accumulator and 64 score
//     values.  The serving path is bf16.

#include <cuda.h>
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

// The first key tile (of width bk) that a query tile whose top row is
// row0 visits: the one holding key row0 - window + 1, the earliest key
// its top row sees; 0 without a window.
__device__ __forceinline__ int first_key_tile(int row0, int window,
                                              int bk) {
  if (window <= 0) return 0;
  const int lo = row0 - window + 1;
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
  const int kt_lo = first_key_tile(q_tile * kBlockQ, window, kBlockK);
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
// bfloat16: TMA, mbarriers, wgmma, warp specialisation (see the note at
// the top).  Fragment layouts are those of PTX's wgmma.m64nNk16 with f32
// accumulators: warp w of a warpgroup holds rows 16w + g and 16w + g + 8
// (g = lane / 4, t = lane % 4); d[4j], d[4j + 1] are row 16w + g, columns
// 8j + 2t, 8j + 2t + 1, and d[4j + 2], d[4j + 3] the same columns of row
// 16w + g + 8.  The register A operand (bf16, 64 x 16) has the layout of
// mma.m16n8k16's A per warp, which is why the score fragments of 16 keys
// pack straight into it.
// ---------------------------------------------------------------------

constexpr int kWgBlockQ = 128;         // query rows a block: 2 x 64
constexpr int kWgThreads = 384;        // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;     // 128 x 24 + 256 x 240 <= 65536
constexpr int kConsumerWarps = 8;      // arrivals that empty a stage
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgPlan {
  static constexpr int kBN = D > 128 ? 64 : 128;        // keys a tile
  static constexpr int kStages = D > 64 ? 2 : 3;
  static constexpr int kCW = D < 64 ? D : 64;            // columns a box
  static constexpr int kRowBytes = kCW * 2;              // swizzle span
  static constexpr int kChunks = D / kCW;                // boxes a row
  static constexpr uint32_t kQBytes = kWgBlockQ * D * 2;
  static constexpr uint32_t kTileBytes = kBN * D * 2;    // K or V, a stage
  static constexpr int kBars = 1 + 4 * kStages;
  // 1024 bytes of slack to align the tiles to the swizzle atom, the
  // tiles, the barriers
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + 256;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // SW128/64
  static_assert(kSmemBytes <= 232448, "past the 227 KB a block may use");
  static_assert(kBars * 8 <= 256, "barriers past their room");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-d map (d, s, h, b) into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s),
      "r"(h), "r"(b)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode in bits 62-63.
template <uint64_t kLayout>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 order the two consumers' products (ping-pong):
// a consumer waits on its own before issuing wgmma and then lets the
// other go, so one's products run while the other computes its softmax.
__device__ __forceinline__ void turn_begin(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_end(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the asm statements around it.
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S (64 x 64, f32) = A (64 x 16) . B (64 x 16)^T, A and B K-major in
// shared memory; scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// S (64 x 128, f32) = A (64 x 16) . B (128 x 16)^T, A and B K-major in
// shared memory; scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x 32, f32) += A (64 x 16, bf16 in registers) . B (16 x 32), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// O (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// O (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// O (64 x 256, f32) += A (64 x 16, bf16 in registers) . B (16 x 256), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "key tile");
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, scale_d);
  } else {
    wgmma_ss_n128(d, a, b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256, "head dim");
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    wgmma_rs_n256(d, a, b);
  }
}

// Shared memory, from a 1024-byte aligned base: Q [chunk][128 rows][kCW],
// then kStages K tiles and kStages V tiles [chunk][kBN rows][kCW], then
// the barriers: q_full, k_full[s], v_full[s], k_empty[s], v_empty[s].
template <int D>
struct WgSmem {
  using P = WgPlan<D>;
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int s) const {
    return base + P::kQBytes + s * P::kTileBytes;
  }
  __device__ uint32_t v(int s) const {
    return base + P::kQBytes + (P::kStages + s) * P::kTileBytes;
  }
  __device__ uint32_t bar(int i) const {
    return base + P::kQBytes + 2 * P::kStages * P::kTileBytes + 8 * i;
  }
  __device__ uint32_t q_full() const { return bar(0); }
  __device__ uint32_t k_full(int s) const { return bar(1 + s); }
  __device__ uint32_t v_full(int s) const { return bar(1 + P::kStages + s); }
  __device__ uint32_t k_empty(int s) const {
    return bar(1 + 2 * P::kStages + s);
  }
  __device__ uint32_t v_empty(int s) const {
    return bar(1 + 3 * P::kStages + s);
  }
};

// The producer: one thread issues every TMA load of the block.
template <int D>
__device__ __forceinline__ void produce(const WgSmem<D>& sm,
                                        const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int q0,
                                        int h, int kvh, int b, int kt_lo,
                                        int n_tiles) {
  using P = WgPlan<D>;
  mbar_expect_tx(sm.q_full(), P::kQBytes);
#pragma unroll
  for (int c = 0; c < P::kChunks; ++c) {
    tma_load(sm.q() + c * kWgBlockQ * P::kRowBytes, tm_q, sm.q_full(),
             c * P::kCW, q0, h, b);
  }
  for (int kt = kt_lo, it = 0; kt < n_tiles; ++kt, ++it) {
    const int s = it % P::kStages;
    const uint32_t ph = (it / P::kStages) & 1;
    mbar_wait(sm.k_empty(s), ph ^ 1);
    mbar_expect_tx(sm.k_full(s), P::kTileBytes);
#pragma unroll
    for (int c = 0; c < P::kChunks; ++c) {
      tma_load(sm.k(s) + c * P::kBN * P::kRowBytes, tm_k, sm.k_full(s),
               c * P::kCW, kt * P::kBN, kvh, b);
    }
    mbar_wait(sm.v_empty(s), ph ^ 1);
    mbar_expect_tx(sm.v_full(s), P::kTileBytes);
#pragma unroll
    for (int c = 0; c < P::kChunks; ++c) {
      tma_load(sm.v(s) + c * P::kBN * P::kRowBytes, tm_v, sm.v_full(s),
               c * P::kCW, kt * P::kBN, kvh, b);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step on this thread's scores sc (rows a and
// a + 8): scale into log2 units, mask where the tile needs it, raise the
// running max, and leave p = exp2(s - m) in sc.  l is rescaled and
// takes the unrounded p; alpha is the factor the accumulator rows still
// owe (exp2(m_old - m_new)).
template <int kBN>
__device__ __forceinline__ void softmax_tile(
    float* sc, int key0, bool masked, int row_a, int col0, int sk,
    int causal, int window, float scale_log2, float& m_a, float& m_b,
    float& l_a, float& l_b, float& alpha_a, float& alpha_b) {
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] *= scale_log2;
  if (masked) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int key = key0 + 8 * (i / 4) + col0 + (i & 1);
      const int row = row_a + ((i & 2) ? 8 : 0);
      const bool ok = key < sk && (!causal || key <= row) &&
                      (window <= 0 || key > row - window);
      if (!ok) sc[i] = kNegInf;
    }
  }
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 2));
  alpha_a = ex2(m_a - mx_a);
  alpha_b = ex2(m_b - mx_b);
  m_a = mx_a;
  m_b = mx_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    sc[4 * j] = ex2(sc[4 * j] - mx_a);
    sc[4 * j + 1] = ex2(sc[4 * j + 1] - mx_a);
    sc[4 * j + 2] = ex2(sc[4 * j + 2] - mx_b);
    sc[4 * j + 3] = ex2(sc[4 * j + 3] - mx_b);
    sum_a += sc[4 * j] + sc[4 * j + 1];
    sum_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
}

// A consumer warpgroup: 64 query rows from r0.  Of the block's key
// tiles it reads those that hold a key one of its rows sees; the ones
// before (outside every row's window) and after (past every row's
// diagonal) are released unread.  Within a warpgroup the products of
// two tiles overlap the softmax between them: S_j = Q K_j^T and O +=
// P_{j-1} V_{j-1} are issued together, S_j's softmax runs while the
// second is in flight, and O is rescaled once it has landed.
template <int D>
__device__ __forceinline__ void consume(
    const WgSmem<D>& sm, int cw, __nv_bfloat16* __restrict__ o,
    long long oss, int sq, int sk, int r0, int kt_lo, int n_tiles,
    float scale_log2, int causal, int window) {
  using P = WgPlan<D>;
  constexpr int kBN = P::kBN;
  constexpr int kRB = P::kRowBytes;
  constexpr uint32_t kSbo = 8 * kRB;                 // next 8 rows
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row_a = r0 + 16 * (tid / 32) + lane / 4;   // and row_a + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_wg = sm.q() + 64 * cw * kRB;

  // this warpgroup's tiles: [lo, hi) of the block's [kt_lo, n_tiles)
  int lo = first_key_tile(r0, window, kBN);
  lo = lo < kt_lo ? kt_lo : (lo > n_tiles ? n_tiles : lo);
  int hi = n_tiles;
  if (causal) {
    const int last = (r0 + 64 + kBN - 1) / kBN;
    hi = last < hi ? last : hi;
  }
  hi = hi < lo ? lo : hi;

  auto stage = [&](int kt) { return (kt - kt_lo) % P::kStages; };
  auto parity = [&](int kt) {
    return static_cast<uint32_t>(((kt - kt_lo) / P::kStages) & 1);
  };
  auto release_unread = [&](int kt) {
    turn_begin(cw);
    turn_end(cw);
    mbar_wait(sm.k_full(stage(kt)), parity(kt));
    if (lane == 0) mbar_arrive(sm.k_empty(stage(kt)));
    mbar_wait(sm.v_full(stage(kt)), parity(kt));
    if (lane == 0) mbar_arrive(sm.v_empty(stage(kt)));
  };
  auto needs_mask = [&](int key0) {
    return key0 + kBN > sk || (causal && key0 + kBN - 1 > r0) ||
           (window > 0 && key0 <= r0 + 63 - window);
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf;    // running max, rows a and a + 8
  float l_a = 0.0f, l_b = 0.0f;          // this thread's share of the sums
  float alpha_a, alpha_b;
  float sc[kBN / 2];                     // S, then P in f32
  uint32_t pa[kBN / 16][4];              // P as wgmma's register A operand

  auto issue_qk = [&](int s) {           // S = Q K^T, D in 16-col steps
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / P::kCW;
      const uint32_t off = (kk * 16 % P::kCW) * 2;
      const uint64_t da = smem_desc<P::kLayout>(
          q_wg + c * kWgBlockQ * kRB + off, 16, kSbo);
      const uint64_t db = smem_desc<P::kLayout>(
          sm.k(s) + c * kBN * kRB + off, 16, kSbo);
      wgmma_ss<kBN>(sc, da, db, kk > 0);
    }
    wg_commit();
  };
  auto issue_pv = [&](int s) {           // O += P V, V MN-major by 16 keys
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t db = smem_desc<P::kLayout>(
          sm.v(s) + kk * 16 * kRB, kBN * kRB, kSbo);
      wgmma_rs<D>(acc, pa[kk], db);
    }
    wg_commit();
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      pa[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  };

  // every consumer takes one turn per tile of the block and one more,
  // whether it reads the tile or not, so the turns pair up; the first
  // consumer starts
  if (cw == 1) turn_end(cw);
  mbar_wait(sm.q_full(), 0);
  for (int kt = kt_lo; kt < lo; ++kt) release_unread(kt);
  if (lo < hi) {
    mbar_wait(sm.k_full(stage(lo)), parity(lo));
    hold<kBN / 2>(sc);
    turn_begin(cw);
    wg_fence();
    issue_qk(stage(lo));
    turn_end(cw);
    hold<kBN / 2>(sc);
    wg_wait<0>();
    hold<kBN / 2>(sc);
    if (lane == 0) mbar_arrive(sm.k_empty(stage(lo)));
    softmax_tile<kBN>(sc, lo * kBN, needs_mask(lo * kBN), row_a, col0, sk,
                      causal, window, scale_log2, m_a, m_b, l_a, l_b,
                      alpha_a, alpha_b);
    pack_p();
    for (int kt = lo + 1; kt < hi; ++kt) {
      const int s = stage(kt), sp = stage(kt - 1);
      mbar_wait(sm.k_full(s), parity(kt));
      hold<kBN / 2>(sc);
      hold<D / 2>(acc);
      hold<kBN / 4>(&pa[0][0]);
      mbar_wait(sm.v_full(sp), parity(kt - 1));
      turn_begin(cw);
      wg_fence();
      issue_qk(s);
      issue_pv(sp);
      turn_end(cw);
      hold<kBN / 2>(sc);
      wg_wait<1>();                      // S_j has landed
      hold<kBN / 2>(sc);
      if (lane == 0) mbar_arrive(sm.k_empty(s));
      softmax_tile<kBN>(sc, kt * kBN, needs_mask(kt * kBN), row_a, col0, sk,
                        causal, window, scale_log2, m_a, m_b, l_a, l_b,
                        alpha_a, alpha_b);
      hold<D / 2>(acc);
      wg_wait<0>();                      // O += P_{j-1} V_{j-1} has landed
      hold<D / 2>(acc);
      hold<kBN / 4>(&pa[0][0]);
      if (lane == 0) mbar_arrive(sm.v_empty(sp));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }
      pack_p();
    }
    mbar_wait(sm.v_full(stage(hi - 1)), parity(hi - 1));
    hold<D / 2>(acc);
    hold<kBN / 4>(&pa[0][0]);
    turn_begin(cw);
    wg_fence();
    issue_pv(stage(hi - 1));
    turn_end(cw);
    hold<D / 2>(acc);
    wg_wait<0>();
    hold<D / 2>(acc);
    hold<kBN / 4>(&pa[0][0]);
    if (lane == 0) mbar_arrive(sm.v_empty(stage(hi - 1)));
  }
  for (int kt = hi; kt < n_tiles; ++kt) release_unread(kt);
  if (lo >= hi) {                        // the turn of the last P V
    turn_begin(cw);
    turn_end(cw);
  }

  l_a += __shfl_xor_sync(kFull, l_a, 1);
  l_a += __shfl_xor_sync(kFull, l_a, 2);
  l_b += __shfl_xor_sync(kFull, l_b, 1);
  l_b += __shfl_xor_sync(kFull, l_b, 2);
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* o_a = o + row_a * oss + col0;
  __nv_bfloat16* o_b = o_a + 8 * oss;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row_a < sq) {
      *reinterpret_cast<uint32_t*>(o_a + 8 * j) =
          pack_bf16(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    }
    if (row_a + 8 < sq) {
      *reinterpret_cast<uint32_t*>(o_b + 8 * j) =
          pack_bf16(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int hq, int group, int sq,
                   int sk, long long osb, long long osh, long long oss,
                   float scale_log2, int causal, int window) {
  using P = WgPlan<D>;
  extern __shared__ unsigned char smem_raw[];
  WgSmem<D> sm;
  sm.base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) +
             1023u) & ~1023u;

  // blocks start in the order of their linear index, x fastest: every
  // head's heaviest causal tile first
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int q0 = q_tile * kWgBlockQ;
  const int k_tiles = (sk + P::kBN - 1) / P::kBN;
  int n_tiles = k_tiles;
  if (causal) {
    const int hi = (q0 + kWgBlockQ + P::kBN - 1) / P::kBN;
    n_tiles = hi < k_tiles ? hi : k_tiles;
  }
  const int kt_lo = first_key_tile(q0, window, P::kBN);

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.k_empty(s), kConsumerWarps);
      mbar_init(sm.v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if-else for the two roles, never reconverging, so that ptxas
  // can honour setmaxnreg.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 0) {
      produce<D>(sm, &tm_q, &tm_k, &tm_v, q0, h, h / group, b, kt_lo,
                 n_tiles);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    consume<D>(sm, cw, o + b * osb + h * osh, oss, sq, sk, q0 + 64 * cw,
               kt_lo, n_tiles, scale_log2, causal, window);
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The 4-d map (d, s, h, b) of a bf16 tensor addressed as base +
// b*st[0] + h*st[1] + t*st[2] + d (elements), boxes of (cols, rows).  A
// dim of size 1 gets the packed stride: it is never stepped over, and
// any stride of its own (0 for an expanded view) may not be one TMA
// takes.  Returns 0 or a CUDA error.
int make_map(CUtensorMap* map, const void* base, int d, int s, int h, int b,
             const long long* st, int cols, int rows,
             CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t packed[3] = {2ull * d, 2ull * d * s, 2ull * d * s * h};
  const long long given[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed[i]
                                  : static_cast<cuuint64_t>(given[i]) * 2;
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int batch, int hq, int hkv, int sq, int sk,
                const long long* st, float scale, int causal, int window,
                cudaStream_t stream) {
  using P = WgPlan<D>;
  const CUtensorMapSwizzle swizzle = P::kRowBytes == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_map(&tm_q, q, D, sq, hq, batch, st, P::kCW, kWgBlockQ,
                     swizzle);
  if (err == 0) {
    err = make_map(&tm_k, k, D, sk, hkv, batch, st + 3, P::kCW, P::kBN,
                   swizzle);
  }
  if (err == 0) {
    err = make_map(&tm_v, v, D, sk, hkv, batch, st + 6, P::kCW, P::kBN,
                   swizzle);
  }
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(batch * hq, (sq + kWgBlockQ - 1) / kWgBlockQ);
  flash_wgmma_kernel<D><<<grid, kWgThreads, P::kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), hq, hq / hkv, sq,
      sk, st[9], st[10], st[11], scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int batch, int hq, int hkv, int sq, int sk, const long long* st,
           int block_n, int stages, float scale, int causal, int window,
           cudaStream_t stream) {
  if (dtype == 1) {
    // the caller's plan must be the one compiled here
    if (block_n != WgPlan<D>::kBN || stages != WgPlan<D>::kStages) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_bf16<D>(q, k, v, o, batch, hq, hkv, sq, sk, st, scale,
                          causal, window, stream);
  }
  if constexpr (D > 128) {
    // float32 takes D <= 128 only (see the note at the top)
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return launch_f32<D>(q, k, v, o, batch, hq, hkv, sq, sk, st, scale,
                         causal, window, stream);
  }
}

}  // namespace

extern "C" {

// Launch K4 on `stream`.  q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) and o
// (B, Hq, Sq, D) are addressed as base + b*s[0] + h*s[1] + t*s[2] + d,
// in elements, with `strides` = {q's 3, k's 3, v's 3, o's 3}; the head
// dim is contiguous, every base is 16-byte aligned and every stride a
// multiple of 16 bytes.  dtype: 0 for float32, 1 for bfloat16.  D is 32,
// 64 or 128, or 256 in bfloat16.  block_n and stages are the caller's
// plan for bfloat16 (kernels/flash_attention.py::PLAN) and must be this
// file's WgPlan<D>; float32 ignores them.  window > 0 masks keys at or
// before q_pos - window and implies causal; 0 is no window.  Returns 0
// on success, else a CUDA error: a refused tensor map, or
// cudaGetLastError() after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int dtype, int batch, int hq, int hkv,
                        int sq, int sk, int d, const long long* strides,
                        int block_n, int stages, float scale, int causal,
                        int window, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      sk <= 0 || window < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (window > 0) causal = 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                        block_n, stages, scale, causal, window, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                        block_n, stages, scale, causal, window, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                         block_n, stages, scale, causal, window, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, batch, hq, hkv, sq, sk, strides,
                         block_n, stages, scale, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
