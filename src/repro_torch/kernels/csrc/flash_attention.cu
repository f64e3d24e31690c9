// Flash attention forward for grouped queries (kernel B3).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (flash_attention_tpu).  q is [B, S, K, G, hd] and k, v are [B, T, K, hd],
// read in place: query head (k, g) attends KV head k.  For each query row
// the kernels compute what the TPU kernel does: logits (q . k) * 1/sqrt(hd);
// -1e30 where a key lies past T, above the causal diagonal or outside the
// sliding window; an online softmax whose running max m, sum l and
// accumulator stay in f32; out = acc / max(l, 1e-30) in the storage type.
// Key tiles that lie wholly above the diagonal or outside the window of
// every row of the block are skipped.  Given an lse pointer, both kernels
// also store each row's logsumexp, lse = m + log(max(l, 1e-30)) in f32 and
// natural log, as [B, K, G, S] from their epilogue (the residual of the
// blockwise backward, repro.kernels.ref._flash_bwd); a row that sees no
// live key keeps m = -1e30, as in the reference.  A null pointer skips the
// store.
//
// Bound on an H100: operations.  A live query-key pair costs 4 * hd
// operations (two products) against 2 * hd elements of q and out per row
// and of k and v per key, so at the serving shapes (thousands of keys per
// row) the tensor-core rate, not the memory, sets the bound.
//
// Both kernels give a block flattened (position, group) query rows of one
// (batch, KV head), so the G query heads that share a KV head share every
// K and V tile staged in shared memory, and each block streams the live
// key tiles of its KV head once.
//
// - bfloat16 (the serving path): TMA loads, wgmma products and warp
//   specialisation, below.
// - float32: products in f32 on the CUDA cores, which keeps the f32
//   results within 2e-5 of the plain version (tf32 products would not).
//   A block takes 64 rows.  Each thread holds a 4 x 4 block of the logits
//   and a 4-row strip of the output in registers and reads its operands
//   from shared memory as float4 along hd; K and V share one tile buffer
//   (K, then V), so a block needs 85 KB at hd = 128 and two blocks fit on
//   an SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

// -- float32: products on the CUDA cores ---------------------------------------

constexpr int kRows = 64;         // query rows of a block: (position, group) pairs
constexpr int kKeys = 64;         // keys of a shared-memory tile

constexpr int kThreads = 256;     // 16 x 16: thread (ty, tx) takes rows ty + 16 i
constexpr int kGrid = 16;         // and keys tx + 16 j, i, j < 4
constexpr int kPer = kRows / kGrid;
constexpr int kOutChunks = kMaxHd / 4 / kGrid;  // float4 output chunks a thread holds
constexpr int kLdp = kKeys + 4;   // row stride of the probability tile

__device__ __forceinline__ float lane(const float4& a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// Keys [k0, k0 + kKeys) of one (batch, KV head) into s[kKeys][ld]; rows
// past T are zero.  src points at key 0; keys are `stride` apart.
__device__ void stage_keys(float* s, const float* src, size_t stride, int k0,
                           int n_keys, int hd, int ld) {
  const int nd4 = hd / 4;
  for (int i = threadIdx.x; i < kKeys * nd4; i += kThreads) {
    const int row = i / nd4, c = (i % nd4) * 4;
    const int t = k0 + row;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < n_keys)
      val = *reinterpret_cast<const float4*>(src + static_cast<size_t>(t) * stride + c);
    *reinterpret_cast<float4*>(s + row * ld + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int n_keys, int KH, int G,
                     int hd, float scale, int causal, int window, int q_offset) {
  extern __shared__ float4 smem4[];
  const int ld = hd + 4;            // keeps float4 reads of 8 rows conflict-free
  float* sq = reinterpret_cast<float*>(smem4);   // [kRows][ld]
  float* skv = sq + kRows * ld;                  // [kKeys][ld]: K, then V
  float* sp = skv + kKeys * ld;                  // [kRows][kLdp]

  const int tx = threadIdx.x % kGrid, ty = threadIdx.x / kGrid;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int rows = S * G;
  const int r0 = blockIdx.x * kRows;
  const int nd4 = hd / 4;
  const size_t kstride = static_cast<size_t>(KH) * hd;
  const size_t kbase = (static_cast<size_t>(b) * n_keys * KH + kh) * hd;

  // row r = s * G + g of this (batch, KV head) is q[b, s, kh, g, :]
  auto q_row = [&](int r) {
    return ((static_cast<size_t>(b) * S + r / G) * KH + kh) * G * hd +
           static_cast<size_t>(r % G) * hd;
  };

  for (int i = threadIdx.x; i < kRows * nd4; i += kThreads) {
    const int row = i / nd4, c = (i % nd4) * 4;
    const int r = r0 + row;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) val = *reinterpret_cast<const float4*>(q + q_row(r) + c);
    *reinterpret_cast<float4*>(sq + row * ld + c) = val;
  }

  const int last = min(r0 + kRows, rows) - 1;
  const int q_lo = r0 / G + q_offset;
  const int q_hi = last / G + q_offset;
  int qpos[kPer];
  float m[kPer], l[kPer];
  float4 acc[kPer][kOutChunks];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    // rows past the end take the last row's position; they are never stored
    qpos[i] = min(r0 + ty + kGrid * i, last) / G + q_offset;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutChunks; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int n_tiles = (n_keys + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, q_hi / kKeys + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kKeys;
    if (window > 0 && k0 + kKeys - 1 <= q_lo - window) continue;  // whole block
    __syncthreads();   // the last tile's readers of skv and sp are done
    stage_keys(skv, k + kbase, kstride, k0, n_keys, hd, ld);
    __syncthreads();

    float s[kPer][kPer] = {};
    for (int c = 0; c < hd; c += 4) {
      float4 qa[kPer], ka[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(sq + (ty + kGrid * i) * ld + c);
        ka[i] = *reinterpret_cast<const float4*>(skv + (tx + kGrid * i) * ld + c);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // online softmax; a row's 64 keys are spread over the 16 threads of its
    // half-warp, so row reductions are shuffles over lane bits 0-3
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int t = k0 + tx + kGrid * j;
        const bool ok = t < n_keys && (!causal || t <= qpos[i]) &&
                        (window <= 0 || t > qpos[i] - window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kGrid; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty + kGrid * i) * kLdp + tx + kGrid * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < kGrid; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutChunks; ++j) {
        acc[i][j].x *= corr;
        acc[i][j].y *= corr;
        acc[i][j].z *= corr;
        acc[i][j].w *= corr;
      }
    }
    __syncthreads();   // K is no longer read and sp is complete
    stage_keys(skv, v + kbase, kstride, k0, n_keys, hd, ld);
    __syncthreads();

    for (int key = 0; key < kKeys; key += 4) {
      float4 pa[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sp + (ty + kGrid * i) * kLdp + key);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = skv + (key + u) * ld;
        float4 va[kOutChunks];
#pragma unroll
        for (int j = 0; j < kOutChunks; ++j) {
          const int c4 = tx + kGrid * j;
          va[j] = c4 < nd4 ? *reinterpret_cast<const float4*>(vrow + c4 * 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kOutChunks; ++j) fma4(acc[i][j], lane(pa[i], u), va[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + ty + kGrid * i;
    if (r >= rows) continue;
    const float d = fmaxf(l[i], 1e-30f);
    // every thread of the half-warp holds the row's m and l
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(blockIdx.y) * G + r % G) * S + r / G] = m[i] + logf(d);
    float* out = o + q_row(r);
#pragma unroll
    for (int j = 0; j < kOutChunks; ++j) {
      const int c4 = tx + kGrid * j;
      if (c4 < nd4)
        *reinterpret_cast<float4*>(out + c4 * 4) = make_float4(
            acc[i][j].x / d, acc[i][j].y / d, acc[i][j].z / d, acc[i][j].w / d);
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int S, int n_keys, int KH, int G, int hd, float scale,
               int causal, int window, int q_offset, void* stream) {
  const size_t smem =
      (static_cast<size_t>(kRows + kKeys) * (hd + 4) + kRows * kLdp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S * G + kRows - 1) / kRows, B * KH);
  flash_fwd_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, n_keys, KH, G, hd, scale, causal, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16: TMA, wgmma and warp specialisation ---------------------------------
//
// A block takes kBlockRows = 128 flattened (position, group) query rows of
// one (batch, KV head) and runs as three warpgroups.  Warpgroups 0 and 1
// (the consumers, 64 rows each: wgmma's M) compute; one warp of warpgroup
// 2 (the producer) streams the live K and V tiles of kTileKeys keys through
// a ring of kStages shared-memory stages with TMA, each stage guarded by a
// full barrier for K, one for V (the TMA's byte count completes them) and
// an empty barrier (one arrival per consumer warp).  setmaxnreg gives the
// producer's registers to the consumers.
//
// Shared memory holds every operand in wgmma's 128-byte swizzled layout:
// column chunks of 64 bf16 (128 bytes) by the tile's rows, so hd <= 64 is
// one chunk and hd <= 128 two.  TMA writes K and V in that layout (a map of
// dims (hd, KH, T, B) reads zeros past hd and past T); the consumers write
// Q in it with 16-byte loads, since the flattened rows are one strided box
// only when G divides 128.
//
// Per key tile, each consumer warpgroup computes S = Q K^T with
// wgmma m64n128k16 (A = Q and B = K from shared memory, f32 accumulators),
// the online softmax in registers in base 2 (the logits scaled by
// scale * log2(e) in the FMA that feeds ex2), masks only on tiles that
// cross T, the causal diagonal or the window edge, rounds P to bf16 in
// registers and computes O += P V with P as wgmma's register A operand and
// V from shared memory as an MN-major B.  The row max and sum use the f32
// logits, as the JAX reference does.  Two overlaps keep the tensor cores
// fed: a warpgroup issues tile i's S together with tile i - 1's P V, so its
// softmax of tile i runs while P V does; and the two warpgroups take turns
// to issue (named barriers), so one's softmax runs while the other's
// products do.  Blocks are issued heaviest first (the last row blocks see
// the most causal key tiles).
//
// At hd = 128 a block needs 224 KB of shared memory (Q 32 KB, three stages
// of K and V at 64 KB), so one block runs on an SM.  Each K/V tile feeds
// 128 rows, so the K and V of a (batch, KV head) are read from L2 once per
// 128 flattened rows: 64 KB per 4.2e6 multiply-adds.

constexpr int kBlockRows = 128;        // query rows of a block
constexpr int kTileKeys = 128;         // keys of a K or V tile
constexpr int kStages = 3;             // K/V ring depth
constexpr int kWgThreads = 128;
constexpr int kConsumers = 2;          // consumer warpgroups
constexpr int kWgmmaThreads = (kConsumers + 1) * kWgThreads;
constexpr int kChunkBytes = 128;       // one swizzled row of 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// 2^x on the special-function unit; denormal results flush to zero, which
// spares exp2f's rescaling of them (p is rounded to bf16 before use)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma's shared-memory operand descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins accumulator registers in place across an asynchronous wgmma, so the
// compiler neither reads them before the wait nor reuses them in between
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for a register A operand, which wgmma reads until it completes
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// A = Q and B = K from shared memory, both K-major: S[64 x 128] (+)= A B^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// A = P from registers, B = V from shared memory, MN-major: O (+)= P V
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int NC>   // column chunks of 64: hd <= 64 * NC
struct WgmmaTile {
  static constexpr int kOut = 32 * NC;                    // O registers
  static constexpr int kQBytes = NC * kBlockRows * kChunkBytes;
  static constexpr int kKvBytes = NC * kTileKeys * kChunkBytes;  // a K or V tile
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKvBytes + 3 * kStages * 8 + 1024;  // + alignment
};

template <int NC>
__device__ __forceinline__ void wgmma_pv(float (&o)[32 * NC], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NC == 1) wgmma_rs_n64(o, a, db, 1);
  else wgmma_rs_n128(o, a, db, 1);
}

template <int NC>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ q,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int S, int n_keys, int KH, int G, int hd, float scale_log2,
                       int causal, int window, int q_offset, int n_heads) {
  using Tile = WgmmaTile<NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* sk = sq + Tile::kQBytes;                    // [stage][chunk][key][128 B]
  uint8_t* sv = sk + kStages * Tile::kKvBytes;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sv + kStages * Tile::kKvBytes);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  // heaviest row blocks first: the last blocks of a causal run see the
  // most key tiles
  const int n_row_blocks = gridDim.x / n_heads;
  const int rb = n_row_blocks - 1 - static_cast<int>(blockIdx.x) / n_heads;
  const int bh = static_cast<int>(blockIdx.x) % n_heads;
  const int b = bh / KH, kh = bh % KH;
  const int rows = S * G;
  const int r0 = rb * kBlockRows;
  const int last = min(r0 + kBlockRows, rows) - 1;
  const int q_lo = r0 / G + q_offset;
  const int q_hi = last / G + q_offset;
  // the live key tiles of the block, [t_begin, t_end)
  int t_end = (n_keys + kTileKeys - 1) / kTileKeys;
  if (causal) t_end = min(t_end, q_hi / kTileKeys + 1);
  const int t_begin = window > 0 ? max(q_lo - window + 1, 0) / kTileKeys : 0;
  const int n_tiles = max(t_end - t_begin, 0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumers * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == kConsumers) {
    // -- producer: one thread issues every TMA load ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * kWgThreads) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap))
                   : "memory");
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        const int key0 = (t_begin + i) * kTileKeys;
        mbar_wait(&empty[stage], parity ^ 1);
        mbar_expect_tx(&full_k[stage], Tile::kKvBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(sk + stage * Tile::kKvBytes + c * kTileKeys * kChunkBytes,
                      &kmap, &full_k[stage], 64 * c, kh, key0, b);
        mbar_expect_tx(&full_v[stage], Tile::kKvBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(sv + stage * Tile::kKvBytes + c * kTileKeys * kChunkBytes,
                      &vmap, &full_v[stage], 64 * c, kh, key0, b);
      }
    }
  } else {
    // -- consumers: 64 query rows each ------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32, ln = tid % 32;
    const int g = ln / 4, t = ln % 4;    // the accumulators' row group and lane
    const int wr0 = r0 + wg * 64;        // this warpgroup's first row
    auto q_row = [&](int r) {
      return ((static_cast<size_t>(b) * S + r / G) * KH + kh) * G * hd +
             static_cast<size_t>(r % G) * hd;
    };

    // Q rows [wr0, wr0 + 64) into the swizzled layout, zero past hd and rows
    for (int i = tid; i < 64 * NC * 8; i += kWgThreads) {
      const int row = i / (NC * 8), c = (i % (NC * 8)) / 8, grp = i % 8;
      const int col = 64 * c + 8 * grp;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (wr0 + row < rows && col < hd)
        val = *reinterpret_cast<const uint4*>(q + q_row(wr0 + row) + col);
      *reinterpret_cast<uint4*>(sq + c * kBlockRows * kChunkBytes +
                                (wg * 64 + row) * kChunkBytes +
                                ((grp ^ (row % 8)) * 16)) = val;
    }
    // the generic-proxy stores above must be visible to wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + wg, kWgThreads);

    // this thread's rows: A = 16 warp + g and B = A + 8 of the warpgroup
    const int wlast = min(wr0 + 63, last);
    const int wq_lo = min(wr0, last) / G + q_offset;
    const int wq_hi = wlast / G + q_offset;
    int qpos[2];
    float m[2], l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qpos[h] = min(wr0 + 16 * warp + g + 8 * h, last) / G + q_offset;
      m[h] = kNegInf;
      l[h] = 0.f;
    }
    float acc[Tile::kOut];
#pragma unroll
    for (int i = 0; i < Tile::kOut; ++i) acc[i] = 0.f;
    const uint8_t* sq_wg = sq + wg * 64 * kChunkBytes;

    // Tile i's S = Q K^T is issued together with tile i - 1's O += P V, so
    // the softmax of tile i runs on the CUDA cores while the tensor cores
    // work on P V; wgmma groups complete in order.
    float s[kTileKeys / 2];
    uint32_t pa[kTileKeys / 16][4];
    auto issue_s = [&](int i) {   // S = Q K^T, hd in steps of 16 (32 bytes)
      const uint8_t* sk_s = sk + (i % kStages) * Tile::kKvBytes;
#pragma unroll
      for (int kk = 0; kk < 4 * NC; ++kk) {
        const int off = (kk / 4) * kBlockRows * kChunkBytes + (kk % 4) * 32;
        const int koff = (kk / 4) * kTileKeys * kChunkBytes + (kk % 4) * 32;
        wgmma_ss_n128(s, sw128_desc(sq_wg + off, 16, 1024),
                      sw128_desc(sk_s + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int i) {  // O += P V, 16 keys (2048 bytes) per step
      const uint8_t* sv_s = sv + (i % kStages) * Tile::kKvBytes;
#pragma unroll
      for (int kk = 0; kk < kTileKeys / 16; ++kk)
        wgmma_pv<NC>(acc, pa[kk],
                     sw128_desc(sv_s + kk * 16 * kChunkBytes,
                                kTileKeys * kChunkBytes, 1024));
      wgmma_commit();
    };
    // the online softmax of tile i over s, in base 2: p = 2^(s c - m c) with
    // c = scale * log2(e); returns each row's correction of acc and leaves
    // p in s.  s[4j + e] holds key 8j + 2t + (e & 1) of row A (e < 2) or B.
    auto softmax = [&](int i, float (&corr)[2]) {
      const int key0 = (t_begin + i) * kTileKeys;
      const bool edge = key0 + kTileKeys > n_keys ||
                        (causal && key0 + kTileKeys - 1 > wq_lo) ||
                        (window > 0 && key0 <= wq_hi - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kTileKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * j + 2 * t + (e & 1);
            const int qp = qpos[e / 2];
            const bool ok = key < n_keys && (!causal || key <= qp) &&
                            (window <= 0 || key > qp - window);
            if (!ok) s[4 * j + e] = kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf}, mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kTileKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = exp2_ftz((m[h] - m_new) * scale_log2);
        m[h] = m_new;
        mc[h] = m_new * scale_log2;
      }
      if (edge) {
        // s c - m c rounds to a huge value, not 0, where s = m = -1e30.  A
        // masked key weighs 1 where every key of its row so far is masked
        // (m = -1e30, as in the reference) and 0 elsewhere.
#pragma unroll
        for (int j = 0; j < kTileKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (s[4 * j + e] == kNegInf)
              s[4 * j + e] = m[e / 2] == kNegInf ? 0.f : -__int_as_float(0x7f800000);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (m[h] == kNegInf) mc[h] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTileKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = exp2_ftz(fmaf(s[4 * j + e], scale_log2, -mc[e / 2]));
          sum[e / 2] += s[4 * j + e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * corr[h] + sum[h];
      }
    };
    // P in bf16 as wgmma's A fragments: keys 16kk..16kk+15 are the
    // accumulator chunks 2kk and 2kk + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kTileKeys / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto parity = [](int i) { return static_cast<uint32_t>((i / kStages) & 1); };

    // The two consumer warpgroups take turns on the tensor cores: each
    // issues its products between my_turn() and your_turn() (named barriers
    // 3 and 4), so one warpgroup's softmax runs while the other's products
    // do.  Warpgroup 0 goes first; each issues n_tiles + 1 batches.
    auto my_turn = [&]() { bar_sync(3 + wg, 2 * kWgThreads); };
    auto your_turn = [&]() { bar_arrive(4 - wg, 2 * kWgThreads); };
    if (n_tiles > 0) {
      float corr[2];
      if (wg == 1) your_turn();
      mbar_wait(&full_k[0], 0);
      wgmma_fence();
      my_turn();
      issue_s(0);
      your_turn();
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0, corr);                  // acc is still zero
      pack_p();
    }
    for (int i = 1; i < n_tiles; ++i) {
      float corr[2];
      mbar_wait(&full_k[i % kStages], parity(i));
      mbar_wait(&full_v[(i - 1) % kStages], parity(i - 1));
      fence_regs(acc);
      wgmma_fence();
      my_turn();
      issue_s(i);
      issue_pv(i - 1);
      your_turn();
      wgmma_wait<1>();                   // S of tile i
      fence_regs(s);
      softmax(i, corr);
      wgmma_wait<0>();                   // P V of tile i - 1
      fence_regs(acc);
      fence_regs(pa);
      if (ln == 0) mbar_arrive(&empty[(i - 1) % kStages]);
#pragma unroll
      for (int j = 0; j < Tile::kOut / 4; ++j) {
        acc[4 * j + 0] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      pack_p();
    }
    if (n_tiles > 0) {
      const int i = n_tiles - 1;
      mbar_wait(&full_v[i % kStages], parity(i));
      fence_regs(acc);
      wgmma_fence();
      my_turn();
      issue_pv(i);
      if (wg == 0) your_turn();          // warpgroup 1 issues last
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (ln == 0) mbar_arrive(&empty[i % kStages]);
    }

    // acc[4j + e] holds column 8j + 2t + (e & 1) of row A (e < 2) or B
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr0 + 16 * warp + g + 8 * h;
      if (r >= rows) continue;
      const float d = fmaxf(l[h], 1e-30f);
      // m is the row's largest unscaled logit and l sums 2^(s c - m c), so
      // the natural logsumexp of the scaled logits is (m c + log2 l) ln 2;
      // the four lanes of a row hold the same m and l
      if (lse != nullptr && t == 0)
        lse[(static_cast<size_t>(bh) * G + r % G) * S + r / G] =
            m[h] == kNegInf ? kNegInf + logf(d)
                            : (m[h] * scale_log2 + log2f(d)) * kLn2;
      __nv_bfloat16* out = o + q_row(r);
#pragma unroll
      for (int j = 0; j < Tile::kOut / 4; ++j) {
        if (8 * j < hd)
          *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
              pack_bf16(acc[4 * j + 2 * h] / d, acc[4 * j + 2 * h + 1] / d);
      }
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no link against libcuda
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// a map of k or v [B, T, K, hd] as dims (hd, K, T, B) whose box is one
// 64-column chunk of kTileKeys keys of one (batch, KV head), 128-byte swizzle;
// reads past hd or T give zeros
bool kv_map(CUtensorMap* map, const void* base, int B, int T, int KH, int hd) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(KH),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * sizeof(__nv_bfloat16);
  const cuuint64_t strides[3] = {row, row * KH, row * KH * T};
  const cuuint32_t box[4] = {64, 1, kTileKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch_wgmma_nc(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int S, int n_keys, int KH, int G, int hd,
                    float scale, int causal, int window, int q_offset,
                    cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!kv_map(&kmap, k, B, n_keys, KH, hd) || !kv_map(&vmap, v, B, n_keys, KH, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = WgmmaTile<NC>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_heads = B * KH;
  const int n_row_blocks = (S * G + kBlockRows - 1) / kBlockRows;
  flash_fwd_wgmma_kernel<NC><<<n_row_blocks * n_heads, kWgmmaThreads, smem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, n_keys, KH, G,
      hd, scale * kLog2e, causal, window, q_offset, n_heads);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                 int B, int S, int n_keys, int KH, int G, int hd, float scale,
                 int causal, int window, int q_offset, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch_wgmma_nc<1>(q, k, v, o, lse, B, S, n_keys, KH, G, hd, scale,
                              causal, window, q_offset, s);
  return launch_wgmma_nc<2>(q, k, v, o, lse, B, S, n_keys, KH, G, hd, scale,
                            causal, window, q_offset, s);
}

}  // namespace

// lse: null, or f32 [B, K, G, S] for each row's logsumexp
extern "C" int repro_flash_fwd_f32(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int S, int T, int K,
                                   int G, int hd, float scale, int causal,
                                   int window, int q_offset, void* stream) {
  return launch_f32(q, k, v, o, lse, B, S, T, K, G, hd, scale, causal, window,
                    q_offset, stream);
}

extern "C" int repro_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                    void* o, void* lse, int B, int S, int T, int K,
                                    int G, int hd, float scale, int causal,
                                    int window, int q_offset, void* stream) {
  return launch_wgmma(q, k, v, o, lse, B, S, T, K, G, hd, scale, causal, window,
                      q_offset, stream);
}
