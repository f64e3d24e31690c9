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
// every row of the block are skipped.
//
// Bound on an H100: operations.  A live query-key pair costs 4 * hd
// operations (two products) against 2 * hd elements of q and out per row
// and of k and v per key, so at the serving shapes (thousands of keys per
// row) the tensor-core rate, not the memory, sets the bound.
//
// Both kernels give one block 64 query rows of one (batch, KV head), the
// (position, group) pairs flattened, so the G query heads that share a KV
// head share every K and V tile staged in shared memory, and each block
// streams the live key tiles of its KV head once.
//
// - bfloat16 (the serving path): mma.sync tensor-core products, below.
// - float32: products in f32 on the CUDA cores, which keeps the f32
//   results within 2e-5 of the plain version (tf32 products would not).
//   Each thread holds a 4 x 4 block of the logits and a 4-row strip of the
//   output in registers and reads its operands from shared memory as float4
//   along hd; K and V share one tile buffer (K, then V), so a block needs
//   85 KB at hd = 128 and two blocks fit on an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 64;         // query rows of a block: (position, group) pairs
constexpr int kKeys = 64;         // keys of a shared-memory tile
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

// -- float32: products on the CUDA cores ---------------------------------------

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
                     const float* __restrict__ v, float* __restrict__ o, int S,
                     int n_keys, int KH, int G, int hd, float scale, int causal,
                     int window, int q_offset) {
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

// -- bfloat16: tensor-core products -----------------------------------------------
//
// Each warp takes 16 query rows and runs both products as
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators): S = Q K^T over hd in
// steps of 16, then O += P V over the tile's keys, with P rounded to bf16 as
// the A operand (the JAX reference rounds it likewise; the TPU kernel keeps
// it in f32).  The row max and sum of the online softmax use the f32
// logits.  Q, K and V tiles sit in shared memory as bf16 with rows padded
// by 16 bytes, which keeps the fragment loads free of bank conflicts; V's
// fragments come through ldmatrix.trans.

constexpr int kMmaWarps = kRows / 16;      // a warp takes 16 query rows
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kKeyChunks = kKeys / 8;      // n8 chunks of S
constexpr int kMaxK16 = kMaxHd / 16;       // k16 steps of Q K^T
constexpr int kMaxN8 = kMaxHd / 8;         // n8 chunks of O

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// n rows of src (row i at src_row(i)) into s[n][ld], hd padded with zeros
// to hdp; rows past `valid` are zero.  16-byte vectors: hd % 8 == 0.
template <typename RowFn>
__device__ void stage_bf16(__nv_bfloat16* s, int n, int valid, int hd,
                           int hdp, int ld, RowFn src_row) {
  const int nc = hdp / 8;
  for (int i = threadIdx.x; i < n * nc; i += kMmaThreads) {
    const int row = i / nc, c = (i % nc) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid && c < hd)
      val = *reinterpret_cast<const uint4*>(src_row(row) + c);
    *reinterpret_cast<uint4*>(s + row * ld + c) = val;
  }
}

__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int n_keys, int KH,
                     int G, int hd, float scale, int causal, int window,
                     int q_offset) {
  extern __shared__ uint4 smem16[];
  const int hdp = (hd + 15) & ~15;
  const int ld = hdp + 8;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem16);  // [rows][ld]
  __nv_bfloat16* sk = sq + kRows * ld;                          // [keys][ld]
  __nv_bfloat16* sv = sk + kKeys * ld;                          // [keys][ld]

  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int g = ln / 4, t = ln % 4;   // the mma fragments' group and lane
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int rows = S * G;
  const int r0 = blockIdx.x * kRows;
  const int nk16 = hdp / 16;
  const size_t kstride = static_cast<size_t>(KH) * hd;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * n_keys * KH + kh) * hd;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * n_keys * KH + kh) * hd;
  auto q_row = [&](int r) {
    return ((static_cast<size_t>(b) * S + r / G) * KH + kh) * G * hd +
           static_cast<size_t>(r % G) * hd;
  };

  stage_bf16(sq, kRows, rows - r0, hd, hdp, ld,
             [&](int row) { return q + q_row(r0 + row); });
  __syncthreads();
  // this thread's rows: A = warp * 16 + g and B = A + 8
  const int row_a = warp * 16 + g;
  uint32_t qf[kMaxK16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxK16; ++kk) {
    if (kk < nk16) {
      const __nv_bfloat16* pa = sq + row_a * ld + 16 * kk + 2 * t;
      qf[kk][0] = ld32(pa);
      qf[kk][1] = ld32(pa + 8 * ld);
      qf[kk][2] = ld32(pa + 8);
      qf[kk][3] = ld32(pa + 8 * ld + 8);
    }
  }

  const int last = min(r0 + kRows, rows) - 1;
  const int q_lo = r0 / G + q_offset;
  const int q_hi = last / G + q_offset;
  int qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = min(r0 + row_a + 8 * h, last) / G + q_offset;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float acc[kMaxN8][4];
#pragma unroll
  for (int n = 0; n < kMaxN8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_tiles = (n_keys + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, q_hi / kKeys + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kKeys;
    if (window > 0 && k0 + kKeys - 1 <= q_lo - window) continue;  // whole block
    __syncthreads();   // the last tile's readers of sk and sv are done
    stage_bf16(sk, kKeys, n_keys - k0, hd, hdp, ld,
               [&](int row) { return kb + static_cast<size_t>(k0 + row) * kstride; });
    stage_bf16(sv, kKeys, n_keys - k0, hd, hdp, ld,
               [&](int row) { return vb + static_cast<size_t>(k0 + row) * kstride; });
    __syncthreads();

    // S = Q K^T: chunk j holds keys 8j + 2t, 8j + 2t + 1 of rows A (0, 1)
    // and B (2, 3)
    float s[kKeyChunks][4];
#pragma unroll
    for (int j = 0; j < kKeyChunks; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* pk = sk + (8 * j + g) * ld + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kMaxK16; ++kk)
        if (kk < nk16) mma_bf16(s[j], qf[kk], ld32(pk + 16 * kk), ld32(pk + 16 * kk + 8));
    }

    // online softmax over f32 logits; a row's keys are spread over the four
    // threads of its quad, so row reductions are shuffles over lane bits 0-1
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kKeyChunks; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = key < n_keys && (!causal || key <= qpos[h]) &&
                        (window <= 0 || key > qpos[h] - window);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKeyChunks; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e / 2]);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < kMaxN8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: P's accumulator layout is the A operand's, two key chunks
    // per k16 step; V's B fragments come transposed from row-major sv
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mat = ln / 8;   // ldmatrix: lane gives row ln % 8 of matrix mat
      const __nv_bfloat16* pv =
          sv + (16 * kk + (mat & 1) * 8 + ln % 8) * ld + (mat >> 1) * 8;
#pragma unroll
      for (int n = 0; n < kMaxN8; n += 2) {
        if (8 * n < hdp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, pv + 8 * n);
          mma_bf16(acc[n], pa, vf[0], vf[1]);
          mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + row_a + 8 * h;
    if (r >= rows) continue;
    const float d = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* out = o + q_row(r);
#pragma unroll
    for (int n = 0; n < kMaxN8; ++n) {
      if (8 * n < hd)
        *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * t) =
            pack_bf16(acc[n][2 * h] / d, acc[n][2 * h + 1] / d);
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int n_keys, int KH, int G, int hd, float scale,
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
      static_cast<const float*>(v), static_cast<float*>(o), S, n_keys, KH, G,
      hd, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int n_keys, int KH, int G, int hd, float scale,
               int causal, int window, int q_offset, void* stream) {
  const size_t smem = static_cast<size_t>(kRows + 2 * kKeys) *
                      (((hd + 15) & ~15) + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S * G + kRows - 1) / kRows, B * KH);
  flash_fwd_mma_kernel<<<grid, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      n_keys, KH, G, hd, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_fwd_f32(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int T, int K, int G,
                                   int hd, float scale, int causal, int window,
                                   int q_offset, void* stream) {
  return launch_f32(q, k, v, o, B, S, T, K, G, hd, scale, causal, window,
                    q_offset, stream);
}

extern "C" int repro_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int S, int T, int K, int G,
                                    int hd, float scale, int causal, int window,
                                    int q_offset, void* stream) {
  return launch_mma(q, k, v, o, B, S, T, K, G, hd, scale, causal, window,
                    q_offset, stream);
}
