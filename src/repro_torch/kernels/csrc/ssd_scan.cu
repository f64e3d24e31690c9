// Mamba2's SSD chunked scan (kernel B4).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:_kernel
// (ssd_scan_tpu).  x is [b, s, h, p], a [b, s, h] the f32 log-decay, B and C
// [b, s, n] (one group, shared by all heads), all read where they lie; y is
// written in x's layout and dtype, the final state [b, h, p, n] in f32.  Per
// chunk of Q steps, with cs the cumulative sum of a inside the chunk:
//
//   y     = ((C B^T) * L) x + diag(exp(cs)) C h_prev,  L[i][j] = exp(cs_i - cs_j), j <= i
//   h_new = exp(cs_end) h_prev + sum_j exp(cs_end - cs_j) x_j B_j^T
//
// chunks in order from h = 0.  exp(cs_i - cs_j) is computed only for j <= i,
// where it is at most 1; above the diagonal it would overflow.  Steps past s
// (a ragged last chunk) read as x = 0, a = 0, B = C = 0: they leave the
// state as it is, so the final state is the state after step s.  Products
// and the carried state are f32; h_prev is rounded to x's dtype before the
// C h_prev term, as models/mamba2.py:ssd_chunked (the function the JAX model
// runs) rounds it.
//
// Bound on an H100: bytes.  At the serving shape (b 4, s 2048, h 32, p 64,
// n 128, chunk 64, bf16) the function moves 76.5 MB (x and y 34 MB each,
// B and C 4 MB each, a 1 MB, the state 4 MB) for 1.5e10 operations: 0.023 ms
// at 3.35 TB/s against 0.015 ms at the tensor cores' bf16 rate.
//
// Both kernels give a block one (batch, head) and a slice of kSlice = 32
// state rows (of p): the rows of the state are independent in p (y[:, i]
// and h[i, :] depend only on x[:, i]), so the block walks the chunks in
// order and keeps its [32, n] slice of h in registers, and nothing carries
// over between blocks.  At the serving shape that is 256 blocks, two per SM.
//
// bfloat16 (the serving path): tensor cores and cp.async.  Every product is
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators) fed by ldmatrix from
// shared memory, whose rows are padded by 16 bytes so that the eight rows
// of an 8 x 8 matrix fall in different banks.  Eight warps in two roles,
// each role with its own loop over the chunks; the roles meet at one block
// barrier a chunk, after which chunk c is in and chunk c - 1 is done with:
//   - row warp w (0-3) owns rows 16w..16w+15 of the chunk.  It computes
//     its row tile of C B^T over the live 16 x 16 tiles j <= w only (10 of
//     the 16 of a 64-step chunk), applies L to the score fragments in f32
//     (zero above the diagonal; exp as the MUFU's exp2), multiplies
//     (scores * L) x over the same tiles with the scores as the A operand
//     straight from the accumulators, adds exp(cs_i) C h_prev^T and writes
//     its rows of y in bf16.  The tile count is a template parameter, so
//     the loops have no branches and a k16 step's loads issue together.
//     Warps 0, 1 and 2, which have the fewest tiles, first start chunk
//     c + 1's loads: cp.async of 16 bytes a lane (a by 4) of B, of C, and of
//     the x slice and a, into the other of two shared-memory stages.
//   - state warp 4 + v holds state columns 32v..32v+31 of all 32 rows in
//     f32 accumulator fragments across the chunks.  Per chunk the four of
//     them write w x (w_j = exp(cs_end - cs_j)), split into three bf16
//     planes, to shared memory, then each scales its h by exp(cs_end),
//     adds (w x)^T B, and writes a bf16 copy of h for the next chunk's
//     C h_prev^T (h_prev is double-buffered, so the row warps read one copy
//     while the state warps write the other).
// Each warp scans a over the chunk for itself (shuffles).  Rows past s are
// filled with zeros, not loaded; rows past the chunk and columns past n stay
// zero from the start.  Where n or p is not a multiple of 8, or an input is
// not 16-byte aligned, the same stages are filled by plain loads instead.
// Shared memory is about 113 KB at n = 128 and registers 128 a thread, so
// two blocks (16 warps) share an SM.
//
// The split-operand rule: an operand that is exactly a bf16 value goes into
// the mma as it is, and an f32 operand is split into bf16 terms, hi =
// bf16(v), then bf16 of what is left, so the f32 tolerances hold:
//   C B^T          C, B inputs: exact products, f32 sums;
//   (scores*L) x   scores*L f32 -> hi + lo: at most 2^-16 of each term lost,
//                  against y's bf16 tolerance (1.2e-2 of its terms' sum);
//   C h_prev^T     h_prev already rounded to bf16: exact;
//   (w x)^T B      w x f32 -> hi + mid + lo: at most 2^-24 of each term,
//                  the size of f32 rounding, so the final state keeps the
//                  f32 tolerance (1e-5 of its terms' sum).
//
// float32: the products in f32 on the CUDA cores.  256 threads as a 16 x 16
// grid: the 64 x 64 score tile (each thread a 4 x 4 strip), then y
// [64, 32] (4 x 2 per thread), then the state update [32, n] (2 rows x 2
// float4 columns per thread).  B, C and h_prev sit in shared memory with a
// row stride of 4 * ceil(n / 4) + 4 floats, so the float4 reads of
// consecutive rows fall in different banks.  Loads are synchronous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kQ = 64;          // the largest chunk; shared tiles have kQ rows
constexpr int kSlice = 32;      // state rows (of p) of a block
constexpr int kMaxN = 128;      // the largest state width n
constexpr unsigned kFull = 0xffffffffu;

// inclusive cumsum of a chunk's a by one warp: rows ln and ln + 32
__device__ __forceinline__ void warp_cumsum(float& lo, float& hi, int ln) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_up_sync(kFull, lo, d);
    const float v = __shfl_up_sync(kFull, hi, d);
    if (ln >= d) {
      lo += u;
      hi += v;
    }
  }
  hi += __shfl_sync(kFull, lo, 31);
}

// -- float32: CUDA cores --------------------------------------------------------

constexpr int kThreads = 256;   // a 16 x 16 grid: tx = t % 16, ty = t / 16
constexpr int kGrid = 16;
constexpr int kLdS = kQ + 1;    // row stride of the score tile

__device__ __forceinline__ float dot4(const float4& u, const float4& v,
                                      float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    float* __restrict__ y, float* __restrict__ state, int S,
                    int H, int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int n4 = (N + 3) / 4;       // float4 columns of B, C and h
  const int ldn = 4 * n4 + 4;
  float* sC = reinterpret_cast<float*>(smem4);   // [kQ][ldn]
  float* sB = sC + kQ * ldn;                     // [kQ][ldn]
  float* sH = sB + kQ * ldn;                     // [kSlice][ldn] h_prev
  float* sX = sH + kSlice * ldn;                 // [kQ][kSlice]
  float* sS = sX + kQ * kSlice;                  // [kQ][kLdS] (C B^T) * L
  float* sCs = sS + kQ * kLdS;                   // [kQ] cumsum of a
  float* sEnd = sCs + kQ;                        // [kQ] exp(cs_end - cs_j)

  const int tid = threadIdx.x;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const int p0 = blockIdx.x * kSlice;
  const int hh = blockIdx.y;
  const size_t b = blockIdx.z;

  // this thread's state: rows ty + 16 r, float4 columns tx + 16 m
  float4 hreg[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < 2; ++m) hreg[r][m] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < kSlice * ldn; i += kThreads) sH[i] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();   // the last chunk's readers of the tiles are done

    // -- stage B, C and x's slice; zero past the chunk, past s, past n and p
    for (int i = tid; i < kQ * 4 * n4; i += kThreads) {
      const int row = i / (4 * n4), col = i % (4 * n4);
      const int t = t0 + row;
      float bv = 0.f, cv = 0.f;
      if (row < Q && t < S && col < N) {
        const size_t off = (b * S + t) * N + col;
        bv = Bm[off];
        cv = Cm[off];
      }
      sB[row * ldn + col] = bv;
      sC[row * ldn + col] = cv;
    }
    for (int i = tid; i < kQ * kSlice; i += kThreads) {
      const int row = i / kSlice, col = i % kSlice;
      const int t = t0 + row, pi = p0 + col;
      float xv = 0.f;
      if (row < Q && t < S && pi < P)
        xv = x[((b * S + t) * H + hh) * P + pi];
      sX[i] = xv;
    }
    // -- cumsum of a over the chunk by one warp (rows lane and lane + 32)
    if (tid < 32) {
      float lo = 0.f, hi = 0.f;
      if (tid < Q && t0 + tid < S) lo = a[(b * S + t0 + tid) * H + hh];
      if (tid + 32 < Q && t0 + tid + 32 < S)
        hi = a[(b * S + t0 + tid + 32) * H + hh];
      warp_cumsum(lo, hi, tid);
      const float cs_end = Q > 32 ? __shfl_sync(kFull, hi, Q - 33)
                                  : __shfl_sync(kFull, lo, Q - 1);
      sCs[tid] = lo;
      sCs[tid + 32] = hi;
      sEnd[tid] = tid < Q ? expf(cs_end - lo) : 0.f;
      sEnd[tid + 32] = tid + 32 < Q ? expf(cs_end - hi) : 0.f;
    }
    __syncthreads();

    // -- scores: (C_i . B_j) * exp(cs_i - cs_j) for j <= i, else 0
    {
      float acc[4][4] = {};
      for (int k = 0; k < n4; ++k) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cv[i] = *reinterpret_cast<const float4*>(sC + (ty + kGrid * i) * ldn + 4 * k);
          bv[i] = *reinterpret_cast<const float4*>(sB + (tx + kGrid * i) * ldn + 4 * k);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = ty + kGrid * i, col = tx + kGrid * j;
          float v = 0.f;
          if (col <= row && row < Q) v = acc[i][j] * expf(sCs[row] - sCs[col]);
          sS[row * kLdS + col] = v;
        }
    }
    __syncthreads();

    // -- y: rows ty + 16 r of the chunk, state rows tx + 16 c of the slice
    {
      float yi[4][2] = {}, yh[4][2] = {};
      for (int j = 0; j < Q; ++j) {
        const float x0 = sX[j * kSlice + tx], x1 = sX[j * kSlice + tx + kGrid];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float sv = sS[(ty + kGrid * r) * kLdS + j];
          yi[r][0] = fmaf(sv, x0, yi[r][0]);
          yi[r][1] = fmaf(sv, x1, yi[r][1]);
        }
      }
      for (int k = 0; k < n4; ++k) {
        float4 cv[4], hv[2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(sC + (ty + kGrid * r) * ldn + 4 * k);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          hv[q] = *reinterpret_cast<const float4*>(sH + (tx + kGrid * q) * ldn + 4 * k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 2; ++q) yh[r][q] = dot4(cv[r], hv[q], yh[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty + kGrid * r;
        const int t = t0 + row;
        if (row >= Q || t >= S) continue;
        const float decay = expf(sCs[row]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int pi = p0 + tx + kGrid * q;
          if (pi < P)
            y[((b * S + t) * H + hh) * P + pi] = yi[r][q] + decay * yh[r][q];
        }
      }
    }

    // -- state: h = exp(cs_end) h + sum_j exp(cs_end - cs_j) x_j B_j^T
    {
      const float dec = expf(sCs[Q - 1]);
      float4 upd[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int m = 0; m < 2; ++m) upd[r][m] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < Q; ++j) {
        const float w = sEnd[j];
        float xw[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) xw[r] = w * sX[j * kSlice + ty + kGrid * r];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int k4 = tx + kGrid * m;
          if (k4 >= n4) continue;
          const float4 bv = *reinterpret_cast<const float4*>(sB + j * ldn + 4 * k4);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            upd[r][m].x = fmaf(xw[r], bv.x, upd[r][m].x);
            upd[r][m].y = fmaf(xw[r], bv.y, upd[r][m].y);
            upd[r][m].z = fmaf(xw[r], bv.z, upd[r][m].z);
            upd[r][m].w = fmaf(xw[r], bv.w, upd[r][m].w);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          hreg[r][m].x = dec * hreg[r][m].x + upd[r][m].x;
          hreg[r][m].y = dec * hreg[r][m].y + upd[r][m].y;
          hreg[r][m].z = dec * hreg[r][m].z + upd[r][m].z;
          hreg[r][m].w = dec * hreg[r][m].w + upd[r][m].w;
        }
    }
    __syncthreads();   // every reader of sH (the y step) is done
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int k4 = tx + kGrid * m;
        if (k4 >= n4) continue;
        float* dst = sH + (ty + kGrid * r) * ldn + 4 * k4;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dst[u] = lane(hreg[r][m], u);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pi = p0 + ty + kGrid * r;
    if (pi >= P) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int k4 = tx + kGrid * m;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 4 * k4 + u;
        if (k4 < n4 && k < N)
          state[((b * H + hh) * P + pi) * N + k] = lane(hreg[r][m], u);
      }
    }
  }
}


int launch_f32(const void* x, const void* a, const void* B, const void* C,
               void* y, void* state, int batch, int S, int H, int P, int N,
               int Q, void* stream) {
  if (Q < 1 || Q > kQ || N < 1 || N > kMaxN || P < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldn = 4 * ((N + 3) / 4) + 4;
  const size_t smem = (static_cast<size_t>(2 * kQ + kSlice) * ldn +
                       kQ * kSlice + kQ * kLdS + 2 * kQ) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kSlice - 1) / kSlice, H, batch);
  ssd_scan_f32_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(state), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16: tensor cores, cp.async ---------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kRowWarps = kQ / 16;       // row warps: 16 rows of a chunk each
constexpr int kMmaWarps = 2 * kRowWarps; // then as many state warps
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kPad = 8;                  // bf16 row padding: 16 bytes
constexpr int kLdx = kSlice + kPad;      // row stride of the x slice

// Shared memory, in bytes, for state width N: two stages of [kQ][ldn] B and
// C, [kQ][kLdx] x and [kQ] a; two [kSlice][ldn] h_prev, one being read and
// one being written; a [kQ] cumsum for each warp; w x split into three
// [kQ][kLdx] bf16 planes.
struct MmaSmem {
  int ldn;     // row stride of B, C and h_prev: N rounded up to 16, + kPad
  int stage_bytes;
  int total;
  __host__ __device__ explicit MmaSmem(int N)
      : ldn(((N + 15) & ~15) + kPad),
        stage_bytes(2 * kQ * ldn * 2 + kQ * kLdx * 2 + kQ * 4),
        total(2 * stage_bytes + 2 * kSlice * ldn * 2 + kMmaWarps * kQ * 4 +
              3 * kQ * kLdx * 2) {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x, the MUFU's approximation (about 2 ulp)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// (v0, v1) = hi + rest exactly; returns the packed hi and sets the rest
__device__ __forceinline__ uint32_t split_off(float& v0, float& v1) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(hi);
  v0 -= f.x;
  v1 -= f.y;
  return bits(hi);
}

// __syncthreads, for loops that reach it from different code: the row and
// the state warps' (bar.sync 0 counts every thread of the block)
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;\n" ::: "memory");
}

// y in bf16 at p and p + 1 (those below P)
__device__ __forceinline__ void store_y2(bf16* dst, float v0, float v1, int p,
                                         int P) {
  if ((P & 1) == 0 && p + 1 < P) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (p < P) dst[0] = __float2bfloat16(v0);
    if (p + 1 < P) dst[1] = __float2bfloat16(v1);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane ln = 4 g + t holds
// accumulator rows g and g + 8, columns 2t and 2t + 1.  ldmatrix.x4 takes
// lane ln's address as row ln % 8 of 8 x 8 matrix ln / 8.

// Rows 16W..16W+15 of a chunk, by one warp: the scores s = C B^T on the
// live j-tiles (jt <= W) and yh = C h_prev^T, both over n; s * L in f32
// (zero above the diagonal); yi = (s * L) x with s * L split into hi + lo;
// then y = yi + exp(cs_i) yh in bf16.  W is a template parameter so that
// every loop over tiles has a fixed trip count and no branch: the loads of
// a k16 step can then be issued ahead of its products.  yb points at y's
// (batch, head, t = 0, p = 0), and a step advances y by HP elements.
template <int W>
__device__ __forceinline__ void chunk_rows(const bf16* sB, const bf16* sC,
                                           const bf16* sX, const bf16* hp,
                                           const float* cs, int ldn, int nk,
                                           bf16* yb, size_t HP, int t0, int S,
                                           int Q, int p0, int P) {
  const int ln = threadIdx.x % 32, g = ln / 4, tq = ln % 4;
  float s[2 * (W + 1)][4] = {}, yh[kSlice / 8][4] = {};
  for (int ks = 0; ks < nk; ++ks) {
    uint32_t af[4], bf[W + 1][4], hf[kSlice / 16][4];
    ldsm_x4(af, sC + (16 * W + (ln & 15)) * ldn + 16 * ks + (ln / 16) * 8);
#pragma unroll
    for (int jt = 0; jt <= W; ++jt)
      ldsm_x4(bf[jt], sB + (16 * jt + (ln & 7) + (ln / 16) * 8) * ldn + 16 * ks +
                          ((ln / 8) & 1) * 8);
#pragma unroll
    for (int pt = 0; pt < kSlice / 16; ++pt)
      ldsm_x4(hf[pt], hp + (16 * pt + (ln & 7) + (ln / 16) * 8) * ldn + 16 * ks +
                          ((ln / 8) & 1) * 8);
#pragma unroll
    for (int jt = 0; jt <= W; ++jt) {
      mma_bf16(s[2 * jt], af, bf[jt][0], bf[jt][1]);
      mma_bf16(s[2 * jt + 1], af, bf[jt][2], bf[jt][3]);
    }
#pragma unroll
    for (int pt = 0; pt < kSlice / 16; ++pt) {
      mma_bf16(yh[2 * pt], af, hf[pt][0], hf[pt][1]);
      mma_bf16(yh[2 * pt + 1], af, hf[pt][2], hf[pt][3]);
    }
  }

  const int r0 = 16 * W + g;
  const float cs0 = cs[r0], cs1 = cs[r0 + 8];
#pragma unroll
  for (int j = 0; j < 2 * (W + 1); ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * tq + e;
      const float cc = cs[col];
      s[j][e] = col <= r0 ? s[j][e] * exp2_approx((cs0 - cc) * kLog2e) : 0.f;
      s[j][2 + e] =
          col <= r0 + 8 ? s[j][2 + e] * exp2_approx((cs1 - cc) * kLog2e) : 0.f;
    }

  float yi[kSlice / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk <= W; ++kk) {
    // the A fragment of keys 16kk..16kk+15 is the accumulators of n8 tiles
    // 2kk and 2kk + 1
    float v[4][2] = {{s[2 * kk][0], s[2 * kk][1]},
                     {s[2 * kk][2], s[2 * kk][3]},
                     {s[2 * kk + 1][0], s[2 * kk + 1][1]},
                     {s[2 * kk + 1][2], s[2 * kk + 1][3]}};
    uint32_t hi[4], lo[4], xf[kSlice / 16][4];
#pragma unroll
    for (int pt = 0; pt < kSlice / 16; ++pt)
      ldsm_x4_trans(xf[pt], sX + (16 * kk + (ln & 15)) * kLdx + 16 * pt +
                                (ln / 16) * 8);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hi[r] = split_off(v[r][0], v[r][1]);
      lo[r] = bits(__floats2bfloat162_rn(v[r][0], v[r][1]));
    }
#pragma unroll
    for (int pt = 0; pt < kSlice / 16; ++pt) {
      mma_bf16(yi[2 * pt], hi, xf[pt][0], xf[pt][1]);
      mma_bf16(yi[2 * pt], lo, xf[pt][0], xf[pt][1]);
      mma_bf16(yi[2 * pt + 1], hi, xf[pt][2], xf[pt][3]);
      mma_bf16(yi[2 * pt + 1], lo, xf[pt][2], xf[pt][3]);
    }
  }

  const float d0 = expf(cs0), d1 = expf(cs1);
  const int t_a = t0 + r0, t_b = t_a + 8;
  const bool row_a = r0 < Q && t_a < S, row_b = r0 + 8 < Q && t_b < S;
#pragma unroll
  for (int nt = 0; nt < kSlice / 8; ++nt) {
    const int pi = p0 + 8 * nt + 2 * tq;
    if (row_a)
      store_y2(yb + t_a * HP + pi, yi[nt][0] + d0 * yh[nt][0],
               yi[nt][1] + d0 * yh[nt][1], pi, P);
    if (row_b)
      store_y2(yb + t_b * HP + pi, yi[nt][2] + d1 * yh[nt][2],
               yi[nt][3] + d1 * yh[nt][3], pi, P);
  }
}

// h += (w x)^T B over the chunk's nq 16-step tiles, for a state warp's NQ
// n8 tiles from nt0 (NQ 2 or 4: n is padded to 16), the (w x)^T operand
// from its three planes: lo, mid, then hi into the f32 accumulators.
template <int NQ>
__device__ __forceinline__ void state_update(float (&h)[kSlice / 16][4][4],
                                             const bf16* sB, const bf16* sW,
                                             int ldn, int nq, int nt0) {
  const int ln = threadIdx.x % 32;
  for (int kk = 0; kk < nq; ++kk) {
    uint32_t bf[NQ / 2][4], af[kSlice / 16][3][4];
#pragma unroll
    for (int u = 0; u < NQ / 2; ++u)
      ldsm_x4_trans(bf[u], sB + (16 * kk + (ln & 15)) * ldn + 8 * (nt0 + 2 * u) +
                               (ln / 16) * 8);
#pragma unroll
    for (int m = 0; m < kSlice / 16; ++m)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        ldsm_x4_trans(af[m][k], sW + (k * kQ + 16 * kk + (ln / 16) * 8 + (ln & 7)) *
                                         kLdx + 16 * m + ((ln / 8) & 1) * 8);
#pragma unroll
    for (int m = 0; m < kSlice / 16; ++m)
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const uint32_t b0 = bf[q / 2][2 * (q % 2)];
        const uint32_t b1 = bf[q / 2][2 * (q % 2) + 1];
        mma_bf16(h[m][q], af[m][2], b0, b1);
        mma_bf16(h[m][q], af[m][1], b0, b1);
        mma_bf16(h[m][q], af[m][0], b0, b1);
      }
  }
}

__global__ void __launch_bounds__(kMmaThreads, 2)
ssd_scan_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                     const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                     bf16* __restrict__ y, float* __restrict__ state, int S,
                     int H, int P, int N, int Q, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaSmem L(N);
  const int ldn = L.ldn, Np = ldn - kPad;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int g = ln / 4, tq = ln % 4;
  const int p0 = blockIdx.x * kSlice, hh = blockIdx.y;
  const size_t b = blockIdx.z;
  bf16* const sH0 = reinterpret_cast<bf16*>(smem + 2 * L.stage_bytes);
  float* const cs_all = reinterpret_cast<float*>(smem + 2 * L.stage_bytes +
                                                 2 * kSlice * ldn * 2);
  float* const cs = cs_all + warp * kQ;
  bf16* const sW = reinterpret_cast<bf16*>(cs_all + kMmaWarps * kQ);
  // stage st: [kQ][ldn] B, then C, then [kQ][kLdx] x, then [kQ] a
  const auto stage = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * L.stage_bytes);
  };

  for (int i = tid; i < L.total / 16; i += kMmaThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // chunk c's B (part 0), C (part 1) or x slice and a (part 2) into stage
  // st, by one warp; rows past s as zeros
  auto load_part = [&](int part, int c, int st) {
    bf16* sB = stage(st);
    bf16* sX = sB + 2 * kQ * ldn;
    float* sA = reinterpret_cast<float*>(sX + kQ * kLdx);
    const int t0 = c * Q;
    const uint4 zero16 = make_uint4(0u, 0u, 0u, 0u);
    const bf16 zero = __float2bfloat16(0.f);
    if (part < 2) {
      bf16* dst = sB + part * kQ * ldn;
      const bf16* src = part == 0 ? Bm : Cm;
      if (vec) {
        // lane: 16-byte piece ln % 16 of rows ln / 16 + 2 k
        const int col = (ln % 16) * 8;
        if (col < Np)
          for (int r = ln / 16; r < Q; r += 2) {
            const int t = t0 + r;
            bf16* d = dst + r * ldn + col;
            if (t < S && col < N) cp_async16(d, src + (b * S + t) * N + col);
            else *reinterpret_cast<uint4*>(d) = zero16;
          }
      } else {
        for (int i = ln; i < Q * Np; i += 32) {
          const int r = i / Np, col = i % Np, t = t0 + r;
          dst[r * ldn + col] = t < S && col < N ? src[(b * S + t) * N + col] : zero;
        }
      }
      return;
    }
    for (int r = ln; r < Q; r += 32) {
      if (t0 + r < S) cp_async4(sA + r, a + (b * S + t0 + r) * H + hh);
      else sA[r] = 0.f;
    }
    if (vec) {
      // lane: 16-byte piece ln % 4 of rows ln / 4 + 8 k
      const int xc = (ln % (kSlice / 8)) * 8, pi = p0 + xc;
      for (int r = ln / (kSlice / 8); r < Q; r += 32 / (kSlice / 8)) {
        const int t = t0 + r;
        bf16* d = sX + r * kLdx + xc;
        if (t < S && pi < P) cp_async16(d, x + ((b * S + t) * H + hh) * P + pi);
        else *reinterpret_cast<uint4*>(d) = zero16;
      }
    } else {
      for (int i = ln; i < Q * kSlice; i += 32) {
        const int r = i / kSlice, col = i % kSlice;
        const int t = t0 + r, pi = p0 + col;
        sX[r * kLdx + col] =
            t < S && pi < P ? x[((b * S + t) * H + hh) * P + pi] : zero;
      }
    }
  };

  const int n_chunks = (S + Q - 1) / Q;
  const int nk = Np / 16;          // k16 steps over n
  const int nq = (Q + 15) / 16;    // 16-row tiles that hold steps of a chunk
  // the cumsum of stage st's a into this warp's cs; a = 0 past the chunk
  // and past s
  const auto scan = [&](int st) {
    const float* sA = reinterpret_cast<const float*>(stage(st) + 2 * kQ * ldn +
                                                     kQ * kLdx);
    float lo = sA[ln], hi = sA[ln + 32];
    warp_cumsum(lo, hi, ln);
    cs[ln] = lo;
    cs[ln + 32] = hi;
    __syncwarp();
  };

  // The two roles run their own loops over the chunks, so that neither
  // keeps the other's registers live; they meet at one block barrier a
  // chunk, after which chunk c is in and chunk c - 1 is done with.
  if (warp < kRowWarps) {
    // The row warps: warps 0, 1 and 2 start the next chunk's loads of B,
    // of C, and of x and a; then every row warp computes its rows of y.
    bf16* yb = y + (b * S * H + hh) * P;
    const size_t HP = static_cast<size_t>(H) * P;
    if (warp < 3) load_part(warp, 0, 0);
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c & 1;
      cp_async_wait_all();
      block_sync();
      if (warp < 3 && c + 1 < n_chunks) load_part(warp, c + 1, st ^ 1);
      cp_async_commit();
      scan(st);
      const bf16* sB = stage(st);
      const bf16* sC = sB + kQ * ldn;
      const bf16* sX = sC + kQ * ldn;
      const bf16* hp = sH0 + st * kSlice * ldn;   // h_prev, rounded
      const int t0 = c * Q;
      if (warp == 0 && nq > 0)
        chunk_rows<0>(sB, sC, sX, hp, cs, ldn, nk, yb, HP, t0, S, Q, p0, P);
      else if (warp == 1 && nq > 1)
        chunk_rows<1>(sB, sC, sX, hp, cs, ldn, nk, yb, HP, t0, S, Q, p0, P);
      else if (warp == 2 && nq > 2)
        chunk_rows<2>(sB, sC, sX, hp, cs, ldn, nk, yb, HP, t0, S, Q, p0, P);
      else if (warp == 3 && nq > 3)
        chunk_rows<3>(sB, sC, sX, hp, cs, ldn, nk, yb, HP, t0, S, Q, p0, P);
    }
    return;
  }

  // The state warps: h = exp(cs_end) h + (w x)^T B, w_j = exp(cs_end -
  // cs_j): first w x, split into hi + mid + lo planes (each thread half a
  // row), then the products; then h_prev for the next chunk, rounded.  This
  // warp's state: rows 16 m + (g, g + 8), columns 8 (nt0 + q) + 2 tq.
  const int n8 = Np / 8;                     // n8 tiles of the state's columns
  const int nt0 = 4 * (warp - kRowWarps);    // this warp's first
  const int lt = tid - 32 * kRowWarps;       // the thread among the state warps
  float h[kSlice / 16][4][4];
#pragma unroll
  for (int m = 0; m < kSlice / 16; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[m][q][e] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    block_sync();
    scan(st);
    const float cs_end = cs[kQ - 1];
    const bf16* sB = stage(st);
    const bf16* sX = sB + 2 * kQ * ldn;
    bf16* hn = sH0 + (st ^ 1) * kSlice * ldn;    // the next chunk's h_prev
    {
      const int j = lt / 2, c0 = (lt % 2) * (kSlice / 2);
      const float w = expf(cs_end - cs[j]);
#pragma unroll
      for (int u = 0; u < kSlice / 2; u += 8) {
        const uint4 xv = *reinterpret_cast<const uint4*>(sX + j * kLdx + c0 + u);
        const uint32_t in[4] = {xv.x, xv.y, xv.z, xv.w};
        uint32_t pl[3][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = unpack(in[r]);
          float v0 = f.x * w, v1 = f.y * w;
          pl[0][r] = split_off(v0, v1);
          pl[1][r] = split_off(v0, v1);
          pl[2][r] = bits(__floats2bfloat162_rn(v0, v1));
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint4*>(sW + (k * kQ + j) * kLdx + c0 + u) =
              make_uint4(pl[k][0], pl[k][1], pl[k][2], pl[k][3]);
      }
      // the four state warps' planes are written
      asm volatile("bar.sync 1, %0;\n" ::"n"(kRowWarps * 32) : "memory");
    }
    const float dec = expf(cs_end);
#pragma unroll
    for (int m = 0; m < kSlice / 16; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[m][q][e] *= dec;
    if (nt0 + 4 <= n8) state_update<4>(h, sB, sW, ldn, nq, nt0);
    else if (nt0 + 2 <= n8) state_update<2>(h, sB, sW, ldn, nq, nt0);
#pragma unroll
    for (int m = 0; m < kSlice / 16; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (nt0 + q >= n8) continue;
        bf16* dst = hn + (16 * m + g) * ldn + 8 * (nt0 + q) + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(h[m][q][0], h[m][q][1]);
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * ldn) =
            __floats2bfloat162_rn(h[m][q][2], h[m][q][3]);
      }
  }

#pragma unroll
  for (int m = 0; m < kSlice / 16; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pi = p0 + 16 * m + g + 8 * (e / 2);
        const int k = 8 * (nt0 + q) + 2 * tq + (e % 2);
        if (nt0 + q < n8 && pi < P && k < N)
          state[((b * H + hh) * P + pi) * N + k] = h[m][q][e];
      }
}

int launch_bf16(const void* x, const void* a, const void* B, const void* C,
                void* y, void* state, int batch, int S, int H, int P, int N,
                int Q, void* stream) {
  if (Q < 1 || Q > kQ || N < 1 || N > kMaxN || P < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaSmem L(N);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = N % 8 == 0 && P % 8 == 0 && aligned(x) && aligned(B) &&
                  aligned(C);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kSlice - 1) / kSlice, H, batch);
  ssd_scan_bf16_kernel<<<grid, kMmaThreads, L.total,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<bf16*>(y), static_cast<float*>(state), S, H, P, N, Q, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ssd_scan_f32(const void* x, const void* a, const void* B,
                                  const void* C, void* y, void* state, int b,
                                  int s, int h, int p, int n, int chunk,
                                  void* stream) {
  return launch_f32(x, a, B, C, y, state, b, s, h, p, n, chunk, stream);
}

extern "C" int repro_ssd_scan_bf16(const void* x, const void* a, const void* B,
                                   const void* C, void* y, void* state, int b,
                                   int s, int h, int p, int n, int chunk,
                                   void* stream) {
  return launch_bf16(x, a, B, C, y, state, b, s, h, p, n, chunk, stream);
}
