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
// n 128, chunk 64, bf16) the function moves 77 MB (x and y 34 MB each) for
// 1.5e10 operations, 0.023 ms against 0.015 ms at the tensor cores' bf16
// rate.  This first kernel does its products in f32 on the CUDA cores, so
// its own floor is the f32 rate (67 TFLOP/s), about ten times the bound.
//
// Design.  The rows of the state are independent in p: y[:, i] and h[i, :]
// depend only on x[:, i].  A block takes one (batch, head) and a slice of
// kPs = 32 state rows, walks the chunks in order and keeps its [32, n] slice
// of h in registers (and, rounded, in shared memory for the C h_prev
// product), so nothing carries over between blocks; at the serving shape
// that is 256 blocks, two per SM.  Each block recomputes C B^T * L for its
// chunk (B and C are shared by the heads).  Per chunk, 256 threads as a
// 16 x 16 grid: the 64 x 64 score tile (each thread a 4 x 4 strip), then
// y [64, 32] (4 x 2 per thread), then the state update [32, n] (2 rows x
// 2 float4 columns per thread).  B, C and h_prev sit in shared memory with a
// row stride of 4 * ceil(n / 4) + 4 floats, so the float4 reads of
// consecutive rows fall in different banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid: tx = t % 16, ty = t / 16
constexpr int kGrid = 16;
constexpr int kQ = 64;          // the largest chunk; shared tiles have kQ rows
constexpr int kPs = 32;         // state rows (of p) of a block
constexpr int kMaxN = 128;      // the largest state width n
constexpr int kLdS = kQ + 1;    // row stride of the score tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                T* __restrict__ y, float* __restrict__ state, int S, int H,
                int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int n4 = (N + 3) / 4;       // float4 columns of B, C and h
  const int ldn = 4 * n4 + 4;
  float* sC = reinterpret_cast<float*>(smem4);   // [kQ][ldn]
  float* sB = sC + kQ * ldn;                     // [kQ][ldn]
  float* sH = sB + kQ * ldn;                     // [kPs][ldn] h_prev, rounded
  float* sX = sH + kPs * ldn;                    // [kQ][kPs]
  float* sS = sX + kQ * kPs;                     // [kQ][kLdS] (C B^T) * L
  float* sCs = sS + kQ * kLdS;                   // [kQ] cumsum of a
  float* sEnd = sCs + kQ;                        // [kQ] exp(cs_end - cs_j)

  const int tid = threadIdx.x;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const int p0 = blockIdx.x * kPs;
  const int hh = blockIdx.y;
  const size_t b = blockIdx.z;

  // this thread's state: rows ty + 16 r, float4 columns tx + 16 m
  float4 hreg[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < 2; ++m) hreg[r][m] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < kPs * ldn; i += kThreads) sH[i] = 0.f;

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
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      sB[row * ldn + col] = bv;
      sC[row * ldn + col] = cv;
    }
    for (int i = tid; i < kQ * kPs; i += kThreads) {
      const int row = i / kPs, col = i % kPs;
      const int t = t0 + row, pi = p0 + col;
      float xv = 0.f;
      if (row < Q && t < S && pi < P)
        xv = to_f32(x[((b * S + t) * H + hh) * P + pi]);
      sX[i] = xv;
    }
    // -- cumsum of a over the chunk by one warp (rows lane and lane + 32)
    if (tid < 32) {
      float lo = 0.f, hi = 0.f;
      if (tid < Q && t0 + tid < S) lo = a[(b * S + t0 + tid) * H + hh];
      if (tid + 32 < Q && t0 + tid + 32 < S)
        hi = a[(b * S + t0 + tid + 32) * H + hh];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float u = __shfl_up_sync(kFull, lo, d);
        const float v = __shfl_up_sync(kFull, hi, d);
        if (tid >= d) {
          lo += u;
          hi += v;
        }
      }
      hi += __shfl_sync(kFull, lo, 31);
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
        const float x0 = sX[j * kPs + tx], x1 = sX[j * kPs + tx + kGrid];
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
            y[((b * S + t) * H + hh) * P + pi] =
                from_f32<T>(yi[r][q] + decay * yh[r][q]);
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
        for (int r = 0; r < 2; ++r) xw[r] = w * sX[j * kPs + ty + kGrid * r];
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
          dst[u] = to_f32(from_f32<T>(lane(hreg[r][m], u)));
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

template <typename T>
int launch(const void* x, const void* a, const void* B, const void* C,
           void* y, void* state, int batch, int S, int H, int P, int N, int Q,
           void* stream) {
  if (Q < 1 || Q > kQ || N < 1 || N > kMaxN || P < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldn = 4 * ((N + 3) / 4) + 4;
  const size_t smem =
      (static_cast<size_t>(2 * kQ + kPs) * ldn + kQ * kPs + kQ * kLdS + 2 * kQ) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kPs - 1) / kPs, H, batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ssd_scan_f32(const void* x, const void* a, const void* B,
                                  const void* C, void* y, void* state, int b,
                                  int s, int h, int p, int n, int chunk,
                                  void* stream) {
  return launch<float>(x, a, B, C, y, state, b, s, h, p, n, chunk, stream);
}

extern "C" int repro_ssd_scan_bf16(const void* x, const void* a, const void* B,
                                   const void* C, void* y, void* state, int b,
                                   int s, int h, int p, int n, int chunk,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, a, B, C, y, state, b, s, h, p, n, chunk,
                               stream);
}
