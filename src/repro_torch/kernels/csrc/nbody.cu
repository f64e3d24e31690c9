// Softened all-pairs gravity on a range of target rows (kernel B1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/nbody.py:_kernel
// (nbody_forces_tpu).  F_i = sum_j d_ij * rsqrt(|d_ij|^2 + soft)^3 with
// d_ij = p_j - p_i, accumulated in f32 whatever the storage type.
//
// Bound on an H100: operations.  Each pair costs 18 f32 operations (3 sub,
// 5 for |d|^2, 1 add for soft, 1 rsqrt, 2 mul for the cube, 6 for the
// accumulation; a fused multiply-add counts as two, as the card's peak rate
// counts it), against 12 bytes per body read once, so the card's f32 rate
// and not its memory rate is the limit: 1.15 ms for one device's chunk of
// the main path (32768 rows x 131072 bodies) at 67 TFLOP/s.  Two floors of
// this card lie nearer than that yardstick:
// - the special-function units (MUFU) take 16 rsqrt per clock per SM:
//   4.29e9 pairs over 132 SMs at 1.98 GHz is 1.03 ms;
// - each pair issues 11 FP32 instructions (3 FADD for d, 3 FFMA for r^2
//   seeded with soft, 2 FMUL for the cube, 3 FFMA for the sums) plus the
//   MUFU, and an SM issues 4 warp instructions (128 threads) per clock:
//   12 instructions per pair plus 1/kRowsPerThread of a shared-memory load
//   is 1.57 ms at 1.98 GHz.  That issue rate, not the f32 rate, is the
//   limit of this design.
//
// Design: a block stages a tile of kTile source bodies in shared memory
// (converted to f32, padded to float4 so one 16-byte load fetches a body),
// read by broadcast, so device memory is touched once per tile and not once
// per pair.  Each thread holds kRowsPerThread target rows in registers, so
// one body loaded from shared memory feeds that many pairs, and kLanes
// threads share a group of rows, lane k taking bodies k, k + kLanes, ... of
// each tile.  Full tiles run a loop of compile-time length; the ragged last
// tile its own loop.  With 128 threads a block takes 64 rows: one device's
// 32768-row chunk of the main path is 512 blocks, about four per SM (the
// launch bound lets eight fit, at 64 registers a thread).
//
// Determinism: a row's sum runs over j in a fixed order (tile by tile, lane
// k taking bodies k, k + kLanes, ... of each tile, then a fixed butterfly
// over the lanes), with every rounding step written out (fmaf, no
// contraction left to the compiler).  That order depends only on N, never
// on lo or hi, so forces, and positions, come out identical however the
// runtime splits the rows.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;            // source bodies per shared-memory tile
constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kLanes = 8;             // threads per group of rows

// 1 / sqrt(x) on the special-function unit.  x >= soft > 0 is never
// denormal, so flushing denormals changes nothing and saves rsqrtf's
// rescaling of them.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// adds body b's pull on the thread's rows to their sums
template <int R>
__device__ __forceinline__ void interact(const float4& b, const float (&x)[R],
                                         const float (&y)[R], const float (&z)[R],
                                         float soft, float (&ax)[R],
                                         float (&ay)[R], float (&az)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float dx = b.x - x[r];
    const float dy = b.y - y[r];
    const float dz = b.z - z[r];
    float r2 = fmaf(dx, dx, soft);
    r2 = fmaf(dy, dy, r2);
    r2 = fmaf(dz, dz, r2);
    const float inv = rsqrt_ftz(r2);
    const float w = __fmul_rn(__fmul_rn(inv, inv), inv);
    ax[r] = fmaf(dx, w, ax[r]);
    ay[r] = fmaf(dy, w, ay[r]);
    az[r] = fmaf(dz, w, az[r]);
  }
}

template <typename T, int R, int L>
__global__ void __launch_bounds__(kThreads, 8)
nbody_rows_kernel(const T* __restrict__ p, T* __restrict__ out, int n, int lo,
                  int hi, float soft) {
  __shared__ float4 sp[kTile];
  constexpr int kGroupRows = kThreads / L * R;
  const int lane = threadIdx.x % L;
  const int row0 = lo + blockIdx.x * kGroupRows + threadIdx.x / L * R;
  float x[R], y[R], z[R], ax[R], ay[R], az[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // rows past hi take row hi - 1; they are never stored
    const size_t o = 3 * static_cast<size_t>(min(row0 + r, hi - 1));
    x[r] = static_cast<float>(p[o + 0]);
    y[r] = static_cast<float>(p[o + 1]);
    z[r] = static_cast<float>(p[o + 2]);
    ax[r] = ay[r] = az[r] = 0.f;
  }
  for (int base = 0; base < n; base += kTile) {
    for (int j = threadIdx.x; j < kTile && base + j < n; j += kThreads) {
      const size_t o = 3 * static_cast<size_t>(base + j);
      sp[j] = make_float4(static_cast<float>(p[o + 0]),
                          static_cast<float>(p[o + 1]),
                          static_cast<float>(p[o + 2]), 0.f);
    }
    __syncthreads();
    const int count = n - base;
    if (count >= kTile) {
#pragma unroll 16
      for (int k = 0; k < kTile / L; ++k)
        interact(sp[k * L + lane], x, y, z, soft, ax, ay, az);
    } else {                                   // the last tile ends at j < n
      for (int k = lane; k < count; k += L)
        interact(sp[k], x, y, z, soft, ax, ay, az);
    }
    __syncthreads();
  }
  // fixed butterfly over the group's lanes; f32 addition commutes, so every
  // lane ends with the same bits
#pragma unroll
  for (int off = 1; off < L; off <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ax[r] += __shfl_xor_sync(0xffffffffu, ax[r], off);
      ay[r] += __shfl_xor_sync(0xffffffffu, ay[r], off);
      az[r] += __shfl_xor_sync(0xffffffffu, az[r], off);
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r >= hi) break;
      const size_t o = 3 * static_cast<size_t>(row0 + r - lo);
      out[o + 0] = static_cast<T>(ax[r]);
      out[o + 1] = static_cast<T>(ay[r]);
      out[o + 2] = static_cast<T>(az[r]);
    }
  }
}

template <typename T, int R = kRowsPerThread, int L = kLanes>
int launch(const void* p, void* out, int n, int lo, int hi, float soft,
           void* stream) {
  constexpr int kGroupRows = kThreads / L * R;
  const int rows = hi - lo;
  const int blocks = (rows + kGroupRows - 1) / kGroupRows;
  nbody_rows_kernel<T, R, L><<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<T*>(out), n, lo, hi, soft);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_nbody_rows_f32(const void* p, void* out, int n, int lo,
                                    int hi, float soft, void* stream) {
  return launch<float>(p, out, n, lo, hi, soft, stream);
}

extern "C" int repro_nbody_rows_f64(const void* p, void* out, int n, int lo,
                                    int hi, float soft, void* stream) {
  return launch<double>(p, out, n, lo, hi, soft, stream);
}
