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
// and not its memory rate is the limit.  The design keeps the source bodies
// in shared memory: a block stages a tile of kTile bodies (converted to f32,
// padded to float4 so one 16-byte load fetches a body) that all of its
// threads read by broadcast, so device memory is touched once per tile and
// not once per pair.  kLanes threads share one target row and take every
// kLanes-th body of each tile, which gives the card four times more warps
// than one thread per row would at the main path's 32768 rows.
//
// Determinism: a row's sum runs over j in a fixed order (tile by tile, lane
// k taking bodies k, k+kLanes, ... of each tile, then a fixed butterfly over
// the lanes).  That order depends only on N, never on lo or hi, so forces,
// and positions, come out identical however the runtime splits the rows.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;            // source bodies per shared-memory tile
constexpr int kThreads = kTile;       // one body loaded per thread per tile
constexpr int kLanes = 4;             // threads per target row
constexpr int kRowsPerBlock = kThreads / kLanes;

template <typename T>
__global__ void __launch_bounds__(kThreads)
nbody_rows_kernel(const T* __restrict__ p, T* __restrict__ out, int n, int lo,
                  int hi, float soft) {
  __shared__ float4 sp[kTile];
  const int lane = threadIdx.x % kLanes;
  const int row = lo + blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const bool live = row < hi;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) {
    xi = static_cast<float>(p[3 * static_cast<size_t>(row) + 0]);
    yi = static_cast<float>(p[3 * static_cast<size_t>(row) + 1]);
    zi = static_cast<float>(p[3 * static_cast<size_t>(row) + 2]);
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < n; base += kTile) {
    const int j = base + threadIdx.x;
    if (j < n) {
      const size_t o = 3 * static_cast<size_t>(j);
      sp[threadIdx.x] = make_float4(static_cast<float>(p[o + 0]),
                                    static_cast<float>(p[o + 1]),
                                    static_cast<float>(p[o + 2]), 0.f);
    }
    __syncthreads();
    const int count = min(kTile, n - base);   // the last tile ends at j < n
    for (int k = lane; k < count; k += kLanes) {
      const float4 q = sp[k];
      const float dx = q.x - xi;
      const float dy = q.y - yi;
      const float dz = q.z - zi;
      const float r2 = dx * dx + dy * dy + dz * dz + soft;
      const float inv = rsqrtf(r2);
      const float w = inv * inv * inv;
      ax += dx * w;
      ay += dy * w;
      az += dz * w;
    }
    __syncthreads();
  }
  // fixed butterfly over the row's lanes; f32 addition commutes, so every
  // lane ends with the same bits
  for (int off = 1; off < kLanes; off <<= 1) {
    ax += __shfl_xor_sync(0xffffffffu, ax, off);
    ay += __shfl_xor_sync(0xffffffffu, ay, off);
    az += __shfl_xor_sync(0xffffffffu, az, off);
  }
  if (live && lane == 0) {
    const size_t o = 3 * static_cast<size_t>(row - lo);
    out[o + 0] = static_cast<T>(ax);
    out[o + 1] = static_cast<T>(ay);
    out[o + 2] = static_cast<T>(az);
  }
}

template <typename T>
int launch(const void* p, void* out, int n, int lo, int hi, float soft,
           void* stream) {
  const int rows = hi - lo;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  nbody_rows_kernel<T><<<blocks, kThreads, 0,
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
