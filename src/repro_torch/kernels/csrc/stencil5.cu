// One 5-point wave step on a chunk of rows (kernel B2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil5.py:_kernel
// (wave_step_tpu).  un = 2u - um + c * (u_up + u_down + u_left + u_right - 4u)
// in f32 whatever the storage type, zero on global rows 0 and H-1 and on
// columns 0 and W-1 (Dirichlet border).
//
// Bound on an H100: bytes.  Each output element reads um and u once and
// writes un once, for about 10 f32 operations, far below the card's
// operations-per-byte balance.  The design is one thread per output element
// with neighbouring threads on neighbouring columns, so every load and store
// of a warp is one coalesced segment; the four neighbours of u come from the
// same rows that the neighbouring threads load, through L1/L2.
//
// Halo layout: the TPU kernel took pre-shifted copies of u and knew its
// global row from the grid index.  Here u_ext is the runtime's contiguous
// neighbourhood slab, the chunk's rows plus one halo row above (when row0 > 0)
// and one below (when the chunk does not end at row H-1); the kernel is given
// the chunk's global first row so that rows 0 and H-1 stay zero.  Column
// neighbours are read only for interior columns, where the TPU kernel's
// column roll never wraps into an output.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
wave_rows_kernel(const T* __restrict__ um, const T* __restrict__ u_ext,
                 T* __restrict__ out, int rows, int w, int row0, int h,
                 int top, float c) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(rows) * w) return;
  const int r = static_cast<int>(idx / w);
  const int col = static_cast<int>(idx % w);
  const int gi = row0 + r;
  float v = 0.f;
  if (gi > 0 && gi < h - 1 && col > 0 && col < w - 1) {
    const T* uc = u_ext + static_cast<size_t>(r + top) * w + col;
    const float center = static_cast<float>(uc[0]);
    const float up = static_cast<float>(uc[-w]);
    const float dn = static_cast<float>(uc[w]);
    const float left = static_cast<float>(uc[-1]);
    const float right = static_cast<float>(uc[1]);
    const float lap = up + dn + left + right - 4.0f * center;
    v = 2.0f * center - static_cast<float>(um[idx]) + c * lap;
  }
  out[idx] = static_cast<T>(v);
}

template <typename T>
int launch(const void* um, const void* u_ext, void* out, int rows, int w,
           int row0, int h, int top, float c, void* stream) {
  const size_t n = static_cast<size_t>(rows) * w;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  wave_rows_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(um), static_cast<const T*>(u_ext),
      static_cast<T*>(out), rows, w, row0, h, top, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_wave_rows_f32(const void* um, const void* u_ext,
                                   void* out, int rows, int w, int row0,
                                   int h, int top, float c, void* stream) {
  return launch<float>(um, u_ext, out, rows, w, row0, h, top, c, stream);
}

extern "C" int repro_wave_rows_f64(const void* um, const void* u_ext,
                                   void* out, int rows, int w, int row0,
                                   int h, int top, float c, void* stream) {
  return launch<double>(um, u_ext, out, rows, w, row0, h, top, c, stream);
}
