// The inter-chunk recurrence of Mamba2's SSD scan (step 3 of kernel B4's
// plain version) and its reverse, for the backward of B4.
//
// Replaces no TPU kernel: the JAX model's gradient is jax.grad through the
// jnp ssd_chunked, whose recurrence is a lax.scan.  Autograd of the same loop
// in PyTorch on the card ran a few ops per chunk and, per chunk, built a zero
// tensor of all the states to add one chunk's gradient into; these two
// kernels take the whole recurrence in one launch each way.  states is [b, c, h, L] in f32
// (L = p * n), decay [b, c, h] f32, both contiguous:
//
//   forward   h_0 = 0,  hprev[ci] = h_ci,  h_{ci+1} = decay_ci * h_ci + states_ci,
//             hlast = h_c
//   reverse   G_c = dhlast (0 without one); for ci = c - 1 down to 0:
//             dstates[ci] = G_{ci+1}
//             ddecay[ci]  = sum over L of G_{ci+1} * hprev[ci]
//             G_ci        = decay_ci * G_{ci+1} + dhprev[ci]   (no add without dhprev)
//
// Every product and sum of the recurrence is rounded on its own (__fmul_rn,
// __fadd_rn, never a contracted FMA), as the plain loop rounds them, so
// hprev, hlast and dstates equal the plain loop's bit for bit.  ddecay is a
// reduction: a fixed tree (a thread's elements in order, warp shuffles,
// the block's warps in order, the cluster's blocks in order, then rounds in
// order), so it is the same from run to run and differs from the plain
// loop's sum only by order.  No float atomics.
//
// Bound on an H100: bytes.  At granite-4.0-h-small's training shape (b 2,
// c 128, h 128, L 8192) the forward reads the states and writes hprev (2.1
// GB), the reverse reads hprev and dhprev and writes dstates (3.2 GB): 1.6
// ms at 3.35 TB/s.  A thread owns four consecutive elements of one (b, h)
// (one where L is no multiple of 4 or a pointer is not 16-byte aligned) and
// walks the chunks with its state in registers; a warp's loads of one chunk
// are consecutive (each (b, ci, h) slab of L floats is contiguous).  Loads
// of kAhead chunks are issued before their arithmetic, so each thread keeps
// several in flight.  The forward's grid is (ceil(L / (4 * 256)), h, b):
// 2,048 blocks at the training shape, for 132 SMs.  The reverse
// gives one (b, h) to a cluster of up to 8 blocks, whose threads take the
// elements in rounds of the cluster's width; after each tile of kTile
// chunks the blocks' partial sums of ddecay meet in block 0 through
// distributed shared memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;        // chunks whose loads a thread issues together
constexpr int kTile = 32;        // chunks of ddecay summed across the cluster at once
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct Pack {
  float v[V];
};

template <int V>
__device__ __forceinline__ Pack<V> load(const float* p) {
  Pack<V> r;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = p[i];
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Pack<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = r.v[i];
  }
}

template <int V>
__device__ __forceinline__ Pack<V> zeros() {
  Pack<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = 0.f;
  return r;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_fwd_kernel(const float* __restrict__ states,
                          const float* __restrict__ decay,
                          float* __restrict__ hprev, float* __restrict__ hlast,
                          int C, int H, int L) {
  const size_t e = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (e >= static_cast<size_t>(L)) return;
  const int hh = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t slab = static_cast<size_t>(H) * L;      // one chunk's states
  const float* src = states + (b * C * H + hh) * L + e;
  float* dst = hprev + (b * C * H + hh) * L + e;
  const float* dec = decay + b * C * H + hh;
  Pack<V> h = zeros<V>();
  for (int c0 = 0; c0 < C; c0 += kAhead) {
    Pack<V> s[kAhead];
    float d[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < C) {
        s[u] = load<V>(src + (c0 + u) * slab);
        d[u] = dec[static_cast<size_t>(c0 + u) * H];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < C) {
        store<V>(dst + (c0 + u) * slab, h);
#pragma unroll
        for (int i = 0; i < V; ++i)
          h.v[i] = __fadd_rn(__fmul_rn(d[u], h.v[i]), s[u].v[i]);
      }
  }
  store<V>(hlast + (b * H + hh) * L + e, h);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_bwd_kernel(const float* __restrict__ decay,
                          const float* __restrict__ hprev,
                          const float* __restrict__ dhprev,
                          const float* __restrict__ dhlast,
                          float* __restrict__ dstates,
                          float* __restrict__ ddecay, int C, int H, int L) {
  __shared__ float s_warp[kTile][kWarps];   // a tile's sums by warp
  __shared__ float s_block[kTile];          // a tile's sums of this block
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int hh = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t slab = static_cast<size_t>(H) * L;
  const size_t base = (b * C * H + hh) * L;
  const float* dec = decay + b * C * H + hh;
  const int width = blocks * kThreads * V;             // elements a round
  const int rounds = (L + width - 1) / width;

  for (int r = 0; r < rounds; ++r) {
    const size_t e = static_cast<size_t>(r) * width +
                     (static_cast<size_t>(rank) * kThreads + tid) * V;
    const bool live = e < static_cast<size_t>(L);
    Pack<V> g = (live && dhlast) ? load<V>(dhlast + (b * H + hh) * L + e)
                                 : zeros<V>();
    for (int t0 = 0; t0 < C; t0 += kTile) {
      const int tlen = min(kTile, C - t0);   // chunks C-1-t0 down to C-t0-tlen
      for (int k0 = 0; k0 < tlen; k0 += kAhead) {
        Pack<V> hp[kAhead], dp[kAhead];
        float d[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int ci = C - 1 - t0 - k0 - u;
          if (k0 + u < tlen) {
            d[u] = dec[static_cast<size_t>(ci) * H];
            if (live) {
              hp[u] = load<V>(hprev + base + ci * slab + e);
              if (dhprev) dp[u] = load<V>(dhprev + base + ci * slab + e);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int ci = C - 1 - t0 - k0 - u;
          if (k0 + u >= tlen) continue;
          float part = 0.f;
          if (live) {
            store<V>(dstates + base + ci * slab + e, g);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              part = __fadd_rn(part, __fmul_rn(g.v[i], hp[u].v[i]));
              const float gd = __fmul_rn(d[u], g.v[i]);
              g.v[i] = dhprev ? __fadd_rn(gd, dp[u].v[i]) : gd;
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            part = __fadd_rn(part, __shfl_xor_sync(kFull, part, o));
          if (ln == 0) s_warp[k0 + u][warp] = part;
        }
      }
      __syncthreads();
      if (tid < tlen) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v = __fadd_rn(v, s_warp[tid][w]);
        s_block[tid] = v;
      }
      cluster.sync();   // every block's s_block is written; s_warp is read
      if (rank == 0 && tid < tlen) {
        float v = 0.f;
        for (int k = 0; k < blocks; ++k)
          v = __fadd_rn(v, cluster.map_shared_rank(s_block, k)[tid]);
        float* out = ddecay + (b * C + (C - 1 - t0 - tid)) * H + hh;
        *out = r == 0 ? v : __fadd_rn(*out, v);
      }
      cluster.sync();   // block 0 has read every s_block
    }
  }
}

int vec_width(int L, const void* const* ptrs, int n) {
  if (L % 4 != 0) return 1;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return 1;
  return 4;
}

}  // namespace

extern "C" int repro_ssd_state_pass_fwd(const void* states, const void* decay,
                                        void* hprev, void* hlast, int b, int c,
                                        int h, int L, void* stream) {
  if (b < 1 || c < 1 || h < 1 || L < 1 || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {states, hprev, hlast};
  const int vec = vec_width(L, ptrs, 3);
  const dim3 grid((L / vec + kThreads - 1) / kThreads, h, b);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const float*>(states);
  const auto* dc = static_cast<const float*>(decay);
  auto* hp = static_cast<float*>(hprev);
  auto* hl = static_cast<float*>(hlast);
  if (vec == 4)
    ssd_state_pass_fwd_kernel<4><<<grid, kThreads, 0, s>>>(st, dc, hp, hl, c, h, L);
  else
    ssd_state_pass_fwd_kernel<1><<<grid, kThreads, 0, s>>>(st, dc, hp, hl, c, h, L);
  return static_cast<int>(cudaGetLastError());
}

// dhprev and dhlast may be null: no gradient reaches hprev or the final state.
extern "C" int repro_ssd_state_pass_bwd(const void* decay, const void* hprev,
                                        const void* dhprev, const void* dhlast,
                                        void* dstates, void* ddecay, int b,
                                        int c, int h, int L, void* stream) {
  if (b < 1 || c < 1 || h < 1 || L < 1 || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {hprev, dhprev, dhlast, dstates};
  const int vec = vec_width(L, ptrs, 4);
  const int per_block = kThreads * vec;
  const int blocks = std::min(kMaxCluster, (L + per_block - 1) / per_block);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, h, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto* dc = static_cast<const float*>(decay);
  const auto* hp = static_cast<const float*>(hprev);
  const auto* dhp = static_cast<const float*>(dhprev);
  const auto* dhl = static_cast<const float*>(dhlast);
  auto* ds = static_cast<float*>(dstates);
  auto* dd = static_cast<float*>(ddecay);
  cudaError_t err =
      vec == 4 ? cudaLaunchKernelEx(&cfg, ssd_state_pass_bwd_kernel<4>, dc, hp,
                                    dhp, dhl, ds, dd, c, h, L)
               : cudaLaunchKernelEx(&cfg, ssd_state_pass_bwd_kernel<1>, dc, hp,
                                    dhp, dhl, ds, dd, c, h, L);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
