// Holds a stream until the host has queued an instruction's card work, so
// that the timing events around that work time the card and not the host's
// feeding of it (core/backend.py, CardGate).  Instrumentation of a traced
// run; no TPU kernel corresponds to it.
//
// words[0] is the last item the host has opened, words[1] the last item
// whose gate stopped waiting at its timeout.  Both live in pinned host
// memory, which a kernel reads and writes through the same pointer under
// unified addressing.  One thread polls; the timeout bounds the wait, so an
// item that synchronises with its own stream before it opens the gate is
// delayed, never hung.
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned long long repro_now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void repro_card_gate_kernel(volatile int* words, int item,
                                       unsigned long long timeout_ns) {
  const unsigned long long t0 = repro_now_ns();
  // item numbers grow by one per item; the difference survives wrap-around
  while (static_cast<int>(static_cast<unsigned>(words[0]) -
                          static_cast<unsigned>(item)) < 0) {
    if (repro_now_ns() - t0 > timeout_ns) {
      words[1] = item;
      __threadfence_system();
      return;
    }
    __nanosleep(256);
  }
}

extern "C" int repro_card_gate(void* words, int item,
                               unsigned long long timeout_ns, void* stream) {
  repro_card_gate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<volatile int*>(words), item, timeout_ns);
  return static_cast<int>(cudaGetLastError());
}
