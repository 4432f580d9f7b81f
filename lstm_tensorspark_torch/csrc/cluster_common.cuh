// Pieces shared by the cluster recurrence kernels (lstm_fwd.cu, lstmx_fwd.cu,
// lstmx_bwd.cu), for Hopper (sm_90a): the gate sigmoid, the phase clocks,
// and the mbarriers that signal a step's slices pushed into a block's shared
// memory by the other blocks of its cluster.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Phase clocks: built with -DPHASE_CLOCKS (python -m
// lstm_tensorspark_torch.phase_clocks), thread `thread` of block 0 adds the
// SM cycles since its previous mark to g_clk[i] at CLK_MARK_AT(i, thread)
// (CLK_MARK(i): thread 0), and kernel_phase_clocks copies the sums out and
// clears them. Without the flag the marks are nothing.
#ifdef PHASE_CLOCKS
__device__ unsigned long long g_clk[16];
#define CLK_START unsigned long long _clk_last = clock64();
#define CLK_MARK_AT(i, thread)                       \
  if (threadIdx.x == (thread) && blockIdx.x == 0) {  \
    const unsigned long long _clk_now = clock64();   \
    g_clk[i] += _clk_now - _clk_last;                \
    _clk_last = _clk_now;                            \
  }
extern "C" int kernel_phase_clocks(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));
  const unsigned long long zero[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));
  return (int)e;
}
#else
#define CLK_START
#define CLK_MARK_AT(i, thread)
#endif
#define CLK_MARK(i) CLK_MARK_AT(i, 0)

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A step's exchange without a cluster barrier: each block owns one mbarrier
// per exchange buffer, expecting one arrival from every other block of the
// cluster per phase. A block stores its slice into the others' buffers
// (distributed shared memory), passes a block barrier so all its threads'
// stores precede the signal, then one thread per destination arrives on the
// destination's mbarrier with release semantics at cluster scope; the
// destination waits on the phase with acquire semantics. Buffers alternate
// by step, so the phase of a buffer at step s is (s >> 1) & 1.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised mbarriers visible to the cluster (before the
// cluster barrier that precedes any remote arrival)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival on the mbarrier at the same place in block `rank`'s shared
// memory
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          remote)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

