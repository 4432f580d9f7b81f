// Pieces shared by the cluster recurrence kernels (lstm_fwd.cu, lstm_bwd.cu,
// lstmx_fwd.cu, lstmx_bwd.cu, lstm_tiled_fwd.cu, lstm_tiled_bwd.cu), for
// Hopper (sm_90a): the gate sigmoid, the phase clocks, the mbarriers that
// signal a step's slices pushed into a block's shared memory by the other
// blocks of its cluster (by remote arrivals, or by the bytes st.async stores
// count), the counters in global memory that hand work from one block (or
// kernel) to another, and cp.async copies.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Phase clocks: built with -DPHASE_CLOCKS (python -m
// lstm_tensorspark_torch.phase_clocks), thread `thread` of block 0 adds the
// SM cycles since its previous mark to g_clk[i] at CLK_MARK_AT(i, thread)
// (CLK_MARK(i): thread 0), and kernel_phase_clocks copies the sums out and
// clears them. The add is a reduction nothing waits for (a read-modify-write
// would stall the marking thread on its load inside the next phase).
// Without the flag the marks are nothing.
#ifdef PHASE_CLOCKS
__device__ unsigned long long g_clk[16];
#define CLK_START unsigned long long _clk_last = clock64();
#define CLK_MARK_AT(i, thread)                       \
  if (threadIdx.x == (thread) && blockIdx.x == 0) {  \
    const unsigned long long _clk_now = clock64();   \
    atomicAdd(&g_clk[i], _clk_now - _clk_last);      \
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

// the shared::cluster address of `addr` (this block's shared memory) in
// block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// one arrival on the mbarrier at the same place in block `rank`'s shared
// memory
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  const uint32_t remote = mapa_addr(smem_addr(bar), rank);
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


// Counters in global memory (zeroed by the wrapper before the launch). A
// block publishes its data with plain stores, a block barrier, then one
// thread's fence and atomic add; a reader's one thread spins on an acquiring
// load until the count is reached, then a block barrier, and the block reads
// the data through L2 (L1 is not coherent with the other SMs' stores). (A
// flag a block, polled by many threads at once, measured slower: the polls
// crowd L2.) A spin needs its producer to run: the tiled pair's cooperative
// launch keeps every block resident, lstmx_fwd.cu's projection never waits
// on its chain. As a backstop the spins trap after about two seconds; a trap
// is fatal to the CUDA context (every later call in the process fails), so it
// must never be the way a grid that cannot be resident is turned away.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void wait_count(const int* p, int target) {
  const long long t0 = clock64();
  while (ld_acquire(p) < target) {
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

__device__ __forceinline__ void arrive_count(int* p) {
  __threadfence();
  atomicAdd(p, 1);
}

// mbar_wait, trapping after about two seconds
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
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
    if (!done && clock64() - t0 > (1LL << 32)) __trap();
  } while (!done);
}

// mbar_wait_bounded with the acquire at CTA scope, for data that lands in
// this block's shared memory by bytes the mbarrier counts (st.async) when
// nothing after the wait reads global memory another block wrote: the
// cluster scope costs an L1 invalidation a warp and wait
__device__ __forceinline__ void mbar_wait_cta_bounded(uint64_t* bar,
                                                      uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 32)) __trap();
  } while (!done);
}

// The next phase of the local mbarrier `bar` expects `bytes` of bulk copies
// or st.async stores (this thread's arrival: the barrier counts one a phase)
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Four floats to the shared::cluster address `dst`, counted as 16 bytes on
// the mbarrier at the shared::cluster address `bar` of the same block
// (st.async: the receiver waits on its mbarrier, no arrival or barrier
// needed)
__device__ __forceinline__ void st_async_v4_at(uint32_t dst, float4 v,
                                               uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// st_async_v4_at to `dst`'s and `bar`'s offsets in the shared memory of
// block `rank` of the cluster (this block's own rank too)
__device__ __forceinline__ void st_async_v4(float* dst, float4 v,
                                            uint64_t* bar, int rank) {
  st_async_v4_at(mapa_addr(smem_addr(dst), rank), v,
                 mapa_addr(smem_addr(bar), rank));
}

// 16 bytes global -> shared through L2 (cp.async.cg: L1 is not coherent
// with the other SMs' stores)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared (data no kernel of the call writes)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// this thread's cp.async copies have landed (a block barrier then shows
// them to the other threads)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
