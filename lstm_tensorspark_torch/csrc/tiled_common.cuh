// Pieces shared by the tiled LSTM pair (lstm_tiled_fwd.cu, lstm_tiled_bwd.cu),
// for Hopper (sm_90a): the product of a lane's register-held weights, TMA
// bulk copies multicast to a cluster, and the cooperative cluster launch with
// its co-residency check. The step counters in global memory that replace a
// grid-wide barrier (wait_count, arrive_count), the bounded mbarrier wait,
// bulk_expect and cp.async are in cluster_common.cuh.
//
// The pair runs one persistent block per SM in clusters of C = 2 or 4
// blocks; block b owns UPB hidden units (their cell state), and rank q of a
// cluster the q-th slice of H (Hq = ceil(H / C) rows). Rows of the batch go
// in tiles of ROWS.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_common.cuh"

#define THREADS 256
#define WARPS 8
#define ROWS 16                // batch rows of a tile
#define KREG 64                // U rows (fwd) / columns (bwd) a lane keeps in registers
#define MAX_UNITS 16           // ROWS * UPB cell threads at most
#define MAX_CLUSTER 4
#define MAX_SMEM_BYTES 232448  // 227 KB: the most a block may opt in to

// A TMA bulk copy of `bytes` (a multiple of 16) from global `src` to `dst`
// in the shared memory of every block of the cluster in `mask` (the same
// offset in each), completing on the mbarrier at `bar`'s offset in each. The
// fence orders this thread's acquired view of global memory, and the
// block's earlier reads of dst, before the copy.
__device__ __forceinline__ void bulk_copy_multicast(float* dst, const float* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("fence.proxy.async;" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(d),
      "l"(src), "r"(bytes), "r"(b), "h"(mask)
      : "memory");
}

// acc[r][e] += v[k][r] * w[k][e] over the lane's first `regs` rows k of
// weights in registers, v read as four float4 (16 rows) a k, k after k
// `stride` float4 apart: an address the lanes of a group share. FULL (regs
// == KREG) drops the guard per k, so the compiler can hoist the next k's
// loads over this k's FMAs.
template <bool FULL>
__device__ __forceinline__ void lane_product(float (&acc)[ROWS][2],
                                             const float4* v,
                                             const float (&w)[KREG][2],
                                             int regs, int stride) {
#pragma unroll
  for (int k = 0; k < KREG; ++k) {
    if (FULL || k < regs) {
      float x[ROWS];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const float4 f = v[k * stride + q4];
        x[4 * q4] = f.x, x[4 * q4 + 1] = f.y;
        x[4 * q4 + 2] = f.z, x[4 * q4 + 3] = f.w;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc[r][0] = fmaf(x[r], w[k][0], acc[r][0]);
        acc[r][1] = fmaf(x[r], w[k][1], acc[r][1]);
      }
    }
  }
}

// Launch `kernel` as blocks / C clusters of C blocks, cooperatively (the
// steps' counters need every block running at once: the CUDA runtime then
// schedules the whole grid together or refuses the launch), after checking
// that the card keeps that many clusters resident
// (cudaOccupancyMaxActiveClusters): cudaErrorCooperativeLaunchTooLarge when
// it does not.
template <typename Kernel, typename... Args>
static cudaError_t launch_clusters(Kernel kernel, int blocks, int C,
                                   size_t smem, cudaStream_t stream,
                                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;  // the occupancy query takes the cluster shape alone
  int resident = 0;
  e = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (resident * C < blocks) return cudaErrorCooperativeLaunchTooLarge;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// how many clusters of C blocks of `kernel`, each asking for smem bytes, the
// card keeps resident at once
template <typename Kernel>
static cudaError_t max_clusters_of(Kernel kernel, int C, int smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}
