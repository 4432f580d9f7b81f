// Pieces shared by lstmx_fwd.cu and lstmx_bwd.cu, the "residentx" LSTM
// recurrence kernels (the input projection computed inside the kernel, z
// recomputed in the backward), for Hopper (sm_90a), float32.
//
// Both kernels cut the work the same way: a cluster of CS blocks owns a group
// of RB rows of one direction; block k of the cluster owns hidden units
// [k*UPC, (k+1)*UPC) and the block's NC = 4*UPC gate columns of z (column
// g*H + u0 + u for gate g and unit u). Rows are stacked by direction: rows
// [0, B) are direction 0 and rows [B, 2B) direction 1 (the time-flipped
// reverse scan of a bi-LSTM layer, flipped outside); a direction picks its own
// W, b, U and U^T. ND = 1 is a plain single-direction layer.
//
// The backward must rebuild the forward's z to the bit, so both kernels take
// every sum of products in the same order (chunk_product below):
//   zx = (x_t . W[:, col]) + b[col]   one fmaf chain over k = 0 .. D-1
//   hU = h_{t-1} . U[:, col]          KS pieces of ceil(H/KS) terms, each an
//                                     fmaf chain from 0, folded left
//   z  = zx + hU
// The forward computes hU on the dependent chain with the same pieces (one
// piece per thread, folded in order), so KS is part of the launch plan that
// both kernels receive (ops/cuda_lstmx.py::plan).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256
#define MAX_CLUSTER 8
#define MAX_SMEM_BYTES 232448  // 227 KB: the most a block may opt in to
#define QMAX 8                 // float4 accumulators of one chunk_product item
#define KB 16                  // weight loads chunk_product keeps in flight
#define SB 8                   // loads a thread of stage_rows keeps in flight

// Phase clocks: built with -DLSTMX_PHASE_CLOCKS (python -m
// lstm_tensorspark_torch.phase_clocks), thread 0 of block 0 adds the SM
// cycles since the previous mark to g_clk[i], and lstmx_phase_clocks copies
// the sums out and clears them. Without the flag the marks are nothing.
#ifdef LSTMX_PHASE_CLOCKS
__device__ unsigned long long g_clk[16];
#define CLK_START unsigned long long _clk_last = clock64();
#define CLK_MARK(i)                                  \
  if (threadIdx.x == 0 && blockIdx.x == 0) {         \
    const unsigned long long _clk_now = clock64();   \
    g_clk[i] += _clk_now - _clk_last;                \
    _clk_last = _clk_now;                            \
  }
extern "C" int lstmx_phase_clocks(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));
  const unsigned long long zero[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));
  return (int)e;
}
#else
#define CLK_START
#define CLK_MARK(i)
#endif

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Which rows, direction and hidden units a block owns. GPD is the number of
// row groups (clusters) per direction.
struct Geo {
  int dir;    // direction of the block's rows
  int row0;   // first stacked row of the group
  int nrows;  // rows of the group (<= RB)
  int u0;     // first hidden unit of the block
  int nu;     // hidden units of the block (<= UPC; 0 never happens by plan)
};

__device__ __forceinline__ Geo block_geo(int CS, int rank, int B, int H,
                                         int UPC, int RB, int GPD) {
  Geo g;
  const int cid = blockIdx.x / CS;
  g.dir = cid / GPD;
  const int grp = cid - g.dir * GPD;
  g.row0 = g.dir * B + grp * RB;
  g.nrows = min(RB, B - grp * RB);
  g.u0 = rank * UPC;
  g.nu = max(0, min(UPC, H - g.u0));
  return g;
}

// Copy nslices slices of n floats each (n a multiple of 4, slice s at
// buf + s*stride, 16-byte aligned) from this block's shared memory to the
// same place in every other block of the cluster, as float4 stores spread
// over all threads. The caller barriers before (the slices are complete)
// and after (cluster.sync publishes them).
__device__ __forceinline__ void push_slices(
    cooperative_groups::cluster_group& cluster, float* buf, int n,
    int stride, int nslices, int CS, int rank) {
  const int n4 = n / 4, per = (CS - 1) * n4;
  for (int i = threadIdx.x; i < nslices * per; i += THREADS) {
    const int s = i / per, rem = i - s * per;
    const int k = rem / n4, j = rem - k * n4;
    float* src = buf + (size_t)s * stride;
    float4* dst = reinterpret_cast<float4*>(
        cluster.map_shared_rank(src, k + (k >= rank)));
    dst[j] = reinterpret_cast<const float4*>(src)[j];
  }
}

// Stage clen steps of the group's rows of src [T][BS][K] transposed into
// dst [K][lda] (dst[k*lda + c*RB4 + r]), zeros for rows past nrows, where
// lda = clen*RB4 + 4: the pad keeps float4 rows aligned and spreads a
// warp's stores (8 values of k times 4 of c*RB4 + r) over all 32 banks.
// With `first` set, step t reads src's step t - 1 and step 0 reads first
// [BS][K] (h_prev from the forward's ys and h0). Each thread keeps SB loads
// in flight before it stores.
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           const float* __restrict__ first,
                                           int t0, int clen, int BS, int row0,
                                           int nrows, int RB4, int K) {
  const int W = clen * RB4, lda = W + 4;
  const int ncg = W / 4, nkg = (K + 7) / 8;
  const int n = 32 * ncg * nkg;
  for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * SB) {
    float v[SB];
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int i = i0 + q * THREADS;
      const int lane = i & 31, grp = i >> 5;
      const int cr = (grp % ncg) * 4 + (lane & 3);
      const int k = (grp / ncg) * 8 + (lane >> 2);
      const int c = cr / RB4, r = cr - c * RB4;
      v[q] = 0.0f;
      if (i < n && k < K && r < nrows) {
        const int t = t0 + c;
        const size_t row = (size_t)(row0 + r);
        if (first == nullptr)
          v[q] = src[((size_t)t * BS + row) * K + k];
        else
          v[q] = t > 0 ? src[((size_t)(t - 1) * BS + row) * K + k]
                       : first[row * K + k];
      }
    }
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int i = i0 + q * THREADS;
      const int lane = i & 31, grp = i >> 5;
      const int cr = (grp % ncg) * 4 + (lane & 3);
      const int k = (grp / ncg) * 8 + (lane >> 2);
      if (i < n && k < K) dst[(size_t)k * lda + cr] = v[q];
    }
  }
}

__device__ __forceinline__ void load_w(float (&w)[KB],
                                       const float* __restrict__ wp, int k,
                                       int ldw) {
#pragma unroll
  for (int q = 0; q < KB; ++q) w[q] = __ldg(wp + (size_t)(k + q) * ldw);
}

// acc[j] += A[k + q][q0 + j] * w[q] for q = 0 .. KB-1 in order
__device__ __forceinline__ void fma_w(float4 (&acc)[QMAX],
                                      const float (&w)[KB], const float4* A4,
                                      int lda4, int q0, int nq, int k) {
#pragma unroll
  for (int q = 0; q < KB; ++q) {
    const float4* ar = A4 + (size_t)(k + q) * lda4 + q0;
#pragma unroll
    for (int j = 0; j < QMAX; ++j) {
      if (j < nq) {
        const float4 av = ar[j];
        acc[j].x = fmaf(av.x, w[q], acc[j].x);
        acc[j].y = fmaf(av.y, w[q], acc[j].y);
        acc[j].z = fmaf(av.z, w[q], acc[j].z);
        acc[j].w = fmaf(av.w, w[q], acc[j].w);
      }
    }
  }
}

// Stage clen steps of the block's own units of src [T][BS][H] into
// dst [clen*RB4][UPC] (dst[(c*RB4 + r)*UPC + u]), zeros outside the group's
// rows and the block's units; with `first` set, step t reads src's step
// t - 1 and step 0 reads first [BS][H] (c_prev from cs and c0).
__device__ __forceinline__ void stage_own(float* dst,
                                          const float* __restrict__ src,
                                          const float* __restrict__ first,
                                          int t0, int clen, int BS, int row0,
                                          int nrows, int RB4, int H, int u0,
                                          int UPC, int nu) {
  const int n = clen * RB4 * UPC;
  for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * SB) {
    float v[SB];
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int i = i0 + q * THREADS;
      const int cr = i / UPC, u = i - cr * UPC;
      const int c = cr / RB4, r = cr - c * RB4;
      v[q] = 0.0f;
      if (i < n && r < nrows && u < nu) {
        const int t = t0 + c;
        const size_t col = (size_t)(row0 + r) * H + u0 + u;
        if (first == nullptr)
          v[q] = src[(size_t)t * BS * H + col];
        else
          v[q] = t > 0 ? src[(size_t)(t - 1) * BS * H + col] : first[col];
      }
    }
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int i = i0 + q * THREADS;
      if (i < n) dst[i] = v[q];
    }
  }
}

// Stage clen steps of the group's mask [T][BS] into dst [clen*RB4]
// (dst[c*RB4 + r], 0 outside the group's rows).
__device__ __forceinline__ void stage_mask(float* dst,
                                           const float* __restrict__ mask,
                                           int t0, int clen, int BS, int row0,
                                           int nrows, int RB4) {
  for (int i = threadIdx.x; i < clen * RB4; i += THREADS) {
    const int c = i / RB4, r = i - c * RB4;
    dst[i] = r < nrows ? mask[(size_t)(t0 + c) * BS + row0 + r] : 0.0f;
  }
}

// For the block's NC gate columns and the NQ*4 entries of A [K][NQ*4 + 4]
// (a chunk's steps times the group's rows, as stage_rows leaves them):
//   out[e][lc] = addend + sum_k A[k][e] * Wd[k*ldw + col(lc)]
// with the sum in KS pieces as described at the top. The addend is
// bias[col] when `bias` is given, else the value out holds already. Each
// output is summed whole by one thread; how items spread over threads does
// not change any bit.
__device__ __forceinline__ void chunk_product(
    const float* A, int K, int NQ, const float* __restrict__ Wd, int ldw,
    int H, int UPC, int u0, int nu, int KS, const float* __restrict__ bias,
    float* out) {
  const int NC = 4 * UPC;
  int QS = (NQ + QMAX - 1) / QMAX;
  const int spread = min(NQ, max(1, THREADS / NC));
  if (spread > QS) QS = spread;
  const int Qc = (NQ + QS - 1) / QS;
  const int Kc = (K + KS - 1) / KS;
  const int lda4 = NQ + 1;  // float4s per row of A
  const float4* A4 = reinterpret_cast<const float4*>(A);
  for (int w = threadIdx.x; w < NC * QS; w += THREADS) {
    const int lc = w % NC, qs = w / NC;
    const int g = lc / UPC, u = lc - g * UPC;
    const int q0 = qs * Qc;
    const int nq = min(Qc, NQ - q0);
    if (u >= nu || nq <= 0) continue;
    const int col = g * H + u0 + u;
    const float* wp = Wd + col;
    float4 tot[QMAX];
    for (int ks = 0; ks < KS; ++ks) {
      const int k0 = ks * Kc, k1 = min(K, k0 + Kc);
      float4 acc[QMAX];
#pragma unroll
      for (int j = 0; j < QMAX; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      // KB weight loads in flight while the previous KB feed their
      // products (one block per SM leaves few warps to hide L2 latency);
      // per output the products still run in increasing k
      float wa[KB], wb[KB];
      int k = k0;
      if (k + KB <= k1) load_w(wa, wp, k, ldw);
      while (k + KB <= k1) {
        const bool nb = k + 2 * KB <= k1;
        if (nb) load_w(wb, wp, k + KB, ldw);
        fma_w(acc, wa, A4, lda4, q0, nq, k);
        k += KB;
        if (!nb) break;
        const bool na = k + 2 * KB <= k1;
        if (na) load_w(wa, wp, k + KB, ldw);
        fma_w(acc, wb, A4, lda4, q0, nq, k);
        k += KB;
        if (!na) break;
      }
      for (; k < k1; ++k) {
        const float wv = __ldg(wp + (size_t)k * ldw);
        const float4* ar = A4 + (size_t)k * lda4 + q0;
#pragma unroll
        for (int j = 0; j < QMAX; ++j) {
          if (j < nq) {
            const float4 av = ar[j];
            acc[j].x = fmaf(av.x, wv, acc[j].x);
            acc[j].y = fmaf(av.y, wv, acc[j].y);
            acc[j].z = fmaf(av.z, wv, acc[j].z);
            acc[j].w = fmaf(av.w, wv, acc[j].w);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < QMAX; ++j) {
        if (ks == 0) {
          tot[j] = acc[j];
        } else {
          tot[j].x = tot[j].x + acc[j].x;
          tot[j].y = tot[j].y + acc[j].y;
          tot[j].z = tot[j].z + acc[j].z;
          tot[j].w = tot[j].w + acc[j].w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QMAX; ++j) {
      if (j < nq) {
        float* o = out + (size_t)(q0 + j) * 4 * NC + lc;
        if (bias != nullptr) {
          const float bv = __ldg(bias + col);
          o[0] = tot[j].x + bv;
          o[NC] = tot[j].y + bv;
          o[2 * NC] = tot[j].z + bv;
          o[3 * NC] = tot[j].w + bv;
        } else {
          o[0] = o[0] + tot[j].x;
          o[NC] = o[NC] + tot[j].y;
          o[2 * NC] = o[2 * NC] + tot[j].z;
          o[3 * NC] = o[3 * NC] + tot[j].w;
        }
      }
    }
  }
}
