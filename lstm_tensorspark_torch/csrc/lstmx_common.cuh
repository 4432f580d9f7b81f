// Pieces shared by lstmx_fwd.cu and lstmx_bwd.cu, the "residentx" LSTM
// recurrence kernels (the input projection computed by the pair itself, z
// recomputed in the backward), for Hopper (sm_90a), float32, with the
// bfloat16 forms' loads (stream_dtype.cuh): an operand of element type TS is
// converted to float where it is loaded, so every product below is a float
// FMA and both kernels still take the same sums in the same order.
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
// The forward's projection kernel runs one fmaf chain over k per output and
// adds the bias last; its chain sums one piece of hU per thread and folds the
// pieces in order, so KS is part of the launch plan that both kernels
// receive (ops/cuda_lstmx.py::plan).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "cluster_common.cuh"
#include "stream_dtype.cuh"

#define THREADS 256
#define MAX_CLUSTER 8
#define MAX_SMEM_BYTES 232448  // 227 KB: the most a block may opt in to
#define QMAX 8                 // float4 accumulators of one chunk_product item
#define KB 16                  // weight loads chunk_product keeps in flight
#define SB 8                   // loads a thread of stage_rows keeps in flight

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

// Stage clen steps of the group's rows of src [T][BS][K] (element type TSRC,
// each value rounded to TR's precision: the bfloat16 backward stages its
// float32 h_prev rounded to bfloat16, as the forward's product reads it)
// transposed into
// dst [K][lda] (dst[k*lda + c*RB4 + r]), zeros for rows past nrows, where
// lda = clen*RB4 + 4: the pad keeps float4 rows aligned and spreads a
// warp's stores (8 values of k times 4 of c*RB4 + r) over all 32 banks.
// With `first` set, step t reads src's step t - 1 and step 0 reads first
// [BS][K] (h_prev from the forward's ys and h0). Each thread keeps SB loads
// in flight before it stores.
template <typename TSRC, typename TR>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const TSRC* __restrict__ src,
                                           const TSRC* __restrict__ first,
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
          v[q] = to_f32(src[((size_t)t * BS + row) * K + k]);
        else
          v[q] = to_f32(t > 0 ? src[((size_t)(t - 1) * BS + row) * K + k]
                              : first[row * K + k]);
        v[q] = round_to<TR>(v[q]);
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

template <typename TW>
__device__ __forceinline__ void load_w(float (&w)[KB],
                                       const TW* __restrict__ wp, int k,
                                       int ldw) {
#pragma unroll
  for (int q = 0; q < KB; ++q) w[q] = ld_stream(wp + (size_t)(k + q) * ldw);
}

// acc[j] += A[k + q][q0 + j] * w[q] for q = 0 .. KB-1 in order
template <int QM>
__device__ __forceinline__ void fma_w(float4 (&acc)[QM], const float (&w)[KB],
                                      const float4* A4, int lda4, int q0,
                                      int nq, int k) {
#pragma unroll
  for (int q = 0; q < KB; ++q) {
    const float4* ar = A4 + (size_t)(k + q) * lda4 + q0;
#pragma unroll
    for (int j = 0; j < QM; ++j) {
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

// For the block's NC gate columns and the NQ*4 entries of A [K][NQ*4 + 4]
// (a chunk's steps times the group's rows, as stage_rows leaves them):
//   out[e][lc] = addend + sum_k A[k][e] * Wd[k*ldw + col(lc)]
// with the sum in KS pieces as described at the top. The addend is
// bias[col] when `bias` is given, else the value out holds already. Each
// output is summed whole by one thread; how items spread over threads does
// not change any bit. An item holds up to QM float4 accumulators. Wd's
// elements are TW (float, or bfloat16 in the bfloat16 forms).
template <int QM = QMAX, typename TW>
__device__ __forceinline__ void chunk_product(
    const float* A, int K, int NQ, const TW* __restrict__ Wd, int ldw,
    int H, int UPC, int u0, int nu, int KS, const float* __restrict__ bias,
    float* out) {
  const int NC = 4 * UPC;
  int QS = (NQ + QM - 1) / QM;
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
    const TW* wp = Wd + col;
    float4 tot[QM];
    for (int ks = 0; ks < KS; ++ks) {
      const int k0 = ks * Kc, k1 = min(K, k0 + Kc);
      float4 acc[QM];
#pragma unroll
      for (int j = 0; j < QM; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
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
        const float wv = ld_stream(wp + (size_t)k * ldw);
        const float4* ar = A4 + (size_t)k * lda4 + q0;
#pragma unroll
        for (int j = 0; j < QM; ++j) {
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
      for (int j = 0; j < QM; ++j) {
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
    for (int j = 0; j < QM; ++j) {
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
