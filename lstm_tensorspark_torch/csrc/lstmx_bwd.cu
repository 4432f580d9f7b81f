// Fused backward (BPTT) of the "residentx" LSTM kernels, one or two
// directions, for Hopper (sm_90a), float32.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_bwdx_kernel (one
// direction, ND = 1) and ops/pallas_bilstm.py::_bi_bwdx_kernel (both
// directions of a bi-LSTM layer, ND = 2). The forward (lstmx_fwd.cu) saved
// only the cell states cs; the backward rebuilds the pre-activations
//   z_t = (x_t @ W_d + b_d) + h_{t-1} @ U_d
// from xs and h_prev (the forward's ys shifted by one step, h0 first), with
// the forward's summation order (lstmx_common.cuh), so z is the forward's to
// the bit, and walks time in reverse with the cotangent algebra of
// _bi_bwdx_kernel:
//   i, f, o = sigmoid(z), g = tanh(z), tanh(c_t) with c_t = f*c_{t-1} + i*g;
//   dh_tot = dh + dys_t; dc_new = dc + dh_tot * o * (1 - tanh(c_t)^2);
//   dz_t = [dc_new*g*i*(1-i), dc_new*c_{t-1}*f*(1-f), dc_new*i*(1-g^2),
//           dh_tot*tanh(c_t)*o*(1-o)]      (gate order i, f, g, o)
//   dh = dz_t @ U_d^T, dc = dc_new * f,
// and under the mask (m = 0 at a frozen step) the gates see m * dh_tot and
// m * dc while (1 - m) of both bypass them into the previous step. It writes
// dz [T, ND*B, 4H] and dh0, dc0; dW, dU, db and dxs are matmuls over T*B
// outside, per direction.
//
// What bounds it on the card: at the LM's T=256 shape (B=64, D=H=128) a call
// does 19.3 GFLOP and the roofline says 0.096 ms, by operations; what it
// does not see is the chain of T dependent steps, each a [RB, 4H] x [4H, UPC]
// product, the exchange of dz between the blocks of a cluster, and the gate
// algebra. Two thirds of the operations, the z rebuild, do not depend on the
// chain, so the design takes them off it and onto the SMs the chain leaves
// idle (at the LM's shape the chain's 16 clusters of 4 take 64 of 132):
//   - lstmx_factors_kernel rebuilds z for a chunk of C steps of one row
//     group and one block's units per block, in the forward's order, and
//     turns z, c_prev, dys and the mask into the per-element factors of the
//     algebra (below), written to a scratch stream in device memory. It
//     runs on a second stream beside the chain, latest chunk first, and
//     counts each finished chunk in `ready`; the chain waits for a chunk's
//     count before it reads it. Inside the chain's own SMs the rebuild
//     competed with the chain for issue slots and shared memory: warp-
//     specialised that way (a producer warp group beside the chain's) the
//     backward took 1.19 ms at the LM's shape, and the two kernels one
//     after the other 0.96 ms (PERF.md).
//   - lstmx_bwd_kernel runs the dependent steps. The algebra needs no
//     transcendental: with A = o(1 - tc^2), Bo = tc o(1-o), Ci = g i(1-i),
//     Cf = c_prev f(1-f), Cg = i(1-g^2),
//       dc_new = m dc + m dh_tot A, dz = (dc_new Ci, dc_new Cf, dc_new Cg,
//       m dh_tot Bo), dc' = dc_new f + (1-m) dc.
//     A step's factors are loaded into registers a step ahead.
//   - A group of KS2 neighbouring lanes owns one hidden unit and four rows
//     and keeps their dh and dc carries in registers; each lane sums every
//     KS2-th term of dz @ U^T (its terms of U^T in registers when they fit,
//     else U^T's slice in shared memory), the sums meet by warp shuffles,
//     and every lane of the group then holds the same dh and computes the
//     same algebra: the lanes share the stores (four float4 dz slices to
//     every block of the cluster, 16 values of dz to device memory).
//   - No cluster barrier per step: after its slices a block passes one
//     block barrier, signals each other block's mbarrier for the step's dz
//     buffer (cluster_common.cuh), stores dz to device memory, and waits on
//     its own.
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// Plain C interface for ctypes: lstmx_bwd_launch returns the CUDA error code
// (0 = success). It allocates nothing (the factor stream is scratch the
// caller passes) and does not synchronise; it runs on the stream it is given.

#include <cooperative_groups.h>

#include "lstmx_common.cuh"

namespace cg = cooperative_groups;

#define NPLANE 8   // factors per element: A Bo Ci Cf Cg F dy, and the mask
#define PROD_QM 4  // float4 accumulators of a rebuild item
#define UT_REG 64  // terms of dz @ U^T a lane keeps in registers

// where a block's slice of U_d^T lives: each lane's terms in its registers
// (4H / KS2 <= UT_REG), the block's slice in shared memory, or read
// through L2
enum { UT_REGS = 0, UT_SMEM = 1, UT_L2 = 2 };

// The factor stream, float4s of four rows: fac[t][grp][rq][plane][col] with
// grp the row group (ND * GPD of them), rq its row quads (RB4 / 4), col the
// CS * UPC units of a cluster's blocks.
__host__ __device__ __forceinline__ size_t fac_index(int t, int grp, int rq,
                                                     int plane, int col,
                                                     int NG, int RQ,
                                                     int WU) {
  return (((size_t)(t * NG + grp) * RQ + rq) * NPLANE + plane) * WU + col;
}

// lstmx_factors_kernel's shared memory, in floats: the chunk's inputs,
// then its h_prev, transposed (stg [max(D,H)][C*RB4 + 4], stage_rows), and
// the chunk's rebuilt z (zbuf [C*RB4][4*UPC])
static size_t factors_smem_floats(int H, int D, int UPC, int RB4, int C) {
  const size_t E = (size_t)C * RB4;
  return (size_t)(D > H ? D : H) * (E + 4) + E * 4 * UPC;
}

// lstmx_bwd_kernel's shared memory, in floats (every piece a multiple of 4):
//   dzbuf [2][4H][RB4]   dz of every gate column for the group's rows,
//                        transposed so four rows load as one float4;
//                        double-buffered by step
//   bars  2 mbarriers    one per dzbuf buffer
//   UTs   [UPC][4H+KS2]  the block's rows of U_d (U_d^T's columns), padded so
//                        the KS2 lanes of neighbouring units meet no bank
//                        conflict (UT_SMEM only)
static size_t bwd_smem_floats(int H, int UPC, int RB4, int KS2, int ut_mode) {
  const size_t G = 4 * (size_t)H;
  size_t n = 2 * G * RB4 + 4;
  if (ut_mode == UT_SMEM) n += (G + KS2) * UPC;
  return n;
}

__device__ __forceinline__ float at(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// Rebuild z for C steps of one row group and one block's units, then the
// algebra's factors. Block b takes unit slice b % CS of row group
// (b / CS) % NG and the chunk b / (CS * NG) from the end.
#define REBUILD_MIN_BLOCKS 2  // rebuild blocks an SM keeps at once
__global__ void __launch_bounds__(THREADS, REBUILD_MIN_BLOCKS)
lstmx_factors_kernel(const float* __restrict__ xs,
                     const float* __restrict__ ys,
                     const float* __restrict__ h0,
                     const float* __restrict__ cs,
                     const float* __restrict__ c0,
                     const float* __restrict__ dys,
                     const float* __restrict__ mask,
                     const float* __restrict__ W,
                     const float* __restrict__ bias,
                     const float* __restrict__ U, float4* __restrict__ fac,
                     int* __restrict__ ready, int T, int B, int ND, int D,
                     int H, int CS, int UPC, int RB, int RB4, int GPD,
                     int ZKS, int C) {
  const int tid = threadIdx.x;
  const int G = 4 * H, NC = 4 * UPC, BS = ND * B, NG = ND * GPD;
  const int rank = blockIdx.x % CS;
  const int grp = (blockIdx.x / CS) % NG;
  // the last chunk first: the chain walks time in reverse
  const int n = (T + C - 1) / C - 1 - (int)(blockIdx.x / (CS * NG));
  const int dir = grp / GPD, gi = grp - dir * GPD;
  const int row0 = dir * B + gi * RB, nrows = min(RB, B - gi * RB);
  const int u0 = rank * UPC, nu = max(0, min(UPC, H - u0));
  const float* Wd = W + (size_t)dir * D * G;
  const float* bd = bias + (size_t)dir * G;
  const float* Ud = U + (size_t)dir * H * G;
  const int t0 = n * C, clen = min(C, T - t0);
  const int NQ = clen * RB4 / 4;

  extern __shared__ float4 smem4[];
  float* stg = reinterpret_cast<float*>(smem4);
  float* zbuf = stg + (size_t)max(D, H) * (C * RB4 + 4);
  CLK_START

  stage_rows(stg, xs, nullptr, t0, clen, BS, row0, nrows, RB4, D);
  __syncthreads();
  CLK_MARK_AT(0, 0)
  chunk_product<PROD_QM>(stg, D, NQ, Wd, G, H, UPC, u0, nu, 1, bd, zbuf);
  __syncthreads();
  stage_rows(stg, ys, h0, t0, clen, BS, row0, nrows, RB4, H);
  __syncthreads();
  CLK_MARK_AT(1, 0)
  chunk_product<PROD_QM>(stg, H, NQ, Ud, G, H, UPC, u0, nu, ZKS, nullptr,
                         zbuf);
  __syncthreads();
  CLK_MARK_AT(2, 0)

  // factors of four elements (rows 4q' .. 4q'+3 of one step) of a unit
  const int RQ = RB4 / 4, WU = CS * UPC;
  for (int i = tid; i < NQ * UPC; i += THREADS) {
    const int u = i % UPC, q = i / UPC;
    const int c = (4 * q) / RB4, rb = 4 * q - c * RB4;
    const int t = t0 + c;
    float pl[NPLANE][4];
#pragma unroll
    for (int r4 = 0; r4 < 4; ++r4) {
      const int r = rb + r4;
      const bool ok = r < nrows && u < nu;
      const size_t row = (size_t)(row0 + r);
      const size_t col = row * H + u0 + u;
      float cp = 0.0f, dy = 0.0f, m = 0.0f;
      if (ok) {
        cp = t > 0 ? cs[(size_t)(t - 1) * BS * H + col] : c0[col];
        dy = dys[(size_t)t * BS * H + col];
        m = mask != nullptr ? mask[(size_t)t * BS + row] : 1.0f;
      }
      const float* zr = zbuf + (size_t)(4 * q + r4) * NC + u;
      const float ig = sigmoid_f(zr[0]);
      const float fg = sigmoid_f(zr[UPC]);
      const float gg = tanhf(zr[2 * UPC]);
      const float og = sigmoid_f(zr[3 * UPC]);
      const float tc = tanhf(fg * cp + ig * gg);
      pl[0][r4] = og * (1.0f - tc * tc);
      pl[1][r4] = tc * og * (1.0f - og);
      pl[2][r4] = gg * ig * (1.0f - ig);
      pl[3][r4] = cp * fg * (1.0f - fg);
      pl[4][r4] = ig * (1.0f - gg * gg);
      pl[5][r4] = fg;
      pl[6][r4] = dy;
      pl[7][r4] = m;  // 0 for rows past the group's: their dz stay 0
    }
    if (u < nu) {
#pragma unroll
      for (int k = 0; k < NPLANE; ++k)
        fac[fac_index(t, grp, rb / 4, k, u0 + u, NG, RQ, WU)] =
            make_float4(pl[k][0], pl[k][1], pl[k][2], pl[k][3]);
    }
  }
  CLK_MARK_AT(3, 0)
  // the chunk's factors of this block's units are out: count them
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicAdd(ready + n * NG + grp, 1);
}

// Wait until all CS blocks of row group grp have written chunk n's factors
// (lstmx_factors_kernel, which may run beside this kernel).
__device__ __forceinline__ void wait_chunk(const int* ready, int n, int NG,
                                           int grp, int CS) {
  if (threadIdx.x == 0) {
    const int* p = ready + n * NG + grp;
    int v;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                   : "=r"(v)
                   : "l"(p)
                   : "memory");
      if (v >= CS) break;
      __nanosleep(256);
    }
  }
  __syncthreads();
}

template <int UT_MODE>
__global__ void __launch_bounds__(THREADS, 1)
lstmx_bwd_kernel(const float4* __restrict__ fac, const int* __restrict__ ready,
                 const float* __restrict__ UT, const float* __restrict__ dhT,
                 const float* __restrict__ dcT, float* __restrict__ dz,
                 float* __restrict__ dh0, float* __restrict__ dc0, int T,
                 int B, int ND, int H, int UPC, int RB, int RB4, int GPD,
                 int KS2, int C) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int G = 4 * H;
  const int BS = ND * B;
  const int NG = ND * GPD, RQ = RB4 / 4, WU = CS * UPC;
  const int grp = blockIdx.x / CS;
  const Geo geo = block_geo(CS, rank, B, H, UPC, RB, GPD);
  const int u0 = geo.u0, nu = geo.nu, row0 = geo.row0, nrows = geo.nrows;
  const float* UTd = UT + (size_t)geo.dir * G * H;

  extern __shared__ float4 smem4[];
  float* dzbuf = reinterpret_cast<float*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(dzbuf + 2 * G * RB4);
  float* UTs = dzbuf + 2 * G * RB4 + 4;
  const int ldu = G + KS2;

  for (int i = tid; i < 2 * G * RB4; i += THREADS) dzbuf[i] = 0.0f;
  if (UT_MODE == UT_SMEM) {
    for (int i = tid; i < G * UPC; i += THREADS) {
      const int j = i / UPC, u = i - j * UPC;
      UTs[u * ldu + j] = u < nu ? UTd[(size_t)j * H + u0 + u] : 0.0f;
    }
  }
  if (tid == 0 && CS > 1) {
    mbar_init(&bars[0], CS - 1);
    mbar_init(&bars[1], CS - 1);
    mbar_init_fence();
  }

  // this thread's group: unit u, rows rb .. rb+3, lane ks of KS2
  const int nitems = UPC * RQ;
  const int item = tid / KS2, ks = tid - item * KS2;
  const bool live = item < nitems;
  const int it = live ? item : 0;
  const int u = it % UPC, rq = it / UPC, rb = 4 * rq;
  const bool active = live && u < nu;
  float dh[4], dc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool ok = active && rb + r < nrows;
    const size_t g = (size_t)(row0 + rb + r) * H + u0 + u;
    dh[r] = ok ? dhT[g] : 0.0f;
    dc[r] = ok ? dcT[g] : 0.0f;
  }
  // the lane's terms of dz @ U^T: j = ks, ks + KS2, ... (neighbouring lanes
  // read neighbouring dz rows: no bank conflict); a lane past the block's
  // units reads unit 0 of U^T's rows
  const float* wp =
      UT_MODE == UT_SMEM ? UTs + u * ldu : UTd + u0 + (active ? u : 0);
  const size_t ldw = UT_MODE == UT_SMEM ? 1 : (size_t)H;
  float utr[UT_MODE == UT_REGS ? UT_REG : 1];
  if (UT_MODE == UT_REGS) {
#pragma unroll
    for (int i = 0; i < UT_REG; ++i) {
      const int j = ks + i * KS2;
      utr[i] = (j < G && active) ? wp[(size_t)j * ldw] : 0.0f;
    }
  }
  // a step's factors, loaded one step ahead through L2 (the rebuild may
  // still be writing the stream; a lane past the block's units loads unit
  // 0's and stores nothing)
  const int col = u0 + (active ? u : 0);
  float4 f[NPLANE], fn[NPLANE];
  wait_chunk(ready, (T - 1) / C, NG, grp, CS);
#pragma unroll
  for (int k = 0; k < NPLANE; ++k) {
    f[k] = __ldcg(fac + fac_index(T - 1, grp, rq, k, col, NG, RQ, WU));
    fn[k] = f[k];
  }
  // every block of the cluster runs (and has its buffers and mbarriers set)
  // before any block writes into another's shared memory
  cluster.sync();
  CLK_START

  for (int t = T - 1, s = 0; t >= 0; --t, ++s) {
    const int cur = (s & 1) * G * RB4;
    if (t > 0 && (t - 1) / C != t / C)
      wait_chunk(ready, (t - 1) / C, NG, grp, CS);
    if (t > 0) {
#pragma unroll
      for (int k = 0; k < NPLANE; ++k)
        fn[k] =
            __ldcg(fac + fac_index(t - 1, grp, rq, k, col, NG, RQ, WU));
    }
    float dzv[4][4], skip[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float m = at(f[7], r);
      const float dh_tot = dh[r] + at(f[6], r);
      const float dh_eff = m * dh_tot, dc_in = dc[r];
      const float dc_new = m * dc_in + dh_eff * at(f[0], r);
      dzv[0][r] = dc_new * at(f[2], r);
      dzv[1][r] = dc_new * at(f[3], r);
      dzv[2][r] = dc_new * at(f[4], r);
      dzv[3][r] = dh_eff * at(f[1], r);
      dc[r] = dc_new * at(f[5], r) + (1.0f - m) * dc_in;
      skip[r] = (1.0f - m) * dh_tot;
    }
    // the four gate slices (four rows each) to every block; job j goes to
    // lane j % KS2 (indices stay compile-time, so dzv stays in registers)
    if (active) {
      for (int k = 0; k < CS; ++k) {
        float* dst = dzbuf + cur + (u0 + u) * RB4 + rb;
        if (k != rank) dst = cluster.map_shared_rank(dst, k);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (((4 * k + g) & (KS2 - 1)) == ks)
            *reinterpret_cast<float4*>(dst + g * H * RB4) = make_float4(
                dzv[g][0], dzv[g][1], dzv[g][2], dzv[g][3]);
        }
      }
    }
    // this block's slices are complete: tell every other block, store dz
    // to device memory while theirs arrive, then wait for them
    __syncthreads();
    if (CS > 1 && tid < CS && tid != rank)
      mbar_arrive_remote(&bars[s & 1], tid);
    CLK_MARK(4)
    if (active) {
      const size_t zb = ((size_t)t * BS + row0 + rb) * G + u0 + u;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (((4 * r + g) & (KS2 - 1)) == ks && rb + r < nrows)
            dz[zb + (size_t)r * G + g * H] = dzv[g][r];
        }
      }
    }
    if (CS > 1) mbar_wait(&bars[s & 1], (s >> 1) & 1);
    CLK_MARK(5)

    // dh[r] = sum_j dz[r][j] * U[u0 + u][j]: this lane's terms, then the
    // group's sums added by shuffles
    const float* dzc = dzbuf + cur + rb;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (UT_MODE == UT_REGS) {
#pragma unroll
      for (int i = 0; i < UT_REG; ++i) {
        // past the lane's terms the weight is 0 and dz row 0 finite
        const int j = ks + i * KS2 < G ? ks + i * KS2 : 0;
        const float4 dv = *reinterpret_cast<const float4*>(dzc + j * RB4);
        a0 = fmaf(dv.x, utr[i], a0);
        a1 = fmaf(dv.y, utr[i], a1);
        a2 = fmaf(dv.z, utr[i], a2);
        a3 = fmaf(dv.w, utr[i], a3);
      }
    } else {
      int j = ks;
      for (; j + 7 * KS2 < G; j += 8 * KS2) {
        float wv[8];
        float4 dv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          wv[q] = wp[(size_t)(j + q * KS2) * ldw];
          dv[q] = *reinterpret_cast<const float4*>(dzc + (j + q * KS2) * RB4);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          a0 = fmaf(dv[q].x, wv[q], a0);
          a1 = fmaf(dv[q].y, wv[q], a1);
          a2 = fmaf(dv[q].z, wv[q], a2);
          a3 = fmaf(dv[q].w, wv[q], a3);
        }
      }
      for (; j < G; j += KS2) {
        const float wv = wp[(size_t)j * ldw];
        const float4 dv = *reinterpret_cast<const float4*>(dzc + j * RB4);
        a0 = fmaf(dv.x, wv, a0);
        a1 = fmaf(dv.y, wv, a1);
        a2 = fmaf(dv.z, wv, a2);
        a3 = fmaf(dv.w, wv, a3);
      }
    }
    for (int o = 1; o < KS2; o <<= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, o);
      a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
      a3 += __shfl_xor_sync(0xffffffffu, a3, o);
    }
    dh[0] = a0 + skip[0];
    dh[1] = a1 + skip[1];
    dh[2] = a2 + skip[2];
    dh[3] = a3 + skip[3];
#pragma unroll
    for (int k = 0; k < NPLANE; ++k) f[k] = fn[k];
    CLK_MARK(6)
  }

  if (active && ks == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (rb + r < nrows) {
        const size_t ob = (size_t)(row0 + rb + r) * H + u0 + u;
        dh0[ob] = dh[r];
        dc0[ob] = dc[r];
      }
    }
  }
  // no block leaves while another may still write into its shared memory
  cluster.sync();
}

template <int UT_MODE>
static cudaError_t launch_chain(const float4* fac, const int* ready,
                                const float* UT, const float* dhT,
                                const float* dcT, float* dz, float* dh0,
                                float* dc0, int T, int B, int ND, int H,
                                int CS, int UPC, int RB, int RB4, int GPD,
                                int KS2, int C, size_t smem,
                                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      lstmx_bwd_kernel<UT_MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS * GPD * ND, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, lstmx_bwd_kernel<UT_MODE>, fac, ready, UT,
                            dhT, dcT, dz, dh0, dc0, T, B, ND, H, UPC, RB, RB4,
                            GPD, KS2, C);
}

// xs [T, ND*B, D]; ys, cs, dys [T, ND*B, H] (the forward's ys and cs);
// h0, c0, dhT, dcT, dh0, dc0 [ND*B, H]; mask [T, ND*B] or null; W [ND, D,
// 4H]; b [ND, 4H]; U [ND, H, 4H]; UT [ND, 4H, H] (U transposed); dz [T,
// ND*B, 4H]; fac scratch of ops/cuda_lstmx.py::factor_floats floats
// (16-byte aligned); ready ceil(T / C) * ND * GPD ints, zero. Plan
// arguments as in lstmx_fwd_launch, ZKS being the forward's KS (the pieces
// of h @ U), C the steps of a rebuild block, KS2 the lanes that share a
// unit's dz @ U^T sum (a power of two, at most 32, KS2 * UPC * RB4 / 4 <=
// 256), ut_mode where U^T's slice lives (0 the lanes' registers: 4H / KS2 <=
// 64; 1 shared memory; 2 read through L2). The rebuild runs on
// rebuild_stream and the chain on stream: two streams let the chain start
// on the chunks already rebuilt (the caller orders both after the inputs and
// the rest after both, and passes one stream when the chain's blocks would
// leave the rebuild no SM).
extern "C" int lstmx_bwd_launch(const void* xs, const void* ys,
                                const void* h0, const void* cs,
                                const void* c0, const void* dys,
                                const void* mask, const void* W, const void* b,
                                const void* U, const void* UT, const void* dhT,
                                const void* dcT, void* dz, void* dh0,
                                void* dc0, void* fac, void* ready, int T,
                                int B, int ND, int D, int H, int CS, int UPC,
                                int RB, int RB4, int GPD, int ZKS, int KS2,
                                int C, int ut_mode, void* rebuild_stream,
                                void* stream) {
  if (T < 1 || B < 1 || ND < 1 || ND > 2 || D < 1 || H < 1 || CS < 1 ||
      CS > MAX_CLUSTER || UPC < 1 || (CS - 1) * UPC >= H || CS * UPC < H ||
      RB < 1 || RB4 < RB || RB4 % 4 != 0 || GPD < 1 || GPD * RB < B ||
      (GPD - 1) * RB >= B || ZKS < 1 || KS2 < 1 || KS2 > 32 ||
      (KS2 & (KS2 - 1)) != 0 || KS2 * UPC * (RB4 / 4) > THREADS || C < 1 ||
      ut_mode < UT_REGS || ut_mode > UT_L2 ||
      (ut_mode == UT_REGS && (4 * H + KS2 - 1) / KS2 > UT_REG))
    return (int)cudaErrorInvalidValue;
  const size_t fsmem = sizeof(float) * factors_smem_floats(H, D, UPC, RB4, C);
  const size_t smem =
      sizeof(float) * bwd_smem_floats(H, UPC, RB4, KS2, ut_mode);
  if (fsmem > MAX_SMEM_BYTES || smem > MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      lstmx_factors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fsmem);
  if (e != cudaSuccess) return (int)e;
  const int nchunks = (T + C - 1) / C;
  lstmx_factors_kernel<<<nchunks * ND * GPD * CS, THREADS, fsmem,
                         (cudaStream_t)rebuild_stream>>>(
      (const float*)xs, (const float*)ys, (const float*)h0, (const float*)cs,
      (const float*)c0, (const float*)dys, (const float*)mask,
      (const float*)W, (const float*)b, (const float*)U, (float4*)fac,
      (int*)ready, T, B, ND, D, H, CS, UPC, RB, RB4, GPD, ZKS, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float4* f = (const float4*)fac;
  const int* r = (const int*)ready;
  if (ut_mode == UT_REGS)
    e = launch_chain<UT_REGS>(f, r, (const float*)UT, (const float*)dhT,
                              (const float*)dcT, (float*)dz, (float*)dh0,
                              (float*)dc0, T, B, ND, H, CS, UPC, RB, RB4, GPD,
                              KS2, C, smem, (cudaStream_t)stream);
  else if (ut_mode == UT_SMEM)
    e = launch_chain<UT_SMEM>(f, r, (const float*)UT, (const float*)dhT,
                              (const float*)dcT, (float*)dz, (float*)dh0,
                              (float*)dc0, T, B, ND, H, CS, UPC, RB, RB4, GPD,
                              KS2, C, smem, (cudaStream_t)stream);
  else
    e = launch_chain<UT_L2>(f, r, (const float*)UT, (const float*)dhT,
                            (const float*)dcT, (float*)dz, (float*)dh0,
                            (float*)dc0, T, B, ND, H, CS, UPC, RB, RB4, GPD,
                            KS2, C, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
