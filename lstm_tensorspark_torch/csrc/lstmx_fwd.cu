// Forward recurrence of the "residentx" LSTM kernels, one or two directions,
// for Hopper (sm_90a), float32.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_fwdx_kernel (one
// direction, ND = 1) and ops/pallas_bilstm.py::_bi_fwdx_kernel (both
// directions of a bi-LSTM layer in one launch, ND = 2). Unlike lstm_fwd.cu,
// the input projection happens here: for every chunk of C steps the block
// computes its gate columns of
//   zx = xs_chunk @ W_d + b_d            (off the dependent chain)
// and then, step by step,
//   z_t = zx_t + h_{t-1} @ U_d           (gate order i, f, g, o)
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
// with the optional mask blend m * new + (1 - m) * old. It writes ys, hT, cT
// and, for training, the cell states cs [T, ND*B, H], the only residual the
// backward (lstmx_bwd.cu) needs: z is rebuilt there, never stored.
//
// What bounds it on the card: at config 2 (B=32 per direction, T=400,
// D=H=256, two directions) a call does 2*T*2B*(D+H)*4H = 26.8 GFLOP of
// products and moves about 83 MB, so the roofline says 0.40 ms, by
// operations. The T dependent steps (a [RB, H] x [H, 4*UPC] product from
// shared memory, the cell update, one cluster barrier) are the floor the
// roofline does not see. The design:
//   - as in lstm_fwd.cu, a cluster owns RB rows of one direction and loops
//     over T; block k keeps its units' four gate columns of U_d in shared
//     memory (128 KiB at H=256) and sends its new h (one contiguous slice
//     of the h buffer, as float4 stores) to every block of the cluster
//     through distributed shared memory, double-buffered;
//   - W_d does not fit beside U_d (another 128 KiB at D=256), and it is off
//     the chain, so the chunk projection reads it through L2: each W value
//     loaded feeds 16 (C=8) products of the chunk's staged inputs;
//   - the two directions are separate clusters of one launch. The H100
//     keeps 15 clusters of 8 blocks resident at 227 KB a block
//     (lstmx_fwd_max_clusters); the plan gives the forward clusters of 8
//     rows at config 2, 8 clusters in one wave, rather than 16 clusters of
//     4 rows whose last one would run as a second wave. The backward keeps
//     4-row clusters: with 8 rows its buffers leave room for a projection
//     chunk of one step only (PERF.md).
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// Plain C interface for ctypes: lstmx_fwd_launch returns the CUDA error code
// (0 = success). It allocates nothing and does not synchronise; it runs on the
// stream it is given.

#include <cooperative_groups.h>

#include "lstmx_common.cuh"

namespace cg = cooperative_groups;

// Shared-memory layout, in floats (every piece a multiple of 4 floats):
//   hbuf [2][H][RB4]    h of every unit for the group's rows, transposed so
//                       four rows load as one float4; double-buffered
//   zacc [RB4][NC]      h @ U for the block's NC = 4 * UPC gate columns
//   cown [RB4][UPC]     c of the block's own units
//   red  [KS][RB4][NC]  the KS pieces of h @ U (KS > 1)
//   xsT  [D][C*RB4 + 4] the chunk's inputs, transposed (stage_rows)
//   zx   [C*RB4][NC]    the chunk's projection zx
//   msk  [C*RB4]        the chunk's mask
//   Us   [H][NC]        the block's slice of U_d (when it fits)
static size_t fwd_smem_floats(int H, int D, int UPC, int RB4, int KS, int C,
                              bool smem_u) {
  const size_t NC = 4 * (size_t)UPC;
  size_t n = 2 * (size_t)H * RB4 + (size_t)RB4 * NC + (size_t)RB4 * UPC;
  if (KS > 1) n += (size_t)KS * RB4 * NC;
  n += (size_t)D * (C * RB4 + 4) + (size_t)C * RB4 * NC + (size_t)C * RB4;
  if (smem_u) n += (size_t)H * NC;
  return n;
}

template <bool SMEM_U>
__global__ void __launch_bounds__(THREADS)
lstmx_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ W,
                 const float* __restrict__ bias, const float* __restrict__ U,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 const float* __restrict__ mask, float* __restrict__ ys,
                 float* __restrict__ hT, float* __restrict__ cT,
                 float* __restrict__ cs_out, int T, int B, int ND, int D,
                 int H, int UPC, int RB, int RB4, int GPD, int KS, int C) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int G = 4 * H;
  const int NC = 4 * UPC;
  const int BS = ND * B;
  const Geo geo = block_geo(CS, rank, B, H, UPC, RB, GPD);
  const int u0 = geo.u0, nu = geo.nu, row0 = geo.row0, nrows = geo.nrows;
  const float* Wd = W + (size_t)geo.dir * D * G;
  const float* bd = bias + (size_t)geo.dir * G;
  const float* Ud = U + (size_t)geo.dir * H * G;

  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);
  float* zacc = hbuf + 2 * H * RB4;
  float* cown = zacc + RB4 * NC;
  float* red = cown + RB4 * UPC;
  float* xsT = red + (KS > 1 ? KS * RB4 * NC : 0);
  float* zx = xsT + (size_t)D * (C * RB4 + 4);
  float* msk = zx + (size_t)C * RB4 * NC;
  float* Us = msk + C * RB4;

  for (int i = tid; i < H * RB4; i += THREADS) {
    const int d = i / RB4, r = i - d * RB4;
    hbuf[i] = r < nrows ? h0[(size_t)(row0 + r) * H + d] : 0.0f;
    hbuf[H * RB4 + i] = 0.0f;
  }
  for (int i = tid; i < RB4 * UPC; i += THREADS) {
    const int r = i / UPC, u = i - r * UPC;
    cown[i] = (r < nrows && u < nu) ? c0[(size_t)(row0 + r) * H + u0 + u]
                                    : 0.0f;
  }
  if (SMEM_U) {
    for (int i = tid; i < H * NC; i += THREADS) {
      const int d = i / NC, lc = i - d * NC;
      const int g = lc / UPC, u = lc - g * UPC;
      Us[i] = u < nu ? Ud[(size_t)d * G + g * H + u0 + u] : 0.0f;
    }
  }
  // every block of the cluster runs (and has its buffers set) before any
  // block writes into another's shared memory
  cluster.sync();
  CLK_START

  const int items = NC * (RB4 / 4);
  const int Kc = (H + KS - 1) / KS;
  for (int t0 = 0; t0 < T; t0 += C) {
    const int clen = min(C, T - t0);
    // the chunk's projection, off the dependent chain
    stage_rows(xsT, xs, nullptr, t0, clen, BS, row0, nrows, RB4, D);
    if (mask != nullptr) stage_mask(msk, mask, t0, clen, BS, row0, nrows, RB4);
    __syncthreads();
    CLK_MARK(0)
    chunk_product(xsT, D, clen * RB4 / 4, Wd, G, H, UPC, u0, nu, 1, bd, zx);
    __syncthreads();
    CLK_MARK(1)

    for (int c = 0; c < clen; ++c) {
      const int t = t0 + c;
      const float* hcur = hbuf + (t & 1) * H * RB4;
      const int nxt = ((t + 1) & 1) * H * RB4;

      // zacc[r][lc] = sum_d h[r][d] * U[d][gate column of lc], in KS pieces,
      // four rows per thread so every weight read feeds four products
      for (int w = tid; w < items * KS; w += THREADS) {
        const int base = w % items, ks = w / items;
        const int lc = base % NC, rg = base / NC;
        const int g = lc / UPC, u = lc - g * UPC;
        if (u >= nu) continue;
        const int d0 = ks * Kc, d1 = min(H, d0 + Kc);
        const float* wp = SMEM_U ? Us + lc : Ud + g * H + u0 + u;
        const size_t ldw = SMEM_U ? (size_t)NC : (size_t)G;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        int d = d0;
        // eight steps' loads first, then their products in order
        for (; d + 8 <= d1; d += 8) {
          float wv[8];
          float4 hv[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            wv[q] = wp[(size_t)(d + q) * ldw];
            hv[q] = *reinterpret_cast<const float4*>(hcur + (d + q) * RB4 +
                                                     rg * 4);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            a0 = fmaf(hv[q].x, wv[q], a0);
            a1 = fmaf(hv[q].y, wv[q], a1);
            a2 = fmaf(hv[q].z, wv[q], a2);
            a3 = fmaf(hv[q].w, wv[q], a3);
          }
        }
        for (; d < d1; ++d) {
          const float wv = wp[(size_t)d * ldw];
          const float4 hv =
              *reinterpret_cast<const float4*>(hcur + d * RB4 + rg * 4);
          a0 = fmaf(hv.x, wv, a0);
          a1 = fmaf(hv.y, wv, a1);
          a2 = fmaf(hv.z, wv, a2);
          a3 = fmaf(hv.w, wv, a3);
        }
        float* dst = KS > 1 ? red + ks * RB4 * NC : zacc;
        dst[(rg * 4 + 0) * NC + lc] = a0;
        dst[(rg * 4 + 1) * NC + lc] = a1;
        dst[(rg * 4 + 2) * NC + lc] = a2;
        dst[(rg * 4 + 3) * NC + lc] = a3;
      }
      __syncthreads();
      if (KS > 1) {
        for (int i = tid; i < RB4 * NC; i += THREADS) {
          float s = red[i];
          for (int ks = 1; ks < KS; ++ks) s = s + red[ks * RB4 * NC + i];
          zacc[i] = s;
        }
        __syncthreads();
      }

      CLK_MARK(2)
      // cell update of the block's own units; the new h goes to every block
      const float* zxc = zx + (size_t)c * RB4 * NC;
      for (int i = tid; i < nrows * nu; i += THREADS) {
        const int r = i / nu, u = i - r * nu;
        const int row = row0 + r;
        const float* za = zacc + r * NC + u;
        const float* zb = zxc + r * NC + u;
        const float zi = zb[0] + za[0];
        const float zf = zb[UPC] + za[UPC];
        const float zg = zb[2 * UPC] + za[2 * UPC];
        const float zo = zb[3 * UPC] + za[3 * UPC];
        const float ig = sigmoid_f(zi);
        const float fg = sigmoid_f(zf);
        const float gg = tanhf(zg);
        const float og = sigmoid_f(zo);
        const float c_old = cown[r * UPC + u];
        float c_new = fg * c_old + ig * gg;
        float h_new = og * tanhf(c_new);
        if (mask != nullptr) {
          const float m = msk[c * RB4 + r];
          const float h_old = hcur[(u0 + u) * RB4 + r];
          c_new = m * c_new + (1.0f - m) * c_old;
          h_new = m * h_new + (1.0f - m) * h_old;
        }
        cown[r * UPC + u] = c_new;
        const size_t ob = ((size_t)t * BS + row) * H + u0 + u;
        ys[ob] = h_new;
        if (cs_out != nullptr) cs_out[ob] = c_new;
        hbuf[nxt + (u0 + u) * RB4 + r] = h_new;
      }
      __syncthreads();
      // the block's new h to every other block, then publish
      push_slices(cluster, hbuf + nxt + u0 * RB4, nu * RB4, 0, 1, CS, rank);
      CLK_MARK(3)
      // publishes this step's h to every block (and orders the local writes)
      cluster.sync();
      CLK_MARK(4)
    }
  }

  const float* hfin = hbuf + (T & 1) * H * RB4;
  for (int i = tid; i < nrows * nu; i += THREADS) {
    const int r = i / nu, u = i - r * nu;
    const size_t ob = (size_t)(row0 + r) * H + u0 + u;
    hT[ob] = hfin[(u0 + u) * RB4 + r];
    cT[ob] = cown[r * UPC + u];
  }
}

template <bool SMEM_U>
static cudaError_t launch(const float* xs, const float* W, const float* b,
                          const float* U, const float* h0, const float* c0,
                          const float* mask, float* ys, float* hT, float* cT,
                          float* cs, int T, int B, int ND, int D, int H, int CS,
                          int UPC, int RB, int RB4, int GPD, int KS, int C,
                          size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstmx_fwd_kernel<SMEM_U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
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
  return cudaLaunchKernelEx(&cfg, lstmx_fwd_kernel<SMEM_U>, xs, W, b, U, h0,
                            c0, mask, ys, hT, cT, cs, T, B, ND, D, H, UPC, RB,
                            RB4, GPD, KS, C);
}

// xs [T, ND*B, D]; W [ND, D, 4H]; b [ND, 4H]; U [ND, H, 4H]; h0, c0, hT, cT
// [ND*B, H]; mask [T, ND*B] or null; ys and cs [T, ND*B, H], cs may be null.
// Plan arguments (ops/cuda_lstmx.py::plan): CS blocks per cluster, UPC
// hidden units per block, RB rows per cluster (RB4 = RB rounded up to 4),
// GPD row groups per direction, KS pieces of the h @ U sum, C steps per
// projection chunk, smem_u = keep the block's slice of U in shared memory.
extern "C" int lstmx_fwd_launch(const void* xs, const void* W, const void* b,
                                const void* U, const void* h0, const void* c0,
                                const void* mask, void* ys, void* hT, void* cT,
                                void* cs, int T, int B, int ND, int D, int H,
                                int CS, int UPC, int RB, int RB4, int GPD,
                                int KS, int C, int smem_u, void* stream) {
  if (T < 1 || B < 1 || ND < 1 || ND > 2 || D < 1 || H < 1 || CS < 1 ||
      CS > MAX_CLUSTER || UPC < 1 || (CS - 1) * UPC >= H || CS * UPC < H ||
      RB < 1 || RB4 < RB || RB4 % 4 != 0 || GPD < 1 || GPD * RB < B ||
      (GPD - 1) * RB >= B || KS < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * fwd_smem_floats(H, D, UPC, RB4, KS, C, smem_u != 0);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (smem_u)
    e = launch<true>((const float*)xs, (const float*)W, (const float*)b,
                     (const float*)U, (const float*)h0, (const float*)c0,
                     (const float*)mask, (float*)ys, (float*)hT, (float*)cT,
                     (float*)cs, T, B, ND, D, H, CS, UPC, RB, RB4, GPD, KS, C,
                     smem, (cudaStream_t)stream);
  else
    e = launch<false>((const float*)xs, (const float*)W, (const float*)b,
                      (const float*)U, (const float*)h0, (const float*)c0,
                      (const float*)mask, (float*)ys, (float*)hT, (float*)cT,
                      (float*)cs, T, B, ND, D, H, CS, UPC, RB, RB4, GPD, KS, C,
                      smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of CS blocks of this kernel, each block asking for smem
// bytes of shared memory, the card keeps resident at once
// (cudaOccupancyMaxActiveClusters), into *out. ops/cuda_lstmx.py::plan fits
// a kernel's row groups into that many clusters when it can. Returns the CUDA
// error code.
extern "C" int lstmx_fwd_max_clusters(int CS, int smem, int* out) {
  if (CS < 1 || CS > MAX_CLUSTER || smem < 0 || smem > MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      lstmx_fwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, lstmx_fwd_kernel<true>,
                                             &cfg);
}
