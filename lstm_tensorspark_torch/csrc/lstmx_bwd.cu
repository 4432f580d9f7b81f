// Fused backward (BPTT) of the "residentx" LSTM kernels, one or two
// directions, for Hopper (sm_90a), float32.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_bwdx_kernel (one
// direction, ND = 1) and ops/pallas_bilstm.py::_bi_bwdx_kernel (both
// directions of a bi-LSTM layer, ND = 2). The forward (lstmx_fwd.cu) saved
// only the cell states cs; this kernel walks time in reverse, one chunk of C
// steps at a time, and first rebuilds the chunk's pre-activations
//   z_t = (x_t @ W_d + b_d) + h_{t-1} @ U_d
// from xs and h_prev (the forward's ys shifted by one step, h0 first), with
// the forward's summation order (lstmx_common.cuh), so z is the forward's to
// the bit. Then per step and row, the cotangent algebra of _bi_bwdx_kernel:
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
// What bounds it on the card: at config 2 a call does 40.3 GFLOP (the z
// rebuild's two products and dz @ U^T) and moves about 216 MB, so the
// roofline says 0.60 ms, by operations; the chain of T dependent steps is
// again the floor it does not see. The design mirrors lstm_bwd.cu on the
// chain: block k owns units [k*UPC, (k+1)*UPC), keeps their rows of U_d (as
// columns of U_d^T, 128 KiB at H=256) in shared memory for dh, and sends its
// dz (four contiguous slices, as float4 stores) to every block of the
// cluster through distributed shared memory, one cluster barrier per step. The z rebuild is off the chain: W_d and U_d are
// read through L2, each value feeding 2*C products.
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// Plain C interface for ctypes: lstmx_bwd_launch returns the CUDA error code
// (0 = success). It allocates nothing and does not synchronise; it runs on the
// stream it is given.

#include <cooperative_groups.h>

#include "lstmx_common.cuh"

namespace cg = cooperative_groups;

// Shared-memory layout, in floats (every piece a multiple of 4 floats):
//   dzbuf [2][4H][RB4]   dz of every gate column for the group's rows,
//                        transposed so four rows load as one float4
//   dhown [RB4][UPC]     dh carry of the block's own units
//   dcown [RB4][UPC]     dc carry of the block's own units
//   skip  [RB4][UPC]     (1 - m) * dh_tot, the masked bypass into dh
//   red   [KS2][RB4][UPC] partial sums when the 4H-sum is split (KS2 > 1)
//   stg   [max(D,H)][C*RB4 + 4]  the chunk's inputs, then its h_prev,
//                        transposed (stage_rows)
//   zbuf  [C*RB4][NC]    the chunk's rebuilt z for the block's columns
//   dyS   [C*RB4][UPC]   the chunk's dys of the block's units
//   cpS   [C*RB4][UPC]   the chunk's c_prev of the block's units
//   msk   [C*RB4]        the chunk's mask
//   UTs   [4H][UPC]      the block's columns of U_d^T (when they fit)
static size_t bwd_smem_floats(int H, int D, int UPC, int RB4, int KS2, int C,
                              bool smem_ut) {
  const size_t G = 4 * (size_t)H;
  size_t n = 2 * G * RB4 + 3 * (size_t)RB4 * UPC;
  if (KS2 > 1) n += (size_t)KS2 * RB4 * UPC;
  n += (size_t)(D > H ? D : H) * (C * RB4 + 4) + (size_t)C * RB4 * 4 * UPC;
  n += 2 * (size_t)C * RB4 * UPC + (size_t)C * RB4;
  if (smem_ut) n += G * UPC;
  return n;
}

template <bool SMEM_UT>
__global__ void __launch_bounds__(THREADS)
lstmx_bwd_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                 const float* __restrict__ h0, const float* __restrict__ cs,
                 const float* __restrict__ c0, const float* __restrict__ dys,
                 const float* __restrict__ mask, const float* __restrict__ W,
                 const float* __restrict__ bias, const float* __restrict__ U,
                 const float* __restrict__ UT, const float* __restrict__ dhT,
                 const float* __restrict__ dcT, float* __restrict__ dz,
                 float* __restrict__ dh0, float* __restrict__ dc0, int T,
                 int B, int ND, int D, int H, int UPC, int RB, int RB4,
                 int GPD, int ZKS, int KS2, int C) {
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
  const float* UTd = UT + (size_t)geo.dir * G * H;

  extern __shared__ float4 smem4[];
  float* dzbuf = reinterpret_cast<float*>(smem4);
  float* dhown = dzbuf + 2 * G * RB4;
  float* dcown = dhown + RB4 * UPC;
  float* skip = dcown + RB4 * UPC;
  float* red = skip + RB4 * UPC;
  float* stg = red + (KS2 > 1 ? KS2 * RB4 * UPC : 0);
  float* zbuf = stg + (size_t)max(D, H) * (C * RB4 + 4);
  float* dyS = zbuf + (size_t)C * RB4 * NC;
  float* cpS = dyS + (size_t)C * RB4 * UPC;
  float* msk = cpS + (size_t)C * RB4 * UPC;
  float* UTs = msk + C * RB4;

  for (int i = tid; i < 2 * G * RB4; i += THREADS) dzbuf[i] = 0.0f;
  for (int i = tid; i < RB4 * UPC; i += THREADS) {
    const int r = i / UPC, u = i - r * UPC;
    const bool own = r < nrows && u < nu;
    const size_t g = (size_t)(row0 + r) * H + u0 + u;
    dhown[i] = own ? dhT[g] : 0.0f;
    dcown[i] = own ? dcT[g] : 0.0f;
    skip[i] = 0.0f;
  }
  if (SMEM_UT) {
    for (int i = tid; i < G * UPC; i += THREADS) {
      const int j = i / UPC, u = i - j * UPC;
      UTs[i] = u < nu ? UTd[(size_t)j * H + u0 + u] : 0.0f;
    }
  }
  // every block of the cluster runs (and has its buffers set) before any
  // block writes into another's shared memory
  cluster.sync();
  CLK_START

  const int items = UPC * (RB4 / 4);
  const int Kc = (G + KS2 - 1) / KS2;
  const int nchunks = (T + C - 1) / C;
  int s = 0;  // reverse step count: picks the dz buffer
  for (int n = nchunks - 1; n >= 0; --n) {
    const int t0 = n * C;
    const int clen = min(C, T - t0);
    const int NQ = clen * RB4 / 4;
    // rebuild the chunk's z, off the dependent chain
    stage_rows(stg, xs, nullptr, t0, clen, BS, row0, nrows, RB4, D);
    stage_own(dyS, dys, nullptr, t0, clen, BS, row0, nrows, RB4, H, u0, UPC,
              nu);
    stage_own(cpS, cs, c0, t0, clen, BS, row0, nrows, RB4, H, u0, UPC, nu);
    if (mask != nullptr) stage_mask(msk, mask, t0, clen, BS, row0, nrows, RB4);
    __syncthreads();
    chunk_product(stg, D, NQ, Wd, G, H, UPC, u0, nu, 1, bd, zbuf);
    __syncthreads();
    stage_rows(stg, ys, h0, t0, clen, BS, row0, nrows, RB4, H);
    __syncthreads();
    chunk_product(stg, H, NQ, Ud, G, H, UPC, u0, nu, ZKS, nullptr, zbuf);
    __syncthreads();
    CLK_MARK(0)

    for (int c = clen - 1; c >= 0; --c, ++s) {
      const int t = t0 + c;
      const int cur = (s & 1) * G * RB4;
      const float* zc = zbuf + (size_t)c * RB4 * NC;

      // gate algebra of the block's own units; dz goes to every block
      for (int i = tid; i < nrows * nu; i += THREADS) {
        const int r = i / nu, u = i - r * nu;
        const int row = row0 + r;
        const size_t zb = ((size_t)t * BS + row) * G + u0 + u;
        const int cu = (c * RB4 + r) * UPC + u;
        const float* zr = zc + r * NC + u;
        const float ig = sigmoid_f(zr[0]);
        const float fg = sigmoid_f(zr[UPC]);
        const float gg = tanhf(zr[2 * UPC]);
        const float og = sigmoid_f(zr[3 * UPC]);
        const float cp = cpS[cu];
        const float tc = tanhf(fg * cp + ig * gg);
        const int o = r * UPC + u;
        const float dh_tot = dhown[o] + dyS[cu];
        const float dc_in = dcown[o];
        float m = 1.0f, dh_eff = dh_tot, dc_eff = dc_in;
        if (mask != nullptr) {
          m = msk[c * RB4 + r];
          dh_eff = m * dh_tot;
          dc_eff = m * dc_in;
        }
        const float dc_new = dc_eff + dh_eff * og * (1.0f - tc * tc);
        const float d_o = dh_eff * tc * og * (1.0f - og);
        const float d_i = dc_new * gg * ig * (1.0f - ig);
        const float d_f = dc_new * cp * fg * (1.0f - fg);
        const float d_g = dc_new * ig * (1.0f - gg * gg);
        dz[zb] = d_i;
        dz[zb + H] = d_f;
        dz[zb + 2 * H] = d_g;
        dz[zb + 3 * H] = d_o;
        float dc_next = dc_new * fg;
        if (mask != nullptr) {
          dc_next = dc_next + (1.0f - m) * dc_in;
          skip[o] = (1.0f - m) * dh_tot;
        }
        dcown[o] = dc_next;
        float* rb = dzbuf + cur;
        rb[(u0 + u) * RB4 + r] = d_i;
        rb[(H + u0 + u) * RB4 + r] = d_f;
        rb[(2 * H + u0 + u) * RB4 + r] = d_g;
        rb[(3 * H + u0 + u) * RB4 + r] = d_o;
      }
      __syncthreads();
      // the block's four gate slices of dz to every other block
      push_slices(cluster, dzbuf + cur + u0 * RB4, nu * RB4, H * RB4, 4, CS,
                  rank);
      CLK_MARK(1)
      // publishes this step's dz to every block
      cluster.sync();
      CLK_MARK(2)

      // dh[r][u] = sum_j dz[r][j] * U[u0 + u][j], four rows per thread
      const float* dzc = dzbuf + cur;
      for (int w = tid; w < items * KS2; w += THREADS) {
        const int base = w % items, ks = w / items;
        const int u = base % UPC, rg = base / UPC;
        if (u >= nu) continue;
        const int j0 = ks * Kc, j1 = min(G, j0 + Kc);
        const float* wp = SMEM_UT ? UTs + u : UTd + u0 + u;
        const size_t ldw = SMEM_UT ? (size_t)UPC : (size_t)H;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        int j = j0;
        // eight columns' loads first, then their products in order
        for (; j + 8 <= j1; j += 8) {
          float wv[8];
          float4 dv[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            wv[q] = wp[(size_t)(j + q) * ldw];
            dv[q] = *reinterpret_cast<const float4*>(dzc + (j + q) * RB4 +
                                                     rg * 4);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            a0 = fmaf(dv[q].x, wv[q], a0);
            a1 = fmaf(dv[q].y, wv[q], a1);
            a2 = fmaf(dv[q].z, wv[q], a2);
            a3 = fmaf(dv[q].w, wv[q], a3);
          }
        }
        for (; j < j1; ++j) {
          const float wv = wp[(size_t)j * ldw];
          const float4 dv =
              *reinterpret_cast<const float4*>(dzc + j * RB4 + rg * 4);
          a0 = fmaf(dv.x, wv, a0);
          a1 = fmaf(dv.y, wv, a1);
          a2 = fmaf(dv.z, wv, a2);
          a3 = fmaf(dv.w, wv, a3);
        }
        if (KS2 > 1) {
          float* dst = red + ks * RB4 * UPC;
          dst[(rg * 4 + 0) * UPC + u] = a0;
          dst[(rg * 4 + 1) * UPC + u] = a1;
          dst[(rg * 4 + 2) * UPC + u] = a2;
          dst[(rg * 4 + 3) * UPC + u] = a3;
        } else {
          dhown[(rg * 4 + 0) * UPC + u] = a0 + skip[(rg * 4 + 0) * UPC + u];
          dhown[(rg * 4 + 1) * UPC + u] = a1 + skip[(rg * 4 + 1) * UPC + u];
          dhown[(rg * 4 + 2) * UPC + u] = a2 + skip[(rg * 4 + 2) * UPC + u];
          dhown[(rg * 4 + 3) * UPC + u] = a3 + skip[(rg * 4 + 3) * UPC + u];
        }
      }
      if (KS2 > 1) {
        __syncthreads();
        for (int i = tid; i < RB4 * UPC; i += THREADS) {
          float acc = red[i];
          for (int ks = 1; ks < KS2; ++ks) acc += red[ks * RB4 * UPC + i];
          dhown[i] = acc + skip[i];
        }
      }
      __syncthreads();
      CLK_MARK(3)
    }
  }

  for (int i = tid; i < nrows * nu; i += THREADS) {
    const int r = i / nu, u = i - r * nu;
    const size_t ob = (size_t)(row0 + r) * H + u0 + u;
    dh0[ob] = dhown[r * UPC + u];
    dc0[ob] = dcown[r * UPC + u];
  }
}

template <bool SMEM_UT>
static cudaError_t launch(const float* xs, const float* ys, const float* h0,
                          const float* cs, const float* c0, const float* dys,
                          const float* mask, const float* W, const float* b,
                          const float* U, const float* UT, const float* dhT,
                          const float* dcT, float* dz, float* dh0, float* dc0,
                          int T, int B, int ND, int D, int H, int CS, int UPC,
                          int RB, int RB4, int GPD, int ZKS, int KS2, int C,
                          size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstmx_bwd_kernel<SMEM_UT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  return cudaLaunchKernelEx(&cfg, lstmx_bwd_kernel<SMEM_UT>, xs, ys, h0, cs,
                            c0, dys, mask, W, b, U, UT, dhT, dcT, dz, dh0,
                            dc0, T, B, ND, D, H, UPC, RB, RB4, GPD, ZKS, KS2,
                            C);
}

// xs [T, ND*B, D]; ys, cs, dys [T, ND*B, H] (the forward's ys and cs);
// h0, c0, dhT, dcT, dh0, dc0 [ND*B, H]; mask [T, ND*B] or null; W [ND, D,
// 4H]; b [ND, 4H]; U [ND, H, 4H]; UT [ND, 4H, H] (U transposed); dz [T,
// ND*B, 4H]. Plan arguments as in lstmx_fwd_launch, ZKS being the forward's
// KS (the pieces of h @ U), KS2 the split of the dz @ U^T sum.
extern "C" int lstmx_bwd_launch(const void* xs, const void* ys,
                                const void* h0, const void* cs,
                                const void* c0, const void* dys,
                                const void* mask, const void* W, const void* b,
                                const void* U, const void* UT, const void* dhT,
                                const void* dcT, void* dz, void* dh0,
                                void* dc0, int T, int B, int ND, int D, int H,
                                int CS, int UPC, int RB, int RB4, int GPD,
                                int ZKS, int KS2, int C, int smem_ut,
                                void* stream) {
  if (T < 1 || B < 1 || ND < 1 || ND > 2 || D < 1 || H < 1 || CS < 1 ||
      CS > MAX_CLUSTER || UPC < 1 || (CS - 1) * UPC >= H || CS * UPC < H ||
      RB < 1 || RB4 < RB || RB4 % 4 != 0 || GPD < 1 || GPD * RB < B ||
      (GPD - 1) * RB >= B || ZKS < 1 || KS2 < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * bwd_smem_floats(H, D, UPC, RB4, KS2, C, smem_ut != 0);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (smem_ut)
    e = launch<true>((const float*)xs, (const float*)ys, (const float*)h0,
                     (const float*)cs, (const float*)c0, (const float*)dys,
                     (const float*)mask, (const float*)W, (const float*)b,
                     (const float*)U, (const float*)UT, (const float*)dhT,
                     (const float*)dcT, (float*)dz, (float*)dh0, (float*)dc0,
                     T, B, ND, D, H, CS, UPC, RB, RB4, GPD, ZKS, KS2, C, smem,
                     (cudaStream_t)stream);
  else
    e = launch<false>((const float*)xs, (const float*)ys, (const float*)h0,
                      (const float*)cs, (const float*)c0, (const float*)dys,
                      (const float*)mask, (const float*)W, (const float*)b,
                      (const float*)U, (const float*)UT, (const float*)dhT,
                      (const float*)dcT, (float*)dz, (float*)dh0, (float*)dc0,
                      T, B, ND, D, H, CS, UPC, RB, RB4, GPD, ZKS, KS2, C,
                      smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
