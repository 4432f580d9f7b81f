// Fused backward (BPTT) of one LSTM layer's recurrence, for Hopper (sm_90a),
// float32.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_bwd_kernel (the
// "resident" branch of _pallas_backward). It walks time in reverse from the
// residuals the forward saved (z [T, B, 4H], cs [T, B, H], c0), and per step
// and row:
//   recomputes i, f, o = sigmoid(z), g = tanh(z) and tanh(c_t) from z_t and
//     c_{t-1} (c_t = f * c_{t-1} + i * g, as the forward computed it);
//   dh_tot = dh + dys_t; dc_new = dc + dh_tot * o * (1 - tanh(c_t)^2);
//   dz_t = [dc_new*g*i*(1-i), dc_new*c_{t-1}*f*(1-f), dc_new*i*(1-g^2),
//           dh_tot*tanh(c_t)*o*(1-o)]      (gate order i, f, g, o)
//   dh = dz_t @ U^T, dc = dc_new * f,
// and under the mask (m = 0 at a frozen step) the gates see m * dh_tot and
// m * dc while (1 - m) of both bypass them into the previous step. It streams
// dz out (dxproj is dz itself; dU = h_prev^T dz is one matmul outside) and
// returns dh0, dc0.
//
// What bounds it on the card: the same as the forward (about 21 MB and 0.54
// GFLOP at config 1, about 8 us by operations), behind the same chain of T
// dependent steps. The design mirrors lstm_fwd.cu:
//   - a cluster of CS blocks owns a group of RB rows and loops over T;
//   - block k owns hidden units [k*UPC, (k+1)*UPC): it computes their four dz
//     columns and dc locally, and keeps its UPC rows of U (as columns of U^T,
//     [4H][UPC], 64 KiB at H=128) in shared memory, or reads them through L2
//     when they do not fit;
//   - dh for a unit needs all 4H columns of dz, so each block writes its dz
//     values into every block's dz buffer through distributed shared memory,
//     and one cluster barrier per step publishes them (double-buffered).
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// Plain C interface for ctypes: lstm_bwd_launch returns the CUDA error code
// (0 = success). It allocates nothing and does not synchronise; it runs on the
// stream it is given.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define THREADS 256
#define MAX_CLUSTER 8
#define MAX_SMEM_BYTES 232448  // 227 KB: the most a block may opt in to

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared-memory layout, in floats (every piece a multiple of 4 floats):
//   dzbuf [2][4H][RB4]  dz of every gate column for the cluster's rows,
//                       transposed so four rows load as one float4
//   dhown [RB4][UPC]    dh carry of the block's own units
//   dcown [RB4][UPC]    dc carry of the block's own units
//   skip  [RB4][UPC]    (1 - m) * dh_tot, the masked bypass into dh
//   red   [KS][RB4][UPC] partial sums when the 4H-sum is split (KS > 1)
//   Ws    [4H][UPC]     the block's columns of U^T (when they fit)
static size_t bwd_smem_floats(int H, int UPC, int RB4, int KS, bool smem_w) {
  const size_t G = 4 * (size_t)H;
  size_t n = 2 * G * RB4 + 3 * (size_t)RB4 * UPC;
  if (KS > 1) n += (size_t)KS * RB4 * UPC;
  if (smem_w) n += G * UPC;
  return n;
}

template <bool SMEM_W>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const float* __restrict__ z, const float* __restrict__ dys,
                const float* __restrict__ cs, const float* __restrict__ c0,
                const float* __restrict__ mask, const float* __restrict__ UT,
                const float* __restrict__ dhT, const float* __restrict__ dcT,
                float* __restrict__ dz, float* __restrict__ dh0,
                float* __restrict__ dc0, int T, int B, int H, int UPC, int RB,
                int RB4, int KS) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int G = 4 * H;
  const int u0 = rank * UPC;
  const int nu = max(0, min(UPC, H - u0));
  const int row0 = group * RB;
  const int nrows = min(RB, B - row0);

  extern __shared__ float4 smem4[];
  float* dzbuf = reinterpret_cast<float*>(smem4);
  float* dhown = dzbuf + 2 * G * RB4;
  float* dcown = dhown + RB4 * UPC;
  float* skip = dcown + RB4 * UPC;
  float* red = skip + RB4 * UPC;
  float* Ws = red + (KS > 1 ? KS * RB4 * UPC : 0);

  for (int i = tid; i < 2 * G * RB4; i += THREADS) dzbuf[i] = 0.0f;
  for (int i = tid; i < RB4 * UPC; i += THREADS) {
    const int r = i / UPC, u = i - r * UPC;
    const bool own = r < nrows && u < nu;
    const size_t g = (size_t)(row0 + r) * H + u0 + u;
    dhown[i] = own ? dhT[g] : 0.0f;
    dcown[i] = own ? dcT[g] : 0.0f;
    skip[i] = 0.0f;
  }
  if (SMEM_W) {
    for (int i = tid; i < G * UPC; i += THREADS) {
      const int j = i / UPC, u = i - j * UPC;
      Ws[i] = u < nu ? UT[(size_t)j * H + u0 + u] : 0.0f;
    }
  }
  // every block of the cluster runs (and has its buffers set) before any
  // block writes into another's shared memory
  cluster.sync();

  const int items = UPC * (RB4 / 4);
  const int Kc = (G + KS - 1) / KS;
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const int cur = (s & 1) * G * RB4;

    // gate algebra of the block's own units; dz goes to every block
    for (int i = tid; i < nrows * nu; i += THREADS) {
      const int r = i / nu, u = i - r * nu;
      const int row = row0 + r;
      const size_t zb = ((size_t)t * B + row) * G + u0 + u;
      const size_t hb = ((size_t)t * B + row) * H + u0 + u;
      const float ig = sigmoid_f(z[zb]);
      const float fg = sigmoid_f(z[zb + H]);
      const float gg = tanhf(z[zb + 2 * H]);
      const float og = sigmoid_f(z[zb + 3 * H]);
      const float cp = t > 0 ? cs[hb - (size_t)B * H]
                             : c0[(size_t)row * H + u0 + u];
      const float tc = tanhf(fg * cp + ig * gg);
      const int o = r * UPC + u;
      const float dh_tot = dhown[o] + dys[hb];
      const float dc_in = dcown[o];
      float m = 1.0f, dh_eff = dh_tot, dc_eff = dc_in;
      if (mask != nullptr) {
        m = mask[(size_t)t * B + row];
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
      for (int k = 0; k < CS; ++k) {
        float* rb = cluster.map_shared_rank(dzbuf, k) + cur;
        rb[(u0 + u) * RB4 + r] = d_i;
        rb[(H + u0 + u) * RB4 + r] = d_f;
        rb[(2 * H + u0 + u) * RB4 + r] = d_g;
        rb[(3 * H + u0 + u) * RB4 + r] = d_o;
      }
    }
    // publishes this step's dz to every block
    cluster.sync();

    // dh[r][u] = sum_j dz[r][j] * U[u0 + u][j], four rows per thread
    const float* dzc = dzbuf + cur;
    for (int w = tid; w < items * KS; w += THREADS) {
      const int base = w % items, ks = w / items;
      const int u = base % UPC, rg = base / UPC;
      if (u >= nu) continue;
      const int j0 = ks * Kc, j1 = min(G, j0 + Kc);
      const float* wp = SMEM_W ? Ws + u : UT + u0 + u;
      const size_t ldw = SMEM_W ? (size_t)UPC : (size_t)H;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int j = j0; j < j1; ++j) {
        const float wv = wp[(size_t)j * ldw];
        const float4 dv = *reinterpret_cast<const float4*>(dzc + j * RB4 + rg * 4);
        a0 = fmaf(dv.x, wv, a0);
        a1 = fmaf(dv.y, wv, a1);
        a2 = fmaf(dv.z, wv, a2);
        a3 = fmaf(dv.w, wv, a3);
      }
      if (KS > 1) {
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
    if (KS > 1) {
      __syncthreads();
      for (int i = tid; i < RB4 * UPC; i += THREADS) {
        float acc = red[i];
        for (int ks = 1; ks < KS; ++ks) acc += red[ks * RB4 * UPC + i];
        dhown[i] = acc + skip[i];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nrows * nu; i += THREADS) {
    const int r = i / nu, u = i - r * nu;
    const size_t ob = (size_t)(row0 + r) * H + u0 + u;
    dh0[ob] = dhown[r * UPC + u];
    dc0[ob] = dcown[r * UPC + u];
  }
}

template <bool SMEM_W>
static cudaError_t launch(const float* z, const float* dys, const float* cs,
                          const float* c0, const float* mask, const float* UT,
                          const float* dhT, const float* dcT, float* dz,
                          float* dh0, float* dc0, int T, int B, int H, int CS,
                          int UPC, int RB, int RB4, int KS, size_t smem,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_kernel<SMEM_W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int groups = (B + RB - 1) / RB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS * groups, 1, 1);
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
  return cudaLaunchKernelEx(&cfg, lstm_bwd_kernel<SMEM_W>, z, dys, cs, c0,
                            mask, UT, dhT, dcT, dz, dh0, dc0, T, B, H, UPC, RB,
                            RB4, KS);
}

// UT is U transposed, [4H, H] contiguous. Plan arguments as in
// lstm_fwd_launch (ops/cuda_lstm.py::plan). mask may be null.
extern "C" int lstm_bwd_launch(const void* z, const void* dys, const void* cs,
                               const void* c0, const void* mask,
                               const void* UT, const void* dhT,
                               const void* dcT, void* dz, void* dh0,
                               void* dc0, int T, int B, int H, int CS,
                               int UPC, int RB, int RB4, int KS, int smem_w,
                               void* stream) {
  if (T < 1 || B < 1 || H < 1 || CS < 1 || CS > MAX_CLUSTER || UPC < 1 ||
      (CS - 1) * UPC >= H || CS * UPC < H || RB < 1 || RB4 < RB ||
      RB4 % 4 != 0 || KS < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * bwd_smem_floats(H, UPC, RB4, KS, smem_w != 0);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (smem_w)
    e = launch<true>((const float*)z, (const float*)dys, (const float*)cs,
                     (const float*)c0, (const float*)mask, (const float*)UT,
                     (const float*)dhT, (const float*)dcT, (float*)dz,
                     (float*)dh0, (float*)dc0, T, B, H, CS, UPC, RB, RB4, KS,
                     smem, (cudaStream_t)stream);
  else
    e = launch<false>((const float*)z, (const float*)dys, (const float*)cs,
                      (const float*)c0, (const float*)mask, (const float*)UT,
                      (const float*)dhT, (const float*)dcT, (float*)dz,
                      (float*)dh0, (float*)dc0, T, B, H, CS, UPC, RB, RB4, KS,
                      smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
