// Forward recurrence of one LSTM layer over T steps, for Hopper (sm_90a),
// float32.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_kernel (the
// "resident" branch of _pallas_forward). The input projection
// xproj = x @ W + b is one matmul outside; per step and row this kernel does
//   z_t = xproj_t + h_{t-1} @ U          (gate order i, f, g, o)
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
// with the optional mask blend m * new + (1 - m) * old, and streams out ys,
// hT, cT and, when asked, the residuals z [T, B, 4H] and cs [T, B, H] that
// lstm_bwd.cu consumes.
//
// What bounds it on the card: at config 1 (B=64, T=64, H=128) the whole call
// moves about 21 MB and does 0.54 GFLOP of products, so the roofline says
// about 8 us, by operations. It does not see the real floor: T dependent
// steps, each a small [B, H] x [H, 4H] product followed by a barrier. The
// design keeps everything a step needs on chip:
//   - Rows are independent, so a cluster of CS blocks owns a group of RB rows
//     and loops over T inside; no two clusters ever talk.
//   - U (256 KiB at H=128) does not fit one block, so the cluster splits it
//     by hidden unit: block k owns units [k*UPC, (k+1)*UPC) and keeps their
//     four gate columns of U in shared memory (64 KiB at H=128), so its cell
//     update is local. When the slice does not fit (H=650, 1024) the block
//     reads it through L2 every step instead.
//   - After its cell update a block writes its new h values into every
//     block's h buffer through distributed shared memory; one cluster barrier
//     per step publishes them. h is double-buffered, so a step's writes never
//     race the reads of the step before.
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// Plain C interface for ctypes: lstm_fwd_launch returns the CUDA error code
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

// Shared-memory layout, in floats (every piece a multiple of 4 floats, so
// each starts 16-byte aligned):
//   hbuf [2][H][RB4]   h of every unit for the cluster's rows, transposed so
//                      four rows load as one float4; double-buffered
//   zacc [RB4][NC]     h @ U for the block's NC = 4 * UPC gate columns
//   cown [RB4][UPC]    c of the block's own units
//   red  [KS][RB4][NC] partial products when the H-sum is split (KS > 1)
//   Ws   [H][NC]       the block's slice of U (when it fits)
static size_t fwd_smem_floats(int H, int UPC, int RB4, int KS, bool smem_w) {
  const size_t NC = 4 * (size_t)UPC;
  size_t n = 2 * (size_t)H * RB4 + (size_t)RB4 * NC + (size_t)RB4 * UPC;
  if (KS > 1) n += (size_t)KS * RB4 * NC;
  if (smem_w) n += (size_t)H * NC;
  return n;
}

template <bool SMEM_W>
__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(const float* __restrict__ xproj, const float* __restrict__ U,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const float* __restrict__ mask, float* __restrict__ ys,
                float* __restrict__ hT, float* __restrict__ cT,
                float* __restrict__ z_out, float* __restrict__ cs_out, int T,
                int B, int H, int UPC, int RB, int RB4, int KS) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int G = 4 * H;
  const int NC = 4 * UPC;
  const int u0 = rank * UPC;
  const int nu = max(0, min(UPC, H - u0));
  const int row0 = group * RB;
  const int nrows = min(RB, B - row0);

  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);
  float* zacc = hbuf + 2 * H * RB4;
  float* cown = zacc + RB4 * NC;
  float* red = cown + RB4 * UPC;
  float* Ws = red + (KS > 1 ? KS * RB4 * NC : 0);

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
  if (SMEM_W) {
    for (int i = tid; i < H * NC; i += THREADS) {
      const int d = i / NC, lc = i - d * NC;
      const int g = lc / UPC, u = lc - g * UPC;
      Ws[i] = u < nu ? U[(size_t)d * G + g * H + u0 + u] : 0.0f;
    }
  }
  // every block of the cluster runs (and has its buffers set) before any
  // block writes into another's shared memory
  cluster.sync();

  const int items = NC * (RB4 / 4);
  const int Kc = (H + KS - 1) / KS;
  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * H * RB4;
    const int nxt = ((t + 1) & 1) * H * RB4;

    // zacc[r][lc] = sum_d h[r][d] * U[d][gate column of lc], four rows per
    // thread so every weight read feeds four products
    for (int w = tid; w < items * KS; w += THREADS) {
      const int base = w % items, ks = w / items;
      const int lc = base % NC, rg = base / NC;
      const int g = lc / UPC, u = lc - g * UPC;
      if (u >= nu) continue;
      const int d0 = ks * Kc, d1 = min(H, d0 + Kc);
      const float* wp = SMEM_W ? Ws + lc : U + g * H + u0 + u;
      const size_t ldw = SMEM_W ? (size_t)NC : (size_t)G;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int d = d0; d < d1; ++d) {
        const float wv = wp[(size_t)d * ldw];
        const float4 hv = *reinterpret_cast<const float4*>(hcur + d * RB4 + rg * 4);
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
        for (int ks = 1; ks < KS; ++ks) s += red[ks * RB4 * NC + i];
        zacc[i] = s;
      }
      __syncthreads();
    }

    // cell update of the block's own units; the new h goes to every block
    for (int i = tid; i < nrows * nu; i += THREADS) {
      const int r = i / nu, u = i - r * nu;
      const int row = row0 + r;
      const size_t xb = ((size_t)t * B + row) * G + u0 + u;
      const float* za = zacc + r * NC + u;
      const float zi = xproj[xb] + za[0];
      const float zf = xproj[xb + H] + za[UPC];
      const float zg = xproj[xb + 2 * H] + za[2 * UPC];
      const float zo = xproj[xb + 3 * H] + za[3 * UPC];
      if (z_out != nullptr) {
        z_out[xb] = zi;
        z_out[xb + H] = zf;
        z_out[xb + 2 * H] = zg;
        z_out[xb + 3 * H] = zo;
      }
      const float ig = sigmoid_f(zi);
      const float fg = sigmoid_f(zf);
      const float gg = tanhf(zg);
      const float og = sigmoid_f(zo);
      const float c_old = cown[r * UPC + u];
      float c_new = fg * c_old + ig * gg;
      float h_new = og * tanhf(c_new);
      if (mask != nullptr) {
        const float m = mask[(size_t)t * B + row];
        const float h_old = hcur[(u0 + u) * RB4 + r];
        c_new = m * c_new + (1.0f - m) * c_old;
        h_new = m * h_new + (1.0f - m) * h_old;
      }
      cown[r * UPC + u] = c_new;
      const size_t ob = ((size_t)t * B + row) * H + u0 + u;
      ys[ob] = h_new;
      if (cs_out != nullptr) cs_out[ob] = c_new;
      for (int k = 0; k < CS; ++k) {
        float* hr = cluster.map_shared_rank(hbuf, k);
        hr[nxt + (u0 + u) * RB4 + r] = h_new;
      }
    }
    // publishes this step's h to every block (and orders the local writes)
    cluster.sync();
  }

  const float* hfin = hbuf + (T & 1) * H * RB4;
  for (int i = tid; i < nrows * nu; i += THREADS) {
    const int r = i / nu, u = i - r * nu;
    const size_t ob = (size_t)(row0 + r) * H + u0 + u;
    hT[ob] = hfin[(u0 + u) * RB4 + r];
    cT[ob] = cown[r * UPC + u];
  }
}

template <bool SMEM_W>
static cudaError_t launch(const float* xproj, const float* U, const float* h0,
                          const float* c0, const float* mask, float* ys,
                          float* hT, float* cT, float* z, float* cs, int T,
                          int B, int H, int CS, int UPC, int RB, int RB4,
                          int KS, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_fwd_kernel<SMEM_W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  return cudaLaunchKernelEx(&cfg, lstm_fwd_kernel<SMEM_W>, xproj, U, h0, c0,
                            mask, ys, hT, cT, z, cs, T, B, H, UPC, RB, RB4,
                            KS);
}

// Plan arguments (chosen by the Python wrapper, ops/cuda_lstm.py::plan):
// CS blocks per cluster, UPC hidden units per block, RB rows per cluster
// (RB4 = RB rounded up to 4), KS splits of the H-sum, smem_w = keep the U
// slice in shared memory. mask, z and cs may be null.
extern "C" int lstm_fwd_launch(const void* xproj, const void* U,
                               const void* h0, const void* c0,
                               const void* mask, void* ys, void* hT, void* cT,
                               void* z, void* cs, int T, int B, int H, int CS,
                               int UPC, int RB, int RB4, int KS, int smem_w,
                               void* stream) {
  if (T < 1 || B < 1 || H < 1 || CS < 1 || CS > MAX_CLUSTER || UPC < 1 ||
      (CS - 1) * UPC >= H || CS * UPC < H || RB < 1 || RB4 < RB ||
      RB4 % 4 != 0 || KS < 1 || ((z == nullptr) != (cs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * fwd_smem_floats(H, UPC, RB4, KS, smem_w != 0);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (smem_w)
    e = launch<true>((const float*)xproj, (const float*)U, (const float*)h0,
                     (const float*)c0, (const float*)mask, (float*)ys,
                     (float*)hT, (float*)cT, (float*)z, (float*)cs, T, B, H,
                     CS, UPC, RB, RB4, KS, smem, (cudaStream_t)stream);
  else
    e = launch<false>((const float*)xproj, (const float*)U, (const float*)h0,
                      (const float*)c0, (const float*)mask, (float*)ys,
                      (float*)hT, (float*)cT, (float*)z, (float*)cs, T, B, H,
                      CS, UPC, RB, RB4, KS, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
