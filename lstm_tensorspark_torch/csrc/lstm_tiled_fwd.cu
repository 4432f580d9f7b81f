// Forward recurrence of one wide LSTM layer (U too big for one block's
// shared memory) over T steps, for Hopper (sm_90a), float32.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_tiled_kernel (the
// "tiled" branch of _pallas_forward). The TPU kernel streams U from HBM in
// [htile, 4H] row tiles every step because 16 MiB (H=1024, f32) does not fit
// in VMEM. It does not fit one SM here either (227 KB a block), but it fits
// in the card's shared memory taken together (132 x 227 KB), so this kernel
// never re-reads U: one persistent block per SM owns UPB hidden units and
// keeps U's four gate columns for them, [H][4*UPB], in shared memory for the
// whole call (128 KiB at H=1024, UPB=8). Per step t every block:
//   - stages h_{t-1} [B, H] from a double-buffered global array (it stays
//     in L2), in tiles of KT rows of H when B*H does not fit, laid out
//     [H][B4] so four rows load as one float4;
//   - accumulates acc = h_{t-1} @ U[:, own columns] in float32 (the sum over
//     each tile split KS ways over the threads), then for its own units
//     z = xproj_t + acc (gate order i, f, g, o),
//     c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g),
//     h_t = sigmoid(o) * tanh(c_t), with the optional mask blend
//     m * new + (1 - m) * old; c stays in shared memory;
//   - writes ys, and z and cs when asked, for its units, and its slice of
//     h_t into the other buffer;
//   - waits at one grid-wide barrier (cooperative launch, grid.sync()).
//
// What bounds it on the card: at config 5's per-chip shard (B=16, T=128,
// H=1024) the products are 2*T*B*H*4H = 17.2 GFLOP, 0.256 ms at the f32 peak,
// and the bytes (xproj, U, ys, z, cs) about 0.030 ms: by operations. The T
// dependent steps, each one product and one grid barrier, are a latency floor
// the bound does not see; so is the L2 traffic of every block staging all of
// h each step (B*H*4 bytes times the blocks).
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// Plain C interface for ctypes: lstm_tiled_fwd_launch returns the CUDA error
// code (0 = success). It allocates nothing (the caller passes the h scratch)
// and does not synchronise; it runs on the stream it is given.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define THREADS 256
#define MAX_SMEM_BYTES 232448  // 227 KB: the most a block may opt in to

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Row stride of the U slice in shared memory: 4 * UPB rounded to 4 (mod 8),
// so the backward's float4 reads of rows d, d+1, ... hit distinct banks
static __host__ __device__ int w_stride(int NC) {
  return NC % 8 == 0 ? NC + 4 : NC;
}

// Shared-memory layout, in floats (every piece a multiple of 4 floats):
//   Ws   [H][S]         U[:, own gate columns], column lc = g * UPB + u
//   hs   [KT][B4]       one tile of h_{t-1}, transposed
//   red  [KS][B4][NC]   the product's partial sums (KS splits)
//   cown [B4][UPB]      c of the block's own units
//   hown [B4][UPB]      h of the block's own units (the mask blend's old h)
static size_t fwd_smem_floats(int H, int UPB, int B4, int KT, int KS) {
  const size_t NC = 4 * (size_t)UPB;
  return (size_t)H * w_stride((int)NC) + (size_t)KT * B4 +
         (size_t)KS * B4 * NC + 2 * (size_t)B4 * UPB;
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_tiled_fwd_kernel(const float* __restrict__ xproj,
                      const float* __restrict__ U,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const float* __restrict__ mask, float* __restrict__ ys,
                      float* __restrict__ hT, float* __restrict__ cT,
                      float* __restrict__ z_out, float* __restrict__ cs_out,
                      float* hbuf, int T, int B, int H, int UPB, int KT,
                      int KS) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int G = 4 * H, NC = 4 * UPB, S = w_stride(NC);
  const int B4 = (B + 3) & ~3;
  const int u0 = blockIdx.x * UPB;
  const int nu = min(UPB, H - u0);

  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);
  float* hs = Ws + (size_t)H * S;
  float* red = hs + (size_t)KT * B4;
  float* cown = red + (size_t)KS * B4 * NC;
  float* hown = cown + B4 * UPB;

  for (int i = tid; i < H * NC; i += THREADS) {
    const int d = i / NC, lc = i - d * NC;
    const int g = lc / UPB, u = lc - g * UPB;
    Ws[(size_t)d * S + lc] = u < nu ? U[(size_t)d * G + g * H + u0 + u] : 0.0f;
  }
  for (int i = tid; i < B4 * UPB; i += THREADS) {
    const int r = i / UPB, u = i - r * UPB;
    const bool own = r < B && u < nu;
    const float h = own ? h0[(size_t)r * H + u0 + u] : 0.0f;
    hown[i] = h;
    cown[i] = own ? c0[(size_t)r * H + u0 + u] : 0.0f;
    if (u < nu) {  // both buffers: padded rows stay 0
      hbuf[(size_t)(u0 + u) * B4 + r] = h;
      hbuf[(size_t)(H + u0 + u) * B4 + r] = 0.0f;
    }
  }
  // every block's h0 slice is in hbuf before any block reads it
  grid.sync();

  const int items = NC * (B4 / 4);
  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (size_t)(t & 1) * H * B4;
    float* hnxt = hbuf + (size_t)((t + 1) & 1) * H * B4;

    // red[ks][r][lc] = sum over the ks-th piece of each tile of
    // h[r][d] * Ws[d][lc], four rows per thread so each weight read feeds
    // four products
    for (int k0 = 0; k0 < H; k0 += KT) {
      const int kt = min(KT, H - k0);
      __syncthreads();  // the previous tile's readers are done with hs
      const float4* src =
          reinterpret_cast<const float4*>(hcur + (size_t)k0 * B4);
      float4* dst = reinterpret_cast<float4*>(hs);
      for (int i = tid; i < kt * B4 / 4; i += THREADS) dst[i] = __ldcg(src + i);
      __syncthreads();
      const int chunk = (kt + KS - 1) / KS;
      for (int w = tid; w < items * KS; w += THREADS) {
        const int base = w % items, ks = w / items;
        const int lc = base % NC, rg = base / NC;
        if (lc % UPB >= nu) continue;
        const int d0 = ks * chunk, d1 = min(kt, d0 + chunk);
        const float* wp = Ws + (size_t)(k0 + d0) * S + lc;
        const float* hp = hs + d0 * B4 + rg * 4;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
        for (int d = d0; d < d1; ++d) {
          const float wv = *wp;
          const float4 hv = *reinterpret_cast<const float4*>(hp);
          wp += S;
          hp += B4;
          a0 = fmaf(hv.x, wv, a0);
          a1 = fmaf(hv.y, wv, a1);
          a2 = fmaf(hv.z, wv, a2);
          a3 = fmaf(hv.w, wv, a3);
        }
        float* o = red + (size_t)ks * B4 * NC + rg * 4 * NC + lc;
        if (k0 == 0) {
          o[0] = a0;
          o[NC] = a1;
          o[2 * NC] = a2;
          o[3 * NC] = a3;
        } else {
          o[0] += a0;
          o[NC] += a1;
          o[2 * NC] += a2;
          o[3 * NC] += a3;
        }
      }
    }
    __syncthreads();

    // cell update of the block's own units
    for (int i = tid; i < B * UPB; i += THREADS) {
      const int r = i / UPB, u = i - r * UPB;
      if (u >= nu) continue;
      float acc[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* rp = red + r * NC + g * UPB + u;
        float s = rp[0];
        for (int ks = 1; ks < KS; ++ks) s += rp[(size_t)ks * B4 * NC];
        acc[g] = s;
      }
      const size_t xb = ((size_t)t * B + r) * G + u0 + u;
      const float zi = xproj[xb] + acc[0];
      const float zf = xproj[xb + H] + acc[1];
      const float zg = xproj[xb + 2 * H] + acc[2];
      const float zo = xproj[xb + 3 * H] + acc[3];
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
      const int o = r * UPB + u;
      const float c_old = cown[o];
      float c_new = fg * c_old + ig * gg;
      float h_new = og * tanhf(c_new);
      if (mask != nullptr) {
        const float m = mask[(size_t)t * B + r];
        c_new = m * c_new + (1.0f - m) * c_old;
        h_new = m * h_new + (1.0f - m) * hown[o];
      }
      cown[o] = c_new;
      hown[o] = h_new;
      const size_t ob = ((size_t)t * B + r) * H + u0 + u;
      ys[ob] = h_new;
      if (cs_out != nullptr) cs_out[ob] = c_new;
      hnxt[(size_t)(u0 + u) * B4 + r] = h_new;
    }
    // publishes this step's h to every block (and orders shared memory)
    grid.sync();
  }

  for (int i = tid; i < B * UPB; i += THREADS) {
    const int r = i / UPB, u = i - r * UPB;
    if (u >= nu) continue;
    const size_t ob = (size_t)r * H + u0 + u;
    hT[ob] = hown[i];
    cT[ob] = cown[i];
  }
}

// Plan arguments (chosen by the Python wrapper, ops/cuda_lstm_tiled.py::plan):
// UPB hidden units per block (the grid is ceil(H / UPB) blocks, one per SM),
// KT rows of H per staged h tile, KS splits of each tile's sum. hbuf is a
// scratch of 2 * H * B4 floats (B4 = B rounded up to 4). mask, z and cs may
// be null.
extern "C" int lstm_tiled_fwd_launch(const void* xproj, const void* U,
                                     const void* h0, const void* c0,
                                     const void* mask, void* ys, void* hT,
                                     void* cT, void* z, void* cs, void* hbuf,
                                     int T, int B, int H, int UPB, int KT,
                                     int KS, void* stream) {
  if (T < 1 || B < 1 || H < 1 || UPB < 1 || UPB > H || KT < 1 || KT > H ||
      KS < 1 || ((z == nullptr) != (cs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int B4 = (B + 3) & ~3;
  const size_t smem = sizeof(float) * fwd_smem_floats(H, UPB, B4, KT, KS);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)lstm_tiled_fwd_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (H + UPB - 1) / UPB;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lstm_tiled_fwd_kernel, THREADS, smem)) != cudaSuccess)
    return (int)e;
  // every block waits at the grid barrier: all of them must be resident
  if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* a_xproj = (const float*)xproj;
  const float* a_U = (const float*)U;
  const float* a_h0 = (const float*)h0;
  const float* a_c0 = (const float*)c0;
  const float* a_mask = (const float*)mask;
  float* a_ys = (float*)ys;
  float* a_hT = (float*)hT;
  float* a_cT = (float*)cT;
  float* a_z = (float*)z;
  float* a_cs = (float*)cs;
  float* a_hbuf = (float*)hbuf;
  void* args[] = {&a_xproj, &a_U, &a_h0, &a_c0, &a_mask, &a_ys, &a_hT,
                  &a_cT,    &a_z, &a_cs, &a_hbuf, &T,    &B,    &H,
                  &UPB,     &KT,  &KS};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
