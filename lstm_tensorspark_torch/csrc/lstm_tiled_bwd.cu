// Fused backward (BPTT) of one wide LSTM layer's recurrence (U too big for
// one block's shared memory), for Hopper (sm_90a), float32.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_bwd_tiled_kernel
// (the "tiled" branch of _pallas_backward). The TPU kernel streams U^T from
// HBM in [ttile, H] row tiles every step. Here, as in lstm_tiled_fwd.cu, one
// persistent block per SM owns UPB hidden units and keeps U's four gate
// columns for them, [H][4*UPB], in shared memory for the whole call; U is
// read from HBM once. Walking time in reverse from the forward's residuals
// (z [T, B, 4H], cs [T, B, H], c0), per step t every block:
//   - completes dh for its own units: the sum over blocks of the partial
//     products the blocks wrote at the step before (plus the mask's skip
//     term (1 - m) * dh_tot), or dhT at the first step;
//   - runs the gate algebra of its units: i, f, o = sigmoid(z), g = tanh(z),
//     tanh(c_t) recomputed from z_t and c_{t-1}; dh_tot = dh + dys_t;
//     dc_new = dc + dh_tot * o * (1 - tanh(c_t)^2);
//     dz_t = [dc_new*g*i*(1-i), dc_new*c_{t-1}*f*(1-f), dc_new*i*(1-g^2),
//             dh_tot*tanh(c_t)*o*(1-o)]; dc = dc_new * f; under the mask
//     (m = 0 at a frozen step) the gates see m * dh_tot and m * dc while
//     (1 - m) of both bypass them into the previous step. It streams its dz
//     columns out (dxproj is dz; dU = h_prev^T dz is one matmul outside);
//   - writes its partial product dz_t[:, own columns] @ U[:, own columns]^T
//     for all H units into a double-buffered global scratch [blocks][B][H]
//     (it stays in L2);
//   - waits at one grid-wide barrier (cooperative launch, grid.sync()).
// A block needs only its own units' dh, so one barrier a step is enough,
// and it reads B * UPB partial sums of each block, not all of dz_t.
//
// What bounds it on the card: the same as the forward (17.2 GFLOP of
// products at config 5's shard, 0.256 ms at the f32 peak: by operations),
// behind the same chain of T dependent steps and barriers; the partial
// sums cross L2 twice a step (written and read, B*H*4 bytes a block each).
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// Plain C interface for ctypes: lstm_tiled_bwd_launch returns the CUDA error
// code (0 = success). It allocates nothing (the caller passes the scratch)
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

// Row stride of the U slice (lstm_tiled_fwd.cu's): with a stride of 4 mod 8
// floats, eight threads reading float4s of rows d..d+7 hit distinct banks
static __host__ __device__ int w_stride(int NC) {
  return NC % 8 == 0 ? NC + 4 : NC;
}

// Shared-memory layout, in floats (every piece a multiple of 4 floats):
//   Ws    [H][S]        U[:, own gate columns], column lc = g * UPB + u
//   dzs   [NC][B4]      this step's dz of the own columns, transposed
//   dhown [B4][UPB]     dh carry of the block's own units
//   dcown [B4][UPB]     dc carry of the block's own units
//   skip  [B4][UPB]     (1 - m) * dh_tot, the masked bypass into dh
//   red   [P][B][UPB]   the dh sum over blocks, split P ways
static size_t bwd_smem_floats(int H, int UPB, int B, int B4, int P) {
  const size_t NC = 4 * (size_t)UPB;
  return (size_t)H * w_stride((int)NC) + NC * B4 + 3 * (size_t)B4 * UPB +
         (size_t)P * B * UPB;
}

// dhown = skip + the sum over blocks of src[blk][r][u0 + u]
__device__ __forceinline__ void gather_dh(const float* src, float* red,
                                          float* dhown, const float* skip,
                                          int B, int H, int UPB, int u0,
                                          int nu, int P, int NB) {
  const int tid = threadIdx.x;
  const int pairs = B * UPB;
  for (int w = tid; w < pairs * P; w += THREADS) {
    const int pr = w % pairs, p = w / pairs;
    const int r = pr / UPB, u = pr - r * UPB;
    float acc = 0.0f;
    if (u < nu) {
      const float* sp = src + (size_t)r * H + u0 + u;
#pragma unroll 8
      for (int blk = p; blk < NB; blk += P)
        acc += __ldcg(sp + (size_t)blk * B * H);
    }
    red[w] = acc;
  }
  __syncthreads();
  for (int i = tid; i < pairs; i += THREADS) {
    float acc = red[i];
    for (int p = 1; p < P; ++p) acc += red[p * pairs + i];
    dhown[i] = acc + skip[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_tiled_bwd_kernel(const float* __restrict__ z,
                      const float* __restrict__ dys,
                      const float* __restrict__ cs,
                      const float* __restrict__ c0,
                      const float* __restrict__ mask,
                      const float* __restrict__ U,
                      const float* __restrict__ dhT,
                      const float* __restrict__ dcT, float* __restrict__ dz,
                      float* __restrict__ dh0, float* __restrict__ dc0,
                      float* part, int T, int B, int H, int UPB, int P) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int NB = (int)gridDim.x;
  const int G = 4 * H, NC = 4 * UPB, S = w_stride(NC);
  const int B4 = (B + 3) & ~3;
  const int u0 = blockIdx.x * UPB;
  const int nu = min(UPB, H - u0);

  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);
  float* dzs = Ws + (size_t)H * S;
  float* dhown = dzs + NC * B4;
  float* dcown = dhown + B4 * UPB;
  float* skip = dcown + B4 * UPB;
  float* red = skip + B4 * UPB;

  for (int i = tid; i < H * NC; i += THREADS) {
    const int d = i / NC, lc = i - d * NC;
    const int g = lc / UPB, u = lc - g * UPB;
    Ws[(size_t)d * S + lc] = u < nu ? U[(size_t)d * G + g * H + u0 + u] : 0.0f;
  }
  // padded rows and the columns past nu stay 0 for the whole call
  for (int i = tid; i < NC * B4; i += THREADS) dzs[i] = 0.0f;
  for (int i = tid; i < B4 * UPB; i += THREADS) {
    const int r = i / UPB, u = i - r * UPB;
    const bool own = r < B && u < nu;
    const size_t g = (size_t)r * H + u0 + u;
    dhown[i] = own ? dhT[g] : 0.0f;
    dcown[i] = own ? dcT[g] : 0.0f;
    skip[i] = 0.0f;
  }
  __syncthreads();

  const size_t part_step = (size_t)NB * B * H;
  const int items = H * (B4 / 4);
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    if (s > 0)
      gather_dh(part + (size_t)((s - 1) & 1) * part_step, red, dhown, skip, B,
                H, UPB, u0, nu, P, NB);

    // gate algebra of the block's own units
    for (int i = tid; i < B * UPB; i += THREADS) {
      const int r = i / UPB, u = i - r * UPB;
      if (u >= nu) continue;
      const size_t zb = ((size_t)t * B + r) * G + u0 + u;
      const size_t hb = ((size_t)t * B + r) * H + u0 + u;
      const float ig = sigmoid_f(z[zb]);
      const float fg = sigmoid_f(z[zb + H]);
      const float gg = tanhf(z[zb + 2 * H]);
      const float og = sigmoid_f(z[zb + 3 * H]);
      const float cp =
          t > 0 ? cs[hb - (size_t)B * H] : c0[(size_t)r * H + u0 + u];
      const float tc = tanhf(fg * cp + ig * gg);
      const float dh_tot = dhown[i] + dys[hb];
      const float dc_in = dcown[i];
      float m = 1.0f, dh_eff = dh_tot, dc_eff = dc_in;
      if (mask != nullptr) {
        m = mask[(size_t)t * B + r];
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
      dzs[(0 * UPB + u) * B4 + r] = d_i;
      dzs[(1 * UPB + u) * B4 + r] = d_f;
      dzs[(2 * UPB + u) * B4 + r] = d_g;
      dzs[(3 * UPB + u) * B4 + r] = d_o;
      float dc_next = dc_new * fg;
      if (mask != nullptr) {
        dc_next = dc_next + (1.0f - m) * dc_in;
        skip[i] = (1.0f - m) * dh_tot;
      }
      dcown[i] = dc_next;
    }
    __syncthreads();

    // partial dh for every unit d: sum over own columns of
    // dz[r][lc] * U[d][lc], four rows per thread
    float* pout = part + (size_t)(s & 1) * part_step +
                  (size_t)blockIdx.x * B * H;
    for (int w = tid; w < items; w += THREADS) {
      const int d = w % H, rg = w / H;
      const float* wp = Ws + (size_t)d * S;
      const float* dp = dzs + rg * 4;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int lc = 0; lc < NC; lc += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wp + lc);
        const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 dv =
              *reinterpret_cast<const float4*>(dp + (lc + q) * B4);
          a0 = fmaf(dv.x, wq[q], a0);
          a1 = fmaf(dv.y, wq[q], a1);
          a2 = fmaf(dv.z, wq[q], a2);
          a3 = fmaf(dv.w, wq[q], a3);
        }
      }
      const int r = rg * 4;
      float* po = pout + (size_t)r * H + d;
      po[0] = a0;
      if (r + 1 < B) po[H] = a1;
      if (r + 2 < B) po[2 * H] = a2;
      if (r + 3 < B) po[3 * H] = a3;
    }
    // publishes this step's partial sums to every block
    grid.sync();
  }

  gather_dh(part + (size_t)((T - 1) & 1) * part_step, red, dhown, skip, B, H,
            UPB, u0, nu, P, NB);
  for (int i = tid; i < B * UPB; i += THREADS) {
    const int r = i / UPB, u = i - r * UPB;
    if (u >= nu) continue;
    const size_t ob = (size_t)r * H + u0 + u;
    dh0[ob] = dhown[i];
    dc0[ob] = dcown[i];
  }
}

// Plan arguments (ops/cuda_lstm_tiled.py::plan): UPB hidden units per block
// (the grid is ceil(H / UPB) blocks, one per SM), P splits of the dh sum
// over blocks. U is [H, 4H] as the forward takes it. part is a scratch of
// 2 * blocks * B * H floats. mask may be null.
extern "C" int lstm_tiled_bwd_launch(const void* z, const void* dys,
                                     const void* cs, const void* c0,
                                     const void* mask, const void* U,
                                     const void* dhT, const void* dcT,
                                     void* dz, void* dh0, void* dc0,
                                     void* part, int T, int B, int H, int UPB,
                                     int P, void* stream) {
  if (T < 1 || B < 1 || H < 1 || UPB < 1 || UPB > H || P < 1)
    return (int)cudaErrorInvalidValue;
  const int B4 = (B + 3) & ~3;
  const size_t smem = sizeof(float) * bwd_smem_floats(H, UPB, B, B4, P);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)lstm_tiled_bwd_kernel;
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
           &per_sm, lstm_tiled_bwd_kernel, THREADS, smem)) != cudaSuccess)
    return (int)e;
  // every block waits at the grid barrier: all of them must be resident
  if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* a_z = (const float*)z;
  const float* a_dys = (const float*)dys;
  const float* a_cs = (const float*)cs;
  const float* a_c0 = (const float*)c0;
  const float* a_mask = (const float*)mask;
  const float* a_U = (const float*)U;
  const float* a_dhT = (const float*)dhT;
  const float* a_dcT = (const float*)dcT;
  float* a_dz = (float*)dz;
  float* a_dh0 = (float*)dh0;
  float* a_dc0 = (float*)dc0;
  float* a_part = (float*)part;
  void* args[] = {&a_z,   &a_dys, &a_cs,  &a_c0,  &a_mask, &a_U,
                  &a_dhT, &a_dcT, &a_dz,  &a_dh0, &a_dc0,  &a_part,
                  &T,     &B,     &H,     &UPB,   &P};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
