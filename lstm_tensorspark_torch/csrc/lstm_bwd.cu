// Fused backward (BPTT) of one LSTM layer's recurrence, for Hopper (sm_90a),
// in two forms: float32, and bfloat16 streams (stream_dtype.cuh).
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
// What bounds it on the card: at config 1 (B=64, T=64, H=128) the call moves
// about 21 MB and does 0.54 GFLOP of products, about 8 us by operations. The
// real floor is the chain of T dependent steps: each a [rows, 4H] x [4H, H]
// product, the gate algebra and the exchange of dz between the blocks that
// own H's units. The design keeps a step to that chain:
//   - Rows are independent, so a cluster of CS blocks owns a group of RB rows
//     and loops over T inside; no two clusters ever talk. Block k owns
//     hidden units [k*UPC, (k+1)*UPC).
//   - A warp owns a quad of four units and a quad of four rows (a slot; a
//     warp takes more than one when the block has more than eight) and sums
//     their 16 values of dz @ U^T over all 4H terms: lane l takes terms
//     l, l + 32, ..., so each float4 of dz (four rows of one term, no bank
//     conflict) feeds 16 FMAs. The 16 sums meet by a reduce-scatter of warp
//     shuffles that leaves lane l with unit (l >> 2) & 3 and row l & 3 (and
//     lane l ^ 16 with the same): no shared-memory fold, no block barrier.
//   - The lane's terms of U^T (16 terms of four units, 64 floats, read from
//     U directly) stay in registers for the whole call when 4H <= 512
//     (UT_REGS); else the block's slice sits in shared memory (UT_SMEM) or
//     is read through L2 (UT_L2, wide H).
//   - The lane then runs the gate algebra of its (unit, row) with dh and dc
//     carried in registers. No transcendental and no load is on the chain:
//     the factors of the algebra (A = o(1-tc^2), Bo = tc o(1-o), Ci =
//     g i(1-i), Cf = c_prev f(1-f), Cg = i(1-g^2), f) are computed while a
//     step's dz is in flight, from z, c_{t-1}, dys and the mask loaded two
//     steps ahead:
//       dc_new = m dc + (m dh_tot) A,
//       dz = (dc_new Ci, dc_new Cf, dc_new Cg, (m dh_tot) Bo),
//       dc' = dc_new f + (1-m) dc,  dh' = dz @ U^T + (1-m) dh_tot
//     (ops/cuda_lstm.py::lstm_backward_factored is this order in plain
//     PyTorch). Lanes l and l ^ 16 hold the same element, so every second
//     step each computes the factors of another step and they swap them.
//   - Two butterfly levels of shuffles turn the quad's four rows of four
//     gates into one float4 of four rows for each gate column, and each
//     goes by st.async into every block's dz buffer (this block's too; the
//     targets mapped once), counted in bytes on the receiver's mbarrier,
//     double-buffered by step: no cluster barrier and no block barrier a
//     step. The wait acquires at CTA scope (the cluster scope costs an L1
//     invalidation a warp a step) and traps after about two seconds as a
//     backstop.
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// The bfloat16 form (TS = __nv_bfloat16: z, U and dz bfloat16, as JAX's
// _lstm_bwd_kernel under bf16 compute) takes the gates from the rounded z,
// rounds each dz element once, before it is sent and stored, so dh is the
// rounded dz times U^T (U converted on load; its slice sits in shared
// memory as bfloat16 in UT_SMEM); the carries stay float32.
//
// Plain C interface for ctypes: lstm_bwd_launch (float32) and
// lstm_bwd_bf16_launch (bfloat16) return the CUDA error code (0 = success).
// They allocate nothing and do not synchronise; they run on the stream they
// are given.

#include <cooperative_groups.h>

#include "cluster_common.cuh"
#include "stream_dtype.cuh"

namespace cg = cooperative_groups;

#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_CLUSTER 8
#define MAX_SMEM_BYTES 232448  // 227 KB: the most a block may opt in to
#define UT_TERMS 16            // terms of each of four units a lane keeps
#define MAX_SLOTS 8            // (unit quad, row quad) slots a warp takes

// where the block's slice of U^T lives: the lanes' registers, shared memory,
// or read through L2
enum { UT_REGS = 0, UT_SMEM = 1, UT_L2 = 2 };

// columns of a dz buffer: 4H rounded up so every lane reads the same number
// of terms (zero columns past 4H)
__host__ __device__ inline int padded_cols(int G, int mode) {
  return mode == UT_REGS ? 32 * UT_TERMS : (G + 127) / 128 * 128;
}

// Shared-memory layout (every piece a multiple of 8 bytes):
//   dzbuf [2][RQ][GP][4]  float: dz of every gate column for the cluster's
//                         rows, a row quad's four rows as one float4; by
//                         step parity
//   UTs   [UQ][GP][4]     TS: the block's columns of U^T, a unit quad's four
//                         units together (UT_SMEM only)
//   bars  2 mbarriers     one per dz buffer
static size_t bwd_smem_bytes(int GP, int RQ, int UQ, int mode, size_t esize) {
  size_t n = sizeof(float) * 2 * (size_t)RQ * GP * 4;
  if (mode == UT_SMEM) n += esize * UQ * GP * 4;
  return n + 16;
}

// One (unit, row) element's inputs of a step: z's four gates, c_{t-1},
// dys_t and the mask (0 for an element the block does not own, so its dz
// stays 0 and its carries keep their zeros), from pointers to the step's
// z, c_{t-1} and dys of the element and its mask
struct Raw {
  float z[4], cp, dy, m;
};

template <typename TS>
__device__ __forceinline__ void load_raw(Raw& R, const TS* zp,
                                         const float* cpp, const float* dyp,
                                         const float* mp, int H, bool ok) {
  if (ok) {
#pragma unroll
    for (int g = 0; g < 4; ++g) R.z[g] = ld_stream(zp + g * H);
    R.cp = __ldg(cpp);
    R.dy = __ldg(dyp);
    R.m = mp != nullptr ? __ldg(mp) : 1.0f;
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g) R.z[g] = 0.0f;
    R.cp = R.dy = R.m = 0.0f;
  }
}

// The algebra's factors of one element: A, Bo, Ci, Cf, Cg, f, dys, mask
struct Fac {
  float A, Bo, Ci, Cf, Cg, F, dy, m;
};

__device__ __forceinline__ void factors(Fac& f, const Raw& R) {
  const float ig = sigmoid_f(R.z[0]);
  const float fg = sigmoid_f(R.z[1]);
  const float gg = tanhf(R.z[2]);
  const float og = sigmoid_f(R.z[3]);
  const float tc = tanhf(fg * R.cp + ig * gg);
  f.A = og * (1.0f - tc * tc);
  f.Bo = tc * og * (1.0f - og);
  f.Ci = gg * ig * (1.0f - ig);
  f.Cf = R.cp * fg * (1.0f - fg);
  f.Cg = ig * (1.0f - gg * gg);
  f.F = fg;
  f.dy = R.dy;
  f.m = R.m;
}

// The 16 sums acc[unit][row] of a warp's lanes, reduce-scattered: lane l
// ends with unit (l >> 2) & 3, row l & 3 (the xor-1 and xor-2 levels halve
// the rows, xor-4 and xor-8 the units, xor-16 adds the two halves)
__device__ __forceinline__ float fold16(const float (&acc)[4][4], int lane) {
  const int b0 = lane & 1, b1 = (lane >> 1) & 1;
  const int b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1;
  float k1[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float keep = b0 ? acc[u][2 * i + 1] : acc[u][2 * i];
      const float send = b0 ? acc[u][2 * i] : acc[u][2 * i + 1];
      k1[u][i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
  }
  float k2[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float keep = b1 ? k1[u][1] : k1[u][0];
    const float send = b1 ? k1[u][0] : k1[u][1];
    k2[u] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  float k3[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b2 ? k2[2 * i + 1] : k2[2 * i];
    const float send = b2 ? k2[2 * i] : k2[2 * i + 1];
    k3[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  const float keep = b3 ? k3[1] : k3[0];
  const float send = b3 ? k3[0] : k3[1];
  const float k4 = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  return k4 + __shfl_xor_sync(0xffffffffu, k4, 16);
}

template <typename TS, int MODE, int NGM>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const TS* __restrict__ z, const float* __restrict__ dys,
                const float* __restrict__ cs, const float* __restrict__ c0,
                const float* __restrict__ mask, const TS* __restrict__ U,
                const float* __restrict__ dhT, const float* __restrict__ dcT,
                TS* __restrict__ dz, float* __restrict__ dh0,
                float* __restrict__ dc0, int T, int B, int H, int UPC, int RB,
                int RB4, int NG) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / CS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = 4 * H;
  const int GP = padded_cols(G, MODE);
  const int u0 = rank * UPC;
  const int nu = max(0, min(UPC, H - u0));
  const int row0 = group * RB;
  const int nrows = min(RB, B - row0);
  const int RQ = RB4 / 4, UQ = (UPC + 3) / 4;
  const int WPU = max(1, WARPS / UQ), NUQ = (UQ + WARPS - 1) / WARPS;

  extern __shared__ float4 smem4[];
  float* dzbuf = reinterpret_cast<float*>(smem4);
  TS* UTs = reinterpret_cast<TS*>(dzbuf + 2 * RQ * GP * 4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      UTs + (MODE == UT_SMEM ? UQ * GP * 4 : 0));

  for (int i = tid; i < 2 * RQ * GP * 4; i += THREADS) dzbuf[i] = 0.0f;
  if (MODE == UT_SMEM) {
    for (int i = tid; i < UQ * GP * 4; i += THREADS) {
      const int k = i & 3, j = (i >> 2) % GP, q = (i >> 2) / GP;
      const int u = 4 * q + k;
      UTs[i] = (u < nu && j < G) ? U[(size_t)(u0 + u) * G + j]
                                 : from_f32<TS>(0.0f);
    }
  }
  if (tid == 0) {  // one arrival a phase: the expected bytes
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }

  // the warp's slots: unit quad uq and row quad rq (warps past UQ * WPU
  // and slots past NG have none)
  const bool wact = warp < UQ * WPU;
  int uqs[NGM], rqs[NGM];
  bool live[NGM];
#pragma unroll
  for (int gi = 0; gi < NGM; ++gi) {
    uqs[gi] = warp % UQ + WARPS * (gi % NUQ);
    rqs[gi] = warp / UQ + (gi / NUQ) * WPU;
    // a slot whose quad holds none of the block's units reads no dz: it
    // would race the next step's sends, which nothing of it waits for
    live[gi] = wact && gi < NG && uqs[gi] < UQ && rqs[gi] < RQ &&
               4 * uqs[gi] < nu;
  }
  // the lane's element after the fold, and its (unit, gate) for the send
  const int ku = (lane >> 2) & 3, kr = lane & 3, half = lane >> 4;

  // UT_REGS: the lane's terms j = lane + 32 i of the four units of its quad
  // (every slot of a warp has the same unit quad when they fit registers)
  float ut[MODE == UT_REGS ? UT_TERMS : 1][4];
  if (MODE == UT_REGS) {
#pragma unroll
    for (int i = 0; i < UT_TERMS; ++i) {
      const int j = lane + 32 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int u = 4 * uqs[0] + k;
        ut[i][k] = (live[0] && u < nu && j < G)
                       ? to_f32(U[(size_t)(u0 + u) * G + j])
                       : 0.0f;
      }
    }
  }

  // per slot: the element's carries, the factors of the step at hand and of
  // the one after the next (pend), and raw inputs. The two half-warps hold
  // the same elements, so every second step each computes the factors of
  // another step (the first half-warp step t - 1's, the second t - 2's,
  // from inputs loaded two steps before) and they swap them by shuffles:
  // half the factor work a step
  float dh[NGM], dc[NGM], skip[NGM];
  Fac fac[NGM], pend[NGM];
  Raw raw[NGM];
  bool eok[NGM];
  int hoff[NGM], zoff[NGM], erow[NGM];
  const size_t BG = (size_t)B * G, BH = (size_t)B * H;
#pragma unroll
  for (int gi = 0; gi < NGM; ++gi) {
    const int u = 4 * uqs[gi] + ku, r = 4 * rqs[gi] + kr;
    eok[gi] = live[gi] && u < nu && r < nrows;
    erow[gi] = row0 + r;
    hoff[gi] = erow[gi] * H + u0 + u;
    zoff[gi] = erow[gi] * G + u0 + u;
    dh[gi] = eok[gi] ? dhT[hoff[gi]] : 0.0f;
    dc[gi] = eok[gi] ? dcT[hoff[gi]] : 0.0f;
    skip[gi] = 0.0f;
  }
  // the inputs of step t0 (first half-warp) or t1 (second), for every slot
  // (the step's offsets into z, the [T, B, H] streams and the mask); none
  // for a step before 0
  auto load_step = [&](int t0, int t1) {
    const int tl = half ? t1 : t0, ts = max(tl, 0);
    const size_t oz = (size_t)ts * BG, oh = (size_t)ts * BH;
#pragma unroll
    for (int gi = 0; gi < NGM; ++gi) {
      if (!live[gi]) continue;
      const float* cpp = ts > 0 ? cs + (oh - BH) + hoff[gi] : c0 + hoff[gi];
      load_raw(raw[gi], z + oz + zoff[gi], cpp, dys + oh + hoff[gi],
               mask != nullptr ? mask + (size_t)ts * B + erow[gi] : nullptr,
               H, eok[gi] && tl >= 0);
    }
  };
  load_step(T - 1, T - 1);
#pragma unroll
  for (int gi = 0; gi < NGM; ++gi)
    if (live[gi]) factors(fac[gi], raw[gi]);
  if (T > 1) load_step(T - 2, T - 3);

  // st.async targets: this lane's blocks half, half + 2, ... (their dz
  // buffers' shared::cluster addresses; a block's mbarriers sit at the same
  // offset in each), and its slots' columns
  uint32_t dst[MAX_CLUSTER / 2];
#pragma unroll
  for (int j = 0; j < MAX_CLUSTER / 2; ++j)
    dst[j] = half + 2 * j < CS ? mapa_addr(smem_addr(dzbuf), half + 2 * j)
                               : 0u;
  const uint32_t bar_off = smem_addr(bars) - smem_addr(dzbuf);
  const uint32_t step_bytes = (uint32_t)(G * RB4 * sizeof(float));
  // every block of the cluster runs (and has its buffers and mbarriers set)
  // before any block writes into another's shared memory
  cluster.sync();
  CLK_START

  // step s (time t); an even step computes factors, an odd one takes the
  // pending ones
  auto step = [&](int s, bool even) {
    const int t = T - 1 - s, b = s & 1;
    // this block's mbarrier for the buffer expects every block's slices
    if (tid == 0) bulk_expect(&bars[b], step_bytes);

    // gate algebra of each slot's element; the quad's four rows of each
    // gate gathered into one lane (lane (k, q) of the warp takes gate q of
    // unit k: a 4 x 4 transpose over lanes in two butterfly levels), sent
    // to every block and stored to dz
#pragma unroll
    for (int gi = 0; gi < NGM; ++gi) {
      if (!live[gi]) continue;
      const Fac& f = fac[gi];
      const float dh_tot = dh[gi] + f.dy;
      const float dh_eff = f.m * dh_tot, dc_in = dc[gi];
      const float dc_new = f.m * dc_in + dh_eff * f.A;
      // dz rounded once, to the precision of its store and of the product
      const float d0 = round_to<TS>(dc_new * f.Ci),
                  d1 = round_to<TS>(dc_new * f.Cf),
                  d2 = round_to<TS>(dc_new * f.Cg),
                  d3 = round_to<TS>(dh_eff * f.Bo);
      dc[gi] = dc_new * f.F + (1.0f - f.m) * dc_in;
      skip[gi] = (1.0f - f.m) * dh_tot;
      const bool b0 = kr & 1, b1 = kr & 2;
      // level xor-2: gates with bit 1 other than the row's go across; the
      // lane then holds gates 2*b1, 2*b1+1 of rows kr and kr ^ 2
      const float a0 = b1 ? d2 : d0, a1 = b1 ? d3 : d1;
      const float r0 = __shfl_xor_sync(0xffffffffu, b1 ? d0 : d2, 2);
      const float r1 = __shfl_xor_sync(0xffffffffu, b1 ? d1 : d3, 2);
      // level xor-1: the gate other than kr goes across; the lane then
      // holds gate kr of rows kr, kr ^ 2 (kept) and kr ^ 1, kr ^ 3
      const float k0 = b0 ? a1 : a0, k2 = b0 ? r1 : r0;
      const float k1 = __shfl_xor_sync(0xffffffffu, b0 ? a0 : a1, 1);
      const float k3 = __shfl_xor_sync(0xffffffffu, b0 ? r0 : r1, 1);
      // row x holds k[x ^ kr]
      const float4 dv = make_float4(
          b1 ? (b0 ? k3 : k2) : (b0 ? k1 : k0),
          b1 ? (b0 ? k2 : k3) : (b0 ? k0 : k1),
          b1 ? (b0 ? k1 : k0) : (b0 ? k3 : k2),
          b1 ? (b0 ? k0 : k1) : (b0 ? k2 : k3));
      const int u = 4 * uqs[gi] + ku;
      if (u < nu) {
        const int col = kr * H + u0 + u;
        const uint32_t off =
            (uint32_t)(((b * RQ + rqs[gi]) * GP + col) * 4 * sizeof(float));
#pragma unroll
        for (int j = 0; j < MAX_CLUSTER / 2; ++j) {
          if (half + 2 * j < CS)
            st_async_v4_at(dst[j] + off, dv, dst[j] + bar_off + 8 * b);
        }
        // rows 0, 1 from the first half-warp, 2, 3 from the second
        const int r = 4 * rqs[gi] + 2 * half;
        TS* dzt = dz + (size_t)t * BG + (size_t)(row0 + r) * G + col;
        if (r < nrows) dzt[0] = from_f32<TS>(half ? dv.z : dv.x);
        if (r + 1 < nrows) dzt[G] = from_f32<TS>(half ? dv.w : dv.y);
      }
    }
    CLK_MARK(0)

    // while the slices arrive: on an even step the factors of steps t - 1
    // and t - 2 (one a half-warp, swapped), then the inputs of t - 3 and
    // t - 4; on an odd step the pending factors
    if (t > 0 && even) {
#pragma unroll
      for (int gi = 0; gi < NGM; ++gi) {
        if (!live[gi]) continue;
        Fac own, got;
        factors(own, raw[gi]);
        got.A = __shfl_xor_sync(0xffffffffu, own.A, 16);
        got.Bo = __shfl_xor_sync(0xffffffffu, own.Bo, 16);
        got.Ci = __shfl_xor_sync(0xffffffffu, own.Ci, 16);
        got.Cf = __shfl_xor_sync(0xffffffffu, own.Cf, 16);
        got.Cg = __shfl_xor_sync(0xffffffffu, own.Cg, 16);
        got.F = __shfl_xor_sync(0xffffffffu, own.F, 16);
        got.dy = __shfl_xor_sync(0xffffffffu, own.dy, 16);
        got.m = __shfl_xor_sync(0xffffffffu, own.m, 16);
        fac[gi] = half ? got : own;
        pend[gi] = half ? own : got;
      }
      if (t > 2) load_step(t - 3, t - 4);
    } else if (t > 0) {
#pragma unroll
      for (int gi = 0; gi < NGM; ++gi) fac[gi] = pend[gi];
    }
    CLK_MARK(1)
    mbar_wait_cta_bounded(&bars[b], (s >> 1) & 1);
    CLK_MARK(2)

    // dh = dz @ U^T + the masked bypass: each lane's terms, then the fold
#pragma unroll
    for (int gi = 0; gi < NGM; ++gi) {
      if (!live[gi]) continue;
      const float* dzc = dzbuf + (b * RQ + rqs[gi]) * GP * 4;
      float acc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[k][r] = 0.0f;
      if (MODE == UT_REGS) {
#pragma unroll
        for (int i = 0; i < UT_TERMS; ++i) {
          const float4 dv =
              *reinterpret_cast<const float4*>(dzc + (lane + 32 * i) * 4);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[k][0] = fmaf(dv.x, ut[i][k], acc[k][0]);
            acc[k][1] = fmaf(dv.y, ut[i][k], acc[k][1]);
            acc[k][2] = fmaf(dv.z, ut[i][k], acc[k][2]);
            acc[k][3] = fmaf(dv.w, ut[i][k], acc[k][3]);
          }
        }
      } else {
        const int uq = uqs[gi];
        // past a block's units and past 4H the indices are clamped: the
        // weight is finite and its dz column 0 (or its sums unused)
        const TS* urow[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          urow[k] = U + (size_t)(u0 + min(4 * uq + k, nu - 1)) * G;
#pragma unroll 4
        for (int j = lane; j < GP; j += 32) {
          const float4 dv = *reinterpret_cast<const float4*>(dzc + j * 4);
          float w[4];
          if (MODE == UT_SMEM) {
            const float4 wv = load4(UTs + ((size_t)uq * GP + j) * 4);
            w[0] = wv.x, w[1] = wv.y, w[2] = wv.z, w[3] = wv.w;
          } else {
            const int jj = min(j, G - 1);
#pragma unroll
            for (int k = 0; k < 4; ++k) w[k] = ld_stream(urow[k] + jj);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[k][0] = fmaf(dv.x, w[k], acc[k][0]);
            acc[k][1] = fmaf(dv.y, w[k], acc[k][1]);
            acc[k][2] = fmaf(dv.z, w[k], acc[k][2]);
            acc[k][3] = fmaf(dv.w, w[k], acc[k][3]);
          }
        }
      }
      dh[gi] = fold16(acc, lane) + skip[gi];
    }
    CLK_MARK(3)
  };
  for (int s = 0; s < T; s += 2) {
    step(s, true);
    if (s + 1 < T) step(s + 1, false);
  }

#pragma unroll
  for (int gi = 0; gi < NGM; ++gi) {
    if (eok[gi] && half == 0) {
      dh0[hoff[gi]] = dh[gi];
      dc0[hoff[gi]] = dc[gi];
    }
  }
  // no block leaves while another may still write into its shared memory
  cluster.sync();
}

template <typename TS, int MODE, int NGM>
static cudaError_t launch(const TS* z, const float* dys, const float* cs,
                          const float* c0, const float* mask, const TS* U,
                          const float* dhT, const float* dcT, TS* dz,
                          float* dh0, float* dc0, int T, int B, int H, int CS,
                          int UPC, int RB, int RB4, int NG, size_t smem,
                          cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      lstm_bwd_kernel<TS, MODE, NGM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
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
  return cudaLaunchKernelEx(&cfg, lstm_bwd_kernel<TS, MODE, NGM>, z, dys, cs,
                            c0, mask, U, dhT, dcT, dz, dh0, dc0, T, B, H, UPC,
                            RB, RB4, NG);
}

template <typename TS, int MODE>
static cudaError_t launch_mode(const TS* z, const float* dys,
                               const float* cs, const float* c0,
                               const float* mask, const TS* U,
                               const float* dhT, const float* dcT, TS* dz,
                               float* dh0, float* dc0, int T, int B, int H,
                               int CS, int UPC, int RB, int RB4, int NG,
                               size_t smem, cudaStream_t stream) {
  if (NG == 1)
    return launch<TS, MODE, 1>(z, dys, cs, c0, mask, U, dhT, dcT, dz, dh0,
                               dc0, T, B, H, CS, UPC, RB, RB4, NG, smem,
                               stream);
  if constexpr (MODE != UT_REGS) {  // U^T in registers takes at most 4
    if (NG > 4)
      return launch<TS, MODE, MAX_SLOTS>(z, dys, cs, c0, mask, U, dhT, dcT,
                                         dz, dh0, dc0, T, B, H, CS, UPC, RB,
                                         RB4, NG, smem, stream);
  }
  return launch<TS, MODE, 4>(z, dys, cs, c0, mask, U, dhT, dcT, dz, dh0, dc0,
                             T, B, H, CS, UPC, RB, RB4, NG, smem, stream);
}

// U is [H, 4H] as the forward takes it. Plan arguments (chosen by the Python
// wrapper, ops/cuda_lstm.py::plan): CS blocks per cluster, UPC hidden units
// per block, RB rows per cluster (RB4 = RB rounded up to 4), NG the slots of
// a warp (ceil(UQ / 8) * ceil((RB4 / 4) / max(1, 8 / UQ)) with UQ =
// ceil(UPC / 4), at most 8, at most 4 with U^T in registers), umode where
// U^T's slice lives (0 registers: 4H <= 512 and UQ <= 8; 1 shared memory; 2
// read through L2). mask may be null. z, U and dz are TS (float, or
// __nv_bfloat16 in lstm_bwd_bf16_launch).
template <typename TS>
static int launch_form(const void* z, const void* dys, const void* cs,
                       const void* c0, const void* mask, const void* U,
                       const void* dhT, const void* dcT, void* dz, void* dh0,
                       void* dc0, int T, int B, int H, int CS, int UPC,
                       int RB, int RB4, int NG, int umode, void* stream) {
  if (T < 1 || B < 1 || H < 1 || CS < 1 || CS > MAX_CLUSTER || UPC < 1 ||
      (CS - 1) * UPC >= H || CS * UPC < H || RB < 1 || RB4 < RB ||
      RB4 % 4 != 0 || umode < UT_REGS || umode > UT_L2)
    return (int)cudaErrorInvalidValue;
  const int G = 4 * H, RQ = RB4 / 4, UQ = (UPC + 3) / 4;
  const int WPU = UQ < WARPS ? WARPS / UQ : 1;
  const int NUQ = (UQ + WARPS - 1) / WARPS;
  if (NUQ > MAX_SLOTS || NG != NUQ * ((RQ + WPU - 1) / WPU) ||
      NG > MAX_SLOTS ||
      (umode == UT_REGS && (NUQ != 1 || G > 32 * UT_TERMS || NG > 4)) ||
      (size_t)G * RB4 * sizeof(float) >= (1u << 20))  // an mbarrier's bytes
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(padded_cols(G, umode), RQ, UQ, umode,
                                     sizeof(TS));
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const TS* zt = (const TS*)z;
  const TS* ut = (const TS*)U;
  const float* in[6] = {(const float*)dys, (const float*)cs,
                        (const float*)c0,  (const float*)mask,
                        (const float*)dhT, (const float*)dcT};
  cudaError_t e;
  if (umode == UT_REGS)
    e = launch_mode<TS, UT_REGS>(zt, in[0], in[1], in[2], in[3], ut, in[4],
                                 in[5], (TS*)dz, (float*)dh0, (float*)dc0, T,
                                 B, H, CS, UPC, RB, RB4, NG, smem,
                                 (cudaStream_t)stream);
  else if (umode == UT_SMEM)
    e = launch_mode<TS, UT_SMEM>(zt, in[0], in[1], in[2], in[3], ut, in[4],
                                 in[5], (TS*)dz, (float*)dh0, (float*)dc0, T,
                                 B, H, CS, UPC, RB, RB4, NG, smem,
                                 (cudaStream_t)stream);
  else
    e = launch_mode<TS, UT_L2>(zt, in[0], in[1], in[2], in[3], ut, in[4],
                               in[5], (TS*)dz, (float*)dh0, (float*)dc0, T,
                               B, H, CS, UPC, RB, RB4, NG, smem,
                               (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int lstm_bwd_launch(const void* z, const void* dys, const void* cs,
                               const void* c0, const void* mask,
                               const void* U, const void* dhT,
                               const void* dcT, void* dz, void* dh0,
                               void* dc0, int T, int B, int H, int CS,
                               int UPC, int RB, int RB4, int NG, int umode,
                               void* stream) {
  return launch_form<float>(z, dys, cs, c0, mask, U, dhT, dcT, dz, dh0, dc0,
                            T, B, H, CS, UPC, RB, RB4, NG, umode, stream);
}

extern "C" int lstm_bwd_bf16_launch(const void* z, const void* dys,
                                    const void* cs, const void* c0,
                                    const void* mask, const void* U,
                                    const void* dhT, const void* dcT,
                                    void* dz, void* dh0, void* dc0, int T,
                                    int B, int H, int CS, int UPC, int RB,
                                    int RB4, int NG, int umode,
                                    void* stream) {
  return launch_form<__nv_bfloat16>(z, dys, cs, c0, mask, U, dhT, dcT, dz,
                                    dh0, dc0, T, B, H, CS, UPC, RB, RB4, NG,
                                    umode, stream);
}
