// Forward recurrence of the "residentx" LSTM kernels, one or two directions,
// for Hopper (sm_90a), in two forms: float32, and bfloat16 (below).
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_fwdx_kernel (one
// direction, ND = 1) and ops/pallas_bilstm.py::_bi_fwdx_kernel (both
// directions of a bi-LSTM layer in one launch, ND = 2). Per direction d:
//   zx  = xs @ W_d + b_d                 (lstmx_proj_kernel)
//   z_t = zx_t + h_{t-1} @ U_d           (lstmx_fwd_kernel; gates i, f, g, o)
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
// with the optional mask blend m * new + (1 - m) * old. It writes ys, hT, cT
// and, for training, the cell states cs [T, ND*B, H], the only residual the
// backward (lstmx_bwd.cu) needs: z is rebuilt there, never stored, so both
// sum in the order set out in lstmx_common.cuh.
//
// What bounds it on the card: at config 2 (B=32 per direction, T=400,
// D=H=256, two directions) a call does 2*T*2B*(D+H)*4H = 26.8 GFLOP of
// products and moves about 83 MB: 0.40 ms by operations. Half of the
// operations, the projection, depend on xs alone; the other half sit on a
// chain of T dependent steps. The design (PERF.md section 6):
//   - lstmx_proj_kernel computes zx on the SMs the chain leaves free, on a
//     side stream beside it: one block per chunk of C steps, row group and
//     32 units (their four gate columns, 128 of 4H), earliest chunk first, a
//     register-tiled product of the chunk's inputs and W_d. It writes a
//     scratch stream laid out for the chain's loads and counts each finished
//     tile of a chunk and row group in `ready`. It never waits on the chain,
//     so it cannot deadlock; when the chain would leave it fewer than
//     REBUILD_MIN_SMS SMs (ops/cuda_lstmx.py) it runs first, on the chain's
//     stream.
//   - lstmx_fwd_kernel runs the steps. A cluster of CS blocks owns RB <= 8
//     rows of one direction; block k owns units [k*UPC, (k+1)*UPC) and their
//     NC = 4*UPC gate columns of U_d. A thread sums one piece of h @ U (the
//     KS pieces of lstmx_common.cuh) of one column for four rows, or with 8
//     rows of a pair of columns for one row quad; the piece's terms of its
//     first column sit in its registers (U_REGS, up to 128 terms), the
//     second column's in shared memory. Wider pieces read the block's slice
//     of U from shared memory, or through L2. Every warp works on one piece
//     and row quad, so each float4 of h it reads from shared memory is one
//     address; the h buffers carry zero rows past H so no read is guarded.
//     A thread per (unit, row) then folds the pieces, adds zx (copied into
//     shared memory a step ahead by cp.async, once its chunk's `ready`
//     count is in), updates the cell and stores ys and cs; the unit's RB4
//     lanes gather its rows by shuffles and send them to every block of the
//     cluster, this one too, by st.async, each store counted in bytes on
//     the receiver's mbarrier for the buffer, which expects all H units. No
//     cluster barrier and no block barrier between a step's cell and the
//     next step's product. A block asks for the whole SM's shared memory,
//     so no projection block shares an SM with the chain.
//   - The waits trap after about two seconds, a backstop
//     (cluster_common.cuh).
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// The bfloat16 form (TS = __nv_bfloat16, JAX's _lstm_fwdx_kernel /
// _bi_fwdx_kernel under bf16 compute) reads xs, W and U as bfloat16 and
// converts them on load (U's slice, and the 8-row chain's second columns,
// sit in shared memory as bfloat16). The projection zx is summed and kept in
// float32 (JAX keeps it as a float32 value in VMEM and never rounds it). The
// h buffers hold h rounded to bfloat16, their only reader being the product;
// each (unit, row) item keeps its float32 h in shared memory (hown) for the
// mask blend and hT. The gates, c, ys and cs stay float32.
//
// Plain C interface for ctypes: lstmx_fwd_launch (float32) and
// lstmx_fwd_bf16_launch (bfloat16) return the CUDA error code
// (0 = success). It allocates nothing (the zx stream and its counts are
// scratch the caller passes) and does not synchronise; it runs on the
// streams it is given.

#include <cooperative_groups.h>

#include "lstmx_common.cuh"

namespace cg = cooperative_groups;

#define PROJ_M 64       // rows of a projection tile: C steps times RB4 rows
#define PROJ_UNITS 32   // units of a projection tile: 128 gate columns
#define PROJ_BK 16      // k of a staged slab of the tile's inputs and W
#define PROJ_LDA 68     // floats a staged k of the inputs (64 and a pad)
#define KREG_MAX 128    // terms of a piece of h @ U a thread keeps (U_REGS)
#define MAX_RB4 8       // rows of a cluster: two float4s of h a term
#define KB_H 8          // loads of h and U a U_REGS thread has in flight
#define UB_PAIRS 64     // column pairs of UB (NC <= 128 under U_REGS)

// where a block's slice of U_d lives: each thread's piece in its registers,
// the block's slice in shared memory, or read through L2
enum { U_REGS = 0, U_SMEM = 1, U_L2 = 2 };

// The zx stream, float4s of one unit's four gates: zx[t][grp][u][r], grp
// the row group (ND * GPD of them), u the H units, r the RB4 rows
__host__ __device__ __forceinline__ size_t zx_index(int t, int grp, int u,
                                                    int r, int NG, int H,
                                                    int RB4) {
  return (((size_t)t * NG + grp) * H + u) * RB4 + r;
}

// Block b of the projection takes units [32*ut, 32*ut + 32) (ut = b % NT)
// of row group (b / NT) % NG and chunk b / (NT * NG): the tile's 64 rows
// are the chunk's C steps times the group's RB4 rows (m = c * RB4 + r, zero
// inputs past the group's rows), its 128 columns the units' four gates (j =
// unit * 4 + gate). Thread (tm, tn) = (tid / 16, tid % 16) sums rows 4tm ..
// 4tm+3 of units tn and 16 + tn: one fmaf chain over k from 0 per output,
// then the bias, as chunk_product does (zero inputs past D add nothing).
// xs and W are TS, converted to float as they are loaded.
template <typename TS>
__global__ void __launch_bounds__(THREADS)
lstmx_proj_kernel(const TS* __restrict__ xs, const TS* __restrict__ W,
                  const float* __restrict__ bias, float4* __restrict__ zx,
                  int* __restrict__ ready, int T, int B, int ND, int D, int H,
                  int RB, int RB4, int GPD, int C) {
  __shared__ __align__(16) float As[2][PROJ_BK][PROJ_LDA];
  __shared__ __align__(16) float Bs[2][PROJ_BK][4 * PROJ_UNITS];
  const int tid = threadIdx.x;
  const int G = 4 * H, BS = ND * B, NG = ND * GPD;
  const int NT = (H + PROJ_UNITS - 1) / PROJ_UNITS;
  const int ut = blockIdx.x % NT;
  const int grp = (blockIdx.x / NT) % NG;
  const int n = blockIdx.x / (NT * NG);
  const int dir = grp / GPD, gi = grp - dir * GPD;
  const int row0 = dir * B + gi * RB, nrows = min(RB, B - gi * RB);
  const int t0 = n * C, clen = min(C, T - t0);
  const int uo = ut * PROJ_UNITS;
  const TS* Wd = W + (size_t)dir * D * G;
  const float* bd = bias + (size_t)dir * G;
  CLK_START

  // staging: input element s of a thread is row m = i / 16 and k = i % 16
  // of the slab (i = tid + s * THREADS: a half-warp reads 16 neighbouring
  // k of a row); weight element s is k = i / 128 and column i % 128, gate
  // (i % 128) / 32 and unit i % 32 (a warp reads 32 neighbouring units)
  const TS* arow[4];
  int acol[4];
  bool aok[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int i = tid + s * THREADS, m = i >> 4;
    const int c = m / RB4, r = m - c * RB4;
    aok[s] = c < clen && r < nrows;
    arow[s] = xs + ((size_t)(t0 + (aok[s] ? c : 0)) * BS + row0 +
                    (aok[s] ? r : 0)) * D;
    acol[s] = i & 15;
  }
  const TS* bcol[8];
  bool bok[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int i = tid + s * THREADS, jj = i & 127;
    const int u = uo + (jj & 31);
    bok[s] = u < H;
    bcol[s] = Wd + (jj >> 5) * H + (bok[s] ? u : 0);
  }
  float ra[4], rw[8];
  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = k0 + acol[s];
      ra[s] = aok[s] && k < D ? ld_stream(arow[s] + k) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int k = k0 + ((tid + s * THREADS) >> 7);
      rw[s] = bok[s] && k < D ? ld_stream(bcol[s] + (size_t)k * G) : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = tid + s * THREADS;
      As[buf][i & 15][i >> 4] = ra[s];
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int i = tid + s * THREADS, jj = i & 127;
      Bs[buf][i >> 7][(jj & 31) * 4 + (jj >> 5)] = rw[s];
    }
  };

  const int tm = tid >> 4, tn = tid & 15;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int nk = (D + PROJ_BK - 1) / PROJ_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * PROJ_BK);
#pragma unroll
    for (int kk = 0; kk < PROJ_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][kk][4 * tm]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tn]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tn]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
  CLK_MARK_AT(0, 0)

  // the bias last, then the float4 of each (row, unit)
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int u = uo + 16 * h2 + tn;
    if (u >= H) continue;
    const float b0 = __ldg(bd + u), b1 = __ldg(bd + H + u);
    const float b2 = __ldg(bd + 2 * H + u), b3 = __ldg(bd + 3 * H + u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * tm + i, c = m / RB4, r = m - c * RB4;
      if (c < clen)
        zx[zx_index(t0 + c, grp, u, r, NG, H, RB4)] = make_float4(
            acc[i][4 * h2] + b0, acc[i][4 * h2 + 1] + b1,
            acc[i][4 * h2 + 2] + b2, acc[i][4 * h2 + 3] + b3);
    }
  }
  // the tile is out: count it
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicAdd(ready + n * NG + grp, 1);
  CLK_MARK_AT(1, 0)
}

// The chain's shared memory (every float piece a multiple of 4 floats):
//   hbuf [2][H+HPAD][RB4]  h of every unit for the group's rows, transposed
//                          so four rows load as one float4; double-buffered;
//                          HPAD = KREG_MAX zero rows under U_REGS, else 0
//   red  [KS][NCP][RB4+1]  the KS pieces of h @ U of the block's columns
//                          (NCP = NC rounded up to a warp), rounded up to 4
//   zxb  [2][UPC*RB4][4]   the step's zx of the block's (unit, row) items
//   cown [UPC*RB4]         c of those items
//   hown [UPC*RB4]         their float32 h (the bfloat16 form only)
//   mskb [2][RB4]          the step's mask
//   bars 2 mbarriers       one per h buffer (4 floats)
//   Us   [H][NCP]          TS: the block's slice of U_d (U_SMEM only)
//   UB   [KS][KREG_MAX][UB_PAIRS] TS: U_REGS with RB4 = 8, the second
//                          column of each thread's pair, a piece's terms
//                          then zeros
// in bytes, the TS pieces at esize bytes an element
static size_t chain_smem_bytes(int H, int UPC, int RB4, int KS, int umode,
                               size_t esize) {
  const size_t NCP = (4 * (size_t)UPC + 31) / 32 * 32;
  size_t n = 2 * (size_t)(H + (umode == U_REGS ? KREG_MAX : 0)) * RB4;
  n += (KS * NCP * (RB4 + 1) + 3) / 4 * 4;
  n += 9 * (size_t)UPC * RB4 + 2 * (size_t)RB4 + 4;
  if (esize != sizeof(float)) n += (size_t)UPC * RB4;
  size_t w = 0;
  if (umode == U_SMEM) w = (size_t)H * NCP;
  if (umode == U_REGS && RB4 == 8) w = (size_t)KS * KREG_MAX * UB_PAIRS;
  return sizeof(float) * n + esize * w;
}

// cp.async of step t's zx for the block's items, and of its mask, into
// buffer b (each thread copies the items it updates)
__device__ __forceinline__ void copy_step(float* zxb, float* mskb,
                                          const float4* __restrict__ zx,
                                          const float* __restrict__ mask,
                                          int t, int b, int grp, int NG,
                                          int H, int RB4, int UPC, int u0,
                                          int nu, int BS, int row0,
                                          int nrows) {
  const int items = UPC * RB4;
  for (int i = threadIdx.x; i < items; i += THREADS) {
    const int u = i / RB4, r = i - u * RB4;
    if (u < nu)
      cp_async16(zxb + ((size_t)b * items + i) * 4,
                 zx + zx_index(t, grp, u0 + u, r, NG, H, RB4));
  }
  if (mask != nullptr && threadIdx.x < nrows)
    cp_async4(mskb + b * RB4 + threadIdx.x,
              mask + (size_t)t * BS + row0 + threadIdx.x);
}

template <typename TS, int UMODE, int KR, int RQ>
__global__ void __launch_bounds__(THREADS, 1)
lstmx_fwd_kernel(const float4* __restrict__ zx, const int* __restrict__ ready,
                 const TS* __restrict__ U, const float* __restrict__ h0,
                 const float* __restrict__ c0, const float* __restrict__ mask,
                 float* __restrict__ ys, float* __restrict__ hT,
                 float* __restrict__ cT, float* __restrict__ cs_out, int T,
                 int B, int ND, int H, int UPC, int RB, int GPD, int KS,
                 int C) {
  constexpr int RB4 = 4 * RQ;
  constexpr int RS = RB4 + 1;  // a column's rows in red: no bank conflict
  constexpr bool F32 = sizeof(TS) == sizeof(float);
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int G = 4 * H, NC = 4 * UPC, NCP = (NC + 31) / 32 * 32;
  const int BS = ND * B, NG = ND * GPD, grp = blockIdx.x / CS;
  const int NT = (H + PROJ_UNITS - 1) / PROJ_UNITS;
  const int items = UPC * RB4;
  const Geo geo = block_geo(CS, rank, B, H, UPC, RB, GPD);
  const int u0 = geo.u0, nu = geo.nu, row0 = geo.row0, nrows = geo.nrows;
  const TS* Ud = U + (size_t)geo.dir * H * G;
  // floats of an h buffer: a U_REGS thread reads up to KREG_MAX terms past
  // its piece's start unguarded (zero rows past H)
  const int HS = (H + (UMODE == U_REGS ? KREG_MAX : 0)) * RB4;

  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);
  float* red = hbuf + 2 * HS;
  float* zxb = red + (KS * NCP * RS + 3) / 4 * 4;
  float* cown = zxb + 8 * items;
  float* hown = cown + items;  // the bfloat16 form
  float* mskb = hown + (F32 ? 0 : items);
  uint64_t* bars = reinterpret_cast<uint64_t*>(mskb + 2 * RB4);
  TS* Us = reinterpret_cast<TS*>(mskb + 2 * RB4 + 4);  // U_SMEM
  TS* UB = Us;  // U_REGS with two row quads

  for (int i = tid; i < 2 * HS; i += THREADS) {
    const int d = i / RB4, r = i - d * RB4;
    hbuf[i] = d < H && r < nrows
                  ? round_to<TS>(h0[(size_t)(row0 + r) * H + d])
                  : 0.0f;
  }
  for (int i = tid; i < items; i += THREADS) {
    const int u = i / RB4, r = i - u * RB4;
    const bool ok = r < nrows && u < nu;
    const size_t o = (size_t)(row0 + r) * H + u0 + u;
    cown[i] = ok ? c0[o] : 0.0f;
    if (!F32) hown[i] = ok ? h0[o] : 0.0f;
  }
  // rows past the group's stay frozen (mask 0) at their zero carries
  if (tid < 2 * RB4) mskb[tid] = mask != nullptr ? 0.0f : 1.0f;
  if (UMODE == U_SMEM) {
    for (int i = tid; i < H * NCP; i += THREADS) {
      const int d = i / NCP, lc = i - d * NCP;
      const int g = lc / UPC, u = lc - g * UPC;
      Us[i] = (lc < NC && u < nu) ? Ud[(size_t)d * G + g * H + u0 + u]
                                  : from_f32<TS>(0.0f);
    }
  }
  if (tid == 0) {  // one arrival a phase: the expected bytes
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }

  // U_REGS: this thread's share of h @ U, one piece p of RQ columns for
  // the four rows of row quad q. Its first column's terms sit in its
  // registers; with two row quads (RB4 = 8) the second column's come from
  // shared memory (UB), so each float4 of h feeds eight FMAs
  const int Kc = (H + KS - 1) / KS;
  // column groups, a warp's multiple; with two row quads a fixed UB_PAIRS
  // pairs, so every offset into UB is a constant
  const int NQ = RQ == 2 ? UB_PAIRS : (NC + 31) / 32 * 32;
  const int per = THREADS / RQ;             // threads a row quad
  const int q = tid / per, p = (tid - q * per) / NQ;
  const int j = tid - q * per - p * NQ;
  const bool live = p < KS && RQ * j < NC;
  const int d0 = live ? p * Kc : 0;
  const int kn = live ? min(H, d0 + Kc) - d0 : 0;
  float ureg[UMODE == U_REGS ? KR : 1];
  if (UMODE == U_REGS) {
    const int lc = RQ * j, g = lc / UPC, u = lc - g * UPC;
    const bool ok = live && u < nu;
#pragma unroll
    for (int k = 0; k < KR; ++k)
      ureg[k] = ok && k < kn ? to_f32(Ud[(size_t)(d0 + k) * G + g * H + u0 + u])
                             : 0.0f;
    if (RQ == 2) {
      for (int i = tid; i < KS * KREG_MAX * NQ; i += THREADS) {
        const int jj = i % NQ, k = (i / NQ) % KREG_MAX, pp = i / (NQ * KREG_MAX);
        const int lb = 2 * jj + 1, gb = lb / UPC, ub = lb - gb * UPC;
        const int d = pp * Kc + k;
        UB[i] = lb < NC && ub < nu && k < Kc && d < H
                    ? Ud[(size_t)d * G + gb * H + u0 + ub]
                    : from_f32<TS>(0.0f);
      }
    }
  }

  // step 0's zx once its chunk is out
  if (tid == 0) wait_count(ready + grp, NT);
  // every block of the cluster runs (and has its buffers and mbarriers set)
  // before any block writes into another's shared memory
  cluster.sync();
  copy_step(zxb, mskb, zx, mask, 0, 0, grp, NG, H, RB4, UPC, u0, nu, BS,
            row0, nrows);
  CLK_START

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nb = cur ^ 1;
    const float* hcur = hbuf + cur * HS;
    float* hnxt = hbuf + nb * HS;

    // the pieces of h @ U, every term's weight feeding all the rows
    if (UMODE == U_REGS) {
      if (live) {
        float acc[RQ][4];
#pragma unroll
        for (int e = 0; e < RQ; ++e)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[e][r] = 0.0f;
        const float* hp = hcur + d0 * RB4 + 4 * q;
        const TS* ub = UB + p * KREG_MAX * NQ + j;
        // KBH terms' loads, then their products: loads hoisted further
        // ahead spilled the registers U needs
        constexpr int KBH = KB_H / RQ;
#pragma unroll
        for (int k0 = 0; k0 < KR; k0 += KBH) {
          float4 hv[KBH];
          float wb[KBH];
#pragma unroll
          for (int kk = 0; kk < KBH; ++kk) {
            // past the piece the weights are 0 and h finite (another
            // piece's or the zero rows past H): no change, and no guard
            hv[kk] = *reinterpret_cast<const float4*>(hp + (k0 + kk) * RB4);
            if (RQ == 2) wb[kk] = to_f32(ub[(k0 + kk) * NQ]);
          }
#pragma unroll
          for (int kk = 0; kk < KBH; ++kk) {
#pragma unroll
            for (int e = 0; e < RQ; ++e) {
              const float w = e == 0 ? ureg[k0 + kk] : wb[kk];
              acc[e][0] = fmaf(hv[kk].x, w, acc[e][0]);
              acc[e][1] = fmaf(hv[kk].y, w, acc[e][1]);
              acc[e][2] = fmaf(hv[kk].z, w, acc[e][2]);
              acc[e][3] = fmaf(hv[kk].w, w, acc[e][3]);
            }
          }
          asm volatile("" ::: "memory");
        }
#pragma unroll
        for (int e = 0; e < RQ; ++e) {
          float* dst = red + (p * NCP + RQ * j + e) * RS + 4 * q;
#pragma unroll
          for (int r = 0; r < 4; ++r) dst[r] = acc[e][r];
        }
      }
    } else {
      for (int w = tid; w < KS * NCP; w += THREADS) {
        const int wpc = w / NCP, wl = w - wpc * NCP;
        const int g = wl / UPC, u = wl - g * UPC;
        if (wl >= NC || u >= nu) continue;
        const int e0 = wpc * Kc, e1 = min(H, e0 + Kc);
        const TS* wp = UMODE == U_SMEM ? Us + wl : Ud + g * H + u0 + u;
        const size_t ldw = UMODE == U_SMEM ? (size_t)NCP : (size_t)G;
        float acc[RB4];
#pragma unroll
        for (int r = 0; r < RB4; ++r) acc[r] = 0.0f;
        for (int d = e0; d < e1; ++d) {
          const float wv =
              UMODE == U_SMEM ? to_f32(wp[d * ldw]) : ld_stream(wp + d * ldw);
          const float4* hk = reinterpret_cast<const float4*>(hcur + d * RB4);
#pragma unroll
          for (int q = 0; q < RQ; ++q) {
            const float4 hv = hk[q];
            acc[4 * q] = fmaf(hv.x, wv, acc[4 * q]);
            acc[4 * q + 1] = fmaf(hv.y, wv, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(hv.z, wv, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(hv.w, wv, acc[4 * q + 3]);
          }
        }
        float* dst = red + (wpc * NCP + wl) * RS;
#pragma unroll
        for (int r = 0; r < RB4; ++r) dst[r] = acc[r];
      }
    }
    cp_async_wait_all();  // this thread's copies of the step's zx and mask
    __syncthreads();
    CLK_MARK(2)

    // item (unit u, row r): fold the pieces, add zx, update the cell, store
    // ys and cs; the unit's RB4 lanes then hold its new h for all rows, and
    // lane r sends them to blocks r, r + RB4, ... (this block too) with
    // st.async, counted on the receiver's mbarrier for the buffer (every
    // lane runs the shuffles)
    for (int i0 = 0; i0 < items; i0 += THREADS) {
      const int i = i0 + tid;
      const int u = i / RB4, r = i - u * RB4;
      const bool act = i < items && u < nu;
      float h_new = 0.0f;
      if (act) {
        float hu[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float* rp = red + (g * UPC + u) * RS + r;
          float s = rp[0];
          if (KS > 1) s = s + rp[NCP * RS];
          for (int k = 2; k < KS; ++k) s = s + rp[k * NCP * RS];
          hu[g] = s;
        }
        const float4 zv =
            reinterpret_cast<const float4*>(zxb)[cur * items + i];
        const float ig = sigmoid_f(zv.x + hu[0]);
        const float fg = sigmoid_f(zv.y + hu[1]);
        const float gg = tanhf(zv.z + hu[2]);
        const float og = sigmoid_f(zv.w + hu[3]);
        const float c_old = cown[i];
        float c_new = fg * c_old + ig * gg;
        h_new = og * tanhf(c_new);
        if (mask != nullptr) {
          const float m = mskb[cur * RB4 + r];
          const float h_old = F32 ? hcur[(u0 + u) * RB4 + r] : hown[i];
          c_new = m * c_new + (1.0f - m) * c_old;
          h_new = m * h_new + (1.0f - m) * h_old;
        }
        cown[i] = c_new;
        if (!F32) hown[i] = h_new;
        if (r < nrows) {
          const size_t ob = ((size_t)t * BS + row0 + r) * H + u0 + u;
          ys[ob] = h_new;
          if (cs_out != nullptr) cs_out[ob] = c_new;
        }
      }
      // what the next product reads: h rounded to TS
      const float h_out = round_to<TS>(h_new);
      float hv[RB4];
#pragma unroll
      for (int q = 0; q < RB4; ++q)
        hv[q] = __shfl_sync(0xffffffffu, h_out, q, RB4);
      if (act) {
        for (int k = r; k < CS; k += RB4) {
#pragma unroll
          for (int q = 0; q < RQ; ++q)
            st_async_v4(hnxt + (u0 + u) * RB4 + 4 * q,
                        make_float4(hv[4 * q], hv[4 * q + 1], hv[4 * q + 2],
                                    hv[4 * q + 3]),
                        &bars[nb], k);
        }
      }
    }
    // this block's mbarrier for the buffer expects every block's slice
    if (tid == 0) bulk_expect(&bars[nb], (uint32_t)(H * RB4 * sizeof(float)));
    CLK_MARK(3)
    // the next step's zx and mask while the slices arrive (its chunk out
    // first), then wait for them
    if (t + 1 < T && (t + 1) % C == 0) {
      if (tid == 0) wait_count(ready + ((t + 1) / C) * NG + grp, NT);
      __syncthreads();
    }
    if (t + 1 < T)
      copy_step(zxb, mskb, zx, mask, t + 1, nb, grp, NG, H, RB4, UPC, u0, nu,
                BS, row0, nrows);
    mbar_wait_bounded(&bars[nb], (t >> 1) & 1);
    CLK_MARK(4)
  }

  const float* hfin = hbuf + (T & 1) * HS;
  for (int i = tid; i < items; i += THREADS) {
    const int u = i / RB4, r = i - u * RB4;
    if (u < nu && r < nrows) {
      const size_t ob = (size_t)(row0 + r) * H + u0 + u;
      hT[ob] = F32 ? hfin[(u0 + u) * RB4 + r] : hown[i];
      cT[ob] = cown[i];
    }
  }
  // no block leaves while another may still write into its shared memory
  cluster.sync();
}

// The chain's arguments past its template choice
struct ChainArgs {
  const float4* zx;
  const int* ready;
  const float *h0, *c0, *mask;
  float *ys, *hT, *cT, *cs;
  int T, B, ND, H, CS, UPC, RB, GPD, KS, C;
};

template <typename TS, int UMODE, int KR, int RQ>
static cudaError_t launch_chain(const TS* U, const ChainArgs& a,
                                cudaStream_t stream) {
  // the whole SM's shared memory: no other block (a projection block) runs
  // beside a chain block
  cudaError_t e = cudaFuncSetAttribute(
      lstmx_fwd_kernel<TS, UMODE, KR, RQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.CS * a.GPD * a.ND, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = MAX_SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, lstmx_fwd_kernel<TS, UMODE, KR, RQ>, a.zx,
                            a.ready, U, a.h0, a.c0, a.mask, a.ys, a.hT, a.cT,
                            a.cs, a.T, a.B, a.ND, a.H, a.UPC, a.RB, a.GPD,
                            a.KS, a.C);
}

template <typename TS, int UMODE, int KR>
static cudaError_t launch_rows(int RQ, const TS* U, const ChainArgs& a,
                               cudaStream_t stream) {
  if (RQ == 1) return launch_chain<TS, UMODE, KR, 1>(U, a, stream);
  return launch_chain<TS, UMODE, KR, 2>(U, a, stream);
}

// xs [T, ND*B, D]; W [ND, D, 4H]; b [ND, 4H]; U [ND, H, 4H]; h0, c0, hT, cT
// [ND*B, H]; mask [T, ND*B] or null; ys and cs [T, ND*B, H], cs may be null;
// zx scratch of T * ND * GPD * H * RB4 float4s (16-byte aligned); ready
// ceil(T / C) * ND * GPD ints, zero. xs, W and U are TS (float, or
// __nv_bfloat16 in lstmx_fwd_bf16_launch), the rest float. Plan arguments
// (ops/cuda_lstmx.py::plan): CS blocks per cluster, UPC hidden units per
// block, RB rows per cluster (RB4 = RB rounded up to 4, 4 or 8), GPD row
// groups per direction, KS pieces of the h @ U sum, C steps per projection
// chunk (C * RB4 = 64), umode where U's slice lives (0 the threads'
// registers: ceil(H / KS) <= 128, and with RB4 = 8 NC <= 128; 1 shared
// memory; 2 read through L2). The projection runs on proj_stream and the
// chain on stream: two streams let the chain start on the chunks already
// projected (the caller orders both after the inputs and the rest after
// both, and passes one stream when the chain's blocks would leave the
// projection too few SMs).
template <typename TS>
static int launch_form(const void* xs, const void* W, const void* b,
                       const void* U, const void* h0, const void* c0,
                       const void* mask, void* ys, void* hT, void* cT,
                       void* cs, void* zx, void* ready, int T, int B, int ND,
                       int D, int H, int CS, int UPC, int RB, int RB4,
                       int GPD, int KS, int C, int umode, void* proj_stream,
                       void* stream) {
  if (T < 1 || B < 1 || ND < 1 || ND > 2 || D < 1 || H < 1 || CS < 1 ||
      CS > MAX_CLUSTER || UPC < 1 || (CS - 1) * UPC >= H || CS * UPC < H ||
      RB < 1 || RB4 < RB || (RB4 != 4 && RB4 != MAX_RB4) || GPD < 1 ||
      GPD * RB < B || (GPD - 1) * RB >= B || KS < 1 ||
      (KS - 1) * ((H + KS - 1) / KS) >= H ||
      C < 1 || C * RB4 != PROJ_M || umode < U_REGS || umode > U_L2 ||
      (umode == U_REGS &&
       ((H + KS - 1) / KS > KREG_MAX ||
        KS * (RB4 == 8 ? UB_PAIRS : (4 * UPC + 31) / 32 * 32) >
            THREADS / (RB4 / 4) ||
        (RB4 == 8 && 4 * UPC > 2 * UB_PAIRS))))
    return (int)cudaErrorInvalidValue;
  if (chain_smem_bytes(H, UPC, RB4, KS, umode, sizeof(TS)) > MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  const int NG = ND * GPD;
  const int NT = (H + PROJ_UNITS - 1) / PROJ_UNITS;
  const int nchunks = (T + C - 1) / C;
  lstmx_proj_kernel<TS><<<nchunks * NG * NT, THREADS, 0,
                          (cudaStream_t)proj_stream>>>(
      (const TS*)xs, (const TS*)W, (const float*)b, (float4*)zx, (int*)ready,
      T, B, ND, D, H, RB, RB4, GPD, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const ChainArgs a = {(const float4*)zx, (const int*)ready, (const float*)h0,
                       (const float*)c0, (const float*)mask, (float*)ys,
                       (float*)hT, (float*)cT, (float*)cs, T, B, ND, H, CS,
                       UPC, RB, GPD, KS, C};
  const TS* u = (const TS*)U;
  const cudaStream_t st = (cudaStream_t)stream;
  const int RQ = RB4 / 4;
  if (umode == U_REGS && (H + KS - 1) / KS <= 64)
    e = launch_rows<TS, U_REGS, 64>(RQ, u, a, st);
  else if (umode == U_REGS)
    e = launch_rows<TS, U_REGS, KREG_MAX>(RQ, u, a, st);
  else if (umode == U_SMEM)
    e = launch_rows<TS, U_SMEM, 1>(RQ, u, a, st);
  else
    e = launch_rows<TS, U_L2, 1>(RQ, u, a, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int lstmx_fwd_launch(const void* xs, const void* W, const void* b,
                                const void* U, const void* h0, const void* c0,
                                const void* mask, void* ys, void* hT, void* cT,
                                void* cs, void* zx, void* ready, int T, int B,
                                int ND, int D, int H, int CS, int UPC, int RB,
                                int RB4, int GPD, int KS, int C, int umode,
                                void* proj_stream, void* stream) {
  return launch_form<float>(xs, W, b, U, h0, c0, mask, ys, hT, cT, cs, zx,
                            ready, T, B, ND, D, H, CS, UPC, RB, RB4, GPD, KS,
                            C, umode, proj_stream, stream);
}

extern "C" int lstmx_fwd_bf16_launch(const void* xs, const void* W,
                                     const void* b, const void* U,
                                     const void* h0, const void* c0,
                                     const void* mask, void* ys, void* hT,
                                     void* cT, void* cs, void* zx,
                                     void* ready, int T, int B, int ND, int D,
                                     int H, int CS, int UPC, int RB, int RB4,
                                     int GPD, int KS, int C, int umode,
                                     void* proj_stream, void* stream) {
  return launch_form<__nv_bfloat16>(xs, W, b, U, h0, c0, mask, ys, hT, cT, cs,
                                    zx, ready, T, B, ND, D, H, CS, UPC, RB,
                                    RB4, GPD, KS, C, umode, proj_stream,
                                    stream);
}

// How many clusters of CS blocks of the chain kernel, each block asking for
// smem bytes of shared memory, the card keeps resident at once
// (cudaOccupancyMaxActiveClusters), into *out. ops/cuda_lstmx.py::plan fits
// a kernel's row groups into that many clusters when it can. Returns the CUDA
// error code.
extern "C" int lstmx_fwd_max_clusters(int CS, int smem, int* out) {
  if (CS < 1 || CS > MAX_CLUSTER || smem < 0 || smem > MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      lstmx_fwd_kernel<float, U_SMEM, 1, 1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  return (int)cudaOccupancyMaxActiveClusters(
      out, lstmx_fwd_kernel<float, U_SMEM, 1, 1>, &cfg);
}
