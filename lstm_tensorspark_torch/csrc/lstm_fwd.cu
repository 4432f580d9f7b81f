// Forward recurrence of one LSTM layer over T steps, for Hopper (sm_90a),
// in two forms: float32, and bfloat16 streams (stream_dtype.cuh).
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
// steps, each a small [B, H] x [H, 4H] product, the cell update and the
// exchange of h between blocks. The design keeps a step to that chain:
//   - Rows are independent, so a cluster of CS blocks owns a group of RB rows
//     and loops over T inside; no two clusters ever talk. Block k owns
//     hidden units [k*UPC, (k+1)*UPC).
//   - A group of KS neighbouring lanes owns one unit and four rows: all four
//     gate columns of the unit, so the cell update follows the product in
//     the same threads with no shared-memory round trip. Each lane sums a
//     1/KS slice of h @ U and the slices meet by warp shuffles, after which
//     every lane of the group holds the same z and c; the lanes share the
//     stores.
//   - The lane's slice of U (ceil(H/KS) rows of four columns: 64 floats at
//     H=128) stays in registers for the whole call when it fits (U_REGS);
//     else it sits in shared memory (U_SMEM) or is read through L2 (U_L2,
//     wide H).
//   - xproj of the next step (and its mask) is loaded into registers while
//     the current step runs, so no step waits on device memory.
//   - The new h (four rows of a unit, one float4) goes to every block's
//     double-buffered h buffer through distributed shared memory; after one
//     block barrier each block signals the others' mbarrier for that buffer
//     and waits on its own (cluster_common.cuh): no cluster barrier per step.
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// The bfloat16 form (TS = __nv_bfloat16: xproj, U and z bfloat16, as JAX's
// _lstm_kernel under bf16 compute) converts xproj and U on load (U's slice
// sits in shared memory as bfloat16 in U_SMEM), keeps the h buffers holding
// h rounded to bfloat16 (the only reader is the product: the mask blend
// takes each lane's float32 h from its registers), feeds the gates the
// float32 z and stores z rounded once. A third form, lstm_fwd_bf16u_launch
// (TX = float, TS = __nv_bfloat16: xproj float32, U bfloat16, no
// residuals), is the rounding of JAX's plain XLA scan under bf16 compute
// (ops/scan.py there: zx stays float32, x and h are rounded only at the
// products), which JAX's serve prefill runs: the port's prefill takes it so
// that its first tokens argmax as JAX's serve and the port's CPU run do.
//
// Plain C interface for ctypes: lstm_fwd_launch (float32),
// lstm_fwd_bf16_launch (bfloat16) and lstm_fwd_bf16u_launch return the CUDA
// error code (0 = success).
// They allocate nothing and do not synchronise; they run on the stream they
// are given.

#include <cooperative_groups.h>

#include "cluster_common.cuh"
#include "stream_dtype.cuh"

namespace cg = cooperative_groups;

#define THREADS 256
#define MAX_CLUSTER 8
#define MAX_SMEM_BYTES 232448  // 227 KB: the most a block may opt in to
#define KREG 16                // rows of U a lane keeps in registers (U_REGS)

enum { U_REGS = 0, U_SMEM = 1, U_L2 = 2 };

// Shared-memory layout (every piece a multiple of 8 bytes):
//   hbuf [2][H][RB4]   float: h of every unit for the cluster's rows,
//                      transposed so four rows load as one float4;
//                      double-buffered
//   Ws   [UPC][H][4]   TS: the block's slice of U, a unit's four gates
//                      together (U_SMEM only)
//   bars 2 mbarriers   one per h buffer
static size_t fwd_smem_bytes(int H, int UPC, int RB4, int umode,
                             size_t esize) {
  size_t n = sizeof(float) * 2 * (size_t)H * RB4;
  if (umode == U_SMEM) n += esize * H * UPC * 4;
  return n + 16;
}

// xproj of step t for four rows (from row) and one unit (column col of
// each gate), and the rows' mask (1 without one); 0 for rows not owned
template <typename TS>
__device__ __forceinline__ void load_step(float (&xp)[4][4], float (&mk)[4],
                                          const TS* __restrict__ xproj,
                                          const float* __restrict__ mask,
                                          int t, int B, int G, int H, int row,
                                          int col, const bool (&rowok)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t xb = ((size_t)t * B + row + r) * G + col;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xp[g][r] = rowok[r] ? ld_stream(xproj + xb + g * H) : 0.0f;
    mk[r] = (mask != nullptr && rowok[r])
                ? __ldg(mask + (size_t)t * B + row + r)
                : 1.0f;
  }
}

// a[r] for a run-time r, without indexing the register array
__device__ __forceinline__ float pick(const float (&a)[4], int r) {
  return r == 0 ? a[0] : r == 1 ? a[1] : r == 2 ? a[2] : a[3];
}

__device__ __forceinline__ bool pick_ok(const bool (&a)[4], int r) {
  return r == 0 ? a[0] : r == 1 ? a[1] : r == 2 ? a[2] : a[3];
}

// one row's cell: the gates of z, c and h, and the mask blend when masked
__device__ __forceinline__ void cell_update(float zi, float zf, float zg,
                                            float zo, float c_old, float m,
                                            float h_old, bool masked,
                                            float& c_out, float& h_out) {
  const float ig = sigmoid_f(zi);
  const float fg = sigmoid_f(zf);
  const float gg = tanhf(zg);
  const float og = sigmoid_f(zo);
  float c_new = fg * c_old + ig * gg;
  float h_new = og * tanhf(c_new);
  if (masked) {
    c_new = m * c_new + (1.0f - m) * c_old;
    h_new = m * h_new + (1.0f - m) * h_old;
  }
  c_out = c_new;
  h_out = h_new;
}

template <typename TX, typename TS, int UMODE>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const TX* __restrict__ xproj, const TS* __restrict__ U,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const float* __restrict__ mask, float* __restrict__ ys,
                float* __restrict__ hT, float* __restrict__ cT,
                TS* __restrict__ z_out, float* __restrict__ cs_out, int T,
                int B, int H, int UPC, int RB, int RB4, int KS) {
  constexpr bool F32 = sizeof(TS) == sizeof(float);
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
  float* hbuf = reinterpret_cast<float*>(smem4);
  TS* Ws = reinterpret_cast<TS*>(hbuf + 2 * H * RB4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      Ws + (UMODE == U_SMEM ? H * UPC * 4 : 0));

  for (int i = tid; i < H * RB4; i += THREADS) {
    const int d = i / RB4, r = i - d * RB4;
    hbuf[i] = r < nrows ? round_to<TS>(h0[(size_t)(row0 + r) * H + d]) : 0.0f;
    hbuf[H * RB4 + i] = 0.0f;
  }
  if (UMODE == U_SMEM) {
    for (int i = tid; i < H * UPC * 4; i += THREADS) {
      const int g = i & 3, ud = i >> 2;
      const int u = ud / H, d = ud - u * H;
      Ws[i] = u < nu ? U[(size_t)d * G + g * H + u0 + u] : from_f32<TS>(0.0f);
    }
  }
  if (tid == 0 && CS > 1) {
    mbar_init(&bars[0], CS - 1);
    mbar_init(&bars[1], CS - 1);
    mbar_init_fence();
  }

  // this thread's group: unit u, rows rb .. rb+3, lane ks of KS
  const int nitems = UPC * (RB4 / 4);
  const int item = tid / KS, ks = tid - item * KS;
  const bool live = item < nitems;
  const int it = live ? item : 0;
  const int u = it % UPC, rb = 4 * (it / UPC);
  const bool active = live && u < nu;
  // the lane's rows of U: k = ks, ks + KS, ... (neighbouring lanes read
  // neighbouring h rows, so their float4 loads meet no bank conflict)
  const int kn = ks < H ? (H - ks + KS - 1) / KS : 0;

  float ureg[UMODE == U_REGS ? KREG : 1][4];
  if (UMODE == U_REGS) {
#pragma unroll
    for (int kk = 0; kk < KREG; ++kk) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        ureg[kk][g] = (kk < kn && u < nu)
                          ? to_f32(U[(size_t)(ks + kk * KS) * G + g * H + u0 + u])
                          : 0.0f;
    }
  }
  bool rowok[4];
  float c[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rowok[r] = active && rb + r < nrows;
    c[r] = rowok[r] ? c0[(size_t)(row0 + rb + r) * H + u0 + u] : 0.0f;
  }
  float c_own = pick(c, ks & 3);  // the lane's row's c (KS >= 4)
  // xproj (and the mask) of step t, loaded one step ahead
  float xp[4][4], mk[4];
  load_step(xp, mk, xproj, mask, 0, B, G, H, row0 + rb, u0 + u, rowok);
  // every block of the cluster runs (and has its buffers and mbarriers set)
  // before any block writes into another's shared memory
  cluster.sync();
  CLK_START

  // the group's last h (float32); the bfloat16 form's blend reads it here,
  // its h buffers holding the rounded h
  float hl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (!F32) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hl[r] = rowok[r] ? h0[(size_t)(row0 + rb + r) * H + u0 + u] : 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * H * RB4;
    const int nb = (t + 1) & 1;
    float* hnxt = hbuf + nb * H * RB4;

    // this lane's slice of h @ U for the unit's four gates and four rows
    float acc[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[g][r] = 0.0f;
    if (UMODE == U_REGS) {
#pragma unroll
      for (int kk = 0; kk < KREG; ++kk) {
        // past the slice the weights are 0 and h stays finite: no change
        const int k = kk < kn ? ks + kk * KS : 0;
        const float4 hv =
            *reinterpret_cast<const float4*>(hcur + k * RB4 + rb);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g][0] = fmaf(hv.x, ureg[kk][g], acc[g][0]);
          acc[g][1] = fmaf(hv.y, ureg[kk][g], acc[g][1]);
          acc[g][2] = fmaf(hv.z, ureg[kk][g], acc[g][2]);
          acc[g][3] = fmaf(hv.w, ureg[kk][g], acc[g][3]);
        }
      }
    } else {
      for (int kk = 0; kk < kn; ++kk) {
        const int k = ks + kk * KS;
        const float4 hv =
            *reinterpret_cast<const float4*>(hcur + k * RB4 + rb);
        float w[4];
        if (UMODE == U_SMEM) {
          const float4 wv = load4(Ws + ((size_t)u * H + k) * 4);
          w[0] = wv.x, w[1] = wv.y, w[2] = wv.z, w[3] = wv.w;
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            w[g] = u < nu ? ld_stream(U + (size_t)k * G + g * H + u0 + u)
                          : 0.0f;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g][0] = fmaf(hv.x, w[g], acc[g][0]);
          acc[g][1] = fmaf(hv.y, w[g], acc[g][1]);
          acc[g][2] = fmaf(hv.z, w[g], acc[g][2]);
          acc[g][3] = fmaf(hv.w, w[g], acc[g][3]);
        }
      }
    }
    // the group's sums: with KS >= 4 lanes a reduce-scatter (the xor-1 and
    // xor-2 levels each keep half the rows, so lane l ends with the four
    // gates of row l & 3; wider levels add those up), else every lane adds
    // up all sixteen
    float zo[4];
    if (KS >= 4) {
      const int b0 = ks & 1, b1 = (ks >> 1) & 1;
      float k1[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float keep = b0 ? acc[g][2 * i + 1] : acc[g][2 * i];
          const float send = b0 ? acc[g][2 * i] : acc[g][2 * i + 1];
          k1[g][i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float keep = b1 ? k1[g][1] : k1[g][0];
        const float send = b1 ? k1[g][0] : k1[g][1];
        zo[g] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
      }
      for (int o = 4; o < KS; o <<= 1) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          zo[g] += __shfl_xor_sync(0xffffffffu, zo[g], o);
      }
    } else {
      for (int o = 1; o < KS; o <<= 1) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], o);
      }
    }
    CLK_MARK(0)

    // cell update: with KS >= 4 each lane updates its row and the group's
    // new h meet by shuffles, else each lane updates all four rows
    // (a lane past the block's units reads unit 0: hbuf holds H units)
    float ho[4];
    if (F32) {
      const float4 hold = *reinterpret_cast<const float4*>(
          hcur + (u0 + (active ? u : 0)) * RB4 + rb);
      ho[0] = hold.x, ho[1] = hold.y, ho[2] = hold.z, ho[3] = hold.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) ho[r] = hl[r];
    }
    float hn[4], z[4][4];
    if (KS >= 4) {
      const int r = ks & 3;
#pragma unroll
      for (int g = 0; g < 4; ++g) zo[g] += pick(xp[g], r);
      float hh;
      cell_update(zo[0], zo[1], zo[2], zo[3], c_own, pick(mk, r), pick(ho, r),
                  mask != nullptr, c_own, hh);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hn[q] = __shfl_sync(0xffffffffu, hh, q, KS);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g][r] = xp[g][r] + acc[g][r];
        cell_update(z[0][r], z[1][r], z[2][r], z[3][r], c[r], mk[r], ho[r],
                    mask != nullptr, c[r], hn[r]);
      }
    }
    // the unit's new h to every block (job k to lane k % KS), rounded to
    // the product's precision
    const float4 hv = make_float4(round_to<TS>(hn[0]), round_to<TS>(hn[1]),
                                  round_to<TS>(hn[2]), round_to<TS>(hn[3]));
    if (active) {
      float* dst = hnxt + (u0 + u) * RB4 + rb;
      for (int k = ks; k < CS; k += KS) {
        if (k == rank)
          *reinterpret_cast<float4*>(dst) = hv;
        else
          *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, k)) = hv;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) hl[r] = hn[r];
    // this block's h is complete: tell every other block, store ys, cs and
    // z and load the next step's xproj while theirs arrive, then wait
    __syncthreads();
    if (CS > 1 && tid < CS && tid != rank) mbar_arrive_remote(&bars[nb], tid);
    CLK_MARK(1)
    const size_t ob = ((size_t)t * B + row0 + rb) * H + u0 + u;
    const size_t zb = ((size_t)t * B + row0 + rb) * G + u0 + u;
    if (KS >= 4) {
      // the row's six stores (ys, cs, four of z) over its KS / 4 lanes
      const int r = ks & 3, nh = KS >> 2, half = ks >> 2;
      const bool ok = pick_ok(rowok, r);
      const size_t o = ob + (size_t)r * H;
      if (ok && half == 0) ys[o] = pick(hn, r);
      if (ok && z_out != nullptr) {
        if (1 % nh == half) cs_out[o] = c_own;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if ((2 + g) % nh == half)
            z_out[zb + (size_t)r * G + g * H] = from_f32<TS>(zo[g]);
      }
    } else if (active) {
      // job j to lane j % KS (indices stay compile-time, so the arrays stay
      // in registers)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (!rowok[r]) continue;
        if ((r & (KS - 1)) == ks) ys[ob + (size_t)r * H] = hn[r];
        if (z_out == nullptr) continue;
        if (((4 + r) & (KS - 1)) == ks) cs_out[ob + (size_t)r * H] = c[r];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (((8 + 4 * r + g) & (KS - 1)) == ks)
            z_out[zb + (size_t)r * G + g * H] = from_f32<TS>(z[g][r]);
        }
      }
    }
    if (t + 1 < T)
      load_step(xp, mk, xproj, mask, t + 1, B, G, H, row0 + rb, u0 + u, rowok);
    if (CS > 1) mbar_wait(&bars[nb], (t >> 1) & 1);
    CLK_MARK(2)
  }

  if (KS >= 4) {
    const int r = ks & 3;
    if (ks < 4 && pick_ok(rowok, r)) {
      const size_t o = (size_t)(row0 + rb + r) * H + u0 + u;
      hT[o] = pick(hl, r);
      cT[o] = c_own;
    }
  } else if (active && ks == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (rowok[r]) {
        const size_t o = (size_t)(row0 + rb + r) * H + u0 + u;
        hT[o] = hl[r];
        cT[o] = c[r];
      }
    }
  }
  // no block leaves while another may still write into its shared memory
  cluster.sync();
}

template <typename TX, typename TS, int UMODE>
static cudaError_t launch(const TX* xproj, const TS* U, const float* h0,
                          const float* c0, const float* mask, float* ys,
                          float* hT, float* cT, TS* z, float* cs, int T,
                          int B, int H, int CS, int UPC, int RB, int RB4,
                          int KS, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      lstm_fwd_kernel<TX, TS, UMODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
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
  return cudaLaunchKernelEx(&cfg, lstm_fwd_kernel<TX, TS, UMODE>, xproj, U, h0, c0,
                            mask, ys, hT, cT, z, cs, T, B, H, UPC, RB, RB4,
                            KS);
}

// Plan arguments (chosen by the Python wrapper, ops/cuda_lstm.py::plan):
// CS blocks per cluster, UPC hidden units per block, RB rows per cluster
// (RB4 = RB rounded up to 4), KS lanes that share a unit's h @ U sum (a
// power of two, at most 32, KS * UPC * RB4 / 4 <= 256), umode where U's
// slice lives (0 registers: ceil(H / KS) <= 16; 1 shared memory; 2 read
// through L2). mask, z and cs may be null (z and cs together). U and z are
// TS (float, or __nv_bfloat16 in lstm_fwd_bf16_launch and
// lstm_fwd_bf16u_launch), xproj TX (TS, or float in lstm_fwd_bf16u_launch).
template <typename TX, typename TS>
static int launch_form(const void* xproj, const void* U, const void* h0,
                       const void* c0, const void* mask, void* ys, void* hT,
                       void* cT, void* z, void* cs, int T, int B, int H,
                       int CS, int UPC, int RB, int RB4, int KS, int umode,
                       void* stream) {
  if (T < 1 || B < 1 || H < 1 || CS < 1 || CS > MAX_CLUSTER || UPC < 1 ||
      (CS - 1) * UPC >= H || CS * UPC < H || RB < 1 || RB4 < RB ||
      RB4 % 4 != 0 || KS < 1 || KS > 32 || (KS & (KS - 1)) != 0 ||
      KS * UPC * (RB4 / 4) > THREADS || umode < U_REGS || umode > U_L2 ||
      (umode == U_REGS && (H + KS - 1) / KS > KREG) ||
      ((z == nullptr) != (cs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(H, UPC, RB4, umode, sizeof(TS));
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const TX* xp = (const TX*)xproj;
  const TS* u = (const TS*)U;
  const float* args[3] = {(const float*)h0, (const float*)c0,
                          (const float*)mask};
  if (umode == U_REGS)
    e = launch<TX, TS, U_REGS>(xp, u, args[0], args[1], args[2], (float*)ys,
                           (float*)hT, (float*)cT, (TS*)z, (float*)cs, T, B,
                           H, CS, UPC, RB, RB4, KS, smem,
                           (cudaStream_t)stream);
  else if (umode == U_SMEM)
    e = launch<TX, TS, U_SMEM>(xp, u, args[0], args[1], args[2], (float*)ys,
                           (float*)hT, (float*)cT, (TS*)z, (float*)cs, T, B,
                           H, CS, UPC, RB, RB4, KS, smem,
                           (cudaStream_t)stream);
  else
    e = launch<TX, TS, U_L2>(xp, u, args[0], args[1], args[2], (float*)ys,
                         (float*)hT, (float*)cT, (TS*)z, (float*)cs, T, B, H,
                         CS, UPC, RB, RB4, KS, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int lstm_fwd_launch(const void* xproj, const void* U,
                               const void* h0, const void* c0,
                               const void* mask, void* ys, void* hT, void* cT,
                               void* z, void* cs, int T, int B, int H, int CS,
                               int UPC, int RB, int RB4, int KS, int umode,
                               void* stream) {
  return launch_form<float, float>(xproj, U, h0, c0, mask, ys, hT, cT, z, cs,
                                   T, B, H, CS, UPC, RB, RB4, KS, umode,
                                   stream);
}

extern "C" int lstm_fwd_bf16_launch(const void* xproj, const void* U,
                                    const void* h0, const void* c0,
                                    const void* mask, void* ys, void* hT,
                                    void* cT, void* z, void* cs, int T, int B,
                                    int H, int CS, int UPC, int RB, int RB4,
                                    int KS, int umode, void* stream) {
  return launch_form<__nv_bfloat16, __nv_bfloat16>(
      xproj, U, h0, c0, mask, ys, hT, cT, z, cs, T, B, H, CS, UPC, RB, RB4, KS,
      umode, stream);
}

// xproj float32, U bfloat16, no residuals (z and cs null)
extern "C" int lstm_fwd_bf16u_launch(const void* xproj, const void* U,
                                     const void* h0, const void* c0,
                                     const void* mask, void* ys, void* hT,
                                     void* cT, void* z, void* cs, int T,
                                     int B, int H, int CS, int UPC, int RB,
                                     int RB4, int KS, int umode,
                                     void* stream) {
  if (z != nullptr || cs != nullptr) return (int)cudaErrorInvalidValue;
  return launch_form<float, __nv_bfloat16>(xproj, U, h0, c0, mask, ys, hT, cT,
                                           z, cs, T, B, H, CS, UPC, RB, RB4,
                                           KS, umode, stream);
}
