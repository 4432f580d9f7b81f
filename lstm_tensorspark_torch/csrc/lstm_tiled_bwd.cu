// Fused backward (BPTT) of one wide LSTM layer's recurrence (U too big for
// one block's shared memory), for Hopper (sm_90a), in two forms: float32,
// and bfloat16 streams (stream_dtype.cuh).
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_bwd_tiled_kernel
// (the "tiled" branch of _pallas_backward). The TPU kernel streams U^T from
// HBM in [ttile, H] row tiles every step. Here, as in lstm_tiled_fwd.cu, one
// persistent block per SM, in clusters of C blocks (tiled_common.cuh), holds
// rows [rank * Hq, ...) of U for its cluster's 4 * UPC gate columns for the
// whole call: in registers (two rows a lane, KREG columns each) and any rest
// in shared memory. Walking time in reverse from the forward's residuals
// (z [T, B, 4H], cs [T, B, H], c0), per step t and tile of 16 batch rows
// every block:
//   - completes dh of its own units: the sum over the clusters of the partial
//     products each cluster published at the step before (a counter in
//     global memory per slice of H: no grid-wide barrier),
//     every cluster's slab copied into shared memory at once (cp.async),
//     plus the mask's skip term (1 - m) * dh_tot; dhT at the first step;
//   - runs the gate algebra of its units from factors computed while the
//     step before was in flight (i, f, o = sigmoid(z), g = tanh(z), tanh(c_t)
//     from z_t and c_{t-1}): dh_tot = dh + dys_t; dc_new = dc + dh_tot * o *
//     (1 - tanh(c_t)^2); dz_t = [dc_new*g*i*(1-i), dc_new*c_{t-1}*f*(1-f),
//     dc_new*i*(1-g^2), dh_tot*tanh(c_t)*o*(1-o)]; dc = dc_new * f; under the
//     mask (m = 0 at a frozen step) the gates see m * dh_tot and m * dc while
//     (1 - m) of both bypass them into the previous step. It streams its dz
//     columns out (dxproj is dz; dU = h_prev^T dz is one matmul outside) and
//     sends them to every block of its cluster (distributed shared memory,
//     an mbarrier per buffer, cluster_common.cuh);
//   - computes dz_t[:, cluster columns] @ U[slice, cluster columns]^T, the
//     cluster's complete sum for the rows of its slice of H: a lane's four
//     float4 loads of dz (one column, 16 rows, a broadcast) feed 32 FMAs with
//     its two rows' weights;
//   - writes that slab [slice][16 rows] into a double-buffered global scratch
//     [2][clusters][H][BP] (it stays in L2) and adds one to its slice's
//     counter; a step's last tile's dz go out to HBM after that, off the
//     chain.
// Only one partial per cluster crosses L2, and a block reads clusters x UPB x
// rows floats of it a step.
//
// What bounds it on the card: the same as the forward (17.2 GFLOP of
// products at config 5's shard, 0.256 ms at the f32 peak: by operations),
// behind the same chain of T dependent steps; a step adds the partial slabs'
// round trip through L2 (B * Hq floats written and clusters * B * UPB read a
// block).
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// The bfloat16 form (TS = __nv_bfloat16: z, U and dz bfloat16, as JAX's
// _lstm_bwd_tiled_kernel under bf16 compute) takes the gates from the
// rounded z and rounds each dz element once, before it is sent and stored,
// so the product is the rounded dz times U^T (U converted on load: float32
// values in the lanes' registers, the columns past them bfloat16 in shared
// memory); the carries and the partial sums stay float32.
//
// Plain C interface for ctypes: lstm_tiled_bwd_launch (float32) and
// lstm_tiled_bwd_bf16_launch (bfloat16) return the CUDA error code (0 =
// success). They allocate nothing (the caller passes the scratch and the
// zeroed counters) and do not synchronise; they run on the stream they are
// given.

#include "cluster_common.cuh"
#include "stream_dtype.cuh"
#include "tiled_common.cuh"

namespace cg = cooperative_groups;

// How the backward's warps share its product: its cluster owns UPC = C *
// UPB units, so NC = 4 * UPC gate columns of U, and block `rank` holds
// rows [rank * Hq, ...) of them. A j-group of `span` warps covers the
// slice of H (two rows a lane); `groups` j-groups split the cluster's
// columns, `per_lane` columns each (the first `regs` in registers). Warps
// past groups * span take no part in the product.
// ops/cuda_lstm_tiled.py::plan mirrors this.
struct BwdGeom {
  int UPC, NC, Hq, BP, NT;
  int span, groups, per_lane, regs, width;
};

__host__ __device__ inline BwdGeom bwd_geom(int B, int H, int C, int UPB) {
  BwdGeom g;
  g.UPC = C * UPB;
  g.NC = 4 * g.UPC;
  g.Hq = (H + C - 1) / C;
  g.BP = (B + ROWS - 1) / ROWS * ROWS;
  g.NT = g.BP / ROWS;
  g.span = (g.Hq + 63) / 64;
  g.groups = g.span <= WARPS ? WARPS / g.span : 0;
  g.per_lane = g.groups > 0 ? (g.NC + g.groups - 1) / g.groups : 0;
  g.regs = g.per_lane < KREG ? g.per_lane : KREG;
  g.width = 64 * g.span;
  return g;
}

// Column `col` of the cluster's 4 * UPC: the columns of block rank r come
// together (gate g, unit uu: col = (r * 4 + g) * UPB + uu), so a block's
// four gates are one contiguous run. Returns U's column g * H + unit, or
// -1 past H.
__device__ __forceinline__ int cluster_col(int col, int cl, int C, int UPB,
                                           int H) {
  const int UC = 4 * UPB;
  const int r = col / UC, rem = col - r * UC;
  const int g = rem / UPB, uu = rem - g * UPB;
  const int unit = (cl * C + r) * UPB + uu;
  return unit < H ? g * H + unit : -1;
}

// Shared-memory layout (every piece a multiple of 16 bytes; Ut in TS, the
// rest float):
//   Ut    [groups][per_lane - regs][width]  U^T columns past the registers
//   dzc   [2][groups * per_lane][ROWS]      the cluster's dz of one tile
//   red   [groups][width][RED_STRIDE]       each j-group's sums, [k][16 rows]
//                                           padded against bank conflicts
//   gsum  [THREADS][4]                      the dh gather's pieces
//   dcown [BP][UPB], skip [BP][UPB]         dc carry and (1 - m) * dh_tot
//   gbuf  [clusters][UPB][ROWS]             every cluster's partial dh of the
//                                           own units for one tile
//   bars  2 mbarriers                       one per dzc buffer
#define RED_STRIDE 20

__host__ __device__ inline size_t bwd_ut_bytes(const BwdGeom& g,
                                                size_t esize) {
  return align16(esize * g.groups * (g.per_lane - g.regs) * g.width);
}

static size_t bwd_smem_bytes(const BwdGeom& g, int UPB, int ncl,
                             size_t esize) {
  return bwd_ut_bytes(g, esize) +
         sizeof(float) * (2 * (size_t)g.groups * g.per_lane * ROWS +
                          (size_t)g.groups * g.width * RED_STRIDE +
                          THREADS * 4 + 2 * (size_t)g.BP * UPB +
                          (size_t)ncl * UPB * ROWS + 4);
}

// One cell's inputs at (t, row): z, c_{t-1}, dys_t and the mask (1 without
// one), loaded a tile ahead; then the gates and tanh(c_t) from them, off the
// chain
struct CellIn {
  float z[4], cp, dy, m;
  float ig, fg, gg, og, tc;
};

template <typename TS>
__device__ __forceinline__ void load_cell(CellIn& a,
                                          const TS* __restrict__ z,
                                          const float* __restrict__ cs,
                                          const float* __restrict__ c0,
                                          const float* __restrict__ dys,
                                          const float* __restrict__ mask,
                                          int t, int row, int B, int H,
                                          int unit, bool ok) {
  const size_t zb = ((size_t)t * B + row) * 4 * H + unit;
  const size_t hb = ((size_t)t * B + row) * H + unit;
#pragma unroll
  for (int g = 0; g < 4; ++g) a.z[g] = ok ? ld_stream(z + zb + g * H) : 0.0f;
  a.cp = !ok ? 0.0f
             : t > 0 ? __ldg(cs + hb - (size_t)B * H)
                     : __ldg(c0 + (size_t)row * H + unit);
  a.dy = ok ? __ldg(dys + hb) : 0.0f;
  a.m = (ok && mask != nullptr) ? __ldg(mask + (size_t)t * B + row) : 1.0f;
}

__device__ __forceinline__ void cell_factors(CellIn& a) {
  a.ig = sigmoid_f(a.z[0]);
  a.fg = sigmoid_f(a.z[1]);
  a.gg = tanhf(a.z[2]);
  a.og = sigmoid_f(a.z[3]);
  a.tc = tanhf(a.fg * a.cp + a.ig * a.gg);
}

template <typename TS>
__global__ void __launch_bounds__(THREADS, 1)
lstm_tiled_bwd_kernel(const TS* __restrict__ z,
                      const float* __restrict__ dys,
                      const float* __restrict__ cs,
                      const float* __restrict__ c0,
                      const float* __restrict__ mask,
                      const TS* __restrict__ U,
                      const float* __restrict__ dhT,
                      const float* __restrict__ dcT, TS* __restrict__ dz,
                      float* __restrict__ dh0, float* __restrict__ dc0,
                      float* part, int* flags, int T, int B, int H, int UPB) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cl = blockIdx.x / C;
  const int ncl = (int)gridDim.x / C;
  const BwdGeom gm = bwd_geom(B, H, C, UPB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = 4 * H, NC = gm.NC, BP = gm.BP, W = gm.width;
  const int JR = gm.groups * gm.per_lane;  // dz columns staged (zero tail)
  const int u0 = (cl * C + rank) * UPB;
  const int nu = max(0, min(UPB, H - u0));
  const int k0 = rank * gm.Hq;
  const int kn = max(0, min(gm.Hq, H - k0));
  const int extra = gm.per_lane - gm.regs;

  extern __shared__ float4 smem4[];
  TS* Ut = reinterpret_cast<TS*>(smem4);
  float* dzc = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                        bwd_ut_bytes(gm, sizeof(TS)));
  float* red = dzc + 2 * (size_t)JR * ROWS;
  float* gsum = red + (size_t)gm.groups * W * RED_STRIDE;
  float* dcown = gsum + THREADS * 4;
  float* skip = dcown + BP * UPB;
  float* gbuf = skip + BP * UPB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(gbuf + ncl * UPB * ROWS);

  // the lane's place in the product: j-group jg, rows kl, kl + 1 of the
  // slice, columns jb .. jb + per_lane of the cluster's (weights past kn,
  // NC or H are 0, and so are the dz columns past NC)
  const int jg = warp / gm.span, kw = warp - jg * gm.span;
  const bool in_product = jg < gm.groups;
  const int kl = 64 * kw + 2 * lane;
  const int jb = jg * gm.per_lane;
  float ureg[KREG][2];
#pragma unroll
  for (int i = 0; i < KREG; ++i) {
    const int uc = (in_product && i < gm.regs && jb + i < NC)
                       ? cluster_col(jb + i, cl, C, UPB, H)
                       : -1;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      ureg[i][e] = (uc >= 0 && kl + e < kn)
                       ? to_f32(U[(size_t)(k0 + kl + e) * G + uc])
                       : 0.0f;
  }
  for (int i = tid; i < gm.groups * extra * W; i += THREADS) {
    const int k = i % W, rr = i / W;
    const int grp = rr / extra, j = grp * gm.per_lane + gm.regs + rr % extra;
    const int uc = j < NC ? cluster_col(j, cl, C, UPB, H) : -1;
    Ut[i] = (k < kn && uc >= 0) ? U[(size_t)(k0 + k) * G + uc]
                                : from_f32<TS>(0.0f);
  }
  for (int i = tid; i < 2 * JR * ROWS; i += THREADS) dzc[i] = 0.0f;
  for (int i = tid; i < BP * UPB; i += THREADS) {
    const int r = i / UPB, uu = i - r * UPB;
    dcown[i] = (r < B && uu < nu) ? dcT[(size_t)r * H + u0 + uu] : 0.0f;
    skip[i] = 0.0f;
  }
  if (tid == 0) {
    mbar_init(&bars[0], C - 1);
    mbar_init(&bars[1], C - 1);
    mbar_init_fence();
  }
  // the slices of H the own units fall in: their dh comes from the blocks
  // of that rank in every cluster
  const int qlo = nu > 0 ? u0 / gm.Hq : 0;
  const int qhi = nu > 0 ? (u0 + nu - 1) / gm.Hq : -1;
  // every block of the cluster runs (and has its mbarriers set) before any
  // block writes into another's shared memory
  cluster.sync();

  // cell thread: row cr of a tile, unit cu
  const int cr = tid / UPB, cu = tid - cr * UPB;
  const bool cell = tid < ROWS * UPB && cu < nu;
  // gather thread: float4 piece (unit gu, rows 4 * gq ..) of every
  // gstride-th cluster's slab, from cluster gc on
  const int pieces = 4 * UPB, gstride = THREADS / pieces;
  const int gc = tid / pieces, gp = tid - gc * pieces;
  const int gu = gp >> 2, gq = gp & 3;
  CellIn in;
  load_cell(in, z, cs, c0, dys, mask, T - 1, cr, B, H, u0 + cu,
            cell && cr < B);
  cell_factors(in);
  CLK_START

  for (int s = 0; s <= T; ++s) {
    const int t = T - 1 - s;
    if (s > 0) {
      if (tid == 0)
        for (int q = qlo; q <= qhi; ++q) wait_count(flags + q, ncl * s);
      __syncthreads();
    }
    CLK_MARK(0)
    const float* pin = part + (size_t)((s - 1) & 1) * ncl * H * BP;
    float* pout = part + (size_t)(s & 1) * ncl * H * BP;
    for (int j = 0; j < gm.NT; ++j) {
      const int item = s * gm.NT + j, buf = item & 1;
      const int row = j * ROWS + cr;
      // dh of the own units for this tile's rows
      float dh = 0.0f;
      if (s > 0) {
        // every cluster's partial for the own units, all copies in flight
        for (int f = tid; f < ncl * nu * 4; f += THREADS) {
          const int c = f / (nu * 4), rem = f - c * nu * 4;
          const int uu = rem >> 2, q4 = rem & 3;
          cp_async16(gbuf + (c * UPB + uu) * ROWS + 4 * q4,
                     pin + ((size_t)c * H + u0 + uu) * BP + j * ROWS + 4 * q4);
        }
        cp_async_wait_all();
        __syncthreads();
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (gc < gstride && gu < nu) {
          const float4* src =
              reinterpret_cast<const float4*>(gbuf) + gu * (ROWS / 4) + gq;
#pragma unroll 8
          for (int c = gc; c < ncl; c += gstride) {
            const float4 v = src[c * UPB * (ROWS / 4)];
            a.x += v.x;
            a.y += v.y;
            a.z += v.z;
            a.w += v.w;
          }
        }
        reinterpret_cast<float4*>(gsum)[tid] = a;
        __syncthreads();
        if (cell) {
#pragma unroll 8
          for (int c = 0; c < gstride; ++c)
            dh += gsum[(c * pieces + cu * 4 + (cr >> 2)) * 4 + (cr & 3)];
          dh += skip[row * UPB + cu];
        }
      } else if (cell && row < B) {
        dh = dhT[(size_t)row * H + u0 + cu];
      }
      if (s == T) {  // dh0, dc0: the gradients of the initial carry
        if (cell && row < B) {
          const size_t ob = (size_t)row * H + u0 + cu;
          dh0[ob] = dh;
          dc0[ob] = dcown[row * UPB + cu];
        }
        __syncthreads();  // gsum is read before the next tile writes it
        continue;
      }
      CLK_MARK(1)

      // gate algebra of the own units; dz out and to the cluster
      if (cell && row < B) {
        const int o = row * UPB + cu;
        const float dh_tot = dh + in.dy;
        const float dc_in = dcown[o];
        float dh_eff = dh_tot, dc_eff = dc_in;
        if (mask != nullptr) {
          dh_eff = in.m * dh_tot;
          dc_eff = in.m * dc_in;
        }
        const float dc_new = dc_eff + dh_eff * in.og * (1.0f - in.tc * in.tc);
        float d[4];
        d[3] = dh_eff * in.tc * in.og * (1.0f - in.og);
        d[0] = dc_new * in.gg * in.ig * (1.0f - in.ig);
        d[1] = dc_new * in.cp * in.fg * (1.0f - in.fg);
        d[2] = dc_new * in.ig * (1.0f - in.gg * in.gg);
        const size_t zb = ((size_t)t * B + row) * G + u0 + cu;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          // dz rounded once, to the precision of its store and the product
          d[g] = round_to<TS>(d[g]);
          // a step's last tile's dz go out after the slab is published
          if (j + 1 < gm.NT) dz[zb + g * H] = from_f32<TS>(d[g]);
          float* dst = dzc + ((size_t)buf * JR + (rank * 4 + g) * UPB + cu) *
                                 ROWS + cr;
          for (int b = 0; b < C; ++b)
            *(b == rank ? dst : cluster.map_shared_rank(dst, b)) = d[g];
        }
        float dc_next = dc_new * in.fg;
        if (mask != nullptr) {
          dc_next = dc_next + (1.0f - in.m) * dc_in;
          skip[o] = (1.0f - in.m) * dh_tot;
        }
        dcown[o] = dc_next;
      }
      // the next tile's inputs, loaded while this tile's exchange and
      // product run
      {
        const int tn = j + 1 < gm.NT ? t : t - 1;
        const int rn = (j + 1 < gm.NT ? j + 1 : 0) * ROWS + cr;
        if (tn >= 0)
          load_cell(in, z, cs, c0, dys, mask, tn, rn, B, H, u0 + cu,
                    cell && rn < B);
      }
      __syncthreads();
      if (tid < C && tid != rank) mbar_arrive_remote(&bars[buf], tid);
      mbar_wait_bounded(&bars[buf], (item >> 1) & 1);
      CLK_MARK(2)

      // the lane's rows of dz @ U^T over its j-group's columns
      if (in_product) {
        float acc[ROWS][2];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = 0.0f;
        const float4* dp =
            reinterpret_cast<const float4*>(dzc + (size_t)buf * JR * ROWS) +
            jb * 4;
        if (gm.regs == KREG)
          lane_product<true>(acc, dp, ureg, KREG, 4);
        else
          lane_product<false>(acc, dp, ureg, gm.regs, 4);
        const TS* up = Ut + (size_t)jg * extra * W + kl;
        for (int i = gm.regs; i < gm.per_lane; ++i) {
          const float2 w = load2(up + (size_t)(i - gm.regs) * W);
          float dv[ROWS];
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const float4 v = dp[i * 4 + q4];
            dv[4 * q4] = v.x, dv[4 * q4 + 1] = v.y;
            dv[4 * q4 + 2] = v.z, dv[4 * q4 + 3] = v.w;
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            acc[r][0] = fmaf(dv[r], w.x, acc[r][0]);
            acc[r][1] = fmaf(dv[r], w.y, acc[r][1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float4* rp = reinterpret_cast<float4*>(
              red + ((size_t)jg * W + kl + e) * RED_STRIDE);
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4)
            rp[q4] = make_float4(acc[4 * q4][e], acc[4 * q4 + 1][e],
                                 acc[4 * q4 + 2][e], acc[4 * q4 + 3][e]);
        }
      }
      __syncthreads();
      // the j-groups' sums: the cluster's slab of this tile, [k][16 rows]
      for (int f = tid; f < kn * 4; f += THREADS) {
        const int k = f >> 2, q4 = f & 3;
        const float4* rp =
            reinterpret_cast<const float4*>(red + (size_t)k * RED_STRIDE) + q4;
        float4 a = rp[0];
        for (int g = 1; g < gm.groups; ++g) {
          const float4 v = rp[(size_t)g * W * RED_STRIDE / 4];
          a.x += v.x;
          a.y += v.y;
          a.z += v.z;
          a.w += v.w;
        }
        *reinterpret_cast<float4*>(pout + ((size_t)cl * H + k0 + k) * BP +
                                   j * ROWS + 4 * q4) = a;
      }
      // the next tile's gates, while the other blocks publish
      cell_factors(in);
      CLK_MARK(3)
    }
    if (s < T) {  // every thread's slab is stored: publish it
      __syncthreads();
      if (tid == 0) arrive_count(flags + rank);
      // the last tile's dz, from the cluster buffer (rewritten two tiles on)
      const int row = (gm.NT - 1) * ROWS + cr;
      if (cell && row < B) {
        const int item = s * gm.NT + gm.NT - 1;
        const float* src = dzc + ((size_t)(item & 1) * JR + rank * 4 * UPB +
                                  cu) * ROWS + cr;
        const size_t zb = ((size_t)t * B + row) * G + u0 + cu;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          dz[zb + g * H] = from_f32<TS>(src[g * UPB * ROWS]);
      }
    }
  }
  // no block leaves while another may still write into its shared memory
  cluster.sync();
}

// Plan arguments (ops/cuda_lstm_tiled.py::plan): C blocks a cluster, UPB
// hidden units a block; the grid is blocks = C * ceil(H / (C * UPB)). U is
// [H, 4H] as the forward takes it. part is a scratch of 2 * (blocks / C) *
// H * BP floats (BP = B rounded up to 16), flags C zeroed ints. mask may be
// null. z, U and dz are TS (float, or __nv_bfloat16 in
// lstm_tiled_bwd_bf16_launch).
template <typename TS>
static int launch_form(const void* z, const void* dys, const void* cs,
                       const void* c0, const void* mask, const void* U,
                       const void* dhT, const void* dcT, void* dz, void* dh0,
                       void* dc0, void* part, void* flags, int T, int B,
                       int H, int C, int UPB, void* stream) {
  if (T < 1 || B < 1 || H < 1 || C < 2 || C > MAX_CLUSTER || UPB < 1 ||
      UPB > MAX_UNITS)
    return (int)cudaErrorInvalidValue;
  const BwdGeom g = bwd_geom(B, H, C, UPB);
  if (g.groups < 1) return (int)cudaErrorInvalidValue;
  const int ncl = (H + g.UPC - 1) / g.UPC, blocks = C * ncl;
  const size_t smem = bwd_smem_bytes(g, UPB, ncl, sizeof(TS));
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  return (int)launch_clusters(
      lstm_tiled_bwd_kernel<TS>, blocks, C, smem, (cudaStream_t)stream,
      (const TS*)z, (const float*)dys, (const float*)cs, (const float*)c0,
      (const float*)mask, (const TS*)U, (const float*)dhT, (const float*)dcT,
      (TS*)dz, (float*)dh0, (float*)dc0, (float*)part, (int*)flags, T, B, H,
      UPB);
}

extern "C" int lstm_tiled_bwd_launch(const void* z, const void* dys,
                                     const void* cs, const void* c0,
                                     const void* mask, const void* U,
                                     const void* dhT, const void* dcT,
                                     void* dz, void* dh0, void* dc0,
                                     void* part, void* flags, int T, int B,
                                     int H, int C, int UPB, void* stream) {
  return launch_form<float>(z, dys, cs, c0, mask, U, dhT, dcT, dz, dh0, dc0,
                            part, flags, T, B, H, C, UPB, stream);
}

extern "C" int lstm_tiled_bwd_bf16_launch(const void* z, const void* dys,
                                          const void* cs, const void* c0,
                                          const void* mask, const void* U,
                                          const void* dhT, const void* dcT,
                                          void* dz, void* dh0, void* dc0,
                                          void* part, void* flags, int T,
                                          int B, int H, int C, int UPB,
                                          void* stream) {
  return launch_form<__nv_bfloat16>(z, dys, cs, c0, mask, U, dhT, dcT, dz,
                                    dh0, dc0, part, flags, T, B, H, C, UPB,
                                    stream);
}
