// Forward recurrence of one wide LSTM layer (U too big for one block's
// shared memory) over T steps, for Hopper (sm_90a), in two forms: float32,
// and bfloat16 streams (stream_dtype.cuh).
//
// Replaces lstm_tensorspark_tpu/ops/pallas_lstm.py::_lstm_tiled_kernel (the
// "tiled" branch of _pallas_forward). The TPU kernel streams U from HBM in
// [htile, 4H] row tiles every step because 16 MiB (H=1024, f32) does not fit
// in VMEM. Here U never moves after the first load: one persistent block per
// SM owns UPB hidden units and holds U's four gate columns for them over all
// of H, in registers (KREG rows a lane, two columns each) and any rest in
// shared memory. The blocks run in clusters of C, which share the copy of h.
// Per step t and tile of 16 batch rows every block:
//   - waits until every block that owns units of its slice of H (rows
//     [rank * Hq, ...)) has published h_{t-1} (a counter in global memory
//     per slice: no grid-wide barrier), and copies that slice of h_{t-1}
//     from L2 with one TMA bulk copy multicast into the shared memory of
//     every block of its cluster, [k][16 rows], once the others have
//     signalled (an mbarrier) that they have read the tile before; each
//     block waits on an mbarrier for all of h (its slice and the others');
//   - accumulates h_{t-1} @ U[:, own columns] in float32: a lane owns two
//     columns and every slots-th row of H, so its four float4 loads of h
//     (one k, 16 rows, shared by the lanes of its slot) feed 32 FMAs;
//   - sums the slots' parts and runs the cell of its own units, z = xproj_t
//     + acc (gate order i, f, g, o), c_t = sigmoid(f) * c_{t-1} + sigmoid(i)
//     * tanh(g), h_t = sigmoid(o) * tanh(c_t), with the optional mask blend
//     m * new + (1 - m) * old; c and h of its units stay in shared memory;
//   - writes its units' h_t into the other half of a double-buffered global
//     array [2][tiles][H][16] (it stays in L2) and adds one to the counter of
//     each slice its units fall in; then ys, z and cs when asked, and the
//     next step's xproj load, off the chain.
// The cluster exchanges no sums: it shares the L2 reads of h (B * H floats
// a cluster a step instead of a block).
//
// What bounds it on the card: at config 5's per-chip shard (B=16, T=128,
// H=1024) the products are 2*T*B*H*4H = 17.2 GFLOP, 0.256 ms at the H100's
// float32 peak (67 TFLOP/s), and the bytes (xproj, U, ys, z, cs) about
// 0.030 ms: by operations. The T dependent steps are a latency floor the
// bound does not see: a step is the product (8 warps x 128 rows x (4 loads
// + 32 FMAs) / 2 slots a warp, about 4,600 cycles of instructions an SM),
// the copy of h, the cell and one counter's round trip through L2.
// Math is expf / tanhf with float32 accumulation (no fast-math intrinsics).
//
// The bfloat16 form (TS = __nv_bfloat16: xproj, U and z bfloat16, as JAX's
// _lstm_tiled_kernel under bf16 compute) converts xproj and U on load (the
// lanes' registers hold float32 values; the rows past them sit in shared
// memory as bfloat16), publishes h_t rounded to bfloat16 (the global h
// array only feeds the product; the cell keeps its float32 h in shared
// memory), feeds the gates the float32 z and stores z rounded once. A
// third form, lstm_tiled_fwd_bf16u_launch (TX = float: xproj float32, U
// bfloat16, no residuals), rounds as JAX's plain XLA scan does under bf16
// compute (the serve prefill's rounding; lstm_fwd.cu says why).
//
// Plain C interface for ctypes: lstm_tiled_fwd_launch (float32),
// lstm_tiled_fwd_bf16_launch (bfloat16) and lstm_tiled_fwd_bf16u_launch
// return the CUDA error code (0 = success). They allocate nothing (the caller passes the h scratch and the
// zeroed counters) and do not synchronise; they run on the stream they are
// given.

#include "cluster_common.cuh"
#include "stream_dtype.cuh"
#include "tiled_common.cuh"

namespace cg = cooperative_groups;

// The block's lanes: a slot of CP = 2 * UPB lanes covers the own columns
// (two a lane) at one row k of H; slots = THREADS / CP slots take every
// slots-th row, per_lane rows each (the first regs of them in registers),
// so the slots of a warp read neighbouring rows of h (no bank conflict).
// ops/cuda_lstm_tiled.py::plan mirrors this.
struct FwdGeom {
  int NCB, CP, slots, per_lane, regs, KR, PS, Hq, BP, NT;
};

__host__ __device__ inline FwdGeom fwd_geom(int B, int H, int C, int UPB) {
  FwdGeom g;
  g.NCB = 4 * UPB;
  g.CP = 2 * UPB;
  g.slots = THREADS / g.CP;
  g.per_lane = (H + g.slots - 1) / g.slots;
  g.regs = g.per_lane < KREG ? g.per_lane : KREG;
  g.KR = g.slots * (g.per_lane > KREG ? g.per_lane : KREG);
  g.PS = g.NCB + 8;  // a row of the slots' sums, padded against conflicts
  g.Hq = (H + C - 1) / C;
  g.BP = (B + ROWS - 1) / ROWS * ROWS;
  g.NT = g.BP / ROWS;
  return g;
}

// Shared-memory layout (every piece a multiple of 16 bytes; Us in TS, the
// rest float):
//   Us   [per_lane - regs][slots][NCB]  U rows past the lanes' registers
//   hs   [KR][ROWS]                     h_{t-1} of one tile (zero tail, at
//                                       least KREG rows a lane)
//   part [slots][ROWS][PS]              each slot's sums
//   cown [BP][UPB], hown [BP][UPB]      c and h of the own units
//   bars 2 mbarriers                    full: h's copies have landed;
//                                       free: the cluster's other blocks
//                                       have read the tile before
__host__ __device__ inline size_t fwd_us_bytes(const FwdGeom& g,
                                                size_t esize) {
  return align16(esize * (g.per_lane - g.regs) * g.slots * g.NCB);
}

static size_t fwd_smem_bytes(const FwdGeom& g, int UPB, size_t esize) {
  return fwd_us_bytes(g, esize) +
         sizeof(float) * ((size_t)g.KR * ROWS + (size_t)g.slots * ROWS * g.PS +
                          2 * (size_t)g.BP * UPB + 4);
}

// xproj of (t, row) for one unit's four gates, and the row's mask (1 without
// one); 0 for a cell thread with no unit or row
template <typename TS>
__device__ __forceinline__ void load_x(float (&xp)[4], float& mk,
                                       const TS* __restrict__ xproj,
                                       const float* __restrict__ mask, int t,
                                       int row, int B, int H, int unit,
                                       bool ok) {
  const size_t xb = ((size_t)t * B + row) * 4 * H + unit;
#pragma unroll
  for (int g = 0; g < 4; ++g) xp[g] = ok ? ld_stream(xproj + xb + g * H) : 0.0f;
  mk = (ok && mask != nullptr) ? __ldg(mask + (size_t)t * B + row) : 1.0f;
}

template <typename TX, typename TS>
__global__ void __launch_bounds__(THREADS, 1)
lstm_tiled_fwd_kernel(const TX* __restrict__ xproj,
                      const TS* __restrict__ U,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const float* __restrict__ mask, float* __restrict__ ys,
                      float* __restrict__ hT, float* __restrict__ cT,
                      TS* __restrict__ z_out, float* __restrict__ cs_out,
                      float* hx, int* flags, int T, int B, int H, int UPB) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const FwdGeom gm = fwd_geom(B, H, C, UPB);
  const int tid = threadIdx.x;
  const int G = 4 * H, NCB = gm.NCB, BP = gm.BP;
  const int u0 = blockIdx.x * UPB;
  const int nu = max(0, min(UPB, H - u0));
  const int k0 = rank * gm.Hq;
  const int kn = max(0, min(gm.Hq, H - k0));

  extern __shared__ float4 smem4[];
  TS* Us = reinterpret_cast<TS*>(smem4);
  float* hs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                       fwd_us_bytes(gm, sizeof(TS)));
  float* part = hs + (size_t)gm.KR * ROWS;
  float* cown = part + (size_t)gm.slots * ROWS * gm.PS;
  float* hown = cown + BP * UPB;
  uint64_t* full = reinterpret_cast<uint64_t*>(hown + BP * UPB);
  uint64_t* freed = full + 1;

  // the lane's place in the product: slot sl (rows k = i * slots + sl),
  // columns 2 * cp, 2 * cp + 1 of the own 4 * UPB (gate g = col / UPB,
  // unit col % UPB); weights past H or nu are 0, and so are staged rows
  // past H
  const int sl = tid / gm.CP, cp = tid - sl * gm.CP;
  const bool in_product = sl < gm.slots;
  int ucol[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = 2 * cp + e, g = col / UPB, uu = col - g * UPB;
    ucol[e] = (in_product && uu < nu) ? g * H + u0 + uu : -1;
  }
  float ureg[KREG][2];
#pragma unroll
  for (int i = 0; i < KREG; ++i) {
    const int k = i * gm.slots + sl;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      ureg[i][e] = (i < gm.regs && k < H && ucol[e] >= 0)
                       ? to_f32(U[(size_t)k * G + ucol[e]])
                       : 0.0f;
  }
  for (int i = tid; i < (gm.per_lane - gm.regs) * gm.slots * NCB;
       i += THREADS) {
    const int col = i % NCB, rr = i / NCB;
    const int s = rr % gm.slots, k = (gm.regs + rr / gm.slots) * gm.slots + s;
    const int g = col / UPB, uu = col - g * UPB;
    Us[i] = (k < H && uu < nu) ? U[(size_t)k * G + g * H + u0 + uu]
                               : from_f32<TS>(0.0f);
  }
  for (int i = tid; i < gm.KR * ROWS; i += THREADS) hs[i] = 0.0f;
  float* hx0 = hx;
  float* hx1 = hx + (size_t)gm.NT * H * ROWS;
  for (int i = tid; i < BP * UPB; i += THREADS) {
    const int r = i / UPB, uu = i - r * UPB;
    const bool own = r < B && uu < nu;
    const float h = own ? h0[(size_t)r * H + u0 + uu] : 0.0f;
    hown[i] = h;
    cown[i] = own ? c0[(size_t)r * H + u0 + uu] : 0.0f;
    if (uu < nu) {  // both buffers: padded rows stay 0
      const size_t o = ((size_t)(r / ROWS) * H + u0 + uu) * ROWS + r % ROWS;
      hx0[o] = round_to<TS>(h);
      hx1[o] = 0.0f;
    }
  }
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(freed, C - 1);
    mbar_init_fence();
  }
  // the slices of H the own units fall in, and how many blocks publish the
  // own slice each step
  const int qlo = nu > 0 ? u0 / gm.Hq : 0;
  const int qhi = nu > 0 ? (u0 + nu - 1) / gm.Hq : -1;
  const int need = kn > 0 ? (k0 + kn - 1) / UPB - k0 / UPB + 1 : 0;
  __syncthreads();
  if (tid == 0)  // h0 published: step -1
    for (int q = qlo; q <= qhi; ++q) arrive_count(flags + q);
  // every block of the cluster runs (and has its mbarrier set) before any
  // copy lands in another's shared memory
  cluster.sync();

  // cell thread: row cr of a tile, unit cu
  const int cr = tid / UPB, cu = tid - cr * UPB;
  const bool cell = tid < ROWS * UPB && cu < nu;
  float xp[4], mk;
  load_x(xp, mk, xproj, mask, 0, cr, B, H, u0 + cu, cell && cr < B);
  // the cell thread's last z, c and h, and their stores
  float zo[4] = {0.0f, 0.0f, 0.0f, 0.0f}, co = 0.0f, ho = 0.0f;
  auto store_out = [&](int ts, int row) {
    const size_t ob = ((size_t)ts * B + row) * H + u0 + cu;
    ys[ob] = ho;
    if (z_out != nullptr) {
      cs_out[ob] = co;
      const size_t zb = ((size_t)ts * B + row) * G + u0 + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) z_out[zb + g * H] = from_f32<TS>(zo[g]);
    }
  };
  const uint16_t everyone = (uint16_t)((1u << C) - 1);
  CLK_START

  for (int t = 0; t < T; ++t) {
    const float* hcur = (t & 1) ? hx1 : hx0;
    float* hnxt = (t & 1) ? hx0 : hx1;
    for (int j = 0; j < gm.NT; ++j) {
      const int s = t * gm.NT + j;
      // the slice's h_{t-1} into every block of the cluster, once the
      // counter says it is published (a step's first tile) and the other
      // blocks have read the tile before
      if (tid == 0) {
        if (j == 0 && need > 0) wait_count(flags + rank, need * (t + 1));
        if (s > 0) mbar_wait_bounded(freed, (s - 1) & 1);
        bulk_expect(full, (uint32_t)H * ROWS * 4);
        if (kn > 0)
          bulk_copy_multicast(hs + (size_t)k0 * ROWS,
                              hcur + ((size_t)j * H + k0) * ROWS,
                              (uint32_t)kn * ROWS * 4, full, everyone);
      }
      mbar_wait_bounded(full, s & 1);
      CLK_MARK(0)

      // the lane's part of h_{t-1} @ U for two columns and 16 rows
      if (in_product) {
        float acc[ROWS][2];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = 0.0f;
        const float4* hp = reinterpret_cast<const float4*>(hs) + sl * 4;
        // every lane runs all KREG register rows: past its share the
        // weights and the staged rows are 0 (one unrolled copy to schedule)
        lane_product<true>(acc, hp, ureg, KREG, gm.slots * 4);
        const TS* up = Us + (size_t)sl * NCB + 2 * cp;
        for (int i = gm.regs; i < gm.per_lane; ++i) {
          const float2 w = load2(up + (size_t)(i - gm.regs) * gm.slots * NCB);
          const float4* hv = hp + (size_t)i * gm.slots * 4;
          float x[ROWS];
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const float4 f = hv[q4];
            x[4 * q4] = f.x, x[4 * q4 + 1] = f.y;
            x[4 * q4 + 2] = f.z, x[4 * q4 + 3] = f.w;
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            acc[r][0] = fmaf(x[r], w.x, acc[r][0]);
            acc[r][1] = fmaf(x[r], w.y, acc[r][1]);
          }
        }
        float* pp = part + (size_t)sl * ROWS * gm.PS + 2 * cp;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          *reinterpret_cast<float2*>(pp + r * gm.PS) =
              make_float2(acc[r][0], acc[r][1]);
      }
      __syncthreads();
      // h of this tile is read: the other blocks may copy the next one here
      if (tid < C && tid != rank) mbar_arrive_remote(freed, tid);
      CLK_MARK(1)

      // cell update of the own units for this tile's rows: h_t first; the
      // outputs of a step's last tile wait until h_t is published
      const int row = j * ROWS + cr;
      if (cell && row < B) {
        // the four gates' sums over the slots side by side
        const float* rp = part + (size_t)cr * gm.PS + cu;
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int q = 0; q < gm.slots; ++q) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            a[g] += rp[(size_t)q * ROWS * gm.PS + g * UPB];
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) zo[g] = xp[g] + a[g];
        const float ig = sigmoid_f(zo[0]);
        const float fg = sigmoid_f(zo[1]);
        const float gg = tanhf(zo[2]);
        const float og = sigmoid_f(zo[3]);
        const int o = row * UPB + cu;
        const float c_old = cown[o];
        co = fg * c_old + ig * gg;
        ho = og * tanhf(co);
        if (mask != nullptr) {
          co = mk * co + (1.0f - mk) * c_old;
          ho = mk * ho + (1.0f - mk) * hown[o];
        }
        cown[o] = co;
        hown[o] = ho;
        hnxt[((size_t)j * H + u0 + cu) * ROWS + cr] = round_to<TS>(ho);
        if (j + 1 < gm.NT) store_out(t, row);
      }
      // the next tile's xproj, loaded while the next product runs (a step's
      // last tile: after h_t is published, off the fence)
      if (j + 1 < gm.NT)
        load_x(xp, mk, xproj, mask, t, row + ROWS, B, H, u0 + cu,
               cell && row + ROWS < B);
      // the slots' sums are read before the next tile's product writes them
      if (j + 1 < gm.NT) __syncthreads();
    }
    // every thread's h_t is stored: publish it, then the last tile's
    // outputs and the next step's xproj
    __syncthreads();
    if (tid == 0)
      for (int q = qlo; q <= qhi; ++q) arrive_count(flags + q);
    const int row = (gm.NT - 1) * ROWS + cr;
    if (cell && row < B) store_out(t, row);
    if (t + 1 < T)
      load_x(xp, mk, xproj, mask, t + 1, cr, B, H, u0 + cu, cell && cr < B);
    CLK_MARK(2)
  }

  for (int i = tid; i < B * UPB; i += THREADS) {
    const int r = i / UPB, uu = i - r * UPB;
    if (uu >= nu) continue;
    const size_t ob = (size_t)r * H + u0 + uu;
    hT[ob] = hown[i];
    cT[ob] = cown[i];
  }
  // no block leaves while a copy or an arrival may still reach its shared
  // memory
  cluster.sync();
}

// Plan arguments (chosen by the Python wrapper, ops/cuda_lstm_tiled.py::plan):
// C blocks a cluster (they share the copy of h), UPB hidden units a block;
// the grid is blocks = C * ceil(H / (C * UPB)). hx is a scratch of 2 * H *
// BP floats (BP = B rounded up to 16), flags C zeroed ints. mask, z and cs
// may be null (z and cs together). U and z are TS (float, or __nv_bfloat16
// in lstm_tiled_fwd_bf16_launch and lstm_tiled_fwd_bf16u_launch), xproj TX
// (TS, or float in lstm_tiled_fwd_bf16u_launch).
template <typename TX, typename TS>
static int launch_form(const void* xproj, const void* U, const void* h0,
                       const void* c0, const void* mask, void* ys, void* hT,
                       void* cT, void* z, void* cs, void* hx, void* flags,
                       int T, int B, int H, int C, int UPB, void* stream) {
  if (T < 1 || B < 1 || H < 1 || C < 2 || C > MAX_CLUSTER || UPB < 1 ||
      UPB > MAX_UNITS || ((z == nullptr) != (cs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const FwdGeom g = fwd_geom(B, H, C, UPB);
  const size_t smem = fwd_smem_bytes(g, UPB, sizeof(TS));
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const int blocks = C * ((H + C * UPB - 1) / (C * UPB));
  return (int)launch_clusters(
      lstm_tiled_fwd_kernel<TX, TS>, blocks, C, smem, (cudaStream_t)stream,
      (const TX*)xproj, (const TS*)U, (const float*)h0, (const float*)c0,
      (const float*)mask, (float*)ys, (float*)hT, (float*)cT, (TS*)z,
      (float*)cs, (float*)hx, (int*)flags, T, B, H, UPB);
}

extern "C" int lstm_tiled_fwd_launch(const void* xproj, const void* U,
                                     const void* h0, const void* c0,
                                     const void* mask, void* ys, void* hT,
                                     void* cT, void* z, void* cs, void* hx,
                                     void* flags, int T, int B, int H,
                                     int C, int UPB, void* stream) {
  return launch_form<float, float>(xproj, U, h0, c0, mask, ys, hT, cT, z, cs,
                                   hx, flags, T, B, H, C, UPB, stream);
}

extern "C" int lstm_tiled_fwd_bf16_launch(const void* xproj, const void* U,
                                          const void* h0, const void* c0,
                                          const void* mask, void* ys,
                                          void* hT, void* cT, void* z,
                                          void* cs, void* hx, void* flags,
                                          int T, int B, int H, int C, int UPB,
                                          void* stream) {
  return launch_form<__nv_bfloat16, __nv_bfloat16>(
      xproj, U, h0, c0, mask, ys, hT, cT, z, cs, hx, flags, T, B, H, C, UPB,
      stream);
}

// xproj float32, U bfloat16, no residuals (z and cs null)
extern "C" int lstm_tiled_fwd_bf16u_launch(const void* xproj, const void* U,
                                           const void* h0, const void* c0,
                                           const void* mask, void* ys,
                                           void* hT, void* cT, void* z,
                                           void* cs, void* hx, void* flags,
                                           int T, int B, int H, int C,
                                           int UPB, void* stream) {
  if (z != nullptr || cs != nullptr) return (int)cudaErrorInvalidValue;
  return launch_form<float, __nv_bfloat16>(xproj, U, h0, c0, mask, ys, hT, cT,
                                           z, cs, hx, flags, T, B, H, C, UPB,
                                           stream);
}

// How many clusters of C blocks the card keeps resident at once when each
// block asks for smem bytes (cudaOccupancyMaxActiveClusters), into *out.
// ops/cuda_lstm_tiled.py::plan fits the pair's clusters into that many.
// Returns the CUDA error code.
extern "C" int lstm_tiled_fwd_max_clusters(int C, int smem, int* out) {
  if (C < 2 || C > MAX_CLUSTER || smem < 0 || smem > MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  return (int)max_clusters_of(lstm_tiled_fwd_kernel<float, float>, C, smem,
                              out);
}
