// The step body of an L-layer LSTM language model's decode, spread over many
// blocks: the embedding rows, L fused LSTM cells and the head's
// argmax, for every row of the batch at once. Shared by decode_window.cu (the
// K-step decode window) and spec_window.cu (the speculative draft-and-verify
// window).
//
// What bounds it on the card: at serving batch sizes a step is a chain of
// matrix-vector products (B rows against the weights), far below the card's
// operations-per-byte ridge, so the least time of a step is the weight bytes
// that do not stay on chip over memory bandwidth. The design reads each weight
// once per step for all rows, on every block of the launch:
//   - Block j owns a balanced slice of each model's hidden units (all four
//     gate columns of a unit, so the cell update stays in the block, c never
//     leaves it) and a slice of the head's V columns. Each block computes its
//     columns for every row: a row tile of up to MAX_RT rows per weight read.
//   - Inside a block a thread owns a 4 x 4 tile (four columns — the four
//     gates of one unit, or four head columns — by four rows) and a slice of
//     the reduction (k-split when a pass has fewer tiles than threads); x is
//     staged in shared memory transposed ([d][row]), so a step of the
//     product is one float4 of x, four weights and 16 FMAs. 64 units (256
//     columns) make a pass.
//   - Two builds of each kernel (template kC), picked by the plan
//     (ops/cuda_decode.plan) from the model's size:
//     one cluster (config 1): every weight slice, the whole head and the
//     embedding sit in each block's shared memory for the window (each
//     weight read once per window); so does the state (h of two steps, c),
//     each block pushing its units' new h into every block's copy
//     (distributed shared memory) before the cluster's hardware barrier, one
//     a layer. Every block computes the whole head, so the tokens need no
//     exchange.
//     a grid of one block an SM (config 3's width), cooperative: the layers
//     read through L2 each step (marked to stay there), the head streamed
//     from device memory (marked to leave first); h double-buffered in
//     global memory, read through L2 (ld.cg); blocks meet at a counter in
//     global memory. Each block leaves, per row, the best (value, index) of
//     its V slice; after one more barrier every block merges all slices the
//     same way (larger value, then lower index: jnp.argmax's rule), so
//     every block holds the same tokens and latches.
// A step costs L barriers in one cluster, L + 1 in a grid. The counters
// reset themselves at the kernel's end (the last block out zeroes them), so
// launches need no host reset and the window can be captured in a graph.
// Scratch comes from the wrapper.
//
// Math is expf / tanhf (no fast-math intrinsics) with f32 accumulation, so the
// kernels agree with their plain PyTorch versions to float32 rounding.
//
// Two forms of the layers (template TW, the element type of W and U): float,
// and __nv_bfloat16 under bf16 compute (JAX's fuse_params: W and U bfloat16,
// the bias float32; pallas_decode.py's dot(x.astype(w.dtype), w,
// preferred_element_type=float32)). The bfloat16 form keeps its weight
// slices in shared memory as bfloat16 (half the bytes of the float form: the
// plan sizes them at Model::es bytes an element), converts a weight to float
// on load and rounds x and h to bfloat16 where it stages them for a layer's
// product, so each product of two bfloat16 values is exact in float and the
// float sum is JAX's up to its order. The embedding, the head, the carries
// and the gate math stay float32 in both forms. Model::lbf16 (JAX's ldtype
// bfloat16) rounds a logit as JAX's dot(..., preferred_element_type=bf16) +
// bias.astype(bf16) does: the float sum to bfloat16, plus the bias rounded
// to bfloat16, rounded again.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cluster_common.cuh"
#include "stream_dtype.cuh"

#define MAX_LAYERS 8
#define THREADS 256
#define NWARPS (THREADS / 32)
#define MAX_RT 16                 // batch rows of a tile
#define PASS_UNITS (THREADS / 4)  // hidden units of a pass (4 columns each)
#define KS_SMEM 8  // most k-slices of a pass whose weights sit on chip
#define PAD_TOKEN (-1)
#define MAX_SMEM_BYTES 232448  // 227 KB: the most a block may opt in to

struct Model {
  const float* emb;  // [V, E]
  const void* W[MAX_LAYERS];  // [D_l, 4H], TW
  const void* U[MAX_LAYERS];  // [H, 4H], TW
  const float* b[MAX_LAYERS];  // [4H]
  const float* head_w;  // [H, V]
  const float* head_b;  // [V]
  int E, L, H;
  int es;     // bytes of an element of W and U: sizeof(TW)
  int lbf16;  // the logits rounded to bfloat16 (JAX's ldtype bfloat16)
};

// The launch plan (ops/cuda_decode.plan mirrors it)
struct Plan {
  int blocks;   // blocks of the launch (one per SM, or one cluster's)
  int cluster;  // 1: the launch is one cluster of `blocks`; 0: a grid
  int wsm;      // the layers' weight slices in shared memory
  int hsm;      // the heads' slices in shared memory
  int stage;    // d-rows of x the staging buffer holds at MAX_RT rows
  int rsm;      // the rows' latches in shared memory (else global scratch)
};

// [lo, hi) of part j of n split into `parts` balanced parts
__host__ __device__ __forceinline__ int split_at(int n, int parts, int j) {
  return (int)(((long long)n * j) / parts);
}

// a / b for 0 <= a < 2^16, 1 <= b < 2^12 by a float reciprocal (the
// half-unit offset keeps the quotient clear of rounding): the index maths
// of a pass sits on every step's critical path, where an integer division
// costs a chain of some twenty instructions
__device__ __forceinline__ int div_small(int a, int b) {
  return (int)__fdividef((float)a + 0.5f, (float)b);
}

// split_at where n * parts fits an int (a pass's rows of x over its
// k-slices, parts <= THREADS): by div_small where n * j < 2^16
__device__ __forceinline__ int split_small(int n, int parts, int j) {
  const int a = n * j;
  return a < 65536 ? div_small(a, parts) : a / parts;
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// n rounded up to a multiple of 4 (16 bytes of floats)
__host__ __device__ __forceinline__ size_t r4(size_t n) {
  return (n + 3) & ~(size_t)3;
}

// A block's slice of a model's layers (nu units), layer after layer: the
// weights [(D_l + H)][4nu] in TW, unit-major (the four gates of a unit side
// by side), from a 16-byte boundary, then the bias [4nu] in float.
// layer_wbytes is the weights' bytes of layer l (rounded up to 16),
// layers_bytes the whole slice's.
__host__ __device__ __forceinline__ size_t layer_wbytes(const Model& m, int nu,
                                                        int l) {
  return (((size_t)((l == 0 ? m.E : m.H) + m.H) * 4 * nu * m.es) + 15) &
         ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t layers_bytes(const Model& m,
                                                        int nu) {
  size_t n = 0;
  for (int l = 0; l < m.L; ++l) n += layer_wbytes(m, nu, l) + 16 * (size_t)nu;
  return n;
}

// floats of a block's head slice (nv columns: [H][nv] then the bias [nv])

__host__ __device__ __forceinline__ size_t head_floats(const Model& m,
                                                       int nv) {
  return (size_t)(m.H + 1) * nv;
}

// The head columns a block holds: all of them in a one-cluster launch (each
// block computes the whole head, so no partials cross blocks), else a
// balanced slice
__host__ __device__ __forceinline__ int head_cols(const Plan& p, int V) {
  return p.cluster ? V : ceil_div(V, p.blocks);
}

// Dynamic shared memory of a block, in the order the kernels carve it: the
// x staging buffer, the k-slices' partial sums, a tile's running argmax, the
// rows' latches (`fields` ints a row, where the plan keeps them on chip);
// for a one-cluster launch the state (copies[i] arrays of [L_i, B, H_i]
// floats for model i); then (where the plan says) each model's layer
// slice, then each model's head (slice), and for a one-cluster launch each
// model's embedding, sized for the largest slices.
__host__ __device__ __forceinline__ size_t window_smem_bytes(
    const Plan& p, const Model* models, const int* copies, int nmodels,
    int V, int B, int fields) {
  size_t floats = (size_t)p.stage * MAX_RT + THREADS * MAX_RT + 2 * MAX_RT;
  size_t bytes = 0;
  if (p.rsm) floats += r4((size_t)fields * B);
  for (int i = 0; i < nmodels; ++i) {
    const Model& m = models[i];
    if (p.cluster)
      floats += copies[i] * r4((size_t)m.L * B * m.H) + r4((size_t)V * m.E);
    if (p.wsm) bytes += layers_bytes(m, ceil_div(m.H, p.blocks));
    if (p.hsm) floats += r4(head_floats(m, head_cols(p, V)));
  }
  return sizeof(float) * floats + bytes;
}

struct Smem {
  float* xs;      // [stage * MAX_RT] x of a tile's chunk, [d][row]
  float* red;     // [THREADS * MAX_RT] partial sums, [k-slice][row][column]
  float* best_v;  // [MAX_RT] a tile's running argmax
  int* best_i;    // [MAX_RT]
  int stage;
  int cluster;    // blocks of the launch's one cluster (exchanged state in
                  // shared memory, written to every block), or 0
};

// A model's share in this block
struct Slice {
  int u0, nu;  // hidden units [u0, u0 + nu)
  int v0, nv;  // head columns [v0, v0 + nv)
  char* ws;    // layer l at ws + layer_off(m, nu, l) bytes (shared memory),
               // or null: global
  float* hs;   // the head slice (shared memory), or null: global
  float* es;   // the embedding (shared memory), or null: global
};

// The block's fixed shared memory; *tail is where the slices go
__device__ __forceinline__ Smem carve(float* base, const Plan& p,
                                      float** tail) {
  Smem sm;
  sm.stage = p.stage;
  sm.cluster = p.cluster ? p.blocks : 0;
  sm.xs = base;
  sm.red = sm.xs + (size_t)p.stage * MAX_RT;
  sm.best_v = sm.red + THREADS * MAX_RT;
  sm.best_i = (int*)(sm.best_v + MAX_RT);
  *tail = (float*)(sm.best_i + MAX_RT);
  return sm;
}

// n floats (or ints) of shared memory at *tail; every piece starts on 16
// bytes
__device__ __forceinline__ float* take(float** tail, size_t n) {
  float* p = *tail;
  *tail += r4(n);
  return p;
}

// n bytes (a multiple of 16) of shared memory at *tail
__device__ __forceinline__ char* take_bytes(float** tail, size_t n) {
  char* p = (char*)*tail;
  *tail += n / sizeof(float);
  return p;
}

// Exchanged state: in a one-cluster launch (kC) it lives in every block's
// shared memory (written to all of them, read locally), else in global
// memory (read through L2: L1 is not coherent with the other SMs' stores)
template <bool kC>
__device__ __forceinline__ float xload(const float* p) {
  return kC ? *p : __ldcg(p);
}

// A one-cluster launch: the new h of units [u0, u0 + nu) of the tile's
// rows (already in this block's copy of hnew, [B, H]) to every other
// block's copy, spread over all threads (a scalar store a thread and rank)
__device__ __forceinline__ void push_units(const Smem& sm, float* hnew, int H,
                                           int u0, int nu, int row0, int nr) {
  __syncthreads();
  const int others = sm.cluster - 1, me = blockIdx.x;
  const int n = nr * nu * others;
  for (int k = threadIdx.x; k < n; k += THREADS) {
    const int item = div_small(k, others);
    const int q = k - item * others;
    const int r = div_small(item, nu);
    float* p = hnew + (size_t)(row0 + r) * H + u0 + (item - r * nu);
    asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(
                     mapa_addr(smem_addr(p), q < me ? q : q + 1)),
                 "f"(*p)
                 : "memory");
  }
}

// The byte where layer l starts in a slice of nu units (layers_bytes'
// order): no array indexed at run time, so a Slice stays in registers and
// its pointers keep their shared address space
__device__ __forceinline__ size_t layer_off(const Model& m, int nu, int l) {
  return l == 0 ? 0
                : layer_wbytes(m, nu, 0) + 16 * (size_t)nu +
                      (size_t)(l - 1) * (layer_wbytes(m, nu, 1) + 16 * nu);
}

// A model's share in block blk, and its layer slice's place in shared
// memory when the plan keeps it there (room for the largest slice)
__device__ __forceinline__ Slice slice_of(const Model& m, const Plan& p, int V,
                                          int blk, float** tail) {
  Slice s;
  s.u0 = split_at(m.H, p.blocks, blk);
  s.nu = split_at(m.H, p.blocks, blk + 1) - s.u0;
  s.v0 = p.cluster ? 0 : split_at(V, p.blocks, blk);
  s.nv = p.cluster ? V : split_at(V, p.blocks, blk + 1) - s.v0;
  s.ws = nullptr;
  s.hs = nullptr;
  s.es = nullptr;
  if (p.wsm) s.ws = take_bytes(tail, layers_bytes(m, ceil_div(m.H, p.blocks)));
  return s;
}

// the head slice's place, after every model's layer slice, and in a
// one-cluster launch the embedding's
__device__ __forceinline__ void place_head(const Model& m, const Plan& p,
                                           int V, Slice& s, float** tail) {
  if (p.hsm) s.hs = take(tail, head_floats(m, head_cols(p, V)));
  if (p.cluster) s.es = take(tail, (size_t)V * m.E);
}

// n floats src -> dst (shared memory) by cp.async, all in flight at once:
// 16 bytes a copy where both are aligned, else 4; the caller waits
// (cp_async_wait_all and a block barrier). src is data no kernel of the
// call writes.
__device__ __forceinline__ void copy_in(float* dst, const float* src,
                                        size_t n) {
  size_t i0 = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    i0 = n & ~(size_t)3;
    for (size_t i = 4 * threadIdx.x; i < i0; i += 4 * THREADS)
      cp_async16(dst + i, src + i);
  }
  for (size_t i = i0 + threadIdx.x; i < n; i += THREADS)
    cp_async4(dst + i, src + i);
}

// Copy the slices the plan keeps on chip into shared memory, by cp.async
// (the caller waits; a bfloat16 weight, too small for cp.async, by a plain
// load and store, which the caller's block barrier publishes). A slice of a
// layer is a gather (unit-major: the four gates of a unit side by side): a
// warp per row of weights, lanes over the row's columns (coalesced, no
// division). The whole head and the embedding are contiguous copies.
template <typename TW>
__device__ __forceinline__ void load_slices(const Model& m, const Slice& s,
                                            int V) {
  const int H = m.H, G = 4 * H, nc = 4 * s.nu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (s.ws != nullptr) {
    for (int l = 0; l < m.L; ++l) {
      const int D = l == 0 ? m.E : H;
      const TW* W = (const TW*)m.W[l];
      const TW* U = (const TW*)m.U[l];
      const float* b = m.b[l];
      TW* dst = (TW*)(s.ws + layer_off(m, s.nu, l));
      float* bdst = (float*)((char*)dst + layer_wbytes(m, s.nu, l));
      const int rows = D + H + 1;  // the bias is row D + H
      for (int q = lane; q < nc; q += 32) {
        // column q of the slice's row: gate g of unit ul, stored at 4ul + g
        const int g = (q >= s.nu) + (q >= 2 * s.nu) + (q >= 3 * s.nu);
        const int ul = q - g * s.nu;
        const int col = g * H + s.u0 + ul;
        for (int d = warp; d < rows; d += NWARPS) {
          if (d == D + H) {
            cp_async4(bdst + 4 * ul + g, b + col);
            continue;
          }
          const TW* src = d < D ? W + (size_t)d * G + col
                                : U + (size_t)(d - D) * G + col;
          TW* to = dst + (size_t)d * nc + 4 * ul + g;
          if constexpr (sizeof(TW) == sizeof(float))
            cp_async4((float*)to, (const float*)src);
          else
            *to = *src;
        }
      }
    }
  }
  if (s.hs != nullptr) {  // [H][nv], then the bias as row H
    if (s.nv == V) {
      copy_in(s.hs, m.head_w, (size_t)H * V);
      copy_in(s.hs + (size_t)H * V, m.head_b, V);
    } else {
      for (int c = lane; c < s.nv; c += 32)
        for (int d = warp; d <= H; d += NWARPS)
          cp_async4(s.hs + (size_t)d * s.nv + c,
                    d < H ? m.head_w + (size_t)d * V + s.v0 + c
                          : m.head_b + s.v0 + c);
    }
  }
  if (s.es != nullptr) copy_in(s.es, m.emb, (size_t)V * m.E);
}

// argmax merge: larger value wins, equal values keep the lower index
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2,
                                             int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, ov, oi);
  }
}

// ---- the barrier between the blocks ----------------------------------------

struct Sync {
  int* count;  // arrivals (grid launch); zero at launch and at exit
  int* exit;   // blocks that left
  int blocks;
  int cluster;
  int n;  // barriers passed
};

__device__ __forceinline__ void sync_blocks(Sync& s) {
  if (s.cluster) {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n\t"
        "barrier.cluster.wait.acquire.aligned;" ::: "memory");
    return;
  }
  __syncthreads();
  if (s.blocks == 1) return;
  s.n += 1;
  if (threadIdx.x == 0) {
    arrive_count(s.count);
    wait_count(s.count, s.n * s.blocks);
  }
  __syncthreads();
}

// a one-cluster launch: every block has started before any block writes
// into another's shared memory
__device__ __forceinline__ void sync_start(const Sync& s) {
  if (s.cluster)
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n\t"
        "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the last block out zeroes the counters: every block has passed its last
// wait by then, so the next launch finds them at zero
__device__ __forceinline__ void sync_exit(Sync& s) {
  if (s.cluster || s.blocks == 1) return;
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(s.exit, 1) == s.blocks - 1) {
    atomicExch(s.count, 0);
    atomicExch(s.exit, 0);
  }
}

// ---- products --------------------------------------------------------------

enum { LD_SMEM = 0, LD_L2 = 1, LD_STREAM = 2 };

// L2 policies: the layers' weights should stay (evict last), the streamed
// head should leave first
__device__ __forceinline__ uint64_t l2_policy(int mode) {
  uint64_t pol;
  if (mode == LD_STREAM)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(pol));
  else
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(pol));
  return pol;
}

template <int MODE>
__device__ __forceinline__ float wload(const float* p, uint64_t pol) {
  if (MODE == LD_SMEM) return *p;
  float v;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v)
               : "l"(p), "l"(pol));
  return v;
}

// a bfloat16 weight as float (its bits are a float's upper half)
template <int MODE>
__device__ __forceinline__ float wload(const __nv_bfloat16* p, uint64_t pol) {
  if (MODE == LD_SMEM) return __bfloat162float(*p);
  unsigned short v;
  asm volatile("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;"
               : "=h"(v)
               : "l"(p), "l"(pol));
  return __uint_as_float((unsigned)v << 16);
}

// The four weights of row p (columns p, p + js, p + 2js, p + 3js; the first
// jn of them), as float. kVec: four neighbours in shared memory, one aligned
// load (16 bytes of float, 8 of bfloat16).
template <int MODE, bool kVec, typename TW>
__device__ __forceinline__ float4 w4(const TW* p, int js, int jn,
                                     uint64_t pol) {
  if (kVec) return load4(p);
  float4 q;
  q.x = wload<MODE>(p, pol);
  q.y = jn > 1 ? wload<MODE>(p + js, pol) : 0.0f;
  q.z = jn > 2 ? wload<MODE>(p + 2 * js, pol) : 0.0f;
  q.w = jn > 3 ? wload<MODE>(p + 3 * js, pol) : 0.0f;
  return q;
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 x, float4 w) {
  const float xr[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc[r][0] = fmaf(xr[r], w.x, acc[r][0]);
    acc[r][1] = fmaf(xr[r], w.y, acc[r][1]);
    acc[r][2] = fmaf(xr[r], w.z, acc[r][2]);
    acc[r][3] = fmaf(xr[r], w.w, acc[r][3]);
  }
}

// acc[r][j] += sum_{i < n} xs[i * RT + r] * w[i * stride + j * js] for the
// thread's four rows (xs points at them) and its first jn of four columns
// (jn >= 1), i in order. The main loop has no guards: UNR rows of weights
// and of x are loaded before any is used (16 weight loads in flight a
// thread from L2, 32 from device memory, 8 rows from shared memory), then
// a remainder loop.
template <int RT, int MODE, bool kVec, typename TW>
__device__ __forceinline__ void seg_dot(float (&acc)[4][4],
                                        const float* __restrict__ xs,
                                        const TW* w, size_t stride, int js,
                                        int jn, int n, uint64_t pol) {
  constexpr int UNR = MODE == LD_L2 ? 4 : 8;
  int i = 0;
  for (; i + UNR <= n; i += UNR) {
    float4 wq[UNR], xq[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u)
      wq[u] = w4<MODE, kVec>(w + (size_t)(i + u) * stride, js, jn, pol);
#pragma unroll
    for (int u = 0; u < UNR; ++u)
      xq[u] = *reinterpret_cast<const float4*>(xs + (i + u) * RT);
#pragma unroll
    for (int u = 0; u < UNR; ++u) fma4x4(acc, xq[u], wq[u]);
  }
  for (; i < n; ++i)
    fma4x4(acc, *reinterpret_cast<const float4*>(xs + i * RT),
           w4<MODE, kVec>(w + (size_t)i * stride, js, jn, pol));
}

// The weights a pass reads: rows [0, da) of a, then rows [da, ...) of b
template <typename TW>
struct WSrc {
  const TW* a;
  size_t sa;
  int da;
  const TW* b;
  size_t sb;
};

// The rows of x a pass multiplies: segment A (width da) is the embedding row
// of each row's token (emb; an id outside [0, V) gives the zero row, as the
// one-hot does) or a row of a; segment B (width db) a row of hb, if any
struct XSrc {
  const float* emb;
  const int* tok;
  int V;
  const float* a;
  int da;
  const float* hb;
  int db;
};

// xs[dd * RT + r] <- x[row0 + r][g0 + dd] for dd < len (rows past nr: 0),
// rounded to TW's precision (JAX's x.astype(w.dtype) before the product).
// Eight consecutive d of one row per eight lanes, so a warp reads whole
// sectors; THREADS is a multiple of 8 RT, so a thread keeps its row r for
// the whole chunk and looks its row up (token, row pointers) once, then
// walks d STEP apart, eight loads in flight.
template <int RT, bool kC, typename TW>
__device__ __forceinline__ void stage(const Smem& sm, const XSrc& s, int g0,
                                      int len, int row0, int nr) {
  constexpr int N = 8;
  constexpr int STEP = THREADS / RT;  // d apart, a thread's elements
  const int r = (threadIdx.x >> 3) % RT;
  const int dd0 = ((threadIdx.x >> 3) / RT) * 8 + (threadIdx.x & 7);
  const bool live = r < nr;
  const int row = row0 + r;
  const float* arow = nullptr;  // segment A's row (null: zeros)
  if (live) {
    if (s.emb == nullptr) {
      arow = s.a + (size_t)row * s.da;
    } else {
      const int t = s.tok[row];
      if (t >= 0 && t < s.V) arow = s.emb + (size_t)t * s.da;
    }
  }
  const float* brow =
      live && s.hb != nullptr ? s.hb + (size_t)row * s.db - s.da : nullptr;
  for (int d0 = dd0; d0 < len; d0 += N * STEP) {
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int d = d0 + j * STEP, g = g0 + d;
      const float* p = d >= len ? nullptr
                       : g < s.da ? (arow != nullptr ? arow + g : nullptr)
                                  : (brow != nullptr ? brow + g : nullptr);
      v[j] = p != nullptr ? xload<kC>(p) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int d = d0 + j * STEP;
      if (d < len) sm.xs[d * RT + r] = round_to<TW>(v[j]);
    }
  }
}

// The columns of a pass: nq quads of four, quad cq's columns at cbase +
// cq * cqs + j * js (j < 4), the first ncp of the 4 nq valid
struct Cols {
  int nq, cbase, cqs, js, ncp;
};

// One pass: thread (column quad cq, row quad rq, k-slice kg < ks) sums
// x[r] . w[:, col] over its slice of every chunk of the dtot rows of x, for
// its four rows and four columns, and leaves its partials in
// red[(kg * RT + r) * 4nq + 4cq + j]; returns ks (at most ksmax). *staged
// says the whole of x is already in xs (a single chunk staged by an earlier
// pass of the same tile, and of the same TW).
template <int RT, int MODE, bool kVec, bool kC, typename TW>
__device__ __forceinline__ int pass_products(const Smem& sm, const XSrc& xsrc,
                                             int dtot, const WSrc<TW>& w,
                                             const Cols& c, int ksmax,
                                             int row0, int nr, bool* staged) {
  const int cap = sm.stage * (MAX_RT / RT);
  const int slots = c.nq * (RT / 4);
  const int ks = min(div_small(THREADS, slots), ksmax);
  const int kg = div_small(threadIdx.x, slots);
  const int slot = threadIdx.x - kg * slots;
  const int rq = div_small(slot, c.nq), cq = slot - rq * c.nq;
  const int col = c.cbase + cq * c.cqs;
  const int jn = min(4, c.ncp - 4 * cq);
  const uint64_t pol = MODE == LD_SMEM ? 0 : l2_policy(MODE);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
  __syncthreads();  // the last pass's readers of xs and red are done
  for (int g0 = 0; g0 < dtot; g0 += cap) {
    const int len = min(cap, dtot - g0);
    if (!(*staged && len == dtot)) {
      if (g0 > 0) __syncthreads();
      stage<RT, kC, TW>(sm, xsrc, g0, len, row0, nr);
      __syncthreads();
    }
    if (kg < ks) {
      const int lo = split_small(len, ks, kg);
      const int hi = split_small(len, ks, kg + 1);
      const int glo = g0 + lo, ghi = g0 + hi;
      const float* xs = sm.xs + 4 * rq;
      const int ea = min(ghi, w.da);
      if (glo < ea)
        seg_dot<RT, MODE, kVec>(acc, xs + lo * RT,
                                w.a + (size_t)glo * w.sa + col, w.sa, c.js,
                                jn, ea - glo, pol);
      const int sb = max(glo, w.da);
      if (sb < ghi)
        seg_dot<RT, MODE, kVec>(acc, xs + (sb - g0) * RT,
                                w.b + (size_t)(sb - w.da) * w.sb + col, w.sb,
                                c.js, jn, ghi - sb, pol);
    }
  }
  *staged = dtot <= cap;
  if (kg < ks) {
    const int ncp4 = 4 * c.nq;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(sm.red + (kg * RT + 4 * rq + r) * ncp4 +
                                 4 * cq) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  return ks;
}

// ---- one layer -------------------------------------------------------------

// Layer l of model m for the tile's rows: this block's units, 64 a pass,
// a thread tile the four gates of one unit by four rows, then the cell
// update of those units: h of the unit to hnew ([B, H]), c in place in cbuf
// ([B, H]). A row whose emit flag is 0 keeps its h (copied from hold) and
// its c. emit null: every row emits.
template <int RT, bool kC, typename TW>
__device__ __forceinline__ void layer_tile(const Smem& sm, const Model& m,
                                           const Slice& s, int l,
                                           const XSrc& xsrc, const float* hold,
                                           const int* emit, float* cbuf,
                                           float* hnew, int row0, int nr) {
  const int H = m.H, D = l == 0 ? m.E : H;
  bool staged = false;
  for (int ua = 0; ua < s.nu; ua += PASS_UNITS) {
    const int nup = min(PASS_UNITS, s.nu - ua);
    const float* bias_s = nullptr;
    int ks;
    if (kC || s.ws != nullptr) {  // a one-cluster launch: on chip
      const char* wl = s.ws + layer_off(m, s.nu, l);
      const WSrc<TW> w{(const TW*)wl, (size_t)(4 * s.nu), D + H, nullptr, 0};
      ks = pass_products<RT, LD_SMEM, true, kC, TW>(
          sm, xsrc, D + H, w, Cols{nup, 4 * ua, 4, 1, 4 * nup}, KS_SMEM, row0,
          nr, &staged);
      bias_s = (const float*)(wl + layer_wbytes(m, s.nu, l)) + 4 * ua;
    } else {
      const WSrc<TW> w{(const TW*)m.W[l], (size_t)(4 * H), D,
                       (const TW*)m.U[l], (size_t)(4 * H)};
      ks = pass_products<RT, LD_L2, false, kC, TW>(
          sm, xsrc, D + H, w, Cols{nup, s.u0 + ua, 1, H, 4 * nup}, THREADS,
          row0, nr, &staged);
    }
    for (int i = threadIdx.x; i < nr * nup; i += THREADS) {
      const int r = div_small(i, nup), u = i - r * nup;
      float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int kg = 0; kg < ks; ++kg) {
        const float4 q = *reinterpret_cast<const float4*>(
            sm.red + (kg * RT + r) * 4 * nup + 4 * u);
        z.x += q.x, z.y += q.y, z.z += q.z, z.w += q.w;
      }
      float4 b;
      if (bias_s != nullptr) {
        b = *reinterpret_cast<const float4*>(bias_s + 4 * u);
      } else {
        const float* bl = m.b[l] + s.u0 + ua + u;
        b = make_float4(__ldg(bl), __ldg(bl + H), __ldg(bl + 2 * H),
                        __ldg(bl + 3 * H));
      }
      const int row = row0 + r;
      const size_t at = (size_t)row * H + s.u0 + ua + u;
      float h;
      if (emit == nullptr || emit[row]) {
        const float c = sigmoid_f(z.y + b.y) * cbuf[at] +
                        sigmoid_f(z.x + b.x) * tanhf(z.z + b.z);
        cbuf[at] = c;
        h = sigmoid_f(z.w + b.w) * tanhf(c);
      } else {
        h = xload<kC>(hold + at);
      }
      hnew[at] = h;
    }
    if (kC) push_units(sm, hnew, H, s.u0 + ua, nup, row0, nr);
  }
}

// Layer l for every row (tiles of MAX_RT rows)
template <bool kC, typename TW>
__device__ __forceinline__ void layer_rows(const Smem& sm, const Model& m,
                                           const Slice& s, int l,
                                           const XSrc& xsrc, const float* hold,
                                           const int* emit, float* cbuf,
                                           float* hnew, int B) {
  for (int row0 = 0; row0 < B; row0 += MAX_RT) {
    const int nr = min(MAX_RT, B - row0);
    if (nr <= 4)
      layer_tile<4, kC, TW>(sm, m, s, l, xsrc, hold, emit, cbuf, hnew, row0,
                               nr);
    else if (nr <= 8)
      layer_tile<8, kC, TW>(sm, m, s, l, xsrc, hold, emit, cbuf, hnew, row0,
                               nr);
    else
      layer_tile<16, kC, TW>(sm, m, s, l, xsrc, hold, emit, cbuf, hnew, row0,
                               nr);
  }
}

// The x source of layer l: the embedding rows of the tokens (l == 0; the
// block's copy in a one-cluster launch) or the new h of layer l - 1 (hprev,
// [B, H]); then the layer's old h (hold)
__device__ __forceinline__ XSrc layer_x(const Model& m, const Slice& s, int l,
                                        int V, const int* tok,
                                        const float* hprev, const float* hold) {
  XSrc x;
  x.emb = l > 0 ? nullptr : s.es != nullptr ? s.es : m.emb;
  x.tok = tok;
  x.V = V;
  x.a = hprev;
  x.da = l == 0 ? m.E : m.H;
  x.hb = hold;
  x.db = m.H;
  return x;
}

// ---- the head --------------------------------------------------------------

// The head (x [B, H] @ head_w + head_b) on this block's V slice for the
// tile's rows, and each row's best (value, index) of the slice into
// part_v / part_i [B][blocks] — or, in a one-cluster launch, where the
// block holds the whole head, each row's token into nx: greedy, or with
// kSampled the Gumbel-argmax argmax(logits / tdiv (if scale) + nz[row][v])
// (a template flag, so the greedy loop carries no sampling branch).
// Columns are walked in ascending order with a strict >, and merges keep the
// lower index among equal values, as jnp.argmax does. A block with no
// columns leaves (-inf, INT_MAX), which every real column beats.
template <int RT, bool kSampled, bool kC>
__device__ __forceinline__ void head_tile(const Smem& sm, const Model& m,
                                          const Slice& s, const float* x,
                                          int V, const float* nz, int scale,
                                          float tdiv, float* part_v,
                                          int* part_i, int* nx, int blk,
                                          int blocks, int row0, int nr) {
  const int H = m.H;
  const XSrc xsrc{nullptr, nullptr, 0, x, H, nullptr, 0};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bool staged = false;
  if (threadIdx.x < RT) {
    sm.best_v[threadIdx.x] = -INFINITY;
    sm.best_i[threadIdx.x] = INT_MAX;
  }
  for (int va = 0; va < s.nv; va += THREADS) {
    const int ncp = min(THREADS, s.nv - va), nq = ceil_div(ncp, 4);
    int ks;
    if (kC || s.hs != nullptr)
      ks = pass_products<RT, LD_SMEM, false, kC, float>(
          sm, xsrc, H, WSrc<float>{s.hs, (size_t)s.nv, H, nullptr, 0},
          Cols{nq, va, 4, 1, ncp}, KS_SMEM, row0, nr, &staged);
    else
      ks = pass_products<RT, LD_STREAM, false, kC, float>(
          sm, xsrc, H, WSrc<float>{m.head_w, (size_t)V, H, nullptr, 0},
          Cols{nq, s.v0 + va, 4, 1, ncp}, THREADS, row0, nr, &staged);
    for (int r = warp; r < nr; r += NWARPS) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int c = lane; c < ncp; c += 32) {
        float acc = 0.0f;
        for (int kg = 0; kg < ks; ++kg)
          acc += sm.red[(kg * RT + r) * 4 * nq + c];
        const int v = s.v0 + va + c;
        const float hb = s.hs != nullptr ? s.hs[(size_t)H * s.nv + va + c]
                                         : __ldg(m.head_b + v);
        float val = m.lbf16 ? round_to<__nv_bfloat16>(
                                  round_to<__nv_bfloat16>(acc) +
                                  round_to<__nv_bfloat16>(hb))
                            : acc + hb;
        if (kSampled) {
          if (scale) val = val / tdiv;
          val = val + nz[(size_t)(row0 + r) * V + v];
        }
        if (val > bv || bi == INT_MAX) {
          bv = val;
          bi = v;
        }
      }
      warp_argmax(bv, bi);
      if (lane == 0) argmax_merge(sm.best_v[r], sm.best_i[r], bv, bi);
    }
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    if (kC) {  // the whole head: the row's token
      nx[row0 + threadIdx.x] = sm.best_i[threadIdx.x];
    } else {
      const size_t at = (size_t)(row0 + threadIdx.x) * blocks + blk;
      part_v[at] = sm.best_v[threadIdx.x];
      part_i[at] = sm.best_i[threadIdx.x];
    }
  }
}

template <bool kSampled, bool kC>
__device__ __forceinline__ void head_rows(const Smem& sm, const Model& m,
                                          const Slice& s, const float* x,
                                          int V, const float* nz, int scale,
                                          float tdiv, float* part_v,
                                          int* part_i, int* nx, int blk,
                                          int blocks, int B) {
  for (int row0 = 0; row0 < B; row0 += MAX_RT) {
    const int nr = min(MAX_RT, B - row0);
    if (nr <= 4)
      head_tile<4, kSampled, kC>(sm, m, s, x, V, nz, scale, tdiv, part_v,
                                   part_i, nx, blk, blocks, row0, nr);
    else if (nr <= 8)
      head_tile<8, kSampled, kC>(sm, m, s, x, V, nz, scale, tdiv, part_v,
                                   part_i, nx, blk, blocks, row0, nr);
    else
      head_tile<16, kSampled, kC>(sm, m, s, x, V, nz, scale, tdiv, part_v,
                                   part_i, nx, blk, blocks, row0, nr);
  }
}

// After the head's barrier: every block merges the blocks' partials of each
// row into its token (nx[row]), the same way in every block
__device__ __forceinline__ void merge_rows(const float* part_v,
                                           const int* part_i, int blocks,
                                           int B, int* nx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < B; r += NWARPS) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = lane; j < blocks; j += 32) {
      const size_t at = (size_t)r * blocks + j;
      argmax_merge(bv, bi, __ldcg(part_v + at), __ldcg(part_i + at));
    }
    warp_argmax(bv, bi);
    if (lane == 0) nx[r] = bi;
  }
  __syncthreads();
}

// this block's units of a [L, B, H] state, all rows and layers: src -> dst
// (plain loads: src is an input, or state this block holds)
__device__ __forceinline__ void copy_units(float* dst, const float* src,
                                           const Model& m, const Slice& s,
                                           int B) {
  const int n = m.L * B * s.nu;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int lr = i / s.nu;
    const size_t at = (size_t)lr * m.H + s.u0 + (i - lr * s.nu);
    dst[at] = src[at];
  }
}

// ---- the launch ------------------------------------------------------------

// Launch `kernel` as the plan says: one cluster of p.blocks (the cluster's
// hardware barrier), or a cooperative grid of p.blocks (the counters need
// every block resident: the runtime runs the whole grid at once or refuses
// the launch).
// Opt `kernel` in to the most dynamic shared memory a block may have and to
// clusters of more than 8 blocks, once per device: the host's attribute
// calls cost more than a small window's launch. opted[dev] remembers it. A
// launch asking for more than the opt-in fails at launch (an error code).
template <typename Kernel>
static cudaError_t opt_in(Kernel kernel, bool* opted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (opted[dev]) return cudaSuccess;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  // the opt-in counts a build's static shared memory too
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM_BYTES - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) opted[dev] = true;
  return e;
}

template <typename Kernel, typename... Args>
static cudaError_t launch_window(Kernel kernel, const Plan& p, size_t smem,
                                 cudaStream_t stream, bool* opted,
                                 Args... args) {
  if (smem > MAX_SMEM_BYTES || p.blocks < 1) return cudaErrorInvalidValue;
  cudaError_t e = opt_in(kernel, opted);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (p.cluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// how many clusters of C blocks of `kernel`, each asking for smem bytes, the
// card keeps resident at once
template <typename Kernel>
static cudaError_t window_max_clusters(Kernel kernel, int C, int smem,
                                       int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

static Plan make_plan(int blocks, int cluster, int wsm, int hsm, int stage,
                      int rsm) {
  Plan p;
  p.blocks = blocks;
  p.cluster = cluster;
  p.wsm = wsm;
  p.hsm = hsm;
  p.stage = stage;
  p.rsm = rsm;
  return p;
}

static Model make_model(const void* emb, int E, int L, int H,
                        const void* const* Ws, const void* const* Us,
                        const void* const* bs, const void* head_w,
                        const void* head_b, int es, int lbf16) {
  Model m;
  m.emb = (const float*)emb;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    m.W[l] = l < L ? Ws[l] : nullptr;
    m.U[l] = l < L ? Us[l] : nullptr;
    m.b[l] = l < L ? (const float*)bs[l] : nullptr;
  }
  m.head_w = (const float*)head_w;
  m.head_b = (const float*)head_b;
  m.E = E;
  m.L = L;
  m.H = H;
  m.es = es;
  m.lbf16 = lbf16;
  return m;
}
