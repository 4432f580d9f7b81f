// One decode step of an L-layer LSTM language model inside one thread block,
// float32: the embedding row, L fused LSTM cells and the head's block argmax.
// Shared by decode_window.cu (the K-step decode window) and spec_window.cu
// (the speculative draft-and-verify window); both run one block per batch
// row with THREADS threads, the row's carries resident in shared memory.
//
// Every function is entered and left by all threads of the block together:
// each ends with __syncthreads(), so what it wrote to shared memory is
// visible to every thread on return.
//
// Math is expf / tanhf (no fast-math intrinsics) with f32 accumulation, so
// the kernels agree with their plain PyTorch versions to float32 rounding.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

#define MAX_LAYERS 8
#define THREADS 512
#define PAD_TOKEN (-1)
#define MAX_SMEM_BYTES 232448  // 227 KB: the most a block may opt in to

struct LayerPtrs {
  const float* W[MAX_LAYERS];  // [D_l, 4H]
  const float* U[MAX_LAYERS];  // [H, 4H]
  const float* b[MAX_LAYERS];  // [4H]
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// argmax merge: larger value wins, equal values keep the lower index
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// x_sh[0:E] <- embedding row of tok: a plain row copy (bit-identical to the
// one-hot matmul; an out-of-range id gives the zero row, as the one-hot does)
__device__ __forceinline__ void embed_row(const float* __restrict__ emb,
                                          int V, int E, int tok,
                                          float* x_sh) {
  const bool in_range = tok >= 0 && tok < V;
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    x_sh[e] = in_range ? emb[(size_t)tok * E + e] : 0.0f;
  __syncthreads();
}

// L fused LSTM cells (z = x @ W + h @ U + b, gate order i, f, g, o) on the
// carries h_sh / c_sh [L, H], updated in place; x_sh [E] is layer 0's input.
// Threads own gate columns j and stream W[d, j] / U[d, j] from global memory,
// coalesced across the warp. Returns the top layer's new h (in h_sh).
__device__ __forceinline__ const float* lstm_layers(
    const LayerPtrs& lp, int L, int H, int E, const float* x_sh,
    float* h_sh, float* c_sh, float* z_sh) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int G = 4 * H;
  const float* x = x_sh;
  int D = E;
  for (int l = 0; l < L; ++l) {
    const float* __restrict__ W = lp.W[l];
    const float* __restrict__ U = lp.U[l];
    const float* __restrict__ bias = lp.b[l];
    float* hl = h_sh + l * H;
    float* cl = c_sh + l * H;
    for (int j = tid; j < G; j += nthreads) {
      float zx = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) zx = fmaf(x[d], W[(size_t)d * G + j], zx);
      float zh = 0.0f;
#pragma unroll 8
      for (int d = 0; d < H; ++d) zh = fmaf(hl[d], U[(size_t)d * G + j], zh);
      z_sh[j] = (zx + zh) + bias[j];
    }
    __syncthreads();
    for (int j = tid; j < H; j += nthreads) {
      const float ig = sigmoid_f(z_sh[j]);
      const float fg = sigmoid_f(z_sh[H + j]);
      const float gg = tanhf(z_sh[2 * H + j]);
      const float og = sigmoid_f(z_sh[3 * H + j]);
      const float cn = fg * cl[j] + ig * gg;
      cl[j] = cn;
      hl[j] = og * tanhf(cn);
    }
    __syncthreads();
    x = hl;
    D = H;
  }
  return x;
}

// The head (x [H] @ head_w [H, V] + head_b) and the block argmax, returned to
// every thread: greedy, or with kSampled the Gumbel-argmax
// argmax(logits / tdiv (if scale) + nz[v]) (a template flag, so the greedy
// loop carries no sampling branch). The head strides threads over V; each
// thread walks its columns in ascending order, so a strict > keeps the lowest
// index among its own equal maxima, and the merges keep the lowest index
// among equal maxima across threads, as jnp.argmax does.
// red_v / red_i [THREADS / 32] and tok_sh are the block's scratch.
template <bool kSampled>
__device__ __forceinline__ int head_argmax(
    const float* x, int H, const float* __restrict__ head_w,
    const float* __restrict__ head_b, int V, const float* __restrict__ nz,
    int scale, float tdiv, float* red_v, int* red_i, int* tok_sh) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int v = tid; v < V; v += nthreads) {
    float acc = 0.0f;
#pragma unroll 8
    for (int d = 0; d < H; ++d) acc = fmaf(x[d], head_w[(size_t)d * V + v], acc);
    float val = acc + head_b[v];
    if (kSampled) {
      if (scale) val = val / tdiv;
      val = val + nz[v];
    }
    if (val > best_v || best_i == INT_MAX) {
      best_v = val;
      best_i = v;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    argmax_merge(best_v, best_i, ov, oi);
  }
  if ((tid & 31) == 0) {
    red_v[tid >> 5] = best_v;
    red_i[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid < 32) {
    const int nwarps = nthreads >> 5;
    best_v = tid < nwarps ? red_v[tid] : -INFINITY;
    best_i = tid < nwarps ? red_i[tid] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      argmax_merge(best_v, best_i, ov, oi);
    }
    if (tid == 0) *tok_sh = best_i;
  }
  __syncthreads();
  return *tok_sh;
}

// Opt the kernel in to `smem` bytes of dynamic shared memory when it needs
// more than the 48 KB default; refuses more than a block may have.
template <typename Kernel>
static cudaError_t opt_in_smem(Kernel kernel, size_t smem) {
  if (smem > MAX_SMEM_BYTES) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}
