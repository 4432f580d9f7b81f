// Fused K-step decode window of an L-layer LSTM language model, for Hopper
// (sm_90a), float32.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_decode.py::_decode_window_kernel.
// Per step and per live row: embedding row, L fused LSTM cells
// (z = x @ W + h @ U + b, gate order i, f, g, o), the head, greedy argmax or
// argmax(logits / max(t, 1e-6) + noise[k]), then the EOS / budget / alive
// latches of the JAX kernel, verbatim. A row dead at step entry emits
// PAD_TOKEN (-1), keeps its carries frozen and feeds token 0.
//
// What bounds it on the card: at serving batch sizes the work is a chain of
// matrix-vector products, far below the card's operations-per-byte ridge, so
// the least time is the weight bytes over memory bandwidth (each weight read
// once per window). This first design does not reach that: it is simple and
// exact first.
//   - One block per batch row (rows are independent during decode); the K
//     steps loop inside the block, so carries, x, the 4H pre-activations and
//     the latches never leave shared memory / registers during the window.
//   - Threads own gate columns j and stream W[d, j] / U[d, j] from global
//     memory, coalesced across the warp. Every row re-reads the weights each
//     step; config 1's ~0.55 MB stays in the 50 MB L2, larger models pay L2 or
//     HBM bandwidth per row-step (the known cost of this design; a later
//     kernel shares weight tiles across rows and steps).
//   - The head strides threads over V; the block argmax keeps the lowest index
//     among equal maxima, as jnp.argmax does.
// Math is expf / tanhf (no fast-math intrinsics) with f32 accumulation, so
// the kernel agrees with the plain PyTorch version to float32 rounding.
//
// Plain C interface for ctypes: decode_window_launch returns the CUDA error
// code of the launch (0 = success). It allocates nothing and does not
// synchronise; it runs on the stream it is given.

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

__global__ void __launch_bounds__(THREADS)
decode_window_kernel(const float* __restrict__ emb, int V, int E,
                     LayerPtrs lp, int L, int H,
                     const float* __restrict__ head_w,
                     const float* __restrict__ head_b,
                     const float* __restrict__ h_in,
                     const float* __restrict__ c_in,
                     const int* __restrict__ tok_in,
                     const int* __restrict__ alive_in,
                     const int* __restrict__ rem_in,
                     const int* __restrict__ eos_in,
                     const float* __restrict__ noise,
                     int B, int K, float tdiv, int scale, int greedy,
                     int* __restrict__ toks_out, int* __restrict__ next_out,
                     int* __restrict__ alive_out, int* __restrict__ rem_out,
                     float* __restrict__ h_out, float* __restrict__ c_out) {
  extern __shared__ float smem[];
  __shared__ float red_v[THREADS / 32];
  __shared__ int red_i[THREADS / 32];
  __shared__ int tok_sh;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int G = 4 * H;
  float* x_sh = smem;           // [E]     layer-0 input (embedding row)
  float* h_sh = x_sh + E;       // [L, H]  carries, resident for the window
  float* c_sh = h_sh + L * H;   // [L, H]
  float* z_sh = c_sh + L * H;   // [4H]    pre-activations of one layer

  for (int i = tid; i < L * H; i += nthreads) {
    const int l = i / H, j = i - l * H;
    const size_t g = ((size_t)l * B + row) * H + j;
    h_sh[i] = h_in[g];
    c_sh[i] = c_in[g];
  }
  int tok = tok_in[row];
  int alive = alive_in[row] != 0;
  int rem = rem_in[row];
  const int eos = eos_in[row];
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    if (!alive) {
      // uniform across the block (one block = one row): a dead row emits
      // PAD, commits nothing and feeds token 0 onward
      if (tid == 0) toks_out[(size_t)k * B + row] = PAD_TOKEN;
      tok = 0;
      continue;
    }
    // embedding row: a plain row copy (bit-identical to the one-hot matmul;
    // an out-of-range id gives the zero row, as the one-hot does)
    const bool in_range = tok >= 0 && tok < V;
    for (int e = tid; e < E; e += nthreads)
      x_sh[e] = in_range ? emb[(size_t)tok * E + e] : 0.0f;
    __syncthreads();

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
      // the row is alive at step entry, so the update commits
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

    // head + sampler; each thread walks its columns in ascending order, so a
    // strict > keeps the lowest index among its own equal maxima
    float best_v = -INFINITY;
    int best_i = INT_MAX;
    const float* nz = greedy ? nullptr : noise + ((size_t)k * B + row) * V;
    for (int v = tid; v < V; v += nthreads) {
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < H; ++d) acc = fmaf(x[d], head_w[(size_t)d * V + v], acc);
      float val = acc + head_b[v];
      if (!greedy) {
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
      if (tid == 0) tok_sh = best_i;
    }
    __syncthreads();
    const int nxt = tok_sh;

    // the latch algebra of the JAX window, verbatim (emit == alive here)
    if (tid == 0) toks_out[(size_t)k * B + row] = nxt;
    rem -= 1;
    const bool hit_eos = (eos >= 0) && (nxt == eos);
    alive = (!hit_eos) && (rem > 0);
    tok = alive ? nxt : 0;
  }

  if (tid == 0) {
    next_out[row] = tok;
    alive_out[row] = alive;
    rem_out[row] = rem;
  }
  for (int i = tid; i < L * H; i += nthreads) {
    const int l = i / H, j = i - l * H;
    const size_t g = ((size_t)l * B + row) * H + j;
    h_out[g] = h_sh[i];
    c_out[g] = c_sh[i];
  }
}

static size_t smem_bytes(int L, int H, int E) {
  return sizeof(float) * ((size_t)E + 2 * (size_t)L * H + 4 * (size_t)H);
}

extern "C" int decode_window_launch(
    const void* emb, int V, int E, int L, int H,
    const void* const* Ws, const void* const* Us, const void* const* bs,
    const void* head_w, const void* head_b,
    const void* h_in, const void* c_in,
    const void* tok_in, const void* alive_in, const void* rem_in,
    const void* eos_in, const void* noise,
    int B, int K, float tdiv, int scale, int greedy,
    void* toks_out, void* next_out, void* alive_out, void* rem_out,
    void* h_out, void* c_out, void* stream) {
  if (L < 1 || L > MAX_LAYERS || B < 1 || K < 1 || H < 1 || E < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  if (!greedy && noise == nullptr) return (int)cudaErrorInvalidValue;
  LayerPtrs lp;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    lp.W[l] = l < L ? (const float*)Ws[l] : nullptr;
    lp.U[l] = l < L ? (const float*)Us[l] : nullptr;
    lp.b[l] = l < L ? (const float*)bs[l] : nullptr;
  }
  const size_t smem = smem_bytes(L, H, E);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_window_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)emb, V, E, lp, L, H, (const float*)head_w,
      (const float*)head_b, (const float*)h_in, (const float*)c_in,
      (const int*)tok_in, (const int*)alive_in, (const int*)rem_in,
      (const int*)eos_in, (const float*)noise, B, K, tdiv, scale, greedy,
      (int*)toks_out, (int*)next_out, (int*)alive_out, (int*)rem_out,
      (float*)h_out, (float*)c_out);
  return (int)cudaGetLastError();
}
