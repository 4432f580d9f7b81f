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
// The step body (embedding row, cells, head, block argmax) is
// decode_common.cuh's, shared with spec_window.cu. Math is expf / tanhf (no
// fast-math intrinsics) with f32 accumulation, so the kernel agrees with the
// plain PyTorch version to float32 rounding.
//
// Plain C interface for ctypes: decode_window_launch returns the CUDA error
// code of the launch (0 = success). It allocates nothing and does not
// synchronise; it runs on the stream it is given.

#include "decode_common.cuh"

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
    embed_row(emb, V, E, tok, x_sh);
    // the row is alive at step entry, so the layers' updates commit
    const float* x = lstm_layers(lp, L, H, E, x_sh, h_sh, c_sh, z_sh);
    const int nxt =
        greedy ? head_argmax<false>(x, H, head_w, head_b, V, nullptr, 0,
                                    1.0f, red_v, red_i, &tok_sh)
               : head_argmax<true>(x, H, head_w, head_b, V,
                                   noise + ((size_t)k * B + row) * V, scale,
                                   tdiv, red_v, red_i, &tok_sh);

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
  const cudaError_t e = opt_in_smem(decode_window_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  decode_window_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)emb, V, E, lp, L, H, (const float*)head_w,
      (const float*)head_b, (const float*)h_in, (const float*)c_in,
      (const int*)tok_in, (const int*)alive_in, (const int*)rem_in,
      (const int*)eos_in, (const float*)noise, B, K, tdiv, scale, greedy,
      (int*)toks_out, (int*)next_out, (int*)alive_out, (int*)rem_out,
      (float*)h_out, (float*)c_out);
  return (int)cudaGetLastError();
}
