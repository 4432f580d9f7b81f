// Fused speculative greedy window of two L-layer LSTM language models (the
// target and a small draft sharing its vocabulary), for Hopper (sm_90a),
// float32.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_decode.py::_spec_window_kernel
// (its per-model step is _model_step there, decode_common.cuh here). Per live
// row, with k_draft = K and W = K + 1:
//   1. propose: the draft decodes K greedy tokens from a COPY of its
//      committed carries, fed its own argmax each step. The copy is
//      discarded at the end of the phase.
//   2. verify: W joint teacher-forced steps on [token, proposals...]. The
//      target steps with its head (t = argmax); the draft steps on the same
//      input from its committed carries, without a head (the JAX kernel
//      discards those logits). Both models' carries commit on the same emit
//      mask, so the verify pass IS the draft's state commit. Latches:
//        - window latch: a step emits while the window is alive; it stays
//          alive only when the session lives on AND proposal i equals t;
//          the last step (i == K) always closes it;
//        - session latch: EOS and budget only (a draft miss ends the window,
//          never the session);
//        - rem falls and final_tok updates only on emitting steps;
//          next = session alive ? final_tok : 0.
//      So a row emits the longest agreeing prefix of the proposals plus the
//      target's own correction: the plain greedy sequence, whatever the
//      draft. A row dead at entry emits PAD_TOKEN (-1) W times and leaves
//      all four carry arrays bitwise unchanged.
//
// What bounds it on the card: like the decode window, a chain of K + W
// dependent matrix-vector steps per row, far below the card's
// operations-per-byte ridge; the least time is both models' weight bytes
// over memory bandwidth. This first design is simple and exact first: one
// block per batch row, the whole window in the block, the carries (target
// h, c; draft committed h, c; the draft's propose-phase copy), x, z, the
// proposals and the latches never leave shared memory / registers. Weights
// stream from global memory each row-step, as in decode_window.cu: config
// 1's two models (~0.6 MB) stay in L2; at config 3's width every row-step
// pays L2 / HBM bandwidth on one SM (the known cost of this design).
//
// Plain C interface for ctypes: spec_window_launch returns the CUDA error
// code of the launch (0 = success). It allocates nothing and does not
// synchronise; it runs on the stream it is given.

#include "decode_common.cuh"

struct ModelPtrs {
  const float* emb;     // [V, E]
  LayerPtrs lp;         // L fused layers
  const float* head_w;  // [H, V]
  const float* head_b;  // [V]
  int E, L, H;
};

__global__ void __launch_bounds__(THREADS)
spec_window_kernel(ModelPtrs tm, ModelPtrs dm, int V, int B, int K,
                   const float* __restrict__ h_in,
                   const float* __restrict__ c_in,
                   const float* __restrict__ dh_in,
                   const float* __restrict__ dc_in,
                   const int* __restrict__ tok_in,
                   const int* __restrict__ alive_in,
                   const int* __restrict__ rem_in,
                   const int* __restrict__ eos_in,
                   int* __restrict__ toks_out, int* __restrict__ next_out,
                   int* __restrict__ alive_out, int* __restrict__ rem_out,
                   float* __restrict__ h_out, float* __restrict__ c_out,
                   float* __restrict__ dh_out, float* __restrict__ dc_out) {
  extern __shared__ float smem[];
  __shared__ float red_v[THREADS / 32];
  __shared__ int red_i[THREADS / 32];
  __shared__ int tok_sh;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int L = tm.L, H = tm.H, Ld = dm.L, Hd = dm.H;
  const int W = K + 1;
  const int Emax = tm.E > dm.E ? tm.E : dm.E;
  const int Hmax = H > Hd ? H : Hd;
  float* x_sh = smem;                      // [max(E, Ed)] a model's input
  float* h_sh = x_sh + Emax;               // [L, H]   target carries
  float* c_sh = h_sh + L * H;              // [L, H]
  float* dh_sh = c_sh + L * H;             // [Ld, Hd] draft, committed
  float* dc_sh = dh_sh + Ld * Hd;          // [Ld, Hd]
  float* ph_sh = dc_sh + Ld * Hd;          // [Ld, Hd] draft, propose copy
  float* pc_sh = ph_sh + Ld * Hd;          // [Ld, Hd]
  float* z_sh = pc_sh + Ld * Hd;           // [4 max(H, Hd)]
  int* props = (int*)(z_sh + 4 * Hmax);    // [K]      proposals

  for (int i = tid; i < L * H; i += nthreads) {
    const int l = i / H, j = i - l * H;
    const size_t g = ((size_t)l * B + row) * H + j;
    h_sh[i] = h_in[g];
    c_sh[i] = c_in[g];
  }
  for (int i = tid; i < Ld * Hd; i += nthreads) {
    const int l = i / Hd, j = i - l * Hd;
    const size_t g = ((size_t)l * B + row) * Hd + j;
    dh_sh[i] = ph_sh[i] = dh_in[g];
    dc_sh[i] = pc_sh[i] = dc_in[g];
  }
  const int tok = tok_in[row];
  const bool alive = alive_in[row] != 0;
  int rem = rem_in[row];
  const int eos = eos_in[row];
  bool sess_alive = alive;
  int final_tok = tok;
  __syncthreads();

  if (alive) {  // uniform across the block (one block = one row)
    // phase 1: the draft proposes K tokens from the propose-phase copy
    int ptok = tok;
    for (int i = 0; i < K; ++i) {
      embed_row(dm.emb, V, dm.E, ptok, x_sh);
      const float* x = lstm_layers(dm.lp, Ld, Hd, dm.E, x_sh, ph_sh, pc_sh,
                                   z_sh);
      ptok = head_argmax<false>(x, Hd, dm.head_w, dm.head_b, V, nullptr, 0,
                                1.0f, red_v, red_i, &tok_sh);
      if (tid == 0) props[i] = ptok;
    }
    __syncthreads();

    // phase 2: W joint teacher-forced verify steps; a step runs only while
    // the window latch is alive, i.e. only steps that emit and commit
    for (int i = 0; i < W; ++i) {
      const int inp = i == 0 ? tok : props[i - 1];
      embed_row(tm.emb, V, tm.E, inp, x_sh);
      const float* x = lstm_layers(tm.lp, L, H, tm.E, x_sh, h_sh, c_sh, z_sh);
      const int t = head_argmax<false>(x, H, tm.head_w, tm.head_b, V,
                                       nullptr, 0, 1.0f, red_v, red_i,
                                       &tok_sh);
      embed_row(dm.emb, V, dm.E, inp, x_sh);
      lstm_layers(dm.lp, Ld, Hd, dm.E, x_sh, dh_sh, dc_sh, z_sh);

      if (tid == 0) toks_out[(size_t)i * B + row] = t;
      rem -= 1;
      const bool hit_eos = (eos >= 0) && (t == eos);
      sess_alive = (!hit_eos) && (rem > 0);
      final_tok = t;
      // past the last proposal nothing can agree: the window closes
      if (!(sess_alive && i < K && props[i] == t)) {
        for (int j = i + 1 + tid; j < W; j += nthreads)
          toks_out[(size_t)j * B + row] = PAD_TOKEN;
        break;
      }
    }
  } else {
    for (int j = tid; j < W; j += nthreads)
      toks_out[(size_t)j * B + row] = PAD_TOKEN;
  }

  if (tid == 0) {
    next_out[row] = sess_alive ? final_tok : 0;
    alive_out[row] = sess_alive;
    rem_out[row] = rem;
  }
  for (int i = tid; i < L * H; i += nthreads) {
    const int l = i / H, j = i - l * H;
    const size_t g = ((size_t)l * B + row) * H + j;
    h_out[g] = h_sh[i];
    c_out[g] = c_sh[i];
  }
  for (int i = tid; i < Ld * Hd; i += nthreads) {
    const int l = i / Hd, j = i - l * Hd;
    const size_t g = ((size_t)l * B + row) * Hd + j;
    dh_out[g] = dh_sh[i];
    dc_out[g] = dc_sh[i];
  }
}

static size_t smem_bytes(int E, int L, int H, int Ed, int Ld, int Hd, int K) {
  const size_t floats = (size_t)(E > Ed ? E : Ed) + 2 * (size_t)L * H +
                        4 * (size_t)Ld * Hd + 4 * (size_t)(H > Hd ? H : Hd);
  return sizeof(float) * floats + sizeof(int) * (size_t)K;
}

static ModelPtrs model_ptrs(const void* emb, int E, int L, int H,
                            const void* const* Ws, const void* const* Us,
                            const void* const* bs, const void* head_w,
                            const void* head_b) {
  ModelPtrs m;
  m.emb = (const float*)emb;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    m.lp.W[l] = l < L ? (const float*)Ws[l] : nullptr;
    m.lp.U[l] = l < L ? (const float*)Us[l] : nullptr;
    m.lp.b[l] = l < L ? (const float*)bs[l] : nullptr;
  }
  m.head_w = (const float*)head_w;
  m.head_b = (const float*)head_b;
  m.E = E;
  m.L = L;
  m.H = H;
  return m;
}

extern "C" int spec_window_launch(
    int V,
    const void* emb, int E, int L, int H,
    const void* const* Ws, const void* const* Us, const void* const* bs,
    const void* head_w, const void* head_b,
    const void* demb, int Ed, int Ld, int Hd,
    const void* const* dWs, const void* const* dUs, const void* const* dbs,
    const void* dhead_w, const void* dhead_b,
    const void* h_in, const void* c_in, const void* dh_in, const void* dc_in,
    const void* tok_in, const void* alive_in, const void* rem_in,
    const void* eos_in, int B, int K,
    void* toks_out, void* next_out, void* alive_out, void* rem_out,
    void* h_out, void* c_out, void* dh_out, void* dc_out, void* stream) {
  if (L < 1 || L > MAX_LAYERS || Ld < 1 || Ld > MAX_LAYERS || B < 1 ||
      K < 1 || H < 1 || E < 1 || Hd < 1 || Ed < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  const ModelPtrs tm = model_ptrs(emb, E, L, H, Ws, Us, bs, head_w, head_b);
  const ModelPtrs dm = model_ptrs(demb, Ed, Ld, Hd, dWs, dUs, dbs, dhead_w,
                                  dhead_b);
  const size_t smem = smem_bytes(E, L, H, Ed, Ld, Hd, K);
  const cudaError_t e = opt_in_smem(spec_window_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  spec_window_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      tm, dm, V, B, K, (const float*)h_in, (const float*)c_in,
      (const float*)dh_in, (const float*)dc_in, (const int*)tok_in,
      (const int*)alive_in, (const int*)rem_in, (const int*)eos_in,
      (int*)toks_out, (int*)next_out, (int*)alive_out, (int*)rem_out,
      (float*)h_out, (float*)c_out, (float*)dh_out, (float*)dc_out);
  return (int)cudaGetLastError();
}
