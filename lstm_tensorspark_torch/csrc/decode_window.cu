// Fused K-step decode window of an L-layer LSTM language model, for Hopper
// (sm_90a), in two forms: float32 (decode_window_launch) and bfloat16
// layers (decode_window_bf16_launch: W and U bfloat16 under bf16 compute,
// x and h rounded at the products, everything else float32; see
// decode_common.cuh). The bfloat16 form is built from this file as its own
// library (decode_window_bf16.cu defines WINDOW_BF16), so the two forms'
// builds run side by side.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_decode.py::_decode_window_kernel
// (its bfloat16 form: the same kernel at a bfloat16 w_ref.dtype, and its
// ldtype; lbf16 here).
// Per step and per live row: embedding row, L fused LSTM cells
// (z = x @ W + h @ U + b, gate order i, f, g, o), the head, greedy argmax or
// argmax(logits / max(t, 1e-6) + noise[k]), then the EOS / budget / alive
// latches of the JAX kernel, verbatim. A row dead at step entry emits
// PAD_TOKEN (-1), keeps its carries frozen and feeds token 0.
//
// What bounds it on the card: at serving batch sizes the work is a chain of
// matrix-vector products, far below the card's operations-per-byte ridge, so
// the least time is the weight bytes over memory bandwidth. The step body
// (decode_common.cuh) spreads every step over the blocks of the launch, each
// owning a slice of the hidden units and of the head's columns for all rows,
// so each weight is read once per step for the whole batch (once per window
// where the plan keeps the slices in shared memory). Each block keeps its own
// copy of the rows' latches (tok, alive, rem; in shared memory where they
// fit) and works out every row's token itself (the whole head in one
// cluster, the merge of the blocks' partials in a grid), so the copies agree
// and the loop ends in every block at the same step when no row is alive.
//
// Plain C interface for ctypes: decode_window_launch and
// decode_window_bf16_launch return the CUDA error code of the launch (0 =
// success). It allocates nothing and does not
// synchronise; it runs on the stream it is given. Scratch (h buffers, the
// head's partials, the rows' latches) comes from the wrapper; the barrier's
// two counters are zero before the launch and after it.

#include "decode_common.cuh"

// the rows' latches of a block: [4][B]
#define R_TOK 0
#define R_ALIVE 1
#define R_REM 2
#define R_NX 3
#define R_FIELDS 4

template <bool kC, typename TW>
__global__ void __launch_bounds__(THREADS, 1)
decode_window_kernel(Model m, Plan p, int V, int B, int K,
                     const float* __restrict__ h_in,
                     const float* __restrict__ c_in,
                     const int* __restrict__ tok_in,
                     const int* __restrict__ alive_in,
                     const int* __restrict__ rem_in,
                     const int* __restrict__ eos_in,
                     const float* __restrict__ noise, float tdiv, int scale,
                     int greedy, float* hbuf, float* part_v, int* part_i,
                     int* rows, int* counters,
                     int* __restrict__ toks_out, int* __restrict__ next_out,
                     int* __restrict__ alive_out, int* __restrict__ rem_out,
                     float* __restrict__ h_out, float* __restrict__ c_out) {
  extern __shared__ float4 smem4[];
  CLK_START
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int L = m.L, H = m.H;
  const size_t state = (size_t)L * B * H;
  float* tail;
  const Smem sm = carve((float*)smem4, p, &tail);
  int* rs = p.rsm ? (int*)take(&tail, (size_t)R_FIELDS * B)
                  : rows + (size_t)blk * R_FIELDS * B;
  // h of two steps and c: in global memory, or in every block of a
  // one-cluster launch
  float* cst = c_out;
  if (kC) {
    hbuf = take(&tail, 2 * state);
    cst = take(&tail, state);
  }
  Slice s = slice_of(m, p, V, blk, &tail);
  place_head(m, p, V, s, &tail);
  load_slices<TW>(m, s, V);
  Sync sync{counters, counters + 1, p.blocks, p.cluster, 0};
  int* tok = rs + R_TOK * B;
  int* alive = rs + R_ALIVE * B;
  int* rem = rs + R_REM * B;
  int* nx = rs + R_NX * B;

  int any = 0;
  for (int r = tid; r < B; r += THREADS) {
    tok[r] = tok_in[r];
    alive[r] = alive_in[r] != 0;
    rem[r] = rem_in[r];
    any |= alive[r];
  }
  copy_units(cst, c_in, m, s, B);
  // a one-cluster launch reads h from its own copy: step 0's old h is
  // buffer 1
  if (kC) copy_in(hbuf + state, h_in, state);
  cp_async_wait_all();
  any = __syncthreads_or(any);
  sync_start(sync);
  CLK_MARK(0)

  const float* hcur = kC ? hbuf + state : h_in;
  int k = 0;
  for (; k < K && any; ++k) {
    float* hnew = hbuf + (size_t)(k & 1) * state;
    for (int l = 0; l < L; ++l) {
      const XSrc x = layer_x(m, s, l, V, tok,
                             l > 0 ? hnew + (size_t)(l - 1) * B * H : nullptr,
                             hcur + (size_t)l * B * H);
      layer_rows<kC, TW>(sm, m, s, l, x, hcur + (size_t)l * B * H, alive,
                     cst + (size_t)l * B * H, hnew + (size_t)l * B * H, B);
      CLK_MARK(1)
      sync_blocks(sync);
      CLK_MARK(2)
    }
    const float* top = hnew + (size_t)(L - 1) * B * H;
    if (greedy)
      head_rows<false, kC>(sm, m, s, top, V, nullptr, 0, 1.0f, part_v,
                           part_i, nx, blk, p.blocks, B);
    else
      head_rows<true, kC>(sm, m, s, top, V, noise + (size_t)k * B * V, scale,
                          tdiv, part_v, part_i, nx, blk, p.blocks, B);
    CLK_MARK(3)
    if (!kC) {  // each block holds a slice of the head: merge the slices
      sync_blocks(sync);
      merge_rows(part_v, part_i, p.blocks, B, nx);
    }
    CLK_MARK(4)

    // the latch algebra of the JAX window, verbatim (emit == alive)
    any = 0;
    for (int r = tid; r < B; r += THREADS) {
      const int nxt = nx[r];
      const int emit = alive[r];
      if (blk == 0) toks_out[(size_t)k * B + r] = emit ? nxt : PAD_TOKEN;
      if (emit) {
        rem[r] -= 1;
        const int hit_eos = eos_in[r] >= 0 && nxt == eos_in[r];
        alive[r] = !hit_eos && rem[r] > 0;
      }
      tok[r] = alive[r] ? nxt : 0;
      any |= alive[r];
    }
    any = __syncthreads_or(any);
    CLK_MARK(5)
    hcur = hnew;
  }

  if (blk == 0) {
    // steps after every row died emit PAD
    for (int i = tid; i < (K - k) * B; i += THREADS)
      toks_out[(size_t)k * B + i] = PAD_TOKEN;
    for (int r = tid; r < B; r += THREADS) {
      next_out[r] = tok[r];
      alive_out[r] = alive[r];
      rem_out[r] = rem[r];
    }
  }
  copy_units(h_out, hcur, m, s, B);
  if (kC) copy_units(c_out, cst, m, s, B);
  sync_exit(sync);
}

// The arguments of both forms: the model (lbf16: the logits rounded to
// bfloat16), the carries and rows, the sampling, the plan, the scratch, the
// outputs, the stream
#define WINDOW_PARAMS                                                        \
  const void *emb, int V, int E, int L, int H, const void *const *Ws,        \
      const void *const *Us, const void *const *bs, const void *head_w,      \
      const void *head_b, int lbf16, const void *h_in, const void *c_in,     \
      const void *tok_in, const void *alive_in, const void *rem_in,          \
      const void *eos_in, const void *noise, int B, int K, float tdiv,       \
      int scale, int greedy, int blocks, int cluster, int wsm, int hsm,      \
      int stage, int rsm, void *hbuf, void *part_v, void *part_i, void *rows, \
      void *counters, void *toks_out, void *next_out, void *alive_out,       \
      void *rem_out, void *h_out, void *c_out, void *stream
#define WINDOW_ARGS                                                          \
  emb, V, E, L, H, Ws, Us, bs, head_w, head_b, lbf16, h_in, c_in, tok_in,    \
      alive_in, rem_in, eos_in, noise, B, K, tdiv, scale, greedy, blocks,    \
      cluster, wsm, hsm, stage, rsm, hbuf, part_v, part_i, rows, counters,   \
      toks_out, next_out, alive_out, rem_out, h_out, c_out, stream

template <typename TW>
static int launch_form(WINDOW_PARAMS) {
  if (L < 1 || L > MAX_LAYERS || B < 1 || K < 1 || H < 1 || E < 1 || V < 1 ||
      stage < 8)
    return (int)cudaErrorInvalidValue;
  if (!greedy && noise == nullptr) return (int)cudaErrorInvalidValue;
  const Model m = make_model(emb, E, L, H, Ws, Us, bs, head_w, head_b,
                             (int)sizeof(TW), lbf16);
  const Plan p = make_plan(blocks, cluster, wsm, hsm, stage, rsm);
  const int copies = 3;  // h of two steps, c
  const size_t smem = window_smem_bytes(p, &m, &copies, 1, V, B, R_FIELDS);
  // the one-cluster launch and the grid launch are two builds of the kernel
  auto kernel = p.cluster ? decode_window_kernel<true, TW>
                          : decode_window_kernel<false, TW>;
  static bool opted[2][64];  // by build (grid, one cluster) and device
  return (int)launch_window(
      kernel, p, smem, (cudaStream_t)stream, opted[p.cluster ? 1 : 0], m, p,
      V, B, K,
      (const float*)h_in, (const float*)c_in, (const int*)tok_in,
      (const int*)alive_in, (const int*)rem_in, (const int*)eos_in,
      (const float*)noise, tdiv, scale, greedy, (float*)hbuf,
      (float*)part_v, (int*)part_i, (int*)rows, (int*)counters,
      (int*)toks_out, (int*)next_out, (int*)alive_out, (int*)rem_out,
      (float*)h_out, (float*)c_out);
}

#ifdef WINDOW_BF16
extern "C" int decode_window_bf16_launch(WINDOW_PARAMS) {
  return launch_form<__nv_bfloat16>(WINDOW_ARGS);
}
#else
extern "C" int decode_window_launch(WINDOW_PARAMS) {
  return launch_form<float>(WINDOW_ARGS);
}

// clusters of C blocks of the window kernel at `smem` bytes each that the
// card keeps resident at once (the plan takes one-cluster launches only
// where this is at least 1)
extern "C" int decode_window_max_clusters(int C, int smem, int* out) {
  return (int)window_max_clusters(decode_window_kernel<true, float>, C, smem,
                                  out);
}
#endif  // WINDOW_BF16
