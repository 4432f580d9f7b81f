// Fused speculative greedy window of two L-layer LSTM language models (the
// target and a small draft sharing its vocabulary), for Hopper (sm_90a), in
// two forms: float32 (spec_window_launch) and bfloat16 layers
// (spec_window_bf16_launch: both models' W and U bfloat16 under bf16
// compute, x and h rounded at the products, everything else float32; see
// decode_common.cuh). The bfloat16 form is built from this file as its own
// library (spec_window_bf16.cu defines WINDOW_BF16), so the two forms'
// builds run side by side.
//
// Replaces lstm_tensorspark_tpu/ops/pallas_decode.py::_spec_window_kernel
// (its per-model step is _model_step there, decode_common.cuh here; the
// target's ldtype and the draft's dldtype are each model's lbf16). For the
// batch, with k_draft = K and W = K + 1:
//   1. propose: the draft decodes K greedy tokens from a COPY of its
//      committed carries, fed its own argmax each step. The copy is
//      discarded at the end of the phase.
//   2. verify: W joint teacher-forced steps on [token, proposals...]. The
//      target steps with its head (t = argmax); the draft steps on the same
//      input from its committed carries, without a head (the JAX kernel
//      discards those logits). Both models' carries commit on the same
//      per-row emit mask (the row's window latch), so the verify pass IS the
//      draft's state commit. Latches:
//        - window latch: a step emits while the window is alive; it stays
//          alive only when the session lives on AND proposal i equals t;
//          the last step (i == K) always closes it;
//        - session latch: EOS and budget only (a draft miss ends the window,
//          never the session);
//        - rem falls and final_tok updates only on emitting steps;
//          next = session alive ? final_tok : 0.
//      So a row emits the longest agreeing prefix of the proposals plus the
//      target's own correction: the plain greedy sequence, whatever the
//      draft. Rows close their windows at different steps; the loop ends
//      when no row's window is alive. A row dead at entry emits PAD_TOKEN
//      (-1) W times and leaves all four carry arrays bitwise unchanged.
//
// What bounds it on the card: like the decode window, a chain of K + W
// dependent matrix-vector steps, far below the card's operations-per-byte
// ridge; the least time is both models' weight bytes over memory bandwidth.
// The step body is decode_common.cuh's: every block owns a slice of both
// models' units and of both heads' columns for all rows, so each weight is
// read once per step for the whole batch (once per window where the plan
// keeps the slices in shared memory: config 1 and its draft). A verify step
// runs the target's and the draft's layer l in the same phase (they take
// the same input), so it costs max(L, Ld) + 1 barriers; a propose step
// Ld + 1.
//
// Plain C interface for ctypes: spec_window_launch and
// spec_window_bf16_launch return the CUDA error code of the launch (0 =
// success). It allocates nothing and does not
// synchronise; it runs on the stream it is given. Scratch comes from the
// wrapper; the barrier's two counters are zero before the launch and after.

#include "decode_common.cuh"

// the rows' latches of a block: [S_FIELDS + K][B]
#define S_TOK 0    // the token at entry
#define S_WIN 1    // the window latch (the verify step's emit mask)
#define S_SESS 2   // the session latch
#define S_REM 3
#define S_FINAL 4  // the last emitted token
#define S_PTOK 5   // the propose phase's input
#define S_INP 6    // the verify step's input
#define S_NX 7     // the merged argmax
#define S_FIELDS 8  // then the K proposals

template <bool kC, typename TW>
__global__ void __launch_bounds__(THREADS, 1)
spec_window_kernel(Model tm, Model dm, Plan p, int V, int B, int K,
                   const float* __restrict__ h_in,
                   const float* __restrict__ c_in,
                   const float* __restrict__ dh_in,
                   const float* __restrict__ dc_in,
                   const int* __restrict__ tok_in,
                   const int* __restrict__ alive_in,
                   const int* __restrict__ rem_in,
                   const int* __restrict__ eos_in, float* hbuf, float* dbuf,
                   float* pbuf, float* pc, float* part_v, int* part_i,
                   int* rows, int* counters,
                   int* __restrict__ toks_out, int* __restrict__ next_out,
                   int* __restrict__ alive_out, int* __restrict__ rem_out,
                   float* __restrict__ h_out, float* __restrict__ c_out,
                   float* __restrict__ dh_out, float* __restrict__ dc_out) {
  extern __shared__ float4 smem4[];
  CLK_START
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int L = tm.L, H = tm.H, Ld = dm.L, Hd = dm.H;
  const size_t tstate = (size_t)L * B * H, dstate = (size_t)Ld * B * Hd;
  const int W = K + 1;
  float* tail;
  const Smem sm = carve((float*)smem4, p, &tail);
  int* rs = p.rsm ? (int*)take(&tail, (size_t)(S_FIELDS + K) * B)
                  : rows + (size_t)blk * (S_FIELDS + K) * B;
  // the exchanged state: in global memory, or in every block of a
  // one-cluster launch
  float* cst = c_out;
  float* dcst = dc_out;
  if (kC) {
    hbuf = take(&tail, 2 * tstate);
    cst = take(&tail, tstate);
    dbuf = take(&tail, 2 * dstate);
    dcst = take(&tail, dstate);
    pbuf = take(&tail, 2 * dstate);
    pc = take(&tail, dstate);
  }
  Slice ts = slice_of(tm, p, V, blk, &tail);
  Slice ds = slice_of(dm, p, V, blk, &tail);
  place_head(tm, p, V, ts, &tail);
  place_head(dm, p, V, ds, &tail);
  load_slices<TW>(tm, ts, V);
  load_slices<TW>(dm, ds, V);
  Sync sync{counters, counters + 1, p.blocks, p.cluster, 0};
  int* tok = rs + S_TOK * B;
  int* win = rs + S_WIN * B;
  int* sess = rs + S_SESS * B;
  int* rem = rs + S_REM * B;
  int* fin = rs + S_FINAL * B;
  int* ptok = rs + S_PTOK * B;
  int* inp = rs + S_INP * B;
  int* nx = rs + S_NX * B;
  int* props = rs + S_FIELDS * B;  // [K][B]

  int any = 0;
  for (int r = tid; r < B; r += THREADS) {
    tok[r] = fin[r] = ptok[r] = inp[r] = tok_in[r];
    win[r] = sess[r] = alive_in[r] != 0;
    rem[r] = rem_in[r];
    any |= win[r];
  }
  copy_units(cst, c_in, tm, ts, B);
  copy_units(dcst, dc_in, dm, ds, B);
  copy_units(pc, dc_in, dm, ds, B);  // the propose phase's c
  // a one-cluster launch reads h from its own copies: each phase's first
  // old h is buffer 1
  if (kC) {
    copy_in(hbuf + tstate, h_in, tstate);
    copy_in(dbuf + dstate, dh_in, dstate);
    copy_in(pbuf + dstate, dh_in, dstate);
  }
  CLK_MARK(0)
  cp_async_wait_all();
  any = __syncthreads_or(any);
  sync_start(sync);
  CLK_MARK(1)

  const float* hcur = kC ? hbuf + tstate : h_in;
  const float* dcur = kC ? dbuf + dstate : dh_in;
  int i = 0;  // verify steps run
  if (any) {
    // phase 1: the draft proposes K tokens from the propose-phase copy
    const float* pcur = kC ? pbuf + dstate : dh_in;
    for (int j = 0; j < K; ++j) {
      float* pnew = pbuf + (size_t)(j & 1) * dstate;
      for (int l = 0; l < Ld; ++l) {
        const float* prev = l > 0 ? pnew + (size_t)(l - 1) * B * Hd : nullptr;
        const XSrc x =
            layer_x(dm, ds, l, V, ptok, prev, pcur + (size_t)l * B * Hd);
        layer_rows<kC, TW>(sm, dm, ds, l, x, pcur + (size_t)l * B * Hd, nullptr,
                       pc + (size_t)l * B * Hd, pnew + (size_t)l * B * Hd,
                       B);
        CLK_MARK(2)
        sync_blocks(sync);
        CLK_MARK(3)
      }
      head_rows<false, kC>(sm, dm, ds, pnew + (size_t)(Ld - 1) * B * Hd, V,
                           nullptr, 0, 1.0f, part_v, part_i, nx, blk,
                           p.blocks, B);
      CLK_MARK(4)
      if (!kC) {
        sync_blocks(sync);
        merge_rows(part_v, part_i, p.blocks, B, nx);
      }
      CLK_MARK(5)
      for (int r = tid; r < B; r += THREADS)
        ptok[r] = props[(size_t)j * B + r] = nx[r];
      __syncthreads();
      CLK_MARK(6)
      pcur = pnew;
    }

    // phase 2: W joint teacher-forced verify steps, while any row's window
    // is alive; rows whose window closed keep their carries
    for (; i < W && any; ++i) {
      float* hnew = hbuf + (size_t)(i & 1) * tstate;
      float* dnew = dbuf + (size_t)(i & 1) * dstate;
      for (int l = 0; l < (L > Ld ? L : Ld); ++l) {
        if (l < L) {
          const float* prev = l > 0 ? hnew + (size_t)(l - 1) * B * H : nullptr;
          const XSrc x =
              layer_x(tm, ts, l, V, inp, prev, hcur + (size_t)l * B * H);
          layer_rows<kC, TW>(sm, tm, ts, l, x, hcur + (size_t)l * B * H, win,
                         cst + (size_t)l * B * H, hnew + (size_t)l * B * H,
                         B);
        }
        CLK_MARK(7)
        if (l < Ld) {
          const float* prev =
              l > 0 ? dnew + (size_t)(l - 1) * B * Hd : nullptr;
          const XSrc x =
              layer_x(dm, ds, l, V, inp, prev, dcur + (size_t)l * B * Hd);
          layer_rows<kC, TW>(sm, dm, ds, l, x, dcur + (size_t)l * B * Hd, win,
                         dcst + (size_t)l * B * Hd,
                         dnew + (size_t)l * B * Hd, B);
        }
        CLK_MARK(8)
        sync_blocks(sync);
        CLK_MARK(9)
      }
      head_rows<false, kC>(sm, tm, ts, hnew + (size_t)(L - 1) * B * H, V,
                           nullptr, 0, 1.0f, part_v, part_i, nx, blk,
                           p.blocks, B);
      CLK_MARK(10)
      if (!kC) {
        sync_blocks(sync);
        merge_rows(part_v, part_i, p.blocks, B, nx);
      }
      CLK_MARK(11)

      any = 0;
      for (int r = tid; r < B; r += THREADS) {
        const int t = nx[r];
        const int emit = win[r];
        if (blk == 0) toks_out[(size_t)i * B + r] = emit ? t : PAD_TOKEN;
        if (emit) {
          rem[r] -= 1;
          const int hit_eos = eos_in[r] >= 0 && t == eos_in[r];
          const int live_on = !hit_eos && rem[r] > 0;
          sess[r] = live_on;
          fin[r] = t;
          // past the last proposal nothing can agree: the window closes
          win[r] = i < K && live_on && props[(size_t)i * B + r] == t;
        }
        if (i < K) inp[r] = props[(size_t)i * B + r];
        any |= win[r];
      }
      any = __syncthreads_or(any);
      CLK_MARK(12)
      hcur = hnew;
      dcur = dnew;
    }
  }

  if (blk == 0) {
    // steps after every window closed (or all of them, for a batch dead at
    // entry) emit PAD
    for (int j = tid; j < (W - i) * B; j += THREADS)
      toks_out[(size_t)i * B + j] = PAD_TOKEN;
    for (int r = tid; r < B; r += THREADS) {
      next_out[r] = sess[r] ? fin[r] : 0;
      alive_out[r] = sess[r];
      rem_out[r] = rem[r];
    }
  }
  copy_units(h_out, hcur, tm, ts, B);
  copy_units(dh_out, dcur, dm, ds, B);
  if (kC) {
    copy_units(c_out, cst, tm, ts, B);
    copy_units(dc_out, dcst, dm, ds, B);
  }
  CLK_MARK(13)
  sync_exit(sync);
}

// The arguments of both forms: the target (lbf16: its logits rounded to
// bfloat16), the draft (dlbf16), the carries and rows, the plan, the
// scratch, the outputs, the stream
#define SPEC_PARAMS                                                          \
  int V, const void *emb, int E, int L, int H, const void *const *Ws,        \
      const void *const *Us, const void *const *bs, const void *head_w,      \
      const void *head_b, int lbf16, const void *demb, int Ed, int Ld,       \
      int Hd, const void *const *dWs, const void *const *dUs,                \
      const void *const *dbs, const void *dhead_w, const void *dhead_b,      \
      int dlbf16, const void *h_in, const void *c_in, const void *dh_in,     \
      const void *dc_in, const void *tok_in, const void *alive_in,           \
      const void *rem_in, const void *eos_in, int B, int K, int blocks,      \
      int cluster, int wsm, int hsm, int stage, int rsm, void *hbuf,         \
      void *dbuf, void *pbuf, void *pc, void *part_v, void *part_i,          \
      void *rows, void *counters, void *toks_out, void *next_out,            \
      void *alive_out, void *rem_out, void *h_out, void *c_out,              \
      void *dh_out, void *dc_out, void *stream
#define SPEC_ARGS                                                            \
  V, emb, E, L, H, Ws, Us, bs, head_w, head_b, lbf16, demb, Ed, Ld, Hd, dWs, \
      dUs, dbs, dhead_w, dhead_b, dlbf16, h_in, c_in, dh_in, dc_in, tok_in,  \
      alive_in, rem_in, eos_in, B, K, blocks, cluster, wsm, hsm, stage, rsm, \
      hbuf, dbuf, pbuf, pc, part_v, part_i, rows, counters, toks_out,        \
      next_out, alive_out, rem_out, h_out, c_out, dh_out, dc_out, stream

template <typename TW>
static int launch_form(SPEC_PARAMS) {
  if (L < 1 || L > MAX_LAYERS || Ld < 1 || Ld > MAX_LAYERS || B < 1 ||
      K < 1 || H < 1 || E < 1 || Hd < 1 || Ed < 1 || V < 1 || stage < 8)
    return (int)cudaErrorInvalidValue;
  const int es = (int)sizeof(TW);
  const Model models[2] = {
      make_model(emb, E, L, H, Ws, Us, bs, head_w, head_b, es, lbf16),
      make_model(demb, Ed, Ld, Hd, dWs, dUs, dbs, dhead_w, dhead_b, es,
                 dlbf16)};
  const Plan p = make_plan(blocks, cluster, wsm, hsm, stage, rsm);
  // the target's h of two steps and c; the committed draft's and the
  // propose copy's
  const int copies[2] = {3, 6};
  const size_t smem =
      window_smem_bytes(p, models, copies, 2, V, B, S_FIELDS + K);
  auto kernel = p.cluster ? spec_window_kernel<true, TW>
                          : spec_window_kernel<false, TW>;
  static bool opted[2][64];  // by build (grid, one cluster) and device
  return (int)launch_window(
      kernel, p, smem, (cudaStream_t)stream, opted[p.cluster ? 1 : 0],
      models[0], models[1], p, V, B, K, (const float*)h_in, (const float*)c_in,
      (const float*)dh_in, (const float*)dc_in, (const int*)tok_in,
      (const int*)alive_in, (const int*)rem_in, (const int*)eos_in,
      (float*)hbuf, (float*)dbuf, (float*)pbuf, (float*)pc, (float*)part_v,
      (int*)part_i, (int*)rows, (int*)counters, (int*)toks_out,
      (int*)next_out, (int*)alive_out, (int*)rem_out, (float*)h_out,
      (float*)c_out, (float*)dh_out, (float*)dc_out);
}

#ifdef WINDOW_BF16
extern "C" int spec_window_bf16_launch(SPEC_PARAMS) {
  return launch_form<__nv_bfloat16>(SPEC_ARGS);
}
#else
extern "C" int spec_window_launch(SPEC_PARAMS) {
  return launch_form<float>(SPEC_ARGS);
}
#endif  // WINDOW_BF16
