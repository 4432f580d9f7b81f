"""bf16 serving in the port against the JAX package, on the CPU.

- The bf16 forms' plain twins, ``cuda_decode.decode_window_reference`` and
  ``cuda_spec.spec_window_reference`` with W and U fused in bfloat16,
  against JAX's ``decode_window_call`` / ``spec_window_call`` in interpret
  mode on the same weights (JAX's ``fuse_params(compute_dtype=bfloat16)``),
  at logits dtype float32 and bfloat16 (the target's and the draft's apart):
  tokens and the row summary identical, carries within WINDOW_TOL.
- The prefill's rounding: the kernel route's plain-rounding form
  (``kernel_lstm_scan(..., plain_rounding=True)``, resident and tiled
  twins) against JAX's plain ``lstm_scan`` in bf16, where the kernel route
  without it rounds xproj to bfloat16 as JAX's Pallas route does.
- ``generate`` in bf16 (± bf16 logits) against JAX's ``make_generate_fn``;
  the engine's bf16 prefill and window chain against JAX's engine with its
  bf16 window kernel (interpret mode).
- ``serve --compute-dtype bfloat16 --checkpoint-dir`` on a checkpoint the
  JAX package wrote: the same greedy tokens as JAX's ``ServeEngine`` on it,
  plain and speculative (``--selftest`` passes too).

WINDOW_TOL: both sides round x and h to bfloat16 before each product and
sum the exact products in float32 in another order, so a sum that lands by
a bfloat16 rounding boundary can round the other way in one of them; the
carries of these few steps stay within 2e-5 (measured: at most 1.2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import generate as tgen
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.ops import cuda_decode, cuda_lstm, cuda_spec
from lstm_tensorspark_torch.ops import cuda_lstm_tiled
from lstm_tensorspark_torch.ops import scan as tscan
from lstm_tensorspark_torch.serve import InprocessClient, ServeEngine
from lstm_tensorspark_torch.train.distill import draft_config, publish_draft
from lstm_tensorspark_tpu.models import LMConfig, init_lm, make_generate_fn
from lstm_tensorspark_tpu.models.generate import fuse_layers as j_fuse
from lstm_tensorspark_tpu.ops import pallas_decode
from lstm_tensorspark_tpu.ops.scan import lstm_scan as j_lstm_scan

torch.set_num_threads(1)

V, H = 29, 16
BF = torch.bfloat16
WINDOW_TOL = 2e-5


def _models(L, ldtype="float32", hidden=H, seed=0, tied=False):
    jcfg = LMConfig(vocab_size=V, hidden_size=hidden, num_layers=L,
                    compute_dtype="bfloat16", logits_dtype=ldtype,
                    tie_embeddings=tied)
    tcfg = tlm.LMConfig(vocab_size=V, hidden_size=hidden, num_layers=L,
                        compute_dtype="bfloat16", logits_dtype=ldtype,
                        tie_embeddings=tied)
    jparams = init_lm(jax.random.PRNGKey(30 + seed + L), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    weights = cuda_decode.decode_weights(
        tparams, tgen.fuse_layers(tparams, tcfg), tied, tcfg.ldtype)
    return jcfg, jparams, tcfg, tparams, weights


def test_bf16_decode_weights_are_jax_fused_weights():
    jcfg, jparams, _, _, w = _models(2)
    assert cuda_decode.layers_dtype(w) == BF
    for f, jf in zip(w.layers, j_fuse(jparams, jcfg)):
        for t, j in ((f.kernel, jf.kernel), (f.recurrent, jf.recurrent),
                     (f.bias, jf.bias)):
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))
    assert w.embedding.dtype == w.head_kernel.dtype == torch.float32


# (layers, batch, window, greedy, logits dtype, tied head)
DECODE_CASES = [
    (1, 4, 4, True, "float32", False),
    (2, 4, 8, True, "bfloat16", False),
    (2, 4, 4, False, "float32", True),
    (1, 1, 8, False, "bfloat16", False),
]


@pytest.mark.parametrize("L,B,K,greedy,ld,tied", DECODE_CASES)
def test_bf16_decode_window_twin_matches_jax_kernel(L, B, K, greedy, ld,
                                                    tied):
    jcfg, jparams, _, _, w = _models(L, ld, tied=tied)
    rng = np.random.RandomState(10 * L + B + K)
    h = (rng.randn(L, B, H) * 0.5).astype(np.float32)
    c = (rng.randn(L, B, H) * 0.5).astype(np.float32)
    tok = rng.randint(0, V, size=B).astype(np.int32)
    noise = None if greedy else rng.gumbel(size=(K, B, V)).astype(np.float32)
    alive = np.ones(B, np.int32)
    rem = np.full(B, K + 2, np.int32)
    eos = np.full(B, -1, np.int32)
    if B == 4:
        rem[1] = max(1, K // 2)
        alive[2], rem[2] = 0, 0
    before = cuda_decode.counts_bf16.reference
    got = cuda_decode.decode_window(
        w, *(torch.from_numpy(a) for a in (h, c, tok, alive, rem, eos)),
        None if noise is None else torch.from_numpy(noise), window=K,
        temperature=0.7, greedy=greedy)
    assert cuda_decode.counts_bf16.reference == before + 1
    ref = pallas_decode.decode_window_call(
        jparams, j_fuse(jparams, jcfg), jcfg, jnp.asarray(h), jnp.asarray(c),
        jnp.asarray(tok), jnp.asarray(alive.astype(bool)), jnp.asarray(rem),
        jnp.asarray(eos), None if noise is None else jnp.asarray(noise),
        window=K, temperature=0.7, greedy=greedy, interpret=True)
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
            a.numpy().dtype))
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=WINDOW_TOL,
                                   rtol=0)


# (target layers, batch, k_draft, target logits, draft logits)
SPEC_CASES = [(1, 4, 2, "float32", "float32"),
              (2, 4, 4, "bfloat16", "float32"),
              (2, 1, 3, "float32", "bfloat16")]


@pytest.mark.parametrize("L,B,K,ld,dld", SPEC_CASES)
def test_bf16_spec_window_twin_matches_jax_kernel(L, B, K, ld, dld):
    jcfg, jparams, _, _, tw = _models(L, ld)
    dcfg, dparams, _, _, dw = _models(1, dld, hidden=8, seed=5)
    rng = np.random.RandomState(L + B + K)
    h = (rng.randn(L, B, H) * 0.5).astype(np.float32)
    c = (rng.randn(L, B, H) * 0.5).astype(np.float32)
    dh = (rng.randn(1, B, 8) * 0.5).astype(np.float32)
    dc = (rng.randn(1, B, 8) * 0.5).astype(np.float32)
    tok = rng.randint(0, V, size=B).astype(np.int32)
    alive = np.ones(B, np.int32)
    rem = np.full(B, K + 3, np.int32)
    eos = np.full(B, -1, np.int32)
    if B == 4:
        alive[1], rem[1] = 0, 0
        rem[2] = 1
    got = cuda_spec.spec_window(
        tw, dw, *(torch.from_numpy(a) for a in (h, c, dh, dc, tok, alive, rem,
                                                 eos)), k_draft=K)
    ref = pallas_decode.spec_window_call(
        jparams, j_fuse(jparams, jcfg), jcfg, dparams, j_fuse(dparams, dcfg),
        dcfg, *(jnp.asarray(a) for a in (h, c, dh, dc, tok)),
        jnp.asarray(alive.astype(bool)), jnp.asarray(rem), jnp.asarray(eos),
        k_draft=K, interpret=True)
    # ref: (h, c, dh, dc, toks, next, alive, rem) as the port's
    for a, b in zip(got[4:], ref[4:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
            a.numpy().dtype))
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=WINDOW_TOL,
                                   rtol=0)
    # one window runs one form: a float32 draft beside a bf16 target raises
    d32 = cuda_decode.DecodeWeights(dw.embedding, tuple(
        f._replace(kernel=f.kernel.float(), recurrent=f.recurrent.float())
        for f in dw.layers), dw.head_kernel, dw.head_bias)
    with pytest.raises(TypeError, match="one window runs one form"):
        cuda_spec.spec_window(tw, d32, *(torch.from_numpy(a) for a in (
            h, c, dh, dc, tok, alive, rem, eos)), k_draft=K)


@pytest.mark.parametrize("route", ["resident", "tiled"])
def test_prefill_plain_rounding_matches_jax_plain_scan(route):
    """The serve prefill's recurrence: the kernel route's plain-rounding
    form (float32 xproj, bf16 U: its twin on the CPU) is JAX's plain scan
    in bf16 (``use_pallas=False``), where the kernel route's own bf16 form
    rounds xproj to bfloat16 and lands elsewhere."""
    from lstm_tensorspark_tpu.ops.lstm_cell import LSTMParams as JP

    jcfg, jparams, _, tparams, _ = _models(1, hidden=24)
    B, T, D = 3, 9, 24
    rng = np.random.RandomState(4)
    xs = (rng.randn(B, T, D) * 0.7).astype(np.float32)
    h0 = (rng.randn(B, 24) * 0.5).astype(np.float32)
    c0 = (rng.randn(B, 24) * 0.5).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([9, 4, 7])[:, None]
    layer = tparams["layers"][0]
    counts = {"resident": cuda_lstm.fwd_bf16u_counts,
              "tiled": cuda_lstm_tiled.fwd_bf16u_counts}[route]
    before = counts.reference
    args = (layer, torch.from_numpy(xs), (torch.from_numpy(h0),
                                          torch.from_numpy(c0)),
            torch.from_numpy(mask), False, BF)
    (hT, cT), ys = tscan._route_scan(route, *args, plain_rounding=True)
    assert counts.reference == before + 1
    jl = JP(*(jnp.asarray(getattr(jparams["layers"][0], f)) for f in JP._fields))
    (jh, jc), jys = j_lstm_scan(jl, jnp.asarray(xs), (jnp.asarray(h0),
                                                     jnp.asarray(c0)),
                                mask=jnp.asarray(mask),
                                compute_dtype=jnp.bfloat16)
    for a, b in ((ys, jys), (hT, jh), (cT, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6,
                                   rtol=0)
    # the kernel route's own bf16 form (xproj rounded) is another rounding
    (_, _), ys_k = tscan._route_scan(route, *args)
    assert float((ys_k - ys).abs().max()) > 1e-4
    # the plain-rounding form is forward only
    with pytest.raises(ValueError, match="forward-only"):
        tscan._route_scan(route, layer._replace(
            W_i=layer.W_i.clone().requires_grad_()), *args[1:],
            plain_rounding=True)


@pytest.mark.parametrize("ld", ["float32", "bfloat16"])
def test_generate_bf16_matches_jax(ld):
    jcfg, jparams, tcfg, tparams, _ = _models(2, ld)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, V, size=(2, 7)).astype(np.int32)
    ref = make_generate_fn(jcfg, max_new_tokens=10, greedy=True)(
        jparams, jnp.asarray(prompt), jax.random.PRNGKey(0))
    got = tgen.generate(tparams, prompt, tcfg, max_new_tokens=10,
                        greedy=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jax_engine_tokens(jparams, jcfg, prompts, n_new):
    from lstm_tensorspark_tpu.serve import ServeEngine as JEngine

    eng = JEngine(jparams, jcfg, num_slots=8, prefill_buckets=(8, 16),
                  batch_buckets=(1, 2, 4), decode_kernel="pallas")
    slots = [eng.cache.acquire(f"s{i}")[0] for i in range(len(prompts))]
    first = eng.prefill([(s, True, p) for s, p in zip(slots, prompts)])
    win = eng.decode_window(slots, [int(t) for t in first],
                            [n_new - 1] * len(slots), window=n_new - 1)
    rest = eng.fetch_window(win)
    return [[int(f)] + [int(t) for t in row if t >= 0]
            for f, row in zip(first, rest)]


@pytest.mark.parametrize("ld", ["float32", "bfloat16"])
def test_engine_bf16_matches_jax_engine(ld):
    jcfg, jparams, tcfg, tparams, _ = _models(2, ld)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, V, size=t).astype(np.int32) for t in (3, 8, 13)]
    want = _jax_engine_tokens(jparams, jcfg, prompts, 9)
    eng = ServeEngine(tparams, tcfg, device="cpu", num_slots=8,
                      prefill_buckets=(8, 16), batch_buckets=(1, 2, 4))
    slots = [eng.cache.acquire(f"s{i}")[0] for i in range(len(prompts))]
    first = eng.prefill([(s, True, p) for s, p in zip(slots, prompts)])
    win = eng.decode_window(slots, [int(t) for t in first], [8] * 3,
                            window=8)
    got = [[int(f)] + [int(t) for t in row if t >= 0]
           for f, row in zip(first, eng.fetch_window(win))]
    assert got == want
    st = eng.stats()
    assert st["window_form"] == "bfloat16" and st["reference_windows"] >= 1
    # a draft of another compute dtype is refused at attach
    dcfg = tlm.LMConfig(vocab_size=V, hidden_size=8)
    with pytest.raises(ValueError, match="compute dtype"):
        eng.attach_draft(tlm.init_lm(torch.Generator().manual_seed(0), dcfg),
                         dcfg)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX-written checkpoint of a bf16 LM (Adam state, step 5) and JAX's
    engine's greedy tokens on it."""
    from lstm_tensorspark_tpu.train import make_optimizer
    from lstm_tensorspark_tpu.train.checkpoint import Checkpointer
    from lstm_tensorspark_tpu.train.loop import init_train_state

    d = tmp_path_factory.mktemp("jaxckpt")
    jcfg, jparams, *_ = _models(2, seed=7)
    st = init_train_state(jparams, make_optimizer("adam", 1e-3),
                          jax.random.PRNGKey(0))
    Checkpointer(str(d)).save(st._replace(step=jnp.asarray(5, jnp.int32)))
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, V, size=t).astype(np.int32) for t in (4, 9, 14)]
    return str(d), prompts, _jax_engine_tokens(jparams, jcfg, prompts, 10)


SERVE_FLAGS = ["--device", "cpu", "--compute-dtype", "bfloat16",
               "--vocab-size", str(V), "--hidden-units", str(H),
               "--num-layers", "2", "--optimizer", "adam",
               "--prefill-buckets", "8,16", "--batch-buckets", "1,2,4",
               "--num-slots", "8", "--max-active", "4"]


@pytest.mark.parametrize("speculative", [False, True])
def test_serve_jax_checkpoint_matches_jax_engine(jax_checkpoint,
                                                 speculative, tmp_path):
    d, prompts, want = jax_checkpoint
    flags = ["--selftest", "--checkpoint-dir", d] + SERVE_FLAGS
    if speculative:
        # the draft the command served before it loaded drafts from a
        # registry: draft_config's shape drawn from --seed + 1
        cfg = tlm.LMConfig(vocab_size=V, hidden_size=H, num_layers=2,
                           compute_dtype="bfloat16")
        dcfg = draft_config(cfg)
        publish_draft(str(tmp_path), tlm.init_lm(
            torch.Generator().manual_seed(1), dcfg), dcfg, cfg)
        flags += ["--speculative", "--registry-dir", str(tmp_path)]
    args = tcli.build_serve_parser().parse_args(flags)
    _, cfg, server = tcli._build_serve_stack(args)
    assert cfg.compute_dtype == "bfloat16"
    server.warmup(prompt_lens=(16,))
    client = InprocessClient(server)
    with server:
        got = [client.generate(p, max_new_tokens=10) for p in prompts]
    assert got == want
    stats = server.stats()["engine"]
    assert stats["window_form"] == "bfloat16"
    if speculative:
        assert stats["spec_reference_windows"] >= 1
    assert tcli.main(["serve", "--sessions", "3", "--max-new-tokens", "6"]
                     + flags) == 0
