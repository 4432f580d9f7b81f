"""The port's cell, scan, LM forward and generation against the JAX package.

Same inputs (numpy, from seeds) and the same weights (carried across with
``convert.params_from_numpy``) go through both. Values agree in float32
within ``atol=1e-5``: the two frameworks sum matrix products in different
orders, so the tolerance is float32 rounding, not zero. Greedy tokens must
be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models import generate as tgen
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.ops import lstm_cell as tcell
from lstm_tensorspark_torch.ops import scan as tscan
from lstm_tensorspark_tpu.models import LMConfig, init_lm, make_generate_fn
from lstm_tensorspark_tpu.models.lstm_lm import lm_forward
from lstm_tensorspark_tpu.ops import lstm_cell as jcell
from lstm_tensorspark_tpu.ops import scan as jscan

torch.set_num_threads(1)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _layer(seed, d, h):
    jp = jax.tree.map(np.asarray,
                      jcell.init_lstm_params(jax.random.PRNGKey(seed), d, h))
    tp = tcell.LSTMParams(*(_t(getattr(jp, f)) for f in tcell.LSTMParams._fields))
    return jp, tp


def test_gate_order_and_fusion_match():
    assert tcell.GATE_ORDER == jcell.GATE_ORDER
    jp, tp = _layer(0, 6, 8)
    jf = jcell.fuse_params(jp)
    tf = tcell.fuse_params(tp)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_lstm_step_matches_jax():
    jp, tp = _layer(1, 10, 16)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 10).astype(np.float32)
    h = rng.randn(3, 16).astype(np.float32) * 0.5
    c = rng.randn(3, 16).astype(np.float32) * 0.5
    (jh, jc), _ = jcell.lstm_step(jcell.fuse_params(jp), (h, c), x)
    (th, tc), ty = tcell.lstm_step(tcell.fuse_params(tp), (_t(h), _t(c)), _t(x))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    assert ty is th


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_jax(masked, reverse):
    jp, tp = _layer(2, 8, 16)
    rng = np.random.RandomState(1)
    B, T = 3, 7
    xs = rng.randn(B, T, 8).astype(np.float32)
    h0 = rng.randn(B, 16).astype(np.float32) * 0.3
    c0 = rng.randn(B, 16).astype(np.float32) * 0.3
    mask = None
    if masked:  # right padding of different lengths, one full row
        lens = np.array([7, 4, 1])
        mask = np.arange(T)[None, :] < lens[:, None]
    (jh, jc), jys = jscan.lstm_scan(
        jp, xs, (h0, c0), mask=None if mask is None else jnp.asarray(mask),
        reverse=reverse)
    (th, tc), tys = tscan.lstm_scan(
        tp, _t(xs), (_t(h0), _t(c0)),
        mask=None if mask is None else _t(mask), reverse=reverse)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), atol=ATOL, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, rtol=0)


def _lm(tied, layers=2, vocab=31, hidden=16, seed=4):
    jcfg = LMConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                    tie_embeddings=tied)
    tcfg = tlm.LMConfig(vocab_size=vocab, hidden_size=hidden,
                        num_layers=layers, tie_embeddings=tied)
    jparams = init_lm(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("tied", [False, True])
def test_lm_forward_matches_jax(tied):
    jcfg, tcfg, jparams, tparams = _lm(tied)
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, 31, size=(3, 9)).astype(np.int32)
    jlogits, jfinals = lm_forward(jparams, jnp.asarray(tokens), jcfg)
    tlogits, tfinals = tlm.lm_forward(tparams, _t(tokens), tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    for (jh, jc), (th, tc) in zip(jfinals, tfinals):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, rtol=0)


def test_masked_backbone_ends_at_each_rows_true_end():
    _, tcfg, _, tparams = _lm(False, layers=1)
    rng = np.random.RandomState(3)
    full = rng.randint(0, 31, size=(2, 6)).astype(np.int32)
    lens = np.array([6, 3])
    padded = full.copy()
    padded[1, 3:] = 0
    mask = _t(np.arange(6)[None, :] < lens[:, None])
    finals, _ = tlm.lm_backbone(tparams, _t(padded), tcfg, mask=mask)
    short, _ = tlm.lm_backbone(tparams, _t(full[1:, :3]), tcfg)
    np.testing.assert_allclose(finals[0][0][1].numpy(), short[0][0][0].numpy(),
                               atol=1e-6, rtol=0)


def test_greedy_generate_matches_jax():
    jcfg, tcfg, jparams, tparams = _lm(False)
    prompt = np.random.RandomState(5).randint(0, 31, size=(2, 5)).astype(np.int32)
    ref = np.asarray(make_generate_fn(jcfg, max_new_tokens=10, greedy=True)(
        jparams, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    got = tgen.generate(tparams, prompt, tcfg, max_new_tokens=10, greedy=True,
                        device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_temperature_sampling_is_gumbel_argmax_of_the_given_noise():
    rng = np.random.RandomState(6)
    logits = rng.randn(4, 23).astype(np.float32)
    noise = rng.gumbel(size=(4, 23)).astype(np.float32)
    got = tgen.sample_logits(_t(logits), temperature=0.7, noise=_t(noise))
    ref = np.argmax(logits / np.float32(0.7) + noise, axis=-1)
    np.testing.assert_array_equal(got.numpy(), ref)
    g = torch.Generator().manual_seed(0)
    drawn = tgen.sample_logits(_t(logits), temperature=1.3, generator=g)
    assert drawn.shape == (4,) and drawn.dtype == torch.int32


@pytest.mark.parametrize("kw", [{"top_k": 5}, {"top_p": 0.9}])
def test_top_k_and_top_p_are_refused(kw):
    with pytest.raises(ValueError, match="top-k / top-p"):
        tgen.sample_logits(torch.zeros(2, 5), temperature=1.0, **kw)


def test_init_lm_is_seeded_and_shaped():
    cfg = tlm.LMConfig(vocab_size=20, hidden_size=8, num_layers=2)
    a = tlm.init_lm(torch.Generator().manual_seed(7), cfg)
    b = tlm.init_lm(torch.Generator().manual_seed(7), cfg)
    torch.testing.assert_close(a["embedding"], b["embedding"], rtol=0, atol=0)
    U = a["layers"][1].U_g
    torch.testing.assert_close(U @ U.T, torch.eye(8), atol=1e-5, rtol=0)
    assert a["layers"][0].b_f.eq(1.0).all() and a["layers"][0].b_i.eq(0).all()
    assert a["head"]["kernel"].shape == (8, 20)
