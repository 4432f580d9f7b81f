"""bf16 compute on the port's residentx route (config 2 and the LM at
T >= 256) against the JAX package, on the CPU.

The same numpy inputs and bridged float32 weights go through both sides:

1. the single-direction pair's plain twins (``ops/cuda_lstmx.py`` in its
   bfloat16 form: xs, W and U bfloat16, zx float32, h rounded at the
   product, dz rounded once) through ``cuda_lstmx_scan(compute_dtype=
   bfloat16)`` against ``pallas_lstm_scan(compute_dtype=bfloat16,
   interpret=True)`` with ``_FUSEDX_MIN_T`` set to 0, so the short sequence
   takes JAX's residentx pair: masked, reversed, with a carry; values to
   1e-3, gradients to 1e-2 of their max |g| (``tests/test_torch_bf16.py``'s
   limits for the kernels' twins: float32 sums in another order, and a
   bfloat16 rounding of h or dz that falls the other way by one ulp);
2. the stacked pair's twins (``cuda_bilstm_scan``) against
   ``pallas_bilstm_scan(compute_dtype=bfloat16, interpret=True)``, same
   limits;
3. the dz stream the twin stores (bfloat16) against the one
   ``_pallas_backward``'s residentx kernel stores (a spy on
   ``pl.pallas_call``), fed the same forward residuals: each element within
   one bfloat16 ulp, or 1e-3 of the stream's max |dz| for elements by zero;
   dh0 and dc0 to 1e-3 of their scale;
4. the twin's rebuilt z against the forward twin's float32 z, bit for bit;
5. the routes of ``ops/scan.py`` in bf16 at config 2's shapes (B=32,
   T=400, D=H=256, masked; with and without ``--remat-chunk 50``) and at
   the LM's T=256 against what JAX's ``chosen_bwd_strategy(..., pbytes=2)``,
   ``_plan_fwd`` and ``bilstm_supported(..., param_dtype_bytes=2)`` choose,
   and the plans' element size;
6. the bf16 classifier's loss and gradients against JAX's ``classifier_loss``
   with ``compute_dtype=bfloat16``: the plain route (both plain scans;
   loss to 1e-5 relative, gradients to 5e-3 of max |g|) and the kernel
   routes (the stacked twins against JAX's ``use_pallas=True`` stacked
   kernel, and under ``remat_chunk`` the residentx forward twin with the
   plain recompute against JAX's residentx forward with its recompute, the
   Pallas kernels in interpret mode; loss to 1e-5 relative, gradients to
   1e-3 of max |g|);
7. ``train --dataset imdb --compute-dtype bfloat16`` on the CPU, with and
   without ``--remat-chunk``: its first losses against JAX's
   ``make_train_step`` over the run's own initial weights and batches (to
   1e-4 relative), and the bf16 LM at ``--seq-len 256``;
8. the port's ``train`` defaults equal JAX's for ``--compute-dtype`` and
   ``--logits-dtype``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import (classifier_params_from_numpy,
                                            classifier_params_to_numpy)
from lstm_tensorspark_torch.exit_codes import OK_RC
from lstm_tensorspark_torch.models import classifier as tclf
from lstm_tensorspark_torch.ops import cuda_bilstm, cuda_lstm, cuda_lstmx
from lstm_tensorspark_torch.ops import lstm_cell as tcell
from lstm_tensorspark_torch.ops import scan as tscan
from lstm_tensorspark_torch.train import loop as tloop
from lstm_tensorspark_tpu import cli as jcli
from lstm_tensorspark_tpu.models import classifier as jclf
from lstm_tensorspark_tpu.ops import lstm_cell as jcell
from lstm_tensorspark_tpu.ops import pallas_bilstm as jbilstm
from lstm_tensorspark_tpu.ops import pallas_lstm as jpallas
from lstm_tensorspark_tpu.train import loop as jloop
from lstm_tensorspark_tpu.train import optimizer as jopt

torch.set_num_threads(1)

BF = torch.bfloat16
B, T, D, H = 8, 8, 12, 16
# the kernels' twins against the Pallas kernels: float32 values, gradients
# as a share of max |g|; a stored bfloat16 element within one ulp or this
# share of the stream's max |value|
VALUE_ATOL, GRAD_SHARE, STREAM_FLOOR = 1e-3, 1e-2, 1e-3
# the classifier: the plain loops' gradients, the kernel routes' gradients
PLAIN_GRAD, KERNEL_GRAD = 5e-3, 1e-3
# the CLI's bf16 losses against JAX's trajectory
LOSS_RTOL = 1e-4
LENGTHS = np.array([8, 1, 5, 8, 7, 2, 6, 3])


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _bf(a):
    """A JAX bfloat16 array as a torch bfloat16 tensor (exact)."""
    return _t(np.asarray(a).astype(np.float32)).to(BF)


def _jparams(seed, d_in=D):
    return jax.tree.map(np.asarray, jcell.init_lstm_params(
        jax.random.PRNGKey(seed), d_in, H))


def _tparams(jp):
    return tcell.LSTMParams(*(_t(getattr(jp, f)).requires_grad_()
                              for f in tcell.LSTMParams._fields))


def _mask(masked):
    return (np.arange(T)[None, :] < LENGTHS[:, None]) if masked else None


def _held(touts, tgrads, jouts, jgrads, names):
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=VALUE_ATOL, rtol=0)
    assert len(tgrads) == len(jgrads) == len(names)
    for name, a, b in zip(names, tgrads, jgrads):
        assert a.dtype == torch.float32, name
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, err_msg=name,
                                   atol=GRAD_SHARE * max(
                                       float(np.abs(b).max()), 1e-30))


def _ulps_held(got, ref, name):
    """Each element of a stored bfloat16 stream within one bfloat16 ulp of
    the reference element, or STREAM_FLOOR of the stream's max |ref|."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(
        ref.abs().clamp_min(2.0 ** -126))[1] - 8)
    bad = (d > ulp) & (d > STREAM_FLOOR * float(ref.abs().max()))
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} of {d.numel()} elements beyond one ulp "
        f"(max |d| {float(d.max()):.3e})")


def _counts(*cs):
    return [c.reference for c in cs]


# ---------------------------------------------------------------------------
# 1, 2. the twins against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked,reverse,carry", [
    (False, False, False), (True, False, True), (True, True, True)])
def test_single_direction_bf16_twins_match_residentx_pallas(
        monkeypatch, masked, reverse, carry):
    monkeypatch.setattr(jpallas, "_FUSEDX_MIN_T", 0)
    hp, dp = jpallas._pad_to_lane(H), jpallas._pad_to_lane(D)
    assert jpallas.chosen_bwd_strategy(B, T, hp, 2, has_mask=masked,
                                       Dp=dp) == "residentx"
    jp = _jparams(3 + masked + 2 * reverse)
    rng = np.random.RandomState(4 + masked)
    xs = rng.randn(B, T, D).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    w = [rng.randn(*s).astype(np.float32)
         for s in ((B, T, H), (B, H), (B, H))]
    mask = _mask(masked)

    def jloss(p, x, h, c):
        (hT, cT), ys = jpallas.pallas_lstm_scan(
            p, x, (h, c) if carry else None,
            mask=None if mask is None else jnp.asarray(mask),
            reverse=reverse, compute_dtype=jnp.bfloat16, interpret=True)
        outs = (ys, hT, cT)
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w)), outs

    (_, jouts), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(xs), jnp.asarray(h0),
        jnp.asarray(c0))

    tp = _tparams(jp)
    x, h, c = (_t(a).requires_grad_() for a in (xs, h0, c0))
    before = _counts(cuda_lstmx.fwdx_bf16_counts, cuda_lstmx.bwdx_bf16_counts,
                     cuda_lstmx.fwdx_counts)
    (hT, cT), ys = cuda_lstmx.cuda_lstmx_scan(
        tp, x, (h, c) if carry else None,
        mask=None if mask is None else torch.from_numpy(mask),
        reverse=reverse, compute_dtype=BF)
    touts = (ys, hT, cT)
    loss = sum((o * _t(wi)).sum() for o, wi in zip(touts, w))
    inputs = [*tp, x] + ([h, c] if carry else [])
    tg = torch.autograd.grad(loss, inputs)
    ran = [a - b for a, b in zip(_counts(
        cuda_lstmx.fwdx_bf16_counts, cuda_lstmx.bwdx_bf16_counts,
        cuda_lstmx.fwdx_counts), before)]
    assert ran == [1, 1, 0]  # the bf16 forms' twins, no float32 form
    expect = [getattr(jg[0], f) for f in tcell.LSTMParams._fields] + [jg[1]]
    expect += [jg[2], jg[3]] if carry else []
    _held(touts, tg, jouts, expect, list(tcell.LSTMParams._fields) + [
        "xs", "h0", "c0"][:len(expect) - 12])


@pytest.mark.parametrize("masked", [False, True])
def test_stacked_bf16_twins_match_bilstm_pallas(masked):
    jf, jb = _jparams(5), _jparams(6)
    rng = np.random.RandomState(7 + masked)
    xs = rng.randn(B, T, D).astype(np.float32)
    w = [rng.randn(*s).astype(np.float32)
         for s in ((B, T, H), (B, H), (B, H)) * 2]
    mask = _mask(masked)

    def weighted(out, ws):
        ((hf, cf), ysf), ((hb, cb), ysb) = out
        outs = (ysf, hf, cf, ysb, hb, cb)
        return sum((o * wi).sum() for o, wi in zip(outs, ws)), outs

    def jloss(pf, pb, x):
        return weighted(jbilstm.pallas_bilstm_scan(
            pf, pb, x, mask=None if mask is None else jnp.asarray(mask),
            compute_dtype=jnp.bfloat16, interpret=True),
            [jnp.asarray(a) for a in w])

    (_, jouts), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                        has_aux=True)(
        jax.tree.map(jnp.asarray, jf), jax.tree.map(jnp.asarray, jb),
        jnp.asarray(xs))

    tf, tb = _tparams(jf), _tparams(jb)
    x = _t(xs).requires_grad_()
    before = _counts(cuda_lstmx.bi_fwdx_bf16_counts,
                     cuda_lstmx.bi_bwdx_bf16_counts, cuda_lstmx.bi_fwdx_counts)
    out = cuda_bilstm.cuda_bilstm_scan(
        tf, tb, x, mask=None if mask is None else torch.from_numpy(mask),
        compute_dtype="bfloat16")
    loss, touts = weighted(out, [_t(a) for a in w])
    tg = torch.autograd.grad(loss, [*tf, *tb, x])
    ran = [a - b for a, b in zip(_counts(
        cuda_lstmx.bi_fwdx_bf16_counts, cuda_lstmx.bi_bwdx_bf16_counts,
        cuda_lstmx.bi_fwdx_counts), before)]
    assert ran == [1, 1, 0]
    fields = tcell.LSTMParams._fields
    expect = ([getattr(jg[0], f) for f in fields]
              + [getattr(jg[1], f) for f in fields] + [jg[2]])
    _held(touts, tg, jouts, expect, [f"fwd.{f}" for f in fields]
          + [f"bwd.{f}" for f in fields] + ["xs"])


# ---------------------------------------------------------------------------
# 3, 4. the dz stream and the rebuilt z
# ---------------------------------------------------------------------------


def test_dz_stream_matches_the_pallas_kernel(monkeypatch):
    """The residentx backward kernel's bfloat16 dz (what its pallas_call
    returns) against the twin's, both fed JAX's forward residuals (ys,
    cs) and the same xs, weights and cotangents."""
    monkeypatch.setattr(jpallas, "_FUSEDX_MIN_T", 0)
    jp = _jparams(11)
    rng = np.random.RandomState(12)
    xs = rng.randn(B, T, D).astype(np.float32)
    h0, c0 = ((rng.randn(B, H) * 0.5).astype(np.float32) for _ in range(2))
    mask = _mask(True)
    tbl = jnp.broadcast_to(jnp.asarray(mask.T, jnp.float32)[:, :, None],
                           (T, B, jpallas._LANE))
    jf = jcell.fuse_params(jax.tree.map(jnp.asarray, jp),
                           compute_dtype=jnp.bfloat16)
    ys, hT, cT, z, cs = jpallas._pallas_forward(
        jf, jnp.asarray(xs), jnp.asarray(h0), jnp.asarray(c0), tbl,
        interpret=True, save_residuals=True)
    assert z is None and cs.dtype == jnp.float32  # the residentx forward

    seen = []
    real = jpallas.pl.pallas_call

    def spy(*a, **k):
        fn = real(*a, **k)

        def call(*args):
            out = fn(*args)
            seen.append(out)
            return out
        return call

    monkeypatch.setattr(jpallas.pl, "pallas_call", spy)
    dys = rng.randn(B, T, H).astype(np.float32)
    dhT, dcT = (rng.randn(B, H).astype(np.float32) for _ in range(2))
    jpallas._pallas_backward(
        jf, jax.tree.map(jnp.asarray, jp), jnp.asarray(xs), jnp.asarray(h0),
        jnp.asarray(c0), tbl, ys, None, cs, jnp.asarray(dys),
        jnp.asarray(dhT), jnp.asarray(dcT), interpret=True)
    jdz, jdh0, jdc0 = seen[-1]
    assert jdz.dtype == jnp.bfloat16 and jdz.shape == (T, B, 4 * H)

    tf = tcell.fuse_params(tcell.LSTMParams(
        *(_t(getattr(jp, f)) for f in tcell.LSTMParams._fields)), BF)
    tys = _t(ys).transpose(0, 1).contiguous()
    tdz, tdh0, tdc0 = cuda_lstmx.lstmx_backward(
        _t(xs).transpose(0, 1).contiguous().to(BF), tys, _t(h0), _t(cs),
        _t(c0), _t(dys).transpose(0, 1).contiguous(), tf.kernel[None],
        tf.bias[None], tf.recurrent[None], _t(dhT), _t(dcT),
        _t(mask.T).contiguous())
    assert tdz.dtype == BF
    _ulps_held(tdz, _bf(jdz), "dz")
    for a, b in ((tdh0, jdh0), (tdc0, jdc0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=VALUE_ATOL * max(
                                       1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_backward_rebuilds_the_forwards_z_bit_for_bit(dtype):
    """The backward twin's z (``rebuild_z``) is the z the forward twin's
    recurrence formed, to the bit, for both directions of a stacked call:
    the same float32 projection, h_prev rounded to U's dtype at the same
    product."""
    rng = np.random.RandomState(9)
    ND, Bd = 2, 3
    xs = _t(rng.randn(T, ND * Bd, D)).to(dtype)
    W = _t(rng.randn(ND, D, 4 * H) / np.sqrt(D)).to(dtype)
    b = _t(rng.randn(ND, 4 * H) * 0.1)
    U = _t(rng.randn(ND, H, 4 * H) / np.sqrt(H)).to(dtype)
    h0, c0 = (_t(rng.randn(ND * Bd, H) * 0.5) for _ in range(2))
    lens = np.array([8, 4, 1, 7, 8, 2])
    mask = _t((np.arange(T)[:, None] < lens[None, :]).astype(np.float32))
    ys, _, _, cs = cuda_lstmx.lstmx_forward_reference(
        xs, W, b, U, h0, c0, mask, save_c=True)
    z = cuda_lstmx.rebuild_z(xs, ys, h0, W, b, U)
    assert z.dtype == torch.float32
    for d in range(ND):
        r = slice(d * Bd, (d + 1) * Bd)
        zx = tcell.mm_f32(xs[:, r], W[d]) + b[d]
        y, _, _, zf, _ = cuda_lstm.lstm_forward_reference(
            zx, U[d], h0[r], c0[r], mask[:, r], save_residuals=True)
        assert torch.equal(y, ys[:, r])
        assert zf.dtype == torch.float32 and torch.equal(zf, z[:, r])


# ---------------------------------------------------------------------------
# 5. routes and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Bc,Tc,Hc,Dc,masked,remat,fwd,bwd,bidir", [
    (32, 400, 256, 256, True, None, "residentx", "residentx", "stacked"),
    (32, 400, 256, 256, True, 50, "residentx", "recompute", "two_scans"),
    (64, 256, 128, 128, False, None, "residentx", "residentx", None),
])
def test_bf16_routes_match_jax(Bc, Tc, Hc, Dc, masked, remat, fwd, bwd,
                               bidir):
    """config 2 (B=32, T=400, D=H=256, masked) as configs/imdb_bilstm.sh
    runs it (--remat-chunk 50: two scans, the residentx forward, the
    recompute backward) and without remat (the stacked pair), and the LM
    at T=256: the port's bf16 routes are JAX's."""
    assert tscan.chosen_fwd_strategy(Bc, Tc, Hc, Dc, esize=2) == fwd
    assert tscan.chosen_bwd_strategy(Bc, Tc, Hc, Dc, remat_chunk=remat,
                                     esize=2) == bwd
    hp, dp = jpallas._pad_to_lane(Hc), jpallas._pad_to_lane(Dc)
    jbwd = jpallas.chosen_bwd_strategy(Bc, Tc, hp, 2, has_mask=masked, Dp=dp,
                                       remat_chunk=remat)
    jfwd = jpallas._plan_fwd(Bc, hp, 2, save_residuals=jbwd != "recompute",
                             has_mask=masked, Dp=dp)[0]
    assert (jfwd, jbwd) == (fwd, bwd)
    if bidir is not None:
        assert tscan.bidir_route(Bc, Tc, Hc, Hc, Dc, remat_chunk=remat,
                                 esize=2) == bidir
        jstacked = remat is None and jbilstm.bilstm_supported(
            Bc, Hc, Dc, Tc, platform="tpu", param_dtype_bytes=2,
            has_mask=masked)
        assert jstacked == (bidir == "stacked")


def test_bf16_plans_follow_the_element_size():
    """A bf16 U takes half the shared memory: the backward's slice of Uᵀ at
    config 2 and the forward's second columns at the LM's width take 2
    bytes an element; every plan still fits a block's 227 KB, and the
    float32 plans are as before."""
    for args in ((32, 256, 256, 2), (32, 256, 256, 1), (64, 128, 128, 1),
                 (8, 200, 72, 2), (32, 300, 256, 2), (64, 650, 256, 1),
                 (3, 5, 7, 1)):
        p4, p2 = (cuda_lstmx.plan(*args, esize=e) for e in (4, 2))
        for k4, k2 in ((p4.fwd, p2.fwd), (p4.bwd, p2.bwd)):
            assert k2.smem_bytes <= cuda_lstmx.MAX_SMEM_BYTES
            assert (k2.u_in_regs, k2.u_in_smem) == (k4.u_in_regs,
                                                    k4.u_in_smem)
        assert p2.zks == p4.zks and p2.cluster == p4.cluster
    c2 = (cuda_lstmx.plan(32, 256, 256, 2, esize=e) for e in (4, 2))
    b4, b2 = (p.bwd for p in c2)
    assert b4.u_in_smem and b2.smem_bytes < b4.smem_bytes
    f4, f2 = (cuda_lstmx.plan(96, 128, 128, 2, esize=e).fwd for e in (4, 2))
    assert f4.rows4 == 8 and f4.u_in_regs and f2.smem_bytes < f4.smem_bytes
    # the bf16 chain keeps each item's float32 h (hown) beside its c
    one = cuda_lstmx.chain_bytes(16, 2, 4, 1, False, True, 2)
    assert one == cuda_lstmx.chain_bytes(16, 2, 4, 1, False, True, 4) \
        + 4 * 2 * 4
    assert cuda_lstmx.fits(32, 256, 256, 2, esize=2)
    assert cuda_bilstm.bilstm_supported(32, 256, 256, 400, esize=2)


# ---------------------------------------------------------------------------
# 6. the classifier
# ---------------------------------------------------------------------------


def _models(remat=None, V=30, Hc=8, E=6, seed=0, use_pallas=False):
    common = dict(vocab_size=V, hidden_size=Hc, embed_size=E,
                  compute_dtype="bfloat16", remat_chunk=remat)
    jcfg = jclf.ClassifierConfig(**common, use_pallas=use_pallas)
    jparams = jclf.init_classifier(jax.random.PRNGKey(seed), jcfg)
    tcfg = tclf.ClassifierConfig(**common)
    tparams = classifier_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(Bb=8, Tb=8, V=30, seed=1):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, Tb + 1, size=Bb).astype(np.int32)
    lens[0] = Tb
    toks = rng.randint(2, V, size=(Bb, Tb)).astype(np.int32)
    toks[np.arange(Tb)[None, :] >= lens[:, None]] = 0
    valid = np.ones(Bb, bool)
    valid[-2:] = False
    return {"tokens": toks, "lengths": lens,
            "labels": rng.randint(0, 2, size=Bb).astype(np.int32),
            "valid": valid}


@pytest.mark.parametrize("route,remat", [("plain", None), ("plain", 4),
                                         ("kernels", None), ("kernels", 4)])
def test_classifier_bf16_matches_jax(route, remat, monkeypatch):
    """The bf16 classifier's loss and gradients against JAX's. ``kernels``:
    without remat the stacked pair's twins against JAX's stacked kernel;
    with remat each direction's residentx forward twin and the plain
    recompute against JAX's residentx forward and its recompute (both
    sides' sequence gates set to 0 so T=8 takes the residentx class)."""
    kernels = route == "kernels"
    jcfg, jparams, tcfg, tparams = _models(remat, seed=3 + (remat or 0),
                                           use_pallas=kernels)
    if kernels:
        monkeypatch.setattr(jpallas, "_FUSEDX_MIN_T", 0)
        monkeypatch.setattr(jpallas, "supported", lambda *a, **k: True)
        real_scan = jpallas.pallas_lstm_scan
        monkeypatch.setattr(jpallas, "pallas_lstm_scan",
                            lambda *a, **k: real_scan(*a, interpret=True, **k))
        monkeypatch.setattr(jbilstm, "bilstm_supported", lambda *a, **k: True)
        real_bi = jbilstm.pallas_bilstm_scan
        monkeypatch.setattr(jbilstm, "pallas_bilstm_scan",
                            lambda *a, **k: real_bi(*a, interpret=True, **k))
        monkeypatch.setattr(cuda_lstmx, "FUSEDX_MIN_T", 0)
        if remat is None:
            monkeypatch.setattr(
                tclf, "bidir_lstm_scan",
                lambda pf, pb, xs, *, mask, remat_chunk, compute_dtype:
                cuda_bilstm.cuda_bilstm_scan(pf, pb, xs, mask=mask,
                                             compute_dtype=compute_dtype))
        else:
            monkeypatch.setattr(tscan, "auto_lstm_scan",
                                lambda *a, bptt="sequential", **k:
                                tscan.kernel_lstm_scan(*a, **k))
    b = _batch(seed=2 + (remat or 0))
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jclf.classifier_loss(p, b, jcfg), has_aux=True)(jparams)
    leaves = [t.requires_grad_() for t in tloop.param_leaves(tparams)]
    params = tloop.params_from_leaves(tparams, leaves)
    counters = (cuda_lstmx.bi_fwdx_bf16_counts, cuda_lstmx.bi_bwdx_bf16_counts,
                cuda_lstmx.fwdx_bf16_counts, cuda_lstmx.bwdx_bf16_counts)
    before = _counts(*counters)
    tl, taux = tclf.classifier_loss(
        params, {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
    tg = torch.autograd.grad(tl, leaves)
    ran = [a - c for a, c in zip(_counts(*counters), before)]
    want = ([0, 0, 0, 0] if not kernels else [1, 1, 0, 0] if remat is None
            else [0, 0, 2, 0])
    assert ran == want
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, atol=0)
    np.testing.assert_allclose(taux["accuracy"].item(),
                               float(jaux["accuracy"]), atol=1e-6)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg) == 12 * 2 + 3
    share = KERNEL_GRAD if kernels else PLAIN_GRAD
    for i, (a, e) in enumerate(zip(tg, jleaves)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   err_msg=f"leaf {i}",
                                   atol=share * float(np.abs(e).max()))


# ---------------------------------------------------------------------------
# 7, 8. the command line
# ---------------------------------------------------------------------------


IMDB_BF16 = ["--dataset", "imdb", "--device", "cpu", "--hidden-units", "8",
             "--seq-len", "16", "--batch-size", "8", "--optimizer", "adam",
             "--learning-rate", "1e-2", "--clip-norm", "1.0",
             "--compute-dtype", "bfloat16"]
N_STEPS = 4


def _jax_params(np_params):
    """The port's classifier dict as numpy leaves → JAX's parameter tree."""
    t = classifier_params_to_numpy(np_params)
    return {"embedding": jnp.asarray(t["embedding"]),
            "fwd": [jcell.LSTMParams(**{k: jnp.asarray(v)
                                        for k, v in layer.items()})
                    for layer in t["fwd"]],
            "bwd": [jcell.LSTMParams(**{k: jnp.asarray(v)
                                        for k, v in layer.items()})
                    for layer in t["bwd"]],
            "head": {k: jnp.asarray(v) for k, v in t["head"].items()}}


@pytest.mark.parametrize("remat", [None, 8])
def test_cli_imdb_bf16_matches_jax_trajectory(tmp_path, remat):
    """``train --dataset imdb --compute-dtype bfloat16`` (± --remat-chunk)
    on the CPU: its logged losses against JAX's ``make_train_step`` with
    ``classifier_loss(compute_dtype=bfloat16)`` over the run's own initial
    weights and its first batches (what ``cli.training`` builds for the
    same flags)."""
    flags = IMDB_BF16 + (["--remat-chunk", str(remat)] if remat else [])
    run = tcli.training(flags + ["--num-steps", str(N_STEPS)])
    feed = iter(run.feed)
    batches = [{k: v.numpy() for k, v in next(feed).items()}
               for _ in range(N_STEPS)]
    jparams = _jax_params(run.state.params)
    V = jparams["embedding"].shape[0]
    jcfg = jclf.ClassifierConfig(vocab_size=V, hidden_size=8,
                                 compute_dtype="bfloat16", remat_chunk=remat)
    jo = jopt.make_optimizer("adam", 1e-2, clip_norm=1.0)
    jstate = jloop.init_train_state(jparams, jo, jax.random.PRNGKey(0))
    jstep = jloop.make_train_step(
        lambda p, bt, rng: jclf.classifier_loss(p, bt, jcfg), jo)
    jl = []
    for bt in batches:
        jstate, jm = jstep(jstate, bt)
        jl.append(float(jm["loss"]))

    path = tmp_path / "m.jsonl"
    assert tcli.main(["train", *flags, "--num-steps", str(N_STEPS),
                      "--log-every", "1", "--jsonl", str(path)]) == OK_RC
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    tl = [r["loss"] for r in recs if "loss" in r]
    assert len(tl) == N_STEPS
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    assert recs[-1]["note"] == "final"


def test_cli_lm_bf16_at_seq_len_256(tmp_path):
    """The bf16 LM at --seq-len 256 (the residentx class on the card) runs
    on the CPU: exits 0 with finite losses, nothing refused."""
    path = tmp_path / "m.jsonl"
    rc = tcli.main(["train", "--device", "cpu", "--hidden-units", "8",
                    "--batch-size", "2", "--seq-len", "256", "--num-steps",
                    "2", "--log-every", "1", "--eval-batches", "1",
                    "--compute-dtype", "bfloat16", "--jsonl", str(path)])
    assert rc == OK_RC
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("flag", ["compute_dtype", "logits_dtype"])
def test_train_dtype_defaults_equal_jax(flag):
    """The port's train command defaults to JAX's: bfloat16 compute,
    float32 logits."""
    port = tcli.build_train_parser().parse_args([])
    jax_args = jcli.build_parser().parse_args([])
    assert getattr(port, flag) == getattr(jax_args, flag)
    assert (port.compute_dtype, port.logits_dtype) == ("bfloat16", "float32")
