"""The port's residentx recurrence (``ops/cuda_lstmx.py``) and its stacked
bi-LSTM form (``ops/cuda_bilstm.py``) against the JAX Pallas kernels.

On the CPU the autograd Function runs the kernels' plain versions; here it
is held against the JAX package's residentx pair as its own tests run it:
``pallas_lstm_scan(..., interpret=True)`` with ``_FUSEDX_MIN_T`` set to 0
so the short sequence takes the residentx path (``_lstm_fwdx_kernel`` /
``_lstm_bwdx_kernel``), and ``pallas_bilstm_scan(..., interpret=True)``
(``_bi_fwdx_kernel`` / ``_bi_bwdx_kernel``), on the same numpy inputs and
bridged weights. Values to atol 1e-5; gradients of every per-gate
parameter, xs, h0 and c0 to atol 1e-5 / rtol 1e-4 (float32 sums over T·B
taken in another order). The launch plan is checked for fitting and
refusing, and the backward's z rebuild against the forward's z.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import kernels, phase_clocks
from lstm_tensorspark_torch.ops import cuda_bilstm, cuda_lstm, cuda_lstmx
from lstm_tensorspark_torch.ops import lstm_cell as tcell
from lstm_tensorspark_tpu.ops import lstm_cell as jcell
from lstm_tensorspark_tpu.ops import pallas_lstm as jpallas
from lstm_tensorspark_tpu.ops.pallas_bilstm import pallas_bilstm_scan
from lstm_tensorspark_tpu.ops.pallas_lstm import pallas_lstm_scan

torch.set_num_threads(1)

B, T, D, H = 8, 8, 12, 16
ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
# right padding of every kind: full rows, a 1-step row, assorted lengths
LENGTHS = np.array([8, 1, 5, 8, 7, 2, 6, 3])


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _jparams(seed, d_in=D):
    return jax.tree.map(np.asarray, jcell.init_lstm_params(
        jax.random.PRNGKey(seed), d_in, H))


def _tparams(jp):
    return tcell.LSTMParams(*(_t(getattr(jp, f)).requires_grad_()
                              for f in tcell.LSTMParams._fields))


def _mask(masked):
    return (np.arange(T)[None, :] < LENGTHS[:, None]) if masked else None


def _grads_close(tgrads, jgrads, names):
    assert len(tgrads) == len(jgrads)
    for name, a, b in zip(names, tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("masked,reverse", [(False, False), (True, False),
                                            (True, True)])
def test_single_direction_matches_residentx_pallas(monkeypatch, masked,
                                                   reverse):
    monkeypatch.setattr(jpallas, "_FUSEDX_MIN_T", 0)
    jp = _jparams(3)
    rng = np.random.RandomState(4)
    xs = rng.randn(B, T, D).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    wy, wh, wc = (rng.randn(*s).astype(np.float32)
                  for s in ((B, T, H), (B, H), (B, H)))
    mask = _mask(masked)

    def jloss(p, x, h, c):
        (hT, cT), ys = pallas_lstm_scan(
            p, x, (h, c), mask=None if mask is None else jnp.asarray(mask),
            reverse=reverse, interpret=True)
        return (jnp.sum(ys * wy) + jnp.sum(hT * wh) + jnp.sum(cT * wc),
                (ys, hT, cT))

    (_, jouts), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                                has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(xs), jnp.asarray(h0),
        jnp.asarray(c0))

    tp = _tparams(jp)
    x, h, c = (_t(a).requires_grad_() for a in (xs, h0, c0))
    before = (cuda_lstmx.fwdx_counts.reference,
              cuda_lstmx.bwdx_counts.reference)
    (hT, cT), ys = cuda_lstmx.cuda_lstmx_scan(
        tp, x, (h, c), mask=None if mask is None else torch.from_numpy(mask),
        reverse=reverse)
    loss = (ys * _t(wy)).sum() + (hT * _t(wh)).sum() + (cT * _t(wc)).sum()
    tg = torch.autograd.grad(loss, [*tp, x, h, c])
    assert (cuda_lstmx.fwdx_counts.reference - before[0],
            cuda_lstmx.bwdx_counts.reference - before[1]) == (1, 1)
    for name, a, b in zip(("ys", "hT", "cT"), (ys, hT, cT), jouts):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL, rtol=0, err_msg=name)
    expect = [getattr(jg[0], f) for f in tcell.LSTMParams._fields]
    _grads_close(tg, expect + list(jg[1:]),
                 list(tcell.LSTMParams._fields) + ["xs", "h0", "c0"])


@pytest.mark.parametrize("masked", [False, True])
def test_bilstm_matches_stacked_pallas(masked):
    """Both directions in one Function call against
    ``pallas_bilstm_scan``: outputs of both directions and the gradients of
    both directions' params and of xs, over lengths 1..T when masked."""
    jf, jb = _jparams(5), _jparams(6)
    rng = np.random.RandomState(7)
    xs = rng.randn(B, T, D).astype(np.float32)
    w = [rng.randn(*s).astype(np.float32)
         for s in ((B, T, H), (B, H), (B, H)) * 2]
    mask = _mask(masked)

    def weighted(out, ws):
        ((hf, cf), ysf), ((hb, cb), ysb) = out
        outs = (ysf, hf, cf, ysb, hb, cb)
        return sum((o * wi).sum() for o, wi in zip(outs, ws)), outs

    def jloss(pf, pb, x):
        return weighted(pallas_bilstm_scan(
            pf, pb, x, mask=None if mask is None else jnp.asarray(mask),
            interpret=True), [jnp.asarray(a) for a in w])

    (_, jouts), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                has_aux=True))(
        jax.tree.map(jnp.asarray, jf), jax.tree.map(jnp.asarray, jb),
        jnp.asarray(xs))

    tf, tb = _tparams(jf), _tparams(jb)
    x = _t(xs).requires_grad_()
    before = (cuda_lstmx.bi_fwdx_counts.reference,
              cuda_lstmx.bi_bwdx_counts.reference)
    out = cuda_bilstm.cuda_bilstm_scan(
        tf, tb, x, mask=None if mask is None else torch.from_numpy(mask))
    loss, touts = weighted(out, [_t(a) for a in w])
    tg = torch.autograd.grad(loss, [*tf, *tb, x])
    assert (cuda_lstmx.bi_fwdx_counts.reference - before[0],
            cuda_lstmx.bi_bwdx_counts.reference - before[1]) == (1, 1)
    for name, a, b in zip(("ys_f", "hT_f", "cT_f", "ys_b", "hT_b", "cT_b"),
                          touts, jouts):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL, rtol=0, err_msg=name)
    fields = tcell.LSTMParams._fields
    expect = ([getattr(jg[0], f) for f in fields]
              + [getattr(jg[1], f) for f in fields] + [jg[2]])
    _grads_close(tg, expect, [f"fwd.{f}" for f in fields]
                 + [f"bwd.{f}" for f in fields] + ["xs"])


def test_backward_rebuilds_the_forwards_z():
    """The plain backward rebuilds z from xs and h_prev; its dz equals
    autograd's gradient of the plain forward with respect to xproj = the
    input projection, for both directions of a stacked call."""
    rng = np.random.RandomState(9)
    ND, Bd = 2, 3
    xs = _t(rng.randn(T, ND * Bd, D))
    W = _t(rng.randn(ND, D, 4 * H) / np.sqrt(D))
    b = _t(rng.randn(ND, 4 * H) * 0.1)
    U = _t(rng.randn(ND, H, 4 * H) / np.sqrt(H))
    h0, c0 = (_t(rng.randn(ND * Bd, H) * 0.5) for _ in range(2))
    lens = np.array([8, 4, 1, 7, 8, 2])
    mask = _t((np.arange(T)[:, None] < lens[None, :]).astype(np.float32))
    ys, hT, cT, cs = cuda_lstmx.lstmx_forward_reference(
        xs, W, b, U, h0, c0, mask, save_c=True)
    dys = _t(rng.randn(T, ND * Bd, H))
    dhT, dcT = _t(rng.randn(ND * Bd, H)), _t(rng.randn(ND * Bd, H))
    dz, dh0, dc0 = cuda_lstmx.lstmx_backward_reference(
        xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask)
    for d in range(ND):
        r = slice(d * Bd, (d + 1) * Bd)
        xproj = (xs[:, r] @ W[d] + b[d]).requires_grad_()
        h, c = h0[r].clone().requires_grad_(), c0[r].clone().requires_grad_()
        y, hh, cc = cuda_lstm.lstm_forward_reference(xproj, U[d], h, c,
                                                     mask[:, r])
        torch.testing.assert_close(y, ys[:, r], rtol=0, atol=0)
        loss = (y * dys[:, r]).sum() + (hh * dhT[r]).sum() + (cc * dcT[r]).sum()
        gx, gh, gc = torch.autograd.grad(loss, [xproj, h, c])
        for a, e in ((dz[:, r], gx), (dh0[r], gh), (dc0[r], gc)):
            np.testing.assert_allclose(a.numpy(), e.numpy(), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL)


def test_no_grad_runs_forward_without_cs():
    rng = np.random.RandomState(0)
    xs, W = _t(rng.randn(5, 2, D)), _t(rng.randn(1, D, 4 * H))
    b, U = _t(rng.randn(1, 4 * H)), _t(rng.randn(1, H, 4 * H))
    h0, c0 = _t(rng.randn(2, H)), _t(rng.randn(2, H))
    with torch.no_grad():
        out = cuda_lstmx.lstmx_recurrence(xs, W.requires_grad_(), b, U, h0, c0)
    assert len(out) == 3 and out[0].grad_fn is None


@pytest.mark.parametrize("B_,H_,D_,ndir", [
    (32, 256, 256, 2), (32, 256, 256, 1), (64, 128, 128, 1),
    (8, 200, 72, 2), (8, 16, 12, 2), (3, 5, 7, 1), (512, 128, 128, 2),
    (32, 256, 512, 2)])
def test_plan_fits_the_card(B_, H_, D_, ndir):
    """Every shape gets a plan whose clusters of at most 8 blocks cover H
    without an empty block, whose row groups cover each direction's rows,
    and whose buffers fit a block's 227 KB of shared memory; at config 2
    each block keeps its slices of U and Uᵀ in shared memory, and its
    clusters (4 rows each) fill 128 of the 132 SMs."""
    p = cuda_lstmx.plan(B_, H_, D_, ndir)
    assert 1 <= p.cluster <= cuda_lstmx.MAX_CLUSTER
    assert (p.cluster - 1) * p.units < H_ <= p.cluster * p.units
    for k in (p.fwd, p.bwd):
        assert 1 <= k.rows <= k.rows4 and k.rows4 % 4 == 0
        assert (k.groups - 1) * k.rows < B_ <= k.groups * k.rows
        assert k.smem_bytes <= cuda_lstmx.MAX_SMEM_BYTES
        assert k.chunk in cuda_lstmx.CHUNKS
    assert p.fwd.ksplit == p.zks
    if (B_, H_, D_, ndir) == (32, 256, 256, 2):
        assert (p.cluster, p.units) == (8, 32)
        for k in (p.fwd, p.bwd):
            assert (k.rows, k.groups) == (4, 8) and k.u_in_smem
            assert p.cluster * k.groups * ndir == 128


@pytest.mark.parametrize("ndir,fwd_rows,bwd_rows", [(2, 8, 4), (1, 4, 4)])
def test_plan_rows_follow_resident_clusters(ndir, fwd_rows, bwd_rows):
    """On a card that keeps 15 clusters of 8 blocks (the H100 at 227 KB a
    block), config 2's stacked forward takes 8-row clusters, 8 in one wave,
    while the backward keeps 4-row clusters, since 8 rows would leave it a
    one-step projection chunk; one direction fits in one wave either way."""
    p = cuda_lstmx.plan(32, 256, 256, ndir, 132, max_clusters=15)
    assert (p.fwd.rows, p.bwd.rows) == (fwd_rows, bwd_rows)
    assert p.fwd.groups * ndir <= 15
    assert p.fwd.chunk >= cuda_lstmx.MIN_ONE_WAVE_CHUNK
    assert cuda_lstmx.plan(32, 256, 256, ndir, 132, max_clusters=16).bwd.rows == 4
    assert cuda_lstmx.plan(32, 256, 256, 2, 132,
                           max_clusters=15)._replace(fwd=None) == \
        cuda_lstmx.plan(32, 256, 256, 2, 132)._replace(fwd=None)


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_lstmx.plan(64, 4096, 4096, 2)
    with pytest.raises(ValueError, match="ndir"):
        cuda_lstmx.plan(8, 16, 16, 3)
    assert not cuda_lstmx.fits(64, 4096, 4096, 2)


def test_bilstm_supported_gate():
    """The stacked pair needs T >= FUSEDX_MIN_T and a fitting plan."""
    assert cuda_bilstm.bilstm_supported(32, 256, 256, 400)
    assert not cuda_bilstm.bilstm_supported(32, 256, 256, 255)
    assert not cuda_bilstm.bilstm_supported(64, 4096, 4096, 400)


def test_defined_macros_build_apart():
    """An instrumented build (``kernels.defined``) has its own library, and
    the plain one is back after the block."""
    plain = kernels.library_path("lstmx_fwd")
    with kernels.defined(phase_clocks.MACRO):
        assert kernels.library_path("lstmx_fwd") != plain
    assert kernels.library_path("lstmx_fwd") == plain


@pytest.mark.parametrize("name", ["lstmx_fwd", "lstmx_bwd"])
def test_phase_clock_marks_match_their_names(name):
    """Each kernel has one clock start and marks 0, 1, ... in source order,
    one per phase name that ``phase_clocks`` prints."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    marks = [int(m) for m in re.findall(r"CLK_MARK\((\d+)\)", src)]
    assert marks == list(range(len(phase_clocks.PHASES[name])))
    assert src.count("CLK_START") == 1
