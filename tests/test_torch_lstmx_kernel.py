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
    the backward keeps its slice of Uᵀ in shared memory in clusters of 4
    rows that fill 128 of the 132 SMs, and the forward's chain keeps U in
    its threads' registers in clusters of 8 rows on 64 SMs, leaving 68 to
    its projection."""
    p = cuda_lstmx.plan(B_, H_, D_, ndir)
    assert 1 <= p.cluster <= cuda_lstmx.MAX_CLUSTER
    assert (p.cluster - 1) * p.units < H_ <= p.cluster * p.units
    for k in (p.fwd, p.bwd):
        assert 1 <= k.rows <= k.rows4 and k.rows4 % 4 == 0
        assert (k.groups - 1) * k.rows < B_ <= k.groups * k.rows
        assert k.smem_bytes <= cuda_lstmx.MAX_SMEM_BYTES
    assert p.bwd.chunk in cuda_lstmx.CHUNKS
    assert p.fwd.chunk * p.fwd.rows4 == cuda_lstmx.PROJ_ROWS
    assert p.fwd.ksplit == p.zks
    if (B_, H_, D_, ndir) == (32, 256, 256, 2):
        assert (p.cluster, p.units) == (8, 32)
        assert (p.bwd.rows, p.bwd.groups) == (4, 8) and p.bwd.u_in_smem
        assert p.cluster * p.bwd.groups * ndir == 128
        assert (p.fwd.rows, p.fwd.groups) == (8, 4) and p.fwd.u_in_regs
        assert cuda_lstmx.projection_sms(p, ndir, 132) == 68


@pytest.mark.parametrize("ndir,fwd_rows,bwd_rows", [(2, 8, 8), (1, 4, 4)])
def test_plan_rows_follow_resident_clusters(ndir, fwd_rows, bwd_rows):
    """On a card that keeps 15 clusters of 8 blocks (the H100 at 227 KB a
    block), config 2's stacked pair takes 8-row clusters, 8 in one wave
    (the backward's chain keeps only dz and Uᵀ in shared memory, so its
    rebuild chunk does not shrink with the rows); one direction fits in
    one wave either way."""
    p = cuda_lstmx.plan(32, 256, 256, ndir, 132, max_clusters=15)
    assert (p.fwd.rows, p.bwd.rows) == (fwd_rows, bwd_rows)
    assert p.fwd.groups * ndir <= 15 and p.bwd.groups * ndir <= 15
    assert p.fwd.chunk >= cuda_lstmx.MIN_ONE_WAVE_CHUNK
    assert p.bwd.chunk >= cuda_lstmx.MIN_ONE_WAVE_CHUNK
    assert cuda_lstmx.plan(32, 256, 256, ndir, 132, max_clusters=16).bwd.rows == 4
    assert cuda_lstmx.plan(32, 256, 256, 2, 132, max_clusters=16) == \
        cuda_lstmx.plan(32, 256, 256, 2, 132)


# csrc/lstmx_bwd.cu: bwd_smem_floats (the chain kernel) and
# factors_smem_floats (the z rebuild), in floats
def _bwd_smem(H, upc, rows4, lanes, smem_ut):
    """``smem_ut``: Uᵀ's slice in shared memory (not in the lanes'
    registers, nor read through L2)."""
    G = 4 * H
    return 4 * (2 * G * rows4 + 4 + ((G + lanes) * upc if smem_ut else 0))


def _rebuild_smem(H, D, upc, rows4, chunk):
    E = chunk * rows4
    return 4 * (max(D, H) * (E + 4) + E * 4 * upc)


@pytest.mark.parametrize("B_,H_,D_,ndir", [
    (64, 128, 128, 1), (32, 256, 256, 2), (32, 256, 256, 1),
    (8, 200, 72, 2), (8, 16, 12, 2), (3, 5, 7, 1), (512, 128, 128, 2),
    (32, 256, 512, 2)])
def test_backward_plan_mirrors_its_layout(B_, H_, D_, ndir):
    """The backward's bytes mirror its chain kernel's layout (dz double
    buffer, mbarriers, Uᵀ's slice unless the lanes hold it), its rebuild
    takes the largest chunk whose staging fits, and its lane groups
    (``ksplit`` lanes, a power of two, per unit and row quad) fit a block's
    256 threads; the factor stream holds 8 float4s per step, row quad and
    unit of a cluster."""
    p = cuda_lstmx.plan(B_, H_, D_, ndir)
    kp = p.bwd
    assert kp.smem_bytes == _bwd_smem(H_, p.units, kp.rows4, kp.ksplit,
                                      kp.u_in_smem)
    assert kp.smem_bytes <= cuda_lstmx.MAX_SMEM_BYTES
    assert _rebuild_smem(H_, D_, p.units, kp.rows4, kp.chunk) <= \
        cuda_lstmx.MAX_SMEM_BYTES
    for c in (c for c in cuda_lstmx.CHUNKS if c > kp.chunk):
        assert _rebuild_smem(H_, D_, p.units, kp.rows4, c) > \
            cuda_lstmx.MAX_SMEM_BYTES
    ks = kp.ksplit
    assert ks & (ks - 1) == 0 and 1 <= ks <= 32
    assert ks * p.units * (kp.rows4 // 4) <= cuda_lstmx.BWD_THREADS
    # Uᵀ's terms sit in the lanes' registers exactly when they fit
    assert kp.u_in_regs == (-(-4 * H_ // ks) <= cuda_lstmx.BWD_UT_REG)
    assert not (kp.u_in_regs and kp.u_in_smem)
    T = 10
    assert cuda_lstmx.factor_floats(T, ndir, p) == 4 * T * ndir * \
        kp.groups * (kp.rows4 // 4) * 8 * p.cluster * p.units
    if (B_, H_, D_, ndir) == (64, 128, 128, 1):  # the LM at T=256
        assert (p.cluster, p.units, kp.rows, kp.groups, ks, kp.chunk) == \
            (4, 32, 4, 16, 8, 8) and kp.u_in_regs
    if (B_, H_, D_) == (32, 256, 256):  # config 2
        assert (kp.rows, kp.chunk, ks) == (4, 8, 8) and kp.u_in_smem


# csrc/lstmx_fwd.cu: chain_smem_floats (the chain kernel), in floats
def _chain_smem(H, upc, rows4, zks, where):
    """h double-buffered (128 zero rows each when U sits in registers), the
    pieces of h @ U, a step's zx double-buffered, c, the mask, mbarriers,
    U's slice in shared memory, or with U in registers and 8 rows the
    second column of each thread's pair (128 terms a piece)."""
    ncp = -(-4 * upc // 32) * 32  # the block's columns, a warp's multiple
    red = -(-zks * ncp * (rows4 + 1) // 4) * 4
    pad = 128 if where == "regs" else 0
    ub = zks * 128 * 64 if where == "regs" and rows4 == 8 else 0
    return 4 * (2 * (H + pad) * rows4 + red + 8 * upc * rows4 + upc * rows4
                + 2 * rows4 + 4 + (H * ncp if where == "smem" else 0) + ub)


@pytest.mark.parametrize("B_,H_,D_,ndir,want", [
    (32, 256, 256, 2, (8, 4, 8, "regs", 68)),
    (32, 256, 256, 1, (4, 8, 16, "regs", 68)),
    (64, 128, 128, 1, (4, 16, 16, "regs", 68)),
    (8, 200, 72, 2, (4, 2, 16, "regs", 104)),
    (8, 16, 12, 2, (4, 2, 16, "regs", 128)),
    (3, 5, 7, 1, (3, 1, 16, "regs", 131)),
    (512, 128, 128, 2, (8, 64, 8, "regs", -380)),
    (32, 300, 256, 2, (8, 4, 8, "smem", 68)),
    (64, 650, 256, 1, (8, 8, 8, "l2", 68)),
    (32, 1024, 1024, 1, (4, 8, 16, "l2", 68))])
def test_forward_plan_mirrors_its_layout(B_, H_, D_, ndir, want):
    """The forward's chain: its bytes a block mirror its layout (h double-
    buffered, the pieces of h @ U, a step's zx double-buffered, c, the
    mask, mbarriers, and U's slice when it sits in shared memory); U sits
    in the threads' registers when a piece of h @ U has at most 128 terms
    (a thread a column and piece; with 8 rows a pair of columns and a row
    quad, the second column's terms in shared memory), else in shared
    memory when it fits, else is read through L2; a cluster takes at most
    8 rows,
    and on an H100 (132 SMs, 15 resident clusters of 8, 30 of 4) the
    fewest rows whose clusters all run at once and leave the projection
    at least 8 SMs; the projection's chunk fills its 64-row tile.
    ``want``: rows, clusters a direction, chunk, where U lives, and the
    SMs left to the projection (negative: the chain runs in waves and
    the projection goes first)."""
    cs, upc = cuda_lstmx.cluster_units(H_)
    mc = {8: 15, 4: 30}.get(cs)
    p = cuda_lstmx.plan(B_, H_, D_, ndir, 132, max_clusters=mc)
    kp = p.fwd
    where = "regs" if kp.u_in_regs else "smem" if kp.u_in_smem else "l2"
    assert (kp.rows, kp.groups, kp.chunk, where,
            cuda_lstmx.projection_sms(p, ndir, 132)) == want
    assert kp.smem_bytes == _chain_smem(H_, upc, kp.rows4, p.zks, where)
    assert kp.smem_bytes <= cuda_lstmx.MAX_SMEM_BYTES
    assert kp.rows4 <= cuda_lstmx.FWD_MAX_ROWS
    assert kp.chunk * kp.rows4 == cuda_lstmx.PROJ_ROWS
    kc = -(-H_ // p.zks)  # terms of a piece
    assert kp.u_in_regs == (kc <= cuda_lstmx.FWD_U_REG)
    if kp.u_in_regs:  # a thread a piece of one column (4 rows) or of two
        # (8 rows: a row quad each, 64 pairs)
        groups = 64 if kp.rows4 == 8 else -(-4 * upc // 32) * 32
        assert p.zks * groups <= cuda_lstmx.THREADS // (kp.rows4 // 4)
        assert kp.rows4 == 4 or 4 * upc <= 128
    else:
        fits = _chain_smem(H_, upc, kp.rows4, p.zks, "smem") <= \
            cuda_lstmx.MAX_SMEM_BYTES
        assert kp.u_in_smem == fits
    # the fewest rows (a multiple of 4) whose clusters all run at once and
    # leave the projection its SMs, unless a cluster would take more than
    # 8 rows
    limit = min(mc or 132 // cs, (132 - 8) // cs) // ndir * ndir
    assert kp.groups * ndir <= limit or kp.rows4 == cuda_lstmx.FWD_MAX_ROWS
    assert kp.rows4 == 4 or -(-B_ // (kp.rows4 - 4)) * ndir > limit
    assert cuda_lstmx.zx_floats(10, H_, ndir, p) == \
        4 * 10 * ndir * kp.groups * H_ * kp.rows4


def _fwd_zks(H):
    """The forward's pieces of h @ U (lstmx_fwd.cu): ceil(H / KS) terms a
    piece, KS from the forward's own clusters."""
    cs, upc = cuda_lstmx.cluster_units(H)
    return max(1, min(cuda_lstmx.THREADS // (4 * upc),
                      H // cuda_lstmx.MIN_SPLIT))


@pytest.mark.parametrize("B_,H_,D_,ndir", [
    (64, 128, 128, 1), (32, 256, 256, 2), (32, 256, 256, 1),
    (8, 200, 72, 1), (8, 200, 72, 2)])
def test_backward_rebuilds_in_the_forwards_pieces(B_, H_, D_, ndir):
    """Whatever rows the backward takes, for every number of resident
    clusters the card may report, its z rebuild sums h @ U in the
    forward's pieces: the plan's ``zks``, which the backward kernel is
    launched with, is the forward's own, set by the forward's clusters."""
    want = _fwd_zks(H_)
    for mc in range(1, 34):
        p = cuda_lstmx.plan(B_, H_, D_, ndir, 132, max_clusters=mc)
        assert p.zks == p.fwd.ksplit == want
        assert (p.cluster, p.units) == cuda_lstmx.cluster_units(H_)


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


@pytest.mark.parametrize("name", ["lstmx_fwd", "lstmx_bwd", "lstm_fwd",
                                  "lstm_bwd", "lstm_tiled_fwd",
                                  "lstm_tiled_bwd", "decode_window",
                                  "spec_window"])
def test_phase_clock_marks_match_their_names(name):
    """Each kernel source has marks 0, 1, ... in source order, one per
    phase name that ``phase_clocks`` prints, and one clock start per clock
    stream (one per marking thread), the streams covering every mark."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    marks = [int(m) for m in re.findall(r"CLK_MARK(?:_AT)?\((\d+)", src)]
    assert marks == list(range(len(phase_clocks.PHASES[name])))
    assert sum(n for _, n, _ in phase_clocks.streams(name)) == len(marks)
    assert src.count("CLK_START") == len(phase_clocks.streams(name))
