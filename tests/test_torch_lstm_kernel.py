"""The port's LSTM recurrence Function against the JAX Pallas kernels.

``lstm_tensorspark_torch.ops.cuda_lstm`` joins the forward and fused-BPTT
kernels (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``) in a
``torch.autograd.Function``; on the CPU the Function runs their plain
versions. Here it is held against ``pallas_lstm_scan(..., interpret=True)``
(the JAX package's ``_lstm_kernel`` / ``_lstm_bwd_kernel`` pair, run as the
JAX package's own tests run it) on the same numpy inputs and bridged
weights: values to atol 1e-5, gradients of every per-gate parameter, xs,
h0 and c0 to atol 1e-5 / rtol 1e-4 (float32 sums over T·B taken in another
order). The plain backward is also held against torch autograd through the
plain ``lstm_scan``, and the kernels' launch plans are checked for the
configs' shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.ops import cuda_lstm
from lstm_tensorspark_torch.ops import lstm_cell as tcell
from lstm_tensorspark_torch.ops import scan as tscan
from lstm_tensorspark_tpu.ops import lstm_cell as jcell
from lstm_tensorspark_tpu.ops.pallas_lstm import pallas_lstm_scan

torch.set_num_threads(1)

B, T, D = 8, 8, 12
ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _inputs(H, seed, masked, carry):
    jp = jax.tree.map(np.asarray,
                      jcell.init_lstm_params(jax.random.PRNGKey(seed), D, H))
    rng = np.random.RandomState(seed)
    xs = rng.randn(B, T, D).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.5).astype(np.float32) if carry else None
    c0 = (rng.randn(B, H) * 0.5).astype(np.float32) if carry else None
    mask = None
    if masked:  # right padding of assorted lengths, full and 1-step rows too
        lens = np.array([8, 3, 5, 1, 8, 6, 2, 7])
        mask = np.arange(T)[None, :] < lens[:, None]
    # cotangent weights for ys, hT, cT, so every output feeds the loss
    wy = rng.randn(B, T, H).astype(np.float32)
    wh = rng.randn(B, H).astype(np.float32)
    wc = rng.randn(B, H).astype(np.float32)
    return jp, xs, h0, c0, mask, (wy, wh, wc)


def _jax(jp, xs, h0, c0, mask, w, reverse):
    wy, wh, wc = (jnp.asarray(a) for a in w)
    carry = None if h0 is None else (jnp.asarray(h0), jnp.asarray(c0))
    m = None if mask is None else jnp.asarray(mask)

    def loss(p, x, carry):
        (hT, cT), ys = pallas_lstm_scan(p, x, carry, mask=m, reverse=reverse,
                                        interpret=True)
        return (jnp.sum(ys * wy) + jnp.sum(hT * wh) + jnp.sum(cT * wc),
                (ys, hT, cT))

    argnums = (0, 1) if carry is None else (0, 1, 2)
    (_, outs), grads = jax.value_and_grad(loss, argnums=argnums,
                                          has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(xs), carry)
    return outs, grads


def _port(jp, xs, h0, c0, mask, w, reverse,
          recurrence=cuda_lstm.lstm_recurrence):
    tp = tcell.LSTMParams(*(_t(getattr(jp, f)).requires_grad_()
                            for f in tcell.LSTMParams._fields))
    x = _t(xs).requires_grad_()
    carry = None
    if h0 is not None:
        carry = (_t(h0).requires_grad_(), _t(c0).requires_grad_())
    m = None if mask is None else torch.from_numpy(mask)
    (hT, cT), ys = cuda_lstm.cuda_lstm_scan(tp, x, carry, mask=m,
                                            reverse=reverse,
                                            recurrence=recurrence)
    wy, wh, wc = (_t(a) for a in w)
    loss = (ys * wy).sum() + (hT * wh).sum() + (cT * wc).sum()
    inputs = [*tp, x] + ([] if carry is None else list(carry))
    grads = torch.autograd.grad(loss, inputs)
    return (ys, hT, cT), grads


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_function_matches_pallas_kernels(masked, carry, reverse):
    H = 16
    args = _inputs(H, 3, masked, carry)
    self_counts = (cuda_lstm.fwd_counts.reference,
                   cuda_lstm.bwd_counts.reference)
    (touts, tgrads) = _port(*args, reverse)
    assert (cuda_lstm.fwd_counts.reference - self_counts[0],
            cuda_lstm.bwd_counts.reference - self_counts[1]) == (1, 1)
    jouts, jgrads = _jax(*args, reverse)
    for name, a, b in zip(("ys", "hT", "cT"), touts, jouts):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL, rtol=0, err_msg=name)
    jp_grad = jgrads[0]
    names = list(tcell.LSTMParams._fields) + ["xs", "h0", "c0"]
    expect = [getattr(jp_grad, f) for f in tcell.LSTMParams._fields]
    expect += [jgrads[1]] + ([] if not carry else list(jgrads[2]))
    assert len(tgrads) == len(expect)
    for name, a, b in zip(names, tgrads, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_function_matches_pallas_kernels_h32():
    args = _inputs(32, 5, False, True)
    touts, tgrads = _port(*args, False)
    jouts, jgrads = _jax(*args, False)
    np.testing.assert_allclose(touts[0].detach().numpy(), np.asarray(jouts[0]),
                               atol=ATOL, rtol=0)
    expect = [getattr(jgrads[0], f) for f in tcell.LSTMParams._fields]
    expect += [jgrads[1], *jgrads[2]]
    for a, b in zip(tgrads, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_backward_reference_matches_autograd(masked, reverse):
    """lstm_backward_reference (inside the Function) against torch autograd
    through the plain lstm_scan, and its dz against autograd's gradient of
    the plain forward with respect to xproj."""
    H = 16
    jp, xs, h0, c0, mask, w = _inputs(H, 7, masked, True)
    m = None if mask is None else torch.from_numpy(mask)
    wy, wh, wc = (_t(a) for a in w)

    def run(scan):
        tp = tcell.LSTMParams(*(_t(getattr(jp, f)).requires_grad_()
                                for f in tcell.LSTMParams._fields))
        x, h, c = (_t(a).requires_grad_() for a in (xs, h0, c0))
        (hT, cT), ys = scan(tp, x, (h, c), mask=m, reverse=reverse)
        loss = (ys * wy).sum() + (hT * wh).sum() + (cT * wc).sum()
        return torch.autograd.grad(loss, [*tp, x, h, c])

    for a, b in zip(run(cuda_lstm.cuda_lstm_scan), run(tscan.lstm_scan)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)

    # dz itself: the gradient with respect to xproj of the plain forward
    rng = np.random.RandomState(11)
    xproj = _t(rng.randn(T, B, 4 * H)).requires_grad_()
    U = _t(rng.randn(H, 4 * H) / np.sqrt(H))
    h, c = _t(h0).requires_grad_(), _t(c0).requires_grad_()
    mf = None if m is None else m.T.to(torch.float32).contiguous()
    ys, hT, cT, z, cs = cuda_lstm.lstm_forward_reference(
        xproj, U, h, c, mf, save_residuals=True)
    dys = _t(rng.randn(T, B, H))
    dhT, dcT = _t(rng.randn(B, H)), _t(rng.randn(B, H))
    loss = (ys * dys).sum() + (hT * dhT).sum() + (cT * dcT).sum()
    g_x, g_h, g_c = torch.autograd.grad(loss, [xproj, h, c])
    c_prev = torch.cat([c[None], cs[:-1]]).detach()
    dz, dh0, dc0 = cuda_lstm.lstm_backward_reference(
        z.detach(), c_prev, dys, U, dhT, dcT, mf)
    for a, b in ((dz, g_x), (dh0, g_h), (dc0, g_c)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_no_grad_runs_forward_without_residuals():
    """Under torch.no_grad the recurrence takes the forward alone (no
    Function, no residuals), as eval and prefill do."""
    rng = np.random.RandomState(0)
    H = 8
    xproj = _t(rng.randn(4, 3, 4 * H)).requires_grad_()
    U, h0, c0 = _t(rng.randn(H, 4 * H)), _t(rng.randn(3, H)), _t(rng.randn(3, H))
    with torch.no_grad():
        out = cuda_lstm.lstm_recurrence(xproj, U, h0, c0)
    assert len(out) == 3 and out[0].grad_fn is None
    ref = cuda_lstm.lstm_forward_reference(xproj.detach(), U, h0, c0)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,H", [(64, 128), (32, 650), (64, 1024), (8, 16),
                                 (3, 5), (512, 128)])
def test_launch_plan_fits_the_card(B, H):
    """Every config width gets a plan: clusters of at most 8 blocks that
    cover H without an empty block, rows that cover B, and buffers within
    a block's 227 KB of shared memory."""
    for kind in ("fwd", "bwd"):
        p = cuda_lstm.plan(kind, B, H)
        assert 1 <= p.cluster <= cuda_lstm.MAX_CLUSTER
        assert (p.cluster - 1) * p.units < H <= p.cluster * p.units
        assert 1 <= p.rows <= p.rows4 and p.rows4 % 4 == 0
        assert -(-B // p.rows) * p.rows >= B
        assert p.smem_bytes <= cuda_lstm.MAX_SMEM_BYTES
    # config 1: the forward's and the backward's lanes keep their slices of
    # U (of Uᵀ) in registers
    if (B, H) == (64, 128):
        assert cuda_lstm.plan("fwd", B, H).u_regs
        assert cuda_lstm.plan("bwd", B, H).u_regs


# csrc/lstm_fwd.cu: fwd_smem_floats, in floats
def _fwd_smem(H, upc, rows4, where):
    return 4 * (2 * H * rows4 + (4 * H * upc if where == "smem" else 0) + 4)


@pytest.mark.parametrize("B,H,where", [
    (64, 128, "regs"), (3, 128, "regs"), (16, 128, "regs"), (8, 16, "regs"),
    (3, 5, "regs"), (64, 256, "smem"), (512, 128, "smem"), (32, 650, "l2"),
    (64, 1024, "l2")])
def test_forward_plan_lanes_and_where_u_lives(B, H, where):
    """The forward's plan: a group of ``ksplit`` lanes (a power of two, at
    most 32) owns one unit and four rows, the groups fit the block's 256
    threads; U's slice sits in the lanes' registers exactly when a lane's
    ceil(H / ksplit) rows fit KREG, else in shared memory when it fits,
    else it is read through L2; the bytes asked for mirror the kernel's
    layout."""
    p = cuda_lstm.plan("fwd", B, H)
    ks = p.ksplit
    assert ks & (ks - 1) == 0 and 1 <= ks <= 32
    assert ks * p.units * (p.rows4 // 4) <= cuda_lstm.THREADS
    assert 2 * ks * p.units * (p.rows4 // 4) > cuda_lstm.THREADS or ks == 32
    assert p.u_regs == (-(-H // ks) <= cuda_lstm.KREG)
    got = "regs" if p.u_regs else "smem" if p.smem_w else "l2"
    assert got == where
    assert p.smem_bytes == _fwd_smem(H, p.units, p.rows4, got)


def test_launch_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_lstm.plan("bwd", 64, 4096)


# the clusters an H100 keeps resident at one block an SM
# (cudaOccupancyMaxActiveClusters on the card: PERF.md)
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


# csrc/lstm_bwd.cu: bwd_smem_floats, in bytes (4H padded to the lanes' 16
# terms in registers, else to 128 columns)
def _bwd_smem(H, upc, rows4, where):
    gp = 32 * 16 if where == "regs" else -(-4 * H // 128) * 128
    ut = -(-upc // 4) * gp * 4 if where == "smem" else 0
    return 4 * (2 * rows4 * gp + ut + 4)


@pytest.mark.parametrize("B,H,where", [
    (64, 128, "regs"), (32, 650, "l2"), (64, 1024, "l2"), (8, 16, "regs"),
    (3, 5, "regs"), (3, 128, "regs"), (64, 256, "smem"), (512, 128, "smem"),
    (16, 40, "regs")])
def test_backward_plan_slots_and_where_ut_lives(B, H, where):
    """The backward's plan on an H100: a warp sums a (unit quad, row quad)
    slot over 32 lanes, and the warps' slots cover every quad pair; Uᵀ's
    slice sits in the lanes' registers exactly when a lane's 16 terms of
    four units cover 4H and a warp's slots share one unit quad (at most
    four), else in shared memory when it fits, else it is read through L2;
    the bytes asked for mirror the kernel's layout and fit 227 KB; the
    clusters fit the card's resident clusters unless four rows are the
    most whose dz buffers fit a block."""
    cs = cuda_lstm.plan("bwd", B, H).cluster
    p = cuda_lstm.plan("bwd", B, H, max_clusters=H100_CLUSTERS[cs])
    assert p.cluster == cs and p.ksplit == 32
    uq, rq = -(-p.units // 4), p.rows4 // 4
    assert p.slots == cuda_lstm.bwd_slots(p.units, p.rows4)
    assert 1 <= p.slots <= cuda_lstm.MAX_SLOTS
    warps = min(cuda_lstm.WARPS, uq * max(1, cuda_lstm.WARPS // uq))
    assert warps * p.slots >= uq * rq
    got = "regs" if p.u_regs else "smem" if p.smem_w else "l2"
    assert got == where
    assert p.u_regs == (uq <= cuda_lstm.WARPS and 4 * H <= 32 * 16
                        and p.slots <= 4)
    assert p.smem_bytes == _bwd_smem(H, p.units, p.rows4, got)
    assert p.smem_bytes <= cuda_lstm.MAX_SMEM_BYTES
    assert -(-B // p.rows) <= H100_CLUSTERS[cs] or (
        p.rows4 == 4 and _bwd_smem(H, p.units, 8, "l2")
        > cuda_lstm.MAX_SMEM_BYTES)


@pytest.mark.parametrize("B,H", [(64, 4096), (1, 1900), (512, 2048)])
def test_backward_plan_refuses_what_does_not_fit(B, H):
    """A width whose dz buffers of four rows exceed a block's shared memory
    raises, whatever the batch."""
    with pytest.raises(ValueError, match="shared memory"):
        cuda_lstm.plan("bwd", B, H)


class _FactoredRecurrence(torch.autograd.Function):
    """The resident Function with ``lstm_backward_factored`` (the kernel's
    order of the algebra) in place of the plain backward."""

    @staticmethod
    def forward(ctx, xproj, U, h0, c0, mask):
        return cuda_lstm.recurrence_forward(ctx, cuda_lstm.lstm_forward,
                                            xproj, U, h0, c0, mask)

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        def factored(z, c0, cs, dys, U, dhT, dcT, mask):
            c_prev = torch.cat([c0[None], cs[:-1]])
            return cuda_lstm.lstm_backward_factored(z, c_prev, dys, U, dhT,
                                                    dcT, mask)

        return cuda_lstm.recurrence_backward(ctx, factored, dys, dhT, dcT)


def _factored(xproj, U, h0, c0, mask=None):
    return cuda_lstm.run_recurrence(_FactoredRecurrence,
                                    cuda_lstm.lstm_forward, xproj, U, h0, c0,
                                    mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_backward_factored_matches_pallas_kernels(masked, reverse):
    """The kernel's order of the algebra (factors first, one multiply a
    term) through the Function against the JAX pair in interpret mode."""
    args = _inputs(16, 9, masked, True)
    touts, tgrads = _port(*args, reverse, recurrence=_factored)
    jouts, jgrads = _jax(*args, reverse)
    expect = [getattr(jgrads[0], f) for f in tcell.LSTMParams._fields]
    expect += [jgrads[1], *jgrads[2]]
    names = list(tcell.LSTMParams._fields) + ["xs", "h0", "c0"]
    for name, a, b in zip(names, tgrads, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H", [5, 40])
def test_backward_factored_matches_reference(masked, H):
    """``lstm_backward_factored`` against ``lstm_backward_reference`` on
    the same residuals: dz, dh0, dc0 within 1e-5 of max(1, their size)
    (chip_smoke.py's tolerance for the kernel)."""
    rng = np.random.RandomState(13 + H)
    xproj = _t(rng.randn(T, B, 4 * H))
    U = _t(rng.randn(H, 4 * H) / np.sqrt(H))
    h0, c0 = _t(rng.randn(B, H) * 0.5), _t(rng.randn(B, H) * 0.5)
    mask = None
    if masked:
        lens = np.array([8, 3, 5, 1, 8, 6, 2, 7])
        mask = _t(np.arange(T)[:, None] < lens[None, :])
    _, _, _, z, cs = cuda_lstm.lstm_forward_reference(
        xproj, U, h0, c0, mask, save_residuals=True)
    c_prev = torch.cat([c0[None], cs[:-1]])
    dys = _t(rng.randn(T, B, H))
    dhT, dcT = _t(rng.randn(B, H)), _t(rng.randn(B, H))
    ref = cuda_lstm.lstm_backward_reference(z, c_prev, dys, U, dhT, dcT, mask)
    got = cuda_lstm.lstm_backward_factored(z, c_prev, dys, U, dhT, dcT, mask)
    for name, a, r in zip(("dz", "dh0", "dc0"), got, ref):
        tol = 1e-5 * max(1.0, float(r.abs().max()))
        assert float((a - r).abs().max()) <= tol, name


def test_dispatch_routes_cpu_to_plain_scan():
    """auto_lstm_scan takes the plain loop for CPU tensors (no kernel
    dispatch, no counted launch) and refuses the unported assoc BPTT."""
    jp, xs, h0, c0, _, _ = _inputs(16, 1, False, True)
    tp = tcell.LSTMParams(*(_t(getattr(jp, f)) for f in tcell.LSTMParams._fields))
    before = (cuda_lstm.fwd_counts.reference, cuda_lstm.fwd_counts.kernel)
    (hT, cT), ys = tscan.auto_lstm_scan(tp, _t(xs), (_t(h0), _t(c0)))
    assert (cuda_lstm.fwd_counts.reference, cuda_lstm.fwd_counts.kernel) == before
    (h2, c2), y2 = tscan.lstm_scan(tp, _t(xs), (_t(h0), _t(c0)))
    assert torch.equal(ys, y2) and torch.equal(hT, h2) and torch.equal(cT, c2)
    with pytest.raises(NotImplementedError, match="assoc"):
        tscan.auto_lstm_scan(tp, _t(xs), bptt="assoc")
