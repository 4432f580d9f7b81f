"""The port's scan dispatch: ``remat_chunk`` and the strategy lattice.

- ``lstm_scan(remat_chunk=)`` (``torch.utils.checkpoint``) gives the values
  and gradients of the scan without it (atol 1e-6: the chunked input
  projection may sum in another order), and refuses a T it does not
  divide with the JAX package's error; it also matches the JAX
  ``lstm_scan(remat_chunk=)`` (atol 1e-5).
- ``chosen_bwd_strategy`` / ``chosen_fwd_strategy`` / ``bidir_route``
  name the route a CUDA scan takes for each (T, remat, plan) case, as the
  JAX package's ``chosen_bwd_strategy`` and ``bidir_lstm_scan`` would.
- ``kernel_lstm_scan`` runs each route on CPU tensors (the kernels' plain
  versions) and equals the plain ``lstm_scan`` in values and gradients
  (atol 1e-5 / rtol 1e-4), including the recompute route's Function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.ops import cuda_lstm, cuda_lstmx
from lstm_tensorspark_torch.ops import lstm_cell as tcell
from lstm_tensorspark_torch.ops import scan as tscan
from lstm_tensorspark_tpu.ops import lstm_cell as jcell
from lstm_tensorspark_tpu.ops.scan import lstm_scan as jlstm_scan

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _setup(B, T, D, H, seed=0, masked=True):
    jp = jax.tree.map(np.asarray, jcell.init_lstm_params(
        jax.random.PRNGKey(seed), D, H))
    rng = np.random.RandomState(seed)
    xs = rng.randn(B, T, D).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    mask = None
    if masked:
        lens = rng.randint(1, T + 1, size=B)
        lens[0] = T
        mask = np.arange(T)[None, :] < lens[:, None]
    w = [rng.randn(*s).astype(np.float32) for s in ((B, T, H), (B, H), (B, H))]
    return jp, xs, h0, c0, mask, w


def _run(scan, jp, xs, h0, c0, mask, w, **kw):
    """Values and the gradients of every gate param, xs, h0 and c0."""
    tp = tcell.LSTMParams(*(_t(getattr(jp, f)).requires_grad_()
                            for f in tcell.LSTMParams._fields))
    x, h, c = (_t(a).requires_grad_() for a in (xs, h0, c0))
    m = None if mask is None else torch.from_numpy(mask)
    (hT, cT), ys = scan(tp, x, (h, c), mask=m, **kw)
    loss = sum((o * _t(wi)).sum() for o, wi in zip((ys, hT, cT), w))
    grads = torch.autograd.grad(loss, [*tp, x, h, c])
    return [o.detach() for o in (ys, hT, cT)], grads


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("chunk", [4, 6])
def test_remat_equals_no_remat(reverse, chunk):
    args = _setup(4, 12, 6, 8, seed=chunk + reverse)
    vals, grads = _run(tscan.lstm_scan, *args, reverse=reverse)
    rvals, rgrads = _run(tscan.lstm_scan, *args, reverse=reverse,
                         remat_chunk=chunk)
    for a, b in zip(vals + list(grads), rvals + list(rgrads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_remat_matches_jax_remat_scan():
    jp, xs, h0, c0, mask, w = _setup(4, 12, 6, 8, seed=3)
    (jh, jc), jys = jlstm_scan(jax.tree.map(jnp.asarray, jp), jnp.asarray(xs),
                               (jnp.asarray(h0), jnp.asarray(c0)),
                               mask=jnp.asarray(mask), remat_chunk=4)
    (ys, hT, cT), _ = _run(tscan.lstm_scan, jp, xs, h0, c0, mask, w,
                           remat_chunk=4)
    for a, b in ((ys, jys), (hT, jh), (cT, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_remat_refuses_an_indivisible_T():
    jp, xs, h0, c0, mask, w = _setup(2, 10, 4, 4)
    with pytest.raises(ValueError, match="not divisible by remat_chunk"):
        _run(tscan.lstm_scan, jp, xs, h0, c0, mask, w, remat_chunk=4)
    with pytest.raises(ValueError, match="not divisible by remat_chunk"):
        _run(tscan.auto_lstm_scan, jp, xs, h0, c0, mask, w, remat_chunk=3)


@pytest.mark.parametrize("B,T,H,D,remat,expect", [
    (32, 400, 256, 256, None, ("residentx", "residentx")),
    (32, 400, 256, 256, 50, ("residentx", "recompute")),
    (64, 64, 128, 128, None, ("resident", "resident")),   # config 1
    (64, 64, 128, 128, 16, ("resident", "recompute")),
    (64, 256, 128, 128, None, ("residentx", "residentx")),  # LM at T=256
    (64, 255, 128, 128, None, ("resident", "resident")),
    # config 3's width: the resident blocks cannot keep U in shared memory
    (32, 70, 650, 650, None, ("tiled", "tiled")),
    # the residentx plan does not fit (xs too wide): the next rung, tiled
    (64, 400, 1024, 8192, None, ("tiled", "tiled")),
])
def test_strategy_lattice(B, T, H, D, remat, expect):
    got = (tscan.chosen_fwd_strategy(B, T, H, D),
           tscan.chosen_bwd_strategy(B, T, H, D, remat_chunk=remat))
    assert got == expect


def test_strategy_lattice_raises_without_a_plan():
    with pytest.raises(ValueError, match="shared memory"):
        tscan.chosen_bwd_strategy(64, 64, 4096, 128)


def test_strategy_lattice_recomputes_over_the_residual_budget():
    # T·B·H·4 bytes of cs = 5.2 GB > 4 GiB
    assert tscan.chosen_fwd_strategy(64, 20000, 1024, 1024) == "residentx"
    assert tscan.chosen_bwd_strategy(64, 20000, 1024, 1024) == "recompute"


@pytest.mark.parametrize("remat,bptt,T,expect", [
    (None, "sequential", 400, "stacked"), (50, "sequential", 400, "two_scans"),
    (None, "assoc", 400, "two_scans"), (None, "auto", 400, "stacked"),
    (None, "sequential", 200, "two_scans")])
def test_bidir_route(remat, bptt, T, expect):
    assert tscan.bidir_route(32, T, 256, 256, 256, remat_chunk=remat,
                             bptt=bptt) == expect
    assert tscan.bidir_route(32, 400, 256, 128, 256) == "two_scans"


def test_assoc_raises_on_every_entry():
    jp, xs, h0, c0, mask, w = _setup(2, 4, 4, 4)
    tp = tcell.LSTMParams(*(_t(getattr(jp, f)) for f in tcell.LSTMParams._fields))
    with pytest.raises(NotImplementedError, match="assoc"):
        tscan.bidir_lstm_scan(tp, tp, _t(xs), bptt="assoc")
    with pytest.raises(ValueError, match="bptt must be"):
        tscan.auto_lstm_scan(tp, _t(xs), bptt="nope")


@pytest.mark.parametrize("T,remat,counter", [
    (256, None, "fwdx"), (8, None, "fwd"), (256, 64, "fwdx"), (8, 4, "fwd")])
def test_kernel_routes_equal_the_plain_scan(T, remat, counter):
    """Each route of kernel_lstm_scan (on CPU tensors: the plain versions
    of its kernels) against the plain lstm_scan: the residentx pair at
    T=256, the resident pair below, and the kernel forward with the
    recompute backward under remat_chunk (its forward kernel ran, no
    backward kernel did)."""
    args = _setup(2, T, 4, 8, seed=T + (remat or 0))
    counts = {"fwdx": (cuda_lstmx.fwdx_counts, cuda_lstmx.bwdx_counts),
              "fwd": (cuda_lstm.fwd_counts, cuda_lstm.bwd_counts)}[counter]
    before = [c.reference for c in counts]
    vals, grads = _run(tscan.kernel_lstm_scan, *args, reverse=True,
                       remat_chunk=remat)
    ran = [c.reference - b for c, b in zip(counts, before)]
    assert ran == ([1, 0] if remat else [1, 1])
    pvals, pgrads = _run(tscan.lstm_scan, *args, reverse=True)
    for a, b in zip(vals, pvals):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    for a, b in zip(grads, pgrads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)
