"""The port's tiled LSTM pair (``ops/cuda_lstm_tiled.py``) against the JAX
package's tiled Pallas kernels, on the CPU.

``LSTMTiledRecurrence`` joins ``csrc/lstm_tiled_fwd.cu`` and
``csrc/lstm_tiled_bwd.cu``; on the CPU it runs their plain versions. Here
it is held against ``pallas_lstm_scan(..., interpret=True)`` at the JAX
tests' tiled shape (B=8, H=1024, T=4, D=32; ``tests/test_pallas.py``), each
case first checking that the JAX planner picks ``"tiled"`` for both
kernels there, so the reference is the tiled pair: values to atol 1e-5,
the gradients of every per-gate parameter, xs, h0 and c0 to atol 1e-5 /
rtol 1e-4 (the tolerances of the JAX tests; float32 sums in another
order). Also: the launch plan at the configs' shapes and awkward ones,
with an H100's resident clusters and without, and the routes of
``ops/scan.py`` — the tiled pair where the resident pair cannot keep U in
shared memory, the tiled forward with the plain recompute backward under
``remat_chunk``, and configs 1, 2 and the LM at T=256 unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.ops import cuda_lstm, cuda_lstm_tiled
from lstm_tensorspark_torch.ops import lstm_cell as tcell
from lstm_tensorspark_torch.ops import scan as tscan
from lstm_tensorspark_tpu.ops import lstm_cell as jcell
from lstm_tensorspark_tpu.ops.pallas_lstm import (_plan_bwd, _plan_fwd,
                                                  pallas_lstm_scan)

torch.set_num_threads(1)

ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _inputs(B, T, D, H, seed, masked, carry):
    jp = jax.tree.map(np.asarray,
                      jcell.init_lstm_params(jax.random.PRNGKey(seed), D, H))
    rng = np.random.RandomState(seed)
    xs = rng.randn(B, T, D).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.5).astype(np.float32) if carry else None
    c0 = (rng.randn(B, H) * 0.5).astype(np.float32) if carry else None
    mask = None
    if masked:  # right padding of assorted lengths, full and 1-step rows
        lens = np.array([T, 1, 3, 2, T, 1, 2, 3][:B])
        mask = np.arange(T)[None, :] < lens[:, None]
    w = [rng.randn(*s).astype(np.float32) for s in ((B, T, H), (B, H), (B, H))]
    return jp, xs, h0, c0, mask, w


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


def _port(scan, jp, xs, h0, c0, mask, w, **kw):
    tp = tcell.LSTMParams(*(_t(getattr(jp, f)).requires_grad_()
                            for f in tcell.LSTMParams._fields))
    x = _t(xs).requires_grad_()
    carry = None
    if h0 is not None:
        carry = (_t(h0).requires_grad_(), _t(c0).requires_grad_())
    m = None if mask is None else torch.from_numpy(mask)
    (hT, cT), ys = scan(tp, x, carry, mask=m, **kw)
    wy, wh, wc = (_t(a) for a in w)
    loss = (ys * wy).sum() + (hT * wh).sum() + (cT * wc).sum()
    inputs = [*tp, x] + ([] if carry is None else list(carry))
    return [o.detach() for o in (ys, hT, cT)], torch.autograd.grad(loss, inputs)


@pytest.mark.parametrize("masked,reverse,carry", [
    (False, False, False), (True, False, True), (True, True, True)])
def test_tiled_function_matches_pallas_tiled(masked, reverse, carry):
    B, T, D, H = 8, 4, 32, 1024
    assert _plan_fwd(B, H, 4, save_residuals=True,
                     has_mask=masked)[0] == "tiled"
    assert _plan_bwd(B, H, 4, masked)[0] == "tiled"
    args = _inputs(B, T, D, H, 7 + masked + 2 * reverse, masked, carry)
    before = (cuda_lstm_tiled.fwd_counts.reference,
              cuda_lstm_tiled.bwd_counts.reference)
    touts, tgrads = _port(cuda_lstm_tiled.cuda_lstm_tiled_scan, *args,
                          reverse=reverse)
    assert (cuda_lstm_tiled.fwd_counts.reference - before[0],
            cuda_lstm_tiled.bwd_counts.reference - before[1]) == (1, 1)
    jouts, jgrads = _jax(*args, reverse)
    for name, a, b in zip(("ys", "hT", "cT"), touts, jouts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0,
                                   err_msg=name)
    names = list(tcell.LSTMParams._fields) + ["xs", "h0", "c0"]
    expect = [getattr(jgrads[0], f) for f in tcell.LSTMParams._fields]
    expect += [jgrads[1]] + ([] if not carry else list(jgrads[2]))
    assert len(tgrads) == len(expect)
    for name, a, b in zip(names, tgrads, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


# the resident clusters an H100 keeps at one block an SM
# (cudaOccupancyMaxActiveClusters: 30 of 4 blocks, 66 of 2)
H100 = {4: 30, 2: 66}


@pytest.mark.parametrize("B,H", [
    (16, 1024), (64, 1024), (256, 1024),   # config 5 at B=16, 64, 256
    (32, 650),                             # config 3's width
    (1, 1024), (3, 1000), (6, 1030), (5, 650), (264, 1024),  # awkward
    (3, 40), (16, 64), (8, 300),           # narrow: more units to fit
])
def test_tiled_plan_covers_h_and_fits(B, H):
    """The plan mirrors ``fwd_geom`` / ``bwd_geom`` and the
    shared-memory layouts of ``csrc/lstm_tiled_*.cu``: every cluster owns
    units and every block a non-empty slice of H (a block of the last
    cluster may own no units and still copy its slice of h, or hold its
    slice of U for the cluster's backward product); the forward's lanes
    cover the own columns at every row of H, the backward's warps the
    slice; the rows go in 16-row tiles; a block fits 227 KB of shared
    memory and a lane keeps at most KREG rows or columns of U, two of the
    other each, in registers."""
    for max_clusters in (None, H100):
        for kind in ("fwd", "bwd"):
            p = cuda_lstm_tiled.plan(kind, B, H, max_clusters=max_clusters)
            C, ncl = p.cluster, p.blocks // p.cluster
            assert p.blocks <= 132 and p.blocks % C == 0
            assert C in cuda_lstm_tiled.CLUSTERS[kind]
            if max_clusters is not None:
                assert ncl <= max_clusters[C]
            assert 1 <= p.units <= cuda_lstm_tiled.MAX_UNITS
            upc, hq = C * p.units, -(-H // C)
            assert ncl * upc >= H > (ncl - 1) * upc
            assert (C - 1) * hq < H
            assert p.row_tiles * cuda_lstm_tiled.ROWS >= B > \
                (p.row_tiles - 1) * cuda_lstm_tiled.ROWS
            ROWS, KREG = cuda_lstm_tiled.ROWS, cuda_lstm_tiled.KREG
            assert p.groups * p.group_lanes <= cuda_lstm_tiled.THREADS
            if kind == "fwd":  # a group: the own columns at one row of H
                assert p.group_lanes == 2 * p.units
                assert p.groups * p.per_lane >= H
                rest = (p.per_lane - p.u_regs) * p.groups * 4 * p.units
            else:  # a group: the slice of H, two rows a lane, in warps
                assert p.group_lanes % 32 == 0
                assert 2 * p.group_lanes >= hq > 2 * p.group_lanes - 64
                assert p.groups * p.per_lane >= 4 * upc
                rest = (p.per_lane - p.u_regs) * p.groups * p.group_lanes
            assert p.u_regs == min(p.per_lane, KREG)
            # U's registers (two columns or rows of each) and the sums
            assert 2 * p.u_regs + 2 * ROWS <= 160
            assert p.smem_bytes <= cuda_lstm_tiled.MAX_SMEM_BYTES == 227 * 1024
            # U past the registers stays in shared memory
            assert p.smem_bytes >= 4 * rest


@pytest.mark.parametrize("B", [16, 64, 256])
def test_tiled_plan_keeps_u_in_registers_at_config5(B):
    """At config 5's width on an H100 the pair runs clusters of 2 (the card
    keeps 30 clusters of 4, too few for 8 units a block), 128 blocks of 8
    units, and every lane's part of U in registers. At config 3's width
    the forward runs clusters of 2 and the backward of 4, U in registers
    (the sizes measured faster there)."""
    for kind in ("fwd", "bwd"):
        p = cuda_lstm_tiled.plan(kind, B, 1024, max_clusters=H100)
        assert (p.blocks, p.cluster, p.units) == (128, 2, 8)
        assert p.per_lane == p.u_regs == cuda_lstm_tiled.KREG
        assert p.row_tiles == B // 16
    p = cuda_lstm_tiled.plan("fwd", 32, 650, max_clusters=H100)
    assert (p.cluster, p.units, p.per_lane <= p.u_regs) == (2, 5, True)
    p = cuda_lstm_tiled.plan("bwd", 32, 650, max_clusters=H100)
    assert (p.cluster, p.units, p.per_lane <= p.u_regs) == (4, 6, True)


def test_tiled_plan_refuses_clusters_the_card_cannot_keep():
    """A cluster size whose clusters cannot all be resident at the given
    count raises, as the launcher would (``launch_clusters``); the
    backward falls back to the other size when the card keeps enough of
    it."""
    with pytest.raises(ValueError, match="8 resident clusters of 4 need 32"):
        cuda_lstm_tiled.plan("bwd", 16, 1024, max_clusters={4: 8})
    with pytest.raises(ValueError, match="keeps no cluster of 2"):
        cuda_lstm_tiled.plan("fwd", 16, 1024, max_clusters={4: 30, 2: 0})
    with pytest.raises(ValueError, match="10 resident clusters of 2"):
        cuda_lstm_tiled.plan("fwd", 16, 1024, max_clusters={4: 30, 2: 10})
    # the backward at config 3's width takes clusters of 2 without 4
    p = cuda_lstm_tiled.plan("bwd", 32, 650, max_clusters={4: 0, 2: 66})
    assert (p.cluster, p.blocks) == (2, 130)


def test_tiled_route_reads_the_card_plan(monkeypatch):
    """Given the card, ``fits`` and the route read :func:`card_plan` (the
    card's SMs and resident clusters), the plan the launch runs: a card
    that keeps too few clusters takes no tiled route."""
    monkeypatch.setattr(cuda_lstm_tiled, "max_clusters",
                        lambda dev: {4: 30, 2: 10})
    monkeypatch.setattr(cuda_lstm, "_num_sms", lambda dev: 132)
    assert cuda_lstm_tiled.fits(16, 1024)
    assert not cuda_lstm_tiled.fits(16, 1024, dev="card")
    assert tscan.chosen_fwd_strategy(16, 128, 1024, 1024) == "tiled"
    assert tscan.chosen_fwd_strategy(16, 128, 1024, 1024,
                                     dev="card") == "resident"
    monkeypatch.setattr(cuda_lstm_tiled, "max_clusters", lambda dev: H100)
    assert tscan.chosen_bwd_strategy(16, 128, 1024, 1024,
                                     dev="card") == "tiled"


def test_tiled_plan_raises_when_it_does_not_fit():
    with pytest.raises(ValueError, match="tiled route's reach"):
        cuda_lstm_tiled.plan("fwd", 512, 1024)
    with pytest.raises(ValueError, match="no plan"):
        cuda_lstm_tiled.plan("bwd", 16, 4096)
    with pytest.raises(ValueError, match="kind"):
        cuda_lstm_tiled.plan("both", 16, 1024)
    assert not cuda_lstm_tiled.fits(512, 1024)
    assert cuda_lstm_tiled.fits(264, 1024)


@pytest.mark.parametrize("B,T,H,D,remat,expect", [
    (16, 128, 1024, 1024, None, ("tiled", "tiled")),     # config 5's shard
    (16, 128, 1024, 1024, 32, ("tiled", "recompute")),
    (64, 128, 1024, 1024, None, ("tiled", "tiled")),
    (256, 128, 1024, 1024, None, ("tiled", "tiled")),    # JAX: plain scan
    (512, 128, 1024, 1024, None, None),                  # nothing fits
    (32, 70, 650, 650, None, ("tiled", "tiled")),        # config 3's width
    (64, 64, 128, 128, None, ("resident", "resident")),  # config 1
    (32, 400, 256, 256, None, ("residentx", "residentx")),  # config 2
    (64, 256, 128, 128, None, ("residentx", "residentx")),  # LM at T=256
])
def test_tiled_routes(B, T, H, D, remat, expect):
    if expect is None:
        with pytest.raises(ValueError, match="shared memory"):
            tscan.chosen_bwd_strategy(B, T, H, D)
        return
    assert (tscan.chosen_fwd_strategy(B, T, H, D),
            tscan.chosen_bwd_strategy(B, T, H, D, remat_chunk=remat)) == expect


@pytest.mark.parametrize("remat", [None, 2])
def test_kernel_scan_takes_the_tiled_route(remat):
    """``kernel_lstm_scan`` at H=1024 runs the tiled Function (the forward
    alone under remat_chunk, with the plain recompute backward) and equals
    the plain ``lstm_scan`` in values and gradients; the resident pair's
    counters do not move."""
    args = _inputs(2, 4, 8, 1024, 3, True, True)
    counts = (cuda_lstm_tiled.fwd_counts, cuda_lstm_tiled.bwd_counts,
              cuda_lstm.fwd_counts, cuda_lstm.bwd_counts)
    before = [c.reference for c in counts]
    vals, grads = _port(tscan.kernel_lstm_scan, *args, reverse=True,
                        remat_chunk=remat)
    ran = [c.reference - b for c, b in zip(counts, before)]
    assert ran == ([1, 0, 0, 0] if remat else [1, 1, 0, 0])
    pvals, pgrads = _port(tscan.lstm_scan, *args, reverse=True)
    for a, b in zip(vals, pvals):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    for a, b in zip(grads, pgrads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_tiled_wrappers_raise_on_other_devices():
    x = torch.zeros(2, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_lstm_tiled.lstm_tiled_forward(x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_lstm_tiled.lstm_tiled_backward(x, x, x, x, x, x, x)
