"""bf16 compute of the port's LM family against the JAX package, on the CPU.

The same numpy inputs and bridged weights (``convert.params_from_numpy``:
JAX's parameters stay float32 under bf16 compute, and so do the port's)
go through both sides:

1. ``fuse_params(compute_dtype=bfloat16)`` bit for bit;
2. the plain loop ``lstm_scan(compute_dtype=bfloat16)`` (zx float32, x and
   h rounded only at the products), ± mask, reverse and ``remat_chunk``,
   against JAX ``lstm_scan``: values to 1e-4, gradients to 5e-3 of their
   max |g| (float32 sums in another order; a bfloat16 rounding of h or of
   a cotangent can fall the other way by one ulp);
3. the resident pair's plain twins (the bfloat16 forms' arithmetic on the
   CPU: xproj, z, dz and U bfloat16, h rounded at the product, dz rounded
   once) against ``pallas_lstm_scan(compute_dtype=bfloat16,
   interpret=True)`` where JAX plans "resident", and the z and dz streams
   against the Pallas kernels' own (each stored element within one
   bfloat16 ulp of JAX's, or 1e-3 of the stream's max |z| for elements by
   zero); values to 1e-3, gradients to 1e-2 of max |g|;
4. the tiled pair's twins at the JAX tests' tiled shape (B=8, H=1024, T=4,
   D=32), where JAX plans ``('resident', 8)`` in bf16 (the same function
   with the same rounding points, another tiling), same limits;
5. the routes of ``ops/scan.py`` in bf16 at configs 1, 3 and 5's shapes
   on a 132-SM plan, the element size in the plans, a bf16 LM at T >= 256
   taking the residentx pair's bf16 form (``tests/test_torch_bf16_residentx
   .py`` holds that form against JAX), and the refusals: a mixed kernel
   call, float16, bf16 serving;
6. ``lm_loss`` and its gradients with ``compute_dtype=bfloat16``, ±
   ``logits_dtype=bfloat16``, L=2, tied and untied: the port's plain loop
   against JAX's default scan (losses to 1e-5 relative, gradients to 5e-3
   of max |g|), and the port's kernel route (its twins) against JAX's
   ``use_pallas=True`` route (the Pallas kernels in interpret mode; losses
   to 1e-5 relative, gradients to 1e-3 of max |g|). Under bfloat16 logits
   the head bias's gradient is held to 5e-2 of its max |g|: JAX sums its
   bfloat16 cotangent over the batch in an order of bfloat16 adds (on the
   CPU neither a float32 sum nor a sequential one), 1.9-3.2% off the
   port's float32 sum of the same cotangent here. The gap between the two
   rounding schemes is measured and bounded (the card-against-CPU limit
   of ``chip_smoke.py`` phase 15);
7. 4 SGD and 4 Adam steps in bf16 (config 1's flags: bf16 compute,
   float32 logits) against JAX's ``make_train_step``: losses to 1e-4
   relative, params to 1e-3 of their scale after SGD and to the learning
   rate after Adam (an Adam update element is at most the learning rate,
   and a gradient element whose bfloat16 rounding falls the other way can
   move one); every parameter and moment stays float32;
8. ``python -m lstm_tensorspark_torch train --compute-dtype bfloat16
   --logits-dtype bfloat16`` on the CPU, and the CLI's handling of the two
   flags on imdb (``--logits-dtype`` ignored, a bf16 run accepted).
"""

import itertools
import os
import subprocess
import sys
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch import cli as tcli
from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.data import batching as tbatch
from lstm_tensorspark_torch.data import corpus as tcorpus
from lstm_tensorspark_torch.exit_codes import OK_RC
from lstm_tensorspark_torch.models import lstm_lm as tlm
from lstm_tensorspark_torch.ops import cuda_lstm, cuda_lstm_tiled
from lstm_tensorspark_torch.ops import lstm_cell as tcell
from lstm_tensorspark_torch.ops import scan as tscan
from lstm_tensorspark_torch.train import loop as tloop
from lstm_tensorspark_torch.train import optimizer as topt
from lstm_tensorspark_tpu.models import LMConfig, init_lm
from lstm_tensorspark_tpu.models.lstm_lm import init_carries, lm_loss
from lstm_tensorspark_tpu.ops import lstm_cell as jcell
from lstm_tensorspark_tpu.ops import pallas_lstm as jpallas
from lstm_tensorspark_tpu.ops import scan as jscan
from lstm_tensorspark_tpu.train import loop as jloop
from lstm_tensorspark_tpu.train import optimizer as jopt

torch.set_num_threads(1)

BF = torch.bfloat16
# the plain loop against JAX's plain scan: one rounding scheme
PLAIN_ATOL, PLAIN_GRAD = 1e-4, 5e-3
# the kernel route against JAX's Pallas route in lm_loss
KERNEL_GRAD = 1e-3
# the head bias's gradient under bfloat16 logits (module docstring, 6.)
BIAS_SHARE = 5e-2
# the kernels' twins against the Pallas kernels: f32 outputs, gradients
# as a share of max |g|
VALUE_ATOL, GRAD_SHARE = 1e-3, 1e-2
STREAM_FLOOR = 1e-3  # of the stream's max |value|, for elements by zero


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _bf(a):
    """A JAX bfloat16 array as a torch bfloat16 tensor (exact)."""
    return _t(np.asarray(a).astype(np.float32)).to(BF)


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


def _jax(scan, jp, xs, h0, c0, mask, w, **kw):
    wy, wh, wc = (jnp.asarray(a) for a in w)
    carry = None if h0 is None else (jnp.asarray(h0), jnp.asarray(c0))
    m = None if mask is None else jnp.asarray(mask)

    def loss(p, x, carry):
        (hT, cT), ys = scan(p, x, carry, mask=m, compute_dtype=jnp.bfloat16,
                            **kw)
        return (jnp.sum(ys * wy) + jnp.sum(hT * wh) + jnp.sum(cT * wc),
                (ys, hT, cT))

    argnums = (0, 1) if carry is None else (0, 1, 2)
    (_, outs), grads = jax.value_and_grad(loss, argnums=argnums,
                                          has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(xs), carry)
    expect = [getattr(grads[0], f) for f in tcell.LSTMParams._fields]
    expect += [grads[1]] + ([] if carry is None else list(grads[2]))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in expect]


def _port(scan, jp, xs, h0, c0, mask, w, **kw):
    tp = tcell.LSTMParams(*(_t(getattr(jp, f)).requires_grad_()
                            for f in tcell.LSTMParams._fields))
    x = _t(xs).requires_grad_()
    carry = None
    if h0 is not None:
        carry = (_t(h0).requires_grad_(), _t(c0).requires_grad_())
    m = None if mask is None else torch.from_numpy(mask)
    (hT, cT), ys = scan(tp, x, carry, mask=m, compute_dtype=BF, **kw)
    wy, wh, wc = (_t(a) for a in w)
    loss = (ys * wy).sum() + (hT * wh).sum() + (cT * wc).sum()
    inputs = [*tp, x] + ([] if carry is None else list(carry))
    grads = torch.autograd.grad(loss, inputs)
    assert all(g.dtype == torch.float32 for g in grads)
    return ([o.detach().numpy() for o in (ys, hT, cT)],
            [g.numpy() for g in grads])


def _held(touts, tgrads, jouts, jgrads, atol, share):
    for name, a, b in zip(("ys", "hT", "cT"), touts, jouts):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)
    names = list(tcell.LSTMParams._fields) + ["xs", "h0", "c0"]
    assert len(tgrads) == len(jgrads)
    for name, a, b in zip(names, tgrads, jgrads):
        np.testing.assert_allclose(a, b, rtol=0, err_msg=name,
                                   atol=share * max(float(np.abs(b).max()),
                                                    1e-30))


def _ulps_held(got, ref, name):
    """Each element of a stored bfloat16 stream within one bfloat16 ulp of
    the reference element, or STREAM_FLOOR of the stream's max |ref|."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(
        ref.abs().clamp_min(2.0 ** -126))[1] - 8)
    floor = STREAM_FLOOR * float(ref.abs().max())
    bad = (d > ulp) & (d > floor)
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} of {d.numel()} elements beyond one ulp "
        f"(max |d| {float(d.max()):.3e})")
    return float((d / ulp).max())


# ---------------------------------------------------------------------------
# 1. fuse_params
# ---------------------------------------------------------------------------


def test_fuse_params_bf16_bit_for_bit():
    jp = jcell.init_lstm_params(jax.random.PRNGKey(3), 12, 20)
    jf = jcell.fuse_params(jp, compute_dtype=jnp.bfloat16)
    tp = tcell.LSTMParams(*(_t(a) for a in jax.tree.map(np.asarray, jp)))
    for dt in (BF, "bfloat16"):
        tf = tcell.fuse_params(tp, compute_dtype=dt)
        assert (tf.kernel.dtype, tf.recurrent.dtype, tf.bias.dtype) == (
            BF, BF, torch.float32)
        for a, b in zip(tf, jf):
            assert torch.equal(a.float(), _t(np.asarray(b).astype(np.float32)))
    f32 = tcell.fuse_params(tp)
    assert all(t.dtype == torch.float32 for t in f32)


# ---------------------------------------------------------------------------
# 2. the plain loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked,reverse,remat", [
    (False, False, None), (True, False, None), (True, True, None),
    (False, False, 4), (True, True, 4)])
def test_plain_scan_bf16_matches_jax(masked, reverse, remat):
    args = _inputs(8, 8, 12, 16, 11 + masked + 2 * reverse, masked, True)
    touts, tgrads = _port(tscan.lstm_scan, *args, reverse=reverse,
                          remat_chunk=remat)
    jouts, jgrads = _jax(jscan.lstm_scan, *args, reverse=reverse,
                         remat_chunk=remat)
    _held(touts, tgrads, jouts, jgrads, PLAIN_ATOL, PLAIN_GRAD)


# ---------------------------------------------------------------------------
# 3, 4. the kernel pairs' plain twins against the Pallas kernels
# ---------------------------------------------------------------------------


def _mask_tbl(mask, T, B):
    if mask is None:
        return None
    return jnp.broadcast_to(jnp.asarray(mask.T, jnp.float32)[:, :, None],
                            (T, B, jpallas._LANE))


@pytest.mark.parametrize("masked,reverse,carry", [
    (False, False, False), (True, False, True), (True, True, True)])
def test_resident_twins_match_pallas_bf16(masked, reverse, carry):
    B, T, D, H = 8, 6, 16, 128
    assert jpallas._plan_fwd(B, H, 2, save_residuals=True,
                             has_mask=masked)[0] == "resident"
    assert jpallas._plan_bwd(B, H, 2, masked)[0] == "resident"
    args = _inputs(B, T, D, H, 21 + masked + 2 * reverse, masked, carry)
    before = (cuda_lstm.fwd_bf16_counts.reference,
              cuda_lstm.bwd_bf16_counts.reference)
    touts, tgrads = _port(cuda_lstm.cuda_lstm_scan, *args, reverse=reverse)
    assert (cuda_lstm.fwd_bf16_counts.reference - before[0],
            cuda_lstm.bwd_bf16_counts.reference - before[1]) == (1, 1)
    jouts, jgrads = _jax(jpallas.pallas_lstm_scan, *args, reverse=reverse,
                         interpret=True)
    _held(touts, tgrads, jouts, jgrads, VALUE_ATOL, GRAD_SHARE)


def test_resident_twins_streams_match_pallas_kernels(monkeypatch):
    """The z the Pallas forward stores and the dz its backward kernel
    stores (bfloat16) against the port's twins fed the same inputs: z from
    the port's own projection and recurrence, dz from JAX's z and cs."""
    B, T, D, H = 8, 6, 16, 128
    jp, xs, h0, c0, mask, _ = _inputs(B, T, D, H, 5, True, True)
    jf = jcell.fuse_params(jax.tree.map(jnp.asarray, jp),
                           compute_dtype=jnp.bfloat16)
    tbl = _mask_tbl(mask, T, B)
    ys, hT, cT, z, cs = jpallas._pallas_forward(
        jf, jnp.asarray(xs), jnp.asarray(h0), jnp.asarray(c0), tbl,
        interpret=True, save_residuals=True, allow_fusedx=False)
    assert z.dtype == jnp.bfloat16 and cs.dtype == jnp.float32

    tf = tcell.fuse_params(tcell.LSTMParams(
        *(_t(getattr(jp, f)) for f in tcell.LSTMParams._fields)))
    xproj = cuda_lstm.project(_t(xs).transpose(0, 1), tf, BF).contiguous()
    mf = _t(mask.T).contiguous()
    Ub = tf.recurrent.to(BF)
    tys, thT, tcT, tz, tcs = cuda_lstm.lstm_forward(
        xproj, Ub, _t(h0), _t(c0), mf, save_residuals=True)
    assert tz.dtype == BF and tcs.dtype == torch.float32
    np.testing.assert_allclose(tys.transpose(0, 1).numpy(), np.asarray(ys),
                               atol=VALUE_ATOL, rtol=0)
    np.testing.assert_allclose(tcs.numpy(), np.asarray(cs), atol=VALUE_ATOL,
                               rtol=0)
    _ulps_held(tz, _bf(z), "z")

    # the backward kernel's dz: record what its pallas_call returns
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
    rng = np.random.RandomState(6)
    dys = rng.randn(B, T, H).astype(np.float32)
    dhT, dcT = (rng.randn(B, H).astype(np.float32) for _ in range(2))
    jpallas._pallas_backward(
        jf, jax.tree.map(jnp.asarray, jp), jnp.asarray(xs), jnp.asarray(h0),
        jnp.asarray(c0), tbl, ys, z, cs, jnp.asarray(dys), jnp.asarray(dhT),
        jnp.asarray(dcT), interpret=True)
    jdz = seen[-1][0]
    assert jdz.dtype == jnp.bfloat16 and jdz.shape == (T, B, 4 * H)
    tdz, tdh0, tdc0 = cuda_lstm.lstm_backward(
        _bf(z), _t(c0), _t(cs), _t(dys).transpose(0, 1).contiguous(), Ub,
        _t(dhT), _t(dcT), mf)
    assert tdz.dtype == BF
    _ulps_held(tdz, _bf(jdz), "dz")
    for a, b in zip((tdh0, tdc0), seen[-1][1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=VALUE_ATOL * max(
                                       1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("masked,reverse,carry", [
    (False, False, True), (True, True, True)])
def test_tiled_twins_match_pallas_bf16(masked, reverse, carry):
    """At the JAX tests' tiled shape JAX plans the resident kernels in
    bf16 (a bf16 U fits the TPU's VMEM); the port keeps its tiled pair
    there (U does not fit a cluster's shared memory on Hopper): the same
    function with the same rounding points."""
    B, T, D, H = 8, 4, 32, 1024
    assert jpallas._plan_fwd(B, H, 2, save_residuals=True,
                             has_mask=masked) == ("resident", 8)
    assert jpallas._plan_bwd(B, H, 2, masked)[0] == "resident"
    assert tscan.chosen_bwd_strategy(B, T, H, D, esize=2) == "tiled"
    args = _inputs(B, T, D, H, 31 + masked + 2 * reverse, masked, carry)
    before = (cuda_lstm_tiled.fwd_bf16_counts.reference,
              cuda_lstm_tiled.bwd_bf16_counts.reference)
    touts, tgrads = _port(cuda_lstm_tiled.cuda_lstm_tiled_scan, *args,
                          reverse=reverse)
    assert (cuda_lstm_tiled.fwd_bf16_counts.reference - before[0],
            cuda_lstm_tiled.bwd_bf16_counts.reference - before[1]) == (1, 1)
    jouts, jgrads = _jax(jpallas.pallas_lstm_scan, *args, reverse=reverse,
                         interpret=True)
    _held(touts, tgrads, jouts, jgrads, VALUE_ATOL, GRAD_SHARE)


# ---------------------------------------------------------------------------
# 5. routes, plans and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,T,H,remat,fwd,bwd", [
    (64, 64, 128, None, "resident", "resident"),    # config 1
    (32, 70, 650, None, "tiled", "tiled"),          # config 3
    (16, 128, 1024, None, "tiled", "tiled"),        # config 5's shard
    (16, 128, 1024, 32, "tiled", "recompute"),      # ... --remat-chunk 32
])
def test_bf16_routes_at_the_configs(B, T, H, remat, fwd, bwd):
    assert tscan.chosen_fwd_strategy(B, T, H, H, num_sms=132,
                                     esize=2) == fwd
    assert tscan.chosen_bwd_strategy(B, T, H, H, remat_chunk=remat,
                                     num_sms=132, esize=2) == bwd


def test_bf16_plans_follow_the_element_size():
    """A bf16 U takes half the shared memory: at B=16, H=384 the resident
    forward keeps its slice of U on chip in bf16 and not in float32, so
    the route moves from the tiled pair to the resident one; the residual
    budget counts z at 2 bytes."""
    f32, bf = (cuda_lstm.plan("fwd", 16, 384, esize=e) for e in (4, 2))
    assert not f32.smem_w and not f32.u_regs and bf.smem_w
    assert tscan.chosen_fwd_strategy(16, 64, 384, 384, esize=4) == "tiled"
    assert tscan.chosen_fwd_strategy(16, 64, 384, 384, esize=2) == "resident"
    b4, b2 = (cuda_lstm.plan("bwd", 64, 256, esize=e) for e in (4, 2))
    assert b4.smem_w and b2.smem_w and b2.smem_bytes < b4.smem_bytes
    for kind in ("fwd", "bwd"):
        t4, t2 = (cuda_lstm_tiled.plan(kind, 6, 1030, esize=e)
                  for e in (4, 2))
        assert t2.smem_bytes <= t4.smem_bytes
    # the residuals z and cs: 20 bytes a (step, row, unit) in float32, 12
    # in bf16; B=8192, T=250, H=128 takes 5.2 GB and 3.1 GB of a 4 GiB
    # budget
    from lstm_tensorspark_torch.ops import cuda_lstmx
    B, T, H = 8192, 250, 128
    assert T * B * H * 20 > cuda_lstmx.RESIDUAL_BUDGET_BYTES >= T * B * H * 12
    assert tscan.chosen_bwd_strategy(B, T, H, H, esize=4) == "recompute"
    assert tscan.chosen_bwd_strategy(B, T, H, H, esize=2) == "resident"


def test_bf16_refusals():
    # a bf16 LM at T >= 256 takes the residentx pair's bf16 form (its twins
    # on the CPU), with the recompute backward under remat
    from lstm_tensorspark_torch.ops import cuda_lstmx
    assert tscan.chosen_fwd_strategy(64, 256, 128, 128, esize=2) == \
        "residentx"
    assert tscan.chosen_bwd_strategy(64, 256, 128, 128, remat_chunk=64,
                                     esize=2) == "recompute"
    xs = torch.zeros(4, 256, 8)
    p = tcell.init_lstm_params(torch.Generator().manual_seed(0), 8, 8)
    before = cuda_lstmx.fwdx_bf16_counts.reference
    (hT, _), ys = tscan.kernel_lstm_scan(p, xs, compute_dtype=BF)
    assert cuda_lstmx.fwdx_bf16_counts.reference == before + 1
    assert ys.dtype == hT.dtype == torch.float32 and bool(ys.isfinite().all())
    # a mixed kernel call raises, on the CPU as on the card
    T, B, H = 3, 2, 4
    args = [torch.zeros(T, B, 4 * H, dtype=BF), torch.zeros(H, 4 * H),
            torch.zeros(B, H), torch.zeros(B, H)]
    with pytest.raises(TypeError, match="U must be torch.bfloat16"):
        cuda_lstm.lstm_forward(*args)
    with pytest.raises(TypeError, match="h0 must be torch.float32"):
        cuda_lstm_tiled.lstm_tiled_forward(args[0], args[1].to(BF),
                                           args[2].to(BF), args[3])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_lstm.lstm_forward(args[0].half(), args[1].half(), *args[2:])
    # an operand that is float32 in every form refuses a bf16 tensor
    from lstm_tensorspark_torch import kernels
    with pytest.raises(TypeError, match="xs must be torch.float32"):
        kernels.check_f32("xs", args[0], tuple(args[0].shape),
                          args[0].device)
    # bf16 serving takes the windows' bf16 forms: W and U bf16, the rest
    # float32; no bf16 config is refused or turned into a float32 one
    from lstm_tensorspark_torch.serve import ServeEngine
    cfg = tlm.LMConfig(vocab_size=10, hidden_size=8,
                       compute_dtype="bfloat16")
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    w = ServeEngine(params, cfg, device="cpu").weights
    assert {t.dtype for f in w.layers for t in (f.kernel, f.recurrent)} \
        == {BF}
    assert w.embedding.dtype == w.head_kernel.dtype == torch.float32
    with pytest.raises(ValueError, match="logits_dtype"):
        tlm.LMConfig(vocab_size=10, logits_dtype="float16")


# ---------------------------------------------------------------------------
# 6. lm_loss
# ---------------------------------------------------------------------------


def _tokens(n_words=3000, seed=0):
    text = tcorpus.synthetic_text(n_words, seed)
    vocab = tcorpus.build_char_vocab(text)
    return vocab, vocab.encode_text(text, "char")


def _models(V, H, L, tied, logits, seed=0, **jkw):
    common = dict(vocab_size=V, hidden_size=H, num_layers=L,
                  tie_embeddings=tied, compute_dtype="bfloat16",
                  logits_dtype=logits)
    jcfg = LMConfig(**common, **jkw)
    jparams = init_lm(jax.random.PRNGKey(seed), jcfg)
    tcfg = tlm.LMConfig(**common)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batch_np(tokens, B, T, index=0):
    return next(itertools.islice(tbatch.lm_batch_stream(tokens, B, T),
                                 index, None))


def _tbatch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _losses(route, tied, logits, monkeypatch):
    """(port loss, port grads, JAX loss, JAX grads) of one bf16 batch, L=2,
    stateful carries; ``route`` "plain" (the CPU's plain loop against
    JAX's default scan) or "kernels" (the kernel pairs' twins against JAX's
    Pallas route in interpret mode)."""
    vocab, tokens = _tokens()
    V, H, B, T, L = len(vocab), 16, 8, 8, 2
    use_pallas = route == "kernels"
    jcfg, jparams, tcfg, tparams = _models(V, H, L, tied, logits, seed=L,
                                           use_pallas=use_pallas)
    if use_pallas:
        real = jpallas.pallas_lstm_scan
        monkeypatch.setattr(jpallas, "supported", lambda *a, **k: True)
        monkeypatch.setattr(jpallas, "pallas_lstm_scan",
                            lambda *a, **k: real(*a, interpret=True, **k))
        monkeypatch.setattr(tscan, "auto_lstm_scan",
                            lambda *a, bptt="sequential", **k:
                            tscan.kernel_lstm_scan(*a, **k))
    b = _batch_np(tokens, B, T, 3)
    rng = np.random.RandomState(4)
    carries = [((rng.randn(B, H) * 0.5).astype(np.float32),
                (rng.randn(B, H) * 0.5).astype(np.float32))
               for _ in range(L)]
    (jl, _), jg = jax.value_and_grad(
        lambda p: lm_loss(p, b, jcfg, carries=carries), has_aux=True)(jparams)
    leaves = [t.requires_grad_() for t in tloop.param_leaves(tparams)]
    params = tloop.params_from_leaves(tparams, leaves)
    tc = [(torch.from_numpy(h), torch.from_numpy(c)) for h, c in carries]
    before = cuda_lstm.fwd_bf16_counts.reference
    tl, _ = tlm.lm_loss(params, _tbatch(b), tcfg, carries=tc)
    assert cuda_lstm.fwd_bf16_counts.reference - before == (
        L if use_pallas else 0)
    tg = torch.autograd.grad(tl, leaves)
    assert all(g.dtype == torch.float32 for g in tg)
    return (tl.item(), [g.numpy() for g in tg], float(jl),
            [np.asarray(g) for g in jax.tree.leaves(jg)])


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("tied,logits", [(False, "float32"),
                                         (True, "bfloat16"),
                                         (False, "bfloat16")])
def test_lm_loss_bf16_matches_jax(route, tied, logits, monkeypatch):
    tl, tg, jl, jg = _losses(route, tied, logits, monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert len(tg) == len(jg)
    for i, (a, e) in enumerate(zip(tg, jg)):
        # leaf 1 is the head's bias (embedding, head bias, ...)
        share = (BIAS_SHARE if i == 1 and logits == "bfloat16"
                 else PLAIN_GRAD if route == "plain" else KERNEL_GRAD)
        np.testing.assert_allclose(a, e, rtol=0, err_msg=f"leaf {i}",
                                   atol=share * float(np.abs(e).max()))


def test_rounding_schemes_gap_is_bounded(monkeypatch):
    """The kernel route (streams rounded to bf16) against the plain loop
    (zx and h rounded only at the products) on the same bf16 batch: the
    gap chip_smoke.py's phase 15 allows the card's first losses against
    the CPU's (2e-3 of the loss) holds with room here."""
    plain = _losses("plain", False, "bfloat16", monkeypatch)[0]
    kern = _losses("kernels", False, "bfloat16", monkeypatch)[0]
    gap = abs(kern - plain) / abs(plain)
    assert 0 < gap < 2e-3 / 4, gap


# ---------------------------------------------------------------------------
# 7. trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt,lr", [("sgd", 0.5), ("adam", 1e-2)])
def test_bf16_trajectory_matches_jax(opt, lr):
    """4 stateful steps of bf16 compute (float32 logits, as
    configs/ptb_char.sh runs) from bridged params on the same windows;
    params, moments and carries stay float32."""
    vocab, tokens = _tokens()
    V, H, B, T = len(vocab), 32, 8, 16
    jcfg, jparams, tcfg, tparams = _models(V, H, 1, False, "float32", seed=9)

    def jloss(params, batch, dropout_rng, carries):
        return lm_loss(params, batch, jcfg, carries=carries)

    jo = jopt.make_optimizer(opt, lr, clip_norm=1.0)
    jstate = jloop.init_train_state(jparams, jo, jax.random.PRNGKey(0),
                                    carries=init_carries(jcfg, B))
    jstep = jloop.make_train_step(jloss, jo, stateful=True)

    def tloss(params, batch, carries=None):
        return tlm.lm_loss(params, batch, tcfg, carries=carries)

    to = topt.make_optimizer(opt, lr, clip_norm=1.0)
    tstate = tloop.init_train_state(tparams, to,
                                    carries=tlm.init_carries(tcfg, B))
    tstep = tloop.make_train_step(tloss, to, stateful=True)
    stream = tbatch.lm_batch_stream(tokens, B, T)
    jl, tl = [], []
    for _ in range(4):
        b = next(stream)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[-1] < tl[0]
    for a, e in zip(tloop.param_leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        assert a.dtype == torch.float32
        atol = lr if opt == "adam" else 1e-3 * float(np.abs(e).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   atol=atol)
    def tensors(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        items = tree.values() if isinstance(tree, dict) else (
            tree if isinstance(tree, (list, tuple)) else [])
        return [t for x in items for t in tensors(x)]

    moments = [t for t in tensors(tstate.opt_state) if t.is_floating_point()]
    assert moments or opt == "sgd"
    assert all(t.dtype == torch.float32 for t in moments)
    for h, c in tstate.carries:
        assert h.dtype == c.dtype == torch.float32


# ---------------------------------------------------------------------------
# 8. the command line
# ---------------------------------------------------------------------------


def test_cli_train_bf16_end_to_end(tmp_path):
    """``train --compute-dtype bfloat16 --logits-dtype bfloat16`` on
    ptb_char, the CPU: exits 0 and the logged loss falls."""
    path = tmp_path / "m.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "lstm_tensorspark_torch", "train",
         "--device", "cpu", "--hidden-units", "32", "--batch-size", "8",
         "--seq-len", "16", "--num-steps", "40", "--log-every", "10",
         "--learning-rate", "0.5", "--stateful", "--compute-dtype",
         "bfloat16", "--logits-dtype", "bfloat16", "--jsonl", str(path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    records = [json.loads(line) for line in path.read_text().splitlines()]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert records[-1]["note"] == "final"


def test_cli_dtype_flags_on_imdb(tmp_path, capsys):
    """As JAX's command: --logits-dtype is an LM flag the classifier
    ignores (the run is the float32 one, loss for loss); --compute-dtype
    bfloat16 on imdb trains the classifier in bf16."""
    base = ["train", "--dataset", "imdb", "--device", "cpu",
            "--hidden-units", "8", "--seq-len", "16", "--batch-size", "4",
            "--num-steps", "2", "--log-every", "1", "--compute-dtype",
            "float32"]
    runs = []
    for i, extra in enumerate(([], ["--logits-dtype", "bfloat16"])):
        path = tmp_path / f"{i}.jsonl"
        assert tcli.main(base + extra + ["--jsonl", str(path)]) == OK_RC
        runs.append([json.loads(line)["loss"] for line in
                     path.read_text().splitlines() if '"loss"' in line])
    assert len(runs[0]) == 2 and runs[0] == runs[1]
    assert tcli.main(base + ["--compute-dtype", "bfloat16"]) == OK_RC
    assert "not ported" not in capsys.readouterr().err
