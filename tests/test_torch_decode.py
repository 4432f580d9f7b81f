"""The decode window's plain PyTorch version against the JAX Pallas kernel.

``lstm_tensorspark_torch.ops.cuda_decode.decode_window_reference`` (the
version the CUDA kernel is held against on the card) and
``lstm_tensorspark_tpu.ops.pallas_decode.decode_window_call`` in interpret
mode (how the JAX package's own tests run its kernel on the CPU) get the
same weights, carries, latches and Gumbel noise. Tokens and the row
summary must be identical; h/c agree within 1e-5 (float32 rounding of
differently ordered sums). The batches hold a row that hits EOS
mid-window, a row whose budget ends mid-window and a row dead on entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.convert import params_from_numpy
from lstm_tensorspark_torch.models.generate import fuse_layers as t_fuse_layers
from lstm_tensorspark_torch.ops import cuda_decode
from lstm_tensorspark_torch.ops.lstm_cell import FusedLSTMParams
from lstm_tensorspark_tpu.models import LMConfig, init_lm
from lstm_tensorspark_tpu.models.generate import fuse_layers as j_fuse_layers
from lstm_tensorspark_tpu.ops import pallas_decode

torch.set_num_threads(1)

V, H = 37, 16
TEMPERATURE = 0.7


def _models(L, tied):
    cfg = LMConfig(vocab_size=V, hidden_size=H, num_layers=L,
                   tie_embeddings=tied)
    jparams = init_lm(jax.random.PRNGKey(10 + L), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    weights = cuda_decode.decode_weights(
        tparams, t_fuse_layers(tparams, None), tied)
    return cfg, jparams, j_fuse_layers(jparams, cfg), weights


def _port(weights, h, c, tok, alive, rem, eos, noise, K, greedy):
    return cuda_decode.decode_window_reference(
        weights, torch.from_numpy(h), torch.from_numpy(c),
        torch.from_numpy(tok), torch.from_numpy(alive), torch.from_numpy(rem),
        torch.from_numpy(eos), None if noise is None else torch.from_numpy(noise),
        window=K, temperature=TEMPERATURE, greedy=greedy)


# (layers, batch, window, greedy, tied head): every K in {1, 4, 8}, B in
# {1, 4} and L in {1, 2} appears in both sampling modes
CASES = [
    (1, 1, 1, True, False),
    (1, 4, 4, True, False),
    (2, 4, 8, True, False),
    (1, 4, 1, True, True),
    (2, 1, 8, False, False),
    (1, 4, 8, False, True),
    (2, 4, 4, False, False),
    (2, 4, 1, False, False),
]


@pytest.mark.parametrize("L,B,K,greedy,tied", CASES)
def test_reference_matches_jax_kernel(L, B, K, greedy, tied):
    cfg, jparams, jfused, weights = _models(L, tied)
    rng = np.random.RandomState(100 * L + 10 * B + K)
    h = (rng.randn(L, B, H) * 0.5).astype(np.float32)
    c = (rng.randn(L, B, H) * 0.5).astype(np.float32)
    tok = rng.randint(0, V, size=B).astype(np.int32)
    noise = None if greedy else rng.gumbel(size=(K, B, V)).astype(np.float32)
    alive = np.ones(B, np.int32)
    rem = np.full(B, K + 3, np.int32)
    eos = np.full(B, -1, np.int32)
    # pick an EOS id the row really emits mid-window: the token a probe run
    # (no EOS) produced at the window's middle step
    probe = _port(weights, h, c, tok, alive, rem, eos, noise, K, greedy)[2]
    eos[0] = int(probe[K // 2, 0])
    if B == 4:
        rem[1] = max(1, K // 2)      # budget ends mid-window
        alive[2], rem[2] = 0, 0      # dead on entry
        tok[2] = 5
    h_t, c_t, toks_t, next_t, alive_t, rem_t = _port(
        weights, h, c, tok, alive, rem, eos, noise, K, greedy)
    h_j, c_j, toks_j, next_j, alive_j, rem_j = pallas_decode.decode_window_call(
        jparams, jfused, cfg, jnp.asarray(h), jnp.asarray(c),
        jnp.asarray(tok), jnp.asarray(alive.astype(bool)), jnp.asarray(rem),
        jnp.asarray(eos), None if noise is None else jnp.asarray(noise),
        window=K, temperature=TEMPERATURE, greedy=greedy, interpret=True)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    np.testing.assert_array_equal(next_t.numpy(), np.asarray(next_j))
    np.testing.assert_array_equal(alive_t.numpy(), np.asarray(alive_j))
    np.testing.assert_array_equal(rem_t.numpy(), np.asarray(rem_j))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5, rtol=0)
    toks = toks_t.numpy()
    # the edge rows did what they are there for (the EOS row stops at the
    # first step that emits its EOS id)
    hit = int(np.flatnonzero(probe[:, 0].numpy() == eos[0])[0])
    assert toks[hit, 0] == eos[0] and (toks[hit + 1:, 0] == -1).all()
    if B == 4:
        assert (toks[:, 2] == -1).all()
        np.testing.assert_array_equal(h_t.numpy()[:, 2], h[:, 2])
        assert (toks[rem[1]:, 1] == -1).all() and (toks[:rem[1], 1] >= 0).all()


def test_dispatch_runs_the_plain_version_for_cpu_tensors():
    _, _, _, weights = _models(1, False)
    z = torch.zeros(1, 2, H)
    row = torch.zeros(2, dtype=torch.int32)
    before = (cuda_decode.counts.kernel, cuda_decode.counts.reference)
    out = cuda_decode.decode_window(
        weights, z, z.clone(), row, torch.ones(2, dtype=torch.bool),
        torch.full((2,), 3, dtype=torch.int32), row - 1, None, window=2,
        temperature=1.0, greedy=True)
    ref = cuda_decode.decode_window_reference(
        weights, z, z.clone(), row, torch.ones(2, dtype=torch.bool),
        torch.full((2,), 3, dtype=torch.int32), row - 1, None, window=2,
        temperature=1.0, greedy=True)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cuda_decode.counts.kernel == before[0]
    assert cuda_decode.counts.reference == before[1] + 1
    with pytest.raises(ValueError, match="window"):
        cuda_decode.decode_window(weights, z, z, row, row, row, row, None,
                                  window=0, temperature=1.0, greedy=True)


def _r4(n):
    return -(-n // 4) * 4


def _window_smem(plan, models, V, B, fields, copies):
    """csrc/decode_common.cuh window_smem_bytes, written out again: the x
    staging buffer (16 rows), the k-slices' partials (256 threads x 16
    rows), a tile's argmax (2 x 16), the rows' latches, and for a
    one-cluster launch the state and each model's embedding; the layer and
    head slices; every piece on 16 bytes."""
    f = plan.stage * 16 + 256 * 16 + 32
    f += _r4(fields * B) if plan.rows_smem else 0
    for (L, H, E), n, nu in zip(models, copies, plan.units):
        if plan.cluster:
            f += n * _r4(L * B * H) + _r4(V * E)
        if plan.layers_smem:
            f += _r4(sum(((E if l == 0 else H) + H + 1) * 4 * nu
                         for l in range(L)))
        if plan.head_smem:
            f += _r4((H + 1) * plan.head_cols)
    return 4 * f


def test_kernel_shared_memory_plan():
    # config 1 (L=1, H=128, V=50) at the engine's widest bucket: one cluster
    # of 16 blocks, each holding its 8 units' gate columns, the whole head
    # and the embedding, so every weight is read once per window; 142,032
    # bytes a block (the 227 KB cap is 232,448)
    p = cuda_decode.plan([(1, 128, 128)], 50, 16)
    assert (p.blocks, p.cluster, p.units, p.head_cols) == (16, 1, (8,), 50)
    assert p.layers_smem and p.head_smem and p.rows_smem
    assert p.offchip_bytes == ((0, 0),)
    assert p.stage == 256  # x and h of one layer at once
    assert p.smem_bytes == _window_smem(p, [(1, 128, 128)], 50, 16, 4, (3,))
    assert p.smem_bytes == 142032 < cuda_decode.MAX_SMEM_BYTES
    # config 5's width (L=4, H=1024) with a small head: one block an SM,
    # 8 units each; the layers (134 MB) read through L2 every step, the
    # head's slice on chip
    p5 = cuda_decode.plan([(4, 1024, 1024)], 1000, 2)
    assert (p5.blocks, p5.cluster, p5.units, p5.head_cols) == (132, 0, (8,), 8)
    assert not p5.layers_smem and p5.head_smem
    assert p5.offchip_bytes == ((4 * (4 * 2048 * 4096 + 4 * 4096), 0),)
    assert p5.smem_bytes == _window_smem(p5, [(4, 1024, 1024)], 1000, 2, 4,
                                         (3,))
    assert p5.smem_bytes <= cuda_decode.MAX_SMEM_BYTES
    # the refusals: more than 8 layers, an empty width; the launch path
    # refuses before it touches a card
    with pytest.raises(ValueError, match="layers"):
        cuda_decode.plan([(9, 16, 16)], 37, 1)
    with pytest.raises(ValueError, match="hidden"):
        cuda_decode.plan([(1, 0, 16)], 37, 1)
    layer = FusedLSTMParams(torch.zeros(1), torch.zeros(1), torch.zeros(1))
    weights = cuda_decode.DecodeWeights(torch.zeros(37, 16), (layer,) * 9,
                                        torch.zeros(1), torch.zeros(1))
    row = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="layers"):
        cuda_decode._launch(weights, torch.zeros(9, 1, 16),
                            torch.zeros(9, 1, 16), row, row, row, row, None,
                            2, 1.0, True)
    assert cuda_decode.sampling_supported(1.0, 5, None, True)
    assert not cuda_decode.sampling_supported(0.7, 5, None, False)
    assert cuda_decode.PAD_TOKEN == pallas_decode.PAD_TOKEN


# (models, V, B, k_draft or None, blocks, cluster, units, where the layers,
# heads and rows' latches live: (layers_smem, head_smem, rows_smem))
ON_CHIP = (True, True, True)
PLAN_CASES = (
    # config 1 at every batch bucket of the engine (serve/engine.py)
    [([(1, 128, 128)], 50, B, None, 16, 1, (8,), ON_CHIP)
     for B in (1, 2, 4, 8, 16)]
    # config 1 and its draft (H=32): both split, 8 and 2 units a block
    + [([(1, 128, 128), (1, 32, 32)], 50, B, K, 16, 1, (8, 2), ON_CHIP)
       for B, K in ((1, 1), (8, 2), (16, 4))]
    # config 3's width (L=2, H=650, V=33,278) and its draft (H=162): the
    # layers through L2, the head streamed
    + [([(2, 650, 650)], 33278, 4, None, 132, 0, (5,), (False, False, True)),
       ([(2, 650, 650), (1, 162, 162)], 33278, 4, 4, 132, 0, (5, 2),
        (False, False, True))]
    # a mid-size model (L=2, H=256-512, V=10,000): a grid whose layer
    # slices stay on chip, with the head's slices too or streamed
    + [([(2, 256, 256)], 10000, 4, None, 132, 0, (2,), ON_CHIP),
       ([(2, 512, 512)], 10000, 4, None, 132, 0, (4,), (True, False, True)),
       ([(2, 512, 512), (1, 128, 128)], 10000, 4, 4, 132, 0, (4, 1),
        (True, False, True))]
    # config 5's width with a small head; B=1 and V=50: more blocks than
    # head columns
    + [([(4, 1024, 1024)], 1000, 2, None, 132, 0, (8,), (False, True, True)),
       ([(4, 1024, 1024)], 50, 1, None, 132, 0, (8,), (False, True, True))]
    # the serve CLI's defaults (L=2, H=64, V=89) and their draft (H=8):
    # the draft has fewer units than blocks
    + [([(2, 64, 64)], 89, B, None, 16, 1, (4,), ON_CHIP) for B in (1, 16)]
    + [([(2, 64, 64), (1, 8, 8)], 89, 16, 2, 16, 1, (4, 1), ON_CHIP)]
    # batches of thousands of rows: the rows' latches no longer fit beside
    # the staging buffer and go to global scratch, a copy a block
    + [([(1, 8, 8)], 50, 14000, None, 132, 0, (1,), (True, True, False)),
       ([(1, 8, 8), (1, 8, 8)], 50, 6000, 2, 132, 0, (1, 1),
        (True, True, False))])


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: f"{c[0]}-V{c[1]}-B{c[2]}-K{c[3]}")
def test_window_plan_cases(case):
    """The plan of every shape the windows are launched at: the blocks and
    their kind, each block's units (every unit owned once: the balanced
    split covers H), its head columns (all of them in a one-cluster
    launch, a slice otherwise: every column owned), where the weights and
    latches live, and the bytes a block asks for."""
    models, V, B, K, blocks, cluster, units, where = case
    p = cuda_decode.plan(models, V, B, K)
    assert (p.blocks, p.cluster, p.units) == (blocks, cluster, units)
    assert (p.layers_smem, p.head_smem, p.rows_smem) == where
    for (L, H, E), nu in zip(models, p.units):
        assert nu == -(-H // blocks)
    assert p.head_cols == (V if cluster else -(-V // blocks))
    fields, copies = (4, (3,)) if K is None else (8 + K, (3, 6))
    assert p.smem_bytes == _window_smem(p, models, V, B, fields, copies)
    assert p.smem_bytes <= cuda_decode.MAX_SMEM_BYTES
    for (L, H, E), (lay, head) in zip(models, p.offchip_bytes):
        assert lay == (0 if p.layers_smem else 4 * sum(
            ((E if l == 0 else H) + H + 1) * 4 * H for l in range(L)))
        assert head == (0 if p.head_smem else 4 * (H + 1) * V)
    # the card's resident clusters decide: none of 16 or 8 -> the grid
    grid = cuda_decode.plan(models, V, B, K, clusters={16: 0, 8: 0})
    assert grid.cluster == 0 and grid.blocks == 132


def _split(V, blocks):
    return [V * j // blocks for j in range(blocks + 1)]


@pytest.mark.parametrize("blocks", [1, 3, 16, 132])
def test_sliced_argmax_matches_jnp_argmax(blocks):
    """The window kernels' argmax (per-block V slices, lanes striding a
    slice, merged by value then lower index) against jnp.argmax, with ties
    across slice boundaries and within a lane's stride, -inf rows and
    slices, and more blocks than columns."""
    V = 50
    rng = np.random.RandomState(blocks)
    x = rng.randn(9, V).astype(np.float32)
    b = _split(V, blocks)[1] if blocks > 1 else 25
    x[0, b - 1] = x[0, b] = 9.0          # a tie across a slice boundary
    x[1, 3] = x[1, V - 1] = 9.0          # a tie across the whole row
    x[2] = -np.inf                       # every column -inf: index 0
    x[3] = -np.inf
    x[3, 37] = -1e30                     # one finite column in -inf slices
    x[4, 5] = x[4, 37] = 7.0             # a tie within one lane's stride
    x[5] = 1.5                           # every column tied
    x[6, :b] = -np.inf                   # the first slice all -inf
    x[7, V - 1] = x[7, 0] = 20.0         # the last and the first column
    x[8, 17] = x[8, 16] = 11.0           # a tie in one slice
    got = cuda_decode.sliced_argmax(torch.from_numpy(x), blocks)
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    assert got.tolist() == want.tolist()
    assert got.tolist() == torch.argmax(torch.from_numpy(x), dim=-1).tolist()