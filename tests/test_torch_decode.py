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


def test_kernel_shared_memory_plan():
    # x [E] + h, c [L, H] + z [4H] floats; config 5 (H=1024, L=4) needs
    # about 53 KB (above the 48 KB default, below the 227 KB cap)
    assert cuda_decode.smem_bytes(1, 128, 128) == 4 * (128 + 256 + 512)
    assert cuda_decode.smem_bytes(4, 1024, 1024) == 53248
    assert cuda_decode.smem_bytes(4, 1024, 1024) < cuda_decode.MAX_SMEM_BYTES
    assert cuda_decode.sampling_supported(1.0, 5, None, True)
    assert not cuda_decode.sampling_supported(0.7, 5, None, False)
    assert cuda_decode.PAD_TOKEN == pallas_decode.PAD_TOKEN
