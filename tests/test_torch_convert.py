"""Parameter conversion between the JAX package and the PyTorch port.

The JAX LM pytree (numpy leaves) goes into the port through
``lstm_tensorspark_torch.convert.params_from_numpy`` and back out through
``params_to_numpy``; both directions must copy every value bit for bit,
for tied and untied heads.
"""

import jax
import numpy as np
import pytest
import torch

from lstm_tensorspark_torch.convert import params_from_numpy, params_to_numpy
from lstm_tensorspark_torch.ops.lstm_cell import LSTMParams
from lstm_tensorspark_tpu.models import LMConfig, init_lm

torch.set_num_threads(1)

_FIELDS = LSTMParams._fields


def _jax_params(tied: bool, layers: int = 2):
    cfg = LMConfig(vocab_size=29, hidden_size=12, num_layers=layers,
                   tie_embeddings=tied)
    return jax.tree.map(np.asarray, init_lm(jax.random.PRNGKey(3), cfg))


@pytest.mark.parametrize("tied", [False, True])
def test_round_trip_is_bit_exact(tied):
    tree = _jax_params(tied)
    port = params_from_numpy(tree, device="cpu")
    back = params_to_numpy(port)
    np.testing.assert_array_equal(back["embedding"], tree["embedding"])
    assert back["embedding"].dtype == np.float32
    assert len(back["layers"]) == len(tree["layers"])
    for got, ref in zip(back["layers"], tree["layers"]):
        for f in _FIELDS:
            np.testing.assert_array_equal(got[f], getattr(ref, f))
    assert set(back["head"]) == set(tree["head"])
    for k in tree["head"]:
        np.testing.assert_array_equal(back["head"][k], tree["head"][k])
    # tied: no head kernel anywhere; untied: the kernel is [H, V]
    assert ("kernel" in port["head"]) is (not tied)


def test_port_params_are_owned_tensors_in_the_port_layout():
    tree = _jax_params(False, layers=1)
    port = params_from_numpy(tree, device="cpu")
    layer = port["layers"][0]
    assert isinstance(layer, LSTMParams)
    assert layer.W_i.shape == (12, 12) and layer.b_f.shape == (12,)
    assert port["head"]["kernel"].shape == (12, 29)
    # owned copies: writing the port's tensor leaves the source untouched
    before = tree["embedding"].copy()
    port["embedding"].add_(1.0)
    np.testing.assert_array_equal(tree["embedding"], before)


def test_layers_given_as_mappings_convert_too():
    tree = _jax_params(True, layers=1)
    as_dicts = dict(tree, layers=[{f: getattr(l, f) for f in _FIELDS}
                                  for l in tree["layers"]])
    a = params_to_numpy(params_from_numpy(tree, device="cpu"))
    b = params_to_numpy(params_from_numpy(as_dicts, device="cpu"))
    for f in _FIELDS:
        np.testing.assert_array_equal(a["layers"][0][f], b["layers"][0][f])
