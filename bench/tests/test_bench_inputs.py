"""Each input stream repeats for a seed and differs across seeds."""

import numpy as np
import pytest
import torch

from bench.lib import inputs
from bench.reference import decoder

SEEDS = (2**31 + 5, 2**33 + 11)
DATA = {"centers": 8, "noise": 0.5, "normalize": True}
MODEL = {"num_hidden_layers": 2, "hidden_size": 32, "num_attention_heads": 4, "num_key_value_heads": 2,
         "head_dim": 8, "intermediate_size": 64, "vocab_size": 128}


def _rows(seed, stream):
    centers = inputs.mixture_centers(DATA, 16, "cpu", seed)
    return inputs.mixture_rows(DATA, centers, 50, "cpu", seed, stream)


@pytest.mark.parametrize("stream", ["rows", "queries", "writer"])
def test_mixture_rows_repeat_and_differ(stream):
    a, b = _rows(SEEDS[0], stream), _rows(SEEDS[0], stream)
    assert torch.equal(a, b)
    assert not torch.equal(a, _rows(SEEDS[1], stream))
    assert torch.allclose(torch.linalg.vector_norm(a, dim=1), torch.ones(50), atol=1e-6)


def test_streams_of_one_seed_differ():
    assert not torch.equal(_rows(SEEDS[0], "rows"), _rows(SEEDS[0], "queries"))


def test_documents_repeat_and_differ():
    def docs(seed):
        return inputs.synth_docs(np.random.default_rng(inputs.stream_seed(seed, "docs")), 6, 16, 512, 16)

    assert np.array_equal(docs(SEEDS[0]), docs(SEEDS[0]))
    assert not np.array_equal(docs(SEEDS[0]), docs(SEEDS[1]))
    assert docs(SEEDS[0]).min() >= 0 and docs(SEEDS[0]).max() < 512


def test_deletes_repeat_and_differ():
    a = inputs.doomed_pks(1000, 0.01, "cpu", SEEDS[0])
    assert torch.equal(a, inputs.doomed_pks(1000, 0.01, "cpu", SEEDS[0]))
    assert not torch.equal(a, inputs.doomed_pks(1000, 0.01, "cpu", SEEDS[1]))
    assert len(a) == 10 and len(set(a.tolist())) == 10


@pytest.mark.parametrize("layer", [0, 1])
def test_layer_weights_repeat_and_differ(layer):
    def draw(seed, at=layer):
        return inputs.layer_weights(decoder.layer_parameters(MODEL, at), at, "cpu", seed)

    a, b, c = draw(SEEDS[0]), draw(SEEDS[0]), draw(SEEDS[1])
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["attn.w_q"], c["attn.w_q"])
    assert a["attn.w_q"].dtype == torch.bfloat16 and a["mlp.w_down"].shape == (64, 32)
    assert not torch.equal(a["attn.w_q"], draw(SEEDS[0], 1 - layer)["attn.w_q"])
