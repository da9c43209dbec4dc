"""Each plain reference agrees with the port at a tiny size on the CPU,
and its lower-precision control lies farther from it than the port does."""

import torch

from bench.lib import inputs
from bench.reference import decoder, exact_search
from conftest import TINY_MODEL

SEED = 2**31 + 99


def _data(metric):
    gen = torch.Generator().manual_seed(5)
    rows = torch.randn(3000, 48, generator=gen)
    q = torch.randn(7, 48, generator=gen)
    if metric == "cosine":
        rows = rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    return q, rows


def test_exact_topk_matches_the_ports_scan():
    from repro_torch.kernels import ops

    for metric in ("l2", "ip"):
        q, rows = _data(metric)
        dead = torch.tensor([3, 17, 2999])
        valid = torch.ones(len(rows), dtype=torch.bool)
        valid[dead] = False
        s, i = ops.topk_scan(q, rows, 10, metric=metric, valid=valid)
        rs, ri = exact_search.topk(q, rows, 10, metric, exclude=dead, block=1000)
        assert torch.equal(i, ri)
        assert torch.allclose(s.double(), rs, rtol=1e-5, atol=1e-4)
        assert torch.allclose(exact_search.scores_of(q, rows, ri, metric), rs)


def test_tf32_control_is_farther_than_float32():
    q, rows = _data("cosine")
    rs, ri = exact_search.topk(q, rows, 10, "cosine")
    f32 = (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)) @ rows.T
    ts, ti = exact_search.topk(q, rows, 10, "cosine", precision="tf32")
    err32 = (torch.topk(f32, 10).values.double() - rs).abs().max()
    errtf = (ts.double() - exact_search.scores_of(q, rows, ti, "cosine")).abs().max()
    assert errtf > 30 * err32


def _port_embeddings(tokens, model):
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.embedder import Embedder

    cfg = ModelConfig(name="tiny", family="dense", num_layers=model["num_hidden_layers"],
                      d_model=model["hidden_size"], num_heads=model["num_attention_heads"],
                      num_kv_heads=model["num_key_value_heads"], head_dim=model["head_dim"],
                      d_ff=model["intermediate_size"], vocab_size=model["vocab_size"],
                      rope_theta=model["rope_theta"], norm_eps=model["rms_norm_eps"])
    state = {"embed": inputs.embedding_table(model, "cpu", SEED),
             "ln_final": inputs.final_norm(model, "cpu", SEED)}
    for layer in range(model["num_hidden_layers"]):
        for n, w in inputs.layer_weights(decoder.layer_parameters(model, layer), layer, "cpu", SEED).items():
            state[f"layers.{layer}.{n}"] = w
    m = M.params_shape(cfg)
    m.load_state_dict(state, strict=False, assign=True)
    return Embedder(cfg, m, max_batch=4).embed(tokens)


def test_decoder_reference_matches_the_ports_embedder():
    model = dict(TINY_MODEL, rope_theta=10000.0, rms_norm_eps=1e-6)
    tokens = torch.randint(0, model["vocab_size"], (6, 16), generator=torch.Generator().manual_seed(1))
    ref = decoder.embed(tokens, model, SEED, "cpu", block=4)
    got = _port_embeddings(tokens, model)
    gap = torch.linalg.vector_norm(got - ref, dim=1).max()
    ctl = torch.linalg.vector_norm(decoder.embed(tokens, model, SEED, "cpu", precision="fp8") - ref, dim=1).max()
    assert gap < 0.03  # bf16 weights and activations against float32
    assert ctl > 3 * gap
