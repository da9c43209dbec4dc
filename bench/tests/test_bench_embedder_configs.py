"""An embedder configuration names its own architecture: the port's
``ModelConfig`` keywords (``port_model``) and the plain reference module
(``reference``) whose ``layer_parameters`` the benchmark draws and loads.

The weights drawn for the dense decoder stay bit for bit what they were
before references declared their parameters; the reference's list fits
the port's model at published widths, with no memory; the draw and the
strict load take every family of the port's zoo; a model of another
architecture lands as new files and new entries alone; and a reference
that does not fit the port fails at set-up, naming the parameter."""

import copy
import dataclasses
import hashlib
import json
import math
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench.lib import harness, inputs, system
from bench.reference import decoder
from conftest import ROOT, TINY_MODEL

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 99
EMBEDDER_CONFIGS = [c for c in BENCH["configs"]
                    if json.loads((ROOT / c["file"]).read_text())["kind"] == "embedder"]


def test_dense_weights_are_the_ones_drawn_before_references_listed_them():
    # The digest of the same draw by the benchmark's code before this
    # interface (torch 2.13 on the CPU): layer_shapes' seven matrices from
    # ("layer", i), the two norms as one [2, d] draw from ("norms", i).
    state = inputs.model_weights(TINY_MODEL, decoder.layer_parameters, 2, "cpu", SEED)
    h = hashlib.sha256()
    for name in sorted(state):
        t = state[name].contiguous()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.view(torch.int16).numpy().tobytes())
    assert len(state) == 2 + 2 * 9
    assert h.hexdigest() == "adb72620b57ed260c97f11df7d810307061b207340abf615b0d4132aa4eaf61c"


def test_yi9b_port_model_builds_the_model_config_mapped_before():
    from repro_torch.models.config import ModelConfig

    config = json.loads((ROOT / "bench/configs/yi9b-embed-rag.json").read_text())
    want = ModelConfig(name="yi9b-embed-rag", family="dense", num_layers=48, d_model=4096, num_heads=32,
                       num_kv_heads=4, head_dim=128, d_ff=11008, vocab_size=64000, rope_theta=10000.0,
                       norm_eps=1e-6)
    assert system.model_config(config["name"], config["port_model"]) == want
    assert config["reference"] == "decoder"


@pytest.mark.parametrize("entry", EMBEDDER_CONFIGS, ids=[c["name"] for c in EMBEDDER_CONFIGS])
def test_reference_lists_the_ports_parameters_at_published_widths(entry):
    from repro_torch.models import model as M

    from bench.lib import spec

    config = json.loads((ROOT / entry["file"]).read_text())
    published = config["model"]
    ref = spec.reference(config["reference"])
    port = M.params_shape(system.model_config(config["name"], config["port_model"]))
    assert port.device.type == "meta"
    assert len(port.layers) == published["num_hidden_layers"]
    assert tuple(port.embed.shape) == (published["vocab_size"], published["hidden_size"])
    assert tuple(port.ln_final.shape) == (published["hidden_size"],)
    for i, layer in enumerate(port.layers):
        listed = [(n, tuple(s)) for n, s, _init in ref.layer_parameters(published, i)]
        assert len(listed) == len(dict(listed))
        assert dict(listed) == {n: tuple(p.shape) for n, p in layer.state_dict(keep_vars=True).items()}


def _listed_from(port):
    """A parameter list read off the port's own model: 1/sqrt(fan-in) for
    matrices, ``"norm"`` for every vector."""
    def layer_parameters(_model, i):
        return [(n, tuple(p.shape), "norm" if p.dim() == 1 else 1 / math.sqrt(p.shape[-2]))
                for n, p in port.layers[i].state_dict(keep_vars=True).items()]

    return layer_parameters


@pytest.mark.parametrize("arch", ["yi-9b", "qwen3-32b", "qwen1.5-4b", "minicpm3-4b", "deepseek-moe-16b",
                                  "qwen3-moe-30b-a3b", "mamba2-370m", "jamba-v0.1-52b"])
def test_every_family_of_the_zoo_draws_loads_and_embeds(arch):
    from repro_torch.configs import ARCHS
    from repro_torch.models import model as M
    from repro_torch.models.embedder import Embedder

    cfg = ARCHS[arch].reduced()
    # ``port_model`` as a configuration file holds it.
    port_model = json.loads(json.dumps({k: v for k, v in dataclasses.asdict(cfg).items() if k != "name"}))
    assert system.model_config(cfg.name, port_model) == cfg
    published = {"hidden_size": cfg.d_model, "vocab_size": cfg.vocab_size}
    state = inputs.model_weights(published, _listed_from(M.params_shape(cfg)), cfg.num_layers, "cpu", SEED)
    model, port = M.params_shape(cfg), dict(M.params_shape(cfg).named_parameters())
    system.load_weights(model, state)
    loaded = dict(model.named_parameters())
    assert set(loaded) - set(state) <= {"lm_head"}
    assert all(not p.is_meta and p.dtype == port[n].dtype for n, p in loaded.items() if n in state)
    tokens = torch.randint(0, cfg.vocab_size, (3, 16), generator=torch.Generator().manual_seed(3))
    rows = Embedder(cfg, model, max_batch=2).embed(tokens)
    assert rows.shape == (3, cfg.d_model) and bool(torch.isfinite(rows).all())
    assert torch.allclose(torch.linalg.vector_norm(rows, dim=1), torch.ones(3), atol=1e-5)


# A dense decoder with per-head RMSNorm on queries and keys (Qwen3's layer),
# as a later change would add it: a module of its own under bench/reference/.
QK_NORM_REFERENCE = '''"""Plain float32 dense decoder with per-head query and key RMSNorm."""

from bench.lib import yardstick
from bench.reference import decoder as d


def layer_parameters(model, layer):
    hd = model["head_dim"]
    return d.layer_parameters(model, layer) + [("attn.q_head_norm", (hd,), "norm"),
                                               ("attn.k_head_norm", (hd,), "norm")]


def _layer(x, w, model, precision):
    b, s, _ = x.shape
    hd, h, kvh = model["head_dim"], model["num_attention_heads"], model["num_key_value_heads"]
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    a = d.rms(x, w["ln_attn"], eps)
    q = d.rms(d.mm(a, w["attn.w_q"], precision).view(b, s, h, hd), w["attn.q_head_norm"], eps)
    k = d.rms(d.mm(a, w["attn.w_k"], precision).view(b, s, kvh, hd), w["attn.k_head_norm"], eps)
    v = d.mm(a, w["attn.w_v"], precision).view(b, s, kvh, hd)
    x = x + d.mm(d.causal_attention(d.rope(q, theta), d.rope(k, theta), v), w["attn.w_o"], precision)
    return x + d.swiglu(d.rms(x, w["ln_mlp"], eps), w, precision)


def embed(tokens, model, seed, device, precision="float32", block=16):
    return d.pooled_embeddings(tokens, model, seed, device, layer_parameters, _layer, precision, block)


flops_per_token = yardstick.decoder_flops_per_token
'''

RUN_IN_COPY = '''
import json, sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/bench/tests"]
import conftest  # the copy's root and src/ on the path, and its tiny sizes
from bench.lib import harness, spec
assert harness.__file__.startswith(root) and str(spec.ROOT) == root
out = {}
for control in (False, True):
    cell = conftest.tiny(spec.load_cell("qwen3-rag-ingest"))
    res = harness.run_cell(cell, int(sys.argv[2]), 1.5, False, "cpu", time.time(), log=lambda m: None,
                           control=control)
    out["control" if control else "program"] = {"correct": res["correct"], "checks": res["checks"],
                                                "metrics": sorted(res["metrics"])}
print(json.dumps(out))
'''


def _digests(root):
    files = [root / "BENCHMARK.json"] + [p for p in (root / "bench").rglob("*")
                                         if p.is_file() and "__pycache__" not in p.parts]
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def test_a_model_of_another_architecture_lands_as_new_files(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    before = _digests(root)

    # Three new things: a configuration naming a new reference, that
    # reference, and a cell; and the cell's name in the ingest metrics'
    # ``workloads``.
    config = json.loads((ROOT / "bench/configs/yi9b-embed-rag.json").read_text())
    config.update(name="qwen3-embed-rag", reference="qk_norm_decoder",
                  source="https://huggingface.co/Qwen/Qwen3-8B")
    config["model"].update(TINY_MODEL, rope_theta=1000000.0)
    config["port_model"].update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                                vocab_size=512, qk_norm=True, rope_theta=1000000.0)
    (root / "bench/configs/qwen3-embed-rag.json").write_text(json.dumps(config, indent=2))
    (root / "bench/reference/qk_norm_decoder.py").write_text(QK_NORM_REFERENCE)
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "qwen3-embed-rag", "source": "https://huggingface.co/Qwen/Qwen3-8B",
                             "file": "bench/configs/qwen3-embed-rag.json", "reduced": [],
                             "why": "per-head query and key RMSNorm in the embedder"})
    bench["workloads"].append({"name": "qwen3-rag-ingest", "config": "qwen3-embed-rag",
                               "traffic": "rag-ingest", "chips": 1, "why": "the ingest mix on another family"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "yi9b-rag-ingest" in m.get("workloads", ()):
            m["workloads"].append("qwen3-rag-ingest")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    out = subprocess.run([sys.executable, "-c", RUN_IN_COPY, str(root), str(SEED)], capture_output=True,
                         text=True, cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["program"]["correct"] is True, got
    assert got["control"]["correct"] is False, got
    assert got["control"]["checks"]["embed_gap"]["value"] > got["control"]["checks"]["embed_gap"]["limit"]
    assert "ingest_rows_s" in got["program"]["metrics"]

    after = _digests(root)
    assert set(after) - set(before) == {"bench/configs/qwen3-embed-rag.json", "bench/reference/qk_norm_decoder.py"}
    assert {n: h for n, h in after.items() if n in before and n != "BENCHMARK.json"} == \
        {n: h for n, h in before.items() if n != "BENCHMARK.json"}
    # BENCHMARK.json gained entries and lost or changed none.
    new = json.loads((root / "BENCHMARK.json").read_text())
    for m in new["end_to_end"] + new["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != "qwen3-rag-ingest"]
    new["configs"], new["workloads"] = new["configs"][:-1], new["workloads"][:-1]
    assert new == BENCH


def _fits_not(kind):
    parameters = decoder.layer_parameters

    def listed(model, layer):
        out = parameters(model, layer)
        if kind == "extra":
            return out + [("attn.w_extra", (4, 4), 0.1)]
        if kind == "left_out":
            return [p for p in out if p[0] != "mlp.w_up"]
        return [(n, (s[0], s[1] + 1) if n == "attn.w_k" else s, i) for n, s, i in out]

    return listed


@pytest.mark.parametrize("kind,named", [("extra", "layers.0.attn.w_extra"), ("left_out", "layers.0.mlp.w_up"),
                                        ("wrong_shape", "layers.0.attn.w_k")])
def test_a_reference_that_does_not_fit_the_port_fails_at_set_up(run_tiny, monkeypatch, kind, named):
    monkeypatch.setattr(decoder, "layer_parameters", _fits_not(kind))
    with pytest.raises(ValueError, match=named.replace(".", r"\.")):
        run_tiny("yi9b-rag-ingest")


@pytest.mark.parametrize("key", ["reference", "port_model"])
def test_an_embedder_configuration_without_its_key_fails_at_set_up(tiny_cell, key):
    cell = tiny_cell("yi9b-rag-ingest")
    del cell.config[key]
    with pytest.raises(KeyError, match=key):
        harness.run_cell(cell, SEED, 1.0, False, "cpu", time.time(), log=lambda m: None)
