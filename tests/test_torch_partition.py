"""The port's partitioning rules (``repro_torch.distributed.partition``)
against the reference's, entry for entry, for all ten architectures at
their published widths.

The reference's ``param_specs`` / ``cache_specs`` are pure functions of
names, shapes and axis sizes: they run here on ``jax.eval_shape`` trees
and a stand-in mesh whose ``.shape`` is the axis-size dict, so no devices
are forced.  The port keys its specs by ``state_dict`` names, one layer
each: the reference's leading None for the stacked periods axis is
dropped, and layer ``period * len(pattern) + slot`` takes ``slotS``'s
spec.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference's import order)
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.distributed import partition as RP  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.distributed import partition as PP  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}


class StandIn:
    """A mesh as the reference's rules read it: ``.shape`` only."""

    def __init__(self, shape: dict):
        self.shape = shape


@functools.lru_cache(maxsize=None)
def _ref_params_shape(name: str):
    return RM.params_shape(REF_ARCHS[name])


def _ref_by_layer(cfg, tree: dict) -> dict:
    """A reference tree of specs keyed by the port's names, the periods
    entry dropped from the stacked layers'."""
    pattern = PM.effective_pattern(cfg)
    out = {}

    def walk(node, prefix, layer_of=None):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{key}.", layer_of)
            elif layer_of is None:
                out[prefix + key] = tuple(leaf)
            else:
                for layer in layer_of:
                    out[f"layers.{layer}.{prefix}{key}"] = tuple(leaf)[1:]

    walk({k: v for k, v in tree.items() if k != "layers"}, "")
    for slot in range(len(pattern)):
        layers = [p * len(pattern) + slot for p in range(PM.num_periods(cfg))]
        walk(tree["layers"][f"slot{slot}"], "", layers)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_match_reference(name, mesh):
    cfg = ARCHS[name]
    shape = PM.params_shape(cfg)
    for fsdp in (True, False):
        ref = RP.param_specs(REF_ARCHS[name], StandIn(MESHES[mesh]), _ref_params_shape(name), fsdp)
        want = _ref_by_layer(cfg, jax.tree_util.tree_map(
            tuple, ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        got = PP.param_specs(cfg, MESHES[mesh], shape, fsdp)
        assert sorted(got) == sorted(want)
        for key, spec in want.items():
            assert got[key] == spec, (key, fsdp, got[key], spec)
        assert got == PP.param_specs(cfg, StandIn(MESHES[mesh]), shape, fsdp)


def _cache_cases():
    out = []
    for name, cfg in sorted(ARCHS.items()):
        for shape in ("decode_32k", "prefill_32k", "long_500k"):
            if shape == "long_500k" and not cfg.sub_quadratic():
                continue
            out.append((name, shape))
    return out


@pytest.mark.parametrize("name,shape", _cache_cases())
def test_cache_specs_match_reference(name, shape):
    cfg, sc = ARCHS[name], SHAPES[shape]
    ref_cache = RM.cache_shape(REF_ARCHS[name], sc.global_batch, sc.seq_len)
    port_cache = PM.cache_shape(cfg, sc.global_batch, sc.seq_len)
    pattern = PM.effective_pattern(cfg)
    for mesh in MESHES.values():
        ref = RP.cache_specs(REF_ARCHS[name], StandIn(mesh), ref_cache, sc.global_batch)
        got = PP.cache_specs(cfg, mesh, port_cache, sc.global_batch)
        assert got["length"] == tuple(ref["length"]) == ()
        assert len(got["layers"]) == cfg.num_layers
        for layer, specs in enumerate(got["layers"]):
            want = ref[f"slot{layer % len(pattern)}"]
            assert sorted(specs) == sorted(want)
            for key, spec in specs.items():
                assert spec == tuple(want[key])[1:], (layer, key, spec, want[key])


def test_batch_spec_and_axes_match_reference():
    for mesh in MESHES.values():
        assert PP.batch_axes(mesh) == RP.batch_axes(StandIn(mesh))
        for batch in (1, 2, 4, 16, 32, 128, 256, 6):
            assert PP.batch_spec(mesh, batch) == tuple(RP.batch_spec(StandIn(mesh), batch))


def test_local_shards_tile_the_whole():
    """Every rank's block under a spec, at its mesh coordinates, tiles the
    tensor exactly once (the first axis of a tuple major)."""
    mesh = {"pod": 2, "data": 2, "model": 3}
    full = torch.arange(4 * 6 * 5).reshape(4, 6, 5)
    for spec in ((("pod", "data"), "model", None), ("data", None, None), (None, ("data", "model"), None),
                 (None, "model")):
        blocks = 1
        for entry in spec:
            blocks *= PP.shard_index(entry, {}, mesh)[1]
        seen = torch.zeros_like(full)
        for pod in range(2):
            for data in range(2):
                for model in range(3):
                    coords = {"pod": pod, "data": data, "model": model}
                    sl = PP.local_slices(full.shape, spec, coords, mesh)
                    assert full[sl].shape == PP.local_shape(full.shape, spec, mesh)
                    seen[sl] += 1
        assert (seen == 12 // blocks).all(), spec  # each block held by the ranks it is replicated on
    # the first axis of a tuple is the major one, as PartitionSpec orders them
    assert PP.shard_index(("pod", "data"), {"pod": 1, "data": 0}, mesh) == (2, 4)
    assert PP.shard_index(("pod", "data"), {"pod": 0, "data": 1}, mesh) == (1, 4)


@pytest.mark.parametrize("name", ["yi-9b", "paligemma-3b"])
def test_input_specs_and_identity_constraints_keep_the_reference_names(name):
    """``steps.input_specs`` / ``batch_specs`` give the reference's inputs
    and specs, and ``constrain`` / ``constrain_tree_batch`` /
    ``model_axis_size`` keep the reference's names: under local shards
    there is nothing to constrain, so each returns its argument (1 for
    the width outside a policy)."""
    from repro.launch import steps as RS
    from repro_torch.distributed import act_sharding
    from repro_torch.launch import steps as PS

    for shape in SHAPES.values():
        got, want = PS.input_specs(ARCHS[name], shape), RS.input_specs(REF_ARCHS[name], shape)
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
        for mesh in MESHES.values():
            assert PS.batch_specs(ARCHS[name], shape, mesh) == {
                k: tuple(v) for k, v in RS.batch_specs(REF_ARCHS[name], shape, StandIn(mesh)).items()}
    x = torch.ones(2, 3)
    tree = {"tokens": x, "nested": [x]}
    assert act_sharding.constrain(x, "batch", None) is x
    assert act_sharding.constrain_tree_batch(tree, {2: 0}) is tree
    assert act_sharding.model_axis_size() == 1
