"""parallel/mesh.py in the port against the JAX package (CPU): the specs
equal JAX's PartitionSpecs; each rank's shard_context_params shards equal
JAX's addressable shards on the same place of the virtual 8-device mesh;
make_mesh's defaults, the collectives and fetch_np over 2- and 4-process
Gloo groups (tests/_torch_mesh_child.py, one spawn for the module)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_child as child
from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu.parallel import mesh as JX
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.parallel import mesh as X


class MeshAt:
    """A (dp, tp) mesh seen from one place of it: what shard_tensor reads
    of a DeviceMesh (its dim names and sizes, this rank's coordinates)."""

    def __init__(self, shape, coord, names=("dp", "tp")):
        self.mesh_dim_names, self.shape, self.coord = names, shape, coord
        self.device_type = "cpu"

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return child.run_worlds({"basics2": 2, "basics4": 4}, tmp_path_factory.mktemp("mesh"))


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return JX.make_mesh(8, tp=2)


@pytest.mark.parametrize("fsdp", [None, "dp"])
def test_param_specs_equal_jax(fsdp):
    cfg, tcfg = M.PRESETS["tiny"], TM.PRESETS["tiny"]
    assert X.whisper_param_specs(tcfg, fsdp) == _spec_tree(JX.whisper_param_specs(cfg, fsdp))
    assert X.prepared_param_specs(tcfg, fsdp) == _spec_tree(JX.prepared_param_specs(cfg, fsdp))


def test_activation_and_cache_specs_equal_jax(jmesh):
    """batch and seq specs as JAX's; the caches' in the natural (L, B, T, S)
    layout: JAX's head axis (on tp) is the port's S axis."""
    mesh = MeshAt((4, 2), (0, 0))
    assert X.batch_sharding(mesh) == tuple(JX.batch_sharding(jmesh).spec)
    assert X.seq_sharding(mesh) == tuple(JX.seq_sharding(jmesh).spec)
    for port, jax_spec in ((X.kv_sharding, JX.kv_sharding), (X.cross_kv_sharding,
                                                            JX.cross_kv_sharding)):
        L, B, H, T, dh = tuple(jax_spec(jmesh).spec)
        assert port(mesh) == (L, B, T, H) and dh is None
    j3 = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "sp", "tp"))
    assert X.seq_sharding(MeshAt((2, 2, 2), (0, 0, 0), ("dp", "sp", "tp"))) == \
        tuple(JX.seq_sharding(j3).spec)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshAt((4, 2), (0, 0))
    assert X.placements((None, None, "tp"), mesh) == [Replicate(), Shard(2)]
    assert X.placements(("dp", None, "tp"), mesh) == [Shard(0), Shard(2)]
    assert X.placements((), mesh) == [Replicate(), Replicate()]


def _jax_tree(params):
    return jax.tree.map(np.asarray, params)


def test_shard_context_params_equal_jax_shards(jmesh):
    """tiny, seed 0 (device=False), prepared: on every place (dp, tp) of the
    virtual (4, 2) mesh, each leaf's shard equals JAX's addressable shard
    on the device there; the leaves the specs do not name stay whole."""
    cfg = M.PRESETS["tiny"]
    params = M.init_params(cfg, seed=0, dtype=jnp.float32, device=False)
    params = dict(params, decoder=M.prepare_decoder(params["decoder"]))
    jsh = JX.shard_context_params(params, cfg, jmesh)
    tparams = TM.params_from_jax(_jax_tree(params), device="cpu")
    place = {d.id: tuple(int(i) for i in np.argwhere(jmesh.devices == d)[0])
             for d in jmesh.devices.flat}
    flat = jax.tree_util.tree_flatten_with_path(jsh)[0]
    sharded = set()
    for coord in sorted(set(place.values())):
        tsh = X.shard_context_params(tparams, TM.PRESETS["tiny"], MeshAt((4, 2), coord))
        assert tsh["encoder"]["mesh"].coord == coord
        for path, leaf in flat:
            got = tsh
            for k in path:
                got = got[k.key]
            want = next(np.asarray(s.data) for s in leaf.addressable_shards
                        if place[s.device.id] == coord)
            name = "/".join(k.key for k in path)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} at {coord}")
            if want.shape != leaf.shape:
                sharded.add(name)
    assert {"decoder/blocks/qkv_w", "decoder/blocks/qkv_b", "decoder/blocks/o_w",
            "encoder/blocks/mlp0_w", "encoder/blocks/mlp1_w", "decoder/blocks/ck_w"} <= sharded
    assert "decoder/te" not in sharded and "encoder/blocks/o_b" not in sharded


def test_quantized_layers_stay_whole_with_their_bias():
    """A QuantLinear plane is whole on every rank, as in JAX; its layer's
    bias stays whole with it (JAX shards the bias: a logged departure), so
    the layer runs whole; a dense layer beside it is sharded."""
    from open_whisper_kit_tpu_torch.ops.quant_matmul import quantize_linear
    cfg = TM.WhisperConfig(640, 48, 128, 2, 1, 64, 128, 2, 1, 80)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    blocks = params["encoder"]["blocks"]
    blocks["mlp0_w"] = quantize_linear(blocks["mlp0_w"])
    sh = X.shard_context_params(params, cfg, MeshAt((1, 2), (0, 1)))["encoder"]["blocks"]
    assert sh["mlp0_w"] is blocks["mlp0_w"] and sh["mlp0_b"] is blocks["mlp0_b"]
    assert torch.equal(sh["q_w"], blocks["q_w"][..., 64:])
    assert torch.equal(sh["q_b"], blocks["q_b"][..., 64:])


def test_make_mesh_defaults(worlds):
    """World 1 (made on first use): (1, 1). Two ranks: tp 2 by default;
    four: (2, 2), tp 1 gives (4, 1) and make_mesh3 (1, 2, 2). A rank count
    other than the world raises."""
    mesh = X.make_mesh(device="cpu")
    assert tuple(mesh.mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("dp", "tp")
    assert X.axis_size(mesh, "tp") == X.axis_size(mesh, "dp") == 1 and X.tp_of(mesh) is None
    with pytest.raises(ValueError, match="n_devices"):
        X.make_mesh(n_devices=2, device="cpu")
    with pytest.raises(AssertionError):
        X.make_mesh3(device="cpu")
    two, four = worlds["basics2"], worlds["basics4"]
    assert two["default"] == (1, 2) and two["shapes"] == {1: (2, 1), 2: (1, 2)}
    assert four["default"] == (2, 2) and four["shapes"] == {1: (4, 1), 4: (1, 4)}
    assert four["mesh3"] == ((1, 2, 2), ("dp", "sp", "tp"), ("dp", "sp", "tp"))
    assert [r["coord"] for r in four["ranks"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_fetch(worlds, world):
    """all_gather_last joins the tp group's blocks in rank order (16-bit
    floats exactly), all_reduce_sum sums them, the same on every rank;
    fetch_np joins dp shares in rank order; mha_full_tp over whole q/k/v
    (heads on tp, a batch of two on dp) gives mha_full's output; no CPU
    tensor went through the host."""
    out = worlds[f"basics{world}"]
    for r in out["ranks"]:
        dp, tp = r["coord"]
        peers = [dp * 2 + t for t in range(2)]
        blocks = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * p for p in peers]
        np.testing.assert_array_equal(r["gather"], np.concatenate(blocks, axis=-1))
        np.testing.assert_array_equal(r["gather_bf16"], np.concatenate(blocks, axis=-1))
        np.testing.assert_array_equal(r["reduce"], sum(blocks))
        np.testing.assert_array_equal(r["fetch"], np.repeat(np.arange(world), 2).reshape(world, 2))
        assert r["fetch_list"] == list(range(world))
        assert r["mha_tp"] <= 1e-6
    assert out["collectives"]["staged"] == 0


@pytest.mark.parametrize("world", [2, 4])
def test_shards_on_real_ranks_equal_the_placed_ones(worlds, world):
    """Each rank's shard_context_params shards on the real DeviceMesh equal
    the ones computed for its place, and gather_context_params gives every
    rank the whole tensor back; on a quantized decoder (whose layers stay
    whole, biases too) it gives back every leaf as it was."""
    cfg = TM.WhisperConfig(51864, 1500, 128, 2, 2, 448, 128, 2, 3, 80)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    params["decoder"] = TM.prepare_decoder(params["decoder"])
    whole = params["decoder"]["blocks"]["qkv_w"].numpy()
    shape = worlds[f"basics{world}"]["default"]
    for r in worlds[f"basics{world}"]["ranks"]:
        sh = X.shard_context_params(params, cfg, MeshAt(shape, r["coord"]))
        for k, v in r["shards"].items():
            np.testing.assert_array_equal(v, sh["decoder"]["blocks"][k].numpy(), err_msg=k)
        np.testing.assert_array_equal(r["whole"], whole)
        assert r["quant_roundtrip"]


def test_collectives_refuse_a_backend_that_cannot_take_the_device(monkeypatch):
    """An NCCL group takes no CPU tensor; no backend takes a meta tensor."""
    monkeypatch.setattr(X.dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="nccl"):
        X._through_host(torch.zeros(1), None)
    monkeypatch.setattr(X.dist, "get_backend", lambda group=None: "gloo")
    assert X._through_host(torch.zeros(1), None) is False
    with pytest.raises(ValueError, match="meta"):
        X._through_host(torch.zeros(1, device="meta"), None)
