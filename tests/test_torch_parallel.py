"""The port's mesh parallelism (``deepflows_tpu_torch.parallel``) on 4
gloo ranks against the JAX package's on 4 of its 8 virtual CPU devices, at
the same mesh shape, from the same weights (``load_jax_state_dict``) and
batches.

The port's ranks are processes that import no JAX
(``tests/torch_parallel_ranks.py``); one group of 4 runs every case of
this file in the background while this process runs the JAX side.  Each
case also holds the port's sharded run against its own unsharded
``CompiledTrainStep`` (rank 0), and checks the blocks each rank stores.

Cases (the JAX tests' in ``tests/test_parallel.py`` and the EP tests):
DP on the Conv/BN/Linear model with SGD momentum; TP with Adam and the
block shapes; ``ShardedEvalStep``; a bf16 step; ``accum_steps=2`` over
{data: 2, model: 2}; ZeRO-1 (slots on ``data``); FSDP (1/4 blocks, small
parameters whole), FSDP + TP, FSDP with Muon, with Adafactor and with
clipping by global norm; stochastically rounded Adam on bf16 weights
FSDP-sharded over a model axis, bit for bit the unsharded run; a remat
ResNet-18 under DP; sequence constraints against none; EP on ``nn.MoE``
and on ``MixtralLM`` with ``MoECriterion`` (its balancing loss over the
global batch), a Switch MoE whose capacity drops tokens; a constraint
refusing a DTensor; ``F.batch_norm``'s global statistics on a
batch-sharded input; the step's ``metrics_fn``; live dropout drawing the
unsharded step's masks; a cross-entropy mean over the positions
``ignore_index`` keeps (SFT prompt masking) over the global batch; a
DTensor at each training kernel's entry raising.

Tolerances are the JAX tests': DP losses rtol 1e-4 / atol 1e-5 and
weights rtol 1e-3 / atol 1e-5; sharded against replicated layouts rtol
1e-5 / atol 1e-6 (Muon's weights 2e-5 / 2e-6); MoE EP against JAX rtol
2e-3 / atol 1e-5; bf16 rtol 2e-2.
"""

import numpy as np
import pytest

import deepflows_tpu as df
from deepflows_tpu import Graph, models, nn, optim

import torch_parallel_ranks as ranks

jax = pytest.importorskip("jax")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found
    it: later test files in the same process build their models from it."""
    from deepflows_tpu import config
    from deepflows_tpu import random as jrandom
    from deepflows_tpu.backend import jax_kernels, numpy_kernels

    seed, host_key, np_rng = config.seed, jax_kernels._host_key, numpy_kernels._rng
    np_state = np_rng.bit_generator.state
    eager = (jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter)
    yield
    config.seed, jax_kernels._host_key, numpy_kernels._rng = seed, host_key, np_rng
    np_rng.bit_generator.state = np_state
    jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter = eager


@pytest.fixture(autouse=True)
def _clean():
    df.set_grad_enabled(True)
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)


# ------------------------------------------------------------- JAX models
def jax_model(kind, seed=0):
    df.manual_seed(seed)
    if kind == "cnn":
        return nn.Sequential(
            nn.Conv2d(3, 8, 3, padding=1, bias=False, device="cpu"),
            nn.BatchNorm2d(8, device="cpu"), nn.ReLU(), nn.MaxPool2d(2), nn.Flatten(),
            nn.Linear(8 * 8 * 8, 32, device="cpu"), nn.ReLU(), nn.Linear(32, 4, device="cpu"))
    if kind == "mlp":
        return nn.Sequential(nn.Flatten(), nn.Linear(48, 32, device="cpu"), nn.ReLU(),
                             nn.Linear(32, 4, device="cpu"))
    if kind == "dropout":
        return nn.Sequential(nn.Flatten(), nn.Linear(48, 32, device="cpu"), nn.ReLU(),
                             nn.Dropout(0.5), nn.Linear(32, 4, device="cpu"))
    if kind == "lm":
        return models.TransformerLM(vocab_size=16, max_len=32, dim=32, depth=2, num_heads=2,
                                    device="cpu", flash=False)
    if kind == "moe":
        return nn.Sequential(nn.MoE(8, 16, n_experts=4, device="cpu"),
                             nn.LayerNorm(8, device="cpu"), nn.Flatten(),
                             nn.Linear(5 * 8, 3, device="cpu"))
    if kind == "switch":
        return nn.Sequential(nn.MoE(8, 32, n_experts=4, capacity_factor=1.0, device="cpu"),
                             nn.Flatten(), nn.Linear(4 * 8, 4, device="cpu"))
    if kind == "mixtral":
        return models.MixtralLM(vocab_size=24, max_len=8, dim=32, depth=1, num_heads=4,
                                num_kv_heads=2, n_experts=4, top_k=2, device="cpu",
                                flash=False)
    if kind == "resnet":
        return models.ResNet18(num_classes=4, small_input=True, device="cpu", remat=True)
    raise ValueError(kind)


def jax_encoder(with_sp, mesh=None):
    from deepflows_tpu.parallel import sequence_sharding

    df.manual_seed(0)
    blocks = [models.EncoderBlock(32, 2, device="cpu") for _ in range(2)]
    sp = sequence_sharding(mesh or jax_mesh({"data": 2, "model": 2}), axis="model", dim=1)
    mods = []
    for b in blocks:
        if with_sp:
            mods.append(sp)
        mods.append(b)
    if with_sp:
        mods.append(sp)
    return nn.Sequential(*mods)


def state_of(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


def batch(i=0, n=16):
    r = np.random.default_rng(i)
    return (r.standard_normal((n, 3, 16, 16)).astype(np.float32),
            r.integers(0, 4, n).astype(np.int32))


JAX_OPTS = {
    "sgd": lambda m: optim.SGD(m.parameters(), lr=0.05, momentum=0.9),
    "adam": lambda m: optim.Adam(m.parameters(), lr=1e-3),
    "adam01": lambda m: optim.Adam(m.parameters(), lr=0.01),
    "adam5e3": lambda m: optim.Adam(m.parameters(), lr=5e-3),
    "muon": lambda m: optim.Muon(m.parameters(), lr=0.02, adamw_lr=1e-3),
    "adafactor": lambda m: optim.Adafactor(m.parameters(), lr=1e-2),
}


def jax_mesh(axes):
    from deepflows_tpu.parallel import make_mesh

    return make_mesh(axes, jax.devices()[:4])


def jax_rules(name, mesh):
    from deepflows_tpu.parallel import (expert_parallel_rules, fsdp_rules,
                                        tensor_parallel_rules)

    return {None: None, "tp": tensor_parallel_rules("model"), "fsdp": fsdp_rules(mesh),
            "fsdp_tp": fsdp_rules(mesh, base=tensor_parallel_rules("model")),
            "ep": expert_parallel_rules("model")}[name]


def jax_train(inp, axes, rules=None, **kw):
    """The JAX package's sharded run of a case: (losses, {name: weights})."""
    import jax.numpy as jnp

    from deepflows_tpu.parallel import ShardedTrainStep

    m = jax_model(inp["model"], inp.get("seed", 0))
    opt = JAX_OPTS[inp["opt"]](m)
    crit = {"moe_ce": lambda: nn.MoECriterion(nn.CrossEntropyLoss(), m),
            "ce_ignore": lambda: nn.CrossEntropyLoss(ignore_index=-100)}.get(
                inp.get("crit"), nn.CrossEntropyLoss)()
    if inp.get("clip"):
        kw["grad_transform"] = optim.clip_by_global_norm(inp["clip"])
    if inp.get("bf16"):
        kw["compute_dtype"] = jnp.bfloat16
    if inp.get("accum"):
        kw["accum_steps"] = inp["accum"]
    if inp.get("metrics"):
        kw["metrics_fn"] = lambda out, yt: {
            "acc": (out.data.array.argmax(1) == yt.data.array).mean()}
    mesh = jax_mesh(axes)
    step = ShardedTrainStep(m, opt, crit, mesh, param_rules=jax_rules(rules, mesh), **kw)
    losses = [float(step(x, y)) for x, y in inp["batches"]]
    jax_train.last_metrics = step._last_metrics
    return losses, {n: np.asarray(p.data.array, np.float32) for n, p in m.named_parameters()}


# ------------------------------------------------------------- the cases
def _inputs():
    cnn = state_of(jax_model("cnn"))
    r = np.random.default_rng(0)
    xa = r.standard_normal((32, 3, 4, 4)).astype(np.float32)
    ya = r.integers(0, 4, 32).astype(np.int32)
    moe_batches = []
    r = np.random.default_rng(0)
    for _ in range(3):
        moe_batches.append((r.standard_normal((8, 5, 8)).astype(np.float32),
                            r.integers(0, 3, 8).astype(np.int32)))
    seq = np.random.default_rng(0).integers(0, 24, (8, 9)).astype(np.int32)
    rb = np.random.default_rng(5)
    rd = np.random.default_rng(8)
    drop_batches = [(rd.standard_normal((16, 3, 4, 4)).astype(np.float32),
                     rd.integers(0, 4, 16).astype(np.int32)) for _ in range(3)]
    return {
        "dp": dict(model="cnn", state=cnn, opt="sgd", metrics=True,
                   batches=[batch(i) for i in range(3)]),
        "tp": dict(model="cnn", state=cnn, opt="adam01", batches=[batch(i, 8) for i in range(2)]),
        "eval_step": dict(state=cnn, x=batch(0)[0]),
        "bf16": dict(model="cnn", state=cnn, opt="adam", bf16=True, batches=[batch(0)] * 2),
        "accum": dict(model="mlp", state=state_of(jax_model("mlp")), opt="sgd", accum=2,
                      batches=[(xa, ya)] * 2),
        "zero": dict(model="cnn", state=cnn, opt="adam", batches=[batch(i) for i in range(3)]),
        "fsdp": dict(model="cnn", state=cnn, opt="adam", batches=[batch(i) for i in range(3)]),
        "fsdp_tp": dict(model="cnn", state=cnn, opt="adam",
                        batches=[batch(i) for i in range(3)]),
        "fsdp_muon": dict(model="cnn", state=cnn, opt="muon",
                          batches=[batch(i) for i in range(3)]),
        "fsdp_clip": dict(model="cnn", state=cnn, opt="adam", clip=0.5,
                          batches=[batch(i) for i in range(3)]),
        "fsdp_adafactor": dict(model="cnn", state=cnn, opt="adafactor",
                               batches=[batch(i) for i in range(3)]),
        "fsdp_sr": dict(model="cnn", state=cnn, opt="adam_sr", bf16_params=True,
                        batches=[batch(i) for i in range(3)]),
        "remat_resnet": dict(state=state_of(jax_model("resnet")), batches=[
            (r.standard_normal((16, 3, 16, 16)).astype(np.float32),
             r.integers(0, 4, 16).astype(np.int32))
            for r in [np.random.default_rng(0)] for _ in range(2)]),
        "ep_moe": dict(model="moe", state=state_of(jax_model("moe")), opt="adam",
                       batches=moe_batches),
        "ep_mixtral": dict(model="mixtral", seed=2, state=state_of(jax_model("mixtral", 2)),
                           opt="adam5e3", crit="moe_ce",
                           batches=[(seq[:, :8], seq[:, 1:])] * 5),
        "ep_switch": dict(model="switch", state=state_of(jax_model("switch")), opt="adam01",
                          crit="moe_ce", batches=[
                              (r.standard_normal((16, 4, 8)).astype(np.float32),
                               r.integers(0, 4, 16).astype(np.int32))
                              for r in [np.random.default_rng(3)] for _ in range(3)]),
        "seq_dtensor": dict(x=np.random.default_rng(4).standard_normal((4, 8, 16))
                            .astype(np.float32)),
        "bn_functional": dict(x=rb.standard_normal((8, 3, 4, 4)).astype(np.float32),
                              w=rb.standard_normal((1, 3, 1, 1)).astype(np.float32),
                              b=rb.standard_normal((1, 3, 1, 1)).astype(np.float32),
                              g=rb.standard_normal((8, 3, 4, 4)).astype(np.float32)),
        "dropout": dict(model="dropout", state=state_of(jax_model("dropout")), opt="sgd",
                        mask_seed=7, batches=drop_batches),
        "sft": dict(model="lm", seed=21, state=state_of(jax_model("lm", 21)), opt="sgd",
                    crit="ce_ignore", batches=sft_batches()),
        "dtensor_kernels": {},
        "mesh": {},
        "seq": dict(state=state_of(jax_encoder(False)), state_sp=state_of(jax_encoder(True)),
                    batches=[(r.standard_normal((8, 8, 32)).astype(np.float32),
                              r.standard_normal((8, 8, 32)).astype(np.float32))
                             for r in [np.random.default_rng(0)] for _ in range(3)]),
    }


# the prompt length of each row (its targets ignored), then the padding:
# the ranks of {data: 4} keep 5, 27, 16 and 9 positions of 32
SFT_PROMPTS = (14, 13, 2, 3, 4, 7, 9, 10)
SFT_PADDING = (0, 0, 0, 0, 3, 2, 2, 2)


def sft_batches(steps=3, L=16):
    r = np.random.default_rng(9)
    out = []
    for _ in range(steps):
        x = r.integers(0, 16, (8, L)).astype(np.int64)
        y = r.integers(0, 16, (8, L)).astype(np.int64)
        for i, (p, pad) in enumerate(zip(SFT_PROMPTS, SFT_PADDING)):
            y[i, :p] = -100
            y[i, L - pad:] = -100
        out.append((x, y))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _inputs()
    w = ranks.World(list(inputs), inputs, tmp_path_factory.mktemp("parallel"))
    yield w, inputs
    w.results()  # every rank has ended


def close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def close_params(got, want, rtol, atol):
    assert list(got) == list(want)
    for n in got:
        close(got[n], want[n], rtol, atol, n)


def test_rules_match_jax():
    """The rules give the JAX package's specs for every parameter of the
    zoo models the JAX tests shard (pure functions: no ranks)."""
    from deepflows_tpu.parallel import expert_parallel_rules as jep
    from deepflows_tpu.parallel import fsdp_rules as jfsdp
    from deepflows_tpu.parallel import tensor_parallel_rules as jtp

    from deepflows_tpu_torch import models as tmodels
    from deepflows_tpu_torch.parallel import (expert_parallel_rules, fsdp_rules,
                                              tensor_parallel_rules)

    class _Mesh:  # fsdp_rules reads the axis's size alone
        mesh_dim_names = ("data",)

        def size(self, k):
            return 4

    port_models = {
        "cnn": ranks.make_model(),
        "resnet": tmodels.ResNet18(num_classes=4, small_input=True, device="cpu"),
        "moe": ranks.build("moe"),
        "mixtral": ranks.build("mixtral"),
        "lm": ranks.build("lm"),
        "mobilenet": tmodels.MobileNetV2(num_classes=4, device="cpu"),
    }
    jmesh = jax_mesh({"data": 4})
    pairs = [(tensor_parallel_rules("model"), jtp("model")),
             (expert_parallel_rules("model"), jep("model")),
             (fsdp_rules(_Mesh()), jfsdp(jmesh)),
             (fsdp_rules(_Mesh(), base=tensor_parallel_rules()), jfsdp(jmesh, base=jtp()))]
    checked = 0
    for name, m in port_models.items():
        for pname, p in m.named_parameters():
            for mine, theirs in pairs:
                shape = tuple(p.shape)
                assert tuple(mine(pname, shape)) == tuple(theirs(pname, shape)), (name, pname)
                checked += 1
    assert checked > 400


def test_make_mesh_shapes(world):
    w, _ = world
    for r in w.case("mesh"):
        assert r["names"] == ("data", "model") and r["shape"] == (2, 2)
        assert r["auto"] == (2, 2)
        assert "needs 8 devices, have 4" in r["mismatch"]
        assert r["jax_modules"] == []  # the ranks run the port alone


def test_data_parallel_matches_single_device(world):
    w, inputs = world
    got = w.case("dp")
    r0 = got[0]
    close(r0["losses"], r0["ref_losses"], 1e-4, 1e-5)
    close_params(r0["params"], r0["ref_params"], 1e-3, 1e-5)
    losses, params = jax_train(inputs["dp"], {"data": 4})
    close(r0["losses"], losses, 1e-4, 1e-5)
    close_params(r0["params"], params, 1e-3, 1e-5)
    # the step's metrics (accuracy of the last step) are the global batch's
    close(r0["metrics"]["acc"], r0["ref_metrics"]["acc"], 0, 1e-7)
    close(r0["metrics"]["acc"], float(jax_train.last_metrics["acc"]), 0, 1e-7)
    # every rank holds the same global loss, metrics, weights and BN statistics
    for r in got[1:]:
        assert r["losses"] == r0["losses"] and r["metrics"] == r0["metrics"]
    assert r0["bn_spread"] == 0.0
    assert all(s == ("R",) for s in r0["specs"].values())


def test_tensor_parallel_matches_and_shards(world):
    w, inputs = world
    got = w.case("tp")
    r0 = got[0]
    close(r0["losses"], r0["ref_losses"], 1e-4, 1e-5)
    losses, params = jax_train(inputs["tp"], {"data": 2, "model": 2}, "tp")
    close(r0["losses"], losses, 1e-4, 1e-5)
    close_params(r0["params"], params, 1e-3, 1e-5)
    assert r0["specs"]["5.weight"] == ("R", "S(1)")
    assert r0["specs"]["0.weight"] == ("R", "S(0)")
    assert r0["specs"]["1.weight"] == ("R", "R")  # BN affine
    for r in got:
        assert r["local_shapes"] == {"5.weight": (512, 16), "0.weight": (4, 3, 3, 3)}
    assert r0["bn_spread"] == 0.0


def test_sharded_eval_step(world):
    w, inputs = world
    from deepflows_tpu.parallel import ShardedEvalStep

    got = w.case("eval_step")
    for r in got:
        assert r["out"].shape == (16, 4)
        close(r["out"], r["ref"], 1e-4, 1e-5)
        close(r["tp_out"], r["ref"], 1e-4, 1e-5)  # with tensor_parallel_rules
        assert r["tp_specs"]["5.weight"] == ("R", "S(1)") and r["training"]
    m = jax_model("cnn")
    want = np.asarray(ShardedEvalStep(m, jax_mesh({"data": 4}))(inputs["eval_step"]["x"]))
    close(got[0]["out"], want, 1e-4, 1e-5)


def test_sharded_bf16_step(world):
    w, inputs = world
    r0 = w.case("bf16")[0]
    l1, l2 = r0["losses"]
    assert np.isfinite(l1) and np.isfinite(l2) and l2 < l1
    assert r0["dtype"] == "torch.float32"
    close(r0["losses"], r0["ref_losses"], 2e-2, 2e-2)
    losses, _ = jax_train(inputs["bf16"], {"data": 4})
    close(r0["losses"], losses, 2e-2, 2e-2)


def test_sharded_gradient_accumulation(world):
    w, inputs = world
    r0 = w.case("accum")[0]
    close(r0["losses"], r0["ref_losses"], 1e-5, 1e-6)
    losses, _ = jax_train(inputs["accum"], {"data": 2, "model": 2}, "tp")
    close(r0["losses"], losses, 1e-5, 1e-6)


def test_zero_shard_state_matches_and_shards(world):
    w, inputs = world
    got = w.case("zero")
    r0 = got[0]
    close(r0["losses"], r0["replicated_losses"], 1e-6, 1e-6)
    close_params(r0["params"], r0["replicated_params"], 1e-6, 1e-7)
    close(r0["losses"], r0["ref_losses"], 1e-4, 1e-5)
    losses, _ = jax_train(inputs["zero"], {"data": 4}, zero_shard_state=True)
    close(r0["losses"], losses, 1e-4, 1e-5)
    # the conv kernel's moment (dim 0 = 8) lies in quarters on the data axis
    assert r0["v_specs"][0] == ("S(0)",)
    for r in got:
        local, total = r["v_sizes"][0]
        assert local * 4 == total


def test_fsdp_matches_replicated_and_shards(world):
    w, inputs = world
    got = w.case("fsdp")
    r0 = got[0]
    close(r0["losses"], r0["replicated_losses"], 1e-5, 1e-6)
    close_params(r0["params"], r0["replicated_params"], 1e-5, 1e-6)
    close(r0["losses"], r0["ref_losses"], 1e-4, 1e-5)
    losses, _ = jax_train(inputs["fsdp"], {"data": 4}, "fsdp")
    close(r0["losses"], losses, 1e-4, 1e-5)
    for r in got:
        big = [(loc, tot) for loc, tot in r["sizes"].values() if tot >= 2048]
        assert big and all(loc * 4 == tot for loc, tot in big)
        assert all(loc * 4 == tot for loc, tot in (s for s in r["v_sizes"] if s)
                   if tot >= 2048)
        loc, tot = r["sizes"]["1.weight"]  # BN affine: below min_elems, whole
        assert loc == tot


def test_fsdp_composes_with_tensor_parallel(world):
    w, inputs = world
    r0 = w.case("fsdp_tp")[0]
    close(r0["losses"], r0["tp_losses"], 1e-5, 1e-6)
    close(r0["losses"], r0["ref_losses"], 1e-4, 1e-5)
    assert r0["specs"]["5.weight"] == ("R", "S(1)")
    losses, _ = jax_train(inputs["fsdp_tp"], {"data": 2, "model": 2}, "fsdp_tp")
    close(r0["losses"], losses, 1e-4, 1e-5)


@pytest.mark.parametrize("name, slot", [("fsdp_muon", "m_sizes"), ("fsdp_adafactor", None),
                                        ("fsdp_clip", None)])
def test_fsdp_with_whole_value_updates(world, name, slot):
    """Muon's Newton-Schulz and Adafactor's factored statistics run on the
    whole matrices, and a clipped step's norm is the global one: the FSDP
    run tracks the unsharded run and the JAX package's.  (The JAX
    package's FSDP step refuses Adafactor here: it places the (1, 32)
    column factor like its (512, 32) weight, on dim 0 over 4 devices.  The
    port replicates a factor; its run is held to the unsharded one.)"""
    w, inputs = world
    got = w.case(name)
    r0 = got[0]
    close(r0["losses"], r0["ref_losses"], 1e-5, 1e-6)
    close_params(r0["params"], r0["ref_params"], 2e-5, 2e-6)
    if name != "fsdp_adafactor":
        losses, params = jax_train(inputs[name], {"data": 4}, "fsdp")
        close(r0["losses"], losses, 1e-4, 1e-5)
        close_params(r0["params"], params, 1e-3, 1e-5)
    if slot:
        for r in got:
            assert all(loc * 4 == tot for loc, tot in (s for s in r[slot] if s) if tot >= 2048)


def test_fsdp_stochastic_rounding_is_the_unsharded_rounding(world):
    """bf16 weights, Adam(stochastic_round=True), FSDP over a model axis
    (the batch whole on every rank): the update runs on whole values, so
    each element draws its bits at its global offset and the weights equal
    the unsharded run's bit for bit."""
    w, _ = world
    r0 = w.case("fsdp_sr")[0]
    assert r0["dtype"] == "torch.bfloat16"
    assert r0["losses"] == r0["ref_losses"]
    for n in r0["params"]:
        np.testing.assert_array_equal(r0["params"][n], r0["ref_params"][n], err_msg=n)


def test_remat_resnet_under_data_parallel(world):
    w, inputs = world
    import deepflows_tpu.parallel as jp

    r0 = w.case("remat_resnet")[0]
    close(r0["losses"], r0["ref_losses"], 1e-4, 1e-5)
    m = jax_model("resnet")
    opt = optim.SGD(m.parameters(), lr=0.05, momentum=0.9)
    step = jp.ShardedTrainStep(m, opt, nn.CrossEntropyLoss(), jax_mesh({"data": 4}))
    losses = [float(step(x, y)) for x, y in inputs["remat_resnet"]["batches"]]
    close(r0["losses"], losses, 1e-4, 1e-5)


def test_sequence_constraints_match_unconstrained(world):
    """Constraints between two EncoderBlocks change no number: the
    constrained model trains as the plain one, in the port and against the
    JAX package's constrained step."""
    from deepflows_tpu.parallel import ShardedTrainStep

    w, inputs = world
    r0 = w.case("seq")[0]
    close(r0["sp"], r0["plain"], 1e-5, 1e-6)
    mesh = jax_mesh({"data": 2, "model": 2})
    m = jax_encoder(True, mesh)
    step = ShardedTrainStep(m, optim.Adam(m.parameters(), lr=1e-3), nn.MSELoss(), mesh)
    losses = [float(step(x, y)) for x, y in inputs["seq"]["batches"]]
    close(r0["sp"], losses, 1e-4, 1e-5)


def test_expert_parallel_moe(world):
    w, inputs = world
    r0 = w.case("ep_moe")[0]
    close(r0["losses"], r0["replicated_losses"], 1e-5, 1e-6)
    close_params(r0["params"], r0["ref_params"], 1e-5, 1e-6)
    assert r0["specs"]["0.experts_w1"] == ("R", "S(0)")
    losses, _ = jax_train(inputs["ep_moe"], {"data": 2, "model": 2}, "ep")
    close(r0["losses"], losses, 2e-3, 1e-5)


def test_expert_parallel_switch_capacity_counts_the_global_batch(world):
    """Switch MoE (capacity 1.0: tokens are dropped) under EP on {data: 2,
    model: 2}: the capacity and the slot order count the global batch's
    tokens, so the sharded run is the unsharded one and the JAX
    package's."""
    w, inputs = world
    got = w.case("ep_switch")
    r0 = got[0]
    assert r0["dropped"] > 0
    close(r0["losses"], r0["ref_losses"], 1e-5, 1e-6)
    close_params(r0["params"], r0["ref_params"], 1e-5, 1e-6)
    losses, _ = jax_train(inputs["ep_switch"], {"data": 2, "model": 2}, "ep")
    close(r0["losses"], losses, 2e-3, 1e-5)
    assert all(r["dropped"] == r0["dropped"] for r in got)


def test_shard_constraint_on_dtensors(world):
    """No step of the port runs DTensor activations: a constraint is the
    identity on the plain tensors ShardedTrainStep runs, says so, and
    refuses a DTensor."""
    w, _ = world
    for r in w.case("seq_dtensor"):
        assert r["refused"] and "identity" in r["refused"]
        assert r["plain_is_identity"]
        assert "identity under ShardedTrainStep" in r["repr"]


def test_live_dropout_draws_the_unsharded_masks(world):
    """Dropout 0.5 under DP over {data: 4} and over {data: 2, model: 2}:
    each rank keeps its rows of the global batch's mask, so the sharded
    runs are the unsharded run (the masks' generator reseeded before
    each), and every rank holds the same loss."""
    w, _ = world
    got = w.case("dropout")
    r0 = got[0]
    close(r0["losses"], r0["ref_losses"], 1e-5, 1e-6)
    close_params(r0["params"], r0["ref_params"], 1e-5, 1e-6)
    close(r0["tp_losses"], r0["ref_losses"], 1e-5, 1e-6)
    close_params(r0["tp_params"], r0["ref_params"], 1e-5, 1e-6)
    # dropout was live: without it the same steps give other losses
    assert max(abs(a - b) for a, b in zip(r0["losses"], r0["no_dropout_losses"])) > 1e-2
    for r in got[1:]:
        assert r["losses"] == r0["losses"] and r["tp_losses"] == r0["tp_losses"]


def test_ignore_index_mean_spans_the_global_batch(world):
    """CrossEntropyLoss(ignore_index=-100) on SFT-style targets (prompts
    and padding ignored, 5 to 27 positions of 32 kept a rank) over {data: 4}:
    the mean divides by the global batch's count of kept positions, as
    the JAX package's one program does and the unsharded step does."""
    w, inputs = world
    per_rank = (inputs["sft"]["batches"][0][1] != -100).reshape(4, -1).sum(1)
    assert per_rank.tolist() == [5, 27, 16, 9]
    got = w.case("sft")
    r0 = got[0]
    close(r0["losses"], r0["ref_losses"], 1e-5, 1e-6)
    close_params(r0["params"], r0["ref_params"], 1e-4, 1e-6)
    losses, params = jax_train(inputs["sft"], {"data": 4})
    close(r0["losses"], losses, 1e-4, 1e-5)
    close_params(r0["params"], params, 1e-3, 1e-5)
    for r in got[1:]:
        assert r["losses"] == r0["losses"]


def test_expert_parallel_mixtral_with_moe_criterion(world):
    """EP on {data: 2, model: 2}: the balancing loss's expert fractions and
    router means span the global batch, as in the JAX package's one
    program."""
    w, inputs = world
    got = w.case("ep_mixtral")
    r0 = got[0]
    close(r0["losses"], r0["ref_losses"], 2e-3, 1e-5)
    losses, _ = jax_train(inputs["ep_mixtral"], {"data": 2, "model": 2}, "ep")
    close(r0["losses"], losses, 2e-3, 1e-5)
    for r in got[1:]:
        np.testing.assert_array_equal(r["fraction"], r0["fraction"])
    specs = {n: s for n, s in r0["specs"].items() if ".experts_" in n}
    assert len(specs) == 3 and all(s == ("R", "S(0)")
                                   for s in specs.values())


def test_batch_norm_global_statistics(world):
    w, _ = world
    for r in w.case("bn_functional"):
        for key in ("out", "mean", "var", "dx"):
            close(r[key], r["ref_" + key], 1e-5, 1e-6, key)


def test_dtensor_at_a_kernel_entry_raises(world):
    w, _ = world
    got = w.case("dtensor_kernels")
    assert len(got) == 4
    for r in got:
        assert r["world"] == 4
        for name, msg in r["raised"].items():
            assert msg and "DTensor" in msg, name
