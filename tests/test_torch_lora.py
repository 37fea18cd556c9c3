"""The port's LoRA (``nn.LoRALinear``, ``apply_lora``, ``merge_lora``,
``unmerge_lora``, ``lora_state_dict``, ``load_lora_state_dict``) against the
JAX package on the CPU, mirroring ``tests/test_lora.py``.

The same small models are built in both packages (an MLP, LlamaLM and
TransformerLM at depth 1-2 and widths up to 32), LoRA is applied in both,
and the JAX weights, adapters included, cross with ``load_jax_state_dict``
under the JAX package's keys (``q_proj.base.weight``, ``q_proj.lora_A``,
``q_proj.lora_B``).  Every port decoder refuses an unmerged LoRA model.
Tolerances: f32 rtol and atol 1e-4 (tests/test_torch_decoding.py);
merge against the adapted forward rtol 1e-5 / atol 1e-6 (the JAX test's).
"""

import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu import Graph
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.jit import CompiledEvalStep as JaxEvalStep
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu.models.decoding import KVCacheDecoder as JaxDecoder
from deepflows_tpu_torch import models, nn, ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(11)
LLAMA = dict(vocab_size=48, max_len=16, dim=32, depth=2, num_heads=4, num_kv_heads=2)
TARGET = ["q_proj", "v_proj", "out_proj"]  # examples/lora_finetune.py's


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
    ops.reset_launch_counts()
    df.set_grad_enabled(True)  # an earlier file's JAX Module.eval() may have left it off
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


def _nonzero_b(jm, scale):
    """JAX adapters' B set away from zero, so that the adapters act."""
    from deepflows_tpu.backend import BackendTensor

    for mod in jm.modules():
        if isinstance(mod, jnn.LoRALinear):
            mod.lora_B.data = BackendTensor(
                (RNG.standard_normal(mod.lora_B.shape) * scale).astype(np.float32),
                device=mod.lora_B.device)


def _pair(kind, seed, lora=None, b_scale=0.0):
    """The same model in both packages, LoRA applied to both with
    ``lora``'s arguments and the JAX weights and adapters copied."""
    df.manual_seed(seed)
    if kind == "mlp":
        jm = jnn.Sequential(jnn.Linear(8, 16, device="tpu"), jnn.ReLU(),
                            jnn.Linear(16, 4, device="tpu"))
        tm = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                           nn.Linear(16, 4, device="cpu"))
    elif kind == "llama":
        jm = jmodels.LlamaLM(**LLAMA, device="cpu", flash=False)
        tm = models.LlamaLM(**LLAMA, device="cpu")
    else:
        cfg = dict(vocab_size=32, max_len=8, dim=32, depth=2, num_heads=2)
        jm = jmodels.TransformerLM(**cfg, device="cpu")
        tm = models.TransformerLM(**cfg, device="cpu")
    if lora is not None:
        jnn.apply_lora(jm, **lora)
        nn.apply_lora(tm, **lora)
        if b_scale:
            _nonzero_b(jm, b_scale)
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    Graph.free_graph_all()
    return jm, tm


def _jfwd(jm, x):
    return np.asarray(JaxEvalStep(jm)(x))  # one program: cheaper than eager ops


def _tfwd(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy()


def test_lora_is_identity_at_init_and_keys_match_jax():
    x = RNG.standard_normal((5, 8)).astype(np.float32)
    jm, tm = _pair("mlp", 0)
    want = _tfwd(tm, x)
    adapters = nn.apply_lora(tm, r=4)
    np.testing.assert_array_equal(_tfwd(tm, x), want)  # B is zero
    jnn.apply_lora(jm, r=4)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert "0.base.weight" in tm.state_dict() and "0.lora_A" in tm.state_dict()
    assert [tuple(p.shape) for p in adapters] == [(8, 4), (4, 16), (16, 4), (4, 4)]
    mod = tm[0]
    assert isinstance(mod, nn.LoRALinear) and mod.scaling == 16.0 / 4
    assert mod.weight is mod.base.weight and mod.bias is mod.base.bias
    assert not mod.base.weight.requires_grad and mod.lora_A.requires_grad
    assert not torch.equal(mod.lora_A, torch.zeros_like(mod.lora_A))  # kaiming init


def test_eager_lora_trains_only_the_adapters():
    """As the JAX suite's: 40 eager Adam steps (forward, backward, step) of
    the adapters alone fit a regression, the base bit for bit unchanged."""
    dt.manual_seed(0)
    m = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(), nn.Linear(16, 4, device="cpu"))
    adapters = nn.apply_lora(m, r=4)
    base = {n: p.clone() for n, p in m.named_parameters() if "base" in n}
    x = torch.from_numpy(RNG.standard_normal((32, 8)).astype(np.float32))
    y = torch.from_numpy(RNG.standard_normal((32, 4)).astype(np.float32))
    opt = optim.Adam(adapters, lr=1e-2)
    losses = []
    for _ in range(40):
        loss = ((m(x) - y) ** 2).mean()
        losses.append(float(loss))
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert losses[-1] < 0.6 * losses[0]
    for n, p in m.named_parameters():
        if n in base:
            assert torch.equal(p, base[n]) and p.grad is None, n


@pytest.mark.parametrize("kind", ["mlp", "llama"])
def test_lora_forward_merge_unmerge_match_jax(kind):
    lora = dict(r=4, alpha=8.0, target=None if kind == "mlp" else TARGET)
    jm, tm = _pair(kind, 3, lora, b_scale=0.3)
    x = (RNG.standard_normal((6, 8)).astype(np.float32) if kind == "mlp"
         else RNG.integers(0, 48, (2, 16)).astype(np.int64))
    adapted = _tfwd(tm, x)
    np.testing.assert_allclose(adapted, _jfwd(jm, x), rtol=1e-4, atol=1e-4)
    base = {n: p.clone() for n, p in tm.named_parameters() if "base" in n}
    nn.merge_lora(tm)
    jnn.merge_lora(jm)
    merged = _tfwd(tm, x)
    np.testing.assert_allclose(merged, adapted, rtol=1e-5, atol=1e-6)
    tsd = tm.state_dict()
    for k, v in jm.state_dict().items():  # the merged weights
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    nn.merge_lora(tm)  # a second merge is a no-op
    np.testing.assert_allclose(_tfwd(tm, x), merged, rtol=0, atol=0)
    nn.unmerge_lora(tm)
    np.testing.assert_allclose(_tfwd(tm, x), adapted, rtol=1e-5, atol=1e-5)
    for n, p in tm.named_parameters():
        if "base" in n:
            np.testing.assert_allclose(p.detach().numpy(), base[n].numpy(), rtol=0,
                                       atol=1e-6, err_msg=n)


def test_adapter_checkpoint_round_trip_and_from_jax():
    x = RNG.integers(0, 48, (2, 12)).astype(np.int64)
    jm, tm = _pair("llama", 4, dict(r=2, target=TARGET), b_scale=0.2)
    sd = nn.lora_state_dict(tm)
    assert len(sd) == 2 * 3 * 2 and all(isinstance(v, torch.Tensor) for v in sd.values())
    _, fresh = _pair("llama", 4, dict(r=2, target=TARGET))  # the same base, B zero
    nn.load_lora_state_dict(fresh, sd)
    np.testing.assert_array_equal(_tfwd(fresh, x), _tfwd(tm, x))  # bit for bit
    _, fresh2 = _pair("llama", 4, dict(r=2, target=TARGET))
    nn.load_lora_state_dict(fresh2, jnn.lora_state_dict(jm))  # the JAX checkpoint
    np.testing.assert_array_equal(_tfwd(fresh2, x), _tfwd(tm, x))
    key = next(iter(sd))
    with pytest.raises(KeyError, match="unmatched"):
        nn.load_lora_state_dict(fresh, {**sd, "bogus.lora_A": sd[key]})
    with pytest.raises(KeyError, match="missing"):
        nn.load_lora_state_dict(fresh, {k: v for k, v in sd.items() if k != key})
    with pytest.raises(ValueError, match="shape"):
        nn.load_lora_state_dict(fresh, {**sd, key: torch.zeros(3, 3)})


def test_target_selection_on_transformer_matches_jax():
    """q and v of a TransformerLM (the standard recipe): the same adapters
    and trainable share as the JAX package, and no match raises."""
    jm, tm = _pair("transformer", 0)
    total = sum(p.numel() for p in tm.parameters())
    adapters = nn.apply_lora(tm, r=2, target=["q_proj", "v_proj"])
    jadapters = jnn.apply_lora(jm, r=2, target=["q_proj", "v_proj"])
    assert [tuple(p.shape) for p in adapters] == [tuple(p.shape) for p in jadapters]
    assert len(adapters) == 2 * 2 * 2
    trainable = [p for p in tm.parameters() if p.requires_grad]
    assert set(map(id, trainable)) == set(map(id, adapters))
    assert sum(p.numel() for p in trainable) < 0.05 * total
    with pytest.raises(ValueError, match="no Linear"):
        nn.apply_lora(tm, target=["nothing"])


def test_lora_adamw_trajectory_matches_jax():
    """Three AdamW steps of the adapters alone, clipped by global norm and
    on a WarmupCosineLR schedule: the same losses and adapters as the JAX
    package, the frozen base bit for bit unchanged."""
    jm, tm = _pair("llama", 6, dict(r=4, alpha=8.0, target=TARGET))
    base = {n: p.clone() for n, p in tm.named_parameters() if not p.requires_grad}
    jadapters = [p for p in jm.parameters() if p.requires_grad]
    tadapters = [p for p in tm.parameters() if p.requires_grad]
    jopt = joptim.AdamW(jadapters, lr=1e-2, weight_decay=0.0)
    topt = optim.AdamW(tadapters, lr=1e-2, weight_decay=0.0)
    jsch = joptim.WarmupCosineLR(jopt, warmup_epochs=1, T_max=3)
    tsch = optim.WarmupCosineLR(topt, warmup_epochs=1, T_max=3)
    jstep = JaxStep(jm, jopt, jnn.CrossEntropyLoss(),
                    grad_transform=joptim.clip_by_global_norm(1.0))
    tstep = CompiledTrainStep(tm, topt, nn.CrossEntropyLoss(),
                              grad_transform=optim.clip_by_global_norm(1.0))
    seq = RNG.integers(0, 48, (4, 17)).astype(np.int32)
    x, y = seq[:, :16], seq[:, 1:]
    want, got = [], []
    for _ in range(3):
        want.append(float(jstep(x, y)))
        got.append(float(tstep(x, y)))
        jsch.step()
        tsch.step()
        assert topt.lr == jopt.lr
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]
    tsd = tm.state_dict()
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for n, p in tm.named_parameters():
        if n in base:
            assert torch.equal(p, base[n]), n


def test_train_step_binds_bf16_copies_and_leaves_the_base_without_gradient():
    _, tm = _pair("llama", 7, dict(r=2, target=TARGET))
    names = [n for n, _ in tm.named_parameters()]
    q = tm.blocks[0].attn.q_proj
    seen = {}

    def criterion(out, y):
        seen["dtypes"] = (q.base.weight.dtype, q.lora_A.dtype, q.lora_B.dtype)
        seen["grad"] = (q.base.weight.requires_grad, q.lora_A.requires_grad)
        return nn.CrossEntropyLoss()(out, y)

    def transform(grads):
        seen["none"] = [n for n, g in zip(names, grads) if g is None]
        return grads

    adapters = [p for p in tm.parameters() if p.requires_grad]
    step = CompiledTrainStep(tm, optim.AdamW(adapters, lr=1e-3), criterion,
                             compute_dtype=torch.bfloat16, grad_transform=transform)
    seq = RNG.integers(0, 48, (2, 17)).astype(np.int32)
    step(seq[:, :16], seq[:, 1:])
    assert seen["dtypes"] == (torch.bfloat16,) * 3
    assert seen["grad"] == (False, True)
    assert set(seen["none"]) == {n for n in names if "lora_" not in n}
    assert q.base.weight.dtype == q.lora_A.dtype == torch.float32  # the masters back


@pytest.mark.parametrize("kind", ["transformer", "llama", "mixtral"])
def test_every_decoder_refuses_an_unmerged_lora_model(kind):
    dt.manual_seed(1)
    if kind == "transformer":
        lm = models.TransformerLM(vocab_size=32, max_len=8, dim=32, depth=1, num_heads=2,
                                  device="cpu")
    elif kind == "llama":
        lm = models.LlamaLM(**LLAMA, device="cpu")
    else:
        lm = models.MixtralLM(**dict(LLAMA, depth=1), n_experts=4, device="cpu")
    nn.apply_lora(lm, r=2, target=["q_proj", "v_proj"])
    want = {"transformer": "KVCacheDecoder", "llama": "LlamaKVCacheDecoder",
            "mixtral": "MixtralKVCacheDecoder"}[kind]
    with pytest.raises(RuntimeError, match="merge_lora"):
        models.KVCacheDecoder(lm)
    nn.merge_lora(lm)
    assert type(models.KVCacheDecoder(lm)).__name__ == want


def test_merged_llama_decodes_as_jax():
    """After merge_lora the port's Llama decoder gives the JAX decoder's
    greedy tokens on the JAX model's merged weights, and its prefill
    logits equal the adapted forward's."""
    jm, tm = _pair("llama", 2, dict(r=2, target=TARGET), b_scale=0.3)
    x = RNG.integers(0, 48, (2, 4)).astype(np.int64)
    pad = np.zeros((2, LLAMA["max_len"]), np.int64)
    pad[:, :4] = x
    adapted = _tfwd(tm, pad)[:, 3]
    nn.merge_lora(tm)
    jnn.merge_lora(jm)
    dec = models.KVCacheDecoder(tm)
    with torch.no_grad():
        logits = dec._prefill(dec._prepared(), torch.from_numpy(pad), 4)[2]
    np.testing.assert_allclose(logits.numpy(), adapted, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(dec.generate(x.copy(), 3), JaxDecoder(jm).generate(x.copy(), 3))
