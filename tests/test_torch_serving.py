"""The port's gRPC serving (deepflows_tpu_torch/serving) on the CPU, over a
real server on 127.0.0.1 (a port the server picks): Predict round trips,
Generate through each of its routes (one-shot, int8 bf16, in-flight,
in-flight paged, prefix-cached, speculative, seq2seq), Predict of a zoo
model served from a checkpoint file (the port's and the JAX package's),
refusals (a model that is neither LM nor seq2seq, an ONNX file), and the
JAX package's ``PredictClient`` calling the port's server: both packages'
protobuf modules register one identical ``serving.proto`` in the
process's descriptor pool.

LMs (TransformerLM dim 32, depth 2, 2 heads, vocab 16, max_len 24) are
built by the JAX package and crossed with ``load_jax_state_dict``; greedy
tokens over the wire equal the JAX package's one-shot decoder's (f32) or
the port's own decoder in the same mode (int8 bf16).
"""

import sys
import threading

import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu.models.decoding import KVCacheDecoder as JaxDecoder
from deepflows_tpu_torch import nn, ops
from deepflows_tpu_torch.models import KVCacheDecoder, TransformerLM
from deepflows_tpu_torch.utils import load_jax_state_dict

grpc = pytest.importorskip("grpc")

from deepflows_tpu.serving import PredictClient as JaxClient  # noqa: E402
from deepflows_tpu_torch.serving import MyDLPWServicer, PredictClient  # noqa: E402

CFG = dict(vocab_size=16, max_len=24, dim=32, depth=2, num_heads=2)


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
    df.set_grad_enabled(True)  # an earlier file's JAX Module.eval() may have left it off
    ops.reset_launch_counts()
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


@pytest.fixture(scope="module")
def lms():
    """The JAX LM, its port (the served target) and a port draft."""
    df.manual_seed(7)
    jlm = jmodels.TransformerLM(**CFG, device="cpu", flash=False)
    tlm = TransformerLM(**CFG, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    Graph.free_graph_all()
    draft = TransformerLM(**dict(CFG, dim=16, depth=1), device="cpu")
    return jlm, tlm, draft


_JAX_TOKENS = {}


def _jax_tokens(jlm, prompt, new):
    """The JAX package's one-shot greedy tokens, computed once per prompt
    by one decoder (its programs compile once)."""
    key = (prompt.tobytes(), prompt.shape, new)
    if key not in _JAX_TOKENS:
        if "dec" not in _JAX_TOKENS:
            _JAX_TOKENS["dec"] = JaxDecoder(jlm)
        _JAX_TOKENS[key] = _JAX_TOKENS["dec"].generate(prompt.astype(np.int64), new)
    return _JAX_TOKENS[key]


class _Served:
    def __init__(self, model, **kw):
        self.server = MyDLPWServicer("127.0.0.1:0", model=model, **kw)
        self.server.serve(wait=False)
        self.addr = f"127.0.0.1:{self.server.port}"
        self.client = PredictClient(self.addr)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.client.close()
        self.server.stop()


def test_predict_round_trip_from_both_clients():
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                          nn.Linear(16, 3, device="cpu"))
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.as_tensor(x)).numpy()
    with _Served(model) as s:
        (out,) = s.client.predict(x)
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
        outs = s.client.predict(x, x * 2)
        assert len(outs) == 2 and outs[1].shape == (4, 3)
        jc = JaxClient(s.addr)
        (jout,) = jc.predict(x)
        jc.close()
    np.testing.assert_allclose(jout, want, rtol=1e-5, atol=1e-6)
    assert model.training  # CompiledEvalStep put the mode back


ROUTES = {  # server keywords, and the attribute of the service that served
    "one-shot": ({}, "_decoder"),
    "int8": (dict(decode_dtype=torch.bfloat16, decode_quant="int8"), "_decoder"),
    "inflight": (dict(inflight_slots=3, inflight_chunk=2), "_engine"),
    "inflight-paged": (dict(inflight_slots=2, inflight_chunk=2, paged_blocks=6, block_size=8),
                       "_engine"),
    "prefix": (dict(inflight_slots=2, inflight_chunk=2), "_engine"),
    "speculative": (dict(spec_gamma=3), "_spec"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_generate_route_matches_the_decoder(lms, route):
    """Three Generate calls from three threads (prompts of 3, 2 and 4, +5,
    +7, +4) and one two-row call: greedy tokens over the wire equal the
    JAX package's one-shot decoder's (int8 bf16: the port's own decoder in
    that mode), and the route's object served them.  Prefix: the prompts
    start with a system prompt registered before the engine exists, and
    one registered on the running engine; every call hits."""
    jlm, tlm, draft = lms
    kw, attr = ROUTES[route]
    if route == "speculative":
        kw = dict(kw, draft_model=draft)
    sys_prompt = np.array([9, 8, 7, 6, 5], np.int64)
    prompts = [np.array([[1, 3, 5]]), np.array([[2, 4]]), np.array([[7, 6, 5, 4]])]
    if route == "prefix":
        prompts = [np.concatenate([sys_prompt[None], p], 1) for p in prompts]
    budgets = [5, 7, 4]
    multi = np.array([[1, 2, 3], [4, 5, 6]])
    if route == "int8":
        ref = KVCacheDecoder(tlm, compute_dtype=torch.bfloat16, quant="int8")
        want = lambda p, n: ref.generate(p, n)  # noqa: E731
    else:
        want = lambda p, n: _jax_tokens(jlm, p, n)  # noqa: E731
    with _Served(tlm, **kw) as s:
        if route == "prefix":
            s.server._service.register_prefix(sys_prompt)
        outs = [None] * 3
        threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, s.client.generate(prompts[i], budgets[i]))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        for i, (o, p, n) in enumerate(zip(outs, prompts, budgets)):
            np.testing.assert_array_equal(o, want(p, n), err_msg=f"call {i}")
        np.testing.assert_array_equal(s.client.generate(multi, 5), want(multi, 5))
        service = s.server._service
        assert getattr(service, attr) is not None
        if route == "prefix":
            extra = np.array([[2, 2, 2, 1]])
            service.register_prefix(extra[0, :3])
            np.testing.assert_array_equal(s.client.generate(extra, 5), want(extra, 5))
            assert service._engine.prefix_hits == 4
        if route == "int8":
            assert service._decoder.quant == "int8"
    if attr == "_engine":
        assert s.server._service._engine is None  # stop() closed the engine


def test_generate_sampling_knobs_and_fallbacks(lms):
    """Sampled calls are reproducible under their seed; top_k 1 collapses
    to greedy; with a draft or an engine configured, a top_k call goes to
    the one-shot decoder."""
    jlm, tlm, draft = lms
    prompt = np.array([[1, 3, 5], [2, 4, 6]])
    want = _jax_tokens(jlm, prompt, 5)
    for kw in ({}, dict(draft_model=draft), dict(inflight_slots=2)):
        with _Served(tlm, **kw) as s:
            a = s.client.generate(prompt, 5, temperature=1.0, seed=3)
            if not kw:
                np.testing.assert_array_equal(a, s.client.generate(prompt, 5, temperature=1.0,
                                                                   seed=3))
            assert (a[:, :3] == prompt).all() and ((a >= 0) & (a < 16)).all()
            np.testing.assert_array_equal(
                s.client.generate(prompt, 5, temperature=2.0, top_k=1), want)
            assert s.server._service._decoder is not None


def test_jax_client_calls_the_port_server(lms):
    """The JAX package's PredictClient asks the port's server: its greedy
    tokens equal the JAX decoder's, and the request's knobs reach it."""
    jlm, tlm, _ = lms
    prompt = np.array([[1, 3, 5], [2, 4, 6]], np.int64)
    with _Served(tlm, inflight_slots=2) as s:
        jc = JaxClient(s.addr)
        out = jc.generate(prompt, 6)
        np.testing.assert_array_equal(out, _jax_tokens(jlm, prompt, 6))
        np.testing.assert_array_equal(jc.generate(prompt, 6, temperature=2.0, top_k=1), out)
        jc.close()


def test_refusals(lms):
    """Generate on a model that is neither an LM nor a seq2seq model fails
    the call (its error names the model); an ONNX file that is not there
    raises FileNotFoundError (tests/test_torch_onnx.py serves one that
    is); a checkpoint without a model name, and no model, raise."""
    model = nn.Sequential(nn.Linear(8, 3, device="cpu"))
    with _Served(model) as s:
        with pytest.raises(grpc.RpcError, match="Sequential"):
            s.client.generate(np.array([[1, 2]]), 3)
    with pytest.raises(FileNotFoundError):
        MyDLPWServicer("127.0.0.1:0", root_dir=".", model_file="absent.onnx", device="cpu")
    with pytest.raises(ValueError, match="model_name"):
        MyDLPWServicer("127.0.0.1:0", root_dir=".", model_file="m.pkl")
    with pytest.raises(ValueError, match="model"):
        MyDLPWServicer("127.0.0.1:0")


S2S = dict(vocab_size=24, src_len=6, tgt_len=6, dim=32, enc_depth=1, dec_depth=1, num_heads=2)


def test_seq2seq_generate_over_grpc():
    """Generate serves a Seq2SeqTransformer (tests/test_serving.py's case):
    matrix[0] the source, the answer the (B, new_tokens) target, equal to
    the JAX model's greedy tokens from both clients; the seed slot carries
    bos_id; with decode_dtype bf16 the server's tokens equal the port's own
    bf16 generator's."""
    from deepflows_tpu_torch.models import Seq2SeqGenerator, Seq2SeqTransformer

    df.manual_seed(9)
    jm = jmodels.Seq2SeqTransformer(**S2S, device="cpu")
    tm = Seq2SeqTransformer(**S2S, device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    Graph.free_graph_all()
    src = np.array([[1, 3, 5, 7, 9, 11], [2, 4, 6, 8, 10, 12]], np.int64)
    with _Served(tm) as s:
        out = s.client.generate(src, 4)
        assert out.shape == (2, 4)
        np.testing.assert_array_equal(out, jm.generate(src, 4, bos_id=0))
        np.testing.assert_array_equal(s.client.generate(src, 4, seed=3),
                                      jm.generate(src, 4, bos_id=3))
        jc = JaxClient(s.addr)
        np.testing.assert_array_equal(jc.generate(src, 4, temperature=0.0, seed=3),
                                      jm.generate(src, 4, bos_id=3))
        jc.close()
        assert isinstance(s.server._service._decoder, Seq2SeqGenerator)
        # concurrent calls share the one generator (its lock)
        srcs = [np.random.default_rng(i).integers(0, 24, (2, 6)) for i in range(6)]
        outs = [None] * len(srcs)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
                i, s.client.generate(srcs[i], 4))) for i in range(len(srcs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        for i, (o, src_i) in enumerate(zip(outs, srcs)):
            np.testing.assert_array_equal(o, jm.generate(src_i, 4), err_msg=f"call {i}")
    with _Served(tm, decode_dtype=torch.bfloat16) as s:
        want = Seq2SeqGenerator(tm, compute_dtype=torch.bfloat16).generate(src, 5, bos_id=2)
        np.testing.assert_array_equal(s.client.generate(src, 5, seed=2), want)
        assert s.server._service._decoder.compute_dtype == torch.bfloat16


def test_predict_from_a_checkpoint_file(tmp_path):
    """A ResNet-18 checkpoint (``utils.save_checkpoint``) served from
    ``root_dir`` + ``model_file`` with ``model_name``: Predict of 2 x 3 x
    32² over the wire equals ``CompiledEvalStep`` on the saved model; the
    same for the JAX package's checkpoint of its own model, against JAX's
    eval."""
    from deepflows_tpu.jit import CompiledEvalStep as JaxEvalStep
    from deepflows_tpu.utils import save_checkpoint as jax_save
    from deepflows_tpu_torch.jit import CompiledEvalStep
    from deepflows_tpu_torch.models import ResNet18
    from deepflows_tpu_torch.utils import save_checkpoint

    model = ResNet18(num_classes=10, device="cpu")
    with torch.no_grad():  # running statistics away from their init
        for b in model.buffers():
            b.uniform_(0.5, 1.5)
    save_checkpoint(model, save_path=str(tmp_path / "resnet18.pkl"))
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = CompiledEvalStep(model)(x).numpy()
    kw = dict(root_dir=str(tmp_path), model_name="resnet18", num_classes=10, device="cpu")
    server = MyDLPWServicer("127.0.0.1:0", model_file="resnet18.pkl", **kw)
    server.serve(wait=False)
    try:
        client = PredictClient(f"127.0.0.1:{server.port}")
        (out,) = client.predict(x)
        client.close()
    finally:
        server.stop()
    np.testing.assert_array_equal(out, want)
    df.manual_seed(3)
    jm = jmodels.ResNet18(num_classes=10, device="cpu")
    jax_save(jm, save_path=str(tmp_path / "jax_resnet18.pkl"))
    jwant = np.asarray(JaxEvalStep(jm)(x))
    with _Served(None, model_file="jax_resnet18.pkl", **kw) as s:
        (jout,) = s.client.predict(x)
    np.testing.assert_allclose(jout, jwant, rtol=1e-4, atol=1e-4)


def test_predict_takes_a_batch_of_images_above_grpc_default():
    """A Predict of 8 x 3 x 224² (4.8 MB, above grpc's default 4 MiB
    limit) reaches the port's server from either client; the JAX
    package's server keeps the default and refuses it."""
    import socket

    from deepflows_tpu.serving import MyDLPWServicer as JaxServer

    x = np.random.default_rng(2).standard_normal((8, 3, 224, 224)).astype(np.float32)
    model = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(3, 2, device="cpu"))
    with torch.no_grad():
        want = model(torch.as_tensor(x)).numpy()
    with _Served(model) as s:
        (out,) = s.client.predict(x)
        jc = JaxClient(s.addr)
        (jout,) = jc.predict(x)
        jc.close()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jout, want, rtol=1e-5, atol=1e-6)
    with socket.socket() as sock:  # a free port: the JAX server does not report its own
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    js = JaxServer(f"127.0.0.1:{port}", model=jnn.Sequential(jnn.Flatten()))
    js.serve(wait=False)
    try:
        client = PredictClient(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError) as err:
            client.predict(x)
        client.close()
    finally:
        js.stop()
    assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
