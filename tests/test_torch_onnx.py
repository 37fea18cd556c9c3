"""The port's ONNX export and runtime (``deepflows_tpu_torch/onnx/``) held
against the JAX package's (``tests/test_onnx.py``'s cases).

Each model family is built in both packages with the JAX weights carried
across (``load_jax_state_dict``; BN running statistics moved off their
initial values, so that the folded BN chain is tested), and checked four
ways: (a) the port's file in the port's runtime equals the port model;
(b) the port's file in the JAX package's ``OnnxModel`` equals the port
model; (c) the file the JAX exporter writes, in the port's runtime,
equals the JAX runtime on it; (d) the op-histogram facts of the JAX
tests hold for the port's file.  The LMs run tokens never seen while
tracing.  One JAX export per family, in a module fixture."""

import threading

import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu import models as jmodels
from deepflows_tpu.onnx import OnnxModel as JaxOnnxModel
from deepflows_tpu.onnx import export_onnx as jax_export
from deepflows_tpu_torch import config, models, nn
from deepflows_tpu_torch.jit import CompiledEvalStep
from deepflows_tpu_torch.onnx import OnnxModel, check_onnx, export_onnx
from deepflows_tpu_torch.onnx.export import _Exporter, _tensor_proto, _trace, _value_info
from deepflows_tpu_torch.onnx.proto import onnx_minimal_pb2 as pb
from deepflows_tpu_torch.tensor import active_mode
from deepflows_tpu_torch.utils import load_jax_state_dict

CNN = dict(rtol=1e-5, atol=1e-5)  # tests/test_onnx.py's _roundtrip
LM = dict(rtol=1e-5, atol=1e-6)  # its LM cases
CNN_JAX = dict(rtol=1e-4, atol=1e-5)  # the JAX runtime on the port's file, CNNs
IMG = (2, 3, 32, 32)

# name: (class, kwargs, input shape or (vocab, shape), batch_dynamic)
FAMILIES = {
    "mnist_cnn": ("MNIST_CNN", {}, (2, 1, 28, 28), True),
    "cifar10_cnn": ("CIFAR10_CNN", {}, IMG, True),
    "resnet18": ("ResNet18", dict(num_classes=10, small_input=True), IMG, True),
    "vgg16": ("VGG16", dict(num_classes=10, img_size=32), (1, 3, 32, 32), True),
    "mobilenet_v1": ("MobileNetV1", dict(num_classes=10), (1, 3, 32, 32), True),
    "mobilenet_v2": ("MobileNetV2", dict(num_classes=4, small_input=True), IMG, True),
    "resnet18_fused": ("ResNet18", dict(num_classes=10, small_input=True), IMG, True),
    "transformer_lm": ("TransformerLM", dict(vocab_size=16, max_len=8, dim=32, depth=2,
                                             num_heads=2), (16, (2, 8)), True),
    "llama": ("LlamaLM", dict(vocab_size=32, dim=32, depth=2, num_heads=2, num_kv_heads=1,
                              max_len=8), (32, (2, 8)), False),
    "mixtral": ("MixtralLM", dict(vocab_size=32, dim=32, depth=2, num_heads=2, num_kv_heads=1,
                                  n_experts=4, max_len=8), (32, (2, 8)), False),
    "seq2seq": ("Seq2SeqTransformer", dict(vocab_size=32, src_len=4, tgt_len=4, dim=32,
                                           enc_depth=1, dec_depth=1, num_heads=2),
                (32, (2, 8)), False),
}


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found
    it."""
    from deepflows_tpu import config as jconfig
    from deepflows_tpu import random as jrandom
    from deepflows_tpu.backend import jax_kernels, numpy_kernels

    seed, host_key, np_rng = jconfig.seed, jax_kernels._host_key, numpy_kernels._rng
    np_state = np_rng.bit_generator.state
    eager = (jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter)
    yield
    jconfig.seed, jax_kernels._host_key, numpy_kernels._rng = seed, host_key, np_rng
    np_rng.bit_generator.state = np_state
    jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter = eager


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("DEEPFLOWS_BACKEND", "cpu")
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)
    yield
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)


def _inputs(name, seed):
    spec = FAMILIES[name][2]
    rng = np.random.default_rng(seed)
    if isinstance(spec[1], tuple):
        vocab, shape = spec
        return rng.integers(0, vocab, shape).astype(np.int32)
    return rng.standard_normal(spec).astype(np.float32)


def _pair(name):
    """The JAX model and the port model with its weights, in eval mode."""
    cls, kw, _, _ = FAMILIES[name]
    df.manual_seed(0)
    # the numpy device: the JAX exporter's trace then compiles nothing
    jm = getattr(jmodels, cls)(device="cpu", **kw).to("cpu")
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    rng = np.random.default_rng(1)
    for k in [k for k in jsd if k.endswith(("running_mean", "running_var"))]:
        shift = rng.standard_normal(jsd[k].shape).astype(np.float32) * 0.1
        jsd[k] = (jsd[k] + shift) if k.endswith("mean") else jsd[k] * np.exp(shift)
    jm.load_state_dict(jsd)
    tm = getattr(models, cls)(device="cpu", **kw)
    load_jax_state_dict(tm, jsd)
    x = _inputs(name, 2)
    if name.endswith("_fused"):
        from deepflows_tpu.nn.fusion import fuse_conv_bn as jfuse

        from deepflows_tpu_torch.nn.fusion import fuse_conv_bn

        jm, tm = jfuse(jm, x), fuse_conv_bn(tm, x)
    jm.eval()
    tm.eval()
    df.set_grad_enabled(True)
    dt.set_grad_enabled(True)
    return jm, tm


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per family, made once: the two packages' files and the port model."""
    cache = {}

    def get(name):
        if name not in cache:
            d = tmp_path_factory.mktemp(name)
            jm, tm = _pair(name)
            x = _inputs(name, 3)
            bd = FAMILIES[name][3]
            port = export_onnx(tm, x, str(d / "port.onnx"), batch_dynamic=bd)
            jax = jax_export(jm, x, str(d / "jax.onnx"), batch_dynamic=bd)
            df.set_grad_enabled(True)
            cache[name] = (tm, port, jax)
        return cache[name]

    return get


def _port_out(tm, x):
    return CompiledEvalStep(tm)(x).numpy()


def _jax_run(path, x):
    """The JAX package's runtime on ``path``: its ``OnnxModel._run``, jitted
    with the initializers as arguments.  ``OnnxModel.__call__`` closes over
    them, and XLA folding VGG16's 4096-wide constants takes seconds a
    compile; ``test_dynamic_batch`` calls it as it is."""
    import jax

    m = JaxOnnxModel(path)
    consts = {k: jax.device_put(v) for k, v in m.initializers.items()}
    (out,) = jax.jit(lambda c, *a: m._run(c, a))(consts, x)
    return np.asarray(out)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_roundtrip_both_runtimes(name, exported):
    tm, port, jax = exported(name)
    tol, jtol = (LM, LM) if isinstance(FAMILIES[name][2][1], tuple) else (CNN, CNN_JAX)
    x = _inputs(name, 4)  # fresh: nothing input-dependent may have been folded
    ref = _port_out(tm, x)
    got = OnnxModel(port, device="cpu")(x)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **tol)  # (a)
    np.testing.assert_allclose(_jax_run(port, x), ref, **jtol)  # (b)
    want = _jax_run(jax, x)
    np.testing.assert_allclose(OnnxModel(jax, device="cpu")(x), want, **jtol)  # (c)
    df.set_grad_enabled(True)


def _ops(path):
    return check_onnx(path)["ops"]


def test_histogram_facts(exported):
    """(d): the op-histogram facts of tests/test_onnx.py, on the port's
    files."""
    info = check_onnx(exported("mnist_cnn")[1])
    assert info["ops"]["Conv"] == 2 and info["ops"]["MatMul"] == 1
    assert info["inputs"] == ["input"] and info["opset"] == [13]
    ops = _ops(exported("cifar10_cnn")[1])
    assert "Dropout" not in ops and "BatchNormalization" not in ops and ops["Conv"] == 3
    assert {"Sub", "Div", "Mul", "Add"} <= set(ops)  # BN eval as its folded chain
    assert _ops(exported("resnet18")[1])["Conv"] == 20
    assert _ops(exported("mobilenet_v2")[1]).get("Min", 0) > 0  # ReLU6
    assert _ops(exported("transformer_lm")[1]).get("Gather") == 1
    assert _ops(exported("llama")[1]).get("Sigmoid", 0) > 0  # SiLU decomposed
    ops = _ops(exported("mixtral")[1])
    assert ops.get("TopK", 0) == 2 and ops.get("GreaterOrEqual", 0) == 2  # routing not folded
    assert ops.get("Cast", 0) == 2
    assert _ops(exported("seq2seq")[1]).get("Slice", 0) >= 2
    import os

    plain, fused = exported("resnet18")[1], exported("resnet18_fused")[1]
    info_p, info_f = check_onnx(plain), check_onnx(fused)
    assert info_f["ops"]["Conv"] == info_p["ops"]["Conv"] == 20
    n_affine = lambda i: sum(i["ops"].get(k, 0) for k in ("Sub", "Div", "Mul"))  # noqa: E731
    assert n_affine(info_p) >= 20 and n_affine(info_f) == 0
    assert os.path.getsize(fused) < os.path.getsize(plain)


def test_deep_model_exports(tmp_path):
    """ResNet-50's chain (over a thousand values deep) exports: the walk
    does not recurse per value."""
    torch.manual_seed(0)
    m = models.ResNet50(num_classes=10, device="cpu")
    x = np.random.default_rng(0).standard_normal((1, 3, 32, 32)).astype(np.float32)
    p = export_onnx(m, x, str(tmp_path / "r50.onnx"))
    assert check_onnx(p)["ops"]["Conv"] == 53
    np.testing.assert_allclose(OnnxModel(p, device="cpu")(x), _port_out(m, x), **CNN)


def test_check_onnx_and_signature_match_jax(exported):
    """Both exporters write the same graph signature: one input named
    "input" of the sample's element type with a dynamic "N", one output."""
    from deepflows_tpu.onnx import check_onnx as jcheck

    for name in ("mnist_cnn", "transformer_lm"):
        _, port, jax = exported(name)
        p, j = check_onnx(port), jcheck(jax)
        assert p["inputs"] == j["inputs"] == ["input"] and p["opset"] == j["opset"]
        mp, mj = pb.ModelProto(), pb.ModelProto()
        mp.ParseFromString(open(port, "rb").read())
        mj.ParseFromString(open(jax, "rb").read())
        assert mp.ir_version == mj.ir_version == 8
        assert mp.graph.input[0] == mj.graph.input[0]
        assert [d.dim_param or d.dim_value for d in mp.graph.output[0].type.tensor_type.shape.dim] \
            == [d.dim_param or d.dim_value for d in mj.graph.output[0].type.tensor_type.shape.dim]


@pytest.mark.parametrize("bs", [1, 7])
def test_dynamic_batch(bs, exported):
    tm, port, _ = exported("mnist_cnn")
    x = np.random.default_rng(bs).standard_normal((bs, 1, 28, 28)).astype(np.float32)
    ref = _port_out(tm, x)
    np.testing.assert_allclose(OnnxModel(port, device="cpu")(x), ref, **CNN)
    np.testing.assert_allclose(JaxOnnxModel(port)(x), ref, **CNN_JAX)
    df.set_grad_enabled(True)


def test_lm_dynamic_batch(exported):
    tm, port, _ = exported("transformer_lm")
    idx = np.random.default_rng(1).integers(0, 16, (5, 8)).astype(np.int32)
    got = OnnxModel(port, device="cpu")(idx)
    assert got.shape == (5, 8, 16)
    np.testing.assert_allclose(got, _port_out(tm, idx), **LM)


def test_train_mode_export_rejected():
    torch.manual_seed(0)
    model = models.CIFAR10_CNN(device="cpu")
    model.train()
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 3, 32, 32)),
                        dtype=torch.float32)
    tracer, out = _trace(model, x)  # export_onnx's trace forces eval: trace in train mode
    with pytest.raises(ValueError, match="eval"):
        _Exporter(tracer, True).name_of(out)
    assert model.training


def _refused(model, x, tmp_path, match="no ONNX mapping|not exportable"):
    with pytest.raises(ValueError, match=match):
        export_onnx(model, x, str(tmp_path / "refused.onnx"))


class _Square(dt.UnaryOperator):
    """A user-defined tape op written the JAX package's way."""

    def forward(self, x):
        return x.data * x.data

    def grad_fn(self, x, grad):
        return grad * x.data * 2.0


class _UserOpModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(8, 4, device="cpu")

    def forward(self, x):
        return self.lin(_Square(dt.Tensor(x)))


class _Unmapped(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(8, 4, device="cpu")

    def forward(self, x):
        return torch.sort(self.lin(x), -1).values


class _Bridged(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(8, 4, device="cpu")
        self.fn = nn.torch_function(lambda t: torch.tanh(t) * 2.0)

    def forward(self, x):
        return self.fn(self.lin(x))


def _refusal_case(kind):
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    if kind == "moe":  # tests/test_onnx.py::test_jax_bridge_node_refuses_constant_fold
        model = nn.Sequential(nn.MoE(8, 16, n_experts=2, capacity_factor=2.0, device="cpu"),
                              nn.Flatten(), nn.Linear(2 * 8, 3, device="cpu"))
        return model, rng.standard_normal((2, 2, 8)).astype(np.float32)
    if kind == "flash":
        model = models.TransformerLM(vocab_size=16, max_len=8, dim=32, depth=1, num_heads=2,
                                     device="cpu", flash=True)
        return model, rng.integers(0, 16, (2, 8)).astype(np.int32)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    if kind == "use_pallas":
        return nn.Sequential(nn.Linear(8, 4, device="cpu")), x
    if kind == "torch_function":
        return _Bridged(), x
    if kind == "user_op":
        return _UserOpModel(), x
    return _Unmapped(), x


@pytest.mark.parametrize("kind", ["moe", "flash", "use_pallas", "torch_function", "user_op",
                                  "unmapped"])
def test_refusals(kind, tmp_path):
    """Where the JAX exporter refuses (a MoE with capacity, the flash and
    use_pallas kernel routes, a bridged function, a user-defined tape op,
    an op it cannot map), the port's refuses, and never folds the node."""
    model, x = _refusal_case(kind)
    saved = config.use_pallas
    config.use_pallas = kind == "use_pallas"
    try:
        match = {"flash": "_FlashAttention", "use_pallas": "_FusedLinear",
                 "torch_function": "not exportable", "user_op": "_UserOp"}.get(
                     kind, "no ONNX mapping|not exportable")
        _refused(model, x, tmp_path, match)
    finally:
        config.use_pallas = saved
    assert not (tmp_path / "refused.onnx").exists()


def test_flash_auto_takes_the_naive_path_while_traced(tmp_path):
    """flash=None exports (its naive path has an ONNX form) and equals the
    model; flash=True is refused above by the kernel route's name."""
    torch.manual_seed(0)
    lm = models.TransformerLM(vocab_size=16, max_len=8, dim=32, depth=1, num_heads=2,
                              device="cpu", flash=None)
    idx = np.random.default_rng(0).integers(0, 16, (2, 8)).astype(np.int32)
    p = export_onnx(lm, idx, str(tmp_path / "lm.onnx"))
    np.testing.assert_allclose(OnnxModel(p, device="cpu")(idx), _port_out(lm, idx), **LM)
    assert active_mode() is None  # the tracer is gone with the export


class _Held(nn.Module):
    """A forward that holds the export's trace open until ``go`` is set,
    noting the tracing thread's active mode."""

    def __init__(self, entered, go):
        super().__init__()
        self.lin = nn.Linear(8, 4, device="cpu")
        self.entered, self.go, self.seen = entered, go, None

    def forward(self, x):
        self.seen = active_mode()
        self.entered.set()
        self.go.wait(60)
        return self.lin(x)


def test_tracer_is_scoped_to_its_thread(tmp_path):
    """While one thread traces an export, another thread's tape step runs
    as before: no mode is active there, and its autograd Function joins
    the tape (its gradient arrives).  The tracing thread's forward sees the
    tracer, which asks attention layers for no kernel route."""
    entered, go = threading.Event(), threading.Event()
    model = _Held(entered, go)
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    path = str(tmp_path / "held.onnx")
    errors = []

    def export():
        try:
            export_onnx(model, x, path)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=export)
    th.start()
    try:
        assert entered.wait(60)
        assert active_mode() is None
        with dt.enable_grad():  # the export's eval() turned the tape's flag off
            w = dt.Tensor(x, device="cpu", requires_grad=True)
            y = nn.torch_function(lambda t: t * t)(w)
            assert type(y) is dt.Tensor and any(n is y for n in dt.Graph.node_list)
            dt.tensor.sum(y).backward()
        np.testing.assert_array_equal(w.grad.numpy(), 2 * x)
    finally:
        go.set()
        th.join(120)
    assert not errors and not th.is_alive()
    assert type(model.seen).__name__ == "_Tracer" and model.seen.kernel_routes is False
    np.testing.assert_allclose(OnnxModel(path, device="cpu")(x), _port_out(model, x), **CNN)


class _Head(nn.Module):
    def __init__(self, key):
        super().__init__()
        self.lin = nn.Linear(8, 8, device="cpu")
        self.key = key

    def forward(self, x):
        return self.lin(x)[self.key]


@pytest.mark.parametrize("key,shape", [((slice(None), slice(None, 3)), (4, 3)),
                                       ((slice(None), slice(4, None)), (4, 4)),
                                       ((Ellipsis, slice(-3, None)), (4, 3)),
                                       ((slice(None), 2), (4,)),
                                       ((slice(None), None, slice(1, 5)), (4, 1, 4))])
def test_input_slices(key, shape, tmp_path):
    """Static slicing of an input-dependent value lowers to Slice (an int
    index or None adds a Reshape); the open end's INT64_MAX sentinel stays
    exact in both runtimes (tests/test_onnx.py's input and open-ended
    slice cases)."""
    torch.manual_seed(0)
    m = _Head(key)
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    p = export_onnx(m, x, str(tmp_path / "slice.onnx"))
    assert check_onnx(p)["ops"].get("Slice") == 1
    ref = _port_out(m, x)
    assert ref.shape == shape
    np.testing.assert_allclose(OnnxModel(p, device="cpu")(x), ref, **LM)
    np.testing.assert_allclose(JaxOnnxModel(p)(x), ref, **LM)


def test_unsupported_graph_rejected(tmp_path):
    m = pb.ModelProto()
    m.ir_version = 8
    m.opset_import.add().version = 13
    n = m.graph.node.add()
    n.op_type = "LSTM"
    n.input.append("input")
    n.output.append("out")
    m.graph.input.add().name = "input"
    m.graph.output.add().name = "out"
    path = str(tmp_path / "bad.onnx")
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    with pytest.raises(ValueError, match="unsupported ONNX ops"):
        OnnxModel(path, device="cpu")


def _attr(n, name, kind, value):
    a = n.attribute.add()
    a.name, a.type = name, kind
    if kind == pb.AttributeProto.FLOAT:
        a.f = value
    else:
        a.i = value


def test_foreign_graph_ops_execute(tmp_path):
    """Ops the exporter never writes but foreign files use (Gemm with
    transB, Flatten, BatchNormalization, GlobalAveragePool, Softmax) run
    as the JAX runtime runs them."""
    rng = np.random.default_rng(0)
    C = 3
    arrs = dict(scale=rng.standard_normal(C), bias=rng.standard_normal(C),
                mean=rng.standard_normal(C), var=np.abs(rng.standard_normal(C)) + 0.5,
                W=rng.standard_normal((4, C)), b=rng.standard_normal(4))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    m = pb.ModelProto()
    m.ir_version = 8
    m.opset_import.add().version = 13
    g = m.graph
    g.input.append(_value_info("input", (2, C, 5, 5), True))
    for name, arr in arrs.items():
        g.initializer.append(_tensor_proto(name, arr))
    for op, ins, out, attrs in (
            ("BatchNormalization", ["input", "scale", "bias", "mean", "var"], "bn",
             [("epsilon", pb.AttributeProto.FLOAT, 1e-5)]),
            ("GlobalAveragePool", ["bn"], "gap", []), ("Flatten", ["gap"], "flat", []),
            ("Gemm", ["flat", "W", "b"], "gemm", [("transB", pb.AttributeProto.INT, 1)]),
            ("Softmax", ["gemm"], "out", [("axis", pb.AttributeProto.INT, 1)])):
        n = g.node.add()
        n.op_type = op
        n.input.extend(ins)
        n.output.append(out)
        for a in attrs:
            _attr(n, *a)
    g.output.append(_value_info("out", (2, 4), True))
    path = str(tmp_path / "foreign.onnx")
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    x = rng.standard_normal((2, C, 5, 5)).astype(np.float32)
    got = OnnxModel(path, device="cpu")(x)
    c = (1, C, 1, 1)
    bn = (x - arrs["mean"].reshape(c)) / np.sqrt(arrs["var"].reshape(c) + 1e-5)
    bn = bn * arrs["scale"].reshape(c) + arrs["bias"].reshape(c)
    z = bn.mean((2, 3)) @ arrs["W"].T + arrs["b"]
    want = np.exp(z - z.max(1, keepdims=True))
    want /= want.sum(1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, JaxOnnxModel(path)(x), rtol=1e-5, atol=1e-6)


def test_serve_onnx_from_disk(exported):
    """MyDLPWServicer(root_dir, model_file="*.onnx") serves Predict from the
    port's runtime, equal to OnnxModel; the JAX package's file too."""
    pytest.importorskip("grpc")
    import os

    from deepflows_tpu_torch.serving import MyDLPWServicer, PredictClient

    x = np.random.default_rng(5).standard_normal((3, 1, 28, 28)).astype(np.float32)
    for path in exported("mnist_cnn")[1:]:
        s = MyDLPWServicer("127.0.0.1:0", root_dir=os.path.dirname(path),
                           model_file=os.path.basename(path), device="cpu")
        s.serve(wait=False)
        try:
            client = PredictClient(f"127.0.0.1:{s.port}")
            (out,) = client.predict(x)
            client.close()
        finally:
            s.stop()
        np.testing.assert_array_equal(out, OnnxModel(path, device="cpu")(x))


def test_serve_onnx_concurrent_predicts(exported):
    """Clients on several threads send different inputs of one shape at
    once; each answer is OnnxModel's on that request's own input."""
    pytest.importorskip("grpc")
    import os
    from concurrent.futures import ThreadPoolExecutor

    from deepflows_tpu_torch.serving import MyDLPWServicer, PredictClient

    path = exported("mnist_cnn")[1]
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((2, 1, 28, 28)).astype(np.float32) for _ in range(8)]
    s = MyDLPWServicer("127.0.0.1:0", root_dir=os.path.dirname(path),
                       model_file=os.path.basename(path), device="cpu")
    s.serve(wait=False)

    def ask(x):
        client = PredictClient(f"127.0.0.1:{s.port}")
        try:
            return client.predict(x)[0]
        finally:
            client.close()

    try:
        with ThreadPoolExecutor(len(xs)) as pool:
            outs = list(pool.map(ask, xs))
    finally:
        s.stop()
    ref = OnnxModel(path, device="cpu")
    for x, out in zip(xs, outs):
        np.testing.assert_array_equal(out, ref(x))


def test_runtime_drops_values_after_last_use(exported):
    """Each value but the graph outputs is dropped once, after the last
    node that reads it, and never before the node that makes it."""
    m = OnnxModel(exported("resnet18")[1], device="cpu")
    made, read = {}, {}
    for i, n in enumerate(m.nodes):
        read.update((name, i) for name in n.input if name)
        made.update((name, i) for name in n.output if name)
    dropped = {name: i for i, names in enumerate(m._dead) for name in names}
    assert sum(map(len, m._dead)) == len(dropped)
    assert set(dropped) == (set(read) | set(made)) - set(m.output_names)
    for name, i in dropped.items():
        assert i == max(read.get(name, -1), made.get(name, -1))


def test_onnxruntime_crosscheck(exported):
    """Env-gated: where onnxruntime is installed, it runs the port's file."""
    ort = pytest.importorskip("onnxruntime")
    tm, port, _ = exported("mnist_cnn")
    x = np.random.default_rng(6).standard_normal((2, 1, 28, 28)).astype(np.float32)
    (got,) = ort.InferenceSession(port).run(None, {"input": x})
    np.testing.assert_allclose(got, _port_out(tm, x), rtol=1e-4, atol=1e-5)
