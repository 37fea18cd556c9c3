"""The port's pretrained-weight pipeline (``utils.pretrained_models``,
``utils.convert_pretrained``, ``utils.model_param_mappings``) against the
JAX package's on the CPU, on state dicts built here (no download):

- ``convert_torch_state_dict`` gives JAX's arrays bit for bit (a torch
  ResNet twin with torchvision's names, a Linear, a MobileNetV2 laid out as
  torchvision lays it out), and the converted port model computes the
  twin's output;
- ``export_torch_state_dict`` gives JAX's arrays for the same weights, and
  converting them back is exact;
- ``convert_weights_to_deepflows`` writes the pickle JAX writes, and each
  package's file loads through the other's ``load_pretrained_model``;
- the port's own mapping JSONs equal JAX's and cover every parameter and
  buffer of the port's zoo;
- the CLI lists and converts; without torchvision the download raises
  JAX's message; strict loading raises on what does not fit;
- the real torchvision checkpoint waits for ``DEEPFLOWS_RESNET18_PTH``.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu.utils import pretrained_models as jpre
from deepflows_tpu_torch import models, nn, ops
from deepflows_tpu_torch.utils import load_jax_state_dict
from deepflows_tpu_torch.utils import pretrained_models as tpre

RNG = np.random.default_rng(0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found it."""
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
    df.set_grad_enabled(True)
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)


class TBasic(tnn.Module):
    def __init__(self, inp, planes, stride=1, down=False):
        super().__init__()
        self.conv1 = tnn.Conv2d(inp, planes, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.relu = tnn.ReLU()
        self.conv2 = tnn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.downsample = (tnn.Sequential(tnn.Conv2d(inp, planes, 1, stride, bias=False),
                                          tnn.BatchNorm2d(planes)) if down else None)

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + idt)


class TResNet(tnn.Module):
    """torchvision's ResNet names on ResNet(BasicBlock, [1, 1, 1, 1])."""

    def __init__(self, num_classes=5):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.relu = tnn.ReLU()
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        self.layer1 = tnn.Sequential(TBasic(64, 64))
        self.layer2 = tnn.Sequential(TBasic(64, 128, 2, True))
        self.layer3 = tnn.Sequential(TBasic(128, 256, 2, True))
        self.layer4 = tnn.Sequential(TBasic(256, 512, 2, True))
        self.avgpool = tnn.AdaptiveAvgPool2d(1)
        self.fc = tnn.Linear(512, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(self.avgpool(x).flatten(1))


def _twin(seed=0, num_classes=5):
    torch.manual_seed(seed)
    tm = TResNet(num_classes)
    with torch.no_grad():  # running statistics that are not the init's
        for m in tm.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
    return tm.eval()


def _same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resnet_conversion_matches_jax_and_the_twin():
    tm = _twin()
    sd = tm.state_dict()
    port = models.ResNet(models.BasicBlock, [1, 1, 1, 1], num_classes=5, device="cpu")
    jax_model = jmodels.ResNet(jmodels.BasicBlock, [1, 1, 1, 1], num_classes=5, device="cpu")
    got = tpre.convert_torch_state_dict(port, sd)
    _same_arrays(got, jpre.convert_torch_state_dict(jax_model, sd))
    missing, unexpected = port.load_weights(got)
    assert not missing and not unexpected
    port.eval()
    x = RNG.standard_normal((2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.tensor(x)).numpy()
        out = port(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-3, atol=1e-4)


def test_linear_conversion_transposes_even_square_weights():
    for n_in, n_out in ((4, 3), (5, 5)):
        torch.manual_seed(n_in)
        tl = tnn.Linear(n_in, n_out)
        sd = {f"0.{k}": v for k, v in tl.state_dict().items()}
        port = nn.Sequential(nn.Linear(n_in, n_out, device="cpu"))
        got = tpre.convert_torch_state_dict(port, sd)
        _same_arrays(got, jpre.convert_torch_state_dict(
            jnn.Sequential(jnn.Linear(n_in, n_out, device="cpu")), sd))
        port.load_weights(got)
        x = RNG.standard_normal((2, n_in)).astype(np.float32)
        with torch.no_grad():
            np.testing.assert_allclose(port(torch.tensor(x)).numpy(), tl(torch.tensor(x)).numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_bf16_and_mismatched_entries():
    """A bf16 source widens to f32; an entry the model lacks, or whose shape
    no rule fits, is skipped as in JAX."""
    tl = tnn.Linear(4, 3)
    sd = {"0.weight": tl.weight.detach().to(torch.bfloat16), "0.bias": torch.zeros(7),
          "9.weight": torch.zeros(2, 2)}
    port = nn.Sequential(nn.Linear(4, 3, device="cpu"))
    got = tpre.convert_torch_state_dict(port, sd)
    assert list(got) == ["0.weight"] and got["0.weight"].dtype == np.float32
    np.testing.assert_array_equal(got["0.weight"], sd["0.weight"].float().numpy().T)


@pytest.mark.parametrize("name", ["cifar", "resnet18"])
def test_export_matches_jax_and_round_trips(name):
    df.manual_seed(4)
    if name == "cifar":
        jm, tm = jmodels.CIFAR10_CNN(device="cpu"), models.CIFAR10_CNN(device="cpu")
    else:
        jm, tm = jmodels.ResNet18(num_classes=10, device="cpu"), models.ResNet18(
            num_classes=10, device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    exported = tpre.export_torch_state_dict(tm)
    _same_arrays(exported, jpre.export_torch_state_dict(jm))
    if name == "cifar":
        assert exported["fc.weight"].shape == (10, 128 * 4 * 4)  # torch layout
    back = tpre.convert_torch_state_dict(tm, exported)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_convert_file_pipeline_across_packages(tmp_path):
    """One .pth through both packages' convert_weights_to_deepflows: the
    pickles hold the same arrays, and each loads through the other's
    load_pretrained_model."""
    tm = _twin(seed=1, num_classes=1000)
    pth = str(tmp_path / "resnet18.pth")
    torch.save({k: v for k, v in tm.state_dict().items() if not k.startswith("fc.")}, pth)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jout = jpre.convert_weights_to_deepflows("resnet18", pth, pretrained_dir=jdir)
    tout = tpre.convert_weights_to_deepflows("resnet18", pth, pretrained_dir=tdir)
    assert os.path.basename(tout) == os.path.basename(jout) == "resnet18_deepflows.pkl"
    with open(jout, "rb") as f:
        jarr = pickle.load(f)
    with open(tout, "rb") as f:
        tarr = pickle.load(f)
    _same_arrays(tarr, jarr)
    assert tpre.load_model_metadata("resnet18", tdir)["num_arrays"] == \
        jpre.load_model_metadata("resnet18", jdir)["num_arrays"] == len(tarr)
    assert tpre.is_pretrained_available("resnet18", tdir)
    assert tpre.list_available_pretrained_models(True, tdir) == ["resnet18"]
    # the JAX file into the port (non-strict: the twin's layers hold one block)
    port = models.ResNet18(num_classes=1000, device="cpu")
    tpre.load_pretrained_model(port, "resnet18", pretrained_dir=jdir)
    for k, v in jarr.items():
        np.testing.assert_array_equal(port.state_dict()[k].numpy(), v, err_msg=k)
    with pytest.raises(KeyError, match="missing="):
        tpre.load_pretrained_model(models.ResNet18(device="cpu"), "resnet18", jdir, strict=True)
    # the port's file into the JAX package
    jm = jmodels.ResNet18(num_classes=1000, device="cpu")
    jpre.load_pretrained_model(jm, "resnet18", pretrained_dir=tdir)
    for k, v in tarr.items():
        np.testing.assert_array_equal(jm.state_dict()[k], v, err_msg=k)
    # a new head: fc keeps its init
    fresh = tpre.create_model_with_pretrained_weights("resnet18", tdir, num_classes=7,
                                                      device="cpu")
    np.testing.assert_array_equal(fresh.conv1.weight.detach().numpy(), tarr["conv1.weight"])
    assert tuple(fresh.fc.weight.shape) == (512, 7)
    with pytest.raises(FileNotFoundError):
        tpre.get_pretrained_weights("vgg16", tdir, auto_download=False)


def test_strict_load_raises_on_shape():
    m = nn.Sequential(nn.Linear(4, 3, device="cpu"))
    bad = {"0.weight": np.zeros((3, 4), np.float32), "0.bias": np.zeros((1, 3), np.float32)}
    from deepflows_tpu_torch.utils.convert import load_arrays

    with pytest.raises(ValueError, match="size mismatch for 0.weight"):
        load_arrays(m, bad, strict=True)
    w = m[0].weight.detach().clone()
    missing, unexpected = m.load_weights(dict(bad, extra=np.zeros(1)))
    assert missing == [] and unexpected == ["extra"]  # skipped, not raised
    assert torch.equal(m[0].weight, w) and not m[0].bias.detach().any()


def test_mapping_jsons_are_jax_s_and_cover_the_port_zoo():
    zoo = {
        "resnet18": models.ResNet18(device="cpu"),
        "resnet50": models.ResNet50(device="cpu"),
        "vgg16": models.VGG16(device="cpu"),
        "mobilenet_v1": models.MobileNetV1(device="cpu"),
    }
    for name in tpre.SUPPORTED_MODELS:
        assert tpre.load_model_param_mapping(name) == jpre.load_model_param_mapping(name)
        assert os.path.dirname(tpre._MAPPING_DIR).endswith(os.path.join("deepflows_tpu_torch",
                                                                        "utils"))
    for name, model in zoo.items():
        mapping = tpre.load_model_param_mapping(name)
        ours = set(model.state_dict())
        mapped = {v for v in mapping.values() if not v.endswith("num_batches_tracked")}
        assert mapped == ours, (name, mapped ^ ours)
    assert tpre.load_model_param_mapping("nope") is None


def test_mapping_generator_reproduces_the_files():
    from deepflows_tpu_torch.utils.model_param_mappings import generate

    built = {"resnet18": generate.build_mapping(models.ResNet18(device="cpu")),
             "mobilenet_v2": generate.build_mobilenet_v2_mapping(models.MobileNetV2(device="cpu"))}
    for name, mapping in built.items():
        assert mapping == tpre.load_model_param_mapping(name), name


def test_mobilenet_v2_mapping_round_trip():
    """A MobileNetV2 state dict laid out as torchvision's (renamed by the
    mapping, Linear transposed, BN vectors raveled, num_batches_tracked
    added) converts back to the model's arrays in both packages."""
    df.manual_seed(6)
    jm = jmodels.MobileNetV2(num_classes=10, device="cpu")
    own = jm.state_dict()
    mapping = tpre.load_model_param_mapping("mobilenet_v2")
    fake = {}
    for tname, name in mapping.items():
        if name.endswith("num_batches_tracked"):
            fake[tname] = np.asarray(0, np.int64)
        else:
            fake[tname] = tpre.to_torch_layout(name, own[name])
    got = tpre.convert_torch_state_dict(models.MobileNetV2(num_classes=10, device="cpu"), fake,
                                        mapping=mapping)
    _same_arrays(got, jpre.convert_torch_state_dict(jm, fake, mapping=mapping))
    _same_arrays(got, dict(own))


def test_cli_lists_and_converts(capsys, tmp_path):
    from deepflows_tpu_torch.utils.convert_pretrained import main

    assert main(["--list", "--pretrained_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert all(m in out for m in tpre.SUPPORTED_MODELS) and "[converted]" not in out
    pth = str(tmp_path / "twin.pth")
    torch.save(_twin(num_classes=1000).state_dict(), pth)
    assert main(["--model_name", "resnet18", "--weights_path", pth,
                 "--pretrained_dir", str(tmp_path)]) == 0
    assert "converted ->" in capsys.readouterr().out
    main(["--list", "--pretrained_dir", str(tmp_path)])
    assert "resnet18        [converted]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main([])  # --model_name is required unless --list


def test_download_without_torchvision_raises_jax_message(tmp_path):
    try:
        import torchvision  # noqa: F401

        pytest.skip("torchvision is installed: the download would run")
    except ImportError:
        pass
    for pkg in (jpre, tpre):
        with pytest.raises(RuntimeError, match="torchvision is not available"):
            pkg.download_pretrained_model("resnet18", pretrained_dir=str(tmp_path))
        with pytest.raises(ValueError, match="unsupported model"):
            pkg.download_pretrained_model("alexnet", pretrained_dir=str(tmp_path))


def test_real_torchvision_checkpoint_end_to_end(tmp_path):
    """A real torchvision ResNet-18 .pth: converted, loaded, and held
    against the torchvision-layout twin (``examples/torch_twins.py``) on the
    same weights.  Set DEEPFLOWS_RESNET18_PTH to its path; skipped without."""
    path = os.environ.get("DEEPFLOWS_RESNET18_PTH")
    if not path or not os.path.exists(path):
        pytest.skip("set DEEPFLOWS_RESNET18_PTH to a torchvision resnet18 .pth")
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from torch_twins import TorchResNet18

    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = tpre.convert_weights_to_deepflows("resnet18", path, pretrained_dir=str(tmp_path))
    model = models.ResNet18(num_classes=1000, device="cpu")
    tpre.load_pretrained_model(model, "resnet18", pretrained_dir=str(tmp_path))
    model.eval()
    twin = TorchResNet18(num_classes=1000, small_input=False)
    twin.load_state_dict(sd, strict=False)
    twin.eval()
    x = RNG.standard_normal((2, 3, 224, 224)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.tensor(x)).numpy(), twin(torch.tensor(x)).numpy(),
                                   rtol=1e-3, atol=1e-4)
    assert os.path.exists(out)
    with open(os.path.join(str(tmp_path), "resnet18_info.json")) as f:
        assert json.load(f)["source"] == "pytorch"
