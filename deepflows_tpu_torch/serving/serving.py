"""gRPC serving (counterpart of ``deepflows_tpu/serving/serving.py``).

The wire protocol is the JAX package's: ``MyDLPW.serving.MyDLPWServing``
with ``Predict`` and ``Generate``, each taking a ``PredictReq`` of
``Matrix`` {flat float values, dims} and answering a ``PredictResp``
(``proto/serving.proto``), registered with grpc's generic method handlers
over the protoc-generated messages, so a client of either package calls a
server of either.  ``Predict`` runs the model's forward
(``jit.CompiledEvalStep``) on the model's device, or a served ``.onnx``
file in the port's runtime (``onnx.OnnxModel``); ``Generate`` decodes a
served LM, through the in-flight engine, the speculative decoder or the
one-shot KV-cache decoder, tried in that order as in the JAX package, or
a ``Seq2SeqTransformer`` through its greedy generator.  The server and
the client take messages of up to ``MAX_MESSAGE_BYTES`` (grpc's default
is 4 MiB, less than a batch of 8 images of 3 × 224²).

``grpc`` is imported only by the server and client classes, so the rest of
the package imports without it.
"""

from __future__ import annotations

import os
import threading
from concurrent import futures
from typing import Optional

import numpy as np
import torch

from .proto import serving_pb2

_SERVICE = "MyDLPW.serving.MyDLPWServing"
MAX_MESSAGE_BYTES = 256 << 20
_GRPC_OPTIONS = [("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                 ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES)]


def _to_matrix(arr: np.ndarray) -> "serving_pb2.Matrix":
    m = serving_pb2.Matrix()
    m.value.extend(np.asarray(arr, dtype=np.float32).ravel().tolist())
    m.dim.extend(list(arr.shape))
    return m


def _from_matrix(m) -> np.ndarray:
    return np.asarray(m.value, dtype=np.float32).reshape(tuple(m.dim))


class PredictService:
    """The Predict and Generate handlers over one model of the port."""

    def __init__(
        self, model, decode_dtype=None, decode_quant=None,
        inflight_slots=None, inflight_chunk: int = 8, inflight_top_k=None,
        paged_blocks=None, block_size: int = 16,
        draft_model=None, spec_gamma: int = 4,
    ):
        """``decode_dtype`` (a torch dtype) and ``decode_quant`` (None,
        "int8", "w8a8") configure Generate's decoders; Predict runs the
        model as it is.

        ``inflight_slots=N`` serves Generate through one shared
        ``models.InflightEngine`` of N slots (``inflight_chunk``,
        ``inflight_top_k``, ``paged_blocks``, ``block_size``): concurrent
        calls, and each row of a call, join one running batch.  A sampling
        request whose ``top_k`` is not the engine's goes to the one-shot
        decoder, and the engine's sampling stream is shared (a request's
        ``seed`` does not replay it).

        ``draft_model`` serves Generate speculatively
        (``models.SpeculativeDecoder``, ``spec_gamma`` proposals a round)
        when no engine is configured; requests with ``top_k`` or ``top_p``
        go to the one-shot decoder."""
        from ..jit import CompiledEvalStep
        from ..onnx import OnnxModel

        self._model = model
        self._decoder = None
        self._decode_dtype = decode_dtype
        self._decode_quant = decode_quant
        self._engine = None
        self._inflight_slots = inflight_slots
        self._inflight_chunk = inflight_chunk
        self._inflight_top_k = inflight_top_k
        self._paged_blocks = paged_blocks
        self._block_size = block_size
        self._draft_model = draft_model
        self._spec_gamma = spec_gamma
        self._spec = None
        self._prefixes: list = []
        # an ONNX file runs in the port's runtime; a model through its forward
        self._step = model if isinstance(model, OnnxModel) else CompiledEvalStep(model)
        self._make = threading.Lock()  # concurrent calls make each decoder once

    def register_prefix(self, tokens) -> None:
        """A shared prompt prefix (a system prompt) for the in-flight
        Generate route (``InflightEngine.register_prefix``); kept for an
        engine made later."""
        self._prefixes.append(np.asarray(tokens))
        if self._engine is not None:
            self._engine.register_prefix(self._prefixes[-1])

    def predict(self, request, context=None):
        outs = []
        for m in request.matrix:
            y = self._step(_from_matrix(m))
            if isinstance(y, torch.Tensor):
                y = y.detach().float().cpu().numpy()
            outs.append(_to_matrix(y))
        resp = serving_pb2.PredictResp()
        resp.matrix.extend(outs)
        return resp

    def generate(self, request, context=None):
        """matrix[0] the (B, L) prompt ids, matrix[1] [new_tokens], and
        optionally matrix[2] [temperature, top_k, top_p, seed] (0 turns
        each off; no matrix[2] or temperature 0 is greedy).  Answers
        matrix[0] = (B, L + new_tokens) tokens.  A ``Seq2SeqTransformer``
        reads matrix[0] as the (B, Ls) source, decodes greedily from the
        bos_id in the knobs' fourth slot (0 without), and answers the
        (B, new_tokens) target alone."""
        from ..models.decoding import KVCacheDecoder
        from ..models.llama import LlamaLM
        from ..models.mixtral import MixtralLM
        from ..models.seq2seq import Seq2SeqTransformer
        from ..models.transformer_lm import TransformerLM

        if isinstance(self._model, Seq2SeqTransformer):
            return self._generate_seq2seq(request)
        if not isinstance(self._model, (TransformerLM, LlamaLM, MixtralLM)):
            raise ValueError(
                "Generate is served for TransformerLM, LlamaLM, MixtralLM and "
                f"Seq2SeqTransformer models; got {type(self._model).__name__}")
        with self._make:
            if self._decoder is None:
                self._decoder = KVCacheDecoder(self._model, compute_dtype=self._decode_dtype,
                                               quant=self._decode_quant)
        prompt = _from_matrix(request.matrix[0]).astype(np.int64)
        new_tokens = int(_from_matrix(request.matrix[1]).ravel()[0])
        sample_kw = {}
        if len(request.matrix) > 2:
            knobs = _from_matrix(request.matrix[2]).ravel()
            temperature, top_k, top_p, seed = (list(knobs) + [0.0] * 4)[:4]
            sample_kw = dict(
                temperature=float(temperature),
                top_k=int(top_k) if top_k > 0 else None,
                top_p=float(top_p) if top_p > 0 else None,
                seed=int(seed),
            )
        tokens = self._engine_generate(prompt, new_tokens, sample_kw)
        if tokens is None:
            tokens = self._speculative_generate(prompt, new_tokens, sample_kw)
        if tokens is None:
            tokens = self._decoder.generate(prompt, new_tokens, **sample_kw)
        resp = serving_pb2.PredictResp()
        resp.matrix.extend([_to_matrix(tokens.astype(np.float32))])
        return resp

    def _generate_seq2seq(self, request):
        """The encoder-decoder route: greedy only, the generator in
        ``decode_dtype``."""
        from ..models.seq2seq import Seq2SeqGenerator

        with self._make:
            if self._decoder is None:
                self._decoder = Seq2SeqGenerator(self._model, compute_dtype=self._decode_dtype)
        src = _from_matrix(request.matrix[0]).astype(np.int64)
        new_tokens = int(_from_matrix(request.matrix[1]).ravel()[0])
        knobs = _from_matrix(request.matrix[2]).ravel() if len(request.matrix) > 2 else ()
        bos = int(knobs[3]) if len(knobs) > 3 else 0
        tokens = self._decoder.generate(src, new_tokens, bos_id=bos)
        resp = serving_pb2.PredictResp()
        resp.matrix.extend([_to_matrix(tokens.astype(np.float32))])
        return resp

    def _speculative_generate(self, prompt, new_tokens, sample_kw):
        """Generate through the speculative decoder when a draft is
        configured and the request has no top-k or top-p; None otherwise."""
        if self._draft_model is None or new_tokens < 1:
            return None
        if sample_kw.get("top_k") or sample_kw.get("top_p"):
            return None
        with self._make:
            if self._spec is None:
                from ..models.speculative import SpeculativeDecoder

                self._spec = SpeculativeDecoder(
                    self._model, self._draft_model, gamma=self._spec_gamma,
                    compute_dtype=self._decode_dtype, quant=self._decode_quant)
        return self._spec.generate(prompt, new_tokens,
                                   temperature=sample_kw.get("temperature", 0.0),
                                   seed=sample_kw.get("seed", 0))

    def _engine_generate(self, prompt, new_tokens, sample_kw):
        """Generate through the shared in-flight engine, one engine request
        a prompt row, when one is configured and the request suits it; None
        otherwise."""
        if self._inflight_slots is None or new_tokens < 1:
            return None
        temperature = sample_kw.get("temperature", 0.0)
        if temperature > 0.0 and sample_kw.get("top_k") != self._inflight_top_k:
            return None  # the engine's top_k is fixed
        with self._make:
            if self._engine is None:
                from ..models.engine import InflightEngine

                self._engine = InflightEngine(
                    self._model, slots=self._inflight_slots, chunk=self._inflight_chunk,
                    top_k=self._inflight_top_k, compute_dtype=self._decode_dtype,
                    quant=self._decode_quant, paged_blocks=self._paged_blocks,
                    block_size=self._block_size)
                for pfx in self._prefixes:
                    self._engine.register_prefix(pfx)
        handles = [self._engine.submit(row, new_tokens, temperature=temperature,
                                       top_p=sample_kw.get("top_p"))
                   for row in prompt]
        # no eos on this call, so every row has the same length
        return np.stack([h.result(timeout=600) for h in handles])


class MyDLPWServicer:
    """The gRPC server: construct with a host:port and a model of the port,
    then ``serve()``."""

    def __init__(
        self,
        host: str,
        model=None,
        root_dir: Optional[str] = None,
        model_file: Optional[str] = None,
        model_name: Optional[str] = None,
        num_classes: int = 1000,
        max_workers: int = 10,
        decode_dtype=None,
        decode_quant=None,
        inflight_slots=None,
        inflight_chunk: int = 8,
        inflight_top_k=None,
        paged_blocks=None,
        block_size: int = 16,
        draft_model=None,
        spec_gamma: int = 4,
        device=None,
    ):
        """Serve ``model`` as it is, or a model file (``root_dir`` and
        ``model_file``) on ``device`` (the card by default): an ``.onnx``
        graph (either package's exporter, or a foreign file within the op
        set) runs in the port's ONNX runtime (``onnx.OnnxModel``), with no
        model class needed, as the reference ran onnxruntime here; a
        checkpoint (``*.pkl``, ``utils.save_checkpoint`` of either package)
        is loaded with ``strict=False`` into the zoo model ``model_name``
        (``num_classes`` wide)."""
        import grpc

        if model is None and model_file is not None and str(model_file).endswith(".onnx"):
            from ..onnx import OnnxModel

            model = OnnxModel(os.path.join(root_dir or ".", model_file), device=device)
        if model is None and model_file is not None:
            from ..utils.model_utils import load_checkpoint
            from ..utils.pretrained_models import _build_model

            if model_name is None:
                raise ValueError("model_name required to serve from a checkpoint")
            model = _build_model(model_name, num_classes=num_classes, device=device)
            load_checkpoint(model, None, os.path.join(root_dir or ".", model_file),
                            strict=False)
        if model is None:
            raise ValueError("pass a deepflows_tpu_torch model to serve")
        self.host = host
        self._service = PredictService(
            model, decode_dtype=decode_dtype, decode_quant=decode_quant,
            inflight_slots=inflight_slots, inflight_chunk=inflight_chunk,
            inflight_top_k=inflight_top_k, paged_blocks=paged_blocks, block_size=block_size,
            draft_model=draft_model, spec_gamma=spec_gamma)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                                   options=_GRPC_OPTIONS)
        handler = grpc.method_handlers_generic_handler(_SERVICE, {
            name: grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=serving_pb2.PredictReq.FromString,
                response_serializer=serving_pb2.PredictResp.SerializeToString,
            )
            for name, fn in (("Predict", self._service.predict),
                             ("Generate", self._service.generate))
        })
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(host)  # the bound port (host ":0" picks one)

    def serve(self, wait: bool = True):
        self._server.start()
        if wait:
            self._server.wait_for_termination()
        return self._server

    def stop(self, grace: float = 0.5):
        self._server.stop(grace).wait()
        if self._service._engine is not None:
            self._service._engine.close()
            self._service._engine = None


class PredictClient:
    """The client stub."""

    def __init__(self, host: str):
        import grpc

        self._channel = grpc.insecure_channel(host, options=_GRPC_OPTIONS)
        self._call, self._generate_call = (
            self._channel.unary_unary(
                f"/{_SERVICE}/{name}",
                request_serializer=serving_pb2.PredictReq.SerializeToString,
                response_deserializer=serving_pb2.PredictResp.FromString,
            )
            for name in ("Predict", "Generate")
        )

    def predict(self, *arrays: np.ndarray):
        req = serving_pb2.PredictReq()
        req.matrix.extend(_to_matrix(a) for a in arrays)
        return [_from_matrix(m) for m in self._call(req).matrix]

    def generate(self, prompt: np.ndarray, new_tokens: int, temperature: float = 0.0,
                 top_k=None, top_p=None, seed: int = 0) -> np.ndarray:
        """Server-side decoding: (B, L) int prompt -> (B, L + new_tokens)
        int tokens; greedy at ``temperature=0``, else sampled with
        ``top_k``, ``top_p`` and ``seed`` (the knobs ride a third Matrix).
        A server of a ``Seq2SeqTransformer`` answers the (B, new_tokens)
        target and reads ``seed``'s slot as its bos_id."""
        req = serving_pb2.PredictReq()
        mats = [_to_matrix(np.asarray(prompt, np.float32)),
                _to_matrix(np.asarray([new_tokens], np.float32))]
        if (temperature and temperature > 0.0) or seed:
            # the knobs ride float32: an int past 2^24 would arrive rounded
            for name, val in (("seed", seed), ("top_k", top_k or 0)):
                if abs(int(val)) > 1 << 24:
                    raise ValueError(f"{name}={val} exceeds the float32-exact integer range "
                                     "(2^24) of the Generate wire format")
            mats.append(_to_matrix(np.asarray([temperature, top_k or 0, top_p or 0.0, seed],
                                              np.float32)))
        req.matrix.extend(mats)
        return _from_matrix(self._generate_call(req).matrix[0]).astype(np.int64)

    def close(self):
        self._channel.close()
