"""paddle_tpu_torch's public signatures against paddle_tpu's.

A call written for paddle_tpu must bind the same way in the port: the
same parameter names in the same order (a positional argument means the
same thing in both), with only the port's trailing ``device`` beyond
them; ``GPTConfig`` has the same fields with the same defaults. What the
port does not implement raises NotImplementedError naming ROADMAP.md at a
non-default value, instead of being dropped silently (the engine's such
options: tests/test_torch_port_engine.py).
"""
import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

from paddle_tpu import jit as jjit
from paddle_tpu.inference import predictor as jpred
from paddle_tpu import distributed as jdist
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.models import scanned as jscanned
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu.inference import serve as jserve
from paddle_tpu.inference.engine import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu import nn as jnn
from paddle_tpu import obs as jobs
from paddle_tpu.distributed import resilience as jresil
from paddle_tpu.framework import env as jenv
from paddle_tpu.inference import engine as jengine
from paddle_tpu.nn import functional as jF
from paddle_tpu.nn.functional import activation as jact
from paddle_tpu.nn.functional import common as jcommon
from paddle_tpu.nn import utils as jutils
from paddle_tpu import optimizer as joptim
import paddle_tpu as jpkg
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.inference import predictor as tpred
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.models import scanned as tscanned
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.inference import serve as tserve
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.distributed import resilience as tresil
from paddle_tpu_torch.framework import env as tenv
from paddle_tpu_torch.inference import engine as tengine
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.nn.functional import activation as tact
from paddle_tpu_torch.nn.functional import common as tcommon
from paddle_tpu_torch.nn import utils as tutils
from paddle_tpu_torch import optimizer as toptim
import paddle_tpu_torch as tpkg

# both packages re-export a flash_attention function under the module's name
jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")


def _attr(mod, dotted):
    obj = mod
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


# (port module, reference module, dotted name): the nn bindings (C8), the
# serving tier's engine and server surface, obs, resilience and the router
_NAMES = [(tF, jF, n) for n in ("layer_norm", "cross_entropy")] + [
    (tnn, jnn, n) for n in ("Linear.__init__", "Embedding.__init__",
                            "Embedding.forward", "LayerNorm.__init__",
                            "RMSNorm.__init__")] + [
    (tserve, jserve, n) for n in (
        "PredictorServer.start", "PredictorServer.stop",
        "PredictorServer.begin_drain", "PredictorServer.inflight",
        "send_json", "send_text", "handle_admin_trace", "main")] + [
    (tengine, jengine, n) for n in (
        "ContinuousBatchingEngine.submit", "ContinuousBatchingEngine.cancel",
        "ContinuousBatchingEngine.warmup", "ContinuousBatchingEngine.stats",
        "GenerationPredictor.__init__", "GenerationPredictor.generate",
        "create_engine_predictor")] + [
    (tpred, jpred, "Config.enable_continuous_batching"),
    (tenv, jenv, "bool_env")] + [
    (tobs, jobs, n) for n in (
        "enabled", "set_enabled", "span", "record_span", "dump_flight",
        "make_lock", "make_rlock", "make_condition", "set_lock_san",
        "metrics.Registry.counter", "metrics.Registry.gauge",
        "metrics.Registry.histogram", "metrics.Registry.render",
        "metrics.Counter.inc", "metrics.Gauge.set",
        "metrics.Histogram.observe",
        "metrics.Histogram.snap", "metrics.HistSnap.percentile",
        "metrics.parse_text", "metrics.percentile_from_cum",
        "metrics.samples_to_hist", "metrics.render_tier",
        "trace.FlightRecorder.record", "trace.begin_span", "trace.end_span",
        "trace.export_chrome", "trace.artifact_dir",
        "efficiency.chip_spec", "efficiency.mfu",
        "efficiency.model_bandwidth_eff", "efficiency.modeled_tick_bytes",
        "efficiency.train_step_flops", "efficiency.tree_nbytes")] + [
    (tresil, jresil, n) for n in (
        "maybe_inject", "should_fire", "wedge_seconds", "arm_fault",
        "_parse_spec", "FaultInjector.__init__", "RetryPolicy.__init__",
        "RetryPolicy.from_env", "RetryPolicy.delay", "RetryPolicy.sleep",
        "RetryPolicy.run", "with_retries")] + [
    (trouter, jrouter, n) for n in (
        "Router.__init__", "Router.start", "Router.wait_ready",
        "Router.stop", "Router.rolling_restart", "Router.forward_generate",
        "Router.replicas", "Router.stats", "Router.render_metrics",
        "ReplicaSpec.__init__", "ReplicaSpec.argv", "Replica.__init__",
        "RespawnGovernor.__init__", "RespawnGovernor.note_death",
        "single_device_child_env", "main")] + [
    # draft-model speculation and the training memory features
    (tspec, jspec, n) for n in (
        "resolve_speculative", "DraftModelProposer.__init__",
        "DraftModelProposer.admit", "DraftModelProposer.propose")] + [
    (tdist, jdist, n) for n in ("recompute", "recompute_sequential")] + [
    (tscanned, jscanned, n) for n in (
        "ScannedStack.__init__", "ScannedStack.load_from_blocks",
        "ScannedStack.forward", "ScannedStack.forward_cached",
        "ScannedStack.reject_dropout")] + [
    (tF, jF, "fused_linear_cross_entropy"),
    (tgpt, jgpt, "GPTForCausalLM.fused_loss_fn"),
    (tllama, jllama, "LlamaForCausalLM.fused_loss_fn"),
    (tgen, jgen, "new_kv_caches"), (tgen, jgen, "new_paged_kv_caches")] + [
    # C10's five reference calls
    (tfa, jfa, "paged_kv_cache"), (tfa, jfa, "quantized_kv_cache"),
    (toptim, joptim, "Adam.__init__"), (toptim, joptim, "AdamW.__init__"),
    (tpred, jpred, "Config.enable_tpu"), (tobs, jobs, "trace.capture")] + [
    # the Layer system: Layer's methods, ParamAttr, the initializers
    (tnn, jnn, f"Layer.{n}") for n in (
        "__init__", "create_parameter", "add_parameter", "add_sublayer",
        "register_buffer", "sublayers", "named_sublayers", "parameters",
        "named_parameters", "astype", "to", "float", "bfloat16", "half",
        "state_dict", "set_state_dict", "set_dict", "load_dict",
        "register_forward_pre_hook", "register_forward_post_hook",
        "full_name", "clear_gradients", "extra_repr")] + [
    (tnn, jnn, "ParamAttr.__init__")] + [
    (tnn, jnn, f"initializer.{n}") for n in (
        "Constant.__init__", "Normal.__init__", "TruncatedNormal.__init__",
        "Uniform.__init__", "XavierNormal.__init__",
        "XavierUniform.__init__", "KaimingNormal.__init__",
        "KaimingUniform.__init__", "Assign.__init__", "Orthogonal.__init__",
        "Dirac.__init__", "Bilinear.__init__", "Initializer.__call__",
        "calculate_gain", "set_global_initializer")] + [
    # the containers and the transformer layers
    (tnn, jnn, n) for n in (
        "Sequential.__init__", "Sequential.forward", "LayerList.__init__",
        "LayerList.append", "LayerList.insert", "LayerList.extend",
        "ParameterList.__init__", "ParameterList.append",
        "LayerDict.__init__", "LayerDict.update", "LayerDict.pop",
        "MultiHeadAttention.__init__", "MultiHeadAttention.forward",
        "MultiHeadAttention.gen_cache", "TransformerEncoderLayer.__init__",
        "TransformerEncoderLayer.forward",
        "TransformerEncoderLayer.gen_cache", "TransformerEncoder.__init__",
        "TransformerEncoder.forward", "TransformerEncoder.gen_cache",
        "TransformerDecoderLayer.__init__", "TransformerDecoderLayer.forward",
        "TransformerDecoderLayer.gen_cache", "TransformerDecoder.__init__",
        "TransformerDecoder.forward", "TransformerDecoder.gen_cache",
        "Transformer.__init__", "Transformer.forward",
        "Transformer.generate_square_subsequent_mask")] + [
    # the activation layers and functionals
    (tnn, jnn, f"{n}.__init__") for n in jnn.layer.activation.__all__] + [
    (tact, jact, n) for n in jact.__all__] + [
    (tutils, jutils, n) for n in jutils.__all__] + [
    (tfa, jfa, "flash_attn_unpadded"), (tfa, jfa, "sdp_kernel.__init__"),
    (tpkg, jpkg, "save"), (tpkg, jpkg, "load"),
    (tpkg, jpkg, "set_device"), (tpkg, jpkg, "get_device")]


def test_capture_takes_a_torch_profile_flag():
    """``capture`` takes paddle_tpu's names: its device-profiler flag is
    ``jax_profile`` in both, in the same place (the port runs
    ``torch.profiler`` under it)."""
    got = list(inspect.signature(tobs.trace.capture).parameters)
    want = list(inspect.signature(jobs.trace.capture).parameters)
    assert want == ["duration_s", "jax_profile"]
    assert got == want


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_gpt_config_fields_match_reference():
    assert _fields(GPTConfig) == _fields(JaxGPTConfig)
    assert GPTConfig(moe_experts=4).moe_experts == 4
    assert GPTConfig(recompute_policy="dots").recompute_policy == "dots"


@pytest.mark.parametrize("port,ref", [
    (tfa.flash_attention, jfa.flash_attention),
    (tfa.scaled_dot_product_attention, jfa.scaled_dot_product_attention),
    (tgen.generate, jgen.generate),
    (ContinuousBatchingEngine.__init__, JaxEngine.__init__),
    (tserve.PredictorServer.__init__, jserve.PredictorServer.__init__),
    (tpred.Config.__init__, jpred.Config.__init__),
    (tpred.create_predictor, jpred.create_predictor),
    (tjit.save, jjit.save),
    (tjit.InputSpec.__init__, jjit.InputSpec.__init__),
    (tcommon.dropout, jcommon.dropout),
    (tact.gelu, jact.gelu)] + [
    (_attr(tmod, name), _attr(jmod, name)) for tmod, jmod, name in _NAMES],
    ids=["flash_attention", "scaled_dot_product_attention", "generate",
         "ContinuousBatchingEngine", "PredictorServer", "Config",
         "create_predictor", "jit.save", "InputSpec", "dropout", "gelu"] + [
         name for _, _, name in _NAMES])
def test_signature_matches_reference(port, ref):
    got = list(inspect.signature(port).parameters)
    want = list(inspect.signature(ref).parameters)
    if got[-1:] == ["device"] and want[-1:] != ["device"]:
        got = got[:-1]
    got = [n for n in got if n not in _module_keywords(port)]
    assert got == want


def _module_keywords(port):
    """The keyword-only parameters that a ``Layer`` method takes beyond
    paddle's, named as ``torch.nn.Module``'s method of the same name names
    them (torch's own callers pass them: ``functional_call`` passes
    ``named_parameters(remove_duplicate=False)``). After paddle's
    parameters and keyword-only, they change no binding of a paddle call.
    Empty for anything but a ``Layer`` method."""
    name = getattr(port, "__name__", "")
    if getattr(tnn.Layer, name, None) is not port or \
            not hasattr(torch.nn.Module, name):
        return set()
    module = set(inspect.signature(getattr(torch.nn.Module, name)).parameters)
    return {n for n, p in inspect.signature(port).parameters.items()
            if p.kind is p.KEYWORD_ONLY and n in module}


def test_c10_reference_calls_run_in_the_port():
    """The five calls that raised in the port, each with paddle_tpu's own
    arguments: the cache constructors take the reference's dtype strings
    and resolve their device as every entry point does (the card when
    omitted: on a machine without one they raise naming CUDA); Adam and
    AdamW ignore paddle's extra keywords; ``Config.enable_tpu`` selects
    the card; ``capture`` takes ``jax_profile``."""
    for call in (lambda **kw: tfa.paged_kv_cache(4, 8, 2, 16,
                                                 dtype="bfloat16", **kw),
                 lambda **kw: tfa.quantized_kv_cache(2, 8, 2, 16, **kw)):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
        assert call(device="cpu")
    pool = tfa.paged_kv_cache(4, 8, 2, 16, device="cpu")
    assert pool["pages"].dtype == torch.bfloat16
    assert tuple(pool["pages"].shape) == (4, 8, 2, 16)
    assert tfa.paged_kv_cache(4, 8, 2, 16, "float32", device="cpu")[
        "pages"].dtype == torch.float32
    i8 = tfa.paged_kv_cache(4, 8, 2, 16, "int8", device="cpu")
    assert i8["pages"].dtype == torch.int8 and i8["scale"].shape == (4, 8, 2)
    q8 = tfa.quantized_kv_cache(2, 8, 2, 16, device="cpu")
    assert q8["data"].dtype == torch.int8 and q8["scale"].shape == (2, 8, 2)
    params = [torch.nn.Parameter(torch.ones(3))]
    for cls in (toptim.Adam, toptim.AdamW):
        opt = cls(learning_rate=0.1, parameters=params,
                  use_multi_tensor=True)
        params[0].grad = torch.ones(3)
        opt.step()
    cfg = tpred.Config()
    cfg.enable_tpu(device_id=0)
    assert cfg.use_gpu() and cfg._device_id == 0
    doc = tobs.trace.capture(0.0, jax_profile=False)
    assert "torch_profile_dir" not in doc["metadata"]


def _qkv():
    rs = np.random.RandomState(0)
    return [torch.from_numpy(rs.randn(1, 8, 1, 4).astype(np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("kw", [{"fixed_seed_offset": 3},
                                {"rng_name": "local_seed"}])
def test_flash_attention_dropout_seeds_are_ignored(kw):
    """paddle_tpu takes ``fixed_seed_offset`` and ``rng_name`` and reads
    neither; so does the port: the result is the same bit for bit."""
    q, k, v = _qkv()
    want = tfa.flash_attention(q, k, v, causal=True)[0]
    torch.testing.assert_close(
        tfa.flash_attention(q, k, v, causal=True, **kw)[0], want, rtol=0,
        atol=0)


def test_attention_name_is_ignored():
    q, k, v = _qkv()
    want = tfa.flash_attention(q, k, v, causal=True)[0]
    torch.testing.assert_close(
        tfa.flash_attention(q, k, v, causal=True, name="attn")[0], want,
        rtol=0, atol=0)
    torch.testing.assert_close(
        tfa.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         name="attn"), want, rtol=0, atol=0)
