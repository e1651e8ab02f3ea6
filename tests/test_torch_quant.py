"""Weight-only int8 (``avsl_tpu_torch/models/quant.py``) against
``avsl_tpu/models/quant.py`` on the CPU.

``quantize_array`` and ``quantize_rows`` are bit for bit JAX's (q and
scale), including JAX's own cases (``tests/test_quant.py``: per-channel
error bound, a zero channel, idempotence). On the tiny Whisper-Flamingo
model with carried weights (tests/torch_serving_fixtures.py), the set of
quantized tensors and their axes equal JAX's ``quantize_tree`` through the
weight carrier, with q and scale bit-equal; ``quantization_report``
counts as JAX's; the int8 model's encoder features and decoder logits are
within 1e-5 relative of JAX's int8 model (both dequantize to bf16 and
compute in fp32); and the int8 transcriber gives JAX's
``StreamingTranscriber(quantize="int8")`` tokens and scores, leaving the
caller's model as it was (JAX's program compiled without XLA's excess
precision, ``strict_bf16``, which otherwise skips the bf16 rounding of
the dequantized weights inside the jit).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.models import quant as jq
from avsl_tpu_torch.models import quant
from avsl_tpu_torch.models.convert import _to_torch_layout, flax_path_to_torch_key
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import (
    assert_same_results,
    carried_models,
    items,
    strict_bf16,
    transcriber_pair,
)

REL_TOL = 1e-5


def _equal(got: quant.QTensor, want):
    """Bit-equal q and scale (``want`` in the port's layout)."""
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("shape,axis", [((64, 128), -1), ((64, 128), 0), ((3, 5, 7, 96), 0),
                                        ((50, 4096), 0), ((2, 3, 4, 5, 70), -1)])
def test_torch_quantize_array_bit_equal_to_jax(shape, axis):
    rng = np.random.default_rng(len(shape) + axis)
    w = rng.normal(size=shape).astype(np.float32)
    w *= np.logspace(-3, 3, shape[axis], dtype=np.float32).reshape(
        [-1 if a == axis % len(shape) else 1 for a in range(len(shape))])
    w.reshape(-1)[::7] = 0.0
    want = jq.quantize_array(jnp.asarray(w), channel_axis=axis)
    got = quant.quantize_array(torch.from_numpy(w), channel_axis=axis)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    _equal(got, (want.q, want.scale))
    np.testing.assert_array_equal(got.dequantize(torch.float32).numpy(),
                                  np.asarray(want.dequantize(jnp.float32)))
    np.testing.assert_array_equal(got.dequantize().float().numpy(),
                                  np.asarray(want.dequantize().astype(jnp.float32)))


def test_torch_quantize_rows_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    x[0, 3] *= 100.0
    x[1, 2, 1] = 0.0
    want = jq.quantize_rows(jnp.asarray(x))
    got = quant.quantize_rows(torch.from_numpy(x))
    assert got.scale.shape == (2, 6, 4, 1)
    _equal(got, (want.q, want.scale))


def test_torch_per_channel_error_bound_and_zero_channel():
    """JAX's cases: each channel within its own half-step; an all-zero
    tensor round-trips to zeros with finite scales."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 128)).astype(np.float32) * np.logspace(-2, 2, 128)[None, :]
    qt = quant.quantize_array(torch.from_numpy(w.astype(np.float32)), channel_axis=-1)
    assert qt.scale.shape == (1, 128)
    err = np.abs(qt.dequantize(torch.float32).numpy() - w)
    assert np.all(err <= qt.scale.numpy() / 2 + 1e-9)
    z = quant.quantize_array(torch.zeros(8, 4096))
    assert torch.all(z.dequantize() == 0) and torch.isfinite(z.scale).all()


def test_torch_predicate_selectivity_and_axes():
    """JAX's predicate on the port's names: kernels per output channel
    (axis 0 here), embeddings per row, AV-HuBERT's learned positions per
    column; biases, gates, norms and small weights stay float."""
    t = torch.ones
    assert quant.default_predicate("decoder.blocks.0.attn.query.weight", t(128, 64))
    assert not quant.default_predicate("decoder.blocks.0.attn.query.bias", t(64))
    assert not quant.default_predicate("decoder.blocks.0.x_attn_gate", t(1))
    assert not quant.default_predicate("decoder.tiny.weight", t(4, 4))
    assert not quant.default_predicate("encoder.pos_conv.0.weight_g", t(4096, 1, 1))
    assert not quant.default_predicate("x.weight", t(128, 64, dtype=torch.int8))
    assert quant.channel_axis("decoder.token_embedding.weight") == 0
    assert quant.channel_axis("decoder.positional_embedding") == 0
    assert quant.channel_axis("decoder.embed_tokens.weight") == 0
    assert quant.channel_axis("decoder.embed_positions.weight") == -1
    assert quant.channel_axis("decoder.blocks.0.mlp.0.weight") == 0


@pytest.fixture(scope="module")
def av():
    """(jax model, variables, port fp32 model, port int8 copy, JAX int8 tree)."""
    jmodel, variables, port = carried_models(av=True, seed=5)
    return jmodel, variables, port, quant.quantize_model(port), jq.quantize_tree(variables)


def _jax_qtensors(qtree):
    """{port key: (q, scale) in the port's layout} for JAX's QTensor leaves."""
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(qtree, is_leaf=lambda x: isinstance(
        x, jq.QTensor))[0]
    for path, leaf in leaves:
        if not isinstance(leaf, jq.QTensor):
            continue
        keys = [str(getattr(k, "key", k)) for k in path]
        assert keys[0] == "params"
        flax_path = "/".join(keys[1:])
        out[flax_path_to_torch_key(flax_path)] = tuple(
            _to_torch_layout(flax_path, np.asarray(x)) for x in (leaf.q, leaf.scale))
    return out


def test_torch_quantized_set_and_axes_equal_jax(av):
    _, _, port, qport, qtree = av
    want = _jax_qtensors(qtree)
    got = quant.quantized_weights(qport)
    assert sorted(got) == sorted(want)
    # every kind of quantized tensor is there: linear, conv, the embedding
    # (the tiny decoder's positions are under 4096 elements)
    names = " ".join(got)
    for part in ("token_embedding", "conv1", "resnet.trunk",
                 "pos_conv.0.weight_v", "x_attn.query", "mlp.0"):
        assert part in names, part
    for name, qt in got.items():
        assert qt.q.shape == dict(port.named_parameters())[name].shape
        _equal(qt, want[name])


def test_torch_quantization_report_counts_equal_jax(av):
    jmodel, variables, port, qport, qtree = av
    want = jq.quantization_report(variables, qtree)
    got = quant.quantization_report(port, qport)
    assert got["n_quantized_leaves"] == want["n_quantized_leaves"]
    # the port also holds the encoder's sinusoid table as a buffer, which
    # JAX recomputes rather than holds
    table = port.encoder.positional_embedding
    extra = table.numel() * table.element_size()
    assert got["bytes_fp32"] - extra == want["bytes_fp32"]
    assert got["bytes_quantized"] - extra == want["bytes_quantized"]
    assert got["bytes_float"] == got["bytes_fp32"]  # the fp32 test model


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_torch_int8_encoder_and_logits_match_jax(av):
    jmodel, variables, port, qport, qtree = av
    rng = np.random.default_rng(2)
    mel = rng.normal(size=(2, 80, 100)).astype(np.float32)
    video = rng.normal(size=(2, 5, 88, 88, 1)).astype(np.float32)
    toks = rng.integers(0, 256, size=(2, 7)).astype(np.int32)
    qv = jq.dequantize_tree(qtree)

    # compiled without XLA's excess precision, as strict_bf16 does: with it
    # the jitted tower skips roundings the eager port makes (5e-4 on xv)
    @jax.jit
    def run(v, mel, video, toks):
        feats, xv = jmodel.apply(v, mel, video, method=jmodel.encode)
        return feats, xv, jmodel.apply(v, toks, feats, xv, method=jmodel.decode)[0]

    jfeats, jxv, jlogits = run.lower(qv, mel, video, toks).compile(
        compiler_options={"xla_allow_excess_precision": False})(qv, mel, video, toks)
    with torch.no_grad():
        feats, xv = qport.encode(torch.from_numpy(mel), torch.from_numpy(video))
        logits, _ = qport.decode(torch.from_numpy(toks.astype(np.int64)), feats, xv)
        float_logits, _ = port.decode(torch.from_numpy(toks.astype(np.int64)),
                                      *port.encode(torch.from_numpy(mel),
                                                   torch.from_numpy(video)))
    assert _rel(feats, jfeats) < REL_TOL
    assert _rel(xv, jxv) < REL_TOL
    assert _rel(logits, jlogits) < REL_TOL
    assert _rel(logits, float_logits) > 1e-4  # the int8 weights are what ran


def test_torch_int8_transcriber_matches_jax_and_leaves_the_model():
    models = carried_models(av=True, seed=6, logit_scale=4.0)
    port = models[2]
    before = {k: v.clone() for k, v in port.state_dict().items()}
    params = dict(port.named_parameters())
    jtr, ptr = transcriber_pair(models, quantize="int8", batch_size=2, max_new_tokens=6)
    strict_bf16(jtr)
    batch = items(3, seed=4)
    batch[0]["lip_feats"] = np.random.default_rng(0).normal(size=(20, 88, 88, 1)).astype(
        np.float32)
    assert_same_results(jtr.transcribe(batch), ptr.transcribe(batch))
    assert ptr.quantize == "int8" and ptr.model is not port
    assert dict(port.named_parameters()) == params and not any(
        hasattr(m, "parametrizations") for m in port.modules())
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert quant.tree_bytes(ptr.model) < 0.55 * quant.tree_bytes(port)
    # the int8 copy shares every tensor it did not quantize with the model
    shared = {id(t) for t in port.parameters()}
    assert ptr.model.decoder.ln.weight is port.decoder.ln.weight
    assert sum(id(t) in shared for t in ptr.model.parameters()) == sum(
        1 for _ in ptr.model.parameters())


def test_torch_quantize_model_is_idempotent_and_takes_fp32_weights():
    """A second pass leaves the int8 weights as they are (JAX's guard);
    ``weights`` (an fp32 state dict) is what gets quantized, not the
    model's own copy of it."""
    _, variables, port = carried_models(av=False, seed=7)
    q1 = quant.quantize_model(port)
    q2 = quant.quantize_model(q1)
    w1, w2 = quant.quantized_weights(q1), quant.quantized_weights(q2)
    assert sorted(w1) == sorted(w2) and all(w1[k].q is w2[k].q for k in w1)
    bf16 = {k: v.to(torch.bfloat16).float() for k, v in port.state_dict().items()}
    from_bf16 = quant.quantized_weights(quant.quantize_model(port, bf16))
    from_fp32 = quant.quantized_weights(quant.quantize_model(port, port.state_dict()))
    assert all(torch.equal(from_fp32[k].q, w1[k].q) for k in w1)
    assert any(not torch.equal(from_bf16[k].scale, w1[k].scale) for k in w1)
    with pytest.raises(ValueError, match="weights give"):
        quant.quantize_model(port, {"decoder.token_embedding.weight": torch.zeros(3, 3)})
