"""Pipeline-parallel training of the port (``train/pp.py``) against the JAX
package, on 4 gloo ranks (data 2 x stage 2) on the CPU.

Every case of ``tests/test_pp_train.py``:

* the tiny Whisper encoder (d 16, 2 heads, 4 blocks, fp32) with its
  blocks pipelined through ``whisper_encoder_pp_forward`` against JAX's
  ``WhisperEncoder.apply`` on the same flax weights (1e-5), the stem keys
  ``{conv1, conv2, ln_post}``;
* one full Adam step of JAX's sandwich (embed -> 4 blocks -> mean-pooled
  head, vocabulary 11, a batch of 8 x 6 tokens, 2 microbatches) through
  ``shard_pp_state``, ``ClippedAdamW`` (weight decay 0, a constant 1e-2,
  no clip) and ``make_train_step``, against JAX's unpipelined
  ``make_train_step`` with ``optax.adam(1e-2)``: the loss (rtol 1e-5) and
  every updated tensor (rtol 1e-4, atol 1e-6);
* the placement: each stage rank holds its rows of the blocks and of
  their Adam moments, the embedding and the head whole;
* 5 steps at 3e-2 bring the loss under 0.7 of the first.

Added for the port's design: the step's ``grad_norm`` (the block slices'
squared sums added over the stage group) equals the unpipelined one
(JAX's, rtol 1e-5), and the checkpoint ``save_checkpoint`` writes of the
pp state after the step is the whole logical state: unstacked, it equals
JAX's unpipelined state after the same step (rtol 1e-4, atol 1e-6) and the
ranks' gathered tensors bit for bit.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avsl_tpu.core.config import WhisperConfig as JaxWhisperConfig
from avsl_tpu.core.pipeline import stack_block_params as jax_stack_block_params
from avsl_tpu.core.pipeline import unstack_block_params as jax_unstack_block_params
from avsl_tpu.models.layers import TransformerBlock as JaxBlock
from avsl_tpu.models.whisper import WhisperEncoder as JaxWhisperEncoder
from avsl_tpu.train.loop import TrainState as JaxTrainState
from avsl_tpu.train.loop import make_train_step as jax_make_train_step
from avsl_tpu_torch.core.pipeline import _flat, _nest, unstack_block_params
from avsl_tpu_torch.models.convert import flax_path_to_torch_key, state_dict_from_flax
from avsl_tpu_torch.models.layers import sinusoid_embedding
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_mesh_workers import pp_train_ranks, spawn

L, D, H, FF, T, V = 4, 16, 2, 32, 6, 11
ENC_CFG = dict(name="test", n_mels=8, n_audio_ctx=32, n_audio_state=D, n_audio_head=H,
               n_audio_layer=L, dtype="float32")
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _block_key(path: str) -> str:
    return flax_path_to_torch_key("encoder/block_0/" + path)[len("encoder.blocks.0."):]


def _port_state(params) -> dict:
    """JAX's sandwich params -> the port's ``PPSandwich`` arrays by key."""
    per_layer = jax_unstack_block_params(params["blocks"], L)
    layers = [state_dict_from_flax(per_layer[f"block_{i}"], key_fn=_block_key) for i in range(L)]
    out = {f"blocks.{k}": np.stack([layer[k].numpy() for layer in layers]) for k in layers[0]}
    out.update(embed=np.asarray(params["embed"]), head=np.asarray(params["head"]))
    return out


def _sandwich(key):
    """JAX's ``_sandwich``: embed -> L blocks -> mean-pool head."""
    import flax.linen as nn

    ke, kb, kh = jax.random.split(key, 3)

    class Stack(nn.Module):
        @nn.compact
        def __call__(self, x):
            for i in range(L):
                x, _ = JaxBlock(d_model=D, n_heads=H, d_ff=FF, dtype=jnp.float32,
                                param_dtype=jnp.float32, name=f"block_{i}")(x)
            return x

    stack = Stack()
    block_params = stack.init(kb, jnp.zeros((1, T, D), jnp.float32))["params"]
    stacked, _ = jax_stack_block_params(block_params, L)
    params = {"embed": jax.random.normal(ke, (V, D), jnp.float32) * 0.1, "blocks": stacked,
              "head": jax.random.normal(kh, (D, V), jnp.float32) * 0.1}
    return params, stack


def _batch(rng):
    return {"tokens": rng.integers(0, V, size=(8, T)), "labels": rng.integers(0, V, size=(8,))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's references and the 4 ranks' results."""
    tmp = tmp_path_factory.mktemp("pp_train")
    cfg = JaxWhisperConfig(**ENC_CFG)
    enc = JaxWhisperEncoder(cfg)
    mel = np.random.default_rng(0).normal(size=(4, cfg.n_mels, 2 * T)).astype(np.float32)
    enc_params = enc.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"]
    sd = state_dict_from_flax(enc_params,
                              key_fn=lambda p: flax_path_to_torch_key("encoder/" + p)[8:])
    sd["positional_embedding"] = torch.from_numpy(sinusoid_embedding(32, D))
    enc_path = str(tmp / "encoder.pt")
    torch.save(sd, enc_path)

    params, stack = _sandwich(jax.random.PRNGKey(0))
    batch = _batch(np.random.default_rng(1))
    learn_params, _ = _sandwich(jax.random.PRNGKey(3))
    learn_batch = _batch(np.random.default_rng(4))
    ckpt = str(tmp / "ckpt")
    pool = ThreadPoolExecutor(1)  # the ranks run while JAX computes its references
    ranks = pool.submit(spawn, pp_train_ranks, 4, tmp, H, (enc_path, ENC_CFG, mel),
                        (_port_state(params), H, batch),
                        (_port_state(learn_params), H, learn_batch), ckpt)
    pool.shutdown(wait=False)

    want_enc = np.asarray(enc.apply({"params": enc_params}, jnp.asarray(mel)))
    tx = optax.adam(1e-2)

    def seq_loss(p, _stats, b, _rng):
        bp = jax_unstack_block_params(p["blocks"], L)
        h = stack.apply({"params": bp}, p["embed"][b["tokens"]])
        logits = jnp.mean(h, axis=1) @ p["head"]
        loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, b["labels"]))
        return loss, ({}, None)

    step = jax_make_train_step(seq_loss, tx, donate=False)
    state, metrics = step(JaxTrainState.create(params, tx),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    ranks = ranks.result()
    saved = torch.load(os.path.join(ckpt, "step_1.pt"), weights_only=True)
    return {"ranks": ranks, "encoder": want_enc, "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "params": _port_state(state.params),
            "saved": saved}


def test_torch_pp_encoder_matches_module(run):
    want = run["encoder"]
    for r in run["ranks"]:
        assert r["encoder"]["stem"] == ["conv1", "conv2", "ln_post"]
        d = r["data_rank"]
        np.testing.assert_allclose(r["encoder"]["y"], want[2 * d:2 * (d + 1)], **FWD_TOL,
                                   err_msg=f"data {d} stage {r['stage_rank']}")


def test_torch_pp_train_step_matches_unpipelined(run):
    assert [r["mesh"] for r in run["ranks"]] == [{"data": 2, "stage": 2}] * 4
    for r in run["ranks"]:
        step = r["step"]
        np.testing.assert_allclose(step["loss"][0], run["loss"], rtol=1e-5)
        assert sorted(step["whole"]) == sorted(run["params"])
        for name, want in run["params"].items():
            np.testing.assert_allclose(step["whole"][name], want, **PARAM_TOL,
                                       err_msg=f"rank {r['stage_rank']} {name}")


def test_torch_pp_grad_norm_matches_unpipelined(run):
    for r in run["ranks"]:
        np.testing.assert_allclose(r["step"]["grad_norm"][0], run["grad_norm"], rtol=1e-5)


def test_torch_pp_state_places_blocks_on_stage(run):
    for r in run["ranks"]:
        step, s = r["step"], r["stage_rank"]
        assert step["rows"] == (s * L // 2, L // 2)
        assert step["split"] == sorted(n for n in step["local"] if n.startswith("blocks."))
        for name, rec in step["local"].items():
            whole = run["params"][name].shape
            want = (L // 2,) + whole[1:] if name.startswith("blocks.") else whole
            assert rec["shape"] == rec["mu_shape"] == want, name
            assert rec["rows_equal"], name


def test_torch_pp_training_learns(run):
    for r in run["ranks"]:
        losses = r["learn"]["loss"]
        assert losses[-1] < losses[0] * 0.7, losses


def test_torch_pp_checkpoint_equals_unpipelined_state(run):
    model = run["saved"]["model"]
    blocks = unstack_block_params(
        _nest({k[len("blocks."):]: v for k, v in model.items() if k.startswith("blocks.")}), L)
    want = run["params"]
    for i in range(L):
        flat = _flat(blocks[f"block_{i}"])
        assert sorted(flat) == sorted(k[len("blocks."):] for k in want if k.startswith("blocks."))
        for key, t in flat.items():
            np.testing.assert_allclose(t.numpy(), want[f"blocks.{key}"][i], **PARAM_TOL,
                                       err_msg=f"layer {i} {key}")
    for name in ("embed", "head"):
        np.testing.assert_allclose(model[name].numpy(), want[name], **PARAM_TOL)
    gathered = run["ranks"][0]["step"]["whole"]
    for name, t in model.items():
        np.testing.assert_array_equal(t.numpy(), gathered[name], err_msg=name)
    mu = dict(zip(run["saved"]["optimizer"]["names"], run["saved"]["optimizer"]["mu"]))
    assert all(tuple(mu[n].shape) == want[n].shape for n in want)
