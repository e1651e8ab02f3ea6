"""Model and run configuration: Whisper presets, the AV-HuBERT config with
its fairseq-style YAML card loader, the Whisper-Flamingo training/serving
config, the YAML helpers, and the typed default-config registry
(``get_default_config``, ``register_default_config``,
``parse_args_with_config``: registry defaults < YAML < explicit flags).

A copy of the matching parts of ``avsl_tpu/core/config.py`` with the same
fields and defaults (the port may not import the JAX package), and the
port's own ``AutoAVSRConfig`` (Auto-AVSR's audio-visual Conformer, which
the JAX package does not have). PyYAML is
imported inside the YAML helpers only, so importing this module needs
nothing beyond the standard library.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
from dataclasses import dataclass, fields
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# YAML load / save / merge / namespace
# ---------------------------------------------------------------------------


def load_yaml_config(path: str) -> Dict[str, Any]:
    """Load a YAML config file into a plain dict (empty file -> {})."""
    import yaml

    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}
    if not isinstance(cfg, dict):
        raise ValueError(f"Config file {path} must contain a YAML mapping, got {type(cfg)}")
    return cfg


def save_yaml_config(cfg: Any, path: str) -> str:
    """Save a dict / namespace / dataclass config to YAML. Returns the path."""
    import yaml

    cfg = namespace_to_dict(cfg)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, default_flow_style=False, sort_keys=False)
    return path


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (override wins).

    Nested dicts are merged key-by-key; every other type (including lists)
    is replaced wholesale. Neither input is mutated.
    """
    out = copy.deepcopy(base)
    for key, value in (override or {}).items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = merge_configs(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def dict_to_namespace(d: Any) -> Any:
    """Recursively convert dicts to SimpleNamespace (lists traversed too)."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: dict_to_namespace(v) for k, v in d.items()})
    if isinstance(d, (list, tuple)):
        return type(d)(dict_to_namespace(v) for v in d)
    return d


def namespace_to_dict(ns: Any) -> Any:
    """Inverse of :func:`dict_to_namespace`; also handles dataclasses."""
    if isinstance(ns, SimpleNamespace):
        return {k: namespace_to_dict(v) for k, v in vars(ns).items()}
    if dataclasses.is_dataclass(ns) and not isinstance(ns, type):
        return {f.name: namespace_to_dict(getattr(ns, f.name)) for f in fields(ns)}
    if isinstance(ns, dict):
        return {k: namespace_to_dict(v) for k, v in ns.items()}
    if isinstance(ns, (list, tuple)):
        return [namespace_to_dict(v) for v in ns]
    return ns


# ---------------------------------------------------------------------------
# Typed default-config registry
# ---------------------------------------------------------------------------

_WHISPER_FLAMINGO_DEFAULTS: Dict[str, Any] = {
    # Key names match config/ami_whisper_flamingo_large.yaml in the reference.
    "train_name": "whisper_flamingo_ft_ami",
    "train_data_path": "",
    "val_data_path": "",
    "test_data_path": "",
    "audio_max_length": 160000,
    "dataset_audio_max_length": 160000,
    "max_duration_filter_seconds": 10.0,
    "dataset_fraction": 0.0,
    "text_max_length": 350,
    "accelerator": "auto",
    "weight_decay": 0.01,
    "adam_epsilon": 1.0e-8,
    "num_worker": 4,
    "validate_every_n_batches": 1000,
    "num_devices": 1,
    "model_name": "large-v2",
    "learning_rate": 1.0e-5,
    "batch_size": 1,
    "eval_batch_size": 1,
    "num_train_steps": 8000,
    "warmup_steps": 1000,
    "gradient_accumulation_steps": 16,
    "monitor": "val/wer_av",
    "video_model_ckpt": "",
    "freeze_video_model": True,
    "freeze_video_batch_norm_stats": False,
    "spec_augment": "ls-basic",
    "dropout_rate": 0.1,
    "lang": "en",
    "pt_ckpt": "",
    "resume_training": False,
    "train_id": "whisper-flamingo_ft_ami",
    "video_projection_train_only": False,
    "video_projection_separate_lr": "",
    "prob_use_av": 1.0,
    "use_av_hubert_encoder": True,
    "add_gated_x_attn": 1,
    "av_fusion": "separate",
    "log_output_dir": "output/train_whisper_flamingo_ft",
    "check_output_dir": "checkpoints/whisper_flamingo_ft",
    "num_sanity_val_steps": 2,
    "precision": "bf16",  # the JAX package's default (the reference used fp16)
    "reload_dataloaders_every_n_epochs": 1,
    "sync_batchnorm": True,
    "download_root": "models/whisper",
    "enable_gradient_checkpointing": True,
}

_LAUGH_DATASET_DEFAULTS: Dict[str, Any] = {
    "markers_csv": "ami_laugh_markers.csv",
    "output_dir": "data/ami/laughter",
    "audio_dir": "",
    "video_dir": "",
    "sample_rate": 16000,
    "min_duration": 0.05,
    "balance_classes": True,
    "chunk_size": 500,
    "num_workers": 8,
    "resume": True,
    "extract_lips": True,
    "lip_size": 96,
    "fps": 25,
}

_PREPROCESS_DEFAULTS: Dict[str, Any] = {
    "ami_root": "",
    "annotations_dir": "",
    "output_dir": "data/ami",
    "sample_rate": 16000,
    "fps": 25,
    "min_segment_seconds": 0.1,
    "lip_size": 96,
    "crop_size": 88,
    "num_workers": 8,
    "chunk_size": 1000,
    "resume": True,
}

_CONFIG_REGISTRY: Dict[str, Dict[str, Any]] = {
    "whisper_flamingo": _WHISPER_FLAMINGO_DEFAULTS,
    "laugh_dataset": _LAUGH_DATASET_DEFAULTS,
    "preprocess": _PREPROCESS_DEFAULTS,
}


def get_default_config(config_type: str) -> Dict[str, Any]:
    """Return a deep copy of the registered defaults for ``config_type``."""
    if config_type not in _CONFIG_REGISTRY:
        raise KeyError(
            f"Unknown config type {config_type!r}; known: {sorted(_CONFIG_REGISTRY)}"
        )
    return copy.deepcopy(_CONFIG_REGISTRY[config_type])


def register_default_config(config_type: str, defaults: Dict[str, Any]) -> None:
    _CONFIG_REGISTRY[config_type] = copy.deepcopy(defaults)


def parse_args_with_config(
    config_type: str,
    argv: Optional[Sequence[str]] = None,
    extra_args: Optional[Dict[str, Dict[str, Any]]] = None,
) -> SimpleNamespace:
    """Resolve a config as: registry defaults < YAML file < explicit CLI flags.

    Builds an argparse parser whose flags are derived from the registered
    defaults for ``config_type`` (plus ``--config`` for the YAML path).
    Only flags the user explicitly passed override the YAML values.
    """
    defaults = get_default_config(config_type)
    parser = argparse.ArgumentParser(description=f"avsl_tpu_torch {config_type} config")
    parser.add_argument("--config", type=str, default=None, help="YAML config path")
    for key, value in defaults.items():
        arg = f"--{key}"
        if isinstance(value, bool):
            parser.add_argument(arg, type=_str2bool, default=None)
        elif isinstance(value, (int, float, str)) or value is None:
            parser.add_argument(arg, type=type(value) if value is not None else str, default=None)
        else:
            parser.add_argument(arg, type=json.loads, default=None)
    for key, kwargs in (extra_args or {}).items():
        parser.add_argument(f"--{key}", **kwargs)

    ns, _unknown = parser.parse_known_args(argv)
    cfg = defaults
    if ns.config:
        cfg = merge_configs(cfg, load_yaml_config(ns.config))
    cli_overrides = {
        k: v for k, v in vars(ns).items() if k != "config" and v is not None
    }
    cfg = merge_configs(cfg, cli_overrides)
    return dict_to_namespace(cfg)


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "y", "t"):
        return True
    if v.lower() in ("false", "0", "no", "n", "f"):
        return False
    raise argparse.ArgumentTypeError(f"Expected a boolean, got {v!r}")


# ---------------------------------------------------------------------------
# AV-HuBERT model config
# ---------------------------------------------------------------------------

# fairseq-style `model.*` YAML key -> AVHuBERTConfig attribute (the key layout
# of configs/avhubert_large.yaml)
_AVHUBERT_YAML_KEY_MAP: Dict[str, str] = {
    "use_audio": "use_audio",
    "use_visual": "use_visual",
    "modality_fuse": "modality_fuse",
    "modality_dropout": "modality_dropout",
    "audio_dropout": "audio_dropout",
    "encoder_embed_dim": "hidden_size",
    "encoder_layers": "num_hidden_layers",
    "encoder_attention_heads": "num_attention_heads",
    "encoder_ffn_embed_dim": "intermediate_size",
    "visual_frontend_channels": "visual_frontend_channels",
    "visual_backbone_channels": "visual_backbone_channels",
    "audio_feat_dim": "audio_feat_dim",
    "conv_dim": "conv_dim",
    "conv_stride": "conv_stride",
    "conv_kernel": "conv_kernel",
    "mask_prob_image": "mask_prob_image",
    "mask_length_image": "mask_length_image",
    "mask_prob_audio": "mask_prob_audio",
    "mask_length_audio": "mask_length_audio",
    "mask_time_prob": "mask_time_prob",
    "mask_time_length": "mask_time_length",
    "mask_feature_prob": "mask_feature_prob",
    "mask_feature_length": "mask_feature_length",
    "dropout": "hidden_dropout",
    "activation_dropout": "activation_dropout",
    "attention_dropout": "attention_dropout",
    "encoder_layerdrop": "layerdrop",
    "dropout_input": "dropout_input",
    "dropout_features": "dropout_features",
    "feature_grad_mult": "feature_grad_mult",
    "decoder_embed_dim": "decoder_hidden_size",
    "decoder_ffn_embed_dim": "decoder_ffn_dim",
    "decoder_layers": "decoder_layers",
    "decoder_attention_heads": "decoder_attention_heads",
    "decoder_layerdrop": "decoder_layerdrop",
    "decoder_normalize_before": "decoder_normalize_before",
    "decoder_dropout": "decoder_dropout",
    "decoder_attention_dropout": "decoder_attention_dropout",
    "decoder_activation_dropout": "decoder_activation_dropout",
    "layer_norm_first": "layer_norm_first",
    "final_dim": "final_dim",
    "untie_final_proj": "untie_final_proj",
    "share_decoder_input_output_embed": "tie_word_embeddings",
}


@dataclass
class AVHuBERTConfig:
    """AV-HuBERT model configuration (large-model defaults): hidden 1024,
    24 layers, 16 heads, FFN 4096, 9 decoder layers, 104-dim
    stacked-fbank audio features, vocab 10000, label smoothing 0.1."""

    # Modalities / fusion
    use_audio: bool = True
    use_visual: bool = True
    modality_fuse: str = "concat"  # "concat" | "add" | "weighted_sum"
    modality_dropout: float = 0.0
    audio_dropout: float = 0.0

    # Encoder transformer
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    layer_norm_first: bool = True
    layerdrop: float = 0.05
    conv_pos: int = 128
    conv_pos_groups: int = 16

    # Visual frontend
    visual_frontend_channels: int = 64
    visual_backbone_channels: int = 512
    resnet_relu_type: str = "prelu"

    # Audio frontend (wav2vec2-style conv stack over 104-dim stacked fbank)
    audio_feat_dim: int = 104
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    use_conv_audio_frontend: bool = False

    # Masking (pretraining-style span masks)
    mask_prob_image: float = 0.3
    mask_length_image: int = 5
    mask_prob_audio: float = 0.8
    mask_length_audio: int = 10
    mask_time_prob: float = 0.0
    mask_time_length: int = 10
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10

    # Dropouts
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    dropout_input: float = 0.1
    dropout_features: float = 0.1
    feature_grad_mult: float = 0.1

    # Decoder
    decoder_hidden_size: int = 1024
    decoder_ffn_dim: int = 4096
    decoder_layers: int = 9
    decoder_attention_heads: int = 8
    decoder_layerdrop: float = 0.1
    decoder_normalize_before: bool = True
    decoder_dropout: float = 0.1
    decoder_attention_dropout: float = 0.0
    decoder_activation_dropout: float = 0.1
    decoder_learned_pos: bool = False
    max_target_positions: int = 2048

    # Heads / vocab
    final_dim: int = 256
    untie_final_proj: bool = True
    logit_temp: float = 0.1
    sim_type: str = "cosine"  # "cosine" | "dot"
    skip_masked: bool = False
    skip_nomask: bool = False
    tie_word_embeddings: bool = True
    vocab_size: int = 10000
    bos_token_id: int = 0
    pad_token_id: int = 1
    eos_token_id: int = 2
    label_smoothing: float = 0.1

    # Image pipeline
    image_crop_size: int = 88
    image_mean: float = 0.421
    image_std: float = 0.165

    # Execution knobs
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "block"

    # Mixture-of-experts encoder FFN (0 = dense)
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def encoder_hidden_size(self) -> int:
        """Post-fusion feature dim: concat doubles when both modalities exist."""
        if self.modality_fuse == "concat" and self.use_audio and self.use_visual:
            return 2 * self.hidden_size
        return self.hidden_size

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AVHuBERTConfig":
        known = {f.name for f in fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        for key in ("conv_dim", "conv_stride", "conv_kernel"):
            if key in kwargs and isinstance(kwargs[key], list):
                kwargs[key] = tuple(kwargs[key])
        return cls(**kwargs)

    @classmethod
    def tiny_test(cls, **overrides: Any) -> "AVHuBERTConfig":
        """Miniature config for unit tests (fast CPU runs)."""
        base = dict(
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=2,
            intermediate_size=64,
            conv_pos=8,
            conv_pos_groups=2,
            visual_frontend_channels=8,
            visual_backbone_channels=64,
            audio_feat_dim=104,
            decoder_hidden_size=32,
            decoder_ffn_dim=64,
            decoder_layers=2,
            decoder_attention_heads=2,
            max_target_positions=64,
            vocab_size=59,
            final_dim=16,
            layerdrop=0.0,
            decoder_layerdrop=0.0,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def from_yaml(cls, path: str) -> "AVHuBERTConfig":
        """Build from a fairseq-style YAML card: the ``model:`` keys of
        ``_AVHUBERT_YAML_KEY_MAP``, the token ids of ``tokenizer:``,
        ``criterion: label_smoothing``, and flat top-level keys."""
        raw = load_yaml_config(path)
        flat: Dict[str, Any] = {}
        model = raw.get("model", {})
        for yaml_key, attr in _AVHUBERT_YAML_KEY_MAP.items():
            if yaml_key in model:
                flat[attr] = model[yaml_key]
        tok = raw.get("tokenizer", {})
        for key in ("vocab_size", "bos_token_id", "pad_token_id", "eos_token_id"):
            if key in tok:
                flat[key] = tok[key]
        crit = raw.get("criterion", {})
        if "label_smoothing" in crit:
            flat["label_smoothing"] = crit["label_smoothing"]
        for k, v in raw.items():  # already-flat keys at the top level
            if not isinstance(v, dict):
                flat.setdefault(k, v)
        return cls.from_dict(flat)

    def to_dict(self) -> Dict[str, Any]:
        return namespace_to_dict(self)


# ---------------------------------------------------------------------------
# Auto-AVSR (audio-visual Conformer) model config
# ---------------------------------------------------------------------------

# the published settings the port builds only one way: key -> the value it takes
_AUTO_AVSR_FIXED: Dict[str, Any] = {
    "transformer_input_layer": "conv3d",
    "aux_transformer_input_layer": "conv1d",
    "transformer_encoder_attn_layer_type": "rel_mha",
    "rel_pos_type": "latest",
    "macaron_style": True,
    "use_cnn_module": True,
    "zero_triu": False,
    "a_upsample_ratio": 1,
    "fusion_norm": "batchnorm",
    "ctc_type": "builtin",
    "transformer_length_normalized_loss": False,
    "relu_type": "swish",
    "aux_relu_type": "swish",
}


@dataclass
class AutoAVSRConfig:
    """Auto-AVSR's audio-visual model (arXiv:2303.14307; mpc001/auto_avsr
    ``audiovisual_backbone``), under its published key names: two
    Conformer encoders of ``elayers`` blocks at ``adim`` wide (``aheads``
    heads, FFN ``eunits``, depthwise kernel ``cnn_module_kernel``), the
    lips' over the 3-D stem and ResNet-18 and the audio's over the
    ResNet-1D on raw 16 kHz PCM; the fusion MLP (``2 adim -> fusion_hdim
    -> adim``); the CTC head; a ``dlayers``-block Transformer decoder
    (``ddim``, ``dheads``, ``dunits``); ``odim`` vocabulary rows, the last
    one sos/eos and the first the CTC blank; the loss
    ``mtlalpha x CTC + (1 - mtlalpha) x`` label-smoothed (``lsm_weight``)
    attention CE. ``dropout_rate`` is every dropout but the attention
    weights' (``transformer_attn_dropout_rate``). The ``aux_*`` keys of the
    published config must equal these (one width for both encoders)."""

    adim: int = 768
    aheads: int = 12
    eunits: int = 3072
    elayers: int = 12
    cnn_module_kernel: int = 31
    visual_frontend_channels: int = 64
    visual_backbone_channels: int = 512
    audio_backbone_channels: int = 512
    image_crop_size: int = 88
    fusion_hdim: int = 8192
    ddim: int = 768
    dheads: int = 12
    dunits: int = 3072
    dlayers: int = 6
    odim: int = 5049
    mtlalpha: float = 0.1
    lsm_weight: float = 0.1
    dropout_rate: float = 0.1
    transformer_attn_dropout_rate: float = 0.1
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def eos_id(self) -> int:
        """sos and eos: the vocabulary's last row."""
        return self.odim - 1

    @classmethod
    def tiny_test(cls, **overrides: Any) -> "AutoAVSRConfig":
        """Miniature config for unit tests (fast CPU runs)."""
        base = dict(adim=32, aheads=2, eunits=64, elayers=2, cnn_module_kernel=5,
                    visual_frontend_channels=8, visual_backbone_channels=32,
                    audio_backbone_channels=32, image_crop_size=24, fusion_hdim=48, ddim=32,
                    dheads=2, dunits=64, dlayers=2, odim=41)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AutoAVSRConfig":
        """The fields in ``d`` (published keys); the ``aux_*`` keys must
        equal the lips' encoder's and each key of ``_AUTO_AVSR_FIXED`` the
        one value the port builds; other keys are ignored."""
        for key, value in d.items():
            if key.startswith("aux_") and key not in _AUTO_AVSR_FIXED and key[4:] in d \
                    and d[key[4:]] != value:
                raise ValueError(f"{key}={value!r} differs from {key[4:]}={d[key[4:]]!r}: "
                                 f"the port builds both encoders alike")
        for key, value in _AUTO_AVSR_FIXED.items():
            if key in d and d[key] != value:
                raise ValueError(f"{key}={d[key]!r}: the port builds only {value!r}")
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml(cls, path: str) -> "AutoAVSRConfig":
        """Build from auto_avsr's model YAML: the keys of
        ``model: audiovisual_backbone:`` (or of a flat ``model:``), then
        flat top-level keys."""
        raw = load_yaml_config(path)
        model = raw.get("model", {})
        flat = dict(model.get("audiovisual_backbone", model))
        for k, v in raw.items():
            if not isinstance(v, dict):
                flat.setdefault(k, v)
        return cls.from_dict(flat)

    def to_dict(self) -> Dict[str, Any]:
        return namespace_to_dict(self)


# ---------------------------------------------------------------------------
# Whisper model config
# ---------------------------------------------------------------------------

# (n_mels, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
#  n_vocab, n_text_ctx, n_text_state, n_text_head, n_text_layer)
_WHISPER_PRESETS: Dict[str, Tuple[int, ...]] = {
    "tiny": (80, 1500, 384, 6, 4, 51865, 448, 384, 6, 4),
    "base": (80, 1500, 512, 8, 6, 51865, 448, 512, 8, 6),
    "small": (80, 1500, 768, 12, 12, 51865, 448, 768, 12, 12),
    "medium": (80, 1500, 1024, 16, 24, 51865, 448, 1024, 16, 24),
    "large": (80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v2": (80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v3": (128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
    # English-only variants have a slightly smaller vocab.
    "tiny.en": (80, 1500, 384, 6, 4, 51864, 448, 384, 6, 4),
    "base.en": (80, 1500, 512, 8, 6, 51864, 448, 512, 8, 6),
    "small.en": (80, 1500, 768, 12, 12, 51864, 448, 768, 12, 12),
    "medium.en": (80, 1500, 1024, 16, 24, 51864, 448, 1024, 16, 24),
}


@dataclass
class WhisperConfig:
    """Whisper architecture hyperparameters (public OpenAI dims)."""

    name: str = "large-v2"
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 1280
    n_audio_head: int = 20
    n_audio_layer: int = 32
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 1280
    n_text_head: int = 20
    n_text_layer: int = 32
    dropout_rate: float = 0.0

    # Whisper-Flamingo additions (video fusion): whether decoder blocks
    # carry tanh-gated cross-attention on video features, and the
    # video-encoder output dim projected into the decoder.
    add_gated_x_attn: int = 0
    video_state: int = 1024
    av_fusion: str = "separate"  # "separate" | "none"
    prob_av: float = 1.0
    prob_a: float = 0.0

    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "block"

    @classmethod
    def from_name(cls, name: str, **overrides: Any) -> "WhisperConfig":
        if name not in _WHISPER_PRESETS:
            raise KeyError(f"Unknown Whisper preset {name!r}; known: {sorted(_WHISPER_PRESETS)}")
        (n_mels, a_ctx, a_state, a_head, a_layer, n_vocab, t_ctx, t_state, t_head, t_layer) = _WHISPER_PRESETS[name]
        cfg = cls(
            name=name,
            n_mels=n_mels,
            n_audio_ctx=a_ctx,
            n_audio_state=a_state,
            n_audio_head=a_head,
            n_audio_layer=a_layer,
            n_vocab=n_vocab,
            n_text_ctx=t_ctx,
            n_text_state=t_state,
            n_text_head=t_head,
            n_text_layer=t_layer,
        )
        return dataclasses.replace(cfg, **overrides)

    @classmethod
    def tiny_test(cls, **overrides: Any) -> "WhisperConfig":
        """A miniature config for unit tests (fast CPU runs)."""
        cfg = cls(
            name="test",
            n_mels=80,
            n_audio_ctx=64,
            n_audio_state=64,
            n_audio_head=2,
            n_audio_layer=2,
            n_vocab=256,
            n_text_ctx=32,
            n_text_state=64,
            n_text_head=2,
            n_text_layer=2,
            video_state=32,
        )
        return dataclasses.replace(cfg, **overrides)

    def to_dict(self) -> Dict[str, Any]:
        return namespace_to_dict(self)


@dataclass
class FlamingoTrainConfig:
    """Whisper-Flamingo fine-tuning run config (the serving CLI reads its
    model and audio fields). Field names match the reference training
    YAML (config/ami_whisper_flamingo_large.yaml)."""

    train_name: str = "whisper_flamingo_ft_ami"
    train_data_path: str = ""
    val_data_path: str = ""
    test_data_path: str = ""
    audio_max_length: int = 160000
    dataset_audio_max_length: int = 160000
    max_duration_filter_seconds: float = 10.0
    dataset_fraction: float = 0.0
    text_max_length: int = 350
    accelerator: str = "auto"
    weight_decay: float = 0.01
    adam_epsilon: float = 1.0e-8
    num_worker: int = 4
    validate_every_n_batches: int = 1000
    num_devices: int = 1
    model_name: str = "large-v2"
    learning_rate: float = 1.0e-5
    batch_size: int = 1
    eval_batch_size: int = 1
    num_train_steps: int = 8000
    warmup_steps: int = 1000
    gradient_accumulation_steps: int = 16
    monitor: str = "val/wer_av"
    video_model_ckpt: str = ""
    freeze_video_model: bool = True
    freeze_video_batch_norm_stats: bool = False
    spec_augment: Optional[str] = "ls-basic"
    dropout_rate: float = 0.1
    lang: str = "en"
    pt_ckpt: str = ""
    resume_training: bool = False
    train_id: str = "whisper-flamingo_ft_ami"
    video_projection_train_only: bool = False
    video_projection_separate_lr: str = ""
    prob_use_av: float = 1.0
    prob_use_a: float = 0.5
    early_stop_patience: Optional[int] = None
    use_av_hubert_encoder: bool = True
    add_gated_x_attn: int = 1
    av_fusion: str = "separate"
    log_output_dir: str = "output/train_whisper_flamingo_ft"
    check_output_dir: str = "checkpoints/whisper_flamingo_ft"
    num_sanity_val_steps: int = 2
    precision: Any = "bf16"
    reload_dataloaders_every_n_epochs: int = 1
    sync_batchnorm: bool = True
    download_root: str = "models/whisper"
    enable_gradient_checkpointing: bool = True
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Optional[List[str]] = None
    ema_decay: float = 0.0
    model_parallel: int = 1
    zero1: bool = False
    fsdp: bool = False
    prefetch_batches: int = 0

    @classmethod
    def from_yaml(cls, path: str) -> "FlamingoTrainConfig":
        return cls.from_dict(load_yaml_config(path))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FlamingoTrainConfig":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> Dict[str, Any]:
        return namespace_to_dict(self)
