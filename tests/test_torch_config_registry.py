"""The port's typed default-config registry against the JAX package's (CPU).

The three default tables equal JAX's key for key (values and types);
``parse_args_with_config`` resolves defaults < YAML < explicit flags as
JAX's does (the case of ``tests/test_config.py``), and every
``configs/*.yaml`` resolves to equal namespaces through both packages,
alone and with flags over it; a bad boolean flag exits in both;
``register_default_config`` keeps a deep copy.
"""

import glob
import os

import pytest

from avsl_tpu.core import config as jax_config
from avsl_tpu_torch.core import config as port_config
from avsl_tpu_torch.core.config import (
    get_default_config,
    parse_args_with_config,
    register_default_config,
    save_yaml_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
TABLES = ("_WHISPER_FLAMINGO_DEFAULTS", "_LAUGH_DATASET_DEFAULTS", "_PREPROCESS_DEFAULTS")


def test_torch_default_registry_and_cli_override(tmp_path):
    defaults = get_default_config("whisper_flamingo")
    assert defaults["model_name"] == "large-v2"
    assert defaults["gradient_accumulation_steps"] == 16

    yaml_path = str(tmp_path / "run.yaml")
    save_yaml_config({"model_name": "small", "batch_size": 4}, yaml_path)
    cfg = parse_args_with_config(
        "whisper_flamingo",
        argv=["--config", yaml_path, "--batch_size", "8"],
    )
    # defaults < yaml < cli
    assert cfg.model_name == "small"
    assert cfg.batch_size == 8
    assert cfg.num_train_steps == 8000


@pytest.mark.parametrize("table", TABLES)
def test_torch_default_tables_equal_jax(table):
    want, got = getattr(jax_config, table), getattr(port_config, table)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key] == value and type(got[key]) is type(value), key
    assert sorted(port_config._CONFIG_REGISTRY) == sorted(jax_config._CONFIG_REGISTRY)


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
@pytest.mark.parametrize("config_type", ["whisper_flamingo", "laugh_dataset", "preprocess"])
def test_torch_configs_resolve_as_in_jax(path, config_type):
    for argv in (["--config", path],
                 ["--config", path, "--batch_size", "3", "--resume", "false", "--fps", "30"]):
        want = jax_config.parse_args_with_config(config_type, argv=argv)
        got = parse_args_with_config(config_type, argv=argv)
        assert vars(got) == vars(want)


def test_torch_registry_bad_bool_and_deep_copy():
    for mod in (jax_config, port_config):
        with pytest.raises(SystemExit):
            mod.parse_args_with_config("preprocess", argv=["--resume", "maybe"])
        with pytest.raises(KeyError, match="Unknown config type"):
            mod.get_default_config("nope")
    table = {"nested": {"a": 1}, "flag": True}
    register_default_config("_test_table", table)
    try:
        table["nested"]["a"] = 2
        got = get_default_config("_test_table")
        assert got == {"nested": {"a": 1}, "flag": True}
        got["nested"]["a"] = 3
        assert get_default_config("_test_table")["nested"]["a"] == 1
        assert parse_args_with_config("_test_table", argv=["--nested", '{"a": 5}']).nested.a == 5
    finally:
        port_config._CONFIG_REGISTRY.pop("_test_table")
