"""Config system (counterpart of pcseqlearning_tpu.config): YAML files
composed with ``_BASE_CONFIG_`` includes and dotted-path overrides from the
command line, and the global ``cfg`` namespace with ``ROOT_DIR``.

A run is composed from up to four YAML files (model, dataset, optimizer,
visualizer), as ``train.py`` does. The files are read by the port's own
reader for the YAML subset of ``tools/cfgs/`` (``utils.yaml_subset``,
equal to ``yaml.safe_load`` on every file there), so no PyYAML is needed.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

from .utils.edict import EDict
from .utils.yaml_subset import load_file


def log_config_to_file(cfg_dict, pre="cfg", logger=None):
    for key, val in cfg_dict.items():
        if isinstance(val, EDict):
            if logger is not None:
                logger.info("----------- %s -----------" % key)
            log_config_to_file(val, pre=pre + "." + key, logger=logger)
            continue
        if logger is not None:
            logger.info("%s.%s: %s" % (pre, key, val))


def cfg_from_list(cfg_list, config):
    """Set config keys from a flat list ``[KEY, VALUE, KEY, VALUE, ...]``.

    Keys are dotted paths (``MODEL.PREPROCESSORS.0.LR``); a value is parsed
    with ``ast.literal_eval`` (kept as text when that fails) and must match
    the existing entry's type (ints and floats are interchangeable; a dict or
    None entry takes anything); a comma-separated text value replacing a
    list becomes a list of literals. Unknown keys and type mismatches raise
    AssertionError, as in the JAX package.
    """
    assert len(cfg_list) % 2 == 0, "override list must have even length"
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = config
        for subkey in key_list[:-1]:
            if isinstance(d, (list, tuple)):
                d = d[int(subkey)]
            else:
                assert subkey in d, "NotFoundKey: %s" % subkey
                d = d[subkey]
        subkey = key_list[-1]
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = v

        if isinstance(d, (list, tuple)):
            d[int(subkey)] = value
            continue

        assert subkey in d, "NotFoundKey: %s" % subkey
        if type(value) != type(d[subkey]) and not isinstance(d[subkey], (EDict, dict, type(None))):
            assert isinstance(value, type(d[subkey])) or isinstance(d[subkey], type(value)) or (
                isinstance(value, (int, float)) and isinstance(d[subkey], (int, float))
            ), "type mismatch for key %s: %r vs %r" % (k, type(value), type(d[subkey]))
        if isinstance(value, str) and "," in value and isinstance(d[subkey], list):
            value = [ast.literal_eval(x) for x in value.split(",")]
        d[subkey] = value


def merge_new_config(config, new_config, base_dir=None):
    """Recursively merge ``new_config`` into ``config``, resolving a
    ``_BASE_CONFIG_`` include first. The include path is tried as given
    (relative to the working directory), then relative to the including
    file's directory, then relative to the repo root."""
    if "_BASE_CONFIG_" in new_config:
        base = new_config["_BASE_CONFIG_"]
        candidates = [base]
        if base_dir is not None:
            candidates.append(os.path.join(base_dir, base))
        candidates.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                       base))
        path = next((p for p in candidates if os.path.exists(p)), base)
        merge_new_config(config, EDict(load_file(path)), base_dir=os.path.dirname(path))

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if not isinstance(val, dict):
            config[key] = val
            continue
        if key not in config:
            config[key] = EDict()
        merge_new_config(config[key], val, base_dir=base_dir)
    return config


def cfg_from_yaml_file(cfg_file, config):
    merge_new_config(config=config, new_config=load_file(cfg_file) or {},
                     base_dir=os.path.dirname(os.path.abspath(cfg_file)))
    return config


cfg = EDict()
cfg.ROOT_DIR = str(Path(__file__).resolve().parent.parent)
cfg.LOCAL_RANK = 0
