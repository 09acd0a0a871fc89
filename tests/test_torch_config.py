"""The port's config system against the JAX package's.

The port reads YAML with its own reader for the subset of ``tools/cfgs/``
(``utils.yaml_subset``), which must equal ``yaml.safe_load`` on every file
there: same keys in the same order, same values and the same Python types
(no tolerance). ``cfg_from_yaml_file`` and ``cfg_from_list`` must compose
the same configs as the JAX functions and reject the same overrides.
"""

import math
from pathlib import Path

import pytest
import yaml

from pcseqlearning_tpu import config as jconfig
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch import config as tconfig
from pcseqlearning_tpu_torch.utils import yaml_subset
from pcseqlearning_tpu_torch.utils.edict import EDict

REPO = Path(__file__).resolve().parent.parent
CFG_FILES = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "tools" / "cfgs").rglob("*.yaml"))
README_CFGS = ("tools/cfgs/waymo_models/registration/cluster_tracking_TLS_multiradius_every8.yaml",
               "tools/cfgs/dataset_configs/waymo/registration/all_sequence.yaml",
               "tools/cfgs/optimizers/registration.yaml")


def _same(a, b):
    """Equal values of equal types, dict key order included."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _plain(d):
    """A config tree with EDicts as plain dicts (the two packages' EDict
    classes differ)."""
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_plain(x) for x in d]
    return d


def test_the_configs_are_all_found():
    assert len(CFG_FILES) == 62


@pytest.mark.parametrize("path", CFG_FILES)
def test_reader_equals_safe_load(path):
    with open(REPO / path) as f:
        want = yaml.safe_load(f)
    assert _same(yaml_subset.load_file(REPO / path), want)


@pytest.mark.parametrize("text, want", [
    ("a: 1e-5", {"a": "1e-5"}),  # YAML 1.1: a float needs a dot
    ("a: -1\nb: +2.5\nc: .5\nd: -.5\ne: 1.0E5\nf: 0.5x",
     {"a": -1, "b": 2.5, "c": 0.5, "d": "-.5", "e": "1.0E5", "f": "0.5x"}),
    ("a: yes\nb: Off\nc: ~\nd:", {"a": True, "b": False, "c": None, "d": None}),
    ("a: 'it''s'\nb: \"x y\"", {"a": "it's", "b": "x y"}),
    ("a: [1, [2.5, x], {b: c}, ]", {"a": [1, [2.5, "x"], {"b": "c"}]}),
    ("a:\n- 1\n- k: v\n  j: [1,\n    2]\nb: 3  # note", {"a": [1, {"k": "v", "j": [1, 2]}], "b": 3}),
])
def test_reader_resolves_like_safe_load(text, want):
    assert _same(yaml_subset.loads(text), yaml.safe_load(text))
    assert _same(yaml_subset.loads(text), want)


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor",          # anchor and alias
    "a: |\n  block scalar\n",            # literal block scalar
    "a: >\n  folded\n",                  # folded block scalar
    "a: !!str 1",                        # tag
    "a: 2001-12-14",                     # timestamp
    "a: 017",                            # octal int
    "a: 0x1F",                           # hex int
    "a: 0b101",                          # binary int
    "a: 1_000",                          # '_'-separated int
    "a: 1:30",                           # sexagesimal int
    "a: -.inf",                          # infinity
    "a: .nan",                           # not a number
    'a: "x\\ty"',                        # escape in double quotes
    "a: 1\n  continued",                 # multi-line plain scalar
    "--- \na: 1",                        # document marker
])
def test_reader_raises_outside_the_subset(text):
    with pytest.raises(yaml_subset.YAMLSubsetError):
        yaml_subset.loads(text)


@pytest.mark.parametrize("paths", [
    README_CFGS,
    ("tools/cfgs/waymo_models/registration/cluster_proposal.yaml",
     "tools/cfgs/dataset_configs/waymo/registration/all_sequence_sample8.yaml",  # _BASE_CONFIG_
     "tools/cfgs/optimizers/registration.yaml",
     "tools/cfgs/visualizers/waymo/registration/voxel_visualizer.yaml"),
])
def test_cfg_from_yaml_file_matches_jax(paths, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # the include resolves from the file or the repo root
    cj, ct = JEDict(ROOT_DIR="r"), EDict(ROOT_DIR="r")
    for p in paths:
        jconfig.cfg_from_yaml_file(str(REPO / p), cj)
        tconfig.cfg_from_yaml_file(str(REPO / p), ct)
    assert _same(_plain(ct), _plain(cj))
    assert isinstance(ct.MODEL, EDict) and isinstance(ct.MODEL.PREPROCESSORS[0], EDict)
    assert ct.DATA_CONFIG.DATASET == "WaymoDataset"


def _composed():
    cj, ct = JEDict(ROOT_DIR="r"), EDict(ROOT_DIR="r")
    for p in README_CFGS:
        jconfig.cfg_from_yaml_file(str(REPO / p), cj)
        tconfig.cfg_from_yaml_file(str(REPO / p), ct)
    return cj, ct


@pytest.mark.parametrize("overrides", [
    ["DATA_CONFIG.DATA_PATH", "/data/waymo", "OPTIMIZATION.BATCH_SIZE_PER_GPU", "2"],
    ["MODEL.PREPROCESSORS.0.MAX_NUM_ITERS", "300", "MODEL.PREPROCESSORS.0.LR", "0.02"],
    ["MODEL.PREPROCESSORS.0.TRUNCATE_HEIGHT", "[0.3, 0.5]"],
    ["MODEL.PREPROCESSORS.1.COMPONENT_KEYS", "['component_rad1x25']",
     "MODEL.PREPROCESSORS.1.GRAPH.RADIUS", "[1.25]"],
    ["MODEL.PREPROCESSORS.2.TRACKING_PARAMS.TRACK_INTERVAL", "4", "MODEL.SUBSAMPLE", "False"],
    ["OPTIMIZATION.LR", "1",  # an int for a float
     "DATA_CONFIG.DATA_SPLIT.train", "val"],
])
def test_cfg_from_list_matches_jax(overrides):
    cj, ct = _composed()
    jconfig.cfg_from_list(list(overrides), cj)
    tconfig.cfg_from_list(list(overrides), ct)
    assert _same(_plain(ct), _plain(cj))


@pytest.mark.parametrize("overrides", [
    ["MODEL.NOT_A_KEY", "1"],                          # unknown key
    ["MODEL.PREPROCESSORS.0.NOPE.X", "1"],             # unknown intermediate key
    ["MODEL.SUBSAMPLE", "'yes'"],                      # str for a bool
    ["DATA_CONFIG.DATA_PATH", "3"],                    # int for a str
    ["MODEL.PREPROCESSORS.0.PILLAR_SIZE", "2.0"],      # float for a list
    ["MODEL.PREPROCESSORS.0.TRUNCATE_HEIGHT", "0.3,0.5"],  # a tuple for a list
    ["CLASS_NAMES", "Car,Truck"],                      # comma text: a str for a list
    ["OPTIMIZATION.LR"],                               # odd length
])
def test_cfg_from_list_rejects_what_jax_rejects(overrides):
    cj, ct = _composed()
    with pytest.raises(AssertionError):
        jconfig.cfg_from_list(list(overrides), cj)
    with pytest.raises(AssertionError):
        tconfig.cfg_from_list(list(overrides), ct)


def test_global_cfg_and_logging():
    assert Path(tconfig.cfg.ROOT_DIR) == REPO
    assert Path(jconfig.cfg.ROOT_DIR) == REPO
    lines = []

    class Log:
        def info(self, msg):
            lines.append(msg)

    _, ct = _composed()
    tconfig.log_config_to_file(ct, logger=Log())
    assert "cfg.MODEL.NAME: SimpleReg" in lines
    assert "----------- DATA_CONFIG -----------" in lines
