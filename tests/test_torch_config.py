"""The port's configuration against ``mgnet_tpu.config``: its YAML reader
against PyYAML's ``safe_load`` on the shipped configs, the loaded trees
key by key, unknown keys, overrides and ``dump``. No JAX compile."""

from __future__ import annotations

import math
from pathlib import Path

import pytest
import yaml

from mgnet_tpu import config as jconfig
from mgnet_tpu_torch import config as tconfig

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs")
                 .glob("*.yaml"))
NAMES = [p.name for p in CONFIGS]
# the port's own mapper classes, where the JAX tree names the JAX ones
PORT_VALUES = {
    "INPUT.TRAIN_DATASET_MAPPER": "mgnet_tpu_torch.data.TrainDatasetMapper",
    "INPUT.TEST_DATASET_MAPPER": "mgnet_tpu_torch.data.TestDatasetMapper",
}


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _same(a, b):
    """Equal values of equal types (an int is not a float, a tuple not a
    list); NaN equals NaN."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def test_there_are_five_shipped_configs():
    assert len(CONFIGS) == 5, NAMES


@pytest.mark.parametrize("path", CONFIGS, ids=NAMES)
def test_reader_matches_pyyaml(path):
    text = path.read_text()
    want = yaml.safe_load(text)
    got = tconfig.parse_yaml(text, str(path))
    assert _flat(got).keys() == _flat(want).keys()
    for k, v in _flat(want).items():
        assert _same(_flat(got)[k], v), k
    assert got.pop("_BASE_", None) == want.pop("_BASE_", None)


@pytest.mark.parametrize("path", CONFIGS, ids=NAMES)
def test_load_config_matches_jax(path):
    got = _flat(tconfig.load_config(str(path)).to_dict())
    want = _flat(jconfig.load_config(str(path)).to_dict())
    assert set(want) - set(got) == set(tconfig.TPU_ONLY_KEYS)
    assert set(got) <= set(want)
    for k, v in got.items():
        assert _same(v, PORT_VALUES.get(k, want[k])), (k, v, want[k])


def test_defaults_match_jax():
    got = _flat(tconfig.get_default_config().to_dict())
    want = _flat(jconfig.get_default_config().to_dict())
    assert set(want) - set(got) == set(tconfig.TPU_ONLY_KEYS)
    for k, v in got.items():
        assert _same(v, PORT_VALUES.get(k, want[k])), k


def test_apply_cityscapes_fine_equals_the_fine_yaml():
    path = [p for p in CONFIGS if p.name == "MGNet-Cityscapes-Fine.yaml"][0]
    got = _flat(tconfig.apply_cityscapes_fine(
        tconfig.get_default_config()).to_dict())
    want = _flat(tconfig.load_config(str(path)).to_dict())
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert _same(got[k], v), k


def test_video_sequence_differs_from_fine_only_in_its_datasets():
    trees = {p.name: _flat(tconfig.load_config(str(p)).to_dict())
             for p in CONFIGS}
    fine = trees["MGNet-Cityscapes-Fine.yaml"]
    video = trees["MGNet-Cityscapes-VideoSequence.yaml"]
    assert [k for k in fine if fine[k] != video[k]] == ["DATASETS.TRAIN"]


def test_base_is_relative_to_the_files_directory(tmp_path, monkeypatch):
    sub = tmp_path / "a" / "b"
    sub.mkdir(parents=True)
    (tmp_path / "a" / "base.yaml").write_text(
        "SOLVER:\n  BASE_LR: 0.5\nWITH_DEPTH: false\n")
    (sub / "child.yaml").write_text(
        '_BASE_: "../base.yaml"\nSOLVER:\n  MAX_ITER: 7\n')
    monkeypatch.chdir(tmp_path)
    cfg = tconfig.load_config(str(sub / "child.yaml"),
                              ["SOLVER.IMS_PER_BATCH", "4"])
    assert cfg.SOLVER.BASE_LR == 0.5 and cfg.SOLVER.MAX_ITER == 7
    assert cfg.WITH_DEPTH is False and cfg.SOLVER.IMS_PER_BATCH == 4


@pytest.mark.parametrize("key", ["NO.SUCH.KEY", "SOLVER.NO_SUCH_KEY",
                                 "SOLVER.CLIP_GRADIENTS.NOPE"])
def test_unknown_key_in_opts_raises(key):
    with pytest.raises(KeyError, match="Unknown config key"):
        tconfig.get_default_config().merge_from_list([key, "1"])


def test_unknown_key_in_a_file_raises(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("SOLVER:\n  BASE_LR: 0.1\n  NO_SUCH_KEY: 3\n")
    with pytest.raises(KeyError, match="SOLVER.NO_SUCH_KEY"):
        tconfig.load_config(str(path))


@pytest.mark.parametrize("key", tconfig.TPU_ONLY_KEYS)
def test_tpu_only_switches_raise_as_unknown(key, tmp_path):
    with pytest.raises(KeyError, match="TPU-only"):
        tconfig.get_default_config().merge_from_list([key, "True"])
    *parents, leaf = key.split(".")
    text = "".join(f"{'  ' * i}{p}:\n" for i, p in enumerate(parents))
    path = tmp_path / "tpu.yaml"
    path.write_text(text + f"{'  ' * len(parents)}{leaf}: False\n")
    with pytest.raises(KeyError, match="TPU-only"):
        tconfig.load_config(str(path))
    # the JAX package takes the same key
    jconfig.get_default_config().merge_from_list([key, "True"])


@pytest.mark.parametrize("key,value", [
    ("WITH_DEPTH", "0"),                    # bool from int
    ("SOLVER.BASE_LR", "1"),                # float from int
    ("SOLVER.BASE_LR", "1e-3"),             # literal_eval reads it
    ("INPUT.CROP.SIZE", "[512, 640]"),      # tuple kept
    ("MODEL.PIXEL_MEAN", "(1.0, 2.0, 3.0)"),  # list kept
    ("MODEL.COMPUTE_DTYPE", "float32"),     # plain string
    ("SOLVER.MAX_ITER", "100"),
])
def test_merge_from_list_coerces_as_jax(key, value):
    got = tconfig.get_default_config()
    want = jconfig.get_default_config()
    got.merge_from_list([key, value])
    want.merge_from_list([key, value])
    g, w = _flat(got.to_dict())[key], _flat(want.to_dict())[key]
    assert _same(g, w), (g, w)


def test_freeze_defrost_clone():
    cfg = tconfig.get_default_config()
    copy = cfg.clone()
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.SOLVER.BASE_LR = 1.0
    with pytest.raises(AttributeError):
        cfg.merge_from_list(["SOLVER.BASE_LR", "1.0"])
    cfg.defrost()
    cfg.SOLVER.BASE_LR = 1.0
    setattr(cfg.SOLVER, "MAX_ITER", 5)
    assert cfg.SOLVER["MAX_ITER"] == 5
    assert copy.SOLVER.BASE_LR == 0.0001 and copy.SOLVER.MAX_ITER == 60000


@pytest.mark.parametrize("text,want", [
    ("A: 1e-4\n", "1e-4"),                  # no dot: a string in YAML 1.1
    ("A: 0.0001\n", 0.0001),
    ("A: 1.0e-4\n", 0.0001),
    ("A: 1.0e4\n", "1.0e4"),               # exponent without a sign
    ("A: true\n", True),
    ("A: ~\n", None),
    ("A:\n", None),
    ("A: -1_000\n", -1000),
    ("A: 08\n", "08"),                      # not octal: a string
    ("A: 'it''s' # c\n", "it's"),
    ("A: a#b\n", "a#b"),                    # '#' not after a space
    ("A: [1, 'x', 2.5, null]  # c\n", [1, "x", 2.5, None]),
    ("A: []\n", []),
    ("# only\n\nA:\n  B:\n    C: 3\n  D: 4\n", {"B": {"C": 3}, "D": 4}),
])
def test_reader_resolves_scalars_as_pyyaml(text, want):
    got = tconfig.parse_yaml(text)["A"]
    assert _same(got, want) or got == want == yaml.safe_load(text)["A"]
    assert got == yaml.safe_load(text)["A"]


@pytest.mark.parametrize("text,what", [
    ("A:\n  - 1\n  - 2\n", "block sequences"),
    ("A:\n\tB: 1\n", "tab"),
    ("A: &x 1\n", "outside the YAML subset"),
    ("A: *x\n", "outside the YAML subset"),
    ("A: |\n  text\n", "outside the YAML subset"),
    ("A: {B: 1}\n", "outside the YAML subset"),
    ("A: [1,\n  2]\n", "not closed"),
    ("A: text\n  more text\n", "indentation"),
    ("A: 1\nA: 2\n", "duplicate"),
    ("true: 1\n", "would not read as a string"),
    ("A: yes\n", "yes/no/on/off"),
    ("A: Off\n", "yes/no/on/off"),
    ("A: 017\n", "octal"),
    ("A: 0x1F\n", "hex"),
    ("A: [1, 0b101]\n", "binary"),
    ("A: 1:30\n", "base-60"),
    ("yes: 1\n", "yes/no/on/off"),
])
def test_reader_refuses_what_it_does_not_read(text, what):
    with pytest.raises(tconfig.YamlError, match=what) as err:
        tconfig.parse_yaml(text, "f.yaml")
    assert "f.yaml:" in str(err.value)


@pytest.mark.parametrize("path", CONFIGS, ids=NAMES)
def test_dump_round_trips(path):
    cfg = tconfig.load_config(str(path))
    text = cfg.dump()
    read = tconfig.parse_yaml(text)
    assert read == yaml.safe_load(text)
    again = tconfig.get_default_config()
    again.merge_dict(read)
    assert again == cfg
    flat = _flat(again.to_dict())
    for k, v in _flat(cfg.to_dict()).items():
        assert _same(flat[k], v), k


def test_dump_writes_floats_pyyaml_reads_as_floats():
    data = {"A": {"B": 1e-05, "C": 2.5e16, "D": [0.1, 3.0, -1e-20]},
            "E": "a \"quoted\" \\ string", "F": None, "G": False}
    text = tconfig.dump_yaml(data)
    assert tconfig.parse_yaml(text) == yaml.safe_load(text) == data
