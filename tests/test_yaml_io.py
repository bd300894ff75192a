"""The in-repo YAML reader and writer (badger_amcl/utils/yaml_io.py): the
launch configs and both saved-pose layouts round-trip, every document is
cross-checked against PyYAML where PyYAML is importable, and malformed
input raises YAMLError (load_pose_from_file then returns None)."""

import math
import os

import numpy as np
import pytest

from badger_amcl.config import AMCLConfig
from badger_amcl.node.messages import PoseWithCovarianceStamped
from badger_amcl.node.persistence import load_pose_from_file, save_pose_to_file
from badger_amcl.utils import yaml_io

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
DEFAULT_COV = (0.25, 0.25, 0.07)


def _pyyaml_equal(text, got):
    """got must equal PyYAML's safe_load of text, when PyYAML is present."""
    try:
        import yaml
    except ImportError:
        return
    want = yaml.safe_load(text)
    assert _canon(got) == _canon(want)


def _canon(v):
    """Comparable form: NaN equal to NaN."""
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_canon(x) for x in v]
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    return v


@pytest.mark.parametrize("name", ["amcl_2d.yaml", "amcl_3d.yaml"])
def test_example_config_round_trip(name):
    path = os.path.join(EXAMPLES, name)
    text = open(path).read()
    raw = yaml_io.load_file(path)
    _pyyaml_equal(text, raw)
    assert yaml_io.loads(yaml_io.dumps(raw)) == raw
    warnings = []
    cfg = AMCLConfig.from_params(raw, warn=lambda *a: warnings.append(a))
    assert warnings == []
    assert cfg.max_particles == raw["max_particles"]
    assert cfg.laser_model_type.value == raw["laser_model_type"]


def test_saved_pose_round_trip(tmp_path):
    path = str(tmp_path / "pose.yaml")
    cov = np.zeros(36)
    cov[0], cov[7], cov[35] = 0.1, 0.2, 0.05
    pose = PoseWithCovarianceStamped(12.75, "map", np.array([1.5, -2.25, 0.7]), cov)
    save_pose_to_file(path, pose, on_exit=True)
    text = open(path).read()
    doc = yaml_io.loads(text)
    _pyyaml_equal(text, doc)
    assert doc["header"]["stamp"] == {"sec": 12, "nsec": 750000000}
    assert doc["header"]["on_exit"] is True
    got, got_cov = load_pose_from_file(path, DEFAULT_COV)
    np.testing.assert_allclose(got, [1.5, -2.25, 0.7], atol=1e-12)
    np.testing.assert_allclose(got_cov, [0.1, 0.2, 0.05])


LEGACY = """\
!!python/object/new:geometry_msgs.msg._PoseWithCovarianceStamped.PoseWithCovarianceStamped
state:
- !!python/object/new:std_msgs.msg._Header.Header
  state:
  - 7
  - !!python/object/new:genpy.rostime.Time
    state: [1500000000, 5]
  - map
- !!python/object/new:geometry_msgs.msg._PoseWithCovariance.PoseWithCovariance
  state:
  - !!python/object/new:geometry_msgs.msg._Pose.Pose
    state:
    - !!python/object/new:geometry_msgs.msg._Point.Point
      state: [2.5, -1.0, 0.0]
    - !!python/object/new:geometry_msgs.msg._Quaternion.Quaternion
      state: [0.0, 0.0, 0.24740395925452294, 0.9689124217106447]
  - [0.11, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.22, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.33]
"""


LEGACY_PLAIN = """\
state:
- state: [7, {state: [1500000000, 5]}, map]
- state:
  - state:
    - state: [2.5, -1.0, 0.0]
    - state: [0.0, 0.0, 0.24740395925452294, 0.9689124217106447]
  - [0.11, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.22, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.33]
"""


@pytest.mark.parametrize("text", [LEGACY, LEGACY_PLAIN], ids=["python_tags", "plain"])
def test_legacy_state_layout_loads(tmp_path, text):
    """The reference's old Python-dump layout (node.cpp:555-606); its
    `!!python/object` tags are ignored, as the reference's reader does."""
    doc = yaml_io.loads(text)
    assert doc == yaml_io.loads(LEGACY_PLAIN)
    if text is LEGACY_PLAIN:
        _pyyaml_equal(text, doc)
    path = tmp_path / "legacy.yaml"
    path.write_text(text)
    pose, cov = load_pose_from_file(str(path), DEFAULT_COV)
    np.testing.assert_allclose(pose, [2.5, -1.0, 0.5], atol=1e-9)
    np.testing.assert_allclose(cov, [0.11, 0.22, 0.33])


DOCS = {
    "flow_and_comments": "a: [1, 2.5, -3.0e+2]  # comment\nb: {x: 1, 'y': \"two\"}\nc: ~\n",
    "booleans_and_specials": "t: yes\nf: Off\ninf: -.inf\nnan: .NaN\nhex: 0x1F\n",
    "nested_block": "top:\n  list:\n  - a\n  - - 1\n    - 2\n  - k: v\n    k2: [x]\n  empty:\n",
    "quoted": "s: 'it''s'\nd: \"tab\\tq\\\"\\u00e9\"\nhash: 'a # b'\ncolon: \"k: v\"\n",
    "wrapped_flow": "cov: [0.1, 0.0,\n  0.0, 0.2]\nm: {a: 1,\n  b: 2}\n",
    "key_then_sequence": "items:\n- 1\n- two\n- 3.0\nafter: true\n",
    "document_markers": "---\nx: 1\ny: -0.5\n...\n",
    "empty": "# nothing\n",
}


@pytest.mark.parametrize("name", list(DOCS))
def test_reader_matches_pyyaml(name):
    text = DOCS[name]
    got = yaml_io.loads(text)
    _pyyaml_equal(text, got)
    if got is not None:
        assert _canon(yaml_io.loads(yaml_io.dumps(got))) == _canon(got)


MALFORMED = {
    "unclosed_flow": "a: [1, 2\n",
    "nested_colon": "a: b: c\n",
    "anchor": "a: &x 1\nb: *x\n",
    "block_scalar": "a: |\n  text\n",
    "two_documents": "a: 1\n---\nb: 2\n",
    "tab_indent": "a:\n\tb: 1\n",
    "bad_indent": "a:\n    b: 1\n  c: 2\n",
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_raises_and_pose_load_gives_none(tmp_path, name):
    with pytest.raises(yaml_io.YAMLError):
        yaml_io.loads(MALFORMED[name])
    path = tmp_path / "pose.yaml"
    path.write_text(MALFORMED[name])
    assert load_pose_from_file(str(path), DEFAULT_COV) is None


def test_exponent_without_dot_is_a_float():
    """YAML 1.2 / yaml-cpp reading, which the reference's launch params get;
    PyYAML's YAML 1.1 resolver would give the string '1e-3'."""
    assert yaml_io.loads("kld_err: 1e-3\nz: -2E2\n") == {"kld_err": 1e-3, "z": -200.0}


def test_writer_quotes_ambiguous_strings():
    doc = {"yes": "yes", "num": "1.0", "colon": "a: b", "hash": "x #y", "empty": "",
           "null": "null", "lead": "-x", "nl": "two\nlines", "u": "\u00e9",
           "f": 1e-7, "big": 1e22, "inf": float("inf"), "nan": float("nan"),
           "ints": [0, -3], "none": None, "nested": {"list": [], "map": {}}}
    text = yaml_io.dumps(doc)
    got = yaml_io.loads(text)
    assert _canon(got) == _canon(doc)
    _pyyaml_equal(text, got)
