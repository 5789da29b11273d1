"""The configs' YAML subset reader/writer, cross-checked against PyYAML
where it is installed, and the CLI's import without PyYAML or Orbax."""
import math
import subprocess
import sys
from pathlib import Path

import pytest

from base_tpu.io import miniyaml
from base_tpu.io.settings import Settings, load_settings, to_yaml

ROOT = Path(__file__).resolve().parents[1]

DOC = """\
# leading comment
files:
  photFile: "a b.phot"      # quoted, with a space
  outputFileBase: 'it''s'
  modelDirectory: ""
models:
  bands: [U, B, 'V', "R"]
  none:
  tilde: ~
cluster:
  starting_logAge: 9.0
  neg: -0.5
  exp: 1.0e-3
  int: 42
  under: 1_000
  flag: true
  flag_no: no
  inf: .inf
  ninf: -.inf
  word: hello world
  hash: a#b
  empty_list: []
  empty_map: {}
  nested:
    deeper:
      x: 1
"""


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def test_reads_the_subset():
    d = miniyaml.loads(DOC)
    assert d["files"] == {"photFile": "a b.phot", "outputFileBase": "it's",
                          "modelDirectory": ""}
    assert d["models"]["bands"] == ["U", "B", "V", "R"]
    assert d["models"]["none"] is None and d["models"]["tilde"] is None
    c = d["cluster"]
    assert c["starting_logAge"] == 9.0 and c["neg"] == -0.5
    assert c["exp"] == 1e-3 and c["int"] == 42 and c["under"] == 1000
    assert c["flag"] is True and c["flag_no"] is False
    assert c["inf"] == math.inf and c["ninf"] == -math.inf
    assert c["word"] == "hello world" and c["hash"] == "a#b"
    assert c["empty_list"] == [] and c["empty_map"] == {}
    assert c["nested"] == {"deeper": {"x": 1}}
    assert miniyaml.loads("# only a comment\n\n") is None


@pytest.mark.parametrize("bad", [
    "a:\n  - 1\n  - 2\n",          # block list
    "a: [1, [2]]\n",               # nested flow list
    "a: 1\n   b: 2\n",             # bad indentation
    "a: &anchor 1\n",              # anchors
    "just a scalar\n",             # no key
    "a: [1, 2\n",                  # unterminated
])
def test_refuses_what_it_does_not_support(bad):
    with pytest.raises(ValueError, match="line"):
        miniyaml.loads(bad)


def test_settings_roundtrip_through_writer():
    s = Settings()
    s.cluster.fieldMagRange = [12.5, 13.0]
    s.files.photFile = "it's: a file.phot"
    doc = miniyaml.loads(to_yaml(s))
    assert doc["files"]["photFile"] == "it's: a file.phot"
    assert doc["cluster"]["fieldMagRange"] == [12.5, 13.0]
    assert math.isnan(doc["multiPop"]["startY_A"])
    assert doc["mcmc"]["denseMass"] is True
    assert doc["models"]["bands"] == list("UBVRIJHK")


def test_shipped_config_loads():
    s = load_settings(str(ROOT / "conf" / "base9.yaml"))
    assert s.mcmc.chains == 64 and s.mcmc.lMax == 48
    assert s.models.bands == list("UBVRIJHK")
    assert s.scatterCluster.exposures == []


@pytest.mark.parametrize("text", [
    DOC,
    (ROOT / "conf" / "base9.yaml").read_text(),
    to_yaml(Settings()),
])
def test_agrees_with_pyyaml(text):
    yaml = pytest.importorskip("yaml")
    assert _same(miniyaml.loads(text), yaml.safe_load(text))


def test_cli_imports_without_yaml_or_orbax():
    """The main path needs neither PyYAML nor Orbax."""
    code = (
        "import sys\n"
        "for m in ('yaml', 'orbax', 'orbax.checkpoint'):\n"
        "    sys.modules[m] = None\n"
        "import base_tpu.tools.main\n"
        "import base_tpu.inference.driver\n"
        "from base_tpu.io.settings import load_settings\n"
        "s = load_settings('conf/base9.yaml')\n"
        "assert s.mcmc.chains == 64\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
