"""The port's YAML reader (``core/yaml_load.py``) against PyYAML 6's
``yaml.safe_load``, value and Python type, recursively (``True`` and ``1``
differ, NaN equals NaN, dict keys in order):

* every ``tasks/*.yaml`` and every fenced ``yaml`` block of ``README.md``
  and ``docs/``; ``ConfigManager`` builds the same ``NetworkPlan`` from
  each task file through the reader as through ``yaml.safe_load``;
* a table of the YAML 1.1 resolver's scalar quirks;
* hypothesis round trips: config-like trees dumped by ``yaml.safe_dump``
  in every flow style, scalar style, indent 2-4, narrow widths, with and
  without ``allow_unicode``;
* hand-written anchors, aliases, merges, block scalars with chomping and
  indentation indicators, quoted scalars over lines, multi-line flow
  collections and directives;
* what it refuses (a tab in the indentation, a tag, a complex key, an
  unclosed flow collection, ...) raises ``ValueError`` with the line;
* no module of the port and no line of ``chip_smoke.py`` imports ``yaml``.
"""

import ast
import datetime
import glob
import math
import re
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mt3d_resenc_unet_torch.core import yaml_load
from mt3d_resenc_unet_torch.core.config import ConfigManager

ROOT = Path(__file__).resolve().parents[1]
TASKS = sorted(glob.glob(str(ROOT / "tasks" / "*.yaml")))


def same(a, b, seen=None) -> bool:
    """Equal in value and type, recursively; NaN equals NaN, -0.0 is not
    0.0, dict keys compare in order, shared and cyclic nodes once."""
    seen = set() if seen is None else seen
    if type(a) is not type(b):
        return False
    if isinstance(a, (dict, list)):
        if (id(a), id(b)) in seen:
            return True
        seen.add((id(a), id(b)))
    if isinstance(a, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    if isinstance(a, dict):
        ka, kb = list(a), list(b)
        return len(ka) == len(kb) and all(
            same(x, y, seen) and same(a[x], b[y], seen)
            for x, y in zip(ka, kb))
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y, seen)
                                        for x, y in zip(a, b))
    return a == b


def check(text):
    want = yaml.safe_load(text)
    got = yaml_load.safe_load(text)
    assert same(got, want), (text, got, want)
    return got


# ------------------------------------------------------ the repo's files

@pytest.mark.parametrize("path", TASKS, ids=lambda p: Path(p).name)
def test_task_files_and_their_plans(path):
    text = Path(path).read_text()
    check(text)
    with open(path, "rb") as f:
        assert same(yaml_load.safe_load(f), yaml.safe_load(text))
    via_reader = ConfigManager(path)
    via_pyyaml = ConfigManager(config_dict=yaml.safe_load(text))
    assert via_reader.build_plan("cpu") == via_pyyaml.build_plan("cpu")


def test_fenced_yaml_blocks_of_the_docs():
    docs = [ROOT / "README.md", *sorted((ROOT / "docs").glob("*.md"))]
    blocks = [m.group(1) for doc in docs for m in re.finditer(
        r"^```ya?ml\n(.*?)^```", doc.read_text(), re.M | re.S)]
    assert blocks, "README.md shows a task file in a yaml block"
    for block in blocks:
        check(block)


# --------------------------------------------------------- scalar quirks

QUIRKS = [
    ("1e-3", "1e-3"), ("1.0e-3", 0.001), ("1.0e+3", 1000.0), ("1.5", 1.5),
    ("017", 15), ("08", "08"), ("0o17", "0o17"), ("0x1F", 31), ("0b101", 5),
    ("1_000", 1000), ("+12", 12), ("-3", -3), ("0", 0), ("-0", 0),
    ("1:30", 90), ("1:30.5", 90.5), ("-1:00:01", -3601),
    (".inf", math.inf), ("-.Inf", -math.inf), ("+.INF", math.inf),
    (".NaN", math.nan), ("1.", 1.0), (".5", 0.5), ("-.5", "-.5"),
    ("1_0.2_5", 10.25), ("-0.0", -0.0),
    ("yes", True), ("No", False), ("on", True), ("OFF", False),
    ("TRUE", True), ("y", "y"), ("n", "n"), ("yEs", "yEs"),
    ("~", None), ("Null", None), ("NULL", None), ("none", "none"),
    ("None", "None"), ("", None),
    ("2024-01-02", datetime.date(2024, 1, 2)),
    ("2024-01-02 10:00:00", datetime.datetime(2024, 1, 2, 10)),
    ("2024-1-2T3:04:05.25Z", datetime.datetime(
        2024, 1, 2, 3, 4, 5, 250000, tzinfo=datetime.timezone.utc)),
    ("2024-01-02 10:00:00 -05:30", datetime.datetime(
        2024, 1, 2, 10, tzinfo=datetime.timezone(
            -datetime.timedelta(hours=5, minutes=30)))),
    ("'yes'", "yes"), ('"017"', "017"), ("!!str 12", "12"),
    ("!!int '0x10'", 16), ("!!float 3", 3.0), ("!!bool 'off'", False),
    ("!!null x", None), ("http://a:b", "http://a:b"), ("a:b", "a:b"),
    ("<<x", "<<x"), ("0.1.2", "0.1.2"), ("12e3", "12e3"),
]


@pytest.mark.parametrize("text,value", QUIRKS, ids=[q[0] or "empty"
                                                    for q in QUIRKS])
def test_scalar_quirks(text, value):
    """Each as a block mapping's value and as a flow sequence's item."""
    assert same(check(f"k: {text}\n")["k"], value)
    assert same(check(f"[{text or '~'}]")[0], value)


# --------------------------------------------------- generated documents

_KEY = st.text(st.characters(blacklist_categories=("Cs",),
                             blacklist_characters="\n\r\x85\u2028\u2029"),
               min_size=1, max_size=12)
_TEXT = st.one_of(st.text(max_size=30), st.sampled_from(
    ["yes", "no", "on", "Null", "none", "1e-3", "017", "08", "1:30", "=",
     "<<", "- x", "a: b", "#c", "---", "...", "2024-01-02", "", " ", "'q'",
     "line\nbreak", "tail \n", "\ttab"]))
_LEAF = st.one_of(st.none(), st.booleans(), st.integers(),
                  st.floats(allow_nan=True, allow_infinity=True), _TEXT)
_TREE = st.recursive(_LEAF, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.dictionaries(_KEY, inner, max_size=4)),
    max_leaves=14)


@settings(max_examples=250, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(tree=_TREE, flow=st.sampled_from([False, True, None]),
       style=st.sampled_from([None, '"', "'", "|", ">"]),
       indent=st.integers(2, 4), width=st.sampled_from([8, 20, 80]),
       unicode=st.booleans())
def test_safe_dump_round_trips(tree, flow, style, indent, width, unicode):
    text = yaml.safe_dump(tree, default_flow_style=flow, default_style=style,
                          indent=indent, width=width, allow_unicode=unicode)
    check(text)


# ------------------------------------------------------ written by hand

def test_anchors_aliases_and_merges():
    got = check("""\
base: &base {lr: 0.1, optimizer: SGD, nested: {a: 1}}
extra: &extra
  momentum: 0.9
  lr: 0.5
run:
  <<: [*base, *extra]
  lr: 0.2
solo:
  <<: *extra
list: &l [1, 2]
again: *l
dup: 1
dup: 2
self: &s [*l, x]
""")
    assert got["run"] == {"lr": 0.2, "momentum": 0.9, "optimizer": "SGD",
                          "nested": {"a": 1}}
    assert got["again"] is got["list"] and got["self"][0] is got["list"]
    assert got["run"]["nested"] is got["base"]["nested"]
    assert got["dup"] == 2
    check("a: &r [1, *r]\n")
    check("- &m {k: v}\n- <<: *m\n  j: w\n- {<<: [*m], =: eq}\n")


BLOCK_SCALARS = [
    "a: |\n  one\n  two\n\n\nb: 1\n",
    "a: |-\n  one\n  two\n\n\nb: 1\n",
    "a: |+\n  one\n  two\n\n\nb: 1\n",
    "a: >\n  folded\n  line\n\n  para\n    indented\n  back\n",
    "a: >-\n  x\n\n\n  y\n",
    "a: >+\n  x\n\n",
    "- |2\n    two extra\n   one extra\n- >1-\n  lead\n",
    "a: |  # comment\n  text\n",
    "a: |\n\n  after blank\n",
    "- |\n  last line without a break",
    "top: |\n text\n---\n",
]


@pytest.mark.parametrize("text", BLOCK_SCALARS)
def test_block_scalars(text):
    try:
        yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(ValueError):
            yaml_load.safe_load(text)
        return
    check(text)


def test_quoted_plain_and_flow_over_lines():
    check("""\
%YAML 1.1
---
# a comment
single: 'it''s

  folded  across   lines'
double: "tab\\tand \\
  continued \\x41\\u00e9\\U0001F600 \\N\\_\\L\\P
  \\ spaced"
plain: first part
  and the second
   and third

  after a blank line
loss_kwargs: {alpha: 0.5,
  beta: 0.5}
list: [a,
  b, [c, d],
  {e: f, g}, k: v, ]
seqs:
- - nested
  - more
- key: value
  other: [1, {x: y}]
-
- ~
empty_map: {}
empty_seq: []
no_value:
"quoted key": 1
...
""")
    assert yaml_load.safe_load("") is None
    assert yaml_load.safe_load("# only a comment\n") is None
    assert yaml_load.safe_load("---\n...\n") is None
    check("\ufeffa: 1\r\nb: [x,\r\n  y]\r\n")
    check(b"a: \xc3\xa9\n")


# ----------------------------------------------------------- refusals

REFUSED = {
    "a tab in the indentation": ("a:\n\tb: 1\n", 2),
    "a tag": ("a: 1\nb: !custom x\n", 2),
    "a python tag": ("a: !!python/name:os.system x\n", 1),
    "a complex key": ("a: 1\n? [b]\n: c\n", 2),
    "an unclosed flow collection": ("a: [1, 2\nb: 3\n", 2),
    "a %TAG directive": ("%TAG ! tag:example.com,2000:\n---\na: 1\n", 1),
    "an undefined alias": ("a: 1\nb: *nowhere\n", 2),
    "a bad indentation": ("a:\n  b: 1\n c: 2\n", 3),
    "two documents": ("a: 1\n---\nb: 2\n", 2),
    "an unhashable key": ("[a]: 1\n", 1),
    "a control character": ("a: \x07\n", 1),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_input_names_its_line(name):
    text, line = REFUSED[name]
    with pytest.raises(ValueError, match=f"line {line}, column"):
        yaml_load.safe_load(text)


# ----------------------------------------------------------- no pyyaml

def _imports_of(top):
    """Every import of the package ``top`` in the port, chip_smoke.py and
    the bucket emulator it runs, as ``file:line name``, and the number of
    files read."""
    files = sorted((ROOT / "mt3d_resenc_unet_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "bucket_emulator.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            found += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                      for n in names if n == top
                      or n.startswith(top + ".")]
    return found, len(files)


def test_no_module_of_the_port_imports_yaml():
    found, files = _imports_of("yaml")
    assert files > 50 and not found, found


# what the card's machine lacks or the port must not lean on: JAX and its
# package, tensorstore, the cloud SDKs and HTTP stacks, cryptography
@pytest.mark.parametrize("top", [
    "jax", "flax", "optax", "mt3d_resenc_unet_tpu", "tensorstore", "boto3",
    "botocore", "google.auth", "google.cloud", "requests", "fsspec",
    "cryptography"])
def test_no_module_of_the_port_imports(top):
    found, files = _imports_of(top)
    assert files > 50 and not found, found
