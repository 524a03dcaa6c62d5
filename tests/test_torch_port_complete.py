"""The port covers all of augustus_tpu: every module has its counterpart
in augustus_tpu_torch, every option key that augustus_tpu reads the port
reads too, and every command line of augustus_tpu has the port's, run
with JAX refused by tests/test_torch_cli_nojax.py.  Static: the sources
are read with `ast`; neither package is imported."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "augustus_tpu", "augustus_tpu_torch"
# the port's modules under another name: the Pallas kernel and its packing
# and preparation programs
RENAMED = {"engine/pallas_scan.py": "engine/viterbi.py",
           "engine/pallas_pack.py": "engine/pack.py",
           "engine/pallas_prep.py": "engine/device_prep.py"}
# what the option keys are read from: `props.get_int("sample")`,
# `opts.get("seq")`, `args.get("species")` and the same through `self.`
RECEIVERS = ("props", "opts", "args")
# the port's only key that augustus_tpu does not read: where the kernels
# run (pipeline/optimize.py's --device; the other entry points take it
# before their options are read)
PORT_ONLY_KEYS = {"device"}


def _modules(pkg):
    """Every .py file of pkg, relative to it, with '/' separators."""
    top = os.path.join(ROOT, pkg)
    return sorted(
        os.path.relpath(os.path.join(d, f), top).replace(os.sep, "/")
        for d, _, fs in os.walk(top) for f in fs if f.endswith(".py"))


def _option_keys(pkg) -> dict:
    """{key: [files]} of every string constant that pkg's sources read
    through a `get*` method of props, opts or args."""
    out = {}
    for rel in _modules(pkg):
        path = os.path.join(ROOT, pkg, rel)
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith("get") and node.args):
                continue
            recv = node.func.value
            name = recv.id if isinstance(recv, ast.Name) else \
                recv.attr if isinstance(recv, ast.Attribute) else None
            key = node.args[0]
            if name in RECEIVERS and isinstance(key, ast.Constant) \
                    and isinstance(key.value, str):
                out.setdefault(key.value, []).append(rel)
    return out


def _nojax_modules() -> set:
    """The modules of the CASES of tests/test_torch_cli_nojax.py."""
    path = os.path.join(ROOT, "tests", "test_torch_cli_nojax.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "CASES"
                for t in node.targets):
            return {c.elts[1].value for c in node.value.elts}
    raise AssertionError("no CASES in test_torch_cli_nojax.py")


@pytest.mark.parametrize("rel", _modules(REF))
def test_every_module_has_its_counterpart(rel):
    want = RENAMED.get(rel, rel)
    assert os.path.isfile(os.path.join(ROOT, PORT, want)), \
        f"{REF}/{rel} has no counterpart {PORT}/{want}"


def test_renamed_modules_are_augustus_tpu_modules():
    assert set(RENAMED) <= set(_modules(REF))
    assert not set(RENAMED) & set(_modules(PORT))


def test_every_option_key_is_read_by_the_port():
    ref, port = _option_keys(REF), _option_keys(PORT)
    assert len(ref) > 100
    missing = {k: ref[k] for k in sorted(set(ref) - set(port))}
    assert not missing, f"keys only augustus_tpu reads: {missing}"
    extra = {k: port[k] for k in sorted(set(port) - set(ref))}
    assert set(extra) == PORT_ONLY_KEYS, f"keys only the port reads: {extra}"


def test_every_command_line_runs_with_jax_refused():
    clis = [r[len("cli/"):-len(".py")] for r in _modules(REF)
            if r.startswith("cli/") and r != "cli/__init__.py"]
    assert "getSeq" in clis
    cases = _nojax_modules()
    missing = [c for c in clis if f"{PORT}.cli.{c}" not in cases]
    assert not missing, f"command lines without a no-JAX case: {missing}"
