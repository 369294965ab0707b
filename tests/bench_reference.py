"""The JSON lines the reference's root benchmark scripts print, read from
their sources: for each ``json.dumps({...})`` of a script, its keys (a
nested dict's keys under its own key) and its metric name when that is a
literal. The port's tools are held to these in the ``test_torch_bench*``
files."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _keys(node: ast.Dict):
    out = {}
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant):
            out[k.value] = _keys(v) if isinstance(v, ast.Dict) else None
    return out


def printed_dicts(script: str, function: str = "main"):
    """[(keys, metric or None)] of every ``json.dumps`` of a dict literal in
    ``function`` of the root ``script``, in source order."""
    tree = ast.parse((ROOT / script).read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == function)
    found = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            metric = None
            for k, v in zip(d.keys, d.values):
                if (isinstance(k, ast.Constant) and k.value == "metric"
                        and isinstance(v, ast.Constant)):
                    metric = v.value
            found.append((node.lineno, _keys(d), metric))
    return [(keys, metric) for _, keys, metric in sorted(
        found, key=lambda t: t[0])]


def key_tree(d: dict):
    """A printed dict's keys in the form ``printed_dicts`` gives."""
    return {k: key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}
