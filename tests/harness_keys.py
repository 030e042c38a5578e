"""The JSON report keys a root harness writes, read from its source: the
keywords of the dict(...) calls that build the report (for tests that
hold the port's harnesses to the JAX tools' report layout)."""
import ast
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _dict_call_keys(call):
    """{keyword: nested keys or None} of a dict(...) call."""
    out = {}
    for kw in call.keywords:
        v = kw.value
        is_dict = isinstance(v, ast.Call) and getattr(v.func, "id", None) == "dict"
        out[kw.arg] = _dict_call_keys(v) if is_dict and v.keywords else None
    return out


def report_layout(tool: str) -> dict:
    """For tools/<tool>.py: the keys of `report`, `checks`, the dict
    appended to `curve` (when there is one) and the metrics written into
    `st["metrics"]` or by `m.update` (when there are)."""
    tree = ast.parse((REPO / "tools" / f"{tool}.py").read_text())
    out = {"metrics": set()}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and getattr(node.value.func, "id", None) == "dict":
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in ("report", "checks"):
                    out[t.id] = _dict_call_keys(node.value)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            owner = getattr(node.func.value, "id", None)
            if node.func.attr == "append" and owner == "curve":
                out["curve"] = _dict_call_keys(node.args[0])
            if node.func.attr == "update" and owner == "m":
                out["metrics"] |= {kw.arg for kw in node.keywords}
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Subscript) \
                        and isinstance(t.value.slice, ast.Constant) \
                        and t.value.slice.value == "metrics":
                    out["metrics"].add(t.slice.value)
    return out
