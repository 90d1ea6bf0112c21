"""AST-level source lint: host syncs outside phase edges (port of
repro.analysis.lint).

A device value read on the host (``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, the port's host copies ``u32.to_numpy`` and
``u32.host_copy``) or a wait (``synchronize()``: ``torch.cuda``,
``Mesh.synchronize``, events, streams) is a phase-EDGE operation: it
belongs where a window closes, a snapshot is cut, a round reports or a
benchmark stops a clock. Inside anything the engine calls per window it
serializes the host behind the device. The lint walks every file under
``src/repro_torch/`` and flags each such call whose enclosing qualname is
not covered by the ``lint.allow`` patterns in ``contracts.json`` (fnmatch
on ``relpath:qualname``, e.g. ``obs/trace.py:*`` or
``pipeline/engine_bridge.py:WindowCommitter.resize``).

This complements the recorded-call check: that one catches a sync inside
a registered program as it runs; the lint catches one anywhere in the
package, also on paths no program drives.
"""

from __future__ import annotations

import ast
import fnmatch
import os

from repro_torch.analysis.checks import Violation

# Methods that read a device value on the host or wait for the device.
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# The port's own host copies (core/u32.py).
HOST_COPIES = {"to_numpy", "host_copy"}


def _call_name(node: ast.Call) -> str | None:
    """The flagged name of the called expression, or None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in SYNC_METHODS:
            return f.attr
        if (f.attr in HOST_COPIES and isinstance(f.value, ast.Name)
                and f.value.id == "u32"):
            return f"u32.{f.attr}"
        return None
    if isinstance(f, ast.Name) and f.id in HOST_COPIES:
        return f.id
    return None


class _Walker(ast.NodeVisitor):
    """Collects (lineno, call, qualname) for every flagged call."""

    def __init__(self):
        self.stack: list[str] = []
        self.hits: list[tuple[int, str, str]] = []

    def _walk_scope(self, node, name: str):
        self.stack.append(name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_ClassDef(self, node):
        self._walk_scope(node, node.name)

    def visit_FunctionDef(self, node):
        self._walk_scope(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        name = _call_name(node)
        if name is not None:
            qual = ".".join(self.stack) or "<module>"
            self.hits.append((node.lineno, name, qual))
        self.generic_visit(node)


def lint_file(path: str, rel: str, allow: list[str]) -> list[Violation]:
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation(rel, "lint.syntax", f"unparseable source: {e}")]
    w = _Walker()
    w.visit(tree)
    out: list[Violation] = []
    for lineno, call, qual in w.hits:
        site = f"{rel}:{qual}"
        if any(fnmatch.fnmatch(site, pat) for pat in allow):
            continue
        out.append(Violation(
            rel, f"lint.{call}",
            f"{call} at line {lineno} in {qual} -- host sync outside the "
            f"allowlisted phase-edge sites; add '{site}' to contracts.json "
            "[lint.allow] only if this site really is a phase edge"))
    return out


def lint_tree(root: str, allow: list[str]) -> list[Violation]:
    """Lint every ``.py`` under ``root`` (skipping __pycache__)."""
    out: list[Violation] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            out.extend(lint_file(path, rel, allow))
    return out


def default_root() -> str:
    """``src/repro_torch``: the package directory itself."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
