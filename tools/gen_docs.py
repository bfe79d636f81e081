"""Generate API reference docs from docstrings (the sphinx-equivalent).

Reference parity: the reference builds sphinx API docs and publishes them via
a gh-pages workflow (`/root/reference/docs/`,
`.github/workflows/documentation.yaml`). This environment has no sphinx, so
this is a stdlib generator: it walks every ``gwen`` module, extracts
public classes/functions with signatures and full docstrings via ``inspect``,
and writes one markdown page per module plus an index to ``docs/reference/``.

Usage:
    python tools/gen_docs.py           # (re)generate docs/reference/
    python tools/gen_docs.py --check   # exit 1 if committed docs are stale
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys
from dataclasses import fields, is_dataclass

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

OUT_DIR = os.path.join(_REPO_ROOT, "docs", "reference")


def _configure_jax() -> None:
    import jax

    # Force the CPU so doc generation never touches an accelerator.
    jax.config.update("jax_platforms", "cpu")


def _iter_modules():
    import gwen

    yield "gwen", gwen
    for info in pkgutil.walk_packages(gwen.__path__, "gwen."):
        if info.name.rsplit(".", 1)[-1].startswith("_"):
            continue
        try:
            yield info.name, importlib.import_module(info.name)
        except ImportError:
            # e.g. the ctypes graphcore .so is discovered as an extension
            # module but is a plain shared library, not importable.
            continue


def _public_names(mod) -> list[str]:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    names = []
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            names.append(name)
    return names


_ADDR_RE = None


def _signature(obj) -> str:
    global _ADDR_RE
    import re

    if _ADDR_RE is None:
        _ADDR_RE = re.compile(r"<([\w.]+)[^>]* at 0x[0-9a-f]+>")
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # Default values whose repr embeds a memory address (e.g. jax-wrapped
    # activation functions) would make generation nondeterministic.
    return _ADDR_RE.sub(r"<\1>", sig)


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else ""


def _class_section(name: str, cls) -> list[str]:
    lines = [f"### `class {name}{_signature(cls)}`", ""]
    if _doc(cls):
        lines += [_doc(cls), ""]
    if is_dataclass(cls):
        lines.append("**Fields:**")
        lines.append("")
        for f in fields(cls):
            tp = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", str(f.type))
            lines.append(f"- `{f.name}: {tp}`")
        lines.append("")
    for mname, meth in sorted(vars(cls).items()):
        if mname.startswith("_") and mname != "__call__":
            continue
        func = meth
        kind = ""
        if isinstance(meth, staticmethod):
            func, kind = meth.__func__, "staticmethod "
        elif isinstance(meth, classmethod):
            func, kind = meth.__func__, "classmethod "
        elif isinstance(meth, property):
            lines.append(f"#### `property {name}.{mname}`")
            lines.append("")
            if _doc(meth.fget):
                lines += [_doc(meth.fget), ""]
            continue
        if not inspect.isfunction(func):
            continue
        lines.append(f"#### `{kind}{name}.{mname}{_signature(func)}`")
        lines.append("")
        if _doc(func):
            lines += [_doc(func), ""]
    return lines


def _module_page(modname: str, mod) -> str:
    lines = [f"# `{modname}`", ""]
    if _doc(mod):
        lines += [_doc(mod), ""]
    names = _public_names(mod)
    for name in names:
        obj = getattr(mod, name, None)
        if obj is None:
            continue
        # Re-exports in package __init__: link rather than duplicate.
        owner = getattr(obj, "__module__", modname)
        if owner != modname and (inspect.isclass(obj) or inspect.isfunction(obj)):
            lines.append(f"- `{name}` — re-exported from [`{owner}`]({owner}.md)")
            continue
        if inspect.isclass(obj):
            lines += _class_section(name, obj)
        elif inspect.isfunction(obj):
            lines.append(f"### `{name}{_signature(obj)}`")
            lines.append("")
            if _doc(obj):
                lines += [_doc(obj), ""]
    # Collapse the re-export bullet list spacing.
    text = "\n".join(lines)
    while "\n\n\n" in text:
        text = text.replace("\n\n\n", "\n\n")
    return text.rstrip() + "\n"


def generate() -> dict[str, str]:
    _configure_jax()
    pages: dict[str, str] = {}
    index = [
        "# API reference",
        "",
        "Generated from docstrings by `tools/gen_docs.py` — do not edit by",
        "hand; run `python tools/gen_docs.py` after changing public APIs",
        "(`tools/ci.sh` fails when these pages are stale).",
        "",
    ]
    for modname, mod in _iter_modules():
        page = _module_page(modname, mod)
        pages[f"{modname}.md"] = page
        summary = (_doc(mod).splitlines() or [""])[0]
        index.append(f"- [`{modname}`]({modname}.md) — {summary}")
    index.append("")
    pages["index.md"] = "\n".join(index)
    return pages


def main() -> int:
    check = "--check" in sys.argv
    pages = generate()
    stale = []
    os.makedirs(OUT_DIR, exist_ok=True)
    existing = {f for f in os.listdir(OUT_DIR) if f.endswith(".md")}
    for fname, content in pages.items():
        path = os.path.join(OUT_DIR, fname)
        old = None
        if os.path.exists(path):
            with open(path) as fh:
                old = fh.read()
        if old != content:
            stale.append(fname)
            if not check:
                with open(path, "w") as fh:
                    fh.write(content)
    orphans = existing - set(pages)
    for fname in orphans:
        stale.append(fname + " (orphan)")
        if not check:
            os.remove(os.path.join(OUT_DIR, fname))
    if check and stale:
        print("stale API docs (run `python tools/gen_docs.py`):")
        for f in sorted(stale):
            print(f"  docs/reference/{f}")
        return 1
    print(f"docs: {len(pages)} pages, {len(stale)} updated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
