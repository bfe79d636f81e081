#!/usr/bin/env python
"""Render the markdown docs to static HTML (the sphinx-build equivalent).

Reference parity: the reference builds sphinx HTML and publishes it via
gh-pages (`/root/reference/docs/`, `.github/workflows/documentation.yaml`).
This environment has no sphinx, so this is a stdlib renderer for the
markdown subset our docs use: ATX headings, fenced/indented code blocks,
blockquotes, unordered lists, tables, inline code/bold/links.

Usage:
    python tools/build_docs_html.py            # writes docs/html/
    python tools/build_docs_html.py --check    # exit 1 if output is stale
"""

from __future__ import annotations

import html
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SRC_DIRS = [REPO / "docs", REPO / "docs" / "reference"]
OUT = REPO / "docs" / "html"

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       max-width: 56rem; margin: 2rem auto; padding: 0 1rem;
       line-height: 1.55; color: #1c1e21; }
code, pre { font-family: ui-monospace, 'SF Mono', Menlo, Consolas, monospace;
            background: #f4f4f6; border-radius: 4px; }
code { padding: .1em .3em; font-size: .92em; }
pre { padding: .8rem 1rem; overflow-x: auto; }
pre code { padding: 0; background: none; }
h1, h2, h3, h4 { line-height: 1.25; margin-top: 1.6em; }
h1 { border-bottom: 2px solid #e3e5e8; padding-bottom: .3em; }
h2 { border-bottom: 1px solid #e3e5e8; padding-bottom: .2em; }
a { color: #0969da; text-decoration: none; }
a:hover { text-decoration: underline; }
blockquote { margin: 0; padding: .2rem 1rem; border-left: 4px solid #d0d4d9;
             color: #4b5563; }
table { border-collapse: collapse; }
th, td { border: 1px solid #d0d4d9; padding: .3rem .6rem; }
nav { font-size: .9em; color: #6b7280; margin-bottom: 1rem; }
""".strip()


def _inline(text: str) -> str:
    text = html.escape(text, quote=False)
    text = re.sub(r"``([^`]+)``", r"<code>\1</code>", text)
    text = re.sub(r"`([^`]+)`", r"<code>\1</code>", text)
    text = re.sub(r"\*\*([^*]+)\*\*", r"<strong>\1</strong>", text)
    text = re.sub(
        r"\[([^\]]+)\]\(([^)\s]+)\)",
        lambda m: f'<a href="{_link(m.group(2))}">{m.group(1)}</a>',
        text,
    )
    return text


def _link(target: str) -> str:
    if target.endswith(".md"):
        return target[:-3] + ".html"
    return target


def md_to_html(src: str) -> str:
    out: list[str] = []
    lines = src.splitlines()
    i = 0
    in_list = False

    def close_list() -> None:
        nonlocal in_list
        if in_list:
            out.append("</ul>")
            in_list = False

    while i < len(lines):
        line = lines[i]
        if line.startswith("```"):
            close_list()
            block = []
            i += 1
            while i < len(lines) and not lines[i].startswith("```"):
                block.append(lines[i])
                i += 1
            out.append("<pre><code>"
                       + html.escape("\n".join(block)) + "</code></pre>")
            i += 1
            continue
        if line.startswith("    ") and (not out or out[-1] != "<p>"):
            close_list()
            block = []
            while i < len(lines) and (lines[i].startswith("    ")
                                      or not lines[i].strip()):
                if not lines[i].strip() and not (
                        i + 1 < len(lines) and lines[i + 1].startswith("    ")):
                    break
                block.append(lines[i][4:])
                i += 1
            out.append("<pre><code>"
                       + html.escape("\n".join(block)) + "</code></pre>")
            continue
        m = re.match(r"(#{1,6})\s+(.*)", line)
        if m:
            close_list()
            level = len(m.group(1))
            out.append(f"<h{level}>{_inline(m.group(2))}</h{level}>")
            i += 1
            continue
        if line.startswith(("- ", "* ")):
            if not in_list:
                out.append("<ul>")
                in_list = True
            item = [line[2:]]
            i += 1
            while i < len(lines) and lines[i].startswith("  ") \
                    and not lines[i].startswith(("- ", "* ")):
                item.append(lines[i].strip())
                i += 1
            out.append(f"<li>{_inline(' '.join(item))}</li>")
            continue
        if line.startswith("> "):
            close_list()
            quote = []
            while i < len(lines) and lines[i].startswith(">"):
                quote.append(lines[i].lstrip("> "))
                i += 1
            out.append(f"<blockquote><p>{_inline(' '.join(quote))}</p>"
                       "</blockquote>")
            continue
        if line.startswith("|") and i + 1 < len(lines) \
                and re.match(r"^\|[\s\-|:]+\|$", lines[i + 1].strip()):
            close_list()
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            rows = ["<tr>" + "".join(f"<th>{_inline(c)}</th>" for c in cells)
                    + "</tr>"]
            i += 2
            while i < len(lines) and lines[i].startswith("|"):
                cells = [c.strip()
                         for c in lines[i].strip().strip("|").split("|")]
                rows.append("<tr>" + "".join(f"<td>{_inline(c)}</td>"
                                             for c in cells) + "</tr>")
                i += 1
            out.append("<table>" + "".join(rows) + "</table>")
            continue
        if not line.strip():
            close_list()
            i += 1
            continue
        para = [line]
        i += 1
        while i < len(lines) and lines[i].strip() \
                and not lines[i].startswith(("#", "- ", "* ", "> ", "|", "```",
                                             "    ")):
            para.append(lines[i])
            i += 1
        out.append(f"<p>{_inline(' '.join(para))}</p>")
    close_list()
    return "\n".join(out)


def _page(title: str, body: str, depth: int) -> str:
    home = "../" * depth + "index.html"
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)} — gwen</title>"
            f"<style>{_CSS}</style></head><body>"
            f"<nav><a href='{home}'>gwen docs</a></nav>"
            f"{body}</body></html>\n")


def build() -> dict[Path, str]:
    pages: dict[Path, str] = {}
    md_files = sorted(
        p for d in SRC_DIRS for p in d.glob("*.md") if OUT not in p.parents
    )
    for md in md_files:
        rel = md.relative_to(REPO / "docs").with_suffix(".html")
        title = md.stem if md.stem != "index" else "index"
        body = md_to_html(md.read_text())
        pages[OUT / rel] = _page(title, body, len(rel.parts) - 1)

    links = []
    for md in md_files:
        rel = md.relative_to(REPO / "docs").with_suffix(".html")
        first = md.read_text().lstrip().splitlines()[0].lstrip("# ")
        links.append(f"<li><a href='{rel.as_posix()}'>"
                     f"{html.escape(first)}</a></li>")
    index_body = ("<h1>gwen documentation</h1>"
                  "<p>GNN weather-ensemble framework — rendered "
                  "from the markdown docs by <code>tools/build_docs_html.py"
                  "</code>.</p><ul>" + "".join(links) + "</ul>")
    pages[OUT / "index.html"] = _page("gwen", index_body, 0)
    return pages


def main(argv: list[str]) -> int:
    pages = build()
    if "--check" in argv:
        stale = [p for p, content in pages.items()
                 if not p.exists() or p.read_text() != content]
        if stale:
            print("stale HTML docs (run: python tools/build_docs_html.py):")
            for p in stale:
                print(f"  {p.relative_to(REPO)}")
            return 1
        print(f"docs/html: {len(pages)} pages up to date")
        return 0
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "reference").mkdir(exist_ok=True)
    for p, content in pages.items():
        p.write_text(content)
    print(f"wrote {len(pages)} pages to {OUT.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
