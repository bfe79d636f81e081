#!/usr/bin/env bash
# One-command CI: lint + bytecode-compile + tests (reference parity:
# jenkins/Jenkinsfile:50-117 runs pytest; .pre-commit-config.yaml lints).
#
# This runs hermetically (no network): lint is the stdlib tools/lint.py;
# ruff/mypy run additionally when installed (see .github/workflows/ci.yml,
# ruff.toml, mypy.ini).
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== lint (tools/lint.py) =="
python tools/lint.py

SKIPPED=""
if command -v ruff >/dev/null 2>&1; then
  echo "== ruff =="
  ruff check .
else
  echo "!! SKIPPED: ruff (not installed — hermetic env; tools/lint.py covers"
  echo "!!   syntax/unused-imports/undefined-names; GH CI runs ruff)"
  SKIPPED="$SKIPPED ruff"
fi
if command -v mypy >/dev/null 2>&1; then
  echo "== mypy =="
  mypy gwen
else
  echo "!! SKIPPED: mypy (not installed — hermetic env; GH CI runs mypy)"
  SKIPPED="$SKIPPED mypy"
fi

echo "== api docs (tools/gen_docs.py --check) =="
python tools/gen_docs.py --check

echo "== html docs (tools/build_docs_html.py --check) =="
python tools/build_docs_html.py --check

echo "== compileall =="
python -m compileall -q gwen tests benchmarks bench.py chip_smoke.py __graft_entry__.py

echo "== pytest =="
python -m pytest tests/ -q

echo "== multi-process dryrun =="
python tools/multiproc_dryrun.py

if [ -n "$SKIPPED" ]; then
  echo "CI OK (with skipped gates:$SKIPPED — see markers above)"
else
  echo "CI OK"
fi
