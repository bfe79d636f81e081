"""Version metadata for gwen.

Reference parity: src/gwen/__init__.py:1-9 exposes ``__version__``/``__author__``
via importlib metadata; we keep a plain module so the package works without being
installed.
"""

__version__ = "0.1.0"
__author__ = "gwen developers"
