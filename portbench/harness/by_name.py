"""Modules found by name: ``portbench/<folder>/<name>.py``, loaded by the file's path (a name may
hold dots and dashes), once a process. ``BENCHMARK.json`` and the data files name them:

* ``metrics/<metric>.py``: a per-layer or end-to-end metric's reader, ``read(r)``;
* ``traffic/<kind>.py``: a kind of mix (a mix file's ``kind``), ``prepare(run)``;
* ``systems/<system>.py``: how a configuration's scorer is built (its ``system``);
* ``reference/<reference>.py``: a configuration's plain reference (its ``reference``).

A new cell, mix, metric or family of models is new files and entries: nothing here branches
on a name.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def module(folder: str, name: str):
    key = f"portbench_{folder}_{name}"
    if key not in sys.modules:
        path = os.path.join(HERE, folder, f"{name}.py")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {folder} named {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]
