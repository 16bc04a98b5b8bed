"""Modules found by name: metrics/<metric>.py, calls/<call>.py and
workops/<op>.py are loaded from their files, so that a later change adds a
metric, a kind of call or an operation of the work counts as a file of its
own, and edits none. Each file is loaded once a process."""

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load(folder: str, name: str):
    """The module kzgbench/<folder>/<name>.py."""
    key = "kzgbench._byname." + folder + "." + "".join(c if c.isalnum() else f"_{ord(c):02x}" for c in name)
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no {folder} named {name!r} (looked for {path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod
