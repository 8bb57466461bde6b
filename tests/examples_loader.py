"""Load an example script (``examples/`` or ``examples_torch/``) by path."""

import importlib.util
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]


def load_example(folder: str, stem: str):
    """``<repo>/<folder>/<stem>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{stem}", REPO / folder / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
