"""Pickle/npz persistence with the reference's on-disk contract.

Reference: utils/load_save_utils.py:9-34.  File formats are kept
bit-compatible (pickle HIGHEST_PROTOCOL, same append semantics) so
artifacts are interchangeable between the reference and this framework.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def save_binary(obj, filename: str, append=False) -> None:
    """Pickle `obj`; optionally append to an existing file.

    append=True      : existing list contents + obj (both lists)
    append="embeds"  : np.vstack(existing, obj)
    Reference: load_save_utils.py:9-21.
    """
    if filename[-4:] != ".pkl":
        filename = filename + ".pkl"
    if os.path.exists(filename) and append:
        contents = load_binary(filename)
        if append == "embeds":
            obj = np.vstack((contents, obj))
        elif append:
            obj = contents + obj
    with open(filename, "wb") as outfile:
        pickle.dump(obj, outfile, pickle.HIGHEST_PROTOCOL)


def load_binary(filename: str):
    with open(filename, "rb") as infile:
        return pickle.load(infile)


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)
