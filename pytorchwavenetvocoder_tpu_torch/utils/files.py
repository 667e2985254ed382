"""File listing helpers (reference ``utils/utils.py:129-162``)."""

from __future__ import annotations

import fnmatch
import os


def find_files(directory: str, pattern: str = "*.wav",
               use_dir_name: bool = True) -> list[str]:
    """Recursively find files matching ``pattern``.

    With ``use_dir_name=False`` the leading ``directory`` prefix is stripped
    from each result (reference behavior for building parallel wav/feat
    lists, `utils.py:129-147`).
    """
    files = []
    for root, _, filenames in os.walk(directory, followlinks=True):
        for filename in fnmatch.filter(filenames, pattern):
            files.append(os.path.join(root, filename))
    if not use_dir_name:
        files = [f.replace(directory + "/", "") for f in files]
    return files


def read_txt(file_list: str) -> list[str]:
    """Read a .scp-style list file into a list of non-empty lines."""
    with open(file_list, "r") as f:
        return [line.strip() for line in f if line.strip()]
