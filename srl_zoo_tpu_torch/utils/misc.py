"""Small shared helpers (port of ``srl_zoo_tpu/utils/misc.py``): coloured
prints, dataset-folder names, folder creation and global seeding."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def _colored(text: str, code: int) -> str:
    return f"\033[{code}m{text}\033[0m"


def printGreen(text: str) -> None:
    print(_colored(str(text), 32), flush=True)


def printYellow(text: str) -> None:
    print(_colored(str(text), 33), flush=True)


def printRed(text: str) -> None:
    print(_colored(str(text), 31), flush=True)


def parseDataFolder(path: str) -> str:
    """``data/my_dataset``, ``my_dataset/`` or ``my_dataset`` ->
    ``my_dataset``."""
    path = path.rstrip("/")
    if path.startswith("data/"):
        path = path[len("data/"):]
    return path


def createFolder(path: str, exist_warning: str | None = None) -> None:
    """mkdir -p with an optional warning when the folder already exists."""
    if os.path.exists(path):
        if exist_warning:
            printYellow(exist_warning)
    else:
        os.makedirs(path, exist_ok=True)


def set_global_seeds(seed: int) -> None:
    """Seed python's, numpy's and torch's global generators. The model's
    initial weights come from their own ``torch.Generator``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
