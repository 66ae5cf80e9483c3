"""Small IO helpers (port of cim_tpu/utils/io.py; reference lib/utils/io.py
save_object / load_object)."""
from __future__ import annotations

import json
import os
import pickle


def save_object(obj, file_name):
    file_name = os.path.abspath(file_name)
    os.makedirs(os.path.dirname(file_name), exist_ok=True)
    with open(file_name, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)


def load_object(file_name):
    with open(file_name, "rb") as f:
        return pickle.load(f)


def save_json(obj, file_name, **kw):
    file_name = os.path.abspath(file_name)
    os.makedirs(os.path.dirname(file_name), exist_ok=True)
    with open(file_name, "w") as f:
        json.dump(obj, f, **kw)


def load_json(file_name):
    with open(file_name) as f:
        return json.load(f)
