"""The reference's conv bodies, one file each, found by name.

``benchmark/reference/bodies/<name>.py`` is the body that a configuration
file names as ``model.body``. A body file holds:

- ``Body``, the ``nn.Module`` under the reference checkpoint's module names
  (it becomes ``Conv_Body``), with class attributes ``dim_out`` and
  ``stride`` and a static ``frozen(freeze_at)``, the module names under it
  that FREEZE_AT stages freeze;
- ``feature_hw(h, w)``, the body's feature extent of an (h, w) image;
- ``CONV_BODY``, the part of the program's ``MODEL.CONV_BODY`` before its
  first dot, lower-case, that names this body in the program's config;
- ``FREEZE_KEY``, the program's config key of its freeze depth
  ("ResNet.FREEZE_AT"), or None for a body with no frozen stages;
- optionally ``mismatches(cfg)``, the body's own settings that the
  reference builds in and the program's config states (an HRNet's
  ``MODEL.EXTRA`` stage table): a list of where they disagree, empty
  where they agree; the harness refuses to run on any.

The shared layers (``Conv2d``, ``FrozenBatchNorm``, ``Bottleneck``, ...)
are ``benchmark.reference.model``'s; a body file imports them from there.
A new body is a new file here, and nothing else of the harness changes.
"""
from __future__ import annotations

import importlib
import os
import re

DIR = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def conv_body(name: str):
    """The module of body ``name``, imported on first use."""
    path = os.path.join(DIR, f"{name}.py")
    if not NAME.match(str(name)) or not os.path.isfile(path):
        rel = os.path.relpath(path, os.path.dirname(os.path.dirname(os.path.dirname(DIR))))
        raise LookupError(f"no conv body {name!r} in the reference: {rel} is missing")
    return importlib.import_module(f"{__name__}.{name}")
