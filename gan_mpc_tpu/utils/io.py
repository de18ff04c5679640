"""Run persistence: auto-increment run directories, params, JSON artifacts.

Capability parity with ``/root/reference/utils.py:121-156`` (save_all_args /
load_params): each run gets the next integer directory under a model family
path; params + config.json + loss-curve JSONs are written there and can be
reloaded to reconstruct the model. Params are serialized in flax's
msgpack format (portable, no pickle; ``utils/serialization.py``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from gan_mpc_tpu.utils import serialization


def new_run_dir(base_dir: str) -> str:
    """Create and return ``base_dir/<n+1>`` where n is the largest existing
    integer subdirectory (reference scheme, ``utils.py:135-141``)."""
    os.makedirs(base_dir, exist_ok=True)
    existing = [int(d) for d in os.listdir(base_dir) if d.isdigit()]
    run_id = max(existing) + 1 if existing else 0
    path = os.path.join(base_dir, str(run_id))
    os.makedirs(path, exist_ok=True)
    return path


def save_json(data, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fp:
        json.dump(data, fp, indent=2, sort_keys=True)


def load_json(path: str):
    with open(path, "r") as fp:
        return json.load(fp)


def save_params(params, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fp:
        fp.write(serialization.to_bytes(params))


def load_params(template, path: str):
    """Deserialize into the structure of ``template`` (a params pytree with
    the right shapes, e.g. from ``policy.init``)."""
    with open(path, "rb") as fp:
        return serialization.from_bytes(template, fp.read())


def latest_run_dir(base_dir: str, run_id: Optional[str] = None) -> str:
    if run_id is not None:
        return os.path.join(base_dir, str(run_id))
    existing = [int(d) for d in os.listdir(base_dir) if d.isdigit()]
    if not existing:
        raise FileNotFoundError(f"no runs under {base_dir!r}")
    return os.path.join(base_dir, str(max(existing)))
