"""Scene generators, one module a generator, found by the name a
configuration gives (`scene.generator`). `make(**params)` returns a scene
description: plain NumPy data that both the program's Scene and the
reference are built from.

    {"shapes": [{"positions": (V, 3) f32, "indices": (F, 3) i32, "uvs": (V, 2) f32 or None}],
     "instances": [{"shape": int, "material": int, "transform": (4, 4) f32, "name": str}],
     "materials": [{"colour": (3,), "emission": (3,), "roughness": float, "type": "matte"}],
     "camera": {"eye": (3,), "target": (3,), "fov": degrees}}
"""

from __future__ import annotations

import importlib


def make(spec: dict) -> dict:
    """The description of the scene `spec` names: {"generator": name, ...params}."""
    params = {k: v for k, v in spec.items() if k != "generator"}
    return importlib.import_module(f"portbench.scenes.{spec['generator']}").make(**params)
