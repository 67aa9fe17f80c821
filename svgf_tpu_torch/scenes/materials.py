"""The materials scene: the Cornell box dressed in every material and light
type the tracer has.

  * walls (floor, ceiling, back): MATTE with a 64x64 checkerboard colour
    texture whose alpha is 128 on a quarter of its texels (so the scene has
    opacity pass-through through the alpha fold) and a tilted normal map;
    their quads carry UVs from 0 to 2, so the textures wrap;
  * left wall: PBR, metallic 1.0, roughness 0.3;
  * right wall: PBR, metallic 0.0, roughness 0.0 (the delta lobe);
  * tall block: GLASS, roughness 0.0;
  * short block: VOLUMETRIC, scattering colour 0.6, transmission depth 0.5,
    anisotropy 0.3;
  * both blocks raised LIFT above the floor: a ray inside a block would
    otherwise meet its bottom face and the floor at the same t, a tie that
    1-ulp roundings of t decide either way;
  * the area light unchanged, and one Environment with a 64x128 equirect
    texture, seen through the open front of the box.

`dress_cornell` takes the host classes as arguments, so that the tests
dress svgf_tpu's Cornell box with the same data.
"""

from __future__ import annotations

import numpy as np

from svgf_tpu_torch.core.scene import Environment, Material, MaterialType, Scene
from svgf_tpu_torch.scenes.cornell import cornell_box

TEX = 64
ENV_H, ENV_W = 64, 128
LIFT = 0.01


def checker_texture() -> np.ndarray:
    """(64, 64, 4) u8: 8-texel cells of two colours; alpha 128 where both
    cell indices are even (a quarter of the texels), else 255."""
    y, x = np.mgrid[0:TEX, 0:TEX]
    cy, cx = y // 8, x // 8
    odd = (cy + cx) % 2 == 1
    rgb = np.where(odd[..., None], np.array([235, 228, 210]), np.array([70, 90, 160]))
    alpha = np.where((cy % 2 == 0) & (cx % 2 == 0), 128, 255)
    return np.concatenate([rgb, alpha[..., None]], axis=-1).astype(np.uint8)


def normal_texture() -> np.ndarray:
    """(64, 64, 4) u8 tangent-space normals tilted by 0.35 along +-u in
    16-texel stripes, encoded as (n + 1) / 2."""
    x = np.mgrid[0:TEX, 0:TEX][1]
    tilt = np.where((x // 16) % 2 == 0, 0.35, -0.35)
    n = np.stack([tilt, 0.1 * np.ones_like(tilt), np.ones_like(tilt)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgb = np.round((n * 0.5 + 0.5) * 255.0)
    return np.concatenate([rgb, np.full((TEX, TEX, 1), 255.0)], axis=-1).astype(np.uint8)


def environment_texture() -> np.ndarray:
    """(64, 128, 3) f32 equirect sky: a blue gradient from the zenith to a
    dim ground, with a small warm sun."""
    v = (np.arange(ENV_H)[:, None] + 0.5) / ENV_H           # 0 at the zenith
    u = (np.arange(ENV_W)[None, :] + 0.5) / ENV_W
    sky = np.stack([0.3 + 0.4 * v, 0.45 + 0.35 * v, 0.9 - 0.2 * v], axis=-1) * (v < 0.5)[..., None]
    ground = np.array([0.15, 0.12, 0.1]) * (v >= 0.5)[..., None]
    img = np.broadcast_to(sky + ground, (ENV_H, ENV_W, 3)).copy()
    sun = ((u - 0.3) ** 2 + (v - 0.25) ** 2) < 0.003
    img[sun] = (6.0, 5.0, 3.5)
    return img.astype(np.float32)


def dress_cornell(scene, material_cls, material_type, environment_cls):
    """Give a Cornell box (scenes/cornell.py or svgf_tpu's copy, with its
    blocks) the materials scene's materials, textures and environment,
    built from the host classes given. Returns the scene."""
    walls = scene.shapes[0]
    quad_uv = np.array([[0.0, 0.0], [2.0, 0.0], [2.0, 2.0], [0.0, 2.0]], np.float32)
    walls.uvs = np.tile(quad_uv, (walls.positions.shape[0] // 4, 1))
    scene.textures = [checker_texture(), normal_texture()]
    scene.textures_enabled = True
    scene.materials[0] = material_cls(colour=(0.725, 0.71, 0.68), colour_texture=0,
                                      normal_texture=1)
    scene.materials[1] = material_cls(colour=(0.63, 0.065, 0.05), material_type=material_type.PBR,
                                      metallic=1.0, roughness=0.3)
    scene.materials[2] = material_cls(colour=(0.14, 0.45, 0.091), material_type=material_type.PBR,
                                      metallic=0.0, roughness=0.0)
    scene.materials.append(material_cls(colour=(0.95, 0.97, 0.99),
                                        material_type=material_type.GLASS, roughness=0.0))
    scene.materials.append(material_cls(colour=(0.8, 0.85, 0.9),
                                        material_type=material_type.VOLUMETRIC,
                                        scattering_colour=(0.6, 0.6, 0.6),
                                        transmission_depth=0.5, anisotropy=0.3))
    glass, volume = len(scene.materials) - 2, len(scene.materials) - 1
    scene.instances[4].material = glass    # the tall block
    scene.instances[5].material = volume   # the short block
    for block in scene.instances[4:6]:
        block.transform = np.array(block.transform, np.float32)
        block.transform[1, 3] += LIFT
    scene.env_textures = [environment_texture()]
    scene.environments.append(environment_cls(emission=(1.0, 1.0, 1.0), emission_texture=0))
    return scene


def cornell_materials(aspect: float = 1.0) -> Scene:
    """The Cornell box of scenes/cornell.py in the materials scene's dress."""
    return dress_cornell(cornell_box(aspect=aspect), Material, MaterialType, Environment)
