"""Scene-texture sampling and normal mapping (svgf_tpu/ops/texture.py;
reference Common.cuh:1327-1418).

  * `sample_texture` = textureSample (Common.cuh:1329-1354): negative
    coordinates mirrored as 1-c, the fractional part, the NEAREST texel
    (no filtering), value / 255. The texel is a plain index gather of the
    (K, S, S, 4) u8 stack.
  * `eval_texture` = EvalTexture (Common.cuh:1386-1394): INVALID_ID slots
    give vec4(1); optional sRGB->linear on rgb only (ToLinear,
    Common.cuh:189-211).
  * `apply_normal_map` = EvalNormalMap (Common.cuh:1405-1418) with the
    tangent frame of PathTrace.cuh:182-185, quirk included: the bitangent
    crosses the WORLD normal with the OBJECT-space tangent before
    transforming.

Every function is batched over shading lanes, the texture ids gathered
per lane.
"""

from __future__ import annotations

import torch

INVALID_ID = -1


def to_linear(rgb):
    """sRGB -> linear transfer (Common.cuh:189-192)."""
    return torch.where(
        rgb <= 0.04045,
        rgb / 12.92,
        ((torch.clamp_min(rgb, 0.04045) + 0.055) / 1.055) ** 2.4,
    )


def _wrap(c):
    """textureSample's coordinate wrap (Common.cuh:1333-1337): negatives
    mirrored as 1-c, then the fractional part c - floor(c) (torch.fmod
    would keep the sign of c)."""
    c = torch.where(c < 0.0, 1.0 - c, c)
    return c - torch.floor(c)


def sample_texture(textures, tex_id, uv):
    """Nearest-texel fetch from the (K, S, S, 4) u8 stack -> (R, 4) f32.
    tex_id: (R,) i32, INVALID_ID allowed (the caller masks); uv: (R, 2)."""
    k, h, w = textures.shape[0], textures.shape[1], textures.shape[2]
    u = _wrap(uv[..., 0])
    v = _wrap(uv[..., 1])
    # the int32 cast truncates, as astype does
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1)
    layer = torch.clamp(tex_id, 0, k - 1)
    texel = textures[layer.long(), y.long(), x.long()]  # (R, 4) u8
    return texel.to(torch.float32) / 255.0


def eval_texture(textures, tex_id, uv, linear: bool):
    """EvalTexture (Common.cuh:1386-1394): vec4(1) for INVALID_ID slots,
    optional sRGB->linear on rgb (alpha untouched)."""
    val = sample_texture(textures, tex_id, uv)
    if linear:
        val = torch.cat([to_linear(val[..., :3]), val[..., 3:4]], dim=-1)
    return torch.where((tex_id >= 0)[..., None], val, 1.0)


def apply_normal_map(textures, normal_tex_id, uv, normal_world, tangent_obj,
                     normal_transform, transform_direction_fn, normalize_fn):
    """EvalNormalMap (Common.cuh:1405-1418) with the PathTrace.cuh:182-185
    tangent frame (TransformDirection normalizes, Common.cuh:305-309):

        T  = TransformDirection(NormalTransform, tangent.xyz)
        B  = TransformDirection(NormalTransform,
                 normalize(cross(N_world, tangent.xyz) * tangent.w))
        n' = normalize(TBN @ normalize(2*tex - 1))       for textured lanes

    normal_world: (R,3) world interpolated normal; tangent_obj: (R,4)
    object-space tangent and handedness; normal_transform: (R,4,4) per-lane
    inverse-transpose instance matrices."""
    t_obj = tangent_obj[..., :3]
    w = tangent_obj[..., 3:4]
    T = transform_direction_fn(normal_transform, t_obj)
    b_obj = normalize_fn(torch.linalg.cross(normal_world, t_obj) * w)
    B = transform_direction_fn(normal_transform, b_obj)

    ntex = eval_texture(textures, normal_tex_id, uv, linear=False)[..., :3]
    local = normalize_fn(2.0 * ntex - 1.0)
    mapped = normalize_fn(
        T * local[..., 0:1] + B * local[..., 1:2] + normal_world * local[..., 2:3]
    )
    return torch.where((normal_tex_id >= 0)[..., None], mapped, normal_world)
