"""Participating media: exponential transmittance sampling (Beer-Lambert)
and the Henyey-Greenstein phase function (svgf_tpu/ops/media.py;
reference Common.cuh:977-1013, 1141-1187).

Reference quirk reproduced (PARITY.md): `EvalPhase` / `SamplePhasePDF`
compute Denom = pow(1+g^2-2g cos, 1.5) and divide by Denom * sqrt(Denom),
an exponent of 2.25 where Henyey-Greenstein has 1.5. Both share the
formula, so their ratio is still ScatteringColour * Density; only the MIS
mixture's denominator sees the biased value. `sample_phase` draws from the
true HG inverse CDF, as the reference does.
"""

from __future__ import annotations

import torch

from svgf_tpu_torch.ops.geometry import MAX_LENGTH, PI, basis_from_z, dot, sqrt

_EPS = 1e-18


def sample_transmittance(density, max_distance, rl, rd):
    """Distance to the next medium event (Common.cuh:978-991): one of the
    3 colour channels picked with `rl`, the exponential CDF inverted with
    `rd`, clamped to the surface distance. density (R,3); the rest (R,)."""
    channel = torch.clamp((rl * 3.0).to(torch.int32), 0, 2)
    d = torch.gather(density, -1, channel[..., None].long())[..., 0]
    dist = torch.where(d == 0.0, MAX_LENGTH, -torch.log1p(-rd) / torch.clamp_min(d, _EPS))
    return torch.minimum(dist, max_distance)


def eval_transmittance(density, distance):
    """Beer-Lambert attenuation exp(-density*distance) (Common.cuh:993-997)."""
    return torch.exp(-density * distance[..., None])


def sample_transmittance_pdf(density, distance, max_distance):
    """Channel-averaged exponential pdf (Common.cuh:999-1013): inside the
    medium mean(d*exp(-d*x)); at the surface the residual mass
    mean(exp(-d*max))."""
    pdf_in = torch.mean(density * torch.exp(-density * distance[..., None]), dim=-1)
    pdf_out = torch.mean(torch.exp(-density * max_distance[..., None]), dim=-1)
    return torch.where(distance < max_distance, pdf_in, pdf_out)


def _phase_function(anisotropy, cosine):
    """The reference's HG lobe with its exponent of 2.25 (Common.cuh:1170-1173);
    the base is floored at 1e-4 (|g| -> 1 forward scatter), as in svgf_tpu."""
    x = 1.0 + anisotropy * anisotropy - 2.0 * anisotropy * cosine
    denom = torch.clamp_min(x, 1e-4) ** 1.5
    return (1.0 - anisotropy * anisotropy) / (4.0 * PI * denom * sqrt(denom))


def sample_phase(density, anisotropy, outgoing, ruv):
    """A scatter direction from the true HG inverse CDF around -outgoing
    (Common.cuh:1145-1163); 0 where density == 0."""
    g = anisotropy
    iso = torch.abs(g) < 1e-3
    safe_g = torch.where(iso, 1.0, g)  # keeps the untaken branch finite
    square = (1.0 - g * g) / (1.0 + g - 2.0 * g * ruv[..., 1])
    cos_theta = torch.where(
        iso, 1.0 - 2.0 * ruv[..., 1], (1.0 + g * g - square * square) / (2.0 * safe_g)
    )
    sin_theta = sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * PI * ruv[..., 0]
    local = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )
    bx, by, bz = basis_from_z(-outgoing)
    direction = local[..., 0:1] * bx + local[..., 1:2] * by + local[..., 2:3] * bz
    zero = (density == 0.0).all(-1)
    return torch.where(zero[..., None], 0.0, direction)


def eval_phase(scattering, density, anisotropy, outgoing, incoming):
    """ScatteringColour * Density * phase(cos) (Common.cuh:1165-1176)."""
    pf = _phase_function(anisotropy, -dot(outgoing, incoming))
    zero = (density == 0.0).all(-1)
    return torch.where(zero[..., None], 0.0, scattering * density * pf[..., None])


def sample_phase_pdf(density, anisotropy, outgoing, incoming):
    """(Common.cuh:1178-1187)."""
    pf = _phase_function(anisotropy, -dot(outgoing, incoming))
    zero = (density == 0.0).all(-1)
    return torch.where(zero, 0.0, pf)
