"""Frozen copy of ``myraytracer_tpu_torch/render/textures.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: none.

Texture evaluation: checker, marble and the sphere-UV image lookup.

Port of ``myraytracer_tpu.render.textures``. The winner primitive's record
carries a texture type, a second color and a scale (``scene/compile.py``
packs them), and the bounce loop replaces the hit's albedo with the
texture's value at the hit point before NEE and the scatter use it. Lights
are never textured, so emission reads the albedo rows unchanged.

* the texture is evaluated once per bounce on the closest-hit winner, never
  inside the sweep;
* checker and marble are exact arithmetic (integer parity, the integer-hash
  noise and triangle wave of ``core/noise.py``), so they are bitwise the
  JAX package's functions run op by op;
* the image lookup maps the OUTWARD normal to ``u = (atan2(-z, x) + pi) /
  2pi``, ``v = acos(-y) / pi`` and gathers the nearest texel, ``v``
  flipped so that image row 0 is the top; ``atan2`` and ``acos`` are the
  device's math library's, as the CUDA kernel's are;
* no random draws are consumed: textures never shift the sample stream.

This is the plain version of the texture step of ``csrc/trace.cu``
(``texture_albedo``), which repeats these expression trees.
"""

from __future__ import annotations

import torch

from .noise import triangle_wave, turbulence
from .vec import V3
from .hit import count_work, counting
from . import api

TEX_SOLID = api.TEXTURE_SOLID
TEX_CHECKER = api.TEXTURE_CHECKER
TEX_MARBLE = api.TEXTURE_MARBLE
TEX_IMAGE = api.TEXTURE_IMAGE

# Python floats, rounded to f32 where they meet an f32 tensor (as JAX's
# weak-typed constants are).
_PI = 3.14159265358979
_INV_PI = 1.0 / _PI
_INV_2PI = 0.5 / _PI


def sphere_uv(outward: V3):
    """RTiOW book-2 ch. 4.2 sphere mapping of an OUTWARD unit normal:
    ``u = (atan2(-z, x) + pi) / 2pi``, ``v = acos(-y) / pi``."""
    u = (torch.atan2(-outward.z, outward.x) + _PI) * _INV_2PI
    v = torch.acos(torch.clamp(-outward.y, -1.0, 1.0)) * _INV_PI
    return u, v


def image_albedo(image: torch.Tensor, scale, outward: V3) -> V3:
    """Nearest-texel lookup of the scene bitmap ``image`` ([TH, TW, 3]) at
    the sphere UV; ``scale`` tiles the map (the fraction of u*scale and
    v*scale), v flips so that row 0 is the top, and indices clamp."""
    u, v = sphere_uv(outward)
    us = u * scale
    vs = v * scale
    us = us - torch.floor(us)
    vs = vs - torch.floor(vs)
    th, tw = image.shape[0], image.shape[1]
    i = torch.clamp((us * tw).to(torch.int32), 0, tw - 1)
    j = torch.clamp(((1.0 - vs) * th).to(torch.int32), 0, th - 1)
    texel = image[j.long(), i.long()]
    return V3(texel[..., 0], texel[..., 1], texel[..., 2])


def checker_albedo(even: V3, odd: V3, scale, p: V3) -> V3:
    """3-D checker: ``even`` where the floor(p*scale) coordinates sum even
    (integer parity, exact at any distance)."""
    sx = torch.floor(p.x * scale).to(torch.int32)
    sy = torch.floor(p.y * scale).to(torch.int32)
    sz = torch.floor(p.z * scale).to(torch.int32)
    is_even = ((sx + sy + sz) & 1) == 0
    return V3.where(is_even, even, odd)


def marble_albedo(color: V3, scale, p: V3) -> V3:
    """``color * 0.5 * (1 + band(scale * z + 10 * turbulence(p)))`` with the
    exact triangle wave as the band."""
    band = triangle_wave(scale * p.z + 10.0 * turbulence(p))
    return color * (0.5 * (1.0 + band))


def effective_albedo(albedo: V3, tex_ty: torch.Tensor, albedo2: V3,
                     tex_scale: torch.Tensor, point: V3, image=None,
                     outward: V3 = None) -> V3:
    """Compute-all-select texture dispatch over the lanes (the JAX
    package's with every family present).

    ``albedo`` doubles as the solid color, the checker EVEN color, the
    marble base color and the image's multiplier; ``albedo2`` is the
    checker ODD color; ``tex_ty`` selects per lane; image lanes need the
    scene's bitmap ``image`` and the OUTWARD normals ``outward``.
    """
    if counting():  # the kernel evaluates each lane's own kind only
        kinds = [(TEX_CHECKER, "checker"), (TEX_MARBLE, "marble")]
        if image is not None:
            kinds.append((TEX_IMAGE, "image"))
        for ty, kind in kinds:
            count_work(kind, (tex_ty == ty).sum())
    out = V3.where(tex_ty == TEX_CHECKER, checker_albedo(albedo, albedo2, tex_scale, point),
                   albedo)
    out = V3.where(tex_ty == TEX_MARBLE, marble_albedo(albedo, tex_scale, point), out)
    if image is not None:
        out = V3.where(tex_ty == TEX_IMAGE, albedo * image_albedo(image, tex_scale, outward),
                       out)
    return out


def apply_texture(hit, image=None):
    """``hit`` with its albedo replaced by the texture's value at
    ``hit.point``; unchanged when the record carries no texture rows (an
    untextured scene). ``image`` is the scene's bitmap
    (``CompiledScene.tex_image``); its UV comes from the OUTWARD normal,
    the hit's front-face-oriented one flipped back."""
    if hit.tex_ty is None:
        return hit
    outward = V3.where(hit.front_face, hit.normal, -hit.normal)
    return hit._replace(albedo=effective_albedo(
        hit.albedo, hit.tex_ty, hit.albedo2, hit.tex_scale, hit.point,
        image=image, outward=outward,
    ))
