"""Film tonemapping (the reference's Output/FilmicTonemapping/
GammaCorrection, pathtracer.cu:187-204, 2516-2531); the port of
gpu_pathtracer_tpu/film/film.py."""

from __future__ import annotations

import torch


def gamma_correction(c):
    """pathtracer.cu:187-197: exposure sqrt(2), gamma 2.2 (quirk kept)."""
    c = torch.clamp_min(c, 1e-5)
    return (c * 1.41421356) ** (1.0 / 2.2)


def filmic_tonemap(c):
    """Hejl–Burgess-Dawson approximation (pathtracer.cu:199-204)."""
    c = torch.clamp_min(c - 0.004, 0.0)
    return (c * (6.2 * c + 0.5)) / (c * (6.2 * c + 1.7) + 0.06)


def tonemap(acc, iteration, filmic: bool):
    """Output (pathtracer.cu:2516-2531): average then tone-curve."""
    c = acc / max(iteration, 1)
    return filmic_tonemap(c) if filmic else gamma_correction(c)
