"""Rays a traced spp, from the program's device-side count
(Renderer.rays): closest hits and shadow rays."""


def read(s):
    t = s.get("trace")
    return t["rays_per_spp"] if t and t["rays_per_spp"] > 0 else None
