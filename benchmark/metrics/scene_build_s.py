"""Host seconds of the scene's parse, flatten and BVH build (the
Renderer made, synchronised)."""


def read(s):
    return s.get("scene_build_s")
