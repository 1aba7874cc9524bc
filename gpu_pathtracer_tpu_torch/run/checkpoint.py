"""Render checkpoints: save a progressive render and resume it.

The port of gpu_pathtracer_tpu/run/checkpoint.py, with its file format:
one npz holding `fingerprint` (16 hex digits as uint8), `iteration`,
`acc` (the whole [W*H, 3] film), and by kind SPPM's visible points
(`sppm_{ld,ind,beta,dir,pos,nor,uv,dpdu,mat_idx,tau,radius,n,valid}`),
IR's VPL store (`vpl_{beta,dir,pos,nor,uv,dpdu,mat_idx,pdf0,count}`) or
MLT's chains (`mlt_{u,lum,li,px,py,film,b_sum,b_cnt,steps}`). The
fingerprint is the JAX package's: a scene flattened the same way, at
the same size, integrator, depth and seed, fingerprints the same in
both packages, so a file written by either loads in the other. Every
random site is keyed by (seed, iteration, lane), so a resumed render
continues the same samples.

Two differences from the JAX package's renderer, both about state the
port makes before the first iteration that a load must replace: MLT's
chains are bootstrapped when the Renderer is made, and IR's VPL store,
made at iteration 1 of each 32, is kept and restored (a store drawn
again at the resumed iteration would be another store).

Under a sharded render (run/renderer.py) both functions are collectives
that every rank calls: the film and MLT's chains are gathered or summed
across the ranks, and rank 0 alone writes the file.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

SPPM_FIELDS = ("ld", "ind", "beta", "dir", "pos", "nor", "uv", "dpdu",
               "mat_idx", "tau", "radius", "n", "valid")
VPL_FIELDS = ("beta", "dir", "pos", "nor", "uv", "dpdu", "mat_idx", "pdf0",
              "count")
MLT_FIELDS = ("u", "lum", "li", "px", "py", "film", "b_sum", "b_cnt",
              "steps")
MLT_CHAIN_FIELDS = ("u", "lum", "li", "px", "py")   # split by chain
MLT_SUM_FIELDS = ("film", "b_sum", "b_cnt")         # summed over ranks

_NUMPY = {torch.float32: np.float32, torch.int32: np.int32,
          torch.int64: np.int64, torch.bool: np.bool_}


def _fingerprint(renderer) -> str:
    """Scene and config fingerprint (the JAX package's): resolution,
    integrator, depth and seed, then the flattened prim, material and
    light tables' bytes."""
    s = renderer.static
    h = hashlib.sha256()
    h.update(json.dumps({
        "w": s.width, "h": s.height, "integrator": int(s.integrator),
        "max_depth": s.max_depth, "seed": renderer.seed,
    }, sort_keys=True).encode())
    d = renderer.device_scene
    for t in (d.prim_attrs, d.mat_attrs, d.light_attrs):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def to_numpy(tensors: dict) -> dict:
    """{name: tensor} read back to the host in one copy (one wait for
    the device), as {name: numpy array} of the same dtypes and shapes."""
    flat = [t.detach().reshape(-1).contiguous().view(torch.uint8)
            for t in tensors.values()]
    host = torch.cat(flat).cpu().numpy()
    out, at = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        out[name] = host[at:at + nbytes].view(_NUMPY[t.dtype]) \
            .reshape(tuple(t.shape)).copy()
        at += nbytes
    return out


def _state_tensors(renderer) -> dict:
    """The tensors a checkpoint holds, whole (collective when sharded)."""
    out = {"acc": renderer.film()}
    if renderer.kind == "sppm":
        st = renderer._sppm_state
        out.update({f"sppm_{k}": getattr(st, k) for k in SPPM_FIELDS})
    if renderer.kind == "ir" and renderer._vpls is not None:
        out.update({f"vpl_{k}": getattr(renderer._vpls, k)
                    for k in VPL_FIELDS})
    if renderer.kind == "mlt":
        st, shard = renderer._mlt_state, renderer.shard
        n = renderer.width * renderer.height
        for k in MLT_FIELDS:
            v = st[k]
            if k in MLT_CHAIN_FIELDS:
                v = shard.gather(v, n, dim=1 if k == "u" else 0)
            elif k in MLT_SUM_FIELDS:
                v = shard.reduce(v)
            out[f"mlt_{k}"] = v
    return out


def save_checkpoint(renderer, path: str) -> None:
    """Write the film, the iteration and the kind's state to `path`
    (npz, under that name as given). Every rank of a sharded render
    calls it; rank 0 writes."""
    arrays = to_numpy(_state_tensors(renderer))
    if renderer.shard.rank != 0:
        return
    arrays["fingerprint"] = np.frombuffer(
        _fingerprint(renderer).encode(), dtype=np.uint8)
    arrays["iteration"] = np.int64(renderer.iteration)
    # through a file handle: np.savez adds ".npz" to a bare path, and the
    # CLI would then not find the file it was given
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(renderer, path: str) -> None:
    """Restore a checkpoint written by `save_checkpoint` (of either
    package) onto `renderer.device`. Raises ValueError on a scene or
    config mismatch instead of blending films."""
    from gpu_pathtracer_tpu_torch.integrators import ir, mlt, sppm
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    want = _fingerprint(renderer)
    got = bytes(data["fingerprint"]).decode()
    if got != want:
        raise ValueError(
            f"checkpoint fingerprint {got} does not match scene {want}; "
            "refusing to resume")
    dev = renderer.device
    renderer.iteration = int(data["iteration"])
    renderer.place_film(torch.as_tensor(data["acc"]))
    if renderer.kind == "sppm":
        renderer._sppm_state = sppm.state_from_numpy(
            {k: data[f"sppm_{k}"] for k in SPPM_FIELDS}, dev)
    if renderer.kind == "ir":
        renderer._vpls = None
        if "vpl_beta" in data:
            renderer._vpls = ir.vpls_from_numpy(
                {k: data[f"vpl_{k}"] for k in VPL_FIELDS}, dev)
    if renderer.kind == "mlt" and "mlt_u" in data:
        st = mlt.state_from_numpy({k: data[f"mlt_{k}"] for k in MLT_FIELDS},
                                  dev)
        shard = renderer.shard
        if shard.joined:
            lo, hi = renderer._lo, renderer._hi
            st["u"] = st["u"][:, lo:hi]
            for k in MLT_CHAIN_FIELDS[1:]:
                st[k] = st[k][lo:hi]
            if shard.rank > 0:   # the sums stay whole on rank 0 only
                for k in MLT_SUM_FIELDS:
                    st[k] = torch.zeros_like(st[k])
        renderer._mlt_state = st
