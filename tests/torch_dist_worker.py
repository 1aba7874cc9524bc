"""One rank of the 2-rank gloo group of tests/test_torch_dist.py.

    python tests/torch_dist_worker.py RANK WORLD STORE OUT

Joins the group through the file store STORE (one torch thread), then
gathers `gather_probe`'s tensors from the ranks' slices
(OUT/gather.npz), renders every case of CASES with
`Renderer(shard=True)` and has rank 0 write what the test compares to
OUT/<case>.npz (`case_arrays`): the
whole film, the rays, and SPPM's visible points or MLT's chains
gathered whole. Also: a PT checkpoint written by the 2 ranks
(OUT/pt_ckpt.npz), the checkpoints OUT/resume_<case>.npz written by one
rank loaded by both and rendered one iteration on, and each rank's hash
of its scene tables (OUT/tables_<rank>.txt). The test runs the same
cases on one rank in its own process.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
CORNELL = REPO / "scenes" / "cornell_port" / "scene.json"
SMOKE = REPO / "scenes" / "smoke_port" / "scene.json"
SIZE = 16
DEPTH = 3
PHOTONS = 4096
# case: (scene, integrator, iterations)
CASES = {
    "ao": (CORNELL, "AO", 2), "pt": (CORNELL, "PT", 2),
    "vpt": (SMOKE, "VPT", 2), "lt": (CORNELL, "LT", 2),
    "bdpt": (CORNELL, "BDPT", 2), "ir": (CORNELL, "IR", 2),
    "sppm": (CORNELL, "SPPM", 2), "mlt": (CORNELL, "MLT", 3),
}
RESUMED = ("lt", "mlt")   # checkpoints of one rank resumed by two


def renderer(case: str, shard: bool, seed: int = 5):
    """The case's Renderer on the CPU at SIZE^2, depth DEPTH."""
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    path, integ, _ = CASES[case]
    host = load_scene(str(path))
    host.width = host.height = SIZE
    r = Renderer(host, seed=seed, device="cpu", cache=False,
                 integrator=IntegratorType[integ], max_depth=DEPTH,
                 photons_per_iteration=PHOTONS, shard=shard)
    return r


def case_arrays(r) -> dict:
    """What the test compares of a renderer: every array whole (a
    collective on a sharded renderer)."""
    n = r.width * r.height
    out = {"film": r.film().numpy(), "rays": r.rays.numpy()}
    if r.kind == "sppm":
        out.update(radius=r._sppm_state.radius.numpy(),
                   n=r._sppm_state.n.numpy())
    if r.kind == "mlt":
        st = r._mlt_state
        out.update(u=r.shard.gather(st["u"], n, dim=1).numpy(),
                   lum=r.shard.gather(st["lum"], n).numpy(),
                   px=r.shard.gather(st["px"], n).numpy())
    return out


def gather_probe() -> dict:
    """Whole tensors for `Shard.gather` to rebuild from the ranks' slices
    bit for bit: float32 with -0.0, NaN, a subnormal and -inf, int32,
    bool, and [3, N] gathered along dim 1."""
    import torch
    f = torch.tensor([-0.0, float("nan"), 1e-45, -float("inf"), 3.5, 0.0,
                      -2.0], dtype=torch.float32)
    return {"f32": f, "i32": torch.arange(-3, 4, dtype=torch.int32),
            "bool": f > 0, "rows": torch.stack([f, -f, f * 2])}


def table_hash(scene) -> str:
    """sha256 over every tensor of a DeviceScene, field by field."""
    import dataclasses
    import torch
    h = hashlib.sha256()
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor):
            h.update(f.name.encode())
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def main(rank: int, world: int, store: str, out: str) -> None:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from gpu_pathtracer_tpu_torch.parallel import dist
    from gpu_pathtracer_tpu_torch.run import checkpoint as ckpt
    out = pathlib.Path(out)
    dist.init("gloo", f"file://{store}", rank, world, timeout_s=150)
    shard = dist.Shard.current()
    gathered = {}
    for k, whole in gather_probe().items():
        dim = 1 if k == "rows" else 0
        lo, hi = shard.range(whole.shape[dim])
        gathered[k] = shard.gather(whole.narrow(dim, lo, hi - lo),
                                   whole.shape[dim], dim).numpy()
    if rank == 0:
        np.savez(out / "gather.npz", **gathered)
    for case, (_, _, iterations) in CASES.items():
        r = renderer(case, True)
        if r.shard.world != world:
            raise RuntimeError(f"{case}: a world of {r.shard.world}")
        if case == "pt":
            (out / f"tables_{rank}.txt").write_text(
                table_hash(r.device_scene))
        r.render(iterations)
        arrays = case_arrays(r)
        if case == "pt":
            ckpt.save_checkpoint(r, str(out / "pt_ckpt.npz"))
        if rank == 0:
            np.savez(out / f"{case}.npz", **arrays)
    for case in RESUMED:
        r = renderer(case, True)
        ckpt.load_checkpoint(r, str(out / f"resume_{case}.npz"))
        r.render_iteration()
        arrays = case_arrays(r)
        if rank == 0:
            np.savez(out / f"resumed_{case}.npz", **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
