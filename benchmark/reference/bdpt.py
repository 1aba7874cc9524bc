"""Bidirectional path tracing (pathtracer.cu:1393-1970), one sample a lane.

Lane i traces a camera subpath from pixel `pixels[i]` and a light
subpath, each of at most K = max_depth + 1 vertices, at iteration
`its[i]`, then connects them: t0 (a camera vertex on a light), t1 (a
camera vertex to a new light sample), s1 (a light vertex to the camera,
splatted at its raster pixel) and the general case s, t >= 2. Each
strategy is weighted by the power-free MIS sum over the subpaths'
forward and reverse area pdfs (ConvertPdf), with the pdfs a connection
overrides. Shadow connections are thinned by a roulette against the
mean luminance of the lane's valid connections of the round, and
weighted by its inverse probability.

Draws (Philox, keyed by the pixel index): camera subpath tag 0, sites
0-1 the pixel jitter, step s at 8 + 8 s + k (k = 0-2 the BSDF sample,
3 the roulette); light subpath tag 2, sites 0-4 the emission (pick,
triangle u, v, direction u1, u2), steps as the camera's; connection
round p (s1 1, t0 2, t1 3, general 4 + s - 2) tag 3, item 32 pixel +
column, sites 4 p + k (t1: k = 0-2 the light sample, 3 the roulette;
s1 and general: the roulette at k = 0).

Materials are lambertian or rough conductors (no delta lobe, and the
two transport modes agree), surfaces only (no media).
"""

from __future__ import annotations

import torch

from benchmark.reference import geometry as geo
from benchmark.reference import shading as sh
from benchmark.reference.rng import Stream

EMIT, STEP, ITEM_LANES, CONNECT_SITES = 8, 8, 32, 4
LIGHT_TAG, CONNECT_TAG = 2, 3
RR_DEPTH = 4


def _convert(pdf, frm, to, to_nor):
    """A solid-angle pdf at `frm` as an area pdf at `to`."""
    d = frm - to
    d2 = torch.clamp_min(geo.dot(d, d), 1e-30)
    cos = torch.abs(geo.dot(d / torch.sqrt(d2)[..., None], to_nor))
    return torch.where(geo.dot(to_nor, to_nor) > 0.0, pdf / d2 * cos,
                       pdf / d2)


def _remap(x):
    return torch.where(x == 0.0, 1.0, x)


class Path:
    """Vertex tables [R, K, ...] of R subpaths."""

    def __init__(self, r, k, dev, dtype):
        def z(*shape, dt=dtype, fill=0):
            return torch.full((r, k) + shape, fill, dtype=dt, device=dev)
        self.pos, self.nor, self.dpdu, self.beta = z(3), z(3), z(3), z(3)
        self.fwd, self.rev = z(), z()
        self.mat = z(dt=torch.int64)
        self.light = z(dt=torch.int64, fill=-1)
        self.count = torch.zeros(r, dtype=torch.int64, device=dev)

    def get(self, name, idx):
        t = getattr(self, name)
        return t[torch.arange(t.shape[0], device=t.device),
                 torch.clamp(idx, 0, t.shape[1] - 1)]

    def set(self, name, mask, idx, val):
        t = getattr(self, name)
        rows = torch.arange(t.shape[0], device=t.device)
        idx = torch.clamp(idx, 0, t.shape[1] - 1)
        m = mask.reshape(mask.shape + (1,) * (val.dim() - 1))
        t[rows, idx] = torch.where(m, val, t[rows, idx])


def _walk(scene, seed, its, lanes, light_rows, path, ro, rd, beta, fwd,
          dtype):
    """Extend the 2N subpaths step by step (pathtracer.cu:1415-1690)."""
    eps = scene.epsilon
    alive = torch.ones(ro.shape[0], dtype=torch.bool, device=ro.device)
    tags = torch.where(light_rows, LIGHT_TAG, 0)
    for step in range(path.pos.shape[1] - 1):
        t, prim = geo.closest(scene, ro, rd, eps,
                              torch.where(alive, torch.inf, 0.0).to(dtype))
        hit = geo.hit_record(scene, ro, rd, t, prim)
        alive = alive & hit.valid
        prev = path.count - 1
        prev_pos, prev_nor = path.get("pos", prev), path.get("nor", prev)
        surf = alive
        path.set("pos", surf, path.count, hit.pos)
        path.set("nor", surf, path.count, hit.nor)
        path.set("dpdu", surf, path.count, hit.dpdu)
        path.set("beta", surf, path.count, beta)
        path.set("fwd", surf, path.count, _convert(fwd, prev_pos, hit.pos,
                                                   hit.nor))
        path.set("rev", surf, path.count, torch.zeros_like(fwd))
        path.set("mat", surf, path.count, hit.mat)
        path.set("light", surf, path.count, hit.light)
        u1, u2, _, u_rr = _Draws(seed, its, lanes, EMIT + STEP * step,
                                 dtype, tags).take(4)
        m = sh.materials(scene, hit.mat)
        wo, fr, pdf = sh.sample_bsdf(m, -rd, hit.nor, hit.dpdu, u1, u2)
        dead = surf & (geo.is_black(fr) | (pdf <= 0.0))
        alive = alive & ~dead
        go = surf & ~dead
        nxt = beta * fr * torch.abs(geo.dot(wo, hit.nor))[:, None] \
            / torch.clamp_min(pdf, 1e-30)[:, None]
        beta = torch.where(go[:, None], nxt, beta)
        fwd = torch.where(go, pdf, fwd)
        _, pdf_r = sh.eval_bsdf(m, wo, -rd, hit.nor, hit.dpdu)
        path.set("rev", go, prev, _convert(pdf_r, hit.pos, prev_pos,
                                           prev_nor))
        ro = torch.where(go[:, None], hit.pos, ro)
        rd = torch.where(go[:, None], wo, rd)
        path.count = torch.where(surf, path.count + 1, path.count)
        q = torch.clamp(1.0 - sh.luminance(beta), 0.0, 1.0)
        rr = go & (path.count - 1 > RR_DEPTH)
        alive = alive & ~(rr & (u_rr < q))
        beta = torch.where((rr & alive)[:, None],
                           beta * (1.0 / torch.clamp_min(1.0 - q, 1e-30)
                                   )[:, None], beta)
        alive = alive & (path.count < path.pos.shape[1])


class _Draws:
    """Sites base .. base + n of rows whose stream tag differs by row."""

    def __init__(self, seed, its, lanes, base, dtype, tags):
        self.streams = [Stream(seed, its, lanes, base, dtype, tag)
                        for tag in (0, LIGHT_TAG)]
        self.tags = tags

    def take(self, n):
        out = []
        for _ in range(n):
            a, b = (s.uniform() for s in self.streams)
            out.append(torch.where(self.tags == LIGHT_TAG, b, a))
        return out


def _tables(path, lo):
    """MIS suffix tables: A[m] = r_m (ok_m + A[m - 1]), r = rev / fwd."""
    r = _remap(path.rev) / _remap(path.fwd)
    ok = torch.ones_like(r)
    if lo == 1:
        ok[:, 0] = 0.0
    acc = torch.zeros_like(r[:, 0])
    cols = []
    for m in range(r.shape[1]):
        acc = r[:, m] * (ok[:, m] + acc)
        cols.append(acc)
    return ok, torch.stack(cols, 1)


def _col(arr, i):
    k = arr.shape[1]
    if isinstance(i, int):
        c = min(max(i, 0), k - 1)
        return arr[:, c:c + 1]
    return arr[:, torch.clamp(i.reshape(-1), 0, k - 1)]


def _if(cond, a, b):
    if isinstance(cond, bool):
        return a if cond else torch.zeros_like(a) + b
    return torch.where(cond, a, b)


def _mis(cam, light, s, t, c1, c2, l1, l2, l0_fwd):
    """1 / (1 + the sum of the other strategies' pdf ratios)."""
    (cf, cok, ca), (lf, lok, la) = cam, light

    def pick(arr, i, lo):
        return _if(i >= lo, _col(arr, i), 0.0)

    r_e = _if(s - 1 >= 1, _remap(c1) / _remap(_col(cf, s - 1)), 0.0)
    r_e1 = _if(s - 2 >= 1, _remap(c2) / _remap(_col(cf, s - 2)), 0.0)
    total = r_e * (pick(cok, s - 1, 1) + r_e1 * (pick(cok, s - 2, 1)
                                                 + pick(ca, s - 3, 1)))
    f_e = l0_fwd if isinstance(t, int) and t == 1 else _col(lf, t - 1)
    r_le = _if(t - 1 >= 0, _remap(l1) / _remap(f_e), 0.0)
    r_le1 = _if(t - 2 >= 0, _remap(l2) / _remap(_col(lf, t - 2)), 0.0)
    total = total + r_le * (pick(lok, t - 1, 0) + r_le1 * (
        pick(lok, t - 2, 0) + pick(la, t - 3, 0)))
    w = 1.0 / (1.0 + total)
    return _if(s + t == 2, torch.ones_like(w), w)


def _cols_sum(x):
    acc = x[:, 0]
    for g in range(1, x.shape[1]):
        acc = acc + x[:, g]
    return acc


def _cols(path, lo, g):
    """Vertex records of columns lo .. lo + g - 1 for each (lane, column)."""
    sl = slice(max(lo, 0), max(lo, 0) + g)
    m = path.pos.shape[0] * g
    return {k: getattr(path, k)[:, sl].reshape((m,) + getattr(
        path, k).shape[2:]) for k in ("pos", "nor", "dpdu", "beta", "mat",
                                      "light")}


def _at(path, i, g):
    """Vertex records of column i (clipped) repeated for the g columns."""
    n = path.pos.shape[0]
    c = min(max(i, 0), path.pos.shape[1] - 1)

    def b(x):
        x = x[:, c]
        return x[:, None].expand((n, g) + x.shape[1:]).reshape(
            (n * g,) + x.shape[1:])
    return {k: b(getattr(path, k)) for k in ("pos", "nor", "dpdu", "beta",
                                             "mat", "light")}


def _round(scene, seed, its_items, items, mis, case, p, s, t, c1, c2, l1, l2,
           valid2, dtype):
    """One connection round over the [N, G] items: (L [N G, 3] after the
    roulette, live [N G], the shadow ray (o, d, tmax) and the s1 pixel)."""
    eps = scene.epsilon
    cam = scene.cam
    n, g = valid2.shape
    m = n * g
    valid = valid2.reshape(-1)
    rng = Stream(seed, its_items, items, CONNECT_SITES * p, dtype,
                 CONNECT_TAG)
    nan = torch.full((m,), torch.nan, dtype=dtype, device=items.device)
    shadow = pix = None
    if c1 is not None:
        c1p, c1n = c1["pos"], c1["nor"]
        in_c1 = geo.normalize(c2["pos"] - c1p)
    if l1 is not None:
        l1p, l1n = l1["pos"], l1["nor"]
        in_l1 = geo.normalize(l2["pos"] - l1p)
        l1m = sh.materials(scene, l1["mat"])
    if case in ("t1", "gen"):
        c1m = sh.materials(scene, c1["mat"])
    if case == "t0":
        lidx = torch.clamp_min(c1["light"], 0)
        L = c1["beta"] * sh.light_le(scene, c1["light"], c1n, in_c1)
        area = 1.0 / torch.clamp_min(sh.light_area(scene, lidx), 1e-30)
        ok = valid & (c1["light"] >= 0) & ~geo.is_black(L)
        c1r = area * sh.choice_pdf(scene, lidx).to(dtype)
        c2r = _convert(torch.abs(geo.dot(in_c1, c1n)) * (1.0 / torch.pi),
                       c1p, c2["pos"], c2["nor"])
        l1r = l2r = l0f = nan
    elif case == "t1":
        pick, choice = sh.pick_light(scene, rng.uniform())
        choice = choice.to(dtype)
        lu1, lu2 = rng.uniform(), rng.uniform()
        _, lnor = sh.light_point(scene, pick, lu1, lu2)
        rad, sd, st, lpdf = sh.sample_light(scene, pick, c1p, lu1, lu2, eps)
        light_pos = c1p + sd * (st + eps)[:, None]
        fr, nxt = sh.eval_bsdf(c1m, in_c1, sd, c1n, c1["dpdu"])
        L = c1["beta"] * fr * rad * (torch.abs(geo.dot(c1n, sd))
                                     / torch.clamp_min(lpdf * choice,
                                                       1e-30))[:, None]
        _, rev = sh.eval_bsdf(c1m, sd, in_c1, c1n, c1["dpdu"])
        ok = valid & ~geo.is_black(rad) & (lpdf > 0.0) & ~geo.is_black(L)
        l0f = (1.0 / torch.clamp_min(sh.light_area(scene, pick), 1e-30)) \
            * choice
        l1r = _convert(nxt, c1p, light_pos, lnor)
        c1r = _convert(torch.abs(geo.dot(sd, lnor)) * (1.0 / torch.pi),
                       light_pos, c1p, c1n)
        c2r = _convert(rev, c1p, c2["pos"], c2["nor"])
        l2r = nan
        shadow = (c1p, sd, st)
    elif case == "s1":
        sd, st, we, cpdf, rx, ry = sh.sample_camera(cam, l1p, eps)
        fr, nxt = sh.eval_bsdf(l1m, in_l1, sd, l1n, l1["dpdu"])
        L = l1["beta"] * fr * (we * torch.abs(geo.dot(sd, l1n))
                               / torch.clamp_min(cpdf, 1e-30))[:, None]
        _, rev = sh.eval_bsdf(l1m, sd, in_l1, l1n, l1["dpdu"])
        ok = valid & (cpdf != 0.0) & ~geo.is_black(L)
        l1r = _convert(sh.camera_pdf(cam, -sd), cam["position"].expand(m, 3),
                       l1p, l1n)
        l2r = _convert(rev, l1p, l2["pos"], l2["nor"])
        c1r = c2r = l0f = nan
        shadow = (l1p, sd, st)
        pix = rx + ry * scene.width
    else:
        conn = c1p - l1p
        d2 = torch.clamp_min(geo.dot(conn, conn), 1e-30)
        l_to_c = conn / torch.sqrt(d2)[:, None]
        fr_c, pdf_to_l1 = sh.eval_bsdf(c1m, in_c1, -l_to_c, c1n, c1["dpdu"])
        fr_l, pdf_to_c1 = sh.eval_bsdf(l1m, in_l1, l_to_c, l1n, l1["dpdu"])
        g3 = torch.abs(geo.dot(l_to_c, l1n)) \
            * torch.abs(geo.dot(-l_to_c, c1n)) / d2
        L = c1["beta"] * fr_c * fr_l * l1["beta"] * g3[:, None]
        _, pdf_to_l2 = sh.eval_bsdf(l1m, l_to_c, in_l1, l1n, l1["dpdu"])
        _, pdf_to_c2 = sh.eval_bsdf(c1m, -l_to_c, in_c1, c1n, c1["dpdu"])
        ok = valid & ~geo.is_black(L)
        c1r = _convert(pdf_to_c1, l1p, c1p, c1n)
        l1r = _convert(pdf_to_l1, c1p, l1p, l1n)
        l2r = _convert(pdf_to_l2, l1p, l2["pos"], l2["nor"])
        c2r = _convert(pdf_to_c2, c1p, c2["pos"], c2["nor"])
        l0f = nan
        shadow = (c1p, -l_to_c, torch.sqrt(d2) - eps)
    w = _mis(*mis, s, t, *(x.reshape(n, g) for x in (c1r, c2r, l1r, l2r,
                                                     l0f))).reshape(m)
    L = L * w[:, None]
    ok = ok & torch.isfinite(L).all(-1) & ~geo.is_black(L)
    L = torch.where(ok[:, None], L, 0.0)
    if case == "t0":
        return L, ok, None, None
    lum = sh.luminance(L)
    okf = ok.reshape(n, g)
    mean = _cols_sum(torch.where(okf, lum.reshape(n, g), 0.0)) \
        / torch.clamp_min(okf.sum(1), 1).to(dtype)
    q = torch.clamp(lum / torch.clamp_min(mean.repeat_interleave(g), 1e-30),
                    0.0, 1.0)
    ok = ok & (rng.uniform() < q)
    L = torch.where(ok[:, None], L / torch.clamp_min(q, 1e-30)[:, None], 0.0)
    return L, ok, shadow, pix


def radiance(scene, seed: int, its, pixels, dtype=torch.float32):
    """(li [N, 3] of each lane's own pixel, film [W H, 3] of the lanes'
    s = 1 splats) of one BDPT sample for each (iteration, pixel) lane."""
    dev = pixels.device
    eps = scene.epsilon
    n = pixels.shape[0]
    k = scene.max_depth + 1
    g = k - 1
    its, pixels = its.to(torch.int64), pixels.to(torch.int64)
    cam = scene.cam
    # vertex 0: the pinhole, and a point on a light
    cs = Stream(seed, its, pixels, 0, dtype)
    jx, jy = cs.uniform() - 0.5, cs.uniform() - 0.5
    c_ro, c_rd = sh.primary_rays(cam, (pixels % scene.width).to(dtype) + jx,
                                 (pixels // scene.width).to(dtype) + jy)
    ls = Stream(seed, its, pixels, 0, dtype, LIGHT_TAG)
    lidx, choice = sh.pick_light(scene, ls.uniform())
    choice = choice.to(dtype)
    u1, u2, u3, u4 = (ls.uniform() for _ in range(4))
    l_ro, l_nor = sh.light_point(scene, lidx, u1, u2)
    local, pdf_w = sh.cosine_hemisphere(u3, u4)
    uu, ww = sh.make_coordinate(l_nor)
    l_rd = sh.to_world(local, uu, l_nor, ww)
    pdf_a = 1.0 / torch.clamp_min(sh.light_area(scene, lidx), 1e-30)
    rad = scene.l_rad[lidx]
    den = torch.clamp_min(pdf_a * pdf_w * choice, 1e-30)
    l_beta = rad * (torch.abs(geo.dot(l_rd, l_nor)) / den)[:, None]

    path = Path(2 * n, k, dev, dtype)
    path.pos[:n, 0] = cam["position"]
    path.nor[:n, 0] = -cam["w"]
    path.beta[:n, 0] = 1.0
    path.fwd[:n, 0] = 1.0
    path.pos[n:, 0], path.nor[n:, 0], path.beta[n:, 0] = l_ro, l_nor, rad
    path.fwd[n:, 0] = pdf_a * choice
    path.light[n:, 0] = lidx
    path.count += 1
    light_rows = torch.arange(2 * n, device=dev) >= n
    _walk(scene, seed, torch.cat([its, its]), torch.cat([pixels, pixels]),
          light_rows, path, torch.cat([c_ro, l_ro]), torch.cat([c_rd, l_rd]),
          torch.cat([torch.ones_like(l_beta), l_beta]),
          torch.cat([sh.camera_pdf(cam, c_rd), pdf_w]), dtype)

    camp, lightp = _half(path, 0, n), _half(path, n, 2 * n)
    mis = ((camp.fwd, *_tables(camp, 1)), (lightp.fwd, *_tables(lightp, 0)))
    items = (pixels[:, None] * ITEM_LANES
             + torch.arange(g, device=dev)).reshape(-1)
    its_items = its.repeat_interleave(g)
    cc, lc = camp.count, lightp.count
    cols = torch.arange(2, g + 2, device=dev)[None, :]
    li = torch.zeros((n, 3), dtype=dtype, device=dev)
    film = torch.zeros((scene.width * scene.height, 3), dtype=dtype,
                       device=dev)
    queued = []   # (round, L, live, shadow ray, pixel)

    def run(case, p, s, t, c1, c2, l1, l2, valid2):
        return _round(scene, seed, its_items, items, mis, case, p, s, t, c1,
                      c2, l1, l2, valid2, dtype)

    queued.append(("s1",) + run("s1", 1, 1, cols, None, None,
                                _cols(lightp, 1, g), _cols(lightp, 0, g),
                                cols <= lc[:, None]))
    valid2 = cols <= cc[:, None]
    L0, *_ = run("t0", 2, cols, 0, _cols(camp, 1, g), _cols(camp, 0, g),
                 None, None, valid2)
    li = li + _cols_sum(L0.reshape(n, g, 3))
    queued.append(("t1",) + run("t1", 3, cols, 1, _cols(camp, 1, g),
                                _cols(camp, 0, g), None, None,
                                valid2 & (lc >= 1)[:, None]))
    for s in range(2, g + 2):
        queued.append(("gen",) + run(
            "gen", 4 + s - 2, s, cols, _at(camp, s - 1, g),
            _at(camp, s - 2, g), _cols(lightp, 1, g), _cols(lightp, 0, g),
            (s <= cc)[:, None] & (cols <= lc[:, None])))
    for case, L, live, (o, d, tmax), pix in queued:
        blocked = geo.occluded(scene, o, d, eps, torch.where(live, tmax, 0.0))
        c = torch.where((live & ~blocked)[:, None], L, 0.0)
        if case == "s1":
            on = live & ~blocked
            film.index_put_((pix[on],), c[on], accumulate=True)
        else:
            li = li + _cols_sum(c.reshape(n, g, 3))
    li = torch.where(torch.isfinite(li).all(-1)[:, None], li, 0.0)
    return li, film


def _half(path, lo, hi):
    out = Path.__new__(Path)
    for name in ("pos", "nor", "dpdu", "beta", "fwd", "rev", "mat", "light",
                 "count"):
        setattr(out, name, getattr(path, name)[lo:hi])
    return out
