"""One rank of the 4-rank gloo world of the port's sharded-path tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_groupwise_sharded.py``).

    python tests/torch_parallel_worker.py SUITE INPUTS.npz OUT_DIR RANK WORLD STORE
    torchrun --nproc_per_node=4 tests/torch_parallel_worker.py SUITE INPUTS.npz OUT_DIR

Imports torch, numpy and the port only (no JAX, no conftest). Joins a gloo
world on the CPU over the ``file://`` store STORE or, under ``torchrun``,
an NCCL world of one card a rank; builds the meshes (1, 4), (2, 2) and
(4, 1), runs every case of SUITE that the mesh admits on the inputs of
INPUTS.npz, and assembles each result whole (over "space" and "data").
Rank 0 writes the results to OUT_DIR/results.npz, keyed
"<case>/<data>x<space>/<name>", and each failed case's traceback to
OUT_DIR/errors.json. ``run_world`` starts the four ranks and waits for
them, killing them at its timeout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from sift3d_tpu_torch import pyramid as pyr  # noqa: E402
from sift3d_tpu_torch.config import RansacParams, SIFT3DParams  # noqa: E402
from sift3d_tpu_torch.convert import descriptors_from_numpy  # noqa: E402
from sift3d_tpu_torch.parallel import (  # noqa: E402
    batch_detect_describe, batch_register_pairs, conv_sep_sharded,
    descrip_level_sharded, init_distributed, level_extrema_sharded,
    make_mesh, nn_match_ring, nn_match_sharded, orient_level_sharded,
    shard_halo)
from sift3d_tpu_torch.parallel.mesh import all_gather, all_gather_cat  # noqa: E402
from sift3d_tpu_torch.parallel.pipeline import (  # noqa: E402
    _Slabs, build_gpyr_batched)
from sift3d_tpu_torch.register import groupwise as gw  # noqa: E402

WORLD = 4
DEVICE = torch.device("cpu")    # the ranks' device (a card under torchrun)
MESHES = ((1, 4), (2, 2), (4, 1))
TIMEOUT_S = 120
DIMS = {"z": 0, "y": 1, "x": 2}


# --- blocks in, whole results out -------------------------------------------

def block(x, m, data_dim=0, space_dim=None) -> torch.Tensor:
    """This rank's block of a global numpy array: its "data" slice of
    ``data_dim`` and "space" slab of ``space_dim`` (None: not split)."""
    t = torch.as_tensor(np.ascontiguousarray(x))
    for dim, n, i in ((data_dim, m.data, m.d), (space_dim, m.space, m.s)):
        if dim is not None:
            L = t.shape[dim] // n
            t = t.narrow(dim, i * L, L)
    return t.contiguous().to(DEVICE)


def dev(x) -> torch.Tensor:
    """A whole numpy input on the ranks' device."""
    return torch.as_tensor(np.asarray(x)).to(DEVICE)


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def whole(t: torch.Tensor, m, data_dim=0, space_dim=None) -> np.ndarray:
    """The global array from every rank's block (``block``'s inverse)."""
    if space_dim is not None:
        t = all_gather_cat(t, m, "space", space_dim)
    if data_dim is not None:
        t = all_gather_cat(t, m, "data", data_dim)
    return host(t)


# --- suite "parallel" --------------------------------------------------------

ALL = MESHES
CONV = {   # case: (units, shard dim, meshes whose slab holds the halo)
    "conv_local_u0": ((1.0, 1.0, 1.0), "z", ALL),
    "conv_local_u1": ((1.0, 1.5, 2.0), "z", ALL),
    "conv_batched": ((1.0, 1.0, 1.0), "z", ((2, 2), (4, 1))),
    "conv_single": ((1.0, 1.0, 1.0), "z", ((2, 2), (4, 1))),
    "conv_y": ((1.0, 1.3, 0.8), "y", ALL),
    "conv_x": ((1.0, 1.3, 0.8), "x", ALL),
}
WINDOW_UNITS = (1.0, 1.3, 0.8)
WINDOW_SD = 1.6
CORNER = 0.4
EXT_THRESH, EXT_CAP = 0.1, 64
NN_THRESH = 0.8


def _conv(name):
    units, sd, _ = CONV[name]

    def run(inp, m):
        vol = inp[f"{name}/vol"]
        batched = vol.ndim == 4
        dd = 0 if batched else None
        sdim = (1 if batched else 0) + DIMS[sd]
        out = conv_sep_sharded(block(vol, m, dd, sdim), inp[f"{name}/taps"],
                               1.0, units, m, shard_dim=sd)
        return {"out": whole(out, m, dd, sdim)}
    return run


def _halo(inp, m):
    out = {}
    for sd in ("z", "y"):
        x = block(inp["halo/vol"], m, 0, 1 + DIMS[sd])
        out[sd] = whole(shard_halo(x, 2, m, 1 + DIMS[sd]), m, 0,
                        1 + DIMS[sd])
    return out


def _layout(inp, m):
    me = dev([torch.distributed.get_rank(), m.d, m.s])
    return {"space": host(all_gather(me, m, "space")),
            "data": host(all_gather(me, m, "data"))}


def _extrema(sd):
    def run(inp, m):
        p, c, n = (block(inp[f"ext_{sd}/{k}"], m, 0, 1 + DIMS[sd])
                   for k in ("prev", "cur", "nxt"))
        rows, count, total = level_extrema_sharded(
            p, c, n, EXT_THRESH, EXT_CAP, m, shard_dim=sd)
        zyx = torch.zeros((c.shape[0], EXT_CAP, 3), dtype=torch.int32,
                          device=DEVICE)
        vol = rows[:, 0].long()
        pos = torch.arange(rows.shape[0], device=DEVICE) - \
            (torch.cumsum(count, 0) - count)[vol]
        zyx[vol, pos] = rows[:, 1:]
        return {"zyx": whole(zyx, m), "count": whole(count, m),
                "total": whole(total, m)}
    return run


def _orient(sd):
    def run(inp, m):
        R, valid = orient_level_sharded(
            block(inp[f"orient_{sd}/levels"], m, 0, 1 + DIMS[sd]),
            block(inp[f"orient_{sd}/kp"], m), WINDOW_SD, WINDOW_UNITS,
            CORNER, m, shard_dim=sd)
        return {"R": whole(R, m), "valid": whole(valid, m)}
    return run


def _descrip(sd):
    def run(inp, m):
        d = descrip_level_sharded(
            block(inp[f"desc_{sd}/levels"], m, 0, 1 + DIMS[sd]),
            block(inp[f"desc_{sd}/centers"], m),
            block(inp[f"desc_{sd}/Q"], m), WINDOW_SD, WINDOW_UNITS, m,
            shard_dim=sd)
        return {"vec": whole(d, m)}
    return run


def _match(name, ring=False, streamed=None):
    def run(inp, m):
        d1, d2 = inp[f"{name}/d1"], inp[f"{name}/d2"]
        v1 = inp.get(f"{name}/v1", np.ones(len(d1), bool))
        v2 = inp.get(f"{name}/v2", np.ones(len(d2), bool))
        if ring:
            out = nn_match_ring(block(d1, m, None, 0), block(d2, m, None, 0),
                                NN_THRESH, m, valid1=block(v1, m, None, 0),
                                valid2=block(v2, m, None, 0))
        else:
            out = nn_match_sharded(dev(d1), block(d2, m, None, 0), NN_THRESH,
                                   m, valid1=dev(v1),
                                   valid2=block(v2, m, None, 0),
                                   streamed=streamed)
        return {"matches": host(out)}
    return run


# Pipelines: (shape zyx, units, caps, shard dim).
PIPES = {
    "bdd_z": ((16, 16, 16), (1.0, 1.0, 1.0), 128, "z"),
    "bdd_y": ((8, 24, 24), (1.0, 1.0, 2.0), 128, "y"),
}


def _pipeline(name):
    shape, units, cap, sd = PIPES[name]

    def run(inp, m):
        params = SIFT3DParams(max_kp_per_level=cap)
        plan = pyr.plan_pyramid(shape[::-1], units, params)
        kp, desc, ov = batch_detect_describe(inp[f"{name}/vols"], plan,
                                             params, device=DEVICE, mesh=m,
                                             shard_dim=sd)
        out = {f: host(getattr(kp, f)) for f in
               ("x", "y", "z", "o", "s", "sd", "R", "count")}
        out.update(vec=host(desc.vec), xyz=host(desc.xyz),
                   overflow=host(ov))
        return out
    return run


def _overflow(inp, m):
    vols = inp["overflow/vols"]
    out = {}
    for cap in (1, 512):
        params = SIFT3DParams(max_kp_per_level=cap)
        plan = pyr.plan_pyramid(vols.shape[1:][::-1], (1.0, 1.0, 1.0),
                                params)
        out[f"ov{cap}"] = host(batch_detect_describe(
            vols, plan, params, device=DEVICE, mesh=m)[2])
    params = SIFT3DParams(max_kp_per_level=1)
    plan = pyr.plan_pyramid(vols.shape[1:][::-1], (1.0, 1.0, 1.0), params)
    res = batch_register_pairs(vols, vols, plan, params,
                               ransac_params=RansacParams(num_iter=20),
                               device=DEVICE, mesh=m)
    out["reg_overflow"] = host(res.kp_overflow)
    out["reg_A_shape"] = np.asarray(res.A.shape)
    return out


def _pipelined(inp, m):
    vols = inp["pipelined/vols"]
    plan = pyr.plan_pyramid(vols.shape[1:][::-1], (1.0, 1.0, 1.0),
                            SIFT3DParams())
    sl = _Slabs(m, "z")
    x = block(vols, m, 0, 1 if m.space > 1 else None)
    out = {}
    for label, pip in (("pip", True), ("seq", False)):
        levels = build_gpyr_batched(x, plan, m, pipelined=pip)
        for (o, s), lv in levels.items():
            n = plan.octave_dims(o)[2]
            full = sl.full(lv, n) if m.space > 1 else lv
            out[f"{label}_{o}_{s}"] = whole(full, m)
    return out


PARALLEL = {name: (_conv(name), meshes)
            for name, (_, _, meshes) in CONV.items()}
PARALLEL.update({
    "halo": (_halo, ALL),
    "layout": (_layout, ALL),
    **{f"ext_{sd}": (_extrema(sd), ALL) for sd in "zyx"},
    **{f"orient_{sd}": (_orient(sd), ALL) for sd in "zyx"},
    **{f"desc_{sd}": (_descrip(sd), ALL) for sd in "zyx"},
    "match": (_match("match"), ALL),
    "match_pad": (_match("match_pad"), ALL),
    "match_streamed": (_match("match", streamed=True), ALL),
    "ring": (_match("match", ring=True), ALL),
    "ring_pad": (_match("match_pad", ring=True), ALL),
    **{name: (_pipeline(name), ALL) for name in PIPES},
    "overflow": (_overflow, ALL),
    "pipelined": (_pipelined, ALL),
})


# --- suite "groupwise" -------------------------------------------------------

GW_SOLVE_ITERS = 200
GW_REGISTER_ITERS = 100


def _gw_solve(inp, m):
    res = gw.groupwise_solve_sharded(
        inp["gw_solve/edges"], inp["gw_solve/src"], inp["gw_solve/ref"],
        inp["gw_solve/counts"], 4, m,
        ransac_params=RansacParams(num_iter=GW_SOLVE_ITERS), device=DEVICE,
        ransac_idx=dev(inp["gw_solve/idx"]))
    return _gw_out(res)


def _gw_register(inp, m):
    desc = descriptors_from_numpy(
        inp["gw_register/xyz"], inp["gw_register/sd"],
        inp["gw_register/vec"], inp["gw_register/count"], device=DEVICE)
    res = gw.register_groupwise_sharded(
        desc, inp["gw_register/edges"], (1.0, 1.0, 1.0), m,
        ransac_params=RansacParams(num_iter=GW_REGISTER_ITERS),
        ransac_idx=dev(inp["gw_register/idx"]), device=DEVICE)
    return _gw_out(res)


def _gw_fleet(inp, m):
    res = gw.groupwise_solve_sharded(
        inp["gw_fleet/edges"], inp["gw_fleet/src"], inp["gw_fleet/ref"],
        inp["gw_fleet/counts"], int(inp["gw_fleet/n"]), m,
        ransac_params=RansacParams(num_iter=60), device=DEVICE)
    return _gw_out(res)


def _gw_out(res):
    return {"A": host(res.A), "inliers": host(res.edge_inliers),
            "edge_ok": host(res.edge_ok), "ok": np.asarray(bool(res.ok))}


GROUPWISE = {"gw_solve": (_gw_solve, ALL),
             "gw_register": (_gw_register, ALL),
             "gw_fleet": (_gw_fleet, ALL)}

SUITES = {"parallel": PARALLEL, "groupwise": GROUPWISE}


def cases(suite: str):
    """(case, "<data>x<space>") of every check the suite's world runs."""
    return [(name, f"{d}x{s}") for name, (_, meshes) in SUITES[suite].items()
            for d, s in meshes]


# --- the world ---------------------------------------------------------------

def main(argv) -> int:
    global DEVICE
    if len(argv) == 3:              # under torchrun: one card a rank
        suite, inputs, out = argv
        DEVICE = init_distributed()
        rank = torch.distributed.get_rank()
    else:
        suite, inputs, out, rank, world, store = argv
        rank = int(rank)
        torch.set_num_threads(1)
        init_distributed(f"file://{store}", int(world), rank, device="cpu")
    os.makedirs(out, exist_ok=True)
    inp = dict(np.load(inputs))
    results, errors = {}, {}
    try:
        for data, space in MESHES:
            m = make_mesh(data, space, device=DEVICE)
            for name, (fn, meshes) in SUITES[suite].items():
                if (data, space) not in meshes:
                    continue
                key = f"{name}/{data}x{space}"
                try:
                    for k, v in fn(inp, m).items():
                        results[f"{key}/{k}"] = np.asarray(v)
                except Exception:   # recorded per case; the test fails
                    errors[key] = traceback.format_exc()
        if rank == 0:
            np.savez(os.path.join(out, "results.npz"), **results)
            with open(os.path.join(out, "errors.json"), "w") as f:
                json.dump(errors, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def run_world(suite: str, inputs: Path, out: Path,
              timeout: float = TIMEOUT_S) -> tuple[dict, dict, str]:
    """Run the suite's 4-rank world; returns (results, errors, failure):
    ``failure`` is "" when every rank exited 0 within ``timeout`` seconds,
    else what went wrong (the ranks are killed at the timeout)."""
    store = out / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    logs = [open(out / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), suite, str(inputs),
         str(out), str(r), str(WORLD), str(store)],
        cwd=str(ROOT), env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    deadline = time.monotonic() + timeout
    failure = ""
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failure = f"the world did not finish within {timeout} s"
                break
            if rc:
                failure = f"rank {r} exited {rc}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.seek(0)
        tails = "\n".join(f"--- rank {r}\n{f.read()[-3000:]}"
                          for r, f in enumerate(logs))
        for f in logs:
            f.close()
    if failure:
        return {}, {}, failure + "\n" + tails
    if not (out / "results.npz").exists():
        return {}, {}, "rank 0 wrote no results\n" + tails
    results = dict(np.load(out / "results.npz"))
    errors = json.loads((out / "errors.json").read_text())
    return results, errors, ""


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
