"""The sharded-path tests' checks with the port's ranks on cards.

``tests/test_torch_parallel.py`` and ``tests/test_torch_groupwise_sharded.py``
run their 4-rank world on the CPU (gloo). The same world runs on a
machine with 4 GPUs under NCCL, one card a rank, and its results are held
here, on the CPU, by the same test functions against the JAX package's
sharded results and the port's one-device path:

    python tests/torch_parallel_cards.py prep build/mesh4        # CPU, JAX
    # on the 4-GPU machine, for SUITE in parallel and groupwise:
    python -c "from sift3d_tpu_torch import _build; _build.build_all()"
    python -m torch.distributed.run --nproc_per_node=4 \\
        tests/torch_parallel_worker.py SUITE build/mesh4/SUITE_inputs.npz \\
        chiprun_out/mesh4_SUITE
    python tests/torch_parallel_cards.py check build/mesh4 chiprun_out

``prep`` writes each suite's inputs (``make_inputs``) and keeps JAX's
results beside them; ``check`` runs every (case, mesh) check of both
suites on the cards' results and prints what passed.
"""

from __future__ import annotations

import json
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import tests.conftest  # noqa: E402,F401  (JAX on the virtual CPU mesh)
from tests import test_torch_groupwise_sharded as tg  # noqa: E402
from tests import test_torch_parallel as tp  # noqa: E402
from tests import torch_parallel_worker as worker  # noqa: E402


def prep(out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    inp = tp.make_inputs()
    np.savez(out / "parallel_inputs.npz", **inp)
    ing = tg.make_inputs()
    ing["gw_register/idx"] = tg.register_draws(ing)
    np.savez(out / "groupwise_inputs.npz", **ing)
    with open(out / "jax_results.pkl", "wb") as f:
        pickle.dump((tp.jax_results(inp), tg.jax_results(ing)), f)


def _world(inputs: Path, results: Path, jax_out):
    inp = dict(np.load(inputs))
    res = dict(np.load(results / "results.npz"))
    errors = json.loads((results / "errors.json").read_text())
    return inp, jax_out, res, errors, ""


def _parallel_check(world, unsharded, case, mesh):
    if case.startswith("conv_"):
        tp.test_conv_sep_sharded(world, case, mesh)
    elif case in ("halo", "layout"):
        tp.test_shard_halo_and_layout(world, mesh)
    elif case.startswith("ext_"):
        tp.test_level_extrema_sharded(world, case, mesh)
    elif case.startswith("orient_"):
        tp.test_orient_level_sharded(world, case, mesh)
    elif case.startswith("desc_"):
        tp.test_descrip_level_sharded(world, case, mesh)
    elif case.startswith(("match", "ring")):
        tp.test_nn_match_sharded_and_ring(world, case, mesh)
    elif case.startswith("bdd_"):
        tp.test_batch_detect_describe_mesh(world, unsharded, case, mesh)
    elif case == "overflow":
        tp.test_overflow_flag_mesh(world, mesh)
    elif case == "pipelined":
        tp.test_build_gpyr_batched_pipelined(world, mesh)
    else:
        raise KeyError(case)


def check(prep_dir: Path, results_dir: Path) -> int:
    import torch
    from sift3d_tpu_torch import pyramid as tpyr
    from sift3d_tpu_torch.config import SIFT3DParams
    from sift3d_tpu_torch.parallel import pipeline as tpipe
    with open(prep_dir / "jax_results.pkl", "rb") as f:
        jax_par, jax_gw = pickle.load(f)
    world = _world(prep_dir / "parallel_inputs.npz",
                   results_dir / "mesh4_parallel", jax_par)
    unsharded = {}
    for name, (shape, units, cap, _) in worker.PIPES.items():
        params = SIFT3DParams(max_kp_per_level=cap)
        plan = tpyr.plan_pyramid(shape[::-1], units, params)
        unsharded[name] = tpipe.batch_detect_describe(
            world[0][f"{name}/vols"], plan, params, device="cpu")
    torch.set_num_threads(4)
    passed, failed = 0, []
    for case, mesh in worker.cases("parallel"):
        try:
            _parallel_check(world, unsharded, case, mesh)
            passed += 1
        except Exception:    # report every failing case, not the first
            failed.append((case, mesh, traceback.format_exc(limit=2)))
    world = _world(prep_dir / "groupwise_inputs.npz",
                   results_dir / "mesh4_groupwise", jax_gw)
    for case, mesh in worker.cases("groupwise"):
        try:
            tg.test_groupwise_sharded(world, case, mesh)
            passed += 1
        except Exception:
            failed.append((case, mesh, traceback.format_exc(limit=2)))
    for case, mesh, tb in failed:
        print(f"FAILED {case} {mesh}\n{tb}")
    print(f"{passed} (case, mesh) checks passed, {len(failed)} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1] == "prep":
        prep(Path(sys.argv[2]))
    else:
        sys.exit(check(Path(sys.argv[2]), Path(sys.argv[3])))
