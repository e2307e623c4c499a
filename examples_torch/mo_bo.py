"""Multi-objective BO with MO_BO: the nb_modgp workflow as three lines
(the port's counterpart of ``examples/mo_bo.py``).

The default surrogate is a pair of independent per-objective exact GPRs
(the JAX package's bake-off winner); pass a model_dic without 'type' to get
the notebook's coupled MO-DGP surrogate instead.

Run: ``python examples_torch/mo_bo.py [--cpu]``.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from dgp_tpu_torch.bo.mo_bo import MO_BO  # noqa: E402
from dgp_tpu_torch.bo.problems import get  # noqa: E402


def main(infills=4, S=200, popsize_DE=60, iterations_DE=60, model_dic=None,
         device=None, dtype=None):
    """The default GPR pair's EHVI loop, a save/load round trip. Returns
    the loop."""
    problem = get("multi_obj_1D_4")  # bi-objective, d=1, HV box in .bounds

    # default surrogate (independent GPR pair) — no model_dic needed
    bo = MO_BO(problem=problem, DoE_size=10, seed=0, model_dic=model_dic,
               device=device, dtype=dtype)
    print(f"DoE hypervolume: {bo.hv_trace[0]:.4f}")

    trace = bo.run(infills, S=S, popsize_DE=popsize_DE,
                   iterations_DE=iterations_DE)
    print(f"after {infills} EHVI infills: HV {trace[0]:.4f} -> "
          f"{trace[-1]:.4f}")

    X_nd, F_nd = bo.pareto()
    print(f"non-dominated set: {len(X_nd)} points")
    for x, f in zip(X_nd, F_nd):
        print(f"  x={np.round(x, 4)}  f=({f[0]:+.4f}, {f[1]:+.4f})")

    # checkpoint/resume round-trips the data archive, HV trace, PRNG stream
    # position and the surrogate spec
    path = os.path.join(tempfile.mkdtemp(), "mo_bo_example.npz")
    bo.save(path)
    bo2 = MO_BO.load(path, problem, device=device, dtype=dtype)
    assert bo2.hv_trace == list(trace) and bo2.model_dic == bo.model_dic
    print("save/load round-trip OK")
    return bo


def coupled(infills=1, schedule=(100, 0, 0), S=100, popsize_DE=30,
            iterations_DE=30, restarts=None, device=None, dtype=None):
    """The notebook's coupled MO-DGP surrogate, one model_dic away (with
    ``restarts``, that many schedules a fit; by default the model's
    "auto"). Returns the loop."""
    spec = {"loop": 2, "num_samples": 5, "schedule": schedule}
    if restarts is not None:
        spec["restarts"] = restarts
    bo = MO_BO(problem=get("multi_obj_1D_4"), DoE_size=10, seed=0,
               model_dic=spec, device=device, dtype=dtype)
    bo.run(infills, S=S, popsize_DE=popsize_DE, iterations_DE=iterations_DE)
    print(f"coupled MO-DGP surrogate, {infills} infill: HV "
          f"{bo.hv_trace[0]:.4f} -> {bo.hv_trace[-1]:.4f}")
    return bo


if __name__ == "__main__":
    device = "cpu" if "--cpu" in sys.argv else None
    main(device=device)
    coupled(device=device)
